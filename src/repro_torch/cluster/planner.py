"""SLO-driven capacity planner.

Sweeps cluster size (and, for disaggregated clusters, the prefill/decode
pool split) at a target arrival rate, prices every candidate with a
$/device-hour table, and returns the cheapest configuration whose SLO
attainment (fraction of requests meeting BOTH the TTFT and TPOT SLOs —
`goodput_frac`) clears the target. This is the cluster-level question the
paper's per-device-group model (§4.3) exists to inform: how much hardware,
and in what organization, a latency target actually costs.

Prices are public on-demand list-price ballparks (documented assumptions,
overridable via `price_table`); what matters for plan *ranking* is their
ratio, not their absolute level.

A copy of `repro.cluster.planner` (the port imports nothing of the JAX package);
`tests/test_torch_cluster_dynamic.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import replace

from repro_torch.configs.base import ModelConfig
from repro_torch.sim.scheduler import SchedConfig
from repro_torch.sim.workload import SimRequest, Workload

from repro_torch.cluster.autoscale import AutoscaleConfig
from repro_torch.cluster.cluster import (
    ClusterSpec,
    ReplicaSpec,
    peak_over_spans,
    simulate_cluster,
    summarize_cluster,
)
from repro_torch.cluster.prefixcache import PrefixCacheConfig

# $/device-hour, on-demand cloud ballparks (ranking inputs, not quotes)
DEFAULT_PRICE_PER_DEV_HR = {
    "a100": 1.8,
    "a100-80g": 1.8,
    "h100": 3.9,
    "h100-sxm": 3.9,
    "h200": 4.5,
    "b200": 6.9,
    "tpu-v5e": 1.2,
    "v5e": 1.2,
}


def replica_price_per_hr(rs: ReplicaSpec, table: dict | None = None) -> float:
    """$/hour to run one replica: the per-device price of its hardware
    times its tensor-parallel device count."""
    table = table or DEFAULT_PRICE_PER_DEV_HR
    name = (rs.hw if isinstance(rs.hw, str) else rs.hw.name).lower()
    if name not in table:
        raise ValueError(
            f"no $/hr price for hardware {name!r}; pass price_table= "
            f"(known: {sorted(table)})")
    return table[name] * rs.tp


def cluster_price_per_hr(spec: ClusterSpec, table: dict | None = None) -> float:
    """$/hour for the whole (static) fleet: sum of its replica prices."""
    return sum(replica_price_per_hr(rs, table) for rs in spec.replicas)


def provisioning_summary(cres, table: dict | None = None, *,
                         shed_cost_usd: float = 0.0) -> dict:
    """Price a (possibly dynamic) cluster run's actual provisioning against
    static peak provisioning of the same trace.

    `replica_hours` bills each replica for its provisioned span (warmup and
    drain tails included); the static-peak counterfactual runs the maximum
    concurrently-provisioned fleet for the whole trace span (`cres.span`,
    origin to the last replica going quiet — the same window the real
    spans are billed over and the same frame an exported trace renders,
    reported back as `t0`/`horizon`) — what you'd have to deploy without
    an autoscaler to survive the trace's peak. The savings fraction is
    the autoscaling headline number on diurnal traces.

    Args:
        cres: a `ClusterResult`.
        table: $/device-hour price table (default
            `DEFAULT_PRICE_PER_DEV_HR`).
        shed_cost_usd: $ each dropped request costs (lost revenue / SLA
            credit). Nonzero makes the shedding-vs-overprovisioning trade
            explicit: a fleet that sheds its way to cheap replica-hours
            pays for it in `shed_cost_usd`, and `cost_usd_total` ranks the
            two honestly.

    Returns dict keys (all costs in $, hours in replica-hours):
        replica_hours / replica_hours_static_peak, cost_usd /
        cost_usd_static_peak, savings_frac, peak_replicas,
        shed / shed_cost_usd / cost_usd_total, and `pools` — a per-pool
        breakdown {pool: {replica_hours, cost_usd, peak_replicas}} so
        pool-aware autoscaling bills prefill and decode separately."""
    prices = [replica_price_per_hr(rs, table) for rs in cres.replica_specs]
    span = cres.span
    cost = sum(p * (e - s) / 3600.0
               for p, (s, e) in zip(prices, cres.replica_spans))
    # static peak $: the max concurrent price rate, held for the whole span
    static_cost = peak_over_spans(cres.replica_spans, prices) * span / 3600.0
    shed_cost = len(cres.shed) * shed_cost_usd
    pools: dict = {}
    for pool in dict.fromkeys(cres.replica_pools):  # stable order
        idxs = [i for i, p in enumerate(cres.replica_pools) if p == pool]
        spans = [cres.replica_spans[i] for i in idxs]
        pools[pool] = {
            "replica_hours": sum(e - s for s, e in spans) / 3600.0,
            "cost_usd": sum(prices[i] * (e - s) / 3600.0
                            for i, (s, e) in zip(idxs, spans)),
            "peak_replicas": int(peak_over_spans(spans)),
        }
    return {
        "replica_hours": cres.replica_hours,
        "replica_hours_static_peak": cres.replica_hours_static_peak,
        "cost_usd": cost,
        "cost_usd_static_peak": static_cost,
        "savings_frac": 1.0 - cost / static_cost if static_cost > 0 else 0.0,
        "peak_replicas": cres.peak_replicas,
        "shed": len(cres.shed),
        "shed_cost_usd": shed_cost,
        "cost_usd_total": cost + shed_cost,
        "t0": cres.t0,
        "horizon": cres.horizon if cres.horizon > cres.t0 else cres.t0 + span,
        "pools": pools,
    }


def seed_predictive(asc: AutoscaleConfig, workload: Workload,
                    requests: list[SimRequest] | None = None
                    ) -> AutoscaleConfig:
    """Seed the predictive policy's envelope and traffic shape from a
    workload spec — the planner-side bridge between what the generator
    KNOWS it will offer and what the control loop provisions for.

    Returns a copy of `asc` with `policy="predictive"`,
    `envelope=workload.peak_rate` (the diurnal closed form or the JSONL
    replay's piecewise-linear lookahead), and `mean_prompt`/`mean_output`
    (tokens) taken from the generated `requests` when given (exact, and
    the only option for trace replays) or from the spec's length
    distributions otherwise."""
    if requests:
        mean_prompt = sum(r.prompt for r in requests) / len(requests)
        mean_output = sum(r.output for r in requests) / len(requests)
    else:
        mean_prompt, mean_output = workload.prompt.mean, workload.output.mean
    return replace(asc, policy="predictive", envelope=workload.peak_rate,
                   mean_prompt=float(mean_prompt),
                   mean_output=float(mean_output))


# ------------------------------------------------------------ sweep internals
# Candidate evaluation lives at module level (not in closures) so the same
# code runs serially and inside `ProcessPoolExecutor` workers. Workers
# receive the sweep context once via the pool initializer (fork + one
# pickle per worker, not one per task) and keep their own cost-model /
# goodput memos — memo hits then land per worker instead of globally,
# which costs some duplicated loss-tolerance evaluations but changes no
# row (every simulation is deterministic in its inputs).
_PLAN_CTX: dict | None = None


def _plan_init(ctx: dict) -> None:
    global _PLAN_CTX
    ctx = dict(ctx)
    ctx["cost_cache"] = {}
    ctx["goodput_memo"] = {}
    _PLAN_CTX = ctx


def _plan_spec(ctx: dict, mode: str, n_prefill: int, n_decode: int,
               pc: PrefixCacheConfig | None) -> ClusterSpec:
    n = n_prefill + n_decode
    pools = (["mixed"] * n if mode == "colocated"
             else ["prefill"] * n_prefill + ["decode"] * n_decode)
    replicas = tuple(
        ReplicaSpec(hw=ctx["hw"], tp=ctx["tp"], prec=ctx["prec"], pool=pool,
                    sched=ctx["sched"], ctx_quantum=ctx["ctx_quantum"],
                    kv_block_tokens=ctx["kv_block_tokens"])
        for pool in pools)
    return ClusterSpec(replicas=replicas, router=ctx["router"],
                       decode_router=ctx["decode_router"],
                       hit_frac=ctx["hit_frac"], prefix_cache=pc)


def _plan_goodput(ctx: dict, mode: str, n_prefill: int, n_decode: int,
                  pc: PrefixCacheConfig | None) -> float:
    """Goodput of one (reduced) fleet on the shared stream, memoized:
    many candidates share the same surviving-fleet evaluations."""
    memo = ctx["goodput_memo"]
    key = (mode, n_prefill, n_decode, pc)
    if key not in memo:
        try:
            cres = simulate_cluster(ctx["reqs"], ctx["cfg"],
                                    _plan_spec(ctx, mode, n_prefill,
                                               n_decode, pc),
                                    engine=ctx["engine"],
                                    _cost_cache=ctx["cost_cache"])
            s = summarize_cluster(cres, slo_ttft=ctx["slo_ttft"],
                                  slo_tpot=ctx["slo_tpot"])
            memo[key] = s["goodput_frac"]
        except ValueError:
            memo[key] = 0.0
    return memo[key]


def _plan_loss_goodput(ctx: dict, mode: str, n_prefill: int, n_decode: int,
                       pc: PrefixCacheConfig | None) -> float:
    """Worst-case goodput after losing `loss_tolerance` replicas."""
    n_loss = ctx["loss_tolerance"]
    if mode == "colocated":
        if n_decode - n_loss < 1:
            return 0.0  # the loss empties the fleet
        return _plan_goodput(ctx, mode, 0, n_decode - n_loss, pc)
    if n_prefill <= n_loss or n_decode <= n_loss:
        return 0.0  # the adversary can empty one pool outright
    return min(_plan_goodput(ctx, mode, n_prefill - dp,
                             n_decode - (n_loss - dp), pc)
               for dp in range(n_loss + 1))


def _plan_candidate(ctx: dict, mode: str, n_prefill: int, n_decode: int,
                    pc: PrefixCacheConfig | None) -> dict:
    n = n_prefill + n_decode
    spec = _plan_spec(ctx, mode, n_prefill, n_decode, pc)
    row = {"mode": mode, "replicas": n,
           "prefill": n_prefill if mode == "disaggregated" else 0,
           "decode": n_decode if mode == "disaggregated" else 0,
           "cache_frac": (None if pc is None or pc.budget_bytes is not None
                          else pc.budget_frac),
           "cost_per_hr": cluster_price_per_hr(spec, ctx["price_table"])}
    try:
        cres = simulate_cluster(ctx["reqs"], ctx["cfg"], spec,
                                engine=ctx["engine"],
                                _cost_cache=ctx["cost_cache"])
    except ValueError as e:  # e.g. model KV footprint exceeds a pool budget
        row.update(feasible=False, error=str(e), goodput_frac=0.0)
        return row
    s = summarize_cluster(cres, slo_ttft=ctx["slo_ttft"],
                          slo_tpot=ctx["slo_tpot"])
    row.update(
        goodput_frac=s["goodput_frac"], goodput_rps=s["goodput_rps"],
        ttft_p95=s["ttft_p95"], tpot_p95=s["tpot_p95"],
        tokens_per_s=s["tokens_per_s"], xfer_share=s["xfer_share"],
        preemptions=s["preemptions"],
        util_mean=sum(s["replica_util"]) / len(s["replica_util"]),
        feasible=s["goodput_frac"] >= ctx["attainment"])
    if cres.cache_stats is not None:
        row["cache_hit_tokens"] = s["cache_hit_tokens"]
        row["cache_evictions"] = s["cache_evictions"]
    if ctx["loss_tolerance"] > 0:
        gl = _plan_loss_goodput(ctx, mode, n_prefill, n_decode, pc)
        row["goodput_frac_loss"] = gl
        row["feasible"] = row["feasible"] and gl >= ctx["attainment"]
    return row


def _plan_eval(task: tuple) -> dict:
    return _plan_candidate(_PLAN_CTX, *task)


def _plan_pool(ctx: dict, workers: int) -> ProcessPoolExecutor | None:
    """Fork-based worker pool, or None when unavailable (serial fallback).
    Fork is required so workers inherit the imported modules cheaply; the
    context is shipped once per worker through the initializer."""
    try:
        import multiprocessing as mp
        return ProcessPoolExecutor(max_workers=workers,
                                   mp_context=mp.get_context("fork"),
                                   initializer=_plan_init, initargs=(ctx,))
    except (ValueError, OSError):
        return None


def plan_capacity(cfg: ModelConfig, workload: Workload, *, qps: float,
                  slo_ttft: float, slo_tpot: float, attainment: float = 0.95,
                  hw: str = "h100", tp: int = 1, prec: int = 2,
                  sched: SchedConfig | None = None, router: str = "jsq",
                  decode_router: str = "least_kv", hit_frac: float = 0.5,
                  kv_block_tokens: int = 0, ctx_quantum: int = 16,
                  min_replicas: int = 1, max_replicas: int = 8,
                  modes=("colocated", "disaggregated"),
                  price_table: dict | None = None,
                  prefix_cache: PrefixCacheConfig | None = None,
                  cache_fracs: tuple | None = None,
                  cache_ttl: float | None = None,
                  early_stop: bool = True,
                  loss_tolerance: int = 0,
                  engine: str = "vectorized",
                  sweep_workers: int = 0) -> dict:
    """Sweep replica count / pool split at `qps`; return {"rows", "best"}.

    Every candidate serves the SAME request stream (`workload` regenerated
    at the target rate), so rows are comparable point-for-point. A row is
    feasible when its `goodput_frac >= attainment`. With `early_stop`,
    each mode stops growing the cluster once a feasible size is found —
    larger clusters of the same hardware only cost more.

    The prefix-cache budget share is a CAPACITY DIMENSION of the sweep:
    pass `cache_fracs=(0.05, 0.1, 0.2)` and every topology is evaluated
    once per budget share (`PrefixCacheConfig(budget_frac=f,
    ttl=cache_ttl)`), with `cache_frac` recorded on the row — more cache
    means more prefill skipped but less KV for live sequences, and the
    sweep finds where that trade clears the SLO cheapest. Alternatively
    `prefix_cache=` fixes one explicit config for all candidates; the
    default (both None) keeps the legacy unconditional-discount model.

    `loss_tolerance=N` sizes for FAILURE instead of steady state: a
    candidate is feasible only if, additionally, every fleet obtainable
    by removing N replicas (the worst case over prefill/decode split
    assignments for disaggregated fleets — an adversary kills where it
    hurts most) still clears `attainment` on the same stream. A pool the
    adversary can empty outright scores 0. The surviving-fleet goodput
    lands on the row as `goodput_frac_loss` — the resilience margin the
    chaos engine's correlated `node_failure` events then stress-test.

    `engine` selects the replica-simulation core for every candidate run
    (see `simulate_cluster`). `sweep_workers` > 1 evaluates each fleet
    size's candidate batch in parallel OS processes (fork; `-1` means all
    cores): rows, their order, and `early_stop` behavior are identical to
    the serial sweep — per-`n` batches are the early-stop granularity in
    both — because every candidate simulation is deterministic."""
    if loss_tolerance < 0:
        raise ValueError("loss_tolerance must be >= 0")
    sched = sched or SchedConfig()
    reqs = replace(workload, qps=qps).generate()
    rows: list[dict] = []
    if cache_fracs:  # empty/None both fall back to the single-config path
        cache_cfgs = [PrefixCacheConfig(budget_frac=float(f), ttl=cache_ttl)
                      for f in cache_fracs]
    else:
        cache_cfgs = [prefix_cache]  # may be None: legacy model

    base_ctx = dict(cfg=cfg, reqs=reqs, sched=sched, hw=hw, tp=tp, prec=prec,
                    router=router, decode_router=decode_router,
                    hit_frac=hit_frac, kv_block_tokens=kv_block_tokens,
                    ctx_quantum=ctx_quantum, slo_ttft=slo_ttft,
                    slo_tpot=slo_tpot, attainment=attainment,
                    price_table=price_table, loss_tolerance=loss_tolerance,
                    engine=engine)
    ctx = dict(base_ctx, cost_cache={}, goodput_memo={})
    workers = os.cpu_count() or 1 if sweep_workers < 0 else sweep_workers
    pool = _plan_pool(base_ctx, workers) if workers > 1 else None
    try:
        for mode in modes:
            lo = max(min_replicas, 2) if mode == "disaggregated" else min_replicas
            for n in range(lo, max_replicas + 1):
                splits = ([(p, n - p) for p in range(1, n)]
                          if mode == "disaggregated" else [(0, n)])
                tasks = [(mode, n_p, n_d, pc)
                         for n_p, n_d in splits for pc in cache_cfgs]
                if pool is not None:
                    batch = list(pool.map(_plan_eval, tasks))
                else:
                    batch = [_plan_candidate(ctx, *t) for t in tasks]
                rows.extend(batch)
                if early_stop and any(r["feasible"] for r in batch):
                    break
    finally:
        if pool is not None:
            pool.shutdown()

    feasible = [r for r in rows if r["feasible"]]
    best = min(feasible, key=lambda r: (r["cost_per_hr"], -r["goodput_frac"]),
               default=None)
    return {"rows": rows, "best": best, "qps": qps, "attainment": attainment,
            "loss_tolerance": loss_tolerance}
