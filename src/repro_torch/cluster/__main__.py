"""CLI: simulate a multi-replica serving cluster under load.

    PYTHONPATH=src python -m repro_torch.cluster --config qwen3_14b --hw h100 \\
        --replicas 4 --qps 32

Runs the same fleet as a colocated (data-parallel) cluster and as a
disaggregated prefill/decode cluster, printing cluster- and pool-level
TTFT/TPOT/goodput/SLO-attainment plus the KV-transfer overhead of the
disaggregated organization. `--hw` accepts a comma-separated list cycled
across replicas for heterogeneous fleets; `--plan` runs the SLO-driven
capacity sweep instead of a fixed-size comparison; `--autoscale` makes
the fleet dynamic (replica add/remove with warmup and graceful drain —
pair with `--arrival diurnal` and `--max-replicas`), reporting
replica-hours against static peak provisioning.
`--autoscale-policy predictive` provisions ahead of the known rate
envelope through an M/G/1 wait estimate (scale-ups lead the ramp by the
warmup); `--pool-autoscale` scales a disaggregated fleet's prefill and
decode pools independently on their own signals (admission wait vs
KV + TPOT pressure) instead of the template ratio.

`--prefix-cache` replaces the affinity router's unconditional `hit_frac`
discount with a modeled per-replica prefix cache: a finite byte budget
(`--cache-frac` of KV capacity, carved out of it, or `--cache-gb`
absolute), LRU + TTL eviction (`--cache-ttl`), and cross-session sharing
of the workload's prefix groups (`--prefix-groups`/`--prefix-len`
generate multi-tenant system prompts). `--plan-cache-fracs` sweeps the
budget share as a capacity dimension of `--plan`.

`--trace out.json` records the run: request lifecycle spans, per-replica
counter timelines, and explainable autoscale decisions, exported by
suffix (.json = Chrome trace-event for Perfetto, .jsonl = event log for
`python -m repro_torch.obs report`, .csv = windowed time series); verbosity via
`--trace-level`, per-iteration counter downsampling via
`--trace-counter-dt`. With `--mode both` the mode is suffixed into the
filename (out.colocated.json, out.disaggregated.json).

`--chaos-crashes/--chaos-stragglers/--chaos-links/--chaos-nodes R` inject
seeded faults at rate R events/s over `--chaos-horizon` (crashes lose
in-flight KV; displaced requests re-prefill or restore from a surviving
replica's prefix cache), with `--chaos-node-group` replicas killed per
correlated node failure; the summary gains requests-lost, re-prefill,
and recovery-time columns. `--admission-policy token_bucket|breaker`
puts an overload front door ahead of dispatch (`--admission-rate/
--admission-burst/--admission-queue` for GCRA, `--breaker-*` for the
circuit breaker). `--retry-backoff/--retry-jitter` shape the seeded
exponential shed-retry backoff; `--spare` holds N+k redundancy above the
autoscale policy's ask; `--plan-loss N` makes `--plan` size fleets that
still clear the attainment bar after losing N replicas.

`--slo-window W` turns on the live SLO monitor: TTFT p99 <= `--slo-ttft`
and (if given) goodput >= `--slo-goodput`, judged over tumbling
W-second windows at sim time, with SRE-style fast/slow burn-rate alerts
and EWMA anomaly detection; `alert.*`/`anomaly.*`/`slo.window` instants
land in the trace and the summary gains time-in-violation, alerts-fired,
and budget-burn columns.

A copy of `repro.cluster.__main__` (the port imports nothing of the JAX package);
`tests/test_torch_cluster_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

from repro_torch.configs import get_config
from repro_torch.obs import LEVELS, SLOMonitor, make_slos, make_tracer, write_trace
from repro_torch.sim import ADMISSIONS, ENGINES, LengthDist, SchedConfig, Workload
from repro_torch.cluster import (
    ADMISSION_POLICIES,
    AUTOSCALE_POLICIES,
    ROUTERS,
    AdmissionConfig,
    AutoscaleConfig,
    ChaosConfig,
    ClusterSpec,
    PrefixCacheConfig,
    ReplicaSpec,
    cluster_price_per_hr,
    plan_capacity,
    pool_summaries,
    provisioning_summary,
    seed_predictive,
    simulate_cluster,
    summarize_cluster,
)


def build_parser() -> argparse.ArgumentParser:
    """Argparse parser for `python -m repro_torch.cluster` (qps = requests/s,
    latency SLOs in seconds, prices in $/hr)."""
    p = argparse.ArgumentParser(prog="python -m repro_torch.cluster", description=__doc__)
    p.add_argument("--config", default="qwen3_14b", help="model config id")
    p.add_argument("--hw", default="h100",
                   help="hardware target(s); comma-separated list cycles "
                        "across replicas for heterogeneous fleets")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--prec", type=int, default=2)
    p.add_argument("--replicas", type=int, default=4)
    p.add_argument("--prefill-replicas", type=int, default=None,
                   help="disaggregated pool split (default: replicas // 2)")
    p.add_argument("--mode", default="both",
                   choices=["both", "colocated", "disaggregated"])
    p.add_argument("--router", default="jsq", choices=list(ROUTERS))
    p.add_argument("--decode-router", default="least_kv", choices=list(ROUTERS))
    p.add_argument("--hit-frac", type=float, default=0.5,
                   help="affinity router's prefix-cache discount")
    p.add_argument("--policy", default="continuous",
                   choices=["static", "continuous", "chunked"])
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--token-budget", type=int, default=512)
    p.add_argument("--admission", default="fcfs", choices=list(ADMISSIONS))
    p.add_argument("--block-tokens", type=int, default=0,
                   help="paged-KV page size in tokens (0 = contiguous)")
    p.add_argument("--qps", type=float, default=32.0)
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--arrival", default="poisson",
                   choices=["constant", "poisson", "bursty", "diurnal",
                            "envelope"])
    p.add_argument("--diurnal-period", type=float, default=240.0,
                   help="seconds per compressed day (--arrival diurnal)")
    p.add_argument("--diurnal-amp", type=float, default=0.8,
                   help="relative rate swing in [0, 1] (--arrival diurnal)")
    p.add_argument("--rate-path", default=None,
                   help="JSONL rate envelope {t, qps} (--arrival envelope)")
    p.add_argument("--prompt-dist", default="lognormal", choices=["fixed", "lognormal"])
    p.add_argument("--prompt-mean", type=float, default=512)
    p.add_argument("--prompt-sigma", type=float, default=0.4)
    p.add_argument("--output-dist", default="lognormal", choices=["fixed", "lognormal"])
    p.add_argument("--output-mean", type=float, default=128)
    p.add_argument("--output-sigma", type=float, default=0.4)
    p.add_argument("--sessions", type=int, default=0,
                   help="session count for affinity routing (0 = none)")
    p.add_argument("--prefix-groups", type=int, default=0,
                   help="shared-prefix groups (multi-tenant system prompts) "
                        "in the workload (0 = none)")
    p.add_argument("--prefix-len", type=float, default=256,
                   help="tokens per shared group prefix (--prefix-groups)")
    p.add_argument("--replay", default=None,
                   help="JSONL workload trace to replay instead of the "
                        "synthetic generator")
    p.add_argument("--trace", default=None,
                   help="record the run to this path: .json = Chrome "
                        "trace-event (Perfetto), .jsonl = event log "
                        "(repro_torch.obs report), .csv = windowed time series")
    p.add_argument("--trace-level", default="request", choices=list(LEVELS),
                   help="trace verbosity ceiling (with --trace): summary = "
                        "scaling/shed events, replica = + per-replica spans "
                        "and counters, request = + per-request lifecycle")
    p.add_argument("--trace-counter-dt", type=float, default=0.0,
                   help="minimum seconds between per-(track, series) counter "
                        "samples (0 = every iteration); trims trace size on "
                        "long runs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slo-ttft", type=float, default=2.0, help="seconds")
    p.add_argument("--slo-tpot", type=float, default=0.05, help="seconds/token")
    p.add_argument("--slo-goodput", type=float, default=None,
                   help="live-monitor goodput objective as a fraction (e.g. "
                        "0.99); needs --slo-window")
    p.add_argument("--slo-window", type=float, default=None,
                   help="enable the live SLO monitor: tumbling compliance "
                        "window in seconds for TTFT p99 <= --slo-ttft (and "
                        "goodput >= --slo-goodput if set), with burn-rate "
                        "alerts and anomaly detection")
    p.add_argument("--ctx-quantum", type=int, default=16)
    # modeled prefix cache (default: legacy unconditional affinity discount)
    p.add_argument("--prefix-cache", action="store_true",
                   help="model the prefix cache: finite per-replica budget, "
                        "LRU+TTL eviction, cross-session prefix sharing")
    p.add_argument("--cache-frac", type=float, default=0.1,
                   help="prefix-cache budget as a fraction of replica KV "
                        "capacity (carved out of it)")
    p.add_argument("--cache-gb", type=float, default=None,
                   help="absolute prefix-cache budget in GB (overrides "
                        "--cache-frac; 'inf' = legacy free-infinite cache)")
    p.add_argument("--cache-ttl", type=float, default=None,
                   help="prefix-cache entry TTL in idle seconds (default: "
                        "no expiry)")
    p.add_argument("--plan", action="store_true",
                   help="run the SLO-driven capacity sweep instead")
    p.add_argument("--plan-max-replicas", type=int, default=6)
    p.add_argument("--plan-cache-fracs", default=None,
                   help="comma-separated cache budget shares to sweep as a "
                        "capacity dimension of --plan (e.g. 0.05,0.1,0.2)")
    p.add_argument("--sweep-workers", type=int, default=0,
                   help="--plan: evaluate each fleet size's candidates in "
                        "this many parallel processes (-1 = all cores, "
                        "0/1 = serial; identical rows either way)")
    p.add_argument("--engine", default="vectorized", choices=list(ENGINES),
                   help="simulation core: the vectorized fast path or the "
                        "reference event loop (identical results)")
    p.add_argument("--attainment", type=float, default=0.95)
    # dynamic fleet
    p.add_argument("--autoscale", action="store_true",
                   help="scale the fleet at runtime (--replicas = t=0 fleet)")
    p.add_argument("--autoscale-policy", default="rate",
                   choices=list(AUTOSCALE_POLICIES))
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--scale-interval", type=float, default=5.0,
                   help="control-loop period (s)")
    p.add_argument("--scale-window", type=float, default=15.0,
                   help="rolling observation window (s)")
    p.add_argument("--target-qps", type=float, default=8.0,
                   help="rate policy: target qps per replica")
    p.add_argument("--warmup", type=float, default=None,
                   help="replica warmup (s); default prices weight loading")
    p.add_argument("--lookahead", type=float, default=None,
                   help="predictive policy: envelope horizon (s); "
                        "default warmup + interval")
    p.add_argument("--target-wait", type=float, default=None,
                   help="predictive policy: M/G/1 wait budget (s); "
                        "default slo_ttft / 2")
    p.add_argument("--pool-autoscale", action="store_true",
                   help="disaggregated only: scale prefill and decode "
                        "pools independently on their own signals")
    p.add_argument("--prefill-policy", default="queue_wait",
                   choices=list(AUTOSCALE_POLICIES),
                   help="pool-autoscale: prefill pool policy")
    p.add_argument("--decode-policy", default="kv_tpot",
                   choices=list(AUTOSCALE_POLICIES),
                   help="pool-autoscale: decode pool policy")
    p.add_argument("--shed-cost", type=float, default=0.0,
                   help="$ per dropped request in the provisioning summary")
    p.add_argument("--shed-depth", type=int, default=None,
                   help="shed arrivals when every replica's depth >= this")
    p.add_argument("--retry-after", type=float, default=0.5)
    p.add_argument("--max-retries", type=int, default=2)
    p.add_argument("--retry-backoff", type=float, default=2.0,
                   help="exponential shed-retry backoff base (1 = legacy "
                        "fixed delay)")
    p.add_argument("--retry-jitter", type=float, default=0.5,
                   help="seeded retry jitter amplitude (0 = none)")
    p.add_argument("--spare", type=int, default=0,
                   help="autoscale N+k redundancy: replicas held above the "
                        "policy's ask to absorb a crash")
    p.add_argument("--plan-loss", type=int, default=0,
                   help="--plan: require candidates to clear the attainment "
                        "bar even after losing this many replicas "
                        "(worst-case pool split)")
    # seeded fault injection (repro_torch.cluster.chaos)
    p.add_argument("--chaos-seed", type=int, default=0)
    p.add_argument("--chaos-horizon", type=float, default=120.0,
                   help="seconds of simulated time chaos events are "
                        "sampled over")
    p.add_argument("--chaos-crashes", type=float, default=0.0,
                   help="replica crash rate (events/s; 0 = off)")
    p.add_argument("--chaos-stragglers", type=float, default=0.0,
                   help="straggler onset rate (events/s; 0 = off)")
    p.add_argument("--chaos-links", type=float, default=0.0,
                   help="KV-handoff link degradation rate (events/s)")
    p.add_argument("--chaos-nodes", type=float, default=0.0,
                   help="correlated node-failure rate (events/s)")
    p.add_argument("--chaos-node-group", type=int, default=2,
                   help="replicas killed per correlated node failure")
    # admission front door (evaluated before dispatch)
    p.add_argument("--admission-policy", default=None,
                   choices=list(ADMISSION_POLICIES),
                   help="overload front door ahead of dispatch "
                        "(default: none)")
    p.add_argument("--admission-rate", type=float, default=0.0,
                   help="token_bucket: sustained admits/s")
    p.add_argument("--admission-burst", type=int, default=1,
                   help="token_bucket: burst depth in requests")
    p.add_argument("--admission-queue", type=int, default=0,
                   help="token_bucket: door-queue slots beyond the bucket")
    p.add_argument("--breaker-threshold", type=float, default=0.5,
                   help="breaker: rolling failure fraction that trips OPEN")
    p.add_argument("--breaker-window", type=float, default=10.0,
                   help="breaker: rolling terminal-outcome window (s)")
    p.add_argument("--breaker-cooloff", type=float, default=5.0,
                   help="breaker: OPEN hold before HALF_OPEN probing (s)")
    p.add_argument("--breaker-probes", type=int, default=3,
                   help="breaker: HALF_OPEN trial admissions")
    return p


def _replicas(args, n: int, pools: list[str]) -> tuple[ReplicaSpec, ...]:
    hws = [h.strip() for h in args.hw.split(",") if h.strip()]
    sched = SchedConfig(policy=args.policy, slots=args.slots,
                        token_budget=args.token_budget,
                        admission=args.admission, slo_ttft=args.slo_ttft)
    return tuple(
        ReplicaSpec(hw=hws[i % len(hws)], tp=args.tp, prec=args.prec,
                    pool=pools[i], sched=sched, ctx_quantum=args.ctx_quantum,
                    kv_block_tokens=args.block_tokens)
        for i in range(n))


def _fmt_row(label: str, s: dict, extra: str = "") -> str:
    return (f"{label:<14} "
            f"{s['ttft_p50']:>6.2f}/{s['ttft_p95']:.2f}  "
            f"{s['tpot_p50'] * 1e3:>6.1f}/{s['tpot_p95'] * 1e3:.1f}  "
            f"{s['e2e_p95']:>7.2f}  {s['tokens_per_s']:>7.0f} "
            f"{s['goodput_frac']:>7.0%}{extra}")


def main(argv=None) -> None:
    """Simulate (or `--plan`) the configured fleet and print per-pool
    latency (seconds) / goodput / $-per-hour summaries."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.config)
    wl = Workload(
        name=args.replay or "synthetic", qps=args.qps, num_requests=args.requests,
        arrival=args.arrival,
        prompt=LengthDist(args.prompt_dist, args.prompt_mean, args.prompt_sigma),
        output=LengthDist(args.output_dist, args.output_mean, args.output_sigma),
        seed=args.seed, trace_path=args.replay, num_sessions=args.sessions,
        diurnal_period=args.diurnal_period, diurnal_amp=args.diurnal_amp,
        rate_path=args.rate_path, num_prefix_groups=args.prefix_groups,
        prefix=LengthDist("fixed", args.prefix_len))
    reqs = wl.generate()
    pcache = None
    if args.prefix_cache:
        pcache = PrefixCacheConfig(
            budget_frac=args.cache_frac,
            budget_bytes=args.cache_gb * 1e9 if args.cache_gb is not None
            else None,
            ttl=args.cache_ttl)
    chaos = None
    if any(r > 0 for r in (args.chaos_crashes, args.chaos_stragglers,
                           args.chaos_links, args.chaos_nodes)):
        chaos = ChaosConfig(
            seed=args.chaos_seed, horizon=args.chaos_horizon,
            crash_rate=args.chaos_crashes,
            straggler_rate=args.chaos_stragglers,
            link_rate=args.chaos_links,
            node_failure_rate=args.chaos_nodes,
            node_group=args.chaos_node_group)
    admission = None
    if args.admission_policy is not None:
        admission = AdmissionConfig(
            policy=args.admission_policy, rate=args.admission_rate,
            burst=args.admission_burst, queue_depth=args.admission_queue,
            window=args.breaker_window, fail_thresh=args.breaker_threshold,
            cooloff=args.breaker_cooloff, probes=args.breaker_probes)
    autoscale = None
    if args.autoscale or args.pool_autoscale:
        base = AutoscaleConfig(
            policy=args.autoscale_policy, min_replicas=args.min_replicas,
            max_replicas=args.max_replicas, interval=args.scale_interval,
            window=args.scale_window, target_qps_per_replica=args.target_qps,
            slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot,
            warmup=args.warmup, lookahead=args.lookahead,
            target_wait=args.target_wait, spare=args.spare)

        def _pool_cfg(policy: str) -> AutoscaleConfig:
            asc = replace(base, policy=policy)
            # the predictive policy needs the generator's rate envelope
            # and traffic shape; reactive policies are self-contained
            return seed_predictive(asc, wl, reqs) if policy == "predictive" \
                else asc

        if args.pool_autoscale:
            if args.mode != "disaggregated":
                raise SystemExit(
                    "--pool-autoscale scales prefill/decode pools "
                    "independently; pair it with --mode disaggregated")
            autoscale = {"prefill": _pool_cfg(args.prefill_policy),
                         "decode": _pool_cfg(args.decode_policy)}
        else:
            autoscale = _pool_cfg(args.autoscale_policy)

    if args.plan:
        if args.trace:
            print("# note: --trace records single runs; the --plan sweep "
                  "is untraced")
        hws = [h.strip() for h in args.hw.split(",") if h.strip()]
        if len(hws) > 1:
            print(f"# note: --plan sweeps homogeneous fleets; using {hws[0]!r} "
                  f"(ignoring {', '.join(hws[1:])})")
        if autoscale is not None or args.shed_depth is not None \
                or chaos is not None or admission is not None:
            print("# note: --plan sizes STATIC fault-free fleets; "
                  "--autoscale/--shed-*/--chaos-*/--admission-* flags are "
                  "ignored by the sweep (drop --plan to run the dynamic "
                  "fleet; --plan-loss sizes for N-replica loss)")
        sched = SchedConfig(policy=args.policy, slots=args.slots,
                            token_budget=args.token_budget,
                            admission=args.admission, slo_ttft=args.slo_ttft)
        cache_fracs = None
        if args.plan_cache_fracs:
            cache_fracs = tuple(float(x) for x in
                                args.plan_cache_fracs.split(",") if x.strip())
        plan = plan_capacity(
            cfg, wl, qps=args.qps, slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot,
            attainment=args.attainment, hw=hws[0], tp=args.tp,
            prec=args.prec, sched=sched, router=args.router,
            decode_router=args.decode_router, hit_frac=args.hit_frac,
            kv_block_tokens=args.block_tokens, ctx_quantum=args.ctx_quantum,
            max_replicas=args.plan_max_replicas,
            prefix_cache=None if cache_fracs else pcache,
            cache_fracs=cache_fracs, cache_ttl=args.cache_ttl,
            loss_tolerance=args.plan_loss, engine=args.engine,
            sweep_workers=args.sweep_workers)
        print(f"# capacity plan: {cfg.name} @ {args.qps:g} qps, "
              f"SLO ttft<={args.slo_ttft:g}s tpot<={args.slo_tpot:g}s, "
              f"attainment>={args.attainment:.0%}"
              + (f", survives loss of {args.plan_loss}"
                 if args.plan_loss else ""))
        loss_col = f" {'-' + str(args.plan_loss) + 'rep':>7}" \
            if args.plan_loss else ""
        hdr = (f"{'mode':<14} {'repl':>4} {'P/D':>5} {'cache':>6} {'$/hr':>7} "
               f"{'attain':>7}{loss_col} {'ttft_p95':>9} {'tpot_p95':>9} "
               f"{'feasible':>9}")
        print(hdr)
        print("-" * len(hdr))
        for r in plan["rows"]:
            pd = (f"{r['prefill']}/{r['decode']}"
                  if r["mode"] == "disaggregated" else "-")
            cf = ("-" if r.get("cache_frac") is None
                  else f"{r['cache_frac']:.2f}")
            if "error" in r:
                print(f"{r['mode']:<14} {r['replicas']:>4} {pd:>5} {cf:>6} "
                      f"{r['cost_per_hr']:>7.2f} {'-':>7}"
                      + (f" {'-':>7}" if args.plan_loss else "")
                      + f" {'-':>9} {'-':>9} {'no (kv)':>9}")
                continue
            loss = (f" {r['goodput_frac_loss']:>7.0%}"
                    if args.plan_loss else "")
            print(f"{r['mode']:<14} {r['replicas']:>4} {pd:>5} {cf:>6} "
                  f"{r['cost_per_hr']:>7.2f} {r['goodput_frac']:>7.0%}{loss} "
                  f"{r['ttft_p95']:>8.2f}s {r['tpot_p95'] * 1e3:>7.1f}ms "
                  f"{'YES' if r['feasible'] else 'no':>9}")
        best = plan["best"]
        if best is None:
            print("# no feasible plan within the sweep — raise "
                  "--plan-max-replicas or relax the SLOs")
        else:
            pd = (f" ({best['prefill']}P/{best['decode']}D)"
                  if best["mode"] == "disaggregated" else "")
            cache = (f", cache={best['cache_frac']:.0%} of KV"
                     if best.get("cache_frac") is not None else "")
            print(f"# cheapest feasible: {best['mode']}{pd} x{best['replicas']} "
                  f"at ${best['cost_per_hr']:.2f}/hr "
                  f"({best['goodput_frac']:.0%} attainment{cache})")
        return

    modes = (["colocated", "disaggregated"] if args.mode == "both"
             else [args.mode])
    n = args.replicas
    n_p = args.prefill_replicas if args.prefill_replicas is not None else n // 2
    print(f"# {cfg.name} cluster | {n} replicas [{args.hw}] tp={args.tp} | "
          f"{len(reqs)} requests, {args.arrival} arrivals @ {args.qps:g} qps | "
          f"router={args.router}")
    hdr = (f"{'mode':<14} {'ttft p50/p95(s)':>15} {'tpot p50/p95(ms)':>16} "
           f"{'e2e_p95':>8} {'tok/s':>7} {'goodput':>8}")
    print(hdr)
    print("-" * len(hdr))
    results = {}
    for mode in modes:
        if mode == "disaggregated":
            if n < 2:
                print("disaggregated   (skipped: needs >= 2 replicas)")
                continue
            if not 1 <= n_p <= n - 1:
                raise SystemExit(f"--prefill-replicas must be in [1, {n - 1}]")
            pools = ["prefill"] * n_p + ["decode"] * (n - n_p)
        else:
            pools = ["mixed"] * n
        spec = ClusterSpec(replicas=_replicas(args, n, pools),
                           router=args.router, decode_router=args.decode_router,
                           hit_frac=args.hit_frac,
                           router_slo_ttft=args.slo_ttft,
                           shed_depth=args.shed_depth,
                           retry_after=args.retry_after,
                           max_retries=args.max_retries,
                           retry_backoff=args.retry_backoff,
                           retry_jitter=args.retry_jitter,
                           retry_seed=args.seed,
                           prefix_cache=pcache,
                           chaos=chaos, admission=admission)
        tracer = make_tracer(args.trace_level if args.trace else "off",
                             counter_dt=args.trace_counter_dt)
        monitor = None
        if args.slo_window is not None:
            monitor = SLOMonitor(make_slos(
                slo_ttft=args.slo_ttft, slo_goodput=args.slo_goodput,
                window=args.slo_window))
        elif args.slo_goodput is not None:
            raise SystemExit("--slo-goodput needs --slo-window to enable "
                             "the live SLO monitor")
        try:
            cres = simulate_cluster(reqs, cfg, spec, autoscale=autoscale,
                                    tracer=tracer, monitor=monitor,
                                    engine=args.engine)
        except ValueError as e:
            print(f"{mode:<14} (skipped: {e})")
            continue
        s = summarize_cluster(cres, slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot)
        results[mode] = (spec, cres, s)
        label = mode if mode == "colocated" else f"disagg {n_p}P/{n - n_p}D"
        print(_fmt_row(label, s))
        if tracer.enabled and args.trace:
            # the SLO monitor can force the tracer on without
            # --trace; only export when a path was actually given
            path = args.trace
            if len(modes) > 1:
                root, ext = os.path.splitext(path)
                path = f"{root}.{mode}{ext or '.json'}"
            fmt = write_trace(tracer.events, path, tracer.meta)
            print(f"# trace [{fmt}, level={args.trace_level}]: "
                  f"{len(tracer.events)} events -> {path}")

    for mode, (spec, cres, s) in results.items():
        dynamic = autoscale is not None
        if dynamic:
            # a dynamic fleet has no single $/hr: bill the actual spans
            prov = provisioning_summary(cres, shed_cost_usd=args.shed_cost)
            hours = max(cres.makespan / 3600.0, 1e-12)
            price = f"${prov['cost_usd'] / hours:.2f}/hr avg (dynamic)"
        else:
            price = f"${cluster_price_per_hr(spec):.2f}/hr"
        print(f"\n# {mode}: {price}, "
              f"preemptions={s['preemptions']}, "
              f"util=[{', '.join(f'{u:.0%}' for u in s['replica_util'])}]"
              + (f", kv-transfer: {s['xfer_count']} moves, {s['xfer_gb']:.2f} GB, "
                 f"{s['xfer_s_mean'] * 1e3:.2f} ms mean (p2p), "
                 f"{s['xfer_share']:.2%} of e2e"
                 if cres.mode == "disaggregated" else "")
              + (f", prefix_hits={s['prefix_hits']}"
                 if args.router == "affinity" or args.prefix_cache else "")
              + (f", shed={s['shed']} ({s['shed_frac']:.1%}), "
                 f"retries={s['retries']}"
                 if args.shed_depth is not None else ""))
        if cres.chaos_stats is not None:
            ch = cres.chaos_stats
            print(f"  chaos: {ch['crashes']} crashes, "
                  f"{ch['stragglers']} stragglers, "
                  f"{ch['link_degrades']} link degradations | "
                  f"lost={s['requests_lost']} requests, "
                  f"displaced={ch['displaced']} "
                  f"(re-prefill {ch['re_prefill_tokens']} tok, "
                  f"restored {ch['restored_tokens']} tok), "
                  f"recovery mean/max "
                  f"{ch['recovery_s_mean']:.2f}/{ch['recovery_s_max']:.2f}s")
        if cres.admission_stats is not None:
            ad = cres.admission_stats
            print(f"  door [{ad['policy']}]: {ad['door_admitted']} admitted, "
                  f"{ad['door_delayed']} delayed, {ad['door_shed']} shed"
                  + (f", {ad['breaker_opens']} opens "
                     f"(final state {ad['breaker_state']})"
                     if ad["policy"] == "breaker" else ""))
        if cres.slo is not None:
            print(f"  slo monitor: time_in_violation="
                  f"{s['time_in_violation']:g}s, "
                  f"alerts_fired={s['alerts_fired']}, "
                  f"budget_burn={s['budget_burn']:.1%}, "
                  f"anomalies={s['anomalies']}")
            for a in cres.slo["alerts"]:
                if a["state"] in ("firing", "resolved"):
                    print(f"    t={a['t']:7.2f}s {a['state']:<9} "
                          f"{a['rule']} [{a['slo']}] "
                          f"burn={a['burn_long']:.1f}/{a['burn_short']:.1f} "
                          f"(>= {a['burn_threshold']:g})")
        if args.prefix_cache:
            print(f"  prefix cache: {s['cache_hit_rate']:.0%} hit rate, "
                  f"{s['cache_hit_tokens']} prompt tokens skipped, "
                  f"{s['cache_evictions']} evictions, "
                  f"peak resident {s['cache_resident_gb']:.2f} GB/replica, "
                  f"{s['cache_invalidations']} invalidations")
        if dynamic:
            label = (f"pool-aware {args.prefill_policy}/{args.decode_policy}"
                     if args.pool_autoscale else args.autoscale_policy)
            print(f"  autoscale [{label}]: "
                  f"{s['scale_events']} scale events, "
                  f"peak {s['peak_replicas']} replicas, "
                  f"{prov['replica_hours'] * 3600:.1f} replica-s vs "
                  f"{prov['replica_hours_static_peak'] * 3600:.1f} static-peak "
                  f"(${prov['cost_usd']:.4f} vs "
                  f"${prov['cost_usd_static_peak']:.4f}, "
                  f"{prov['savings_frac']:.0%} saved)")
            if args.shed_cost > 0:
                print(f"  shed cost: {prov['shed']} dropped x "
                      f"${args.shed_cost:.4f} = ${prov['shed_cost_usd']:.4f} "
                      f"-> total ${prov['cost_usd_total']:.4f}")
            if args.pool_autoscale:
                for pool, pp in prov["pools"].items():
                    print(f"  pool {pool:<8} billing: "
                          f"{pp['replica_hours'] * 3600:.1f} replica-s, "
                          f"${pp['cost_usd']:.4f}, "
                          f"peak {pp['peak_replicas']} replicas")
            for ev in cres.scale_events:
                print(f"    t={ev['t']:7.2f}s {ev['action']:<7} "
                      f"r{ev['replica']} [{ev['pool']}]"
                      + (f" ready t={ev['ready']:.2f}s"
                         if ev["action"] == "add" else ""))
        for pool, ps in pool_summaries(cres, slo_ttft=args.slo_ttft,
                                       slo_tpot=args.slo_tpot).items():
            print(f"  pool {pool:<8} x{ps['replicas']}: "
                  f"ttft p95 {ps['ttft_p95']:.2f}s, "
                  f"tpot p95 {ps['tpot_p95'] * 1e3:.1f}ms, "
                  f"goodput {ps['goodput_frac']:.0%}, "
                  f"util {ps['util_mean']:.0%}, "
                  f"peak KV {ps['peak_kv_gb']:.1f} GB, "
                  f"preempt {ps['preemptions']}")


if __name__ == "__main__":
    main()
