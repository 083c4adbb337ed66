"""SLO metrics and throughput-latency sweeps for simulated serving runs.

One metric vocabulary shared with `Breakdown.ttft`/`.tpot` in
`repro_torch.core.predict`: TTFT is the prefill-side wait to the first emitted
token, TPOT the mean inter-token gap after it. Goodput counts only the
requests that met every configured SLO (the inference-perf convention),
normalized by makespan.

`summarize_records` aggregates any collection of `ReqRecord`s — one
replica's, one pool's, or a whole cluster's stitched records — so
`repro_torch.sim` and the cluster simulator (`repro_torch.cluster`)
report the same vocabulary at every level.
Percentile keys and interpolation come from `repro_torch.obs.quantiles`
(`PCTS` = p50/p95/p99/p99.9, numpy linear interpolation), the same
convention the streaming estimators in `repro_torch.obs` reproduce, so offline
trace analysis and in-sim summaries can never disagree on definitions.

A copy of `repro.sim.metrics` (the port imports nothing of the JAX package);
`tests/test_torch_sim.py` holds it to the original bit for bit.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from repro_torch.obs.quantiles import PCTS, percentile_summary
from repro_torch.sim.scheduler import SchedConfig, SimResult, simulate

__all__ = ["PCTS", "summarize_records", "summarize", "pareto_sweep",
           "dominates"]


def summarize_records(records, *, span: float | None = None,
                      slo_ttft: float | None = None,
                      slo_tpot: float | None = None) -> dict:
    """SLO metric dict over a bag of `ReqRecord`s. `span` is the makespan
    used to normalize throughput (defaults to the records' own span)."""
    recs = list(records)
    ttft = np.array([r.ttft for r in recs])
    e2e = np.array([r.e2e for r in recs])
    tpot = np.array([r.tpot for r in recs if r.output > 1])
    if span is None:
        span = (max(r.finish for r in recs) - min(r.arrival for r in recs)
                if recs else 0.0)
    out: dict = {"requests": len(recs)}
    for name, xs in (("ttft", ttft), ("tpot", tpot), ("e2e", e2e)):
        out.update(percentile_summary(xs, name))
    total_tokens = sum(r.output for r in recs)
    denom = max(span, 1e-12)
    out["makespan_s"] = span
    out["tokens_per_s"] = total_tokens / denom
    out["requests_per_s"] = len(recs) / denom
    ok = np.ones(len(recs), bool)
    if slo_ttft is not None:
        ok &= ttft <= slo_ttft
    if slo_tpot is not None:
        tpot_all = np.array([r.tpot for r in recs])
        ok &= tpot_all <= slo_tpot
    out["goodput_frac"] = float(ok.mean()) if len(recs) else 0.0
    out["goodput_rps"] = float(ok.sum()) / denom
    return out


def summarize(res: SimResult, *, slo_ttft: float | None = None,
              slo_tpot: float | None = None) -> dict:
    """Aggregate a SimResult into the SLO metric dict the CLI/benchmarks print."""
    out: dict = {
        "policy": res.policy,
        "iterations": res.iterations,
        "decode_steps": res.decode_steps,
        "preemptions": res.preemptions,
        "peak_kv_gb": res.peak_kv / 1e9,
        "kv_capacity_gb": res.kv_capacity / 1e9,
        "busy_s": res.busy_s,
        "kv_waste_gb": res.peak_kv_waste / 1e9,
        "kv_waste_frac": res.peak_kv_waste / res.peak_kv if res.peak_kv else 0.0,
    }
    out.update(summarize_records(res.records, span=res.makespan,
                                 slo_ttft=slo_ttft, slo_tpot=slo_tpot))
    return out


def pareto_sweep(requests, cost, *, policies=("static", "continuous", "chunked"),
                 slot_counts=(1, 2, 4, 8, 16), base: SchedConfig | None = None,
                 slo_ttft: float | None = None,
                 slo_tpot: float | None = None) -> list[dict]:
    """Throughput-latency frontier: simulate each (policy, slots) point on the
    SAME request trace and KV budget; rows carry tokens/s vs p95 e2e plus a
    `pareto` flag (non-dominated within the sweep)."""
    base = base or SchedConfig()
    rows = []
    for policy in policies:
        for slots in slot_counts:
            sc = replace(base, policy=policy, slots=slots,
                         token_budget=max(base.token_budget, slots))
            s = summarize(simulate(requests, cost, sc),
                          slo_ttft=slo_ttft, slo_tpot=slo_tpot)
            s["slots"] = slots
            rows.append(s)
    for row in rows:
        row["pareto"] = not any(dominates(o, row) for o in rows)
    return rows


def dominates(a: dict, b: dict) -> bool:
    """True when summary `a` beats `b` on the throughput-latency plane."""
    return (
        a["tokens_per_s"] >= b["tokens_per_s"]
        and a["e2e_p95"] <= b["e2e_p95"]
        and (a["tokens_per_s"] > b["tokens_per_s"] or a["e2e_p95"] < b["e2e_p95"])
    )
