"""Trace-to-trace comparison: `python -m repro_torch.obs diff a.jsonl b.jsonl`.

Compares two recorded traces along the axes a capacity review actually
argues about — latency percentiles, completion/shed mix, per-phase time,
event mix, the scaling timeline, and the alert timeline — and turns the
comparison into a CI gate: `--fail-on metric=tolerance` overrides the
default thresholds, and any metric of trace B that regresses past its
tolerance relative to trace A makes the CLI exit non-zero. Checked-in
golden baseline traces plus this gate give trace-level regression
coverage that summary-metric assertions can't (a schedule change that
leaves p50 alone still shifts the event mix or the scaling timeline).

Thresholds are one-sided — only the *worse* direction trips them
(latency up, completion down, shed up, more alerts firing) — and the
defaults are deliberately loose so that two runs differing only in
workload seed pass while a genuinely degraded run (half the replica cap,
an overload burst) fails; tighten per-metric via `--fail-on` where a
baseline is stable enough to afford it.

A copy of `repro.obs.diff` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

from collections import Counter

from .report import PHASES, analyze

# one-sided tolerances: relative for latency (fraction of A's value the
# B value may exceed it by), absolute for fractions/counts
DEFAULT_THRESHOLDS = {
    "ttft_p50": 0.75, "ttft_p99": 0.75, "tpot_p99": 0.75,
    "e2e_p50": 0.75, "e2e_p99": 0.75,
    "completion_frac": 0.05, "shed_frac": 0.05, "drop_frac": 0.05,
}

# metrics where bigger is better (regression = decrease); everything else
# regresses upward
_HIGHER_BETTER = ("completion_frac",)
# absolute-delta metrics (fractions and counts); the rest compare relative
_ABSOLUTE = ("completion_frac", "shed_frac", "drop_frac", "alerts_firing",
             "time_in_violation", "anomalies", "scale_ops")


def _metrics(rep: dict) -> dict:
    """Flatten an `analyze()` result into the comparable scalar metrics."""
    s = rep["summary"]
    n = max(s["n_requests"], 1)
    m = {k: s[k] for k in s if k.startswith(("ttft_", "tpot_", "e2e_"))
         and not k.endswith("_n")}
    m["completion_frac"] = s["n_complete"] / n
    m["shed_frac"] = s["n_shed"] / n
    m["drop_frac"] = s["n_drop"] / n
    m["scale_ops"] = len(rep["scale_ops"])
    m["alerts_firing"] = sum(1 for a in rep["alerts"] if a["state"] == "firing")
    m["anomalies"] = len(rep["anomalies"])
    m["time_in_violation"] = sum(
        (w["t"] - w["t0"]) for w in rep["slo_windows"] if w.get("ok") is False)
    return m


def _event_mix(events) -> Counter:
    return Counter((ev.get("ev"), ev.get("name")) for ev in events)


def diff_traces(a: tuple, b: tuple) -> dict:
    """Compare two `(meta, events)` traces; returns the diff data model
    (plain dicts — `render_diff` draws it, `regressions` gates on it)."""
    meta_a, events_a = a
    meta_b, events_b = b
    ra, rb = analyze(events_a, meta_a), analyze(events_b, meta_b)
    ma, mb = _metrics(ra), _metrics(rb)

    summary = {}
    for k in ma:
        va, vb = ma[k], mb.get(k, 0.0)
        summary[k] = {"a": va, "b": vb, "delta": vb - va,
                      "rel": (vb - va) / va if va else None}

    phases = {}
    for ph in PHASES:
        pa, pb = ra["phase_stats"].get(ph), rb["phase_stats"].get(ph)
        if pa is None and pb is None:
            continue
        row = {}
        for p in (50, 99):
            va = pa[f"{ph}_p{p:g}"] if pa else 0.0
            vb = pb[f"{ph}_p{p:g}"] if pb else 0.0
            row[f"p{p:g}"] = {"a": va, "b": vb, "delta": vb - va}
        phases[ph] = row

    mix_a, mix_b = _event_mix(events_a), _event_mix(events_b)
    event_mix = {f"{kind}:{name}": {"a": mix_a.get((kind, name), 0),
                                    "b": mix_b.get((kind, name), 0)}
                 for kind, name in sorted(set(mix_a) | set(mix_b))
                 if mix_a.get((kind, name)) != mix_b.get((kind, name))}

    ops_a = [(o["op"], o["t"]) for o in ra["scale_ops"]]
    ops_b = [(o["op"], o["t"]) for o in rb["scale_ops"]]
    first_div = None
    for i, (oa, ob) in enumerate(zip(ops_a, ops_b)):
        if oa[0] != ob[0]:
            first_div = {"index": i, "a": oa, "b": ob}
            break
    if first_div is None and len(ops_a) != len(ops_b):
        i = min(len(ops_a), len(ops_b))
        first_div = {"index": i,
                     "a": ops_a[i] if i < len(ops_a) else None,
                     "b": ops_b[i] if i < len(ops_b) else None}
    scaling = {
        "ops": {op: {"a": Counter(o for o, _ in ops_a)[op],
                     "b": Counter(o for o, _ in ops_b)[op]}
                for op in sorted({o for o, _ in ops_a} | {o for o, _ in ops_b})},
        "replicas": {"a": len(ra["replicas"]), "b": len(rb["replicas"])},
        "first_divergence": first_div,
    }

    def first_firing(rep):
        ts = [a["t"] for a in rep["alerts"] if a["state"] == "firing"]
        return min(ts) if ts else None
    alerts = {
        "counts": {st: {"a": sum(1 for x in ra["alerts"] if x["state"] == st),
                        "b": sum(1 for x in rb["alerts"] if x["state"] == st)}
                   for st in ("pending", "firing", "resolved")},
        "first_firing": {"a": first_firing(ra), "b": first_firing(rb)},
    }

    return {"summary": summary, "phases": phases, "event_mix": event_mix,
            "scaling": scaling, "alerts": alerts,
            "meta": {"a": meta_a, "b": meta_b}}


def regressions(diff: dict, thresholds: dict | None = None) -> list[str]:
    """One string per metric of trace B that regressed past its tolerance
    (empty == B is no worse than A). Only metrics named in `thresholds`
    are gated; unknown metric names raise (a misspelled `--fail-on` must
    not silently gate nothing)."""
    thresholds = DEFAULT_THRESHOLDS if thresholds is None else thresholds
    out = []
    for metric, tol in thresholds.items():
        row = diff["summary"].get(metric)
        if row is None:
            raise KeyError(f"unknown diff metric {metric!r}; known: "
                           f"{sorted(diff['summary'])}")
        va, vb = row["a"], row["b"]
        if metric in _HIGHER_BETTER:
            worse = va - vb
        else:
            worse = vb - va
        if metric not in _ABSOLUTE:
            if va <= 0:
                continue  # no baseline signal to compare against
            worse /= va
        if worse > tol:
            kind = "abs" if metric in _ABSOLUTE else "rel"
            out.append(f"{metric}: a={va:.6g} b={vb:.6g} "
                       f"({kind} change {worse:+.3g} > tolerance {tol:g})")
    return out


def parse_fail_on(spec: str | None) -> dict:
    """`--fail-on "ttft_p99=0.2,completion_frac=0.01"` -> thresholds dict
    merged over the defaults (None/'' -> defaults unchanged)."""
    out = dict(DEFAULT_THRESHOLDS)
    if not spec:
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"--fail-on entry {part!r} is not metric=tolerance")
        k, v = part.split("=", 1)
        out[k.strip()] = float(v)
    return out


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_diff(diff: dict, problems: list[str] | None = None) -> str:
    """Human-readable diff text (the CLI's stdout)."""
    out = ["trace diff (a -> b)", ""]
    out.append("summary metrics:")
    out.append(f"  {'metric':<18}{'a':>12}{'b':>12}{'delta':>12}{'rel':>9}")
    for k, row in diff["summary"].items():
        rel = f"{row['rel']:+.1%}" if row["rel"] is not None else "-"
        out.append(f"  {k:<18}{_fmt(row['a']):>12}{_fmt(row['b']):>12}"
                   f"{_fmt(row['delta']):>12}{rel:>9}")
    if diff["phases"]:
        out.append("")
        out.append("per-phase percentiles (s):")
        out.append(f"  {'phase':<12}{'p50 a':>10}{'p50 b':>10}"
                   f"{'p99 a':>10}{'p99 b':>10}")
        for ph, row in diff["phases"].items():
            out.append(f"  {ph:<12}{row['p50']['a']:>10.4f}{row['p50']['b']:>10.4f}"
                       f"{row['p99']['a']:>10.4f}{row['p99']['b']:>10.4f}")
    if diff["event_mix"]:
        out.append("")
        out.append(f"event-mix deltas ({len(diff['event_mix'])} kinds differ):")
        for key, row in list(diff["event_mix"].items())[:25]:
            out.append(f"  {key:<32}{row['a']:>8} -> {row['b']}")
    sc = diff["scaling"]
    out.append("")
    out.append(f"scaling: replicas {sc['replicas']['a']} -> "
               f"{sc['replicas']['b']}")
    for op, row in sc["ops"].items():
        out.append(f"  {op:<16}{row['a']:>8} -> {row['b']}")
    fd = sc["first_divergence"]
    if fd is not None:
        out.append(f"  first divergence at op #{fd['index']}: "
                   f"a={fd['a']} b={fd['b']}")
    al = diff["alerts"]
    if any(r["a"] or r["b"] for r in al["counts"].values()):
        out.append("")
        out.append("alerts:")
        for st, row in al["counts"].items():
            out.append(f"  {st:<10}{row['a']:>8} -> {row['b']}")
        ff = al["first_firing"]
        out.append(f"  first firing: a={_fmt(ff['a'])}s b={_fmt(ff['b'])}s")
    if problems is not None:
        out.append("")
        if problems:
            out.append(f"REGRESSIONS ({len(problems)}):")
            out.extend(f"  ! {p}" for p in problems)
        else:
            out.append("no regressions: b is within tolerance of a")
    return "\n".join(out)
