"""Offline trace analysis: `python -m repro_torch.obs report <trace.jsonl>`.

Rebuilds serving metrics from a JSONL trace alone — no simulator state —
which is the calibration contract from ROADMAP item 5: anything that
emits this schema (the sim today, a real engine later) gets the same
analysis. Three sections:

  * latency summary — TTFT/TPOT/E2E percentiles fed through
    `StreamingQuantiles` (one pass over terminal events, no record list),
    reproducing `summarize_cluster`'s exact p50/p99 at trace sizes where
    the tail reservoir covers the ranks;
  * top-k slowest requests with their per-phase time breakdown
    (queued/prefill/handoff/decode_wait/decode), the "why was this one
    slow" view;
  * per-replica utilization (busy seconds vs provisioned extent, from
    the `busy_s` counter and `provisioned` spans) and the
    scaling-decision timeline (every `autoscale.decision` with the policy
    inputs that drove it, plus `scale.up`/`scale.down`/retire outcomes).

A copy of `repro.obs.report` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

from .export import read_jsonl
from .quantiles import StreamingQuantiles, percentile_summary
from .tracer import TERMINALS, validate_trace

PHASES = ("queued", "prefill", "handoff", "decode_wait", "decode")


def analyze(events, meta=None, *, topk: int = 10) -> dict:
    """Digest an event stream into the report's data model (plain dicts,
    render-agnostic — tests consume this directly)."""
    meta = dict(meta or {})
    phase_by_rid: dict[object, dict[str, float]] = {}
    span_bounds: dict[object, list[float]] = {}
    prefill_track: dict[object, str] = {}
    requests: list[dict] = []
    busy: dict[str, float] = {}
    provisioned: dict[str, float] = {}
    completed_per_track: dict[str, int] = {}
    decisions: list[dict] = []
    scale_ops: list[dict] = []
    counts: dict[str, int] = {}
    slo_windows: list[dict] = []
    alerts: list[dict] = []
    anomalies: list[dict] = []

    for ev in events:
        kind = ev.get("ev")
        name = ev.get("name")
        if kind == "span":
            rid = ev.get("rid")
            if rid is not None and name in PHASES:
                dur = ev["t1"] - ev["t0"]
                phase_by_rid.setdefault(rid, {})
                phase_by_rid[rid][name] = phase_by_rid[rid].get(name, 0.0) + dur
                b = span_bounds.setdefault(rid, [ev["t0"], ev["t1"]])
                b[0] = min(b[0], ev["t0"])
                b[1] = max(b[1], ev["t1"])
                if name == "prefill":
                    prefill_track[rid] = ev.get("track", "")
            elif name == "provisioned":
                track = ev.get("track", "")
                provisioned[track] = provisioned.get(track, 0.0) + (ev["t1"] - ev["t0"])
        elif kind == "instant":
            if name in TERMINALS:
                counts[name] = counts.get(name, 0) + 1
                rid = ev.get("rid")
                at = dict(ev.get("attrs", ()))
                row = {"rid": rid, "t": ev["t"], "outcome": name.split(".")[1],
                       "track": ev.get("track", ""),
                       "ttft": at.get("ttft"), "tpot": at.get("tpot"),
                       "e2e": at.get("e2e")}
                requests.append(row)
                if name == "request.complete":
                    tr = ev.get("track", "")
                    completed_per_track[tr] = completed_per_track.get(tr, 0) + 1
            elif name == "autoscale.decision":
                decisions.append({"t": ev["t"], **dict(ev.get("attrs", ()))})
            elif name in ("scale.up", "scale.down", "scale.cancel",
                          "replica.retired"):
                scale_ops.append({"t": ev["t"], "op": name,
                                  "track": ev.get("track", ""),
                                  **dict(ev.get("attrs", ()))})
            elif name == "slo.window":
                slo_windows.append({"t": ev["t"], **dict(ev.get("attrs", ()))})
            elif name.startswith("alert."):
                alerts.append({"t": ev["t"], "state": name.split(".", 1)[1],
                               **dict(ev.get("attrs", ()))})
            elif name.startswith("anomaly."):
                anomalies.append({"t": ev["t"], "series": name.split(".", 1)[1],
                                  "track": ev.get("track", ""),
                                  **dict(ev.get("attrs", ()))})
        elif kind == "counter" and name == "busy_s":
            # cumulative counter: the last sample is the total
            tr = ev.get("track", "")
            busy[tr] = max(busy.get(tr, 0.0), ev["value"])

    # phase spans may arrive before OR after a rid's terminal (live
    # terminals precede the post-run span emission), so resolve phases
    # only after the full pass
    for row in requests:
        rid = row["rid"]
        row["phases"] = phase_by_rid.get(rid, {})
        if row["e2e"] is None and rid in span_bounds:
            row["e2e"] = span_bounds[rid][1] - span_bounds[rid][0]
        if row["ttft"] is None and "prefill" in row["phases"]:
            row["ttft"] = (row["phases"].get("queued", 0.0)
                           + row["phases"]["prefill"])

    summary: dict = {"n_requests": len(requests)}
    for key in ("ttft", "tpot", "e2e"):
        sq = StreamingQuantiles()
        for r in requests:
            if r["outcome"] == "complete" and r[key] is not None:
                sq.add(r[key])
        summary.update(sq.summary(key))
        summary[f"{key}_n"] = sq.n
    for term in TERMINALS:
        summary[term.replace("request.", "n_")] = counts.get(term, 0)

    phase_stats: dict[str, dict] = {}
    for ph in PHASES:
        vals = [d[ph] for d in phase_by_rid.values() if ph in d]
        if vals:
            phase_stats[ph] = percentile_summary(vals, ph)
            phase_stats[ph][f"{ph}_n"] = len(vals)

    done = [r for r in requests if r["outcome"] == "complete" and r["e2e"] is not None]
    # e2e ties break by rid so --topk output is stable across runs/platforms
    slowest = sorted(done, key=lambda r: (-r["e2e"], r["rid"]))[:topk]

    tracks = sorted(set(provisioned) | set(busy) | set(completed_per_track))
    util = []
    for tr in tracks:
        span = provisioned.get(tr, 0.0)
        b = busy.get(tr, 0.0)
        util.append({"track": tr or "cluster", "provisioned_s": span,
                     "busy_s": b, "util": (b / span) if span > 0 else 0.0,
                     "completed": completed_per_track.get(tr, 0)})

    return {"meta": meta, "summary": summary, "slowest": slowest,
            "phase_stats": phase_stats, "replicas": util,
            "decisions": decisions, "scale_ops": scale_ops,
            "slo_windows": slo_windows, "alerts": alerts,
            "anomalies": anomalies, "problems": validate_trace(events)}


def _fmt_ms(x) -> str:
    return f"{x * 1e3:9.2f}" if x is not None else "        -"


def render(rep: dict) -> str:
    """Render an `analyze()` result as the human-readable report text."""
    out: list[str] = []
    meta, s = rep["meta"], rep["summary"]
    head = f"trace: schema={meta.get('schema', '?')}"
    if "horizon" in meta:
        head += f"  origin={meta.get('t0', 0.0):g}s  horizon={meta['horizon']:g}s"
    out.append(head)
    out.append(f"requests: {s['n_requests']}  completed={s['n_complete']}  "
               f"shed={s['n_shed']}  dropped={s['n_drop']}")
    out.append("")
    out.append("latency (ms)        p50       p95       p99     p99.9      mean")
    for key in ("ttft", "tpot", "e2e"):
        row = "  ".join(_fmt_ms(s[f"{key}_p{p:g}"]) for p in (50, 95, 99, 99.9))
        out.append(f"  {key:<12}{row}  {_fmt_ms(s[f'{key}_mean'])}")
    if rep["slowest"]:
        out.append("")
        out.append(f"top {len(rep['slowest'])} slowest requests (s):")
        out.append("  rid        e2e     ttft   queued  prefill  handoff  "
                   "dec_wait   decode  replica")
        for r in rep["slowest"]:
            ph = r["phases"]
            out.append(
                f"  {str(r['rid']):<6}{r['e2e']:>8.3f} {r['ttft'] or 0.0:>8.3f}"
                f" {ph.get('queued', 0.0):>8.3f} {ph.get('prefill', 0.0):>8.3f}"
                f" {ph.get('handoff', 0.0):>8.3f} {ph.get('decode_wait', 0.0):>9.3f}"
                f" {ph.get('decode', 0.0):>8.3f}  {r['track']}")
    if rep["replicas"]:
        out.append("")
        out.append("per-replica utilization:")
        out.append("  replica           prov_s    busy_s   util  completed")
        for u in rep["replicas"]:
            out.append(f"  {u['track']:<16}{u['provisioned_s']:>8.2f}"
                       f"  {u['busy_s']:>8.2f}  {u['util']:>5.1%}"
                       f"  {u['completed']:>9d}")
    if rep["decisions"] or rep["scale_ops"]:
        out.append("")
        out.append("scaling timeline:")
        timeline = ([{"kind": "decision", **d} for d in rep["decisions"]]
                    + [{"kind": "op", **o} for o in rep["scale_ops"]])
        timeline.sort(key=lambda e: e["t"])
        for e in timeline:
            if e["kind"] == "op":
                out.append(f"  t={e['t']:>8.2f}s  {e['op']:<10} "
                           f"pool={e.get('pool', '-')} {e.get('track', '')}")
            else:
                inputs = "  ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in e.items()
                    if k not in ("kind", "t", "policy", "pool"))
                out.append(f"  t={e['t']:>8.2f}s  decision   "
                           f"pool={e.get('pool', '-')} "
                           f"policy={e.get('policy', '?')}  {inputs}")
    if rep.get("slo_windows"):
        out.append("")
        out.append("SLO compliance (tumbling windows):")
        by_slo: dict[str, list[dict]] = {}
        for w in rep["slo_windows"]:
            by_slo.setdefault(w.get("slo", "?"), []).append(w)
        for slo, wins in by_slo.items():
            judged = [w for w in wins if w.get("ok") is not None]
            viol = [w for w in judged if w.get("ok") is False]
            tail = wins[-1]
            out.append(
                f"  {slo:<24} windows={len(judged)} violated={len(viol)}  "
                f"budget_remaining={tail.get('budget_remaining', 0.0):.1%}")
    if rep.get("alerts"):
        out.append("")
        out.append("alert timeline:")
        for a in rep["alerts"]:
            out.append(
                f"  t={a['t']:>8.2f}s  {a['state']:<9} {a.get('rule', '?'):<10}"
                f" slo={a.get('slo', '?')}  burn={a.get('burn_long', 0.0):.1f}"
                f"/{a.get('burn_short', 0.0):.1f}"
                f" (>= {a.get('burn_threshold', 0.0):g})")
    if rep.get("anomalies"):
        out.append("")
        out.append(f"anomalies ({len(rep['anomalies'])}):")
        for a in rep["anomalies"][:20]:
            out.append(f"  t={a['t']:>8.2f}s  {a['series']:<10} "
                       f"{a.get('track', '')}  value={a.get('value', 0.0):.3g} "
                       f"z={a.get('z', 0.0):+.1f}")
    if rep["problems"]:
        out.append("")
        out.append(f"TRACE PROBLEMS ({len(rep['problems'])}):")
        for p in rep["problems"][:20]:
            out.append(f"  ! {p}")
    return "\n".join(out)


def report_file(path, *, topk: int = 10) -> str:
    """Load a JSONL trace and render its report (the CLI entry point)."""
    meta, events = read_jsonl(path)
    return render(analyze(events, meta, topk=topk))
