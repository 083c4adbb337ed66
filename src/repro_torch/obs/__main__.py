"""CLI: offline trace analysis.

    python -m repro_torch.obs report trace.jsonl [--topk 10] [--validate-only]
                                           [--html out.html]
                                           [--slo-ttft S --slo-goodput F
                                            --slo-window W]
    python -m repro_torch.obs diff a.jsonl b.jsonl [--fail-on metric=tol,...]

Consumes the JSONL trace format written by `--trace out.jsonl` on
`python -m repro_torch.sim` (schema repro.obs/1).

`report` prints the latency summary, slowest-request breakdown,
per-replica utilization, scaling timeline, and (when the trace was
monitored) the SLO-compliance and alert sections; `--slo-ttft` /
`--slo-goodput` replay the online monitor offline over the recorded
trace (the online-vs-offline agreement path); `--html` additionally
renders the self-contained dashboard page. `--validate-only` runs just
the structural validator and exits non-zero on problems (a CI gate).

`diff` compares two traces (percentiles, event mix, scaling and alert
timelines) and exits non-zero when trace B regresses past the `--fail-on`
thresholds — the trace-regression CI gate against golden baselines.

A copy of `repro.obs.__main__` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import argparse
import sys

from .diff import diff_traces, parse_fail_on, regressions, render_diff
from .export import read_jsonl
from .monitor import make_slos, replay
from .report import analyze, render
from .tracer import validate_trace


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Offline analysis of repro_torch.obs JSONL traces.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser(
        "report", help="summarize a JSONL trace: latency percentiles, "
        "slowest requests, per-replica utilization, scaling timeline, "
        "SLO/alert sections, optional HTML dashboard")
    rep.add_argument("trace", help="path to a .jsonl trace written by --trace")
    rep.add_argument("--topk", type=int, default=10,
                     help="how many slowest requests to show (default 10)")
    rep.add_argument("--validate-only", action="store_true",
                     help="only run the structural trace validator; exit "
                     "non-zero if the trace is malformed")
    rep.add_argument("--html", metavar="PATH", default=None,
                     help="also render the self-contained HTML dashboard "
                     "(inline SVG, no JS) to PATH")
    rep.add_argument("--slo-ttft", type=float, default=None,
                     help="replay the SLO monitor offline: TTFT p99 "
                     "objective in seconds")
    rep.add_argument("--slo-goodput", type=float, default=None,
                     help="offline-replay goodput objective as a fraction "
                     "(e.g. 0.99)")
    rep.add_argument("--slo-window", type=float, default=30.0,
                     help="SLO compliance window in simulated seconds "
                     "(default 30)")
    dif = sub.add_parser(
        "diff", help="compare two JSONL traces (latency, phases, event "
        "mix, scaling + alert timelines); non-zero exit on regression")
    dif.add_argument("trace_a", help="baseline trace (.jsonl)")
    dif.add_argument("trace_b", help="candidate trace (.jsonl)")
    dif.add_argument("--fail-on", default=None, metavar="SPEC",
                     help="comma-separated metric=tolerance overrides "
                     "merged over the defaults, e.g. "
                     "'ttft_p99=0.2,completion_frac=0.01'")
    return ap


def _cmd_report(args) -> int:
    meta, events = read_jsonl(args.trace)
    if args.validate_only:
        problems = validate_trace(events)
        if problems:
            for p in problems:
                print(f"! {p}", file=sys.stderr)
            return 1
        print(f"ok: {len(events)} events, schema {meta.get('schema', '?')}")
        return 0
    rep = analyze(events, meta, topk=args.topk)
    print(render(rep))
    slos = make_slos(slo_ttft=args.slo_ttft, slo_goodput=args.slo_goodput,
                     window=args.slo_window)
    if slos:
        res = replay(meta, events, slos)
        print()
        print("offline SLO replay:")
        for s in res["slos"]:
            print(f"  {s['name']:<24} n={s['n']} bad={s['bad']} "
                  f"budget_consumed={s['budget_consumed']:.1%} "
                  f"time_in_violation={s['time_in_violation']:g}s")
        print(f"  alerts fired={res['alerts_fired']}  "
              f"time_in_violation={res['time_in_violation']:g}s")
    if args.html:
        from .dashboard import render_html
        html = render_html(events, meta, rep=rep)
        with open(args.html, "w", encoding="utf-8") as fh:
            fh.write(html)
        print(f"\nwrote dashboard: {args.html}")
    return 0


def _cmd_diff(args) -> int:
    a = read_jsonl(args.trace_a)
    b = read_jsonl(args.trace_b)
    diff = diff_traces(a, b)
    problems = regressions(diff, parse_fail_on(args.fail_on))
    print(render_diff(diff, problems))
    return 1 if problems else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "diff":
        return _cmd_diff(args)
    return _cmd_report(args)


if __name__ == "__main__":
    raise SystemExit(main())
