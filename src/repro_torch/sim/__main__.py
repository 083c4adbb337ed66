"""CLI: simulate serving a model config on a hardware target under load.

    PYTHONPATH=src python -m repro_torch.sim --config qwen3_14b --hw h100 --qps 8

Prints TTFT/TPOT/e2e percentiles, goodput, and tokens/s per scheduler
policy, then the static-vs-continuous throughput-latency sweep.
`--trace out.json` records one policy's run (request lifecycle spans +
per-iteration counters) for Perfetto (.json), `repro_torch.obs report`
(.jsonl), or spreadsheets (.csv); `--trace-counter-dt` downsamples the
per-iteration counters.

`--slo-window W` evaluates the SLO monitor over each policy's run
(TTFT p99 <= --slo-ttft, goodput >= --slo-goodput if set, tumbling
W-second windows, burn-rate alerts). The single-replica sim emits
request records after the run, so the monitor replays the recorded
events in time order — same engine, same results as the cluster CLI's
live monitor.

`--slowdown F --slowdown-at T --slowdown-for D` injects a straggler
window: engine iterations priced inside `[T, T + D)` are stretched by
factor F (the single-replica view of the cluster CLI's `--chaos-stragglers`).

A copy of `repro.sim.__main__` (the port imports nothing of the JAX package);
`tests/test_torch_sim.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import argparse
import os

from repro_torch.configs import get_config
from repro_torch.core.hardware import get_hardware
from repro_torch.obs import LEVELS, make_slos, make_tracer, replay, write_trace
from repro_torch.sim import (
    ADMISSIONS,
    ENGINES,
    LengthDist,
    POLICIES,
    SchedConfig,
    ServingCostModel,
    Workload,
    pareto_sweep,
    simulate,
    summarize,
)


def build_parser() -> argparse.ArgumentParser:
    """Argparse parser for `python -m repro_torch.sim` (qps = requests/second)."""
    p = argparse.ArgumentParser(prog="python -m repro_torch.sim", description=__doc__)
    p.add_argument("--config", default="qwen3_14b", help="model config id")
    p.add_argument("--hw", default="h100", help="hardware target (see core.hardware)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--prec", type=int, default=2, help="bytes per weight/act element")
    p.add_argument("--qps", type=float, default=8.0)
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
    p.add_argument("--replay", default=None,
                   help="JSONL workload trace to replay instead of the "
                        "synthetic generator")
    p.add_argument("--trace", default=None,
                   help="record the run to this path: .json = Chrome "
                        "trace-event (Perfetto), .jsonl = event log "
                        "(repro_torch.obs report), .csv = windowed time series; "
                        "with --policy all, the policy is suffixed into "
                        "the filename")
    p.add_argument("--trace-level", default="request", choices=list(LEVELS),
                   help="trace verbosity ceiling (with --trace)")
    p.add_argument("--trace-counter-dt", type=float, default=0.0,
                   help="minimum seconds between per-(track, series) counter "
                        "samples (0 = every iteration)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--policy", default="all", choices=list(POLICIES) + ["all"])
    p.add_argument("--slots", type=int, default=16)
    p.add_argument("--token-budget", type=int, default=512)
    p.add_argument("--admission", default="fcfs", choices=list(ADMISSIONS),
                   help="admission order: fcfs, or edf on TTFT deadlines")
    p.add_argument("--block-tokens", type=int, default=0,
                   help="paged-KV page size in tokens (0 = contiguous)")
    p.add_argument("--kv-gb", type=float, default=None,
                   help="override KV budget (GB); default: DRAM minus weights")
    p.add_argument("--slo-ttft", type=float, default=2.0, help="seconds")
    p.add_argument("--slo-tpot", type=float, default=0.05, help="seconds/token")
    p.add_argument("--slo-goodput", type=float, default=None,
                   help="SLO-monitor goodput objective as a fraction (e.g. "
                        "0.99); needs --slo-window")
    p.add_argument("--slo-window", type=float, default=None,
                   help="evaluate the SLO monitor over the run: tumbling "
                        "compliance window in seconds for TTFT p99 <= "
                        "--slo-ttft (and goodput >= --slo-goodput if set)")
    p.add_argument("--sweep", default="2,4,8,16",
                   help="comma-separated slot counts for the pareto sweep ('' to skip)")
    p.add_argument("--ctx-quantum", type=int, default=16)
    p.add_argument("--slowdown", type=float, default=None,
                   help="straggler factor stretching engine iterations "
                        "inside the injection window (>= 1)")
    p.add_argument("--slowdown-at", type=float, default=0.0,
                   help="straggler window start (s; with --slowdown)")
    p.add_argument("--slowdown-for", type=float, default=10.0,
                   help="straggler window duration (s; with --slowdown)")
    p.add_argument("--engine", default="vectorized", choices=list(ENGINES),
                   help="simulation core: the vectorized fast path or the "
                        "reference event loop (identical results)")
    return p


def main(argv=None) -> None:
    """Run one serving simulation (latencies in seconds) and/or the sweep."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.config)
    hw = get_hardware(args.hw)
    cost = ServingCostModel(cfg, hw, tp=args.tp, prec=args.prec,
                            ctx_quantum=args.ctx_quantum,
                            kv_block_tokens=args.block_tokens)
    wl = Workload(
        name=args.replay or "synthetic",
        qps=args.qps,
        num_requests=args.requests,
        arrival=args.arrival,
        prompt=LengthDist(args.prompt_dist, args.prompt_mean, args.prompt_sigma),
        output=LengthDist(args.output_dist, args.output_mean, args.output_sigma),
        seed=args.seed,
        trace_path=args.replay,
        diurnal_period=args.diurnal_period,
        diurnal_amp=args.diurnal_amp,
        rate_path=args.rate_path,
    )
    reqs = wl.generate()
    kv_cap = args.kv_gb * 1e9 if args.kv_gb is not None else None

    rate_note = ""
    if args.arrival in ("diurnal", "envelope") and reqs:
        # the peak offered rate is what static provisioning (and a
        # predictive autoscaler's envelope lookahead) must be sized for
        rate_note = f" (envelope peak {wl.peak_rate(0.0, reqs[-1].arrival):g})"
    print(f"# {cfg.name} on {hw.name} tp={args.tp}  |  "
          f"{len(reqs)} requests, {args.arrival} arrivals @ {args.qps} qps"
          f"{rate_note}")
    print(f"# weights {cost.weight_bytes / 1e9:.1f} GB/dev, "
          f"KV budget {(kv_cap or cost.kv_capacity_bytes) / 1e9:.1f} GB/dev")

    policies = list(POLICIES) if args.policy == "all" else [args.policy]
    hdr = (f"{'policy':<11} {'ttft p50/p95/p99 (s)':>22} {'tpot p50/p95/p99 (ms)':>22} "
           f"{'e2e p50/p95/p99 (s)':>21} {'tok/s':>7} {'goodput':>8} {'preempt':>7}")
    print(hdr)
    print("-" * len(hdr))
    slos = make_slos(slo_ttft=args.slo_ttft, slo_goodput=args.slo_goodput,
                     window=args.slo_window or 30.0) \
        if args.slo_window is not None else ()
    if args.slo_goodput is not None and args.slo_window is None:
        raise SystemExit("--slo-goodput needs --slo-window to enable the "
                         "SLO monitor")
    for policy in policies:
        sc = SchedConfig(policy=policy, slots=args.slots,
                         token_budget=args.token_budget, kv_capacity=kv_cap,
                         admission=args.admission, slo_ttft=args.slo_ttft)
        # the monitor consumes request-level events, so monitoring forces
        # the tracer to request level (even without --trace)
        level = args.trace_level if args.trace else "off"
        if slos and level != "request":
            level = "request"
        tracer = make_tracer(level, counter_dt=args.trace_counter_dt)
        slowdown = ((args.slowdown, args.slowdown_at, args.slowdown_for)
                    if args.slowdown is not None else None)
        s = summarize(simulate(reqs, cost, sc, tracer=tracer,
                               slowdown=slowdown, engine=args.engine),
                      slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot)
        if slos:
            mres = replay(tracer.meta, tracer.events, slos)
            print(f"# slo monitor [{policy}]: "
                  f"time_in_violation={mres['time_in_violation']:g}s, "
                  f"alerts_fired={mres['alerts_fired']}, "
                  f"budget_burn={mres['budget_burn']:.1%}")
        if tracer.enabled and args.trace:
            # the SLO monitor can force the tracer on without
            # --trace; only export when a path was actually given
            path = args.trace
            if len(policies) > 1:
                root, ext = os.path.splitext(path)
                path = f"{root}.{policy}{ext or '.json'}"
            fmt = write_trace(tracer.events, path, tracer.meta)
            print(f"# trace [{fmt}, level={args.trace_level}]: "
                  f"{len(tracer.events)} events -> {path}")
        print(f"{policy:<11} "
              f"{s['ttft_p50']:>6.2f}/{s['ttft_p95']:.2f}/{s['ttft_p99']:.2f}  "
              f"{s['tpot_p50'] * 1e3:>6.1f}/{s['tpot_p95'] * 1e3:.1f}/{s['tpot_p99'] * 1e3:.1f}  "
              f"{s['e2e_p50']:>6.2f}/{s['e2e_p95']:.2f}/{s['e2e_p99']:.2f}  "
              f"{s['tokens_per_s']:>7.0f} {s['goodput_frac']:>7.0%} {s['preemptions']:>7}")

    if args.sweep:
        slot_counts = [int(x) for x in args.sweep.split(",") if x]
        rows = pareto_sweep(reqs, cost, policies=POLICIES,
                            slot_counts=slot_counts,
                            base=SchedConfig(token_budget=args.token_budget,
                                             kv_capacity=kv_cap,
                                             admission=args.admission,
                                             slo_ttft=args.slo_ttft),
                            slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot)
        print(f"\n# throughput-latency sweep (equal KV budget)")
        print(f"{'policy':<11} {'slots':>5} {'tok/s':>8} {'e2e_p95 (s)':>12} {'pareto':>7}")
        for r in rows:
            print(f"{r['policy']:<11} {r['slots']:>5} {r['tokens_per_s']:>8.0f} "
                  f"{r['e2e_p95']:>12.2f} {'*' if r['pareto'] else '':>7}")


if __name__ == "__main__":
    main()
