"""The port's observability stack (`repro_torch.obs`) against `repro.obs`, bit for bit.

A traced simulation of the port must emit JAX's event stream, event by event,
and run the schedule an untraced one runs; every consumer of a trace (the JSONL,
Chrome and CSV exports, `analyze`/`render`, the SLO monitor online and in
`replay`, `diff_traces`, the HTML dashboard, the streaming quantiles) must give
JAX's output for the same events; and both command lines (`python -m
repro_torch.sim`, `python -m repro_torch.obs`) must print what JAX's print.

Here the traces come from the single-replica simulator. The cases of JAX's
`tests/test_obs.py` and `tests/test_monitor.py` that trace a cluster (the golden
digests of the colocated, disaggregated and autoscaled fleets, the Chrome
export's replica tracks, `summarize_cluster` from a trace, billing extents, the
prefix-cache wiring, monitored fleets, the cluster CLI and its golden) are in
`tests/test_torch_cluster_obs.py`, and the cluster half of
`tests/test_engine_parity.py` in `tests/test_torch_cluster_parity.py`.
"""

from dataclasses import asdict

import numpy as np
import pytest

import repro.obs as jobs
import repro.sim as jsim
import repro_torch.obs as tobs
import repro_torch.sim as tsim
from repro.configs import get_config as jax_get_config
from repro.core import hardware as jhw
from repro.obs.__main__ import main as jax_obs_main
from repro.sim.__main__ import main as jax_sim_main
from repro_torch.configs import get_config
from repro_torch.core import hardware as thw
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.sim.__main__ import main as sim_main
from test_torch_sim import _bits
from torch_threads import one_thread  # noqa: F401

SIDES = {"port": (tsim, tobs, get_config, thw.H100_SXM),
         "jax": (jsim, jobs, jax_get_config, jhw.H100_SXM)}


def _run(side, *, level="request", seed=0, policy="continuous", tracer=None, counter_dt=0.0,
         qps=50.0, n=24, config="qwen3_14b"):
    """A traced single-replica run: (result, tracer)."""
    sim, obs, cfg, hw = SIDES[side]
    wl = sim.Workload(qps=qps, num_requests=n, arrival="poisson", seed=seed,
                      prompt=sim.LengthDist("lognormal", 96, 0.4, lo=8, hi=512),
                      output=sim.LengthDist("lognormal", 24, 0.4, lo=2, hi=128))
    tracer = tracer if tracer is not None else obs.make_tracer(level, counter_dt=counter_dt)
    cost = sim.ServingCostModel(cfg(config), hw, ctx_quantum=32)
    res = sim.simulate(wl.generate(), cost, sim.SchedConfig(policy=policy, slots=8),
                       tracer=tracer)
    return res, tracer


def _traces(**kw):
    return {s: _run(s, **kw)[1] for s in SIDES}


def _schedule(res):
    return _bits([[asdict(r) for r in res.records], res.admit_order, res.iterations,
                  res.decode_steps, res.busy_s, res.peak_kv, res.preemptions])


def test_the_same_api():
    assert tobs.__all__ == jobs.__all__
    assert (tobs.LEVELS, tobs.TERMINALS, tobs.STRUCTURAL_SPANS, tobs.PCTS) == \
        (jobs.LEVELS, jobs.TERMINALS, jobs.STRUCTURAL_SPANS, jobs.PCTS)


# --------------------------------------------------------------- the tracer
@pytest.mark.parametrize("policy", ["static", "continuous", "chunked"])
@pytest.mark.parametrize("level", ["summary", "replica", "request"])
def test_trace_equals_jax_event_by_event(level, policy):
    tr = _traces(level=level, policy=policy)
    assert len(tr["port"].events) == len(tr["jax"].events)
    for a, b in zip(tr["port"].events, tr["jax"].events):
        assert _bits(a) == _bits(b)
    assert _bits(tr["port"].meta) == _bits(tr["jax"].meta)
    assert tobs.validate_trace(tr["port"].events) == []


def test_tracing_never_perturbs_the_schedule():
    plain, _ = _run("port", level="off")
    for level in ("summary", "replica", "request"):
        traced, tr = _run("port", level=level)
        assert _schedule(traced) == _schedule(plain)
    sizes = [len(_run("port", level=lv)[1].events) for lv in ("summary", "replica", "request")]
    assert sizes[0] < sizes[1] < sizes[2]


def test_counter_downsampling_and_sinks():
    tr = _traces(level="replica", counter_dt=0.05)
    assert _bits(tr["port"].events) == _bits(tr["jax"].events)
    seen = {}
    for s, (_, obs, _, _) in SIDES.items():
        class Sink:
            def __init__(self):
                self.n = 0

            def on_event(self, ev):
                self.n += 1
        sink = Sink()
        t = obs.Tracer("request", sinks=(sink,), keep_events=False)
        _run(s, tracer=t)
        seen[s] = (sink.n, len(t.events))
    assert seen["port"] == seen["jax"] and seen["port"][0] > 0


# ----------------------------------------------------------------- exports
@pytest.mark.parametrize("suffix", [".jsonl", ".json", ".csv"])
def test_write_trace_files_equal(tmp_path, suffix):
    tr = _traces()
    out = {}
    for s, (_, obs, _, _) in SIDES.items():
        p = tmp_path / f"{s}{suffix}"
        fmt = obs.write_trace(tr[s].events, p, tr[s].meta, window=0.125)
        out[s] = (fmt, p.read_bytes())
    assert out["port"] == out["jax"] and len(out["port"][1]) > 1000


def test_chrome_csv_and_read_back(tmp_path):
    tr = _traces(level="request")
    p = tmp_path / "t.jsonl"
    tobs.write_jsonl(tr["port"].events, p, tr["port"].meta)
    assert _bits(tobs.read_jsonl(p)) == _bits(jobs.read_jsonl(p))
    assert _bits(tobs.to_chrome(tr["port"].events, tr["port"].meta)) == \
        _bits(jobs.to_chrome(tr["jax"].events, tr["jax"].meta))
    for window in (0.1, 1.0):
        assert _bits(tobs.csv_rows(tr["port"].events, window=window)) == \
            _bits(jobs.csv_rows(tr["jax"].events, window=window))


# ------------------------------------------------------------------ report
def test_analyze_and_render():
    tr = _traces()
    for topk in (3, 10):
        port = tobs.analyze(tr["port"].events, tr["port"].meta, topk=topk)
        jax = jobs.analyze(tr["jax"].events, tr["jax"].meta, topk=topk)
        assert _bits(port) == _bits(jax) and port["problems"] == []
        assert tobs.render(port) == jobs.render(jax)


def test_validator_finds_the_same_faults():
    events = [e for e in _traces()["port"].events
              if not (e.get("name") == "request.complete" and e.get("rid") == 0)]
    events.append({"ev": "span", "name": "decode", "t0": 2.0, "t1": 1.0, "track": "", "rid": 99})
    assert tobs.validate_trace(events) == jobs.validate_trace(events) != []


# ----------------------------------------------------------------- monitor
def _burst(obs, **kw):
    """JAX's `_burst_monitor`: healthy TTFT for 20 s, then grossly violating."""
    tr = obs.Tracer("summary")
    mon = obs.SLOMonitor(obs.make_slos(slo_ttft=0.5, slo_goodput=0.99, window=4.0), **kw)
    tr.add_sink(mon)
    t, i = 0.0, 0
    while t < 40.0:
        ttft = 0.1 if t < 20.0 else 2.0
        tr.instant("request.complete", t, rid=i, ttft=ttft, tpot=0.01, e2e=ttft + 0.5)
        if i % 17 == 5:
            tr.instant("request.shed", t, rid=10_000 + i)
        t += 1.0 / 3.0
        i += 1
    mon.finish(40.0)
    return tr, mon


def test_online_monitor_and_its_replay():
    out = {}
    for s, (_, obs, _, _) in SIDES.items():
        tr, mon = _burst(obs)
        online = mon.result()
        offline = obs.replay(tr.meta, tr.events, obs.make_slos(slo_ttft=0.5, slo_goodput=0.99,
                                                                window=4.0))
        out[s] = {"online": online, "offline": offline, "events": tr.events}
    assert _bits(out["port"]) == _bits(out["jax"])
    assert out["port"]["online"]["alerts_fired"] >= 2


@pytest.mark.parametrize("window", [0.25, 2.0])
def test_replay_over_a_simulated_trace(window):
    tr = _traces(qps=200.0, n=48)
    res = {s: SIDES[s][1].replay(tr[s].meta, tr[s].events,
                                 SIDES[s][1].make_slos(slo_ttft=0.3, slo_goodput=0.9,
                                                       window=window))
           for s in SIDES}
    assert _bits(res["port"]) == _bits(res["jax"])
    assert res["port"]["slos"][0]["bad"] > 0


def test_quantile_estimators():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(0.0, 1.0, 5000).tolist() + [3.0] * 50
    out = {}
    for s, (_, obs, _, _) in SIDES.items():
        p2 = obs.P2Quantile(0.99)
        sq = obs.StreamingQuantiles()
        agg = obs.WindowedAggregator(0.5)
        for i, x in enumerate(xs):
            p2.add(x)
            sq.add(x)
            agg.add((i * 7919 % 5050) / 100.0, "x", x)
        out[s] = [p2.value(), sq.summary("x"), agg.rows(fill_gaps=True),
                  agg.range_stats("x", 1.0, 20.0), obs.percentile_summary(xs, "x"),
                  obs.pct_key("ttft", 99.9)]
    assert _bits(out["port"]) == _bits(out["jax"])


# ---------------------------------------------------- diff and dashboard
def test_diff_traces_and_regressions():
    a, b = _traces(seed=0), _traces(seed=1, qps=120.0)
    out = {}
    for s, (_, obs, _, _) in SIDES.items():
        d = obs.diff_traces((a[s].meta, a[s].events), (b[s].meta, b[s].events))
        fail_on = obs.parse_fail_on("ttft_p99=0.01,completion_frac=0.5")
        probs = obs.regressions(d, fail_on)
        out[s] = [d, probs, obs.render_diff(d, probs), obs.regressions(d)]
    assert _bits(out["port"]) == _bits(out["jax"])
    assert out["port"][1]


def test_render_html():
    tr = _traces(level="request", qps=120.0, n=40)
    for s in ("summary", "request"):
        t = tr if s == "request" else _traces(level="summary")
        assert tobs.render_html(t["port"].events, t["port"].meta) == \
            jobs.render_html(t["jax"].events, t["jax"].meta)


# ------------------------------------------------------------------- CLIs
def test_sim_cli_prints_what_jax_prints(tmp_path, capsys):
    trace = tmp_path / "run.jsonl"
    args = ["--config", "h2o_danube_1p8b", "--hw", "h100", "--qps", "16", "--requests", "30",
            "--sweep", "2,4", "--trace", str(trace), "--slo-window", "1", "--slo-goodput", "0.9",
            "--ctx-quantum", "32"]
    printed, files = {}, {}
    for side, main in (("port", sim_main), ("jax", jax_sim_main)):
        main(args)
        printed[side] = capsys.readouterr().out
        files[side] = {p.name: p.read_bytes() for p in sorted(tmp_path.glob("run.*.jsonl"))}
    assert printed["port"] == printed["jax"]
    assert files["port"] == files["jax"] and len(files["port"]) == 3
    assert "throughput-latency sweep" in printed["port"]


def test_obs_cli_prints_what_jax_prints(tmp_path, capsys):
    tr, slow = _run("port", qps=120.0, n=40)[1], _run("port", seed=2, qps=400.0, n=40)[1]
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    tobs.write_jsonl(tr.events, a, tr.meta)
    tobs.write_jsonl(slow.events, b, slow.meta)
    bad = tmp_path / "bad.jsonl"
    tobs.write_jsonl([e for e in tr.events
                      if not (e.get("name") == "request.complete" and e.get("rid") == 0)],
                     bad, tr.meta)
    printed = []
    for argv in (["report", str(a)], ["report", str(a), "--validate-only"],
                 ["report", str(bad), "--validate-only"],
                 ["report", str(a), "--topk", "3", "--slo-ttft", "0.2", "--slo-goodput", "0.9",
                  "--slo-window", "0.5", "--html", str(tmp_path / "d.html")],
                 ["diff", str(a), str(b)], ["diff", str(a), str(b), "--fail-on", "ttft_p99=0.1"],
                 ["diff", str(a), str(a), "--fail-on", "ttft_p99=0"]):
        port = obs_main(argv), capsys.readouterr()
        html = (tmp_path / "d.html").read_bytes() if "--html" in argv else None
        jax = jax_obs_main(argv), capsys.readouterr()
        assert (port[0], port[1].out, port[1].err) == (jax[0], jax[1].out, jax[1].err), argv
        if html is not None:
            assert html == (tmp_path / "d.html").read_bytes() and html.startswith(b"<!DOCTYPE")
        printed.append(port)
    assert "latency (ms)" in printed[0][1].out
    assert [code for code, _ in printed] == [0, 0, 1, 0, 0, 1, 0]
    assert "offline SLO replay" in printed[3][1].out
