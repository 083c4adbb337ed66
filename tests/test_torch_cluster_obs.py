"""A traced, monitored cluster of the port against JAX's, and the cluster CLI.

The cases of JAX's `tests/test_obs.py` and `tests/test_monitor.py` that trace a
fleet: a traced cluster of the port emits JAX's event stream event by event (its
digest is JAX's golden), tracing and monitoring leave the schedule alone, the
Chrome export carries one track a replica, `analyze` reproduces
`summarize_cluster` from the trace alone, the provisioned extents are the bill,
and a cached fleet records its cache. The port's `python -m repro_torch.cluster`
regenerates the checked-in `tests/goldens/cluster_small.jsonl` (`python -m
repro_torch.obs diff` against it exits 0) and prints what JAX's prints.
"""

import json
from pathlib import Path

import pytest

from repro.cluster.__main__ import main as jax_cluster_main
from repro_torch.cluster.__main__ import main as cluster_main
from repro_torch.obs.__main__ import main as obs_main
from test_obs import GOLDEN_AUTOSCALED, GOLDEN_COLOCATED, GOLDEN_DISAGG, _digest
from test_torch_cluster import SIDES, assert_same, cluster_state, spec, workload
from test_torch_sim import _bits
from torch_threads import one_thread  # noqa: F401

PORT = SIDES["port"]
GOLDEN = Path(__file__).resolve().parent / "goldens" / "cluster_small.jsonl"
# tests/goldens/README.md's command for the golden's scenario
GOLDEN_ARGS = ["--config", "qwen3_14b", "--hw", "h100", "--replicas", "2", "--qps", "24",
               "--requests", "24", "--slots", "4", "--ctx-quantum", "32", "--mode", "colocated",
               "--slo-window", "1", "--slo-goodput", "0.99"]


def _wl(s, **kw):
    return workload(s, **{"qps": 50.0, "num_requests": 24, **kw})


def _autoscale(s):
    return s.cl.AutoscaleConfig(policy="rate", min_replicas=1, max_replicas=4, interval=0.5,
                                warmup=0.4, target_qps_per_replica=8.0)


def _scenario(s, label, *, tracer=None, monitor=None):
    """JAX's canonical fleets (`tests/test_obs.py`, `tests/test_monitor.py`)."""
    if label == "autoscaled":
        reqs = _wl(s, qps=20.0, num_requests=120, arrival="diurnal", diurnal_period=8.0,
                   diurnal_amp=0.9).generate()
        pools, asc = ["mixed", "mixed"], _autoscale(s)
    else:
        reqs = _wl(s).generate()
        pools = ["mixed", "mixed"] if label == "colocated" else ["prefill", "decode"]
        asc = None
    return s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), spec(s, pools), autoscale=asc,
                                 tracer=tracer, monitor=monitor)


def _monitor(s):
    return s.obs.SLOMonitor(s.obs.make_slos(slo_ttft=0.5, slo_goodput=0.99, window=0.5))


LABELS = ["colocated", "disaggregated", "autoscaled"]
DIGESTS = dict(zip(LABELS, (GOLDEN_COLOCATED, GOLDEN_DISAGG, GOLDEN_AUTOSCALED)))


@pytest.mark.parametrize("level", ["summary", "replica", "request"])
@pytest.mark.parametrize("label", LABELS)
def test_trace_equals_jax_event_by_event(label, level):
    got = {}
    for name, s in SIDES.items():
        tr = s.obs.Tracer(level)
        got[name] = (tr, cluster_state(_scenario(s, label, tracer=tr)))
    (port, port_state), (jax, jax_state) = got["port"], got["jax"]
    assert len(port.events) == len(jax.events)
    for a, b in zip(port.events, jax.events):
        assert _bits(a) == _bits(b)
    assert _bits(port.meta) == _bits(jax.meta) and port_state == jax_state
    assert PORT.obs.validate_trace(port.events) == []
    if level == "request":
        assert _digest(port) == DIGESTS[label]


@pytest.mark.parametrize("label", LABELS)
def test_tracing_and_monitoring_never_perturb_the_schedule(label):
    plain = cluster_state(_scenario(PORT, label))
    traced = cluster_state(_scenario(PORT, label, tracer=PORT.obs.Tracer("request")))
    mon = _scenario(PORT, label, monitor=_monitor(PORT))
    monitored = cluster_state(mon)
    assert traced == plain
    # a monitored fleet's summaries gain the SLO columns; everything else is the plain run's
    gained = {k: monitored["summary"].pop(k) for k in set(monitored["summary"]) - set(plain["summary"])}
    assert {k: v for k, v in monitored.items() if k not in ("slo", "pools")} == \
        {k: v for k, v in plain.items() if k not in ("slo", "pools")}
    assert gained and "alerts_fired" in gained
    assert plain["slo"] is None and mon.slo is not None


@pytest.mark.parametrize("label", LABELS)
def test_monitored_fleet_equals_jax(label):
    """The online monitor's result, its instants in the trace, and the SLO columns
    `summarize_cluster` gains."""
    def monitored(s):
        tr = s.obs.Tracer("request")
        cres = _scenario(s, label, tracer=tr, monitor=_monitor(s))
        names = sorted({e["name"] for e in tr.events if e["name"].startswith(("slo.", "alert.",
                                                                              "anomaly."))})
        return [cluster_state(cres), _bits(tr.events), names]

    state, _, names = assert_same(monitored)
    assert state["slo"] and "slo.window" in names


def test_chrome_export_replica_tracks():
    def chrome(s):
        tr = s.obs.Tracer("request")
        cres = _scenario(s, "autoscaled", tracer=tr)
        doc = json.loads(json.dumps(s.obs.to_chrome(tr.events, tr.meta)))
        threads = {e["args"]["name"] for e in doc["traceEvents"]
                   if e.get("ph") == "M" and e["name"] == "thread_name"}
        return [_bits(doc), sorted(threads), len(cres.replica_specs)]

    _, threads, n = assert_same(chrome)
    assert "cluster" in threads and len(threads) == 1 + n and n > 2


def test_report_reproduces_summarize_cluster_from_the_trace_alone(tmp_path):
    """`analyze` on the JSONL of a traced fleet gives JAX's report, and its
    percentiles are `summarize_cluster`'s (JAX's own contract, to 1e-9)."""
    def report(s):
        tr = s.obs.Tracer("request")
        cres = _scenario(s, "autoscaled", tracer=tr)
        p = tmp_path / f"{'port' if s is PORT else 'jax'}.jsonl"
        s.obs.write_jsonl(tr.events, p, tr.meta)
        meta, events = s.obs.read_jsonl(p)
        rep = s.obs.analyze(events, meta)
        return [_bits(rep), p.read_bytes(), _bits(s.cl.summarize_cluster(cres)), len(cres.records)]

    rep, _, summary, n = assert_same(report)
    assert rep["problems"] == [] and rep["summary"]["n_complete"] == n
    for key in ("ttft_p50", "ttft_p99", "e2e_p50", "e2e_p99"):
        a, b = (float.fromhex(x[1]) for x in (rep["summary"][key], summary[key]))
        assert a == pytest.approx(b, rel=1e-9), key
    assert {o["op"] for o in rep["scale_ops"]} >= {"scale.up", "scale.down", "replica.retired"}


def test_trace_extents_are_the_bill():
    def billing(s):
        tr = s.obs.Tracer("request")
        cres = _scenario(s, "autoscaled", tracer=tr)
        summ, prov = s.cl.summarize_cluster(cres), s.cl.provisioning_summary(cres)
        extent = sum(e["t1"] - e["t0"] for e in tr.events
                     if e["ev"] == "span" and e["name"] == "provisioned")
        return _bits([summ["t0"], summ["horizon"], prov, extent, cres.replica_hours * 3600.0,
                      tr.meta["t0"], tr.meta["horizon"], cres.t0, cres.horizon])

    t0, horizon, prov, extent, hours_s, mt0, mhorizon, ct0, chorizon = assert_same(billing)
    assert (t0, horizon) == (prov["t0"], prov["horizon"]) == (mt0, mhorizon) == (ct0, chorizon)
    assert float.fromhex(extent[1]) == pytest.approx(float.fromhex(hours_s[1]), rel=1e-12)
    static = assert_same(lambda s: _bits(s.cl.provisioning_summary(_scenario(s, "colocated"))))
    assert static["savings_frac"] == ("float", "0x0.0p+0")


def test_prefix_cache_wiring_equals_jax():
    def cached(s):
        wl = _wl(s, qps=20.0, num_requests=120, arrival="diurnal", diurnal_period=8.0,
                 diurnal_amp=0.9, num_sessions=6, num_prefix_groups=3,
                 prefix=s.sim.LengthDist("fixed", 48.0))
        sp = spec(s, ["mixed", "mixed"], router="affinity",
                  prefix_cache=s.cl.PrefixCacheConfig(budget_frac=0.001, ttl=5.0))
        tr = s.obs.Tracer("request")
        cres = s.cl.simulate_cluster(wl.generate(), s.cfg("qwen3_14b"), sp,
                                     autoscale=_autoscale(s), tracer=tr)
        return [cluster_state(cres), _bits(tr.events)]

    _, events = assert_same(cached)
    assert any(e.get("name") == "cache_bytes" for e in events)
    invs = [e for e in events if e.get("name") == "cache.invalidate"]
    assert invs and all("dropped_bytes" in e["attrs"] for e in invs)


# ---------------------------------------------------------------------- CLI
def test_cli_regenerates_the_golden(tmp_path, capsys):
    """The golden's command (tests/goldens/README.md) in the port writes JAX's bytes,
    and `python -m repro_torch.obs diff` against the checked-in golden exits 0."""
    for side, main in (("port", cluster_main), ("jax", jax_cluster_main)):
        (tmp_path / side).mkdir()
        main([*GOLDEN_ARGS, "--trace", str(tmp_path / side / "cluster_small.jsonl")])
    fresh = tmp_path / "port" / "cluster_small.jsonl"
    assert fresh.read_bytes() == (tmp_path / "jax" / "cluster_small.jsonl").read_bytes()
    assert obs_main(["diff", str(GOLDEN), str(fresh)]) == 0
    assert "no regressions" in capsys.readouterr().out
    # GOLDEN_DRIFT: neither side regenerates the checked-in bytes, which the golden's
    # README promises; floats differ in their last digits (the horizon is
    # 6.392291950506389 there, 6.392291950506385 from both CLIs), within the diff's
    # tolerances. Pinned so that a regenerated golden retires this note.
    golden, fresh_lines = GOLDEN.read_text().splitlines(), fresh.read_text().splitlines()
    assert len(golden) == len(fresh_lines) and golden[0] != fresh_lines[0]
    assert json.loads(golden[0])["horizon"] == 6.392291950506389
    assert json.loads(fresh_lines[0])["horizon"] == 6.392291950506385


CLI_CASES = {
    "default": ["--config", "qwen3_14b", "--hw", "h100", "--replicas", "4", "--qps", "32",
                "--requests", "60", "--ctx-quantum", "32"],
    "plan": ["--config", "qwen3_14b", "--hw", "h100", "--qps", "32", "--requests", "40",
             "--ctx-quantum", "32", "--plan", "--plan-max-replicas", "4"],
    "autoscale": ["--config", "qwen3_14b", "--replicas", "2", "--qps", "24", "--requests", "60",
                  "--arrival", "diurnal", "--diurnal-period", "30", "--autoscale",
                  "--max-replicas", "4", "--scale-interval", "1", "--target-qps", "10"],
    "chaos": ["--config", "qwen3_14b", "--replicas", "3", "--qps", "24", "--requests", "60",
              "--ctx-quantum", "32", "--chaos-seed", "3", "--chaos-horizon", "3",
              "--chaos-crashes", "0.5", "--chaos-stragglers", "0.5", "--chaos-links", "0.5",
              "--shed-depth", "8", "--admission-policy", "token_bucket",
              "--admission-rate", "20"],
    "prefix-cache": ["--config", "h2o_danube_1p8b", "--hw", "h100,a100", "--replicas", "3",
                     "--qps", "24", "--requests", "60", "--ctx-quantum", "32", "--router",
                     "affinity", "--sessions", "6", "--prefix-groups", "3", "--prefix-cache",
                     "--cache-ttl", "5"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_prints_what_jax_prints(case, tmp_path, capsys):
    """Each side writes its trace to the same path (the path is printed)."""
    printed, files = {}, {}
    trace = tmp_path / "t.jsonl"
    for side, main in (("port", cluster_main), ("jax", jax_cluster_main)):
        main([*CLI_CASES[case], "--trace", str(trace)] if case == "default" else CLI_CASES[case])
        printed[side] = capsys.readouterr()
        files[side] = {p.name: p.read_bytes() for p in sorted(tmp_path.glob("t.*"))}
        for p in tmp_path.glob("t.*"):
            p.unlink()
    assert (printed["port"].out, printed["port"].err) == (printed["jax"].out, printed["jax"].err)
    assert files["port"] == files["jax"]
    assert printed["port"].out.count("\n") > 3
    if case == "default":
        assert sorted(files["port"]) == ["t.colocated.jsonl", "t.disaggregated.jsonl"]
