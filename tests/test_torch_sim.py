"""The port's serving simulator (`repro_torch.sim`) against `repro.sim`, bit for bit.

Each module of `repro_torch.sim` is a copy of JAX's over the port's config and
analytical core, so the same spec must give the same floats: every comparison
here is `==` on the float's bits (`_bits`), as `tests/test_engine_parity.py`
compares its two engines. No case needs a tolerance; the one tolerance in the
file is JAX's own contract with `inference_latency` (1%), which the port keeps.
"""

from dataclasses import asdict

import numpy as np
import pytest

import repro.sim as jsim
import repro_torch.sim as tsim
from repro.configs import get_config as jax_get_config
from repro.core import hardware as jhw
from repro_torch.configs import get_config
from repro_torch.core import hardware as thw
from repro_torch.core.predict import inference_latency
from torch_threads import one_thread  # noqa: F401

CONFIGS = ("qwen3_14b", "h2o_danube_1p8b", "deepseek_moe_16b", "zamba2_1p2b", "rwkv6_7b")
HARDWARE = ("h100", "a100")
SIDES = {"port": (tsim, get_config, thw.get_hardware),
         "jax": (jsim, jax_get_config, jhw.get_hardware)}


def _bits(x):
    """`x` with every float as its hex string: equal only when bit for bit equal
    (NaN included, and an int never equals a float)."""
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_bits(v) for v in x]
    if isinstance(x, (float, np.floating)):
        return ("float", float(x).hex())
    if isinstance(x, np.integer):
        return int(x)
    return x


def _cost(side, config="qwen3_14b", hw="h100", **kw):
    mod, cfg, hardware = SIDES[side]
    return mod.ServingCostModel(cfg(config), hardware(hw), **kw)


def _workload(side, **kw):
    mod = SIDES[side][0]
    base = dict(qps=100.0, num_requests=24, arrival="poisson",
                prompt=mod.LengthDist("lognormal", 96, 0.4, lo=8, hi=512),
                output=mod.LengthDist("lognormal", 24, 0.4, lo=2, hi=128), seed=0,
                slo_ttft=(0.05, 4.0, 4.0))
    base.update(kw)
    return mod.Workload(**base)


def _requests(side, **kw):
    return [asdict(r) for r in _workload(side, **kw).generate()]


def _result(res):
    return _bits({"policy": res.policy, "records": [asdict(r) for r in res.records],
                  "admit_order": res.admit_order, "iterations": res.iterations,
                  "decode_steps": res.decode_steps, "preemptions": res.preemptions,
                  "peak_kv": res.peak_kv, "kv_capacity": res.kv_capacity, "busy_s": res.busy_s,
                  "peak_kv_waste": res.peak_kv_waste, "makespan": res.makespan})


def _simulate(side, sc_kw, *, config="qwen3_14b", hw="h100", cost_kw=None, wl_kw=None,
              engine="vectorized", **kw):
    mod = SIDES[side][0]
    reqs = _workload(side, **(wl_kw or {})).generate()
    cost = _cost(side, config, hw, **{"ctx_quantum": 32, **(cost_kw or {})})
    return mod.simulate(reqs, cost, mod.SchedConfig(**sc_kw), engine=engine, **kw)


def test_the_same_api():
    assert tsim.__all__ == jsim.__all__
    assert (tsim.POLICIES, tsim.ADMISSIONS, tsim.ENGINES) == (jsim.POLICIES, jsim.ADMISSIONS,
                                                              jsim.ENGINES)


# ------------------------------------------------------------------ workloads
@pytest.mark.parametrize("arrival", ["constant", "poisson", "bursty", "diurnal"])
@pytest.mark.parametrize("seed", [0, 3])
def test_workload_generate(arrival, seed):
    kw = dict(arrival=arrival, seed=seed, num_requests=200, num_sessions=5,
              num_prefix_groups=3, diurnal_period=4.0, diurnal_amp=0.7)
    assert _bits(_requests("port", **kw)) == _bits(_requests("jax", **kw))
    spec = {s: _workload(s, **kw) for s in SIDES}
    assert _bits([spec["port"].rate_at(t) for t in np.linspace(0, 9, 37)]) == \
        _bits([spec["jax"].rate_at(t) for t in np.linspace(0, 9, 37)])
    assert _bits(spec["port"].peak_rate(0.5, 3.0)) == _bits(spec["jax"].peak_rate(0.5, 3.0))
    subs = {s: [[asdict(r) for r in w.generate()] for w in spec[s].substreams(3)] for s in SIDES}
    assert _bits(subs["port"]) == _bits(subs["jax"])


def test_workload_envelope(tmp_path):
    p = tmp_path / "rates.jsonl"
    p.write_text('{"t": 0.0, "qps": 50.0}\n{"time": 10.0, "rate": 50.0}\n'
                 '{"t": 10.0001, "qps": 0.5}\n{"t": 12.0, "qps": 0.0}\n{"t": 30.0, "qps": 4.5}\n')
    kw = dict(arrival="envelope", rate_path=str(p), num_requests=400)
    assert _bits(_requests("port", **kw)) == _bits(_requests("jax", **kw))
    spec = {s: _workload(s, **kw) for s in SIDES}
    assert _bits([spec["port"].peak_rate(a, b) for a, b in ((0, 5), (9, 40), (11, 13))]) == \
        _bits([spec["jax"].peak_rate(a, b) for a, b in ((0, 5), (9, 40), (11, 13))])


def test_workload_trace_replay(tmp_path):
    p = tmp_path / "trace.jsonl"
    p.write_text('{"arrival": 0.0, "prompt": 10, "output": 4}\n'
                 '{"arrival_s": 0.5, "prompt_tokens": 20, "output_tokens": 6, "session": 2}\n'
                 '{"arrival": 0.25, "input_tokens": 9, "output": 3, "slo_ttft": 0.1}\n'
                 '{"arrival": 0.9, "prompt": 30, "output": 2, "prefix_group": 1, "prefix_len": 50}\n'
                 '{"arrival": 0.9, "prompt": 0, "output": 0}\n')
    reqs = {s: [asdict(r) for r in SIDES[s][0].Workload(trace_path=str(p), slo_ttft=1.5).generate()]
            for s in SIDES}
    assert len(reqs["port"]) == 5 and _bits(reqs["port"]) == _bits(reqs["jax"])


# ---------------------------------------------------------------- cost model
@pytest.mark.parametrize("hw", HARDWARE)
@pytest.mark.parametrize("config", CONFIGS)
def test_cost_model_grid(config, hw):
    for kw in (dict(), dict(tp=2, ctx_quantum=1), dict(kv_block_tokens=16, prec=1)):
        port, jax = _cost("port", config, hw, **kw), _cost("jax", config, hw, **kw)
        grid = {}
        for side, cost in (("port", port), ("jax", jax)):
            grid[side] = {
                "prefill": [cost.prefill_time(s, ctx_end=c, batch=b, with_head=h)
                            for s in (17, 512) for c in (None, 5000) for b in (1, 3)
                            for h in (True, False)],
                "decode": [cost.decode_step_time(b, c) for b in (1, 4, 16)
                           for c in (1, 37.5, 1000, 8191)],
                "kv": [cost.kv_bytes(c, exact=e) for c in (0, 1, 63, 4096, 9000)
                       for e in (False, True)],
                "handoff": [cost.kv_handoff_bytes(c) for c in (0, 7, 4096)],
                "weights": cost.weight_bytes,
            }
            try:
                grid[side]["capacity"] = cost.kv_capacity_bytes
            except ValueError as e:
                grid[side]["capacity"] = str(e)
        assert _bits(grid["port"]) == _bits(grid["jax"])


# ------------------------------------------------------------------ simulate
@pytest.mark.parametrize("hw", HARDWARE)
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("engine", ["reference", "vectorized"])
@pytest.mark.parametrize("admission", ["fcfs", "edf"])
@pytest.mark.parametrize("policy", ["static", "continuous", "chunked"])
def test_simulate_matrix(policy, admission, engine, config, hw):
    sc = dict(policy=policy, slots=4, token_budget=96, admission=admission, slo_ttft=1.0)
    port = _simulate("port", sc, config=config, hw=hw, engine=engine)
    jax = _simulate("jax", sc, config=config, hw=hw, engine=engine)
    assert len(port.records) == 24 and _result(port) == _result(jax)


@pytest.mark.parametrize("engine", ["reference", "vectorized"])
@pytest.mark.parametrize("policy", ["static", "continuous", "chunked"])
def test_simulate_paged_kv(policy, engine):
    sc = dict(policy=policy, slots=4, token_budget=96)
    runs = {s: _simulate(s, sc, cost_kw=dict(kv_block_tokens=64), engine=engine) for s in SIDES}
    assert runs["port"].peak_kv_waste > 0
    assert _result(runs["port"]) == _result(runs["jax"])


@pytest.mark.parametrize("engine", ["reference", "vectorized"])
@pytest.mark.parametrize("policy", ["continuous", "chunked"])
@pytest.mark.parametrize("config", ["qwen3_14b", "deepseek_moe_16b"])
def test_simulate_tight_kv_preempts(config, policy, engine):
    """A KV budget of 3 of the largest requests forces recompute preemptions."""
    reqs = {s: _workload(s, num_requests=36, qps=200.0).generate() for s in SIDES}
    runs = {}
    for s, (mod, _, _) in SIDES.items():
        cost = _cost(s, config, ctx_quantum=32)
        cap = 3.0 * max(cost.kv_bytes(r.prompt + r.output) for r in reqs[s])
        runs[s] = mod.simulate(reqs[s], cost, mod.SchedConfig(policy=policy, slots=8,
                                                              kv_capacity=cap), engine=engine)
    assert runs["port"].preemptions > 0
    assert _result(runs["port"]) == _result(runs["jax"])


@pytest.mark.parametrize("engine", ["reference", "vectorized"])
def test_simulate_straggler_window(engine):
    runs = {s: _simulate(s, dict(slots=8), engine=engine, slowdown=(3.0, 0.1, 0.5)) for s in SIDES}
    assert _result(runs["port"]) == _result(runs["jax"])


def test_replica_sim_stepped_by_hand():
    """The steppable replica: pushes with pre-materialised KV, one iteration a
    `step`, `evict_pending` (the cluster's interface, used by its next slice)."""
    out = {}
    for s, (mod, _, _) in SIDES.items():
        sim = mod.make_replica_sim(_cost(s, ctx_quantum=16), mod.SchedConfig(slots=2),
                                   engine="reference", name="r0")
        reqs = _workload(s, num_requests=8).generate()
        for r in reqs[:5]:
            sim.push(r)
        sim.push(reqs[5], cached=reqs[5].prompt, generated=1)
        done = []
        for _ in range(6):
            done += [asdict(r) for r in sim.step()]
        evicted = [asdict(r) for r in sim.evict_pending()]
        out[s] = [done, evicted, sim.now, sim.queue_len, sim.live, sim.kv_used]
    assert _bits(out["port"]) == _bits(out["jax"])


# ------------------------------------------------------------------- metrics
@pytest.mark.parametrize("config", ["qwen3_14b", "rwkv6_7b"])
def test_summarize_and_pareto_sweep(config):
    out = {}
    for s, (mod, _, _) in SIDES.items():
        reqs = _workload(s, num_requests=16).generate()
        cost = _cost(s, config, ctx_quantum=32)
        res = mod.simulate(reqs, cost, mod.SchedConfig(slots=4))
        out[s] = {
            "summary": mod.summarize(res, slo_ttft=0.5, slo_tpot=0.02),
            "records": mod.summarize_records(res.records, span=res.makespan, slo_ttft=0.5),
            "sweep": mod.pareto_sweep(reqs, cost, slot_counts=(2, 4),
                                      base=mod.SchedConfig(token_budget=64)),
        }
        out[s]["dominates"] = [mod.dominates(a, b) for a in out[s]["sweep"]
                               for b in out[s]["sweep"]]
    assert _bits(out["port"]) == _bits(out["jax"])


# ----------------------------------------- the port's two engines (no JAX)
@pytest.mark.parametrize("policy", ["continuous", "chunked"])
def test_port_engines_agree(policy):
    """JAX's `test_simulate_engine_parity` inside the port."""
    reqs = _workload("port", num_requests=48, slo_ttft=None).generate()
    cost = _cost("port", ctx_quantum=32)
    sc = tsim.SchedConfig(policy=policy, slots=8, token_budget=192)
    vec = tsim.simulate(reqs, cost, sc, engine="vectorized")
    ref = tsim.simulate(reqs, cost, sc, engine="reference")
    assert _result(vec) == _result(ref)


def test_port_engines_agree_in_a_straggler_window_and_on_static():
    reqs = _workload("port", num_requests=32, slo_ttft=None).generate()
    cost = _cost("port", ctx_quantum=32)
    for sc, kw in ((tsim.SchedConfig(slots=8), dict(slowdown=(3.0, 0.1, 0.5))),
                   (tsim.SchedConfig(policy="static", slots=8), {})):
        vec = tsim.simulate(reqs, cost, sc, engine="vectorized", **kw)
        ref = tsim.simulate(reqs, cost, sc, engine="reference", **kw)
        assert _result(vec) == _result(ref)
    with pytest.raises(ValueError, match="unknown engine"):
        tsim.simulate(reqs[:4], cost, tsim.SchedConfig(), engine="warp")


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("config", ["qwen3_14b", "h2o_danube_1p8b"])
def test_single_request_matches_inference_latency(config, tp):
    """JAX's contract (`tests/test_sim.py`), held by the port: one request's TTFT
    and TPOT within 1% of the port's `inference_latency`."""
    cfg = get_config(config)
    prompt, gen = 512, 64
    bd = inference_latency(cfg, thw.H100_SXM, tp=tp, batch=1, prompt=prompt, gen=gen)
    cost = tsim.ServingCostModel(cfg, thw.H100_SXM, tp=tp, ctx_quantum=1)
    res = tsim.simulate([tsim.SimRequest(0, 0.0, prompt, gen)], cost,
                        tsim.SchedConfig(policy="continuous", slots=1))
    r = res.records[0]
    assert r.ttft == pytest.approx(bd.ttft, rel=0.01)
    assert r.tpot == pytest.approx(bd.tpot, rel=0.01)
    assert res.decode_steps == gen - 1
