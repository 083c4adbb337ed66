"""The port's two cluster engines agree, and agree with JAX's, bit for bit.

The cases are JAX's `tests/test_engine_parity.py`: colocated or disaggregated x
static or autoscaled x chaos off or on x prefix cache off or on x untraced or
traced, then the edge cases (each router's ties, KV pressure, shed and retry,
the admission door, EDF under chunked prefill, pool-aware autoscaling) and the
single-replica engine. In each, the port's `reference` and `vectorized` engines
must give the same records, assignments, replica results, summaries and event
stream, and so must JAX's `vectorized` engine on the same fleet.
"""

import pytest

from test_torch_cluster import POOLS, SIDES, cluster_state, spec, workload
from test_torch_sim import _bits, _result
from torch_threads import one_thread  # noqa: F401

PORT, JAX = SIDES["port"], SIDES["jax"]


def _tight(s, reqs, factor=3.0, **kw):
    cost = s.sim.ServingCostModel(s.cfg("qwen3_14b"), s.hw.H100_SXM, ctx_quantum=32)
    cap = factor * max(cost.kv_bytes(r.prompt + r.output) for r in reqs)
    return s.sim.SchedConfig(slots=8, kv_capacity=cap, **kw)


def _run(s, case, engine, traced):
    reqs, sp, autoscale = case(s)
    tracer = s.obs.Tracer("replica") if traced else None
    cres = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), sp, autoscale=autoscale,
                                 engine=engine, tracer=tracer)
    return {"state": cluster_state(cres), "trace": _bits(tracer.events) if traced else None}


def _assert_identical(case, traced=False):
    ref = _run(PORT, case, "reference", traced)
    vec = _run(PORT, case, "vectorized", traced)
    jax = _run(JAX, case, "vectorized", traced)
    for part in ("state", "trace"):
        assert vec[part] == ref[part], f"the port's engines diverge in {part}"
        assert vec[part] == jax[part], f"the port diverges from JAX in {part}"
    return vec


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("pcache", [False, True], ids=["nocache", "pcache"])
@pytest.mark.parametrize("chaos", [False, True], ids=["calm", "chaos"])
@pytest.mark.parametrize("scaled", [False, True], ids=["static", "autoscaled"])
@pytest.mark.parametrize("mode", ["colocated", "disagg"])
def test_engine_parity_matrix(mode, scaled, chaos, pcache, traced):
    def case(s):
        kw = {}
        if chaos:
            kw["chaos"] = s.cl.ChaosConfig(seed=5, horizon=40.0, crash_rate=0.06,
                                           straggler_rate=0.1, link_rate=0.05)
        wl = {}
        if pcache:
            kw["router"] = "affinity"
            kw["prefix_cache"] = s.cl.PrefixCacheConfig(budget_frac=0.05)
            wl["num_sessions"] = 6
        autoscale = (s.cl.AutoscaleConfig(policy="rate", min_replicas=2, max_replicas=6,
                                          interval=2.0) if scaled else None)
        return workload(s, **wl).generate(), spec(s, POOLS[mode], **kw), autoscale

    out = _assert_identical(case, traced)
    assert len(out["state"]["records"]) == 36
    if traced:
        assert out["trace"]


def _edge(name):
    def case(s):
        reqs = workload(s).generate()
        hot = workload(s, qps=300.0, num_requests=48).generate()
        sess = workload(s, num_sessions=6).generate()
        cl, sim = s.cl, s.sim
        return {
            "router-rr": (reqs, spec(s, ["mixed"] * 3, router="round_robin"), None),
            "router-leastkv-tightkv": (reqs, spec(s, ["mixed"] * 3, sched=_tight(s, reqs),
                                                  router="least_kv"), None),
            "router-affinity": (sess, spec(s, ["mixed"] * 3, router="affinity"), None),
            "router-slodebt": (reqs, spec(s, ["mixed"] * 3, router="slo_debt"), None),
            "edf-chunked": (reqs, spec(s, ["mixed"] * 3, sched=sim.SchedConfig(
                slots=8, policy="chunked", token_budget=128, admission="edf")), None),
            "disagg-tightkv": (reqs, spec(s, ["prefill", "decode", "decode"],
                                          sched=_tight(s, reqs, 2.5)), None),
            "shed-retry": (hot, spec(s, ["mixed"] * 2, sched=_tight(s, reqs), shed_depth=6),
                           None),
            "admission-door": (hot, spec(s, ["mixed"] * 2, admission=cl.AdmissionConfig(
                rate=30.0, burst=10, queue_depth=8)), None),
            "pool-autoscale": (workload(s, qps=40.0, num_requests=48).generate(),
                               spec(s, ["prefill", "decode"]),
                               {"prefill": cl.AutoscaleConfig(policy="rate", min_replicas=1,
                                                              max_replicas=4, interval=2.0),
                                "decode": cl.AutoscaleConfig(policy="kv_tpot", min_replicas=1,
                                                             max_replicas=4, interval=3.0)}),
        }[name]
    return case


@pytest.mark.parametrize("name", ["router-rr", "router-leastkv-tightkv", "router-affinity",
                                  "router-slodebt", "edf-chunked", "disagg-tightkv",
                                  "shed-retry", "admission-door", "pool-autoscale"])
def test_engine_parity_edges(name):
    _assert_identical(_edge(name))


def _simulate(s, engine, policy="continuous", slowdown=None, n=48):
    reqs = workload(s, num_requests=n, qps=100.0).generate()
    cost = s.sim.ServingCostModel(s.cfg("qwen3_14b"), s.hw.H100_SXM, ctx_quantum=32)
    kw = {} if slowdown is None else {"slowdown": slowdown}
    # JAX's cases: a token budget of 192 for its continuous and chunked runs only
    budget = {"token_budget": 192} if slowdown is None and policy != "static" else {}
    return _result(s.sim.simulate(reqs, cost, s.sim.SchedConfig(policy=policy, slots=8, **budget),
                                  engine=engine, **kw))


@pytest.mark.parametrize("policy,slowdown,n", [("continuous", None, 48), ("chunked", None, 48),
                                               ("continuous", (3.0, 0.1, 0.5), 32),
                                               ("static", None, 24)])
def test_single_replica_engine_parity(policy, slowdown, n):
    vec = _simulate(PORT, "vectorized", policy, slowdown, n)
    assert vec == _simulate(PORT, "reference", policy, slowdown, n)
    assert vec == _simulate(JAX, "vectorized", policy, slowdown, n)


def test_unknown_engine_rejected():
    reqs = workload(PORT, num_requests=4).generate()
    with pytest.raises(ValueError, match="unknown engine"):
        PORT.cl.simulate_cluster(reqs, PORT.cfg("qwen3_14b"), spec(PORT, ["mixed"]),
                                 engine="warp")
