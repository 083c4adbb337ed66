"""The port's cluster simulator (`repro_torch.cluster`) against `repro.cluster`, bit for bit.

Each module of `repro_torch.cluster` is a copy of JAX's over the port's config,
analytical core, simulator and tracer, so the same fleet must give the same
floats: every comparison here is `==` on the float's bits
(`tests/test_torch_sim.py::_bits`). No case needs a tolerance.

`simulate_cluster` is held to JAX over colocated and disaggregated fleets, each
router (affinity with sessions, with `hit_frac` 0 and 0.5), both engines, five
configs, a fleet of h100 and a100 replicas, and shedding with retries and
jitter. "The same" covers the stitched records, each replica's result (the
fields `tests/test_torch_sim.py::_result` compares), the assignments, the KV
transfers, the billing spans, the shed requests and retries, and
`summarize_cluster` and `pool_summaries`. The port's two engines against each
other, on JAX's `tests/test_engine_parity.py` cases, are in
`tests/test_torch_cluster_parity.py`.
"""

from dataclasses import asdict, fields, is_dataclass
from types import SimpleNamespace

import numpy as np
import pytest

import repro.cluster as jcl
import repro.obs as jobs
import repro.sim as jsim
import repro_torch.cluster as tcl
import repro_torch.obs as tobs
import repro_torch.sim as tsim
from repro.cluster import cluster as jcluster
from repro.configs import get_config as jax_get_config
from repro.core import hardware as jhw
from repro_torch.cluster import cluster as tcluster
from repro_torch.configs import get_config
from repro_torch.core import hardware as thw
from test_torch_sim import _bits, _result
from torch_threads import one_thread  # noqa: F401

SIDES = {"port": SimpleNamespace(cl=tcl, sim=tsim, obs=tobs, cfg=get_config, hw=thw),
         "jax": SimpleNamespace(cl=jcl, sim=jsim, obs=jobs, cfg=jax_get_config, hw=jhw)}
CONFIGS = ("qwen3_14b", "h2o_danube_1p8b", "deepseek_moe_16b", "zamba2_1p2b", "rwkv6_7b")
POOLS = {"colocated": ["mixed"] * 3, "disagg": ["prefill", "prefill", "decode"]}


def _plain(x):
    """Dataclasses as dicts (recursively), so that `_bits` reaches every float."""
    if is_dataclass(x) and not isinstance(x, type):
        return _plain(asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def cluster_state(cres, *, slo_ttft=1.0, slo_tpot=0.1):
    """Everything a `ClusterResult` holds, its derived extents, and both summaries."""
    out = {f.name: _plain(getattr(cres, f.name)) for f in fields(cres)
           if f.name != "replica_results"}
    out["replica_results"] = [_result(r) for r in cres.replica_results]
    out["derived"] = [cres.makespan, cres.span, cres.replica_hours, cres.peak_replicas,
                      cres.replica_hours_static_peak]
    mod = type(cres).__module__.split(".")[0]
    cl = tcl if mod == "repro_torch" else jcl
    out["summary"] = cl.summarize_cluster(cres, slo_ttft=slo_ttft, slo_tpot=slo_tpot)
    out["pools"] = cl.pool_summaries(cres, slo_ttft=slo_ttft, slo_tpot=slo_tpot)
    return _bits(out)


def workload(s, **kw):
    base = dict(qps=60.0, num_requests=36, arrival="poisson",
                prompt=s.sim.LengthDist("lognormal", 96, 0.4, lo=8, hi=512),
                output=s.sim.LengthDist("lognormal", 24, 0.4, lo=2, hi=128), seed=0)
    base.update(kw)
    return s.sim.Workload(**base)


def spec(s, pools, *, sched=None, hw="h100", **kw):
    """A fleet of `pools` (one replica each); `hw` a name or one name a replica."""
    sched = sched or s.sim.SchedConfig(slots=8)
    hws = [hw] * len(pools) if isinstance(hw, str) else hw
    return s.cl.ClusterSpec(
        replicas=tuple(s.cl.ReplicaSpec(hw=h, pool=p, sched=sched, ctx_quantum=32)
                       for h, p in zip(hws, pools)), **kw)


def run(s, pools, *, config="qwen3_14b", wl=None, engine="vectorized", autoscale=None,
        tracer=None, monitor=None, **kw):
    reqs = workload(s, **(wl or {})).generate()
    return s.cl.simulate_cluster(reqs, s.cfg(config), spec(s, pools, **kw), autoscale=autoscale,
                                 engine=engine, tracer=tracer, monitor=monitor)


def both(fn):
    """`fn(side)` on each side, as bits: {"port": ..., "jax": ...}."""
    return {name: fn(s) for name, s in SIDES.items()}


def assert_same(fn):
    got = both(fn)
    assert got["port"] == got["jax"]
    return got["port"]


def test_the_same_api():
    assert tcl.__all__ == jcl.__all__
    for name in ("ROUTERS", "POOLS", "CHAOS_KINDS", "ADMISSION_POLICIES", "AUTOSCALE_POLICIES",
                 "DEFAULT_PRICE_PER_DEV_HR"):
        assert getattr(tcl, name) == getattr(jcl, name), name
    assert tcluster.POOLS == jcluster.POOLS == ("mixed", "prefill", "decode")


def _views(s, rng, n):
    idx = sorted(rng.choice(12, size=n, replace=False).tolist())
    return [s.cl.ReplicaView(idx=i, now=float(rng.uniform(0, 5)), queue_len=int(rng.integers(0, 4)),
                             live=int(rng.integers(0, 3)),
                             kv_used=float(rng.choice([0.0, rng.uniform(0, 1e9)])),
                             kv_capacity=float(rng.choice([0.0, 2e9]))) for i in idx]


@pytest.mark.parametrize("name", tcl.ROUTERS)
@pytest.mark.parametrize("hit_frac", [0.0, 0.5])
def test_router_picks_equal_jax(name, hit_frac):
    """Each router's picks, explanations and counters over one seeded sequence of
    views, completions and retirements."""
    def picks(s):
        rng = np.random.default_rng(7)
        r = s.cl.make_router(name, hit_frac=hit_frac, slo_ttft=0.5, debt_window=3.0)
        out = []
        for k in range(60):
            views = _views(s, rng, int(rng.integers(1, 5)))
            req = s.sim.SimRequest(k, float(k) * 0.1, int(rng.integers(1, 300)),
                                   int(rng.integers(1, 40)), session=int(rng.integers(-1, 4)))
            out.append([r.pick(req, views), dict(r.last_pick)])
            r.observe(views[0].idx, float(k) * 0.1, float(rng.uniform(0, 1)))
            if k % 17 == 16:
                r.on_retire(views[-1].idx)
        return _bits([out, getattr(r, "hits", None), getattr(r, "misses", None)])

    got = assert_same(picks)
    assert len(got[0]) == 60


@pytest.mark.parametrize("engine", ["reference", "vectorized"])
@pytest.mark.parametrize("router", tcl.ROUTERS)
@pytest.mark.parametrize("mode", ["colocated", "disagg"])
def test_fleet_equals_jax(mode, router, engine):
    wl = {"num_sessions": 6} if router == "affinity" else {}
    got = assert_same(lambda s: cluster_state(run(s, POOLS[mode], router=router, engine=engine,
                                                  wl=wl)))
    assert got["mode"] == ("colocated" if mode == "colocated" else "disaggregated")
    assert len(got["records"]) == 36
    if mode == "disagg":
        assert got["xfer_count"] == 36 and got["xfer_bytes"] != ("float", "0x0.0p+0")


@pytest.mark.parametrize("hit_frac", [0.0, 0.5])
@pytest.mark.parametrize("mode", ["colocated", "disagg"])
def test_affinity_with_sessions_equals_jax(mode, hit_frac):
    got = assert_same(lambda s: cluster_state(run(s, POOLS[mode], router="affinity",
                                                  hit_frac=hit_frac, wl={"num_sessions": 4})))
    assert (got["prefix_hits"] > 0) == (hit_frac > 0)


@pytest.mark.parametrize("mode", ["colocated", "disagg"])
@pytest.mark.parametrize("config", CONFIGS)
def test_each_config_equals_jax(config, mode):
    got = assert_same(lambda s: cluster_state(run(s, POOLS[mode], config=config,
                                                  wl={"num_requests": 24})))
    assert len(got["records"]) == 24


@pytest.mark.parametrize("engine", ["reference", "vectorized"])
@pytest.mark.parametrize("mode", ["colocated", "disagg"])
def test_heterogeneous_fleet_equals_jax(mode, engine):
    """h100 and a100 replicas in one fleet: each prices its own hardware."""
    got = assert_same(lambda s: cluster_state(run(s, POOLS[mode], hw=["h100", "a100", "a100"],
                                                  engine=engine)))
    assert [r["hw"] for r in got["replica_specs"]] == ["h100", "a100", "a100"]


@pytest.mark.parametrize("engine", ["reference", "vectorized"])
@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_shedding_with_retries_and_jitter_equals_jax(jitter, engine):
    def fleet(s):
        reqs = workload(s, qps=300.0, num_requests=48).generate()
        cost = s.sim.ServingCostModel(s.cfg("qwen3_14b"), s.hw.H100_SXM, ctx_quantum=32)
        cap = 3.0 * max(cost.kv_bytes(r.prompt + r.output) for r in reqs)
        sp = spec(s, ["mixed"] * 2, sched=s.sim.SchedConfig(slots=8, kv_capacity=cap),
                  shed_depth=6, retry_jitter=jitter, retry_seed=3)
        return cluster_state(s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), sp, engine=engine))

    got = assert_same(fleet)
    assert got["retries"] > 0 and got["shed"]


@pytest.mark.parametrize("policy", ["static", "continuous", "chunked"])
def test_one_replica_is_simulate(policy):
    """A one-replica fleet of the port runs the port's `simulate`, as JAX's does."""
    s = SIDES["port"]
    reqs = workload(s, num_requests=24).generate()
    sc = s.sim.SchedConfig(policy=policy, slots=8)
    direct = s.sim.simulate(reqs, s.sim.ServingCostModel(s.cfg("qwen3_14b"), s.hw.H100_SXM,
                                                         ctx_quantum=32), sc)
    [rep] = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), spec(s, ["mixed"], sched=sc)
                                  ).replica_results
    assert _result(rep) == _result(direct)
