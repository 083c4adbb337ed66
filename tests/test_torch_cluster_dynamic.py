"""The port's dynamic fleet against JAX's, bit for bit: the autoscaler, chaos,
the admission door, the prefix cache and the capacity planner.

Every comparison is `==` on the bits of everything a `ClusterResult` holds
(`tests/test_torch_cluster.py::cluster_state`: records, replica results, spans,
scale events, shed requests, retries, `chaos_stats`, `admission_stats`,
`cache_stats`, both summaries), or of the unit's own outputs. JAX's pinned
goldens (`tests/test_autoscale.py`, `tests/test_chaos.py`,
`tests/test_prefixcache.py`) come out of the port's scenarios as they are.
"""

import math
from dataclasses import asdict, replace

import pytest

from repro.cluster import chaos as jchaos
from repro.cluster import prefixcache as jpc
from repro_torch.cluster import chaos as tchaos
from repro_torch.cluster import prefixcache as tpc
from test_autoscale import _sig6
from test_prefixcache import _UnitCost
from test_torch_cluster import SIDES, assert_same, cluster_state, spec, workload
from test_torch_sim import _bits
from torch_threads import one_thread  # noqa: F401

PORT = SIDES["port"]
UNITS = {"port": (tchaos, tpc), "jax": (jchaos, jpc)}


def _diurnal(s, **kw):
    base = dict(qps=30.0, num_requests=60, arrival="diurnal", diurnal_period=20.0,
                diurnal_amp=0.9)
    base.update(kw)
    return workload(s, **base)


def _conserved(state, n):
    rids = sorted([r["rid"] for r in state["records"]] + [r["rid"] for r in state["shed"]])
    assert rids == list(range(n))


# ------------------------------------------------------------------ autoscale
@pytest.mark.parametrize("policy", PORT.cl.AUTOSCALE_POLICIES)
def test_each_autoscale_policy_equals_jax(policy):
    """A fleet-wide control loop of each policy over diurnal traffic (kv_tpot
    scales a disaggregated fleet, the others a colocated one)."""
    def fleet(s):
        wl = _diurnal(s)
        asc = s.cl.AutoscaleConfig(policy=policy, min_replicas=1, max_replicas=4,
                                   interval=0.5, window=2.0, warmup=0.5,
                                   target_qps_per_replica=8.0, wait_lo=0.02, wait_hi=0.1,
                                   slo_ttft=0.1, slo_tpot=0.01, kv_hi=0.02, kv_lo=0.001)
        if policy == "predictive":
            asc = s.cl.seed_predictive(asc, wl)
        pools = ["prefill", "decode"] if policy == "kv_tpot" else ["mixed"]
        return cluster_state(s.cl.simulate_cluster(wl.generate(), s.cfg("qwen3_14b"),
                                                   spec(s, pools), autoscale=asc))

    got = assert_same(fleet)
    _conserved(got, 60)
    assert got["scale_events"]


@pytest.mark.parametrize("kind", ["rate", "predictive", "pool"])
@pytest.mark.parametrize("pools", [["mixed"] * 3, ["prefill", "decode", "decode"]])
def test_pinned_bounds_are_the_static_fleet(pools, kind):
    """JAX's pinned-bounds parity, in the port: a loop pinned at the template size
    runs the static fleet's schedule, and both equal JAX's."""
    def runs(s):
        wl = _diurnal(s)
        n = len(pools)
        if kind == "rate":
            asc = s.cl.AutoscaleConfig(min_replicas=n, max_replicas=n, interval=0.5, warmup=1.0)
        elif kind == "predictive":
            asc = s.cl.seed_predictive(s.cl.AutoscaleConfig(min_replicas=n, max_replicas=n,
                                                            interval=0.5, warmup=1.0), wl)
        else:
            policy = {"mixed": "queue_wait", "prefill": "queue_wait", "decode": "kv_tpot"}
            asc = {p: s.cl.AutoscaleConfig(policy=policy[p], min_replicas=pools.count(p),
                                           max_replicas=pools.count(p), interval=0.5,
                                           warmup=1.0) for p in dict.fromkeys(pools)}
        reqs = wl.generate()
        scaled = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), spec(s, pools), autoscale=asc)
        if s is PORT:
            static = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), spec(s, pools))
            key = [(r.rid, r.admitted, r.first_token, r.finish)
                   for r in sorted(scaled.records, key=lambda r: r.rid)]
            assert key == [(r.rid, r.admitted, r.first_token, r.finish)
                           for r in sorted(static.records, key=lambda r: r.rid)]
        return cluster_state(scaled)

    assert_same(runs)


def test_golden_autoscale_modes():
    """JAX's `tests/test_autoscale.py::test_golden_autoscale_modes_pinned` in the port
    (its 6-figure pins), and the port's whole result equal to JAX's."""
    keys = ("ttft_p50", "ttft_p95", "tpot_p50", "tpot_p95", "e2e_mean", "tokens_per_s",
            "goodput_frac", "makespan_s")

    def goldens(s):
        wl = _diurnal(s, qps=60.0, num_requests=240,
                      prompt=s.sim.LengthDist("lognormal", 192, 0.4, lo=16, hi=1024))
        reqs = wl.generate()
        asc = s.cl.seed_predictive(s.cl.AutoscaleConfig(min_replicas=1, max_replicas=4,
                                                        interval=0.5, window=2.0, warmup=0.5),
                                   wl, reqs)
        pred = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), spec(s, ["mixed"]), autoscale=asc)
        base = s.cl.AutoscaleConfig(min_replicas=1, max_replicas=3, interval=0.5, window=2.0,
                                    warmup=0.5)
        pa = {"prefill": replace(base, policy="queue_wait", wait_hi=0.1, wait_lo=0.02),
              "decode": replace(base, policy="kv_tpot", kv_hi=0.02, kv_lo=0.001)}
        pool = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), spec(s, ["prefill", "decode"]),
                                     autoscale=pa)
        out = {}
        for name, cres in (("predictive", pred), ("pool", pool)):
            st = cluster_state(cres, slo_ttft=2.0, slo_tpot=0.05)
            sm = s.cl.summarize_cluster(cres, slo_ttft=2.0, slo_tpot=0.05)
            out[name] = {"state": st, "pins": {k: _sig6(sm[k]) for k in keys},
                         "events": (sm["scale_events"], sm["peak_replicas"]),
                         "hours": _sig6(s.cl.provisioning_summary(cres)["replica_hours"]),
                         "prov": _bits(s.cl.provisioning_summary(cres, shed_cost_usd=0.01))}
        return out

    got = assert_same(goldens)
    assert got["predictive"]["pins"] == dict(
        ttft_p50=0.452514, ttft_p95=1.30541, tpot_p50=0.0175626, tpot_p95=0.0204003,
        e2e_mean=0.871226, tokens_per_s=1292.04, goodput_frac=1.0, makespan_s=4.32882)
    assert got["predictive"]["events"] == (3, 4) and got["predictive"]["hours"] == 0.00439977
    assert got["pool"]["pins"] == dict(
        ttft_p50=0.457187, ttft_p95=1.4918, tpot_p50=0.0418892, tpot_p95=0.131398,
        e2e_mean=1.65825, tokens_per_s=875.385, goodput_frac=0.545833, makespan_s=6.38919)
    assert got["pool"]["events"] == (4, 6) and got["pool"]["hours"] == 0.00788081


def test_autoscaler_unit_equals_jax():
    """An `Autoscaler` of each policy fed one sequence of observations: the same
    signals and the same desired sizes at each tick."""
    def ticks(s):
        cost = s.sim.ServingCostModel(s.cfg("qwen3_14b"), s.hw.H100_SXM, ctx_quantum=32)
        out = []
        for policy in s.cl.AUTOSCALE_POLICIES:
            asc = s.cl.AutoscaleConfig(policy=policy, min_replicas=1, max_replicas=6, window=3.0,
                                       spare=1 if policy == "rate" else 0,
                                       envelope=lambda t0, t1: 20.0 + t0)
            sc = s.cl.Autoscaler(asc, cost=cost, sched=s.sim.SchedConfig(slots=8), pool="mixed")
            for k in range(40):
                t = 0.25 * k
                sc.observe_arrival(t)
                sc.observe_ttft(t, 0.1 * (k % 7))
                sc.observe_wait(t, 0.05 * (k % 5))
                sc.observe_tpot(t, 0.01 * (k % 9))
                if k % 4 == 3:
                    out.append([policy, sc.desired(t, 2), sc.observed_rate(t), sc.slo_debt(t),
                                sc.tpot_debt(t), sc.queue_wait(t), sc.predicted_wait(8.0, 2)])
        return _bits(out)

    assert len(assert_same(ticks)) == 50


# ---------------------------------------------------------------------- chaos
def test_chaos_schedule_and_victims_equal_jax():
    def draws(s):
        ch, _ = UNITS["port" if s is PORT else "jax"]
        cfg = s.cl.ChaosConfig(seed=11, horizon=30.0, crash_rate=0.2, straggler_rate=0.3,
                               link_rate=0.1, node_failure_rate=0.05, node_group=3,
                               script=(s.cl.ChaosEvent(1.5, "crash", picks=(0.4,)),))
        events = [asdict(e) for e in cfg.schedule()]
        victims = [ch.pick_victims((0.1, 0.7, 0.99), [0, 3, 4, 9], k) for k in (1, 2, 3)]
        return _bits([events, victims])

    got = assert_same(draws)
    assert {e["kind"] for e in got[0]} == set(PORT.cl.CHAOS_KINDS)


def _script(s, *events):
    return s.cl.ChaosConfig(script=tuple(s.cl.ChaosEvent(*a, **kw) for a, kw in events))


CHAOS_CASES = {
    "crash": (["mixed"] * 2, [((0.2, "crash"), {"picks": (0.1,)})]),
    "crash-decode": (["prefill", "decode", "decode"], [((0.3, "crash"), {"picks": (0.99,)})]),
    "straggler": (["mixed"] * 2, [((0.0, "straggler"), {"factor": 8.0, "duration": 5.0,
                                                        "picks": (0.0,)})]),
    "link": (["prefill", "decode"], [((0.0, "link"), {"factor": 5.0, "duration": 1e9})]),
    "node_failure": (["mixed"] * 4, [((0.2, "node_failure"), {"count": 2, "picks": (0.9, 0.9)})]),
    "sole-replica": (["mixed"], [((0.1, "crash"), {"picks": (0.0,)})]),
}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("case", list(CHAOS_CASES))
def test_each_chaos_kind_equals_jax(case, traced):
    pools, events = CHAOS_CASES[case]

    def fleet(s):
        tracer = s.obs.make_tracer("request") if traced else None
        cres = s.cl.simulate_cluster(workload(s, qps=50.0, num_requests=40).generate(),
                                     s.cfg("qwen3_14b"),
                                     spec(s, pools, chaos=_script(s, *events)), tracer=tracer)
        return [cluster_state(cres), _bits(tracer.events) if traced else None]

    state, _ = assert_same(fleet)
    _conserved(state, 40)
    stats = state["chaos_stats"]
    kind = events[0][0][1]
    count = {"crash": "crashes", "straggler": "stragglers", "link": "link_degrades",
             "node_failure": "crashes"}[kind]
    assert stats[count] == events[0][1].get("count", 1)


def test_sampled_chaos_and_the_golden_equal_jax():
    """Rate-sampled chaos on an autoscaled fleet, and JAX's pinned chaos summary
    (`tests/test_chaos.py::test_chaos_summary_golden`)."""
    def fleets(s):
        sampled = s.cl.simulate_cluster(
            workload(s, qps=80.0, num_requests=50, seed=1).generate(), s.cfg("qwen3_14b"),
            spec(s, ["prefill", "decode", "decode"], shed_depth=8, retry_after=0.2,
                 chaos=s.cl.ChaosConfig(seed=1, horizon=1.0, crash_rate=3.0,
                                        straggler_rate=1.0, link_rate=0.5)),
            autoscale=s.cl.AutoscaleConfig(min_replicas=2, max_replicas=4, interval=0.5,
                                           warmup=0.5, spare=1))
        golden = s.cl.simulate_cluster(
            workload(s, qps=50.0, num_requests=40).generate(), s.cfg("qwen3_14b"),
            spec(s, ["prefill", "decode", "decode"], chaos=_script(
                s, ((0.1, "link"), {"factor": 3.0, "duration": 2.0}),
                ((0.2, "straggler"), {"factor": 2.0, "duration": 1.0, "picks": (0.0,)}),
                ((0.3, "crash"), {"picks": (0.99,)}))))
        sm = s.cl.summarize_cluster(golden, slo_ttft=2.0, slo_tpot=0.05)
        pins = {k: _sig6(sm[k]) for k in ("ttft_p95", "tpot_p95", "goodput_frac",
                                          "tokens_per_s", "recovery_s_mean")}
        pins.update({k: sm[k] for k in ("re_prefill_tokens", "requests_lost", "chaos_crashes")})
        return [cluster_state(sampled), cluster_state(golden, slo_ttft=2.0, slo_tpot=0.05), pins]

    sampled, _, pins = assert_same(fleets)
    assert sampled["chaos_stats"]["crashes"] > 0
    assert pins == {"ttft_p95": 0.317871, "tpot_p95": 0.0289603, "goodput_frac": 1.0,
                    "tokens_per_s": 536.038, "recovery_s_mean": 0.623245,
                    "re_prefill_tokens": 387, "requests_lost": 0, "chaos_crashes": 1}


@pytest.mark.parametrize("backoff,jitter", [(1.0, 0.0), (2.0, 0.5)])
def test_shed_retry_backoff_equals_jax(backoff, jitter):
    """JAX's thundering-herd fleet: the legacy fixed delay and exponential backoff
    with seeded jitter, each retry's instant in the trace."""
    def fleet(s):
        tr = s.obs.make_tracer("summary")
        cres = s.cl.simulate_cluster(
            workload(s, arrival="bursty", qps=120.0, num_requests=80).generate(),
            s.cfg("qwen3_14b"),
            spec(s, ["mixed"], sched=s.sim.SchedConfig(slots=4), shed_depth=4, retry_after=0.25,
                 max_retries=4, retry_backoff=backoff, retry_jitter=jitter), tracer=tr)
        return [cluster_state(cres), _bits(tr.events)]

    state, events = assert_same(fleet)
    assert state["retries"] > 0 and any(e.get("name") == "request.retry" for e in events)


@pytest.mark.parametrize("policy", PORT.cl.ADMISSION_POLICIES)
def test_admission_door_equals_jax(policy):
    def fleet(s):
        if policy == "token_bucket":
            door = s.cl.AdmissionConfig(policy="token_bucket", rate=20.0, burst=4, queue_depth=2)
            sp = spec(s, ["mixed"], admission=door)
            reqs = workload(s, qps=100.0, num_requests=60).generate()
        else:
            door = s.cl.AdmissionConfig(policy="breaker", window=5.0, fail_thresh=0.5,
                                        min_samples=5, cooloff=1.0, probes=2)
            sp = spec(s, ["mixed"], sched=s.sim.SchedConfig(slots=2), shed_depth=2,
                      retry_after=0.2, max_retries=1, admission=door)
            reqs = workload(s, qps=150.0, num_requests=80).generate()
        return cluster_state(s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), sp))

    state = assert_same(fleet)
    ad = state["admission_stats"]
    assert ad["door_shed"] > 0
    if policy == "breaker":
        assert ad["breaker_opens"] >= 1


def test_door_units_equal_jax():
    """The GCRA bucket and the breaker's state machine over one offer/observe sequence."""
    def doors(s):
        ch, _ = UNITS["port" if s is PORT else "jax"]
        tb = ch.TokenBucket(s.cl.AdmissionConfig(rate=1.0, burst=2, queue_depth=1))
        br = ch.CircuitBreaker(s.cl.AdmissionConfig(policy="breaker", window=10.0,
                                                    fail_thresh=0.5, min_samples=4, cooloff=2.0,
                                                    probes=2))
        out = []
        for i, t in enumerate((0.0, 0.0, 0.0, 0.0, 0.4, 1.3, 2.6, 2.7, 2.8, 3.2, 10.0)):
            out.append([tb.offer(i, t), br.offer(i, t), br.state])
            br.observe(i, t + 0.1, ok=i > 6)
            tb.observe(i, t + 0.1, ok=True)
        return _bits([out, tb.stats(), br.stats()])

    assert_same(doors)


# --------------------------------------------------------------- prefix cache
@pytest.mark.parametrize("pools", [["mixed"] * 3, ["prefill", "prefill", "decode", "decode"]])
@pytest.mark.parametrize("hit_frac", [0.5, 0.9])
def test_infinite_cache_is_the_legacy_discount(pools, hit_frac):
    """An infinite budget with no TTL is the legacy `hit_frac` discount in the port
    (assignments, records, hits), and each equals JAX's."""
    def fleets(s):
        reqs = workload(s, qps=50.0, num_requests=40, num_sessions=6).generate()
        legacy = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"),
                                       spec(s, pools, router="affinity", hit_frac=hit_frac))
        cached = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), spec(
            s, pools, router="affinity", hit_frac=hit_frac,
            prefix_cache=s.cl.PrefixCacheConfig(budget_bytes=math.inf, ttl=None)))
        return [cluster_state(legacy), cluster_state(cached)]

    legacy, cached = assert_same(fleets)
    for k in ("assignments", "records", "prefix_hits"):
        assert cached[k] == legacy[k], k
    assert cached["cache_stats"]["evictions_lru"] == cached["cache_stats"]["evictions_ttl"] == 0


@pytest.mark.parametrize("ttl", [None, 5.0])
@pytest.mark.parametrize("pools", [["mixed", "mixed"], ["prefill", "decode"]])
def test_finite_cache_equals_jax(pools, ttl):
    """A finite budget (and a TTL) over shared prefix groups: JAX's golden fleet
    (`tests/test_prefixcache.py`), its 6-figure pins where JAX pins them."""
    def fleet(s):
        reqs = workload(s, qps=50.0, num_requests=48, num_sessions=6, num_prefix_groups=3,
                        prefix=s.sim.LengthDist("fixed", 64.0)).generate()
        cres = s.cl.simulate_cluster(reqs, s.cfg("qwen3_14b"), spec(
            s, pools, router="affinity",
            prefix_cache=s.cl.PrefixCacheConfig(budget_frac=0.0005, ttl=ttl)))
        sm = s.cl.summarize_cluster(cres, slo_ttft=2.0, slo_tpot=0.05)
        return [cluster_state(cres, slo_ttft=2.0, slo_tpot=0.05),
                {k: _sig6(sm[k]) for k in ("ttft_p95", "tokens_per_s", "cache_hit_tokens",
                                           "cache_evictions", "prefix_hits")}]

    state, pins = assert_same(fleet)
    assert state["cache_stats"]["evictions_lru"] > 0
    if ttl is not None:
        assert pins == {("mixed", "mixed"): dict(ttft_p95=0.344535, tokens_per_s=621.098,
                                                 cache_hit_tokens=1974.0, cache_evictions=12.0,
                                                 prefix_hits=32.0),
                        ("prefill", "decode"): dict(ttft_p95=0.0283952, tokens_per_s=583.706,
                                                    cache_hit_tokens=2138.0,
                                                    cache_evictions=11.0,
                                                    prefix_hits=35.0)}[tuple(pools)]


def test_replica_prefix_cache_unit_equals_jax():
    """LRU under a byte budget, TTL expiry and recency refresh, an oversized prefix,
    sessions: one sequence of uses, reads and commits, with the counters."""
    def uses(s):
        _, pc = UNITS["port" if s is PORT else "jax"]
        c = pc.ReplicaPrefixCache(budget=100.0, ttl=10.0, cost=_UnitCost())
        out = []
        for k in range(30):
            req = s.sim.SimRequest(k, 0.0, 50 + 17 * k % 200, 4, session=k % 3 - 1,
                                   prefix_group=k % 5 - 1, prefix_len=20 + 9 * (k % 4))
            t = 1.5 * k
            out.append([c.use(req, t, 0.5), c.resident_tokens(req, t + 4.0, 0.5), c.used_bytes])
            if k % 3 == 0:
                c.commit(req, t + 1.0)
            if k == 20:
                c.invalidate()
        stats = [c.evictions_lru, c.evictions_ttl, c.rejected, c.peak_bytes]
        return _bits([out, stats, pc.prefix_key(req), pc.prefix_cap(req, 0.5)])

    assert_same(uses)


# -------------------------------------------------------------------- planner
def _plan(s, **kw):
    base = dict(qps=80.0, slo_ttft=0.3, slo_tpot=0.1, attainment=0.9,
                sched=s.sim.SchedConfig(slots=8), ctx_quantum=32, max_replicas=4)
    base.update(kw)
    return _bits(s.cl.plan_capacity(s.cfg("qwen3_14b"), workload(s, num_requests=40), **base))


def test_plan_capacity_serial_and_forked_equal_jax():
    """The sweep serially and over two worker processes (the pool forks this
    process, which holds no CUDA context), each equal to JAX's serial sweep."""
    jax = _plan(SIDES["jax"])
    assert _plan(PORT) == jax
    assert _plan(PORT, sweep_workers=2) == jax
    assert jax["best"] is not None and len(jax["rows"]) > 2


@pytest.mark.parametrize("kw", [dict(loss_tolerance=1, modes=("colocated",), max_replicas=5),
                                dict(loss_tolerance=1, modes=("disaggregated",), qps=20.0,
                                     early_stop=False),
                                dict(prefix_cache=None, cache_fracs=(0.05, 0.1), cache_ttl=5.0,
                                     router="affinity", modes=("colocated",))])
def test_plan_capacity_options_equal_jax(kw):
    got = assert_same(lambda s: _plan(s, **kw))
    assert got["rows"]


def test_provisioning_prices_and_seed_predictive_equal_jax():
    def econ(s):
        wl = _diurnal(s)
        reqs = wl.generate()
        asc = s.cl.AutoscaleConfig(min_replicas=1, max_replicas=4, interval=0.5, warmup=0.5)
        seeded = s.cl.seed_predictive(asc, wl, reqs)
        seeded_wl = s.cl.seed_predictive(asc, wl)
        sp = spec(s, ["mixed"], hw="a100", shed_depth=5, retry_after=0.1, max_retries=0)
        cres = s.cl.simulate_cluster([s.sim.SimRequest(i, 0.0, 96, 16) for i in range(30)],
                                     s.cfg("qwen3_14b"), sp)
        fields = ("policy", "lookahead", "target_wait", "service_time", "service_cv2",
                  "mean_prompt", "mean_output", "warmup", "min_replicas", "max_replicas")
        return _bits([{f: getattr(seeded, f) for f in fields},
                      {f: getattr(seeded_wl, f) for f in fields},
                      [seeded.envelope(t, t + 2.0) for t in (0.0, 3.0, 7.5)],
                      s.cl.provisioning_summary(cres, shed_cost_usd=0.01),
                      s.cl.provisioning_summary(cres, {"a100": 2.5}),
                      s.cl.cluster_price_per_hr(sp), s.cl.replica_price_per_hr(sp.replicas[0]),
                      dict(s.cl.DEFAULT_PRICE_PER_DEV_HR)])

    got = assert_same(econ)
    assert got[3]["shed"] == 25
