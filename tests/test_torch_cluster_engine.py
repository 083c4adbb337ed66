"""A fleet of the port's `ServeEngine` runs the cluster's per-replica schedules, on the CPU.

`chip_smoke.py`'s phase 13 (a) at `reduced()`: the port's `simulate_cluster`
routes requests that all arrive at 0 over two continuous replicas of 2 slots
(`ctx_quantum` 1); each replica's requests, in rid order, are then served by an
engine of its own, and its decode steps, admissions (the engine's indices mapped
back to rids, so the FCFS order too) and tokens a request must be the simulated
replica's. h2o-danube's prompts pass its reduced window of 16, so each admission
prefills past it; the outputs vary, so later admissions join mid-decode. The
fleet's routing is JAX's (`repro.cluster`), and a decode resumed from a handed-off
cache is the source's, bit for bit (`tests/test_torch_smoke_cluster.py`).
"""

import sys
from pathlib import Path

import pytest
import torch

import repro.cluster as jcl
import repro.sim as jsim
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from torch_threads import one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
FLEET = dict(requests=9, prompt_len=(17, 30), max_new=(1, 9), replicas=2, slots=2, max_len=96)


@pytest.fixture
def no_launches(monkeypatch):
    """No kernel launches on the CPU: the launch checks are told the path has none
    (rwkv6's case on the card)."""
    monkeypatch.setattr(chip_smoke, "used_kernels", lambda cfg: [])
    monkeypatch.setattr(chip_smoke, "attention_blocks", lambda cfg: 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ["qwen3_14b", "h2o_danube_1p8b"])
def test_fleet_of_engines_runs_the_simulated_schedules(arch, seed, no_launches):
    cfg = get_config(arch).reduced()
    out = chip_smoke.phase_cluster_fleet(CPU, cfg, seed=seed, **FLEET)
    rows = out["rows"]
    assert len(rows) == 2 and sorted(r for row in rows for r in row["rids"]) == list(range(9))
    assert all(row["sim"]["admissions"] > 1 for row in rows)
    assert any(len(batch) == 1 for row in rows for batch in row["admitted"][1:])  # mid-decode
    assert len(set(out["news"])) > 1
    if cfg.sliding_window is not None:
        assert min(out["lens"]) > cfg.sliding_window
    # the routing is JAX's
    reqs = [jsim.SimRequest(i, 0.0, n, m) for i, (n, m) in enumerate(zip(out["lens"],
                                                                         out["news"]))]
    rs = jcl.ReplicaSpec("h100", ctx_quantum=1, sched=jsim.SchedConfig("continuous", slots=2))
    jax = jcl.simulate_cluster(reqs, jax_get_config(arch).reduced(), jcl.ClusterSpec(
        replicas=(rs, rs)))
    assert [sorted(r for r, (i, _) in jax.assignments.items() if i == k) for k in (0, 1)] == \
        [row["rids"] for row in rows]


def test_the_routers_route_alike_when_every_arrival_is_at_zero():
    """CLUSTER_NOTE's reason to run one router on the card: with every arrival at 0,
    round_robin, jsq and least_kv send rid i to replica i mod 2, on (a)'s draw."""
    cfg = get_config("h2o_danube_1p8b")
    lens, news, _ = chip_smoke.cluster_traffic(cfg, 0)
    for router in ("round_robin", "jsq", "least_kv"):
        cres = chip_smoke.simulate_fleet(cfg, lens, news, ["mixed"] * 2, 2, router=router)
        assert cres.assignments == {i: (i % 2, -1) for i in range(12)}, router


def test_a_fleet_schedule_that_differs_is_refused(no_launches, monkeypatch):
    """One request simulated with a token more than it is served: the replica's
    decode steps or tokens differ, and phase 13 (a) must fail."""
    real = chip_smoke.simulate_fleet

    def one_more(cfg, lens, news, pools, slots, router="jsq"):
        return real(cfg, lens, [news[0] + 1, *news[1:]], pools, slots, router)

    monkeypatch.setattr(chip_smoke, "simulate_fleet", one_more)
    with pytest.raises(AssertionError, match="replica 0's schedule: .*(decode steps|outputs)"):
        chip_smoke.phase_cluster_fleet(CPU, get_config("qwen3_14b").reduced(), **FLEET)
