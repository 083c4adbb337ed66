"""The executed schedule against the simulated one, on the CPU.

The port's `ServeEngine` serves a reduced model; the port's `simulate` prices the
same requests (`SimRequest(i, 0.0, prompt, output)`, every arrival at 0) under
the `continuous` policy with the engine's slot count. The two schedules must be
one: the same decode steps, one simulated admission time for each of the
engine's prefills, holding the requests that prefill admitted, FCFS order, and
each request's tokens equal to its `output`. `to_engine_requests` must build
JAX's prompts from the same draws.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.sim as jsim
import repro_torch.sim as tsim
from repro_torch.configs import get_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import ServeEngine
from torch_threads import one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

SLOTS = 3


def _requests(seed: int, n: int = 7):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(3, 24, n)
    outputs = rng.integers(1, 12, n)
    return [tsim.SimRequest(i, 0.0, int(p), int(o)) for i, (p, o) in enumerate(zip(prompts, outputs))]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("arch", ["qwen3_14b", "deepseek_moe_16b", "zamba2_1p2b", "rwkv6_7b"])
def test_engine_runs_the_simulated_schedule(arch, seed):
    cfg = get_config(arch).reduced()
    sim_reqs = _requests(seed)
    res = tsim.simulate(sim_reqs, tsim.ServingCostModel(cfg, H100_SXM, tp=1, ctx_quantum=1),
                        tsim.SchedConfig(policy="continuous", slots=SLOTS))
    model = Model(cfg)
    engine = ServeEngine(model, model.init(seed, torch.device("cpu")), max_len=48, slots=SLOTS)
    reqs = engine.serve(tsim.to_engine_requests(sim_reqs, cfg.vocab_size, seed=seed))
    assert res.decode_steps == engine.decode_steps
    assert len({r.admitted for r in res.records}) == engine.admissions == len(engine.admitted)
    assert res.admit_order == [i for batch in engine.admitted for i in batch] == list(range(7))
    assert chip_smoke.sim_admissions(res) == engine.admitted
    assert [len(r.out_tokens) for r in reqs] == [r.output for r in res.records] == \
        [r.output for r in sim_reqs]
    assert engine.admissions > 1 and len({r.output for r in sim_reqs}) > 1


@pytest.mark.parametrize("seed", [0, 5])
def test_to_engine_requests_equals_jax(seed):
    wl = {m: m.Workload(qps=4.0, num_requests=9, seed=seed,
                        prompt=m.LengthDist("lognormal", 40, 0.5, lo=2, hi=200),
                        output=m.LengthDist("lognormal", 8, 0.5, lo=1, hi=64))
          for m in (tsim, jsim)}
    port = tsim.to_engine_requests(wl[tsim].generate(), 1000, seed=seed)
    jax = jsim.to_engine_requests(wl[jsim].generate(), 1000, seed=seed)
    assert type(port[0]).__module__ == "repro_torch.serve.engine"
    assert len(port) == len(jax) == 9
    for a, b in zip(port, jax):
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert np.array_equal(a.prompt, b.prompt)
        assert a.max_new_tokens == b.max_new_tokens
