"""The port's ServeEngine against the JAX ServeEngine: identical greedy tokens.

qwen3-14b, h2o-danube (prompts past its window) and starcoder2 (LayerNorm).
Prompt lengths are drawn from 12-20 (h2o-danube: 20-30), so admissions left-pad with token 0 and
a later admission sets the scalar position to max(old, new) (the known
behaviour of `repro.serve.engine`, ROADMAP C2), which the port reproduces.
"""

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as jax_get_config
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Request, ServeEngine
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.slow  # JAX compiles a prefill per admitted prompt length

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def engines():
    jcfg, cfg = jax_get_config("qwen3_14b").reduced(), get_config("qwen3_14b").reduced()
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jm, jparams, Model(cfg), tparams, cfg


def test_serve_tokens_and_decode_steps_match_jax(engines):
    jm, jparams, model, tparams, cfg = engines
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(12, 21))).astype(np.int32)
               for _ in range(7)]
    new = [int(n) for n in rng.integers(3, 7, size=7)]
    jeng = JaxEngine(jm, jparams, max_len=64, slots=3)
    teng = ServeEngine(model, tparams, max_len=64, slots=3)
    jdone = jeng.serve([JaxRequest(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    tdone = teng.serve([Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert all(r.done for r in tdone)
    assert teng.decode_steps == jeng.decode_steps


@pytest.mark.parametrize("arch,lens", [("h2o_danube_1p8b", (20, 31)), ("starcoder2_3b", (12, 21))])
def test_serve_family_tokens_and_decode_steps_match_jax(arch, lens):
    """h2o-danube with prompts longer than its reduced window of 16 (the prefill
    keeps the last 16 tokens in ring order, decode runs on a full ring), and
    starcoder2 (LayerNorm, no norm kernel) through the same scheduler."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(4))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(*lens))).astype(np.int32)
               for _ in range(5)]
    new = [int(n) for n in rng.integers(3, 7, size=5)]
    # 3 slots, not 2: JAX's `_admit` takes a stacked (L, B, ...) cache leaf for a
    # (B, ...) one when L == slots and splices layers instead of slots (ROADMAP C7)
    jeng = JaxEngine(jm, jparams, max_len=64, slots=3)
    teng = ServeEngine(Model(cfg), tparams, max_len=64, slots=3)
    jdone = jeng.serve([JaxRequest(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    tdone = teng.serve([Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert all(r.done for r in tdone) and teng.decode_steps == jeng.decode_steps


def test_admit_splices_slots_when_layers_equal_slots():
    """With 2 layers and 2 slots, an admission replaces the admitted slot of
    every layer's cache and leaves the other slot as it was (JAX's splice
    takes the layer axis for the slot axis here, ROADMAP C7)."""
    cfg = get_config("qwen3_14b").reduced()
    assert cfg.num_layers == 2
    model = Model(cfg)
    params = model.init(0, CPU)
    eng = ServeEngine(model, params, max_len=32, slots=2)
    active = [Request(prompt=np.arange(5, dtype=np.int32) + 1, max_new_tokens=2),
              Request(prompt=np.arange(7, dtype=np.int32) + 9, max_new_tokens=2)]
    cache, logits = eng._admit([0], active, None, None)
    before = {k: v.clone() for k, v in cache["layers"]["kv"].items()}
    cache, _ = eng._admit([1], active, cache, logits)
    toks = np.zeros((2, 7), np.int32)
    toks[1] = active[1].prompt
    _, fresh = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 32)
    for k, v in cache["layers"]["kv"].items():
        assert torch.equal(v[:, 0], before[k][:, 0])
        assert torch.equal(v[:, 1], fresh["layers"]["kv"][k][:, 1])
    assert cache["pos"] == 7


def test_generate_matches_jax(engines):
    jm, jparams, model, tparams, cfg = engines
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (16, 13)]
    outs_j = JaxEngine(jm, jparams, max_len=48, slots=2).generate(prompts, max_new_tokens=5)
    outs_t = ServeEngine(model, tparams, max_len=48, slots=2).generate(prompts, max_new_tokens=5)
    assert outs_t == outs_j


def test_sampling_is_seeded(engines):
    _, _, model, tparams, cfg = engines
    prompts = [np.arange(10, dtype=np.int32)]
    a = ServeEngine(model, tparams, max_len=32, seed=7).generate(prompts, 6, temperature=1.0)
    b = ServeEngine(model, tparams, max_len=32, seed=7).generate(prompts, 6, temperature=1.0)
    assert a == b and all(0 <= t < cfg.vocab_size for t in a[0])
