"""The port's RWKV6 layer, rwkv6-7b and its serving against the JAX package.

All in float32 with JAX's weights (through `from_jax` for the model):

- `_wkv_chunk_scan` against JAX's at S = 5, 32 and 40 (chunk 32: shorter
  than a chunk, exactly one, and one plus padding with identity steps),
  from a zero and from a given state, with decays spread from ~1e-9 to ~1;
- `group_norm_heads` (eps 64e-5) against JAX's;
- the time mix and channel mix, sequence and decode paths, against JAX's;
- rwkv6-7b at `reduced()` (2 layers, LayerNorm everywhere, no kernel on its
  path), with `kernels=True` and `kernels=False`: prefill of 40 tokens and
  8 decode steps, `forward` and `loss` against JAX's;
- serving: 5 requests over 3 slots against JAX's `ServeEngine`, whose
  splice works on this cache ((L, B, ...) leaves, L = 2 != 3 slots).

Bars: layer outputs and states within 2e-5; logits within 2e-3
(`tests/test_decode_equivalence.py`'s bar); greedy tokens identical; `loss`
metrics within 1e-5.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv
from repro.models.params import init_params as jax_init_params
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import layers, rwkv6
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Request, ServeEngine
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.slow  # JAX compiles each shape and model

CPU = torch.device("cpu")
TOL = 2e-3
LAYER_TOL = 2e-5


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [5, 32, 40])
def test_wkv_chunk_scan_matches_jax(S, with_state):
    rng = np.random.default_rng(S)
    B, H, K = 2, 3, 8
    r, k, v = (rng.standard_normal((B, S, H, K), dtype=np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-6.0, 3.0, (B, S, H, K)))).astype(np.float32)  # ~1e-9 .. ~1
    u = 0.5 * rng.standard_normal((H, K), dtype=np.float32)
    s0 = rng.standard_normal((B, H, K, K), dtype=np.float32) if with_state else None
    js0 = None if s0 is None else jnp.asarray(s0)
    jy, jst = jax.jit(lambda *a: jrwkv._wkv_chunk_scan(*a, chunk=32, init_state=js0))(
        *(jnp.asarray(a) for a in (r, k, v, w, u)))
    y, st = rwkv6._wkv_chunk_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u)), chunk=32,
                                  init_state=None if s0 is None else torch.from_numpy(s0))
    assert y.shape == (B, S, H, K) and st.shape == (B, H, K, K)
    scale = max(1.0, float(np.abs(np.asarray(jy)).max()))
    assert _err(y, jy) < LAYER_TOL * scale and _err(st, jst) < LAYER_TOL * scale


def test_group_norm_heads_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16), dtype=np.float32) * 3 + 1
    p = {"scale": 1 + 0.1 * rng.standard_normal(64, dtype=np.float32),
         "bias": 0.1 * rng.standard_normal(64, dtype=np.float32)}
    ref = jlayers.group_norm_heads({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    assert _err(layers.group_norm_heads(_t(p), torch.from_numpy(x)), ref) < 1e-5


def test_time_and_channel_mix_match_jax():
    jcfg, cfg = jax_get_config("rwkv6_7b").reduced(), get_config("rwkv6_7b").reduced()
    jp = jax.tree.map(np.asarray, jax_init_params(jrwkv.rwkv6_defs(jcfg), jax.random.PRNGKey(1),
                                                  jnp.float32))
    rng = np.random.default_rng(1)
    jp["tm"]["maa"] = (0.3 * rng.standard_normal(jp["tm"]["maa"].shape)).astype(np.float32)
    jp["cm"]["mu_k"] = rng.uniform(0, 1, jp["cm"]["mu_k"].shape).astype(np.float32)
    tp = _t(jp)
    S = 40
    x = rng.standard_normal((2, S + 2, cfg.d_model), dtype=np.float32)
    tm_seq = jax.jit(lambda p, x: jrwkv.time_mix_seq(jcfg, p, x))
    ja, jst = tm_seq(jp["tm"], jnp.asarray(x[:, :S]))
    a, st = rwkv6.time_mix_seq(cfg, tp["tm"], torch.from_numpy(x[:, :S]))
    assert _err(a, ja) < LAYER_TOL and _err(st["wkv"], jst["wkv"]) < LAYER_TOL
    assert _err(st["shift"], jst["shift"]) == 0.0
    jfull, _ = tm_seq(jp["tm"], jnp.asarray(x))
    st = {k: v.clone() for k, v in st.items()}
    outs = [rwkv6.time_mix_decode(cfg, tp["tm"], torch.from_numpy(x[:, t:t + 1]), st)
            for t in (S, S + 1)]
    assert _err(torch.cat(outs, 1), np.asarray(jfull)[:, S:]) < LAYER_TOL
    jd, jst2 = jax.jit(lambda p, x, s: jrwkv.time_mix_decode(jcfg, p, x, s))(
        jp["tm"], jnp.asarray(x[:, S:S + 1]), jst)
    _, st1 = rwkv6.time_mix_seq(cfg, tp["tm"], torch.from_numpy(x[:, :S]))
    d = rwkv6.time_mix_decode(cfg, tp["tm"], torch.from_numpy(x[:, S:S + 1]), st1)
    assert _err(d, jd) < LAYER_TOL and _err(st1["wkv"], jst2["wkv"]) < LAYER_TOL
    jc, jcs = jax.jit(lambda p, x: jrwkv.channel_mix_seq(jcfg, p, x))(jp["cm"], jnp.asarray(x))
    c, cs = rwkv6.channel_mix_seq(cfg, tp["cm"], torch.from_numpy(x))
    assert _err(c, jc) < LAYER_TOL and _err(cs["shift"], jcs["shift"]) == 0.0
    cs = {"shift": torch.from_numpy(x[:, S])}
    c1 = rwkv6.channel_mix_decode(cfg, tp["cm"], torch.from_numpy(x[:, S + 1:S + 2]), cs)
    assert _err(c1, np.asarray(jc)[:, S + 1:S + 2]) < LAYER_TOL
    assert torch.equal(cs["shift"], torch.from_numpy(x[:, S + 1]))


# ------------------------------------------------------------------- the model
B, S, S0 = 2, 48, 40


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = jax_get_config("rwkv6_7b").reduced(), get_config("rwkv6_7b").reduced()
    assert cfg.norm == "layernorm" and cfg.family == "ssm"
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(12))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, cfg.vocab_size, (B, 64)).astype(np.int32)
    fwd = np.asarray(jax.jit(lambda p, t: jm._head(p, jm.forward(p, {"tokens": t})[0]))(
        jparams, jnp.asarray(tokens)))
    labels = rng.integers(0, cfg.vocab_size, (B, 64)).astype(np.int32)
    labels[:, ::2] = fwd.argmax(-1)[:, ::2]
    labels[1, -5:] = -1
    _, met = jax.jit(jm.loss)(jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=S))(
        jparams, {"tokens": jnp.asarray(tokens[:, :S0])})
    dec = jax.jit(jm.decode_step)
    outs = [np.asarray(logits)]
    for i in range(S0, S):
        logits, cache = dec(jparams, cache, jnp.asarray(tokens[:, i:i + 1]))
        outs.append(np.asarray(logits))
    return SimpleNamespace(jm=jm, jparams=jparams, cfg=cfg, tparams=tparams, tokens=tokens,
                           labels=labels, fwd=fwd, decode=np.stack(outs),
                           cache=jax.tree.map(np.asarray, cache), loss={k: float(met[k]) for k in met})


@pytest.mark.parametrize("kernels", [True, False])
def test_prefill_decode_matches_jax(case, kernels):
    model = Model(case.cfg, kernels=kernels)
    t = torch.from_numpy(case.tokens)
    logits, cache = model.prefill(case.tparams, {"tokens": t[:, :S0]}, max_len=S)
    outs = [logits]
    for i in range(S0, S):
        logits, cache = model.decode_step(case.tparams, cache, t[:, i:i + 1])
        outs.append(logits)
    ours = torch.stack(outs).numpy()
    assert _err(ours, case.decode) < TOL and (ours.argmax(-1) == case.decode.argmax(-1)).all()
    # JAX's cache structure, leaf by leaf: (L, B, ...) states after the same tokens
    assert set(cache) == {"layers", "pos"} and cache["pos"] == S
    for part, leaf in (("tm", "wkv"), ("tm", "shift"), ("cm", "shift")):
        ref = case.cache["layers"][part][leaf]
        assert tuple(cache["layers"][part][leaf].shape) == ref.shape
        assert _err(cache["layers"][part][leaf], ref) < 1e-4 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("kernels", [True, False])
def test_forward_and_loss_match_jax(case, kernels):
    model = Model(case.cfg, kernels=kernels)
    batch = {"tokens": torch.from_numpy(case.tokens)}
    x, _ = model.forward(case.tparams, batch)
    assert _err(model._head(case.tparams, x), case.fwd) < TOL
    loss, met = model.loss(case.tparams, {**batch, "labels": torch.from_numpy(case.labels)})
    assert 0.2 < case.loss["accuracy"] < 0.8 and float(loss) == float(met["loss"])
    for k, v in case.loss.items():
        assert abs(float(met[k]) - v) < 1e-5, (k, float(met[k]), v)


def test_serve_tokens_and_decode_steps_match_jax(case):
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, case.cfg.vocab_size, int(rng.integers(12, 40))).astype(np.int32)
               for _ in range(5)]
    new = [int(n) for n in rng.integers(3, 7, size=5)]
    jeng = JaxEngine(case.jm, case.jparams, max_len=64, slots=3)
    teng = ServeEngine(Model(case.cfg), case.tparams, max_len=64, slots=3)
    jdone = jeng.serve([JaxRequest(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    tdone = teng.serve([Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert teng.admissions >= 2 and teng.decode_steps == jeng.decode_steps
