"""The rest of the dense family in the port against the JAX Model: same weights, same inputs.

h2o-danube (sliding window 16 at `reduced()`, and at its real head_dim 80),
pixtral (vlm, `embeds` input), starcoder2 (LayerNorm, plain gelu MLP, kv 2),
minitron (LayerNorm, relu2) and musicgen (audio, LayerNorm, gelu, MHA,
`embeds`), each at `reduced()` in float32 with JAX's weights through
`from_jax`, with `kernels=True` (the kernels' plain versions on the CPU) and
`kernels=False`:

- prefill of 48 tokens, then 16 teacher-forced decode steps, against JAX's;
- `forward` logits against JAX's `forward`;
- prefill + decode against the port's own `forward` (the invariant of
  `tests/test_decode_equivalence.py`);
- `loss` (`ce` and `accuracy`) against JAX's `Model.loss`, on labels of
  which some are -1 and some are the reference's own argmax, so that the
  accuracy is neither 0 nor 1.

Bars: logits within 2e-3 (`tests/test_decode_equivalence.py`'s bar; in
float32 the two packages agree to about 1e-5), greedy tokens identical,
`ce` and `accuracy` within 1e-5.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models.transformer import AUX_KEYS
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import Model
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.slow  # JAX compiles each reduced model

CPU = torch.device("cpu")
B, S, S0 = 2, 64, 48  # 48 > the reduced window of 16: danube's decode runs on a full ring
TOL = 2e-3
# case id -> (arch, reduced() overrides)
CASES = {
    "h2o_danube_1p8b": ("h2o_danube_1p8b", {}),
    "h2o_danube_1p8b-dh80": ("h2o_danube_1p8b", {"head_dim": 80}),
    "pixtral_12b": ("pixtral_12b", {}),
    "starcoder2_3b": ("starcoder2_3b", {}),
    "minitron_8b": ("minitron_8b", {}),
    "musicgen_large": ("musicgen_large", {}),
}


def _models(arch, overrides, seed):
    jcfg, cfg = jax_get_config(arch).reduced(**overrides), get_config(arch).reduced(**overrides)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    return jm, jparams, cfg, from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)


def _jax_prefill_decode(jm, jparams, batch, tokens):
    """JAX's prefill of `batch`, then decode of tokens[:, S0:]: logits (S - S0 + 1, B, V)."""
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=S))(jparams, batch)
    dec = jax.jit(jm.decode_step)
    outs = [np.asarray(logits)]
    for i in range(S0, S):
        logits, cache = dec(jparams, cache, jnp.asarray(tokens[:, i:i + 1]))
        outs.append(np.asarray(logits))
    return np.stack(outs)


def _jax_forward_logits(jm, jparams, batch):
    return np.asarray(jax.jit(lambda p, b: jm._head(p, jm.forward(p, b)[0]))(jparams, batch))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, overrides = CASES[request.param]
    jm, jparams, cfg, tparams = _models(arch, overrides, seed=2)
    assert cfg.sliding_window in (None, 16) and (cfg.head_dim == 80) == ("head_dim" in overrides)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    fwd = _jax_forward_logits(jm, jparams, batch)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, ::2] = fwd.argmax(-1)[:, ::2]  # hits, so that the accuracy is ~0.5
    labels[0, :7] = labels[1, -5:] = -1  # ignored
    _, met = jax.jit(jm.loss)(jparams, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    return SimpleNamespace(
        cfg=cfg, tparams=tparams, tokens=tokens, labels=labels, fwd=fwd,
        decode=_jax_prefill_decode(jm, jparams, {"tokens": jnp.asarray(tokens[:, :S0])}, tokens),
        loss={k: float(met[k]) for k in ("loss", "ce", "accuracy", *AUX_KEYS)})


def _port_prefill_decode(model, params, batch, tokens):
    """The port's prefill of `batch`, then decode of tokens[:, S0:]: logits (S - S0 + 1, B, V)."""
    t = torch.from_numpy(tokens)
    logits, cache = model.prefill(params, batch, max_len=S)
    outs = [logits]
    for i in range(S0, S):
        logits, cache = model.decode_step(params, cache, t[:, i:i + 1])
        outs.append(logits)
    assert cache["pos"] == S
    return torch.stack(outs).numpy()


def _port_forward_logits(model, params, batch):
    x, aux = model.forward(params, batch)
    assert sorted(aux) == sorted(AUX_KEYS) and all(float(v) == 0.0 for v in aux.values())
    return model._head(params, x).numpy()


@pytest.mark.parametrize("kernels", [True, False])
def test_prefill_decode_matches_jax(case, kernels):
    ours = _port_prefill_decode(Model(case.cfg, kernels=kernels), case.tparams,
                                {"tokens": torch.from_numpy(case.tokens[:, :S0])}, case.tokens)
    err = np.abs(ours - case.decode).max()
    assert err < TOL, err
    assert (ours.argmax(-1) == case.decode.argmax(-1)).all()


@pytest.mark.parametrize("kernels", [True, False])
def test_forward_matches_jax(case, kernels):
    ours = _port_forward_logits(Model(case.cfg, kernels=kernels), case.tparams,
                                {"tokens": torch.from_numpy(case.tokens)})
    err = np.abs(ours - case.fwd).max()
    assert err < TOL, err


@pytest.mark.parametrize("kernels", [True, False])
def test_prefill_decode_matches_own_forward(case, kernels):
    model = Model(case.cfg, kernels=kernels)
    full = _port_forward_logits(model, case.tparams, {"tokens": torch.from_numpy(case.tokens)})
    ours = _port_prefill_decode(model, case.tparams, {"tokens": torch.from_numpy(case.tokens[:, :S0])},
                                case.tokens)
    err = np.abs(ours - np.moveaxis(full[:, S0 - 1:], 1, 0)).max()
    assert err < TOL, err


@pytest.mark.parametrize("kernels", [True, False])
def test_loss_matches_jax(case, kernels):
    loss, met = Model(case.cfg, kernels=kernels).loss(
        case.tparams, {"tokens": torch.from_numpy(case.tokens), "labels": torch.from_numpy(case.labels)})
    assert 0.2 < case.loss["accuracy"] < 0.8  # the labels hold hits and misses
    assert float(loss) == float(met["loss"])
    for k, v in case.loss.items():
        assert abs(float(met[k]) - v) < 1e-5, (k, float(met[k]), v)


@pytest.mark.parametrize("arch", ["pixtral_12b", "musicgen_large"])
def test_embeds_input_matches_jax(arch):
    """The vlm and audio configs take precomputed embeddings (`batch["embeds"]`)
    in `forward` and `prefill`; decode continues from tokens, as in JAX."""
    jm, jparams, cfg, tparams = _models(arch, {}, seed=3)
    assert cfg.input_mode == "embeds"
    rng = np.random.default_rng(3)
    embeds = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fwd = _jax_forward_logits(jm, jparams, {"embeds": jnp.asarray(embeds)})
    dec = _jax_prefill_decode(jm, jparams, {"embeds": jnp.asarray(embeds[:, :S0])}, tokens)
    model = Model(cfg)
    ours_fwd = _port_forward_logits(model, tparams, {"embeds": torch.from_numpy(embeds)})
    ours_dec = _port_prefill_decode(model, tparams, {"embeds": torch.from_numpy(embeds[:, :S0])}, tokens)
    assert np.abs(ours_fwd - fwd).max() < TOL
    assert np.abs(ours_dec - dec).max() < TOL
    # the embeddings, not the token table, carried the prefill
    by_tokens = _port_prefill_decode(model, tparams, {"tokens": torch.from_numpy(tokens[:, :S0])}, tokens)
    assert np.abs(by_tokens - dec).max() > 1e-2


def test_loss_needs_whole_chunks():
    cfg = dataclasses.replace(get_config("starcoder2_3b").reduced(), loss_chunk=32)
    model = Model(cfg)
    params = model.init(0, CPU)
    toks = torch.zeros(1, 40, dtype=torch.long)
    with pytest.raises(ValueError, match="loss_chunk"):
        model.loss(params, {"tokens": toks, "labels": toks})
