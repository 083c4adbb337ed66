"""The port's prefill and decode attention against `repro.models.attention`.

Layer-0 attention weights of a JAX-initialized reduced qwen3 go through
`from_jax`; the same numpy hidden states go to both. The JAX config asks for
`attn_impl="chunked"` (which `reduced()` turns off) with S = 48 > the chunk
of 16, so JAX takes `_chunked_attention` while the port takes its kernel
path (the plain flash version on the CPU) and its plain path. float32
throughout: tolerance 2e-5, the same function with sums in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models.params import from_jax, layer_params
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = 2e-5


def _setup(window):
    jcfg = dataclasses.replace(jax_get_config("qwen3_14b").reduced(), attn_impl="chunked",
                               sliding_window=window)
    cfg = dataclasses.replace(get_config("qwen3_14b").reduced(), sliding_window=window)
    jparams = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(3)))
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]), jparams["layers"]["attn"])
    pt = layer_params(from_jax(jparams, cfg, CPU), 0)["attn"]
    return jcfg, cfg, pj, pt


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)


@pytest.mark.slow
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("kernels", [True, False])
def test_prefill_then_decode_matches_jax(window, kernels):
    jcfg, cfg, pj, pt = _setup(window)
    rng = np.random.default_rng(4)
    B, S, max_len = 2, 48, 64
    x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    out_j, cache_j = jax.jit(lambda p, h: jattn.prefill_attention(jcfg, p, h, max_len))(pj, jnp.asarray(x))
    out_t, cache_t = tattn.prefill_attention(cfg, pt, torch.from_numpy(x), max_len, kernels=kernels)
    _close(out_j, out_t)
    for name in ("k", "v"):  # ring order (slot = t mod W) for the window case
        assert cache_t[name].shape == cache_j[name].shape
        _close(cache_j[name], cache_t[name])

    dec = jax.jit(lambda p, h, c, pos: jattn.decode_attention(jcfg, p, h, c, pos))
    for pos in range(S, S + 5):
        x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        out_j, cache_j = dec(pj, jnp.asarray(x1), cache_j, jnp.int32(pos))
        out_t, same = tattn.decode_attention(cfg, pt, torch.from_numpy(x1), cache_t, pos,
                                             kernels=kernels)
        assert same is cache_t  # updated in place
        _close(out_j, out_t)
        _close(cache_j["k"], cache_t["k"])


@pytest.mark.slow
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("kernels", [True, False])
def test_self_attention_matches_jax(window, kernels):
    """`Model.forward`'s attention: JAX's flash-VJP chunked path against the
    port's kernel path (the plain flash version on the CPU) and plain path."""
    jcfg, cfg, pj, pt = _setup(window)
    x = np.random.default_rng(6).standard_normal((2, 48, cfg.d_model), dtype=np.float32)
    out_j = jax.jit(lambda p, h: jattn.self_attention(jcfg, p, h))(pj, jnp.asarray(x))
    _close(out_j, tattn.self_attention(cfg, pt, torch.from_numpy(x), kernels=kernels))


@pytest.mark.parametrize("window", [None, 16])
def test_decode_from_empty_cache_ring_validity(window):
    """Early positions of a ring cache (pos < W): n_valid = pos + 1 equals JAX's slot rule."""
    jcfg, cfg, pj, pt = _setup(window)
    rng = np.random.default_rng(5)
    B, max_len = 2, 32
    cache_j = {k: jnp.zeros_like(v) for k, v in jattn.init_attn_cache(jcfg, B, max_len).items()}
    cache_t = tattn.init_attn_cache(cfg, B, max_len, CPU)
    for pos in range(20):
        x1 = rng.standard_normal((B, 1, cfg.d_model), dtype=np.float32)
        out_j, cache_j = jattn.decode_attention(jcfg, pj, jnp.asarray(x1), cache_j, jnp.int32(pos))
        out_t, _ = tattn.decode_attention(cfg, pt, torch.from_numpy(x1), cache_t, pos)
        _close(out_j, out_t)


def test_decode_past_a_full_cache_raises():
    _, cfg, _, pt = _setup(None)
    cache = tattn.init_attn_cache(cfg, 1, 4, CPU)
    with pytest.raises(ValueError):
        tattn.decode_attention(cfg, pt, torch.zeros(1, 1, cfg.d_model), cache, 4)
