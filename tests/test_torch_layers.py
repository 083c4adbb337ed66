"""The port's shared layers against `repro.models.layers` and `repro.models.mlp`.

Same numpy inputs to both; float32 throughout, tolerance 2e-5 (the same
arithmetic, sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import layers as jl
from repro.models.mlp import apply_mlp as jax_apply_mlp
from repro_torch.models import layers as tl
from repro_torch.models.mlp import apply_mlp
from torch_threads import one_thread  # noqa: F401

TOL = 2e-5


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _close(j, t, atol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_apply_norm_and_head_norm(rng):
    xj, xt = _pair(rng.standard_normal((3, 7, 128), dtype=np.float32))
    sj, st = _pair(rng.standard_normal((128,), dtype=np.float32))
    _close(jl.apply_norm({"scale": sj}, xj), tl.apply_norm({"scale": st}, xt))
    hj, ht = _pair(rng.standard_normal((3, 7, 4, 32), dtype=np.float32) * 1e-3)
    dj, dt = _pair(rng.standard_normal((32,), dtype=np.float32))
    # tiny inputs, where eps (1e-6 here, 1e-5 in apply_norm) shows
    _close(jl.rms_head_norm(dj, hj), tl.rms_head_norm(dt, ht))


@pytest.mark.parametrize("pos_shape", ["S", "B1"])
def test_apply_rope(rng, pos_shape):
    B, S, H, dh = 2, 9, 4, 32
    xj, xt = _pair(rng.standard_normal((B, S, H, dh), dtype=np.float32))
    if pos_shape == "S":
        pos = np.arange(100, 100 + S, dtype=np.int32)
    else:
        S = 1
        xj, xt = xj[:, :1], xt[:, :1]
        pos = np.full((B, 1), 1537, np.int32)
    pj, pt = _pair(pos)
    _close(jl.apply_rope(xj, pj, 1e6), tl.apply_rope(xt, pt, 1e6), atol=1e-5)


def test_silu_embed_and_logits(rng):
    xj, xt = _pair(rng.standard_normal((4, 64), dtype=np.float32))
    _close(jl.activation("silu")(xj), tl.activation("silu")(xt))
    tab_j, tab_t = _pair(rng.standard_normal((512, 64), dtype=np.float32))
    tok = rng.integers(0, 512, (2, 5)).astype(np.int32)
    _close(jl.embed_lookup({"tok": tab_j}, jnp.asarray(tok), jnp.float32),
           tl.embed_lookup({"tok": tab_t}, torch.from_numpy(tok), torch.float32))
    wj, wt = _pair(rng.standard_normal((64, 512), dtype=np.float32))
    hj, ht = jnp.asarray(xj).astype(jnp.bfloat16), xt.to(torch.bfloat16)
    # bf16 hidden state, fp32 head: both promote to fp32 before the product
    _close(jl.lm_logits({"w": wj}, hj, jnp.float32), tl.lm_logits({"w": wt}, ht, torch.float32),
           atol=1e-4)


@pytest.mark.parametrize("gated", [True, False])
def test_apply_mlp(rng, gated):
    D, F = 64, 96
    p_np = {k: rng.standard_normal(s, dtype=np.float32) * 0.1
            for k, s in (("wi", (D, F)), ("wo", (F, D)), ("wg", (D, F)))}
    if not gated:
        del p_np["wg"]
    pj = {k: jnp.asarray(v) for k, v in p_np.items()}
    pt = {k: torch.from_numpy(v) for k, v in p_np.items()}
    for shape in ((2, 5, D), (7, D)):
        xj, xt = _pair(rng.standard_normal(shape, dtype=np.float32))
        _close(jax_apply_mlp(pj, xj, "silu"), apply_mlp(pt, xt, "silu"))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu2"])
def test_activations(rng, name):
    # gelu is the tanh approximation in both (JAX's approximate=True)
    xj, xt = _pair(rng.standard_normal((4, 7, 64), dtype=np.float32) * 3)
    _close(jl.activation(name)(xj), tl.activation(name)(xt))


def test_layernorm(rng):
    """LayerNorm (a `bias` in the norm's params): population variance, eps 1e-5."""
    xj, xt = _pair(rng.standard_normal((3, 7, 128), dtype=np.float32) * 2 + 0.5)
    sj, st = _pair(rng.standard_normal((128,), dtype=np.float32))
    bj, bt = _pair(rng.standard_normal((128,), dtype=np.float32))
    _close(jl.apply_norm({"scale": sj, "bias": bj}, xj), tl.apply_norm({"scale": st, "bias": bt}, xt))
    hj, ht = _pair(rng.standard_normal((5, 64), dtype=np.float32) * 1e-3)  # where eps shows
    s1j, s1t = _pair(np.ones(64, np.float32))
    z = np.zeros(64, np.float32)
    _close(jl.apply_norm({"scale": s1j, "bias": jnp.asarray(z)}, hj),
           tl.apply_norm({"scale": s1t, "bias": torch.from_numpy(z)}, ht))
    # bf16 in, bf16 out: the norm runs in fp32 and casts back, in both (one
    # bf16 step apart at most, where the fp32 sums differ in their last bit)
    yj = jl.apply_norm({"scale": sj, "bias": bj}, xj.astype(jnp.bfloat16))
    yt = tl.apply_norm({"scale": st, "bias": bt}, xt.bfloat16())
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32), rtol=2**-8, atol=1e-6)


@pytest.mark.parametrize("act", ["gelu", "relu2"])
def test_plain_mlp(rng, act):
    """The non-gated MLP of starcoder2 (gelu), musicgen (gelu) and minitron (relu2)."""
    D, F = 64, 96
    p_np = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in (("wi", (D, F)), ("wo", (F, D)))}
    pj = {k: jnp.asarray(v) for k, v in p_np.items()}
    pt = {k: torch.from_numpy(v) for k, v in p_np.items()}
    xj, xt = _pair(rng.standard_normal((2, 5, D), dtype=np.float32))
    _close(jax_apply_mlp(pj, xj, act), apply_mlp(pt, xt, act))
