"""The port's plain flash-attention VJP twin and RMSNorm backward against JAX.

`repro_torch.models.flash_vjp.FlashAttention` (the training path's attention
off the card, and the plain version the card holds the CUDA kernels to)
against `repro.models.flash_vjp.flash_attention_vjp`: value, LSE and dq, dk,
dv at the shapes and windows of `tests/test_attention.py::
test_flash_vjp_value_and_grads`, at GQA G 1 and 4. The plain RMSNorm backward
(`kernels/rmsnorm/ref.py::rmsnorm_bwd_ref`, the CUDA kernel's plain version)
against `jax.grad` of JAX's norms. float32 throughout; tolerance 1e-5: the
same functions with sums in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import flash_vjp as jfv
from repro.models.layers import apply_norm, rms_head_norm
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
from repro_torch.models import flash_vjp as tfv
from torch_threads import one_thread  # noqa: F401

TOL = 1e-5


def _inputs(B, S, Hkv, G, dh, seed=3):
    rng = np.random.default_rng(seed)
    q = 0.3 * rng.standard_normal((B, S, Hkv, G, dh), dtype=np.float32)
    k = 0.3 * rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)
    v = 0.3 * rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)
    do = rng.standard_normal((B, S, Hkv, G, dh), dtype=np.float32)
    return q, k, v, do


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=0)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("Hkv,G", [(1, 4), (4, 1)])
def test_twin_value_lse_and_grads_match_jax(window, Hkv, G):
    B, S, dh, chunk = 1, 96, 16, 32
    q, k, v, do = _inputs(B, S, Hkv, G, dh)
    out_j, lse_j = jfv._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window, chunk)
    _, vjp = jax.vjp(lambda a, b, c: jfv.flash_attention_vjp(a, b, c, window, chunk),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out_t, lse_t = tfv._fwd(tq.detach(), tk.detach(), tv.detach(), window, chunk)
    _close(out_t, out_j)
    _close(lse_t.reshape(B, Hkv, G, S), lse_j)  # the port keeps (B, Hq, S), heads in (Hkv, G) order
    out = tfv.flash_attention_vjp(tq, tk, tv, window, chunk, kernels=False)
    _close(out, out_j)
    for t, j in zip(torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do)), grads_j):
        _close(t, j)


def test_kernel_path_on_the_cpu_is_the_twin():
    """With `kernels=True` a CPU tensor takes the plain twin: the same bits."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 64, 2, 2, 32, seed=5))
    outs = []
    for kernels in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = tfv.flash_attention_vjp(*leaves, 24, 16, kernels=kernels)
        outs.append([out, *torch.autograd.grad(out, leaves, do)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_twin_raises_where_jax_cannot_reshape():
    """S must be a multiple of the chunk, as JAX's reshape into chunks needs."""
    q, k, v, _ = _inputs(1, 100, 1, 2, 16)
    with pytest.raises(TypeError):
        jfv.flash_attention_vjp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 32)
    with pytest.raises(ValueError, match="not a multiple of the attention chunk 32"):
        tfv.flash_attention_vjp(*(torch.from_numpy(a) for a in (q, k, v)), None, 32, kernels=False)


def _jax_norm_grads(kind, x, res, scale, dy, dr):
    """jax.grad of JAX's norm: apply_norm (eps 1e-5), rms_head_norm (eps 1e-6), or the
    fused residual (x + res, then apply_norm; dr is the cotangent of the sum)."""
    if kind == "qk":
        f = lambda a, s: rms_head_norm(s, a)  # noqa: E731
        _, vjp = jax.vjp(f, x, scale)
        return vjp(dy)
    if kind == "plain":
        _, vjp = jax.vjp(lambda a, s: apply_norm({"scale": s}, a), x, scale)
        return vjp(dy)
    _, vjp = jax.vjp(lambda a, b, s: (apply_norm({"scale": s}, a + b), a + b), x, res, scale)
    gx, gres, gs = vjp((dy, dr))
    np.testing.assert_array_equal(np.asarray(gx), np.asarray(gres))
    return gx, gs


@pytest.mark.parametrize("kind,shape", [("plain", (3, 5, 64)), ("fused", (4, 7, 96)),
                                        ("qk", (2, 6, 4, 32))])
def test_rmsnorm_plain_backward_matches_jax_grad(kind, shape):
    rng = np.random.default_rng(7)
    x, res, dy, dr = (rng.standard_normal(shape, dtype=np.float32) for _ in range(4))
    scale = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    gx, gs = _jax_norm_grads(kind, *(jnp.asarray(a) for a in (x, res, scale, dy, dr)))
    eps = 1e-6 if kind == "qk" else 1e-5
    fused = kind == "fused"
    t = {n: torch.from_numpy(a) for n, a in dict(x=x, res=res, scale=scale, dy=dy, dr=dr).items()}
    dx, dscale = rmsnorm_bwd_ref(t["x"], t["res"] if fused else None, t["scale"], t["dy"],
                                 t["dr"] if fused else None, eps=eps)
    _close(dx, gx)
    _close(dscale, gs, tol=TOL * np.abs(np.asarray(gs)).max())
    # the wrappers' CPU path (the plain forward under autograd) agrees too
    xs, ss = t["x"].clone().requires_grad_(), t["scale"].clone().requires_grad_()
    if fused:
        rs = t["res"].clone().requires_grad_()
        y, r = rms_ops.rmsnorm_residual(xs, rs, ss, eps=eps)
        ax, ares, ascale = torch.autograd.grad((y, r), (xs, rs, ss), (t["dy"], t["dr"]))
        assert torch.equal(ax, ares)
    else:
        y = rms_ops.rmsnorm(xs, ss, eps=eps)
        ax, ascale = torch.autograd.grad(y, (xs, ss), t["dy"])
    _close(ax, gx)
    _close(ascale, gs, tol=TOL * np.abs(np.asarray(gs)).max())
