"""Memory-efficient differentiable causal attention (`repro.models.flash_vjp`).

JAX's custom VJP saves only (q, k, v, out, LSE), O(S * d), and recomputes the
probability blocks in the backward (Dao et al.'s dq/dk/dv recurrences), so a
long training sequence never holds an (S, S) score matrix. Here:

- on CUDA with `kernels=True`, the CUDA forward kernel, which then also
  writes the LSE, and the CUDA backward kernel
  (`kernels/flash_attention/ops.py::FlashAttentionKernels`); any S;
- elsewhere, `FlashAttention`, a plain PyTorch twin of JAX's `_fwd`,
  `_fwd_rule` and `_bwd_rule`, block for block (`ref.py::attention_lse_ref`
  and `flash_attention_bwd_ref`, which are also the plain versions the card
  holds the kernels to). Like JAX's, it needs S to be a multiple of `chunk`
  (JAX reshapes into chunks and does not pad) and raises otherwise.

Layouts as in JAX: q (B, S, Hkv, G, dh); k, v (B, S, Hkv, dh). Causal,
optional window.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_lse_ref, flash_attention_bwd_ref
from repro_torch.parallel.axes import on_shards


def _model(t, shape):
    """(B, Hq, S, dh) back to the model layout (B, S, Hkv, G, dh)."""
    B, S, Hkv, G, dh = shape
    return t.transpose(1, 2).reshape(B, S, Hkv, G, dh)


def _fwd(q, k, v, window, chunk):
    """(out, lse (B, Hq, S) float32), JAX's `_fwd`."""
    out, lse = attention_lse_ref(*fa_ops.to_heads(q, k, v), window=window, chunk=chunk)
    return _model(out, q.shape), lse


def _bwd_rule(window, chunk, res, do):
    """(dq, dk, dv) from the residuals (q, k, v, out, lse), JAX's `_bwd_rule`."""
    q, k, v, out, lse = res
    outh, doh = fa_ops.to_heads(out, k, v)[0], fa_ops.to_heads(do, k, v)[0]
    dq, dk, dv = flash_attention_bwd_ref(*fa_ops.to_heads(q, k, v), outh, doh, lse, window=window,
                                         chunk=chunk)
    return _model(dq, q.shape), dk.transpose(1, 2), dv.transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """The plain twin of JAX's `flash_attention_vjp`: `_fwd_rule` saves (q, k, v,
    out, lse), `_bwd_rule` recomputes the blocks from them."""

    @staticmethod
    def forward(ctx, q, k, v, window, chunk):
        out, lse = _fwd(q, k, v, window, chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.chunk = window, chunk
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _bwd_rule(ctx.window, ctx.chunk, ctx.saved_tensors, do)
        return dq, dk, dv, None, None


def flash_attention_vjp(q, k, v, window: int | None, chunk: int, *,
                        kernels: bool = True) -> torch.Tensor:
    """Differentiable causal attention, (B, S, Hkv, G, dh): the CUDA kernels on a
    CUDA tensor with `kernels`, else the plain twin; on a mesh, either on each
    rank's local heads."""
    if kernels and q.is_cuda:
        return on_shards(lambda *t: fa_ops.FlashAttentionKernels.apply(*t, window), q, k, v)
    return on_shards(lambda *t: FlashAttention.apply(*t, window, chunk), q, k, v)
