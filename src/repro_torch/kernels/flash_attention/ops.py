"""Public flash-attention wrappers: the (B, H, S, dh) layout and the model layout.

A CUDA tensor goes to the CUDA kernels, which launch or raise; a CPU tensor
goes to the plain versions in `ref.py`. The model layout is handed to the
kernels as permuted views (strides), so nothing is copied or padded. The
model-layout wrapper is differentiable: on CUDA through `FlashAttentionKernels`
(the forward kernel, which then also writes the LSE, and the backward
kernel), on the CPU through autograd of the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_attention.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref, attention_ref,
                                                     flash_attention_bwd_ref)


def flash_attention_bhsd(q, k, v, *, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, S, dh); k/v: (B, Hkv, S, dh) -> (B, Hq, S, dh), causal; scale dh**-0.5.

    Forward only: on CUDA it refuses inputs that require grad."""
    if not q.is_cuda:
        return attention_ref(q, k, v, window=window, scale=scale)
    _no_grad("flash_attention_bhsd", q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return flash_attention_fwd(q, k, v, out, window=window, scale=scale)


def flash_attention_lse_bhsd(q, k, v, *, window: int | None = None, chunk: int | None = None):
    """(out, lse float32 (B, Hq, S)) of the (B, H, S, dh) layout: the forward kernel
    on CUDA, the blockwise plain version (`chunk`-row blocks) on the CPU."""
    if not q.is_cuda:
        return attention_lse_ref(q, k, v, window=window, chunk=chunk)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return flash_attention_fwd(q, k, v, out, window=window, lse=lse), lse


def flash_attention_bwd_bhsd(q, k, v, out, dout, lse, *, window: int | None = None,
                             chunk: int | None = None):
    """(dq, dk, dv) of the (B, H, S, dh) layout: the backward kernel on CUDA, the
    plain version (`chunk`-row blocks) on the CPU."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window, chunk=chunk)
    grads = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    flash_attention_bwd(q, k, v, out, dout, lse, *grads, window=window)
    return grads


def _no_grad(name: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: it would drop the gradient")


def to_heads(q, k, v):
    """(B, H, S, dh) views of the model layout's q (B, S, Hkv, G, dh), k, v (B, S, Hkv, dh);
    q's heads in (kv head, group) order."""
    B, S, Hkv, G, dh = q.shape
    return q.reshape(B, S, Hkv * G, dh).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


class FlashAttentionKernels(torch.autograd.Function):
    """Causal GQA attention in the model layout through the CUDA kernels.

    The forward writes the float32 LSE only when an input needs a gradient,
    and then saves q, k, v, out and the LSE; the backward kernel recomputes
    the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        B, S, Hkv, G, dh = q.shape
        qh, kh, vh = to_heads(q, k, v)
        out = torch.empty((B, S, Hkv, G, dh), dtype=q.dtype, device=q.device)
        train = any(ctx.needs_input_grad[:3])
        lse = torch.empty((B, Hkv * G, S), dtype=torch.float32, device=q.device) if train else None
        flash_attention_fwd(qh, kh, vh, out.view(B, S, Hkv * G, dh).transpose(1, 2),
                            window=window, lse=lse)
        if train:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        B, S, Hkv, G, dh = q.shape
        dq = torch.empty((B, S, Hkv, G, dh), dtype=q.dtype, device=q.device)
        dk = torch.empty((B, S, Hkv, dh), dtype=k.dtype, device=k.device)
        dv = torch.empty_like(dk)
        flash_attention_bwd(*to_heads(q, k, v), to_heads(out, k, v)[0],
                            to_heads(dout.contiguous(), k, v)[0], lse, *to_heads(dq, dk, dv),
                            window=ctx.window)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, window: int | None = None) -> torch.Tensor:
    """Model layout: q (B, S, Hkv, G, dh); k/v (B, S, Hkv, dh) -> (B, S, Hkv, G, dh)."""
    if q.is_cuda:
        return FlashAttentionKernels.apply(q, k, v, window)
    B, S, Hkv, G, dh = q.shape
    out = attention_ref(*to_heads(q, k, v), window=window)
    return out.transpose(1, 2).reshape(B, S, Hkv, G, dh)
