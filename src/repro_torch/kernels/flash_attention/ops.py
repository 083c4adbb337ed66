"""Public flash-attention wrappers: the (B, H, S, dh) layout and the model layout.

A CUDA tensor goes to the CUDA kernel, which launches or raises; a CPU
tensor goes to the plain version in `ref.py`. The model layout is handed to
the kernel as permuted views (strides), so nothing is copied or padded.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention_bhsd(q, k, v, *, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, S, dh); k/v: (B, Hkv, S, dh) -> (B, Hq, S, dh), causal; scale dh**-0.5."""
    if not q.is_cuda:
        return attention_ref(q, k, v, window=window, scale=scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return flash_attention_fwd(q, k, v, out, window=window, scale=scale)


def flash_attention(q, k, v, *, window: int | None = None) -> torch.Tensor:
    """Model layout: q (B, S, Hkv, G, dh); k/v (B, S, Hkv, dh) -> (B, S, Hkv, G, dh)."""
    B, S, Hkv, G, dh = q.shape
    qh = q.reshape(B, S, Hkv * G, dh).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    if not q.is_cuda:
        out = attention_ref(qh, kh, vh, window=window)
        return out.transpose(1, 2).reshape(B, S, Hkv, G, dh)
    out = torch.empty((B, S, Hkv, G, dh), dtype=q.dtype, device=q.device)
    flash_attention_fwd(qh, kh, vh, out.view(B, S, Hkv * G, dh).transpose(1, 2), window=window)
    return out
