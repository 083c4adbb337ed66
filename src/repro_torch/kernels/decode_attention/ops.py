"""Public flash-decode wrapper.

A CUDA tensor goes to the CUDA kernel, which launches or raises; a CPU
tensor goes to the plain version in `ref.py`. The TPU wrapper padded the
cache to its 512-slot block; the kernel masks the ragged end instead. The
kernel has no backward (decoding is never differentiated), so on CUDA the
wrapper refuses inputs that require grad rather than drop their gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.decode_attention import flash_decode
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention(q, k, v, n_valid: int, *, scale: float | None = None, lse: bool = False):
    """q: (B, Hkv, G, dh); k/v: (B, Hkv, T, dh), any strides; n_valid: host int;
    scale dh**-0.5 unless given. With `lse`, (out, the log-sum-exp of the scaled
    scores (B, Hkv, G) float32), which the kernel writes in its own combine."""
    if not q.is_cuda:
        return decode_attention_ref(q, k, v, n_valid, scale=scale, lse=lse)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention has no backward: it would drop the gradient")
    return flash_decode(q, k, v, n_valid, scale=scale, lse=lse)


def decode_attention_cache(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           n_valid: int, *, lse: bool = False):
    """Model layout: q (B, 1, Hkv, G, dh); caches (B, T, Hkv, dh) -> (B, 1, Hkv, G, dh),
    with `lse` and the log-sum-exp (B, 1, Hkv, G)."""
    B, _, Hkv, G, dh = q.shape
    out = decode_attention(q.reshape(B, Hkv, G, dh), k_cache.transpose(1, 2),
                           v_cache.transpose(1, 2), n_valid, lse=lse)
    if lse:
        return out[0].view(B, 1, Hkv, G, dh), out[1].view(B, 1, Hkv, G)
    return out.view(B, 1, Hkv, G, dh)
