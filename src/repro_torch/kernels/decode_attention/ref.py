"""Plain PyTorch version of flash-decode (masked GQA attention over a cache)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, n_valid: int, *, scale: float | None = None):
    """q: (B, Hkv, G, dh); k/v: (B, Hkv, T, dh); slots >= n_valid are masked."""
    dh = q.shape[-1]
    scale = dh**-0.5 if scale is None else scale
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) * scale
    valid = torch.arange(k.shape[2], device=q.device) < n_valid
    s = torch.where(valid, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bhkd->bhgd", p.to(v.dtype), v)
