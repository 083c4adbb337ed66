"""Plain PyTorch version of flash-decode (masked GQA attention over a cache)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, n_valid: int, *, scale: float | None = None, lse: bool = False):
    """q: (B, Hkv, G, dh); k/v: (B, Hkv, T, dh); slots >= n_valid are masked. With
    `lse`, also the log-sum-exp of the scaled scores, (B, Hkv, G) float32.

    Slots at or past n_valid are never read, as the kernel reads none: they may
    hold anything, NaN included (a masked slot's weight is 0, and 0 x NaN is NaN),
    as the cache of a decode resumed from a handed-off prefix does."""
    if 0 < n_valid < k.shape[2]:
        k, v = k[:, :, :n_valid], v[:, :, :n_valid]
    dh = q.shape[-1]
    scale = dh**-0.5 if scale is None else scale
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) * scale
    valid = torch.arange(k.shape[2], device=q.device) < n_valid
    s = torch.where(valid, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p.to(v.dtype), v)
    return (out, torch.logsumexp(s, dim=-1)) if lse else out
