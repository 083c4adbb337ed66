"""Plain PyTorch version of flash attention (dense causal GQA attention)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, scale: float | None = None, window: int | None = None):
    """q: (B, Hq, S, dh); k, v: (B, Hkv, S, dh) -> (B, Hq, S, dh). Causal."""
    B, Hq, S, dh = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = dh**-0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, G, S, dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return out.reshape(B, Hq, S, dh)
