"""Plain PyTorch versions of the (fused) RMSNorm kernels: the CPU path and the oracle."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def rmsnorm_residual_ref(x, res, scale, *, eps: float = 1e-5):
    """(y, r): r = x + res in fp32, stored in x.dtype; y from the unrounded r."""
    r = x.float() + res.float()
    y = rmsnorm_ref(r, scale, eps=eps)
    return y.to(x.dtype), r.to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, res: torch.Tensor | None, scale: torch.Tensor,
                    dy: torch.Tensor, dr: torch.Tensor | None = None, *, eps: float = 1e-5):
    """Plain version of the RMSNorm backward: (dx in x's dtype, dscale float32).

    The norm was of r = x (+ res, summed in float32 and not rounded, as the
    fused forward does); dr, the cotangent of the fused norm's second output r,
    is added to dx. In float32: dx = inv * (dy * scale) - r * inv^3 *
    mean(dy * scale * r) + dr, dscale = sum over rows of dy * r * inv.
    """
    r = x.float() if res is None else x.float() + res.float()
    g = dy.float()
    inv = torch.rsqrt(r.square().mean(-1, keepdim=True) + eps)
    gs = g * scale.float()
    dx = inv * gs - r * (inv**3 * (gs * r).mean(-1, keepdim=True))
    if dr is not None:
        dx = dx + dr.float()
    dscale = (g * r * inv).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale
