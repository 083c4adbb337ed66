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
