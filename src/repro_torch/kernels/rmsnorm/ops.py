"""Public RMSNorm wrappers (rank-agnostic).

A CUDA tensor goes to the CUDA kernel, which launches or raises; a CPU
tensor goes to the plain version in `ref.py`. Nothing falls back. The TPU
wrapper padded rows to its 256-row block; a kernel with one block per row
needs no padding.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_fwd, rmsnorm_residual_fwd


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps=eps)
    return rmsnorm_fwd(x.reshape(-1, x.shape[-1]), scale, eps=eps).view(x.shape)


def rmsnorm_residual(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, *,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    if not x.is_cuda:
        return rmsnorm_residual_ref(x, res, scale, eps=eps)
    d = x.shape[-1]
    y, r = rmsnorm_residual_fwd(x.reshape(-1, d), res.reshape(-1, d), scale, eps=eps)
    return y.view(x.shape), r.view(x.shape)
