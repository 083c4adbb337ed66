"""Public RMSNorm wrappers (rank-agnostic), differentiable.

A CUDA tensor goes through the autograd Functions below, whose forward and
backward are CUDA kernels that launch or raise; a CPU tensor goes to the
plain versions in `ref.py`, which autograd differentiates. Nothing falls
back. The TPU wrapper padded rows to its 256-row block; the CUDA kernels
guard the rows past the end and need no padding.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref, rmsnorm_residual_ref
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_fwd, rmsnorm_residual_fwd
from repro_torch.kernels.rmsnorm.rmsnorm_bwd import rmsnorm_bwd


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1, t.shape[-1])


class RMSNorm(torch.autograd.Function):
    """y = rmsnorm(x) * scale: the forward kernel, and the backward kernel for dx, dscale."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x2 = _rows(x)
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x2, scale, eps=eps).view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x2, None, scale, _rows(dy), eps=ctx.eps)
        return dx.view(dy.shape), dscale, None


class RMSNormResidual(torch.autograd.Function):
    """(y, r) = (rmsnorm(x + res) * scale, x + res): the fused forward kernel; the
    backward kernel gives x and res one gradient, the norm's plus r's."""

    @staticmethod
    def forward(ctx, x, res, scale, eps):
        x2, res2 = _rows(x), _rows(res)
        ctx.save_for_backward(x2, res2, scale)
        ctx.eps = eps
        y, r = rmsnorm_residual_fwd(x2, res2, scale, eps=eps)
        return y.view(x.shape), r.view(x.shape)

    @staticmethod
    def backward(ctx, dy, dr):
        x2, res2, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x2, res2, scale, _rows(dy), _rows(dr), eps=ctx.eps)
        dx = dx.view(dy.shape)
        return dx, dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    if not x.is_cuda:
        return rmsnorm_ref(x, scale, eps=eps)
    return RMSNorm.apply(x, scale, eps)


def rmsnorm_residual(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, *,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    if not x.is_cuda:
        return rmsnorm_residual_ref(x, res, scale, eps=eps)
    return RMSNormResidual.apply(x, res, scale, eps)


def rmsnorm_backward(x, res, scale, dy, dr=None, *, eps: float = 1e-5):
    """(dx, dscale) of the plain (res None) or fused norm over (T, D) rows: the
    backward kernel on CUDA, its plain version on the CPU."""
    if not x.is_cuda:
        return rmsnorm_bwd_ref(x, res, scale, dy, dr, eps=eps)
    return rmsnorm_bwd(x, res, scale, dy, dr, eps=eps)
