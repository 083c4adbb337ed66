"""Launcher of the CUDA RMSNorm backward (`csrc/rmsnorm_bwd.cu`).

Not a port of a TPU kernel: JAX differentiates its norms by autodiff. One
kernel serves the plain norm and the fused residual-add norm: from the rows
x (and res, whose float32 sum with x the fused forward normalised), the
gains, dy (and the cotangent dr of the fused norm's second output) it writes
dx and dscale. dscale is summed per block in shared memory and the blocks'
partial sums added by a second launch: no atomics, the same bits every run.
Bound by bytes on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

THREADS = 256
MAX_BLOCKS = 528  # 4 blocks of 256 threads on each of the H100's 132 SMs
MAX_D = 12288  # the block's dscale sums, d floats, fit 48 KB of shared memory


class Plan(NamedTuple):
    lanes: int  # threads of a row: a warp (d <= 1024) or the block
    blocks: int


def launch_plan(rows: int, d: int) -> Plan:
    if d > MAX_D:
        raise ValueError(f"rmsnorm_bwd: rows of {d} elements are wider than the kernel takes")
    lanes = 32 if d <= 1024 else THREADS
    return Plan(lanes, max(1, min(MAX_BLOCKS, -(-rows // (THREADS // lanes)))))


def rmsnorm_bwd(x: torch.Tensor, res: torch.Tensor | None, scale: torch.Tensor, dy: torch.Tensor,
                dr: torch.Tensor | None = None, *, eps: float = 1e-5):
    """(dx, dscale): x, res, dy, dr (T, D) contiguous CUDA rows of one dtype, res and dr
    optional; scale (D,) float32. dx in x's dtype, dscale float32."""
    rows, d = x.shape
    for name, t in (("x", x), ("res", res), ("dy", dy), ("dr", dr)):
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device or t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"rmsnorm_bwd: {name} must be a CUDA {tuple(x.shape)} {x.dtype} tensor")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm_bwd: {name} must be contiguous")
    if scale.device != x.device or scale.dtype != torch.float32 or scale.shape != (d,) or \
            not scale.is_contiguous():
        raise ValueError(f"rmsnorm_bwd: scale must be contiguous float32 ({d},) on {x.device}")
    plan = launch_plan(rows, d)
    code = build.dtype_code(x)
    dx = torch.empty_like(x)
    partial = torch.empty((plan.blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.launch_rmsnorm_bwd(x.data_ptr(), ptr(res), scale.data_ptr(), dy.data_ptr(),
                                     ptr(dr), dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
                                     rows, d, eps, code, plan.lanes, plan.blocks,
                                     build.stream_ptr(x.device))
    build.check(lib, err, "rmsnorm_bwd")
    build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale
