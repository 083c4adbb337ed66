"""Launchers of the CUDA RMSNorm kernels (`csrc/rmsnorm.cu`, `csrc/rmsnorm_residual.cu`).

Replace `repro/kernels/rmsnorm/rmsnorm.py::_rmsnorm_kernel` and
`::_fused_res_kernel`. Both are bound by bytes on the card: one block per
row reduces in float32 and writes the row back, and the fused kernel saves
the extra read of the residual that a separate add and norm would make.

Each launcher takes CUDA tensors only, checks what the kernel takes and
raises on anything else, allocates its outputs with `torch.empty`, launches
on the current stream and counts the launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build


def _check_rows(name: str, x: torch.Tensor, scale: torch.Tensor) -> None:
    if not x.is_cuda or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D CUDA tensor, got {x.shape} on {x.device}")
    if scale.device != x.device or scale.dtype != torch.float32 or scale.shape != (x.shape[1],):
        raise ValueError(f"{name}: scale must be float32 ({x.shape[1]},) on {x.device}")
    if not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be contiguous")


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (T, D) CUDA, float32 or bfloat16; scale: (D,) float32 -> (T, D) in x.dtype."""
    _check_rows("rmsnorm", x, scale)
    code = build.dtype_code(x)
    y = torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.launch_rmsnorm(x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.shape[0],
                                 x.shape[1], eps, code, build.stream_ptr(x.device))
    build.check(lib, err, "rmsnorm")
    build.LAUNCHES["rmsnorm"] += 1
    return y


def rmsnorm_residual_fwd(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor, *,
                         eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (y, r): r = x + res, y = rmsnorm(r) * scale; x, res (T, D) of one dtype."""
    _check_rows("rmsnorm_residual", x, scale)
    if res.shape != x.shape or res.dtype != x.dtype or res.device != x.device:
        raise ValueError("rmsnorm_residual: res must match x in shape, dtype and device")
    if not res.is_contiguous():
        raise ValueError("rmsnorm_residual: res must be contiguous")
    code = build.dtype_code(x)
    y, r = torch.empty_like(x), torch.empty_like(x)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.launch_rmsnorm_residual(x.data_ptr(), res.data_ptr(), scale.data_ptr(),
                                          y.data_ptr(), r.data_ptr(), x.shape[0], x.shape[1],
                                          eps, code, build.stream_ptr(x.device))
    build.check(lib, err, "rmsnorm_residual")
    build.LAUNCHES["rmsnorm_residual"] += 1
    return y, r
