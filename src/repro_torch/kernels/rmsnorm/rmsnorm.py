"""Launchers of the CUDA RMSNorm kernels (`csrc/rmsnorm.cu`, `csrc/rmsnorm_residual.cu`).

Replace `repro/kernels/rmsnorm/rmsnorm.py::_rmsnorm_kernel` and
`::_fused_res_kernel`. Both are bound by bytes on the card. The norm reads
each row once in 16-byte loads held in registers, with a launch plan sized
to the row (`launch_plan`); the fused kernel (one block per row) saves the
extra read of the residual that a separate add and norm would make.

Each launcher takes CUDA tensors only, checks what the kernel takes and
raises on anything else, allocates its outputs with `torch.empty`, launches
on the current stream and counts the launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

GROUP_VECS = 128  # rows of up to this many loads take a group of <= 32 lanes
GROUP_BLOCK = 256  # threads of a block of such rows
MAX_THREADS = 1024


class Plan(NamedTuple):
    """How `csrc/rmsnorm.cu` covers a (rows, d) matrix: thread `t` of block
    `b` serves row `b * rows_per_block + t // lanes` and, for j < vecs_per_thread,
    its load `t % lanes + j * lanes` (elements `vec` times that, `vec` of them)
    where that load lies in the row."""

    vec: int  # elements per load: 16 bytes' worth, or 1 on the scalar path
    lanes: int  # threads of one row
    rows_per_block: int
    vecs_per_thread: int  # loads each thread keeps in registers
    blocks: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def launch_plan(rows: int, d: int, elem_size: int, aligned: bool) -> Plan:
    """The kernel's launch for `rows` rows of `d` elements of `elem_size` bytes.

    16-byte loads need `aligned` (x and scale on 16-byte boundaries) and d a
    multiple of the vector; otherwise the scalar path loads one element at a
    time. Rows of up to `GROUP_VECS` loads share a block, a power-of-two
    group of lanes each; wider rows take a block of up to 1024 threads with
    4 or 8 loads each.
    """
    vec = 16 // elem_size
    if not aligned or d % vec:
        vec = 1
    nvec = d // vec
    if nvec <= GROUP_VECS:
        lanes = min(32, _pow2_at_least(nvec))
        vpt = _pow2_at_least(-(-nvec // lanes))
        rpb = GROUP_BLOCK // lanes
    else:
        vpt = next((v for v in (4, 8) if -(-nvec // v) <= MAX_THREADS), None)
        if vpt is None:
            raise ValueError(f"rmsnorm: rows of {d} elements are wider than the kernel takes")
        lanes, rpb = 32 * -(-nvec // (32 * vpt)), 1
    return Plan(vec, lanes, rpb, vpt, -(-rows // rpb))


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
    rows, d = x.shape
    plan = launch_plan(rows, d, x.element_size(),
                       x.data_ptr() % 16 == 0 and scale.data_ptr() % 16 == 0)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.launch_rmsnorm(x.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, d, eps, code,
                                 *plan[:4], build.stream_ptr(x.device))
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
