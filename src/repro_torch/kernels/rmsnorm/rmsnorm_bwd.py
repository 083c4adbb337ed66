"""Launcher of the CUDA RMSNorm backward (`csrc/rmsnorm_bwd.cu`).

Not a port of a TPU kernel: JAX differentiates its norms by autodiff. One
kernel serves the plain norm and the fused residual-add norm: from the rows
x (and res, whose float32 sum with x the fused forward normalised), the
gains, dy (and the cotangent dr of the fused norm's second output) it writes
dx and dscale. Bound by bytes on the card, so it reads each row once, in
16-byte loads held in registers through both row sums and the write of dx,
with a launch plan sized to the row (`launch_plan`), as the forward
(`rmsnorm.py`). dscale is summed per thread in registers and per block in
shared memory, and the blocks' partial sums are added by a second launch:
no atomics, the same bits every run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.rmsnorm import GROUP_BLOCK, _pow2_at_least

MAX_THREADS = 512  # threads of a block (`rmsbwd::MAX_THREADS`): at most 128 registers a thread
ROW_THREADS = 192  # a row takes the fewest loads a thread that keep it to this many threads
RESIDENT_THREADS = 512  # threads an SM keeps at 128 registers: the blocks fill the card once
H100_SMS = 132


def max_elems(fused: bool) -> int:
    """Elements of each row tensor a thread holds (`rmsbwd::max_elems`): what 128
    registers hold beside the dscale sums, for x and dy, or x, res and dy."""
    return 16 if fused else 32


class Plan(NamedTuple):
    """How `csrc/rmsnorm_bwd.cu` covers a (rows, d) matrix: thread `t` of block
    `b` serves, in turn k, row `(k * blocks + b) * rows_per_block + t // lanes`
    and, for j < vecs_per_thread, its load `t % lanes + j * lanes` (elements
    `vec` times that, `vec` of them) where that load lies in the row."""

    vec: int  # elements per load: 16 bytes' worth, or 1 on the scalar path
    lanes: int  # threads of one row: a power of two up to 32, or whole warps
    rows_per_block: int
    vecs_per_thread: int  # loads of each of x, res, dy a thread keeps in registers
    blocks: int  # each writes one row of float32 partial dscale sums


def launch_plan(rows: int, d: int, elem_size: int, aligned: bool, fused: bool = False,
                sms: int = H100_SMS) -> Plan:
    """The kernel's launch for `rows` rows of `d` elements of `elem_size` bytes,
    of the plain norm or the `fused` one (which also holds res).

    16-byte loads need `aligned` (every row tensor and the gains on 16-byte
    boundaries) and d a multiple of the vector; otherwise the scalar path
    loads one element at a time. A thread keeps at most `max_elems(fused)`
    elements of a row tensor. Rows that 32 threads cover share a 256-thread
    block, a power-of-two group of lanes each; wider rows take whole warps,
    with the fewest loads a thread that keep a row to `ROW_THREADS` threads,
    two or more rows to a block where a row takes 128 threads or fewer.
    `blocks` fills `sms` multiprocessors with `RESIDENT_THREADS` threads
    each, or covers the rows in one turn if that takes fewer.
    """
    vec = 16 // elem_size
    if not aligned or d % vec:
        vec = 1
    nvec, max_vpt = d // vec, max_elems(fused) // vec
    if nvec <= 32 * max_vpt:
        lanes = min(32, _pow2_at_least(nvec))
        vpt = _pow2_at_least(-(-nvec // lanes))
    else:
        vpts = [v for v in (1, 2, 4, 8, 16, 32) if v <= max_vpt]
        vpt = next((v for v in vpts if -(-nvec // v) <= ROW_THREADS), max_vpt)
        lanes = 32 * -(-nvec // (32 * vpt))
        if lanes > MAX_THREADS:
            raise ValueError(f"rmsnorm_bwd: rows of {d} elements are wider than the kernel takes")
    rpb = max(1, GROUP_BLOCK // lanes)
    per_sm = max(1, RESIDENT_THREADS // (lanes * rpb))
    return Plan(vec, lanes, rpb, vpt, max(1, min(-(-rows // rpb), sms * per_sm)))


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
    code = build.dtype_code(x)
    dx = torch.empty_like(x)
    rows_in = [t for t in (x, res, dy, dr, dx) if t is not None]
    plan = launch_plan(rows, d, x.element_size(),
                       all(t.data_ptr() % 16 == 0 for t in (*rows_in, scale)), res is not None,
                       torch.cuda.get_device_properties(x.device).multi_processor_count)
    partial = torch.empty((plan.blocks, d), dtype=torch.float32, device=x.device)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.launch_rmsnorm_bwd(x.data_ptr(), ptr(res), scale.data_ptr(), dy.data_ptr(),
                                     ptr(dr), dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(),
                                     rows, d, eps, code, *plan, build.stream_ptr(x.device))
    build.check(lib, err, "rmsnorm_bwd")
    build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale
