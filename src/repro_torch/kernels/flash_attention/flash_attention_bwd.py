"""Launcher of the CUDA flash-attention backward (`csrc/flash_attention_bwd.cu`).

Not a port of a TPU kernel: JAX computes this backward in jnp
(`repro/models/flash_vjp.py::_bwd_rule`). From what the forward saved (q, k,
v, out and the float32 log-sum-exp of each query row) and dout, it writes dq,
dk and dv: three launches on the current stream (delta = rowsum(dout * out),
then dk and dv by key tile, then dq by query tile), deterministic, no
atomics. Bound by operations on the card. Every tensor is read and written
through its strides (unit stride in head_dim), so the model's (B, S, H, dh)
views go in place.

bf16 at dh 64, 80 and 128 takes the tensor-core kernels, which load q, k, v
and dout with TMA: each is a 4-D map over (dh, heads, S, B) read in boxes of
`BOX_D` dh columns by `BLOCK` rows (dh 80 as two boxes, the second
zero-filled past column 80), and which write dq, dk and dv in 16-byte
stores. TMA and those stores need 16-byte aligned base addresses and outer
strides. float32, and bf16 at dh 32, take the fp32-tile kernels, which read
and write elements through the strides.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import BOX_D, HEAD_DIMS, on_tensor_cores

BLOCK = 64  # rows of every tile: keys of a dk/dv block, queries of a dq block (both routes)
NAMES = ("q", "k", "v", "out", "dout", "dq", "dk", "dv")


class Plan(NamedTuple):
    """The launches after delta's: `dkdv_grid` blocks (key tile, kv head, batch)
    and `dq_grid` blocks (query tile counted from the last, query head, batch),
    and the TMA boxes of the tensor-core route, zeros off it."""

    boxes: tuple[int, int, int]  # (dh columns, query rows, keys) of a box
    dkdv_grid: tuple[int, int, int]
    dq_grid: tuple[int, int, int]


def launch_plan(B: int, Hq: int, Hkv: int, S: int, dh: int, dtype: torch.dtype) -> Plan:
    tiles = -(-S // BLOCK)
    boxes = (BOX_D, BLOCK, BLOCK) if on_tensor_cores(dtype, dh) else (0, 0, 0)
    return Plan(boxes, (tiles, Hkv, B), (tiles, Hq, B))


def launch_args(q, k, v, out, dout, dq, dk, dv, *, scale: float | None, window: int | None) -> tuple:
    """The kernels' non-pointer arguments, after checking every layout rule.

    q, out, dout, dq: (B, Hq, S, dh); k, v, dk, dv: (B, Hkv, S, dh), views of
    any strides whose last stride is 1, one dtype. Returns (B, Hq, Hkv, S,
    dh, the 24 (b, h, s) strides of q, k, v, out, dout, dq, dk, dv, TMA boxes
    (zeros off the tensor-core route), window (0 = none), scale).
    """
    tensors = (q, k, v, out, dout, dq, dk, dv)
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("flash_attention_bwd: q, k, v, out, dout, dq, dk, dv must share one dtype")
    if any(t.dim() != 4 for t in tensors):
        raise ValueError("flash_attention_bwd: the tensors must be 4-D")
    B, Hq, S, dh = q.shape
    Hkv = k.shape[1]
    if any(t.shape != q.shape for t in (out, dout, dq)) or any(
            t.shape != (B, Hkv, S, dh) for t in (k, v, dk, dv)):
        raise ValueError(f"flash_attention_bwd: shapes q {q.shape} k {k.shape}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention_bwd: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {dh} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention_bwd: every tensor needs unit stride in head_dim")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_bwd: window must be positive, got {window}")
    plan = launch_plan(B, Hq, Hkv, S, dh, q.dtype)
    if plan.boxes[0]:
        for name, t in zip(NAMES, tensors):
            misaligned = t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3])
            if name != "out" and misaligned:  # out is read element by element
                raise ValueError(f"flash_attention_bwd: {name} needs a 16-byte aligned base and "
                                 f"outer strides for TMA and 16-byte stores, got strides {t.stride()}")
    strides = tuple(s for t in tensors for s in t.stride()[:3])
    return (B, Hq, Hkv, S, dh, *strides, *plan.boxes, window or 0,
            dh**-0.5 if scale is None else scale)


def flash_attention_bwd(q, k, v, out, dout, lse, dq, dk, dv, *, scale: float | None = None,
                        window: int | None = None) -> None:
    """dq, dk, dv of causal GQA attention, written in place.

    q, out, dout, dq: (B, Hq, S, dh); k, v, dk, dv: (B, Hkv, S, dh), any
    strides with unit stride in head_dim, one dtype (float32 or bfloat16);
    lse: contiguous float32 (B, Hq, S) from `flash_attention_fwd(..., lse=)`.
    """
    tensors = (q, k, v, out, dout, dq, dk, dv)
    if not all(t.is_cuda and t.device == q.device for t in (*tensors, lse)):
        raise ValueError("flash_attention_bwd: every tensor must be on one CUDA device")
    B, Hq, Hkv, S, dh, *rest = launch_args(*tensors, scale=scale, window=window)
    strides, boxes, window_arg, scale_arg = rest[:24], rest[24:27], rest[27], rest[28]
    if lse.dtype != torch.float32 or lse.shape != (B, Hq, S) or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 {(B, Hq, S)}")
    delta = torch.empty_like(lse)
    code = build.dtype_code(q)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.launch_flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq, dk, dv)),
            B, Hq, Hkv, S, dh, (ctypes.c_longlong * 24)(*strides), *boxes, window_arg, scale_arg,
            code, build.stream_ptr(q.device))
    build.check(lib, err, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
