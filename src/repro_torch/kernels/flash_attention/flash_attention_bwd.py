"""Launcher of the CUDA flash-attention backward (`csrc/flash_attention_bwd.cu`).

Not a port of a TPU kernel: JAX computes this backward in jnp
(`repro/models/flash_vjp.py::_bwd_rule`). From what the forward saved (q, k,
v, out and the float32 log-sum-exp of each query row) and dout, it writes dq,
dk and dv: three launches on the current stream (delta = rowsum(dout * out),
then dk and dv by key tile, then dq by query tile), deterministic, no
atomics. Bound by operations on the card; this first version runs on fp32
FMAs. Every tensor is read and written through its strides (unit stride in
head_dim), so the model's (B, S, H, dh) views go in place.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS


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
    if lse.dtype != torch.float32 or lse.shape != (B, Hq, S) or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous float32 {(B, Hq, S)}")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention_bwd: window must be positive, got {window}")
    strides = (ctypes.c_longlong * 24)(*(s for t in tensors for s in t.stride()[:3]))
    delta = torch.empty_like(lse)
    code = build.dtype_code(q)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.launch_flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq, dk, dv)),
            B, Hq, Hkv, S, dh, strides, window or 0, dh**-0.5 if scale is None else scale, code,
            build.stream_ptr(q.device))
    build.check(lib, err, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
