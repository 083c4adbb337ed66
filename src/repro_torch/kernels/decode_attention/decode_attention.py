"""Launcher of the CUDA flash-decode kernel (`csrc/decode_attention.cu`).

Replaces `repro/kernels/decode_attention/decode_attention.py::_decode_kernel`.
On the card it is bound by bytes: every valid k and v row is read once for
about G * dh multiply-adds. The kernel reads the cache through its strides,
so the model's (B, T, Hkv, dh) cache is attended in place (a transposed copy
would move both caches every step), and it never touches slots at or past
`n_valid`, which arrives as a host integer rather than a device tensor.
B * Hkv blocks alone would leave most SMs idle at decode batch sizes, so the
valid slots are split into chunks of whole 64-slot tiles, enough for about
two blocks per SM, and a second pass combines the chunks' partial softmaxes.
"""

from __future__ import annotations

import operator

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16
TILE = 64  # slots per shared-memory tile in the kernel (DBK)


def split_slots(n_valid: int, heads: int, sms: int) -> tuple[int, int]:
    """(chunk, n_split): slots per block, a multiple of TILE, and the number of blocks
    per (batch, kv head), aiming at two blocks per SM; every chunk holds a valid slot."""
    tiles = -(-n_valid // TILE)
    want = max(1, -(-2 * sms // heads))
    chunk = -(-tiles // min(want, tiles)) * TILE
    return chunk, -(-n_valid // chunk)


def launch_args(q, k, v, n_valid: int, *, scale: float | None, sms: int = 132) -> tuple:
    """The kernel's non-pointer arguments, after checking every layout rule.

    q: contiguous (B, Hkv, G, dh); k, v: (B, Hkv, T, dh) views of any strides
    whose last stride is 1; `sms` the card's SM count. Returns (B, Hkv, G, T,
    dh, k strides (b, h, t), v strides, n_valid, chunk, n_split, scale).
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("decode_attention: q, k and v must be 4-D")
    B, Hkv, G, dh = q.shape
    T = k.shape[2]
    if k.shape != (B, Hkv, T, dh) or v.shape != k.shape:
        raise ValueError(f"decode_attention: shapes q {q.shape} k {k.shape} v {v.shape}")
    if dh not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"decode_attention: head_dim {dh} not in {HEAD_DIMS} or G={G} not in 1..{MAX_GROUP}")
    if not q.is_contiguous() or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("decode_attention: q must be contiguous and k, v unit-stride in head_dim")
    if isinstance(n_valid, torch.Tensor):
        raise TypeError("decode_attention: n_valid must be a host int, not a tensor")
    n_valid = operator.index(n_valid)
    if not 1 <= n_valid <= T:  # with no valid slot the plain softmax and the kernel disagree
        raise ValueError(f"decode_attention: n_valid must be a host int in [1, {T}], got {n_valid!r}")
    scale = dh**-0.5 if scale is None else scale
    chunk, n_split = split_slots(n_valid, B * Hkv, sms)
    return (B, Hkv, G, T, dh, *k.stride()[:3], *v.stride()[:3], n_valid, chunk, n_split, scale)


def flash_decode(q, k, v, n_valid: int, *, scale: float | None = None) -> torch.Tensor:
    """One-token attention of CUDA q over the cache (k, v) -> (B, Hkv, G, dh)."""
    if not all(t.is_cuda and t.device == q.device for t in (k, v)) or not q.is_cuda:
        raise ValueError("decode_attention: q, k and v must be on one CUDA device")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    args = launch_args(q, k, v, n_valid, scale=scale, sms=sms)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("decode_attention: q, k and v must share one dtype")
    code = build.dtype_code(q)
    B, Hkv, G, dh = q.shape
    n_split = args[13]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # per (batch, kv head, chunk, query head): acc[dh], m, l
    part = torch.empty((B, Hkv, n_split, G, dh + 2), dtype=torch.float32, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.launch_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), part.data_ptr(), *args, code,
                                          build.stream_ptr(q.device))
    build.check(lib, err, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    return out
