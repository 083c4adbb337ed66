"""Launcher of the CUDA flash-attention forward (`csrc/flash_attention.cu`).

Replaces `repro/kernels/flash_attention/flash_attention.py::_fa_kernel`. On
the card it is bound by operations (4 * dh flops per unmasked query-key
pair). The kernel walks only the key blocks that the causal diagonal and the
window leave live, and reads every tensor through its strides, so the
model's (B, S, H, dh) projections are attended in place without transposes
or padding; the ragged end past S is masked inside the kernel.

bf16 at dh 64, 80 and 128 takes the tensor-core kernel, which loads q, k
and v with TMA: each is a 4-D map over (dh, heads, S, B) read in boxes of
`BOX_D` dh columns by `BLOCK_Q` query rows or `BLOCK_K` keys. dh 80 is read
as two boxes, the second zero-filled past column 80. TMA needs
16-byte aligned base addresses and outer strides. float32, and bf16 at
dh 32, take the fp32-tile kernel, which reads elements through the strides.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 80, 128)
TC_HEAD_DIMS = (64, 80, 128)  # bf16 head dims of the tensor-core kernel
BOX_D, BLOCK_Q, BLOCK_K = 64, 128, 64  # its TMA boxes: dh columns, query rows, keys


def on_tensor_cores(dtype: torch.dtype, dh: int) -> bool:
    """Whether calls of this dtype and head dim run the tensor-core kernel."""
    return dtype == torch.bfloat16 and dh in TC_HEAD_DIMS


def launch_args(q, k, v, out, *, scale: float | None, window: int | None) -> tuple:
    """The kernel's non-pointer arguments, after checking every layout rule.

    q, out: (B, Hq, S, dh) and k, v: (B, Hkv, S, dh) views of any strides
    whose last stride is 1. Returns (B, Hq, Hkv, S, dh, q strides (b, h, s),
    k strides, v strides, out strides, TMA boxes (dh columns, query rows,
    keys; zeros off the tensor-core path), window (0 = none), scale).
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or out.dim() != 4:
        raise ValueError("flash_attention: q, k, v and out must be 4-D")
    B, Hq, S, dh = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, dh) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"flash_attention: shapes q {q.shape} k {k.shape} v {v.shape} out {out.shape}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must have unit stride in head_dim")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    boxes = (0, 0, 0)
    if on_tensor_cores(q.dtype, dh):
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
                raise ValueError(f"flash_attention: {name} needs a 16-byte aligned base and outer "
                                 f"strides for TMA, got strides {t.stride()}")
        boxes = (BOX_D, BLOCK_Q, BLOCK_K)
    strides = tuple(s for t in (q, k, v, out) for s in t.stride()[:3])
    scale = dh**-0.5 if scale is None else scale
    return (B, Hq, Hkv, S, dh, *strides, *boxes, window or 0, scale)


def flash_attention_fwd(q, k, v, out, *, scale: float | None = None,
                        window: int | None = None, lse: torch.Tensor | None = None) -> torch.Tensor:
    """Causal GQA attention of CUDA q, k, v into `out` (see `launch_args`).

    With `lse`, a contiguous float32 (B, Hq, S) tensor, the kernel also writes
    each query row's log-sum-exp of its scaled scores there (training); serving
    passes none.
    """
    tensors = (q, k, v, out)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash_attention: q, k, v and out must be on one CUDA device")
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError("flash_attention: q, k, v and out must share one dtype")
    args = launch_args(q, k, v, out, scale=scale, window=window)
    if lse is not None and (lse.dtype != torch.float32 or lse.device != q.device
                            or lse.shape != q.shape[:3] or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be contiguous float32 {tuple(q.shape[:3])} "
                         f"on {q.device}")
    code = build.dtype_code(q)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.launch_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                         None if lse is None else lse.data_ptr(),
                                         *args, code, build.stream_ptr(q.device))
    build.check(lib, err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out
