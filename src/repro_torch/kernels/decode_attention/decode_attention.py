"""Launcher of the CUDA flash-decode kernel (`csrc/decode_attention.cu`).

Replaces `repro/kernels/decode_attention/decode_attention.py::_decode_kernel`.
On the card it is bound by bytes: every valid k and v row is read once for
about G * dh multiply-adds. The kernel reads the model's (B, T, Hkv, dh)
cache in place (a transposed copy would move both caches every step), and it
never reads slots at or past `n_valid`, which arrives as a host integer
rather than a device tensor.

B * Hkv CTAs alone would leave most SMs idle at decode batch sizes, so the
valid 64-slot tiles of each (batch, kv head) are spread over the CTAs of one
thread block cluster, and the CTAs combine their partial softmaxes through
distributed shared memory in the same launch. `launch_plan` makes the whole
plan (split, tiles per CTA, TMA ring, shared memory, boxes, grid); the C
launcher refuses any other, and the CPU tests replay it. The split is the
one whose longest CTA has the fewest tiles once the clusters that do not fit
the card at once are counted as further waves; on the card, how many fit is
asked of the CUDA runtime (`cudaOccupancyMaxActiveClusters`), since clusters
must sit within one GPC and so pack less densely than single CTAs.

bf16 at dh 64, 80 and 128 takes the tensor-core kernel, which loads K and V
with TMA through 4-D maps over (dh, Hkv, slots, B) whose slot extent is
n_valid; dh 80 is read as two boxes, the second zero-filled past column 80,
so its ring stages are sized for 128 columns (`tile_cols`). TMA needs
16-byte aligned base addresses and outer strides. float32, and
bf16 at dh 32, take the fp32-tile kernel, which reads through the strides.
"""

from __future__ import annotations

import functools
import operator
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 80, 128)
TC_HEAD_DIMS = (64, 80, 128)  # bf16 head dims of the tensor-core kernel
MAX_GROUP = 16
TILE = 64  # cache slots of a tile (the TMA box's rows)
BOX_D = 64  # dh columns of a TMA box: one 128-byte swizzle row
MAX_CLUSTER = 8  # CTAs per (batch, kv head): the portable cluster size
RING_BYTES = 96 * 1024  # a CTA's ring: two CTAs share an SM's 228 KB
SM_SMEM = 228 * 1024  # shared memory of an SM, of which the runtime reserves 1 KB a CTA


def on_tensor_cores(dtype: torch.dtype, dh: int) -> bool:
    """Whether calls of this dtype and head dim run the tensor-core kernel."""
    return dtype == torch.bfloat16 and dh in TC_HEAD_DIMS


def tile_cols(dh: int) -> int:
    """Columns of the tensor-core kernel's K and V tiles for head dim `dh`: whole boxes."""
    return -(-dh // BOX_D) * BOX_D


def slice_cols(dh: int, n_split: int) -> int:
    """dh columns each CTA of a cluster combines and writes: ceil(dh / n_split)
    rounded up to 4 floats, so that a slice moves in 16-byte stores."""
    return -(-(-(-dh // n_split)) // 4) * 4


def recv_floats(dh: int) -> int:
    """A CTA's receive area of the combine: the acc slices [n][G][slice_cols]
    (n * slice_cols < dh + 4 n, so at most 16 x (dh + 32) floats), then m and
    l [8][16]."""
    return MAX_GROUP * (dh + 4 * MAX_CLUSTER) + 2 * MAX_CLUSTER * MAX_GROUP


def cta_smem(max_tiles: int, G: int, dh: int, tensor_cores: bool) -> tuple[int, int]:
    """(ring stages, dynamic shared memory bytes) of a CTA that reads up to `max_tiles` tiles."""
    if tensor_cores:
        stage = 2 * TILE * tile_cols(dh) * 2  # a bf16 K tile and a V tile
        stages = min(max_tiles, RING_BYTES // stage)
        # ring, receive area, one mbarrier a stage, slack to align the ring to 1024
        return stages, stages * stage + 4 * recv_floats(dh) + 8 * stages + 1024
    # receive area, K tile (rows padded by one float), V tile, acc, m, l, q, p, corrections
    return 0, 4 * (recv_floats(dh) + TILE * (dh + 1) + TILE * dh + 2 * G * dh + G * TILE + 3 * G)


def resident_estimate(sms: int) -> Callable[[int, int], int]:
    """Clusters of `n_split` CTAs of `smem` bytes an SM count holds, by shared
    memory alone: the CPU's stand-in for asking the card."""
    return lambda n_split, smem: sms * max(1, SM_SMEM // (smem + 1024)) // n_split


class LaunchPlan(NamedTuple):
    n_split: int  # CTAs per (batch, kv head): the cluster size
    tiles_per_cta: int  # floor(tiles / n_split); the first tiles % n_split CTAs take one more
    stages: int  # TMA ring stages of a CTA (0: the fp32-tile kernel, no ring)
    smem: int  # dynamic shared memory of a CTA, bytes
    box: tuple[int, int]  # TMA box over the cache: (dh columns, slots); (0, 0) without TMA
    slot_extent: int  # slots the kernel may read: n_valid (the maps' extent; TMA zero-fills past it)
    grid: tuple[int, int, int]  # (n_split, Hkv, B); the cluster is (n_split, 1, 1)


@functools.lru_cache(maxsize=4096)  # made 40 times a decode step, on a host-bound path
def launch_plan(n_valid: int, B: int, Hkv: int, G: int, dh: int, *, tensor_cores: bool,
                sms: int = 132, resident: Callable[[int, int], int] | None = None) -> LaunchPlan:
    """The launch of one call. The valid tiles of each (batch, kv head) go to a
    cluster of n_split <= 8 CTAs, none empty; n_split makes the fewest tiles on
    the critical path, its longest CTA's count times the waves its clusters
    take (`resident(n_split, smem)` clusters fit at once), the smallest such
    n_split winning a tie. The ring holds all of a CTA's tiles within its
    budget, so that they are all in flight at once."""
    resident = resident or resident_estimate(sms)
    tiles, heads = -(-n_valid // TILE), max(1, B * Hkv)
    best = None
    for n in range(1, min(MAX_CLUSTER, tiles) + 1):
        per_cta = -(-tiles // n)
        stages, smem = cta_smem(per_cta, G, dh, tensor_cores)
        waves = -(-heads // max(1, resident(n, smem)))
        if best is None or per_cta * waves < best[0]:
            best = (per_cta * waves, n, stages, smem)
    _, n_split, stages, smem = best
    box = (BOX_D, TILE) if tensor_cores else (0, 0)
    return LaunchPlan(n_split, tiles // n_split, stages, smem, box, n_valid, (n_split, Hkv, B))


def cta_tiles(plan: LaunchPlan, n_valid: int) -> list[tuple[int, int]]:
    """(first tile, tile count) of each CTA rank of a cluster, as the kernel reads the plan."""
    extra = -(-n_valid // TILE) - plan.tiles_per_cta * plan.n_split
    return [(r * plan.tiles_per_cta + min(r, extra), plan.tiles_per_cta + (r < extra))
            for r in range(plan.n_split)]


def launch_args(q, k, v, n_valid: int, *, scale: float | None, sms: int = 132,
                resident: Callable[[int, int], int] | None = None) -> tuple:
    """The kernel's non-pointer arguments, after checking every layout rule.

    q: contiguous (B, Hkv, G, dh); k, v: (B, Hkv, T, dh) views of any strides
    whose last stride is 1; `sms` the card's SM count and `resident` its
    cluster residency (see `launch_plan`). Returns (B, Hkv, G, T,
    dh, k strides (b, h, t), v strides, n_valid, n_split, tiles per CTA,
    stages, smem, box dh columns, box slots, slot extent, scale).
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
    tensor_cores = on_tensor_cores(q.dtype, dh)
    if tensor_cores:
        for name, t in (("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
                raise ValueError(f"decode_attention: {name} needs a 16-byte aligned base and outer "
                                 f"strides for TMA, got strides {t.stride()}")
    plan = launch_plan(n_valid, B, Hkv, G, dh, tensor_cores=tensor_cores, sms=sms,
                       resident=resident)
    scale = dh**-0.5 if scale is None else scale
    return (B, Hkv, G, T, dh, *k.stride()[:3], *v.stride()[:3], n_valid, plan.n_split,
            plan.tiles_per_cta, plan.stages, plan.smem, *plan.box, plan.slot_extent, scale)


def flash_decode(q, k, v, n_valid: int, *, scale: float | None = None) -> torch.Tensor:
    """One-token attention of CUDA q over the cache (k, v) -> (B, Hkv, G, dh)."""
    if not all(t.is_cuda and t.device == q.device for t in (k, v)) or not q.is_cuda:
        raise ValueError("decode_attention: q, k and v must be on one CUDA device")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("decode_attention: q, k and v must share one dtype")
    code = build.dtype_code(q)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    args = launch_args(q, k, v, n_valid, scale=scale, sms=sms,
                       resident=_card_resident(dev, code, q.shape[-1]))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        err = lib.launch_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                          out.data_ptr(), *args, code, build.stream_ptr(q.device))
    build.check(lib, err, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    return out


@functools.cache
def _resident(device: int, dtype_code: int, dh: int, n_split: int, smem: int) -> int:
    """Clusters of `n_split` CTAs of the kernel for (dtype, dh), `smem` bytes
    each, that the card holds at once (asked once per card and shape)."""
    lib = build.library()
    with torch.cuda.device(device):
        n = lib.decode_attention_max_active_clusters(dtype_code, dh, n_split, smem)
    if n < 0:
        build.check(lib, -n, "decode_attention_max_active_clusters")
    return n


@functools.cache
def _card_resident(device: int, dtype_code: int, dh: int) -> Callable[[int, int], int]:
    """`resident` for `launch_plan` on a card: one object per (card, dtype, dh),
    so that the plan's cache hits."""
    return functools.partial(_resident, device, dtype_code, dh)


def max_active_clusters(plan: LaunchPlan, dh: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Clusters of the kernel under `plan` that the current card holds at once."""
    code = build.DTYPE_CODES[str(dtype).removeprefix("torch.")]
    return _resident(torch.cuda.current_device(), code, dh, plan.n_split, plan.smem)


def card_plan(n_valid: int, B: int, Hkv: int, G: int, dh: int,
              dtype: torch.dtype = torch.bfloat16) -> LaunchPlan:
    """The plan `flash_decode` makes on the current card for these shapes."""
    code = build.DTYPE_CODES[str(dtype).removeprefix("torch.")]
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return launch_plan(n_valid, B, Hkv, G, dh, sms=sms,
                       tensor_cores=on_tensor_cores(dtype, dh),
                       resident=_card_resident(dev, code, dh))
