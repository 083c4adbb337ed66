"""Hierarchical roofline timing for GEMM / GEMV / element-wise ops (§3.1).

Per DeepFlow, a kernel's time is the max over hierarchy levels of
(traffic at that level) / (achievable bandwidth), together with the pure
compute term. Traffic at the off-chip level follows a cache-blocking model:
operands stream once if the working set fits L2/VMEM, otherwise classic tiled
traffic with square tiles sized to half the near memory.

Bound types match the paper's Table 4 classification: "compute" when the
compute term dominates, "memory" (DRAM/HBM) or "l2" otherwise.

A copy of `repro.core.roofline` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.hardware import HardwareSpec


@dataclass(frozen=True)
class GEMM:
    """batch x (m, k) @ (k, n). Weights treated as the (k, n) operand."""

    name: str
    m: int
    n: int
    k: int
    batch: int = 1
    bytes_in: int = 2  # operand precision
    bytes_out: int = 2
    weight_reuse: bool = True  # weights resident across the batch dim

    @property
    def flops(self) -> float:
        return 2.0 * self.batch * self.m * self.n * self.k


@dataclass(frozen=True)
class MemOp:
    """Bandwidth-bound op (norm, softmax, residual, dropout, cache update)."""

    name: str
    bytes: float
    flops: float = 0.0


@dataclass(frozen=True)
class OpTime:
    name: str
    t: float
    bound: str  # compute | memory | l2
    flops: float
    dram_bytes: float
    l2_bytes: float
    t_compute: float = 0.0
    t_dram: float = 0.0
    t_l2: float = 0.0


def gemm_dram_traffic(g: GEMM, l2_capacity: float) -> float:
    """Off-chip bytes for one batched GEMM under L2 cache blocking."""
    bi, bo = g.bytes_in, g.bytes_out
    a_bytes = g.m * g.k * bi
    b_bytes = g.k * g.n * bi
    c_bytes = g.m * g.n * bo
    per_batch_ws = a_bytes + b_bytes + c_bytes
    if per_batch_ws <= l2_capacity * 0.5:
        # streams once; weights shared across batch when flagged
        if g.weight_reuse and g.batch > 1:
            return g.batch * (a_bytes + c_bytes) + b_bytes
        return g.batch * per_batch_ws
    # tiled: square tiles of T x T sized to half of L2 (A-tile + B-tile)
    T = max(64, int(math.sqrt(l2_capacity * 0.5 / (2 * bi))))
    n_tiles_n = math.ceil(g.n / T)
    n_tiles_m = math.ceil(g.m / T)
    traffic = g.m * g.k * bi * n_tiles_n + g.k * g.n * bi * n_tiles_m + g.m * g.n * bo
    return g.batch * traffic


def gemm_l2_traffic(g: GEMM, mxu_tile: int = 128) -> float:
    """On-chip (L2/VMEM -> compute) bytes under a fixed MXU/tensor-core tile."""
    bi, bo = g.bytes_in, g.bytes_out
    reads = g.m * g.k * bi * math.ceil(g.n / mxu_tile) + g.k * g.n * bi * math.ceil(
        g.m / mxu_tile
    )
    return g.batch * (reads + g.m * g.n * bo)


def _dtype_key(bytes_in: int) -> str:
    return {1: "fp8", 2: "bf16", 4: "fp32"}.get(bytes_in, "bf16")


def gemm_time(hw: HardwareSpec, g: GEMM) -> OpTime:
    dt = _dtype_key(g.bytes_in)
    peak = hw.flops.get(dt) or hw.flops["bf16"]
    # skinny GEMMs don't reach fat-GEMM efficiency; ramp with the small dim
    small = min(g.m, g.n)
    eff = hw.compute_util * min(1.0, small / 128.0)
    t_compute = g.flops / (peak * max(eff, 1e-3))

    dram_b = gemm_dram_traffic(g, hw.l2.capacity)
    l2_b = gemm_l2_traffic(g)
    # memory utilization: fat GEMMs stream well; skinny ones follow the paper's
    # calibrated constant GEMV utilization factor (§4.1)
    dram_util = hw.dram.util if small >= 128 else hw.gemv_dram_util
    t_dram = dram_b / (hw.dram.bw * dram_util)
    t_l2 = l2_b / (hw.l2.bw * hw.l2.util)

    t = max(t_compute, t_dram, t_l2)
    bound = {t_compute: "compute", t_dram: "memory", t_l2: "l2"}[t]
    return OpTime(g.name, t, bound, g.flops, dram_b, l2_b, t_compute, t_dram, t_l2)


def memop_time(hw: HardwareSpec, op: MemOp) -> OpTime:
    t_dram = op.bytes / (hw.dram.bw * hw.dram.util)
    t_l2 = op.bytes / (hw.l2.bw * hw.l2.util)
    peak = hw.flops.get("fp32", hw.flops["bf16"] / 16)
    t_c = op.flops / peak if op.flops else 0.0
    t = max(t_dram, t_l2, t_c)
    bound = "memory" if t == t_dram else ("l2" if t == t_l2 else "compute")
    return OpTime(op.name, t, bound, op.flops, op.bytes, op.bytes, t_c, t_dram, t_l2)


def op_time(hw: HardwareSpec, op) -> OpTime:
    if isinstance(op, GEMM):
        return gemm_time(hw, op)
    if isinstance(op, MemOp):
        return memop_time(hw, op)
    raise TypeError(op)


def total_time(hw: HardwareSpec, ops) -> tuple[float, list[OpTime]]:
    times = [op_time(hw, op) for op in ops]
    return sum(t.t for t in times), times
