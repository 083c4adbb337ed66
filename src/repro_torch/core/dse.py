"""Design-space exploration (§3.6, §5.3): technology-node scaling + search.

µArch template: a chip of fixed area/power budget split between compute cores
and on-chip SRAM (L2). Logic scaling between consecutive nodes follows the
paper's iso-performance assumption [3, 29]: the same performance costs 1/1.8
the area and 1/1.3 the power — i.e. compute *density* rises 1.8x/node while
power density rises 1.8/1.3 = 1.38x/node (the dark-silicon squeeze). SRAM
density scales slower (1.4x/node — recorded assumption, SRAM scaling has
lagged logic since N7). DRAM technology and inter-node network are discrete
choices (HBM2..HBM4, NDR/XDR/GDR).

The DSE searches the area split f_core (coordinate descent with golden-section
refinement — the paper uses gradient descent; the objective is 1-D smooth here)
to minimize predicted training time. Reproduces Fig 6's saturation beyond N5
(compute-bound -> DRAM-bound) and the HBM2->HBM2E gain vs HBM3/4 network-bound
plateau, and Fig 7's bound-type shift.

A copy of `repro.core.dse` (the port imports nothing of the JAX package);
`tests/test_torch_kvcache_dse.py` holds it to the original bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import (
    DRAM_TECH,
    GDR_X8,
    HardwareSpec,
    MemLevel,
    NDR_X8,
    NVLINK3,
    XDR_X8,
    TB,
)
from repro_torch.core.parallelism import Mapping
from repro_torch.core.predict import train_step_time

NODES = ["N12", "N7", "N5", "N3", "N2", "N1.5", "N1"]
AREA_SCALE = 1.8
POWER_SCALE = 1.3
SRAM_SCALE = 1.4

# calibration anchor: N7 ~ A100 (826 mm^2, 400 W, 312 TF bf16, 40 MB L2)
_ANCHOR_NODE = 1  # N7
_AREA = 826.0  # mm^2
_POWER = 400.0  # W
_CORE_DENSITY_N7 = 312e12 / (_AREA * 0.5)  # FLOP/s per mm^2 at 50% core area
_W_PER_FLOPS_N7 = (_POWER * 0.6) / 312e12  # core W per FLOP/s at N7
_SRAM_DENSITY_N7 = 40e6 / (_AREA * 0.25)  # bytes per mm^2 at 25% L2 area
_L2_BW_PER_BYTE = 4.8 * TB / 40e6  # L2 bandwidth per byte of capacity (A100)

NETS = {"NDR-x8": NDR_X8, "XDR-x8": XDR_X8, "GDR-x8": GDR_X8}


def build_chip(node: str, f_core: float, dram: str, net: str) -> HardwareSpec:
    """Materialize a HardwareSpec from (tech node, area split, DRAM, network)."""
    k = NODES.index(node) - _ANCHOR_NODE
    core_density = _CORE_DENSITY_N7 * AREA_SCALE**k
    w_per_flops = _W_PER_FLOPS_N7 / POWER_SCALE**k
    sram_density = _SRAM_DENSITY_N7 * SRAM_SCALE**k

    f_l2 = max(1.0 - f_core - 0.25, 0.05)  # 25% fixed (PHY/NoC/misc)
    flops_area = _AREA * f_core * core_density
    flops_power = (_POWER * 0.75) / w_per_flops  # 75% of socket power to cores
    flops = min(flops_area, flops_power)

    l2_cap = _AREA * f_l2 * sram_density
    l2_bw = l2_cap * _L2_BW_PER_BYTE * min(1.0, (1.2**k))

    return HardwareSpec(
        name=f"{node}-{dram}-{net}",
        flops={"bf16": flops, "fp16": flops, "fp32": flops / 16},
        mem=(
            MemLevel(dram, 80e9, DRAM_TECH[dram], util=0.8),
            MemLevel("L2", l2_cap, l2_bw, util=0.8),
        ),
        net=(NVLINK3, NETS[net]),
        compute_util=0.61,
        gemv_dram_util=0.72,
    )


@dataclass
class DSEPoint:
    node: str
    dram: str
    net: str
    f_core: float
    time: float
    flops: float
    l2_capacity: float


def optimize_node(cfg: ModelConfig, node: str, dram: str, net: str, *,
                  mapping: Mapping, global_batch: int, seq: int,
                  iters: int = 12) -> DSEPoint:
    """Golden-section search over the core/L2 area split (§3.6's constrained
    optimization; 1-D once the budgets are fixed)."""

    def objective(f_core: float) -> float:
        hw = build_chip(node, f_core, dram, net)
        return train_step_time(cfg, hw, mapping, global_batch=global_batch, seq=seq).total

    lo, hi = 0.15, 0.72
    phi = 0.6180339887498949
    a, b = hi - phi * (hi - lo), lo + phi * (hi - lo)
    fa, fb = objective(a), objective(b)
    for _ in range(iters):
        if fa < fb:
            hi, b, fb = b, a, fa
            a = hi - phi * (hi - lo)
            fa = objective(a)
        else:
            lo, a, fa = a, b, fb
            b = lo + phi * (hi - lo)
            fb = objective(b)
    f = a if fa < fb else b
    t = min(fa, fb)
    hw = build_chip(node, f, dram, net)
    return DSEPoint(node, dram, net, f, t, hw.flops["bf16"], hw.l2.capacity)


def sweep(cfg: ModelConfig, *, mapping: Mapping, global_batch: int, seq: int,
          drams=("HBM2", "HBM2E", "HBM3", "HBM4"),
          nets=("NDR-x8", "XDR-x8", "GDR-x8"), nodes=None) -> list[DSEPoint]:
    out = []
    for node in nodes or NODES:
        for dram in drams:
            for net in nets:
                out.append(
                    optimize_node(cfg, node, dram, net, mapping=mapping,
                                  global_batch=global_batch, seq=seq)
                )
    return out
