"""Hardware descriptions — the paper's "architecture abstraction layer" (§3.1).

Instead of DeepFlow's low-level technology parameters (area/cell, energy/flip),
each system is described by the high-level performance factors the paper's
abstraction layer extracts: peak compute per dtype, a memory-level hierarchy
(capacity + bandwidth + default utilization), and a network hierarchy
(per-device algorithm bandwidth + latency + group size). This is exactly the
path the paper advocates for modeling commercial hardware whose process details
are not public.

GPU numbers follow the paper's text (§4.3, §5.2, §6.2). The registry is the
analytical model's table of specifications, not a measurement.

A copy of `repro.core.hardware` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class MemLevel:
    name: str
    capacity: float  # bytes
    bw: float  # bytes/s
    util: float = 0.8  # default achievable fraction (paper's utilization factor)


@dataclass(frozen=True)
class NetLevel:
    name: str
    bw: float  # bytes/s per device (algorithm bandwidth, one direction)
    latency: float  # seconds per hop
    size: int  # devices inside this level (e.g. 8 per NVLink node)
    util: float = 0.85


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops: dict  # dtype -> peak FLOP/s (dense)
    mem: tuple  # (off-chip DRAM/HBM, on-chip L2/VMEM) — ordered far -> near
    net: tuple  # (intra-node, inter-node)
    compute_util: float = 0.55  # fat-GEMM MXU/tensor-core efficiency
    gemv_dram_util: float = 0.7  # paper §4.1: constant DRAM util factor for GEMVs

    @property
    def dram(self) -> MemLevel:
        return self.mem[0]

    @property
    def l2(self) -> MemLevel:
        return self.mem[1]

    def with_dram(self, name: str, bw: float, capacity: float | None = None):
        d = self.mem[0]
        new = MemLevel(name, capacity or d.capacity, bw, d.util)
        return replace(self, name=f"{self.name}+{name}", mem=(new, *self.mem[1:]))

    def with_net(self, intra: "NetLevel | None" = None, inter: "NetLevel | None" = None):
        return replace(self, net=(intra or self.net[0], inter or self.net[1]))


GB = 1e9
TB = 1e12
MB = 1e6

# ------------------------------------------------------------------- networks
# NVLink latencies are *collective-op* effective latencies (NCCL small-
# message all-reduce ~20-60us at 8 GPUs), not wire latencies — calibrated
# against Table 2 (the paper makes the same adjustment via eq. 4).
NVLINK3 = NetLevel("NVLink3", 300 * GB, 10e-6, 8)
NVLINK4 = NetLevel("NVLink4", 450 * GB, 8e-6, 8)
NVLINK5 = NetLevel("NVLink5", 900 * GB, 7e-6, 8)
HDR_IB = NetLevel("HDR-IB", 25 * GB, 5e-6, 10_000)  # 200 GB/s per 8-GPU node
NDR_IB = NetLevel("NDR-IB", 50 * GB, 5e-6, 10_000)  # 400 GB/s per 8-GPU node
NVS_NET = NetLevel("NVLinkSwitch", 450 * GB, 3e-6, 10_000)  # NVS system (H100/B200)
NVS5_NET = NetLevel("NVLinkSwitch5", 900 * GB, 3e-6, 10_000)

# DSE inter-node options (§5.3: per x8 node)
NDR_X8 = NetLevel("NDR-x8", 100 * GB / 8, 5e-6, 10_000)
XDR_X8 = NetLevel("XDR-x8", 200 * GB / 8, 5e-6, 10_000)
GDR_X8 = NetLevel("GDR-x8", 400 * GB / 8, 5e-6, 10_000)

# the two levels of a TPU pod: its torus, and the network across pods
ICI_V5E = NetLevel("ICI", 50 * GB, 1e-6, 256, util=0.9)
DCN = NetLevel("DCN", 6.25 * GB, 10e-6, 10_000, util=0.8)

# --------------------------------------------------------------------- chips
A100_80G = HardwareSpec(
    name="A100-80G",
    flops={"fp32": 19.5e12, "tf32": 156e12, "bf16": 312e12, "fp16": 312e12, "int8": 624e12},
    mem=(
        MemLevel("HBM2e", 80e9, 1.935 * TB, util=0.8),
        MemLevel("L2", 40 * MB, 4.8 * TB, util=0.8),
    ),
    net=(NVLINK3, HDR_IB),
    compute_util=0.61,  # calibrated on Table 1 (Megatron 150-177 TF/s/GPU)
    gemv_dram_util=0.72,
)

H100_SXM = HardwareSpec(
    name="H100-SXM",
    flops={"fp32": 67e12, "tf32": 494e12, "bf16": 989e12, "fp16": 989e12, "fp8": 1979e12},
    mem=(
        MemLevel("HBM3", 80e9, 3.35 * TB, util=0.8),
        MemLevel("L2", 50 * MB, 8.0 * TB, util=0.8),
    ),
    net=(NVLINK4, NDR_IB),
    compute_util=0.47,  # H100 tensor-core util on real LLM GEMMs is lower
    gemv_dram_util=0.72,
)

H200 = HardwareSpec(
    name="H200",
    flops=dict(H100_SXM.flops),
    mem=(
        MemLevel("HBM3e", 141e9, 4.8 * TB, util=0.8),
        MemLevel("L2", 50 * MB, 8.0 * TB, util=0.8),
    ),
    net=(NVLINK4, NDR_IB),
    compute_util=0.47,
    gemv_dram_util=0.72,
)

B200 = HardwareSpec(
    name="B200",
    flops={"fp32": 80e12, "bf16": 2250e12, "fp16": 2250e12, "fp8": 4500e12, "fp4": 9000e12},
    mem=(
        MemLevel("HBM3e", 192e9, 8.0 * TB, util=0.8),
        MemLevel("L2", 126 * MB, 16.0 * TB, util=0.8),
    ),
    net=(NVLINK5, NDR_IB),
    compute_util=0.45,
    gemv_dram_util=0.72,
)

TPU_V5E = HardwareSpec(
    name="TPU-v5e",
    flops={"bf16": 197e12, "int8": 394e12, "fp32": 49e12},
    mem=(
        MemLevel("HBM", 16e9, 819e9, util=0.85),
        MemLevel("VMEM", 128 * MB, 11.0 * TB, util=0.85),
    ),
    net=(ICI_V5E, DCN),
    compute_util=0.55,
    gemv_dram_util=0.75,
)

_REGISTRY = {
    "a100": A100_80G,
    "a100-80g": A100_80G,
    "h100": H100_SXM,
    "h100-sxm": H100_SXM,
    "h200": H200,
    "b200": B200,
    "tpu-v5e": TPU_V5E,
    "v5e": TPU_V5E,
}

# DRAM technology scaling table (§5.3, §6.2 / Fig 6, Fig 9)
DRAM_TECH = {
    "GDR6": 600 * GB,
    "HBM2": 1.0 * TB,
    "HBM2E": 1.9 * TB,
    "HBM3": 2.6 * TB,
    "HBM3_inf": 3.35 * TB,  # paper's H100 inference number
    "HBM3E": 4.8 * TB,
    "HBM4": 3.3 * TB,  # paper's projected-HBM4 figure used in Fig 6
    "HBMX": 6.8 * TB,  # futuristic (§6.2)
}


def get_hardware(name: str) -> HardwareSpec:
    return _REGISTRY[name.lower()]
