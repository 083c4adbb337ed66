"""Analytic per-device cost of a production (arch x shape) cell on TPU v5e.

This is the paper's op-graph methodology applied to our own system: exact
per-device FLOPs and modeled HBM traffic for each dry-run cell, used for the
§Roofline compute/memory terms. (XLA's cost_analysis counts loop bodies once —
see core/hlo.py — so the analytic graph is the authoritative source; the raw
HLO numbers are recorded alongside as a cross-check.)

A copy of `repro.core.cellcost` (the port imports nothing of the JAX package)
over the port's `core` copies; `tests/test_torch_cellcost_hlo.py` holds it to the
original field for field. The one change: the hardware is the keyword `hw`,
whose default is the original's TPU v5e, so that a cell can be priced for the
H100 (`H100_SXM`). Flops do not depend on `hw`; DRAM bytes do, through the GEMM
traffic's L2 capacity (`core/roofline.py::gemm_dram_traffic`).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.hardware import TPU_V5E, HardwareSpec
from repro_torch.core.operators import (
    embedding_head_ops,
    layer_ops,
    model_flops,
    total_param_count,
)
from repro_torch.core.roofline import GEMM, op_time


@dataclass(frozen=True)
class CellCost:
    flops_per_device: float
    dram_bytes_per_device: float
    model_flops_global: float
    tokens: int


def cell_cost(cfg: ModelConfig, shape: ShapeSpec, *, dp: int = 16, tp: int = 16,
              prec: int = 2, opt_8bit: bool = False, hw: HardwareSpec = TPU_V5E) -> CellCost:
    kind = shape.kind
    B, S = shape.global_batch, shape.seq_len
    B_dev = max(B // dp, 1)

    def fwd_cost(Bq: int, Sq: int, ctx: int, decode: bool):
        fl = by = 0.0
        for i in range(cfg.num_layers):
            for op in layer_ops(cfg, Bq, Sq, ctx, tp, i, decode=decode, prec=prec):
                t = op_time(hw, op)
                fl += t.flops
                by += t.dram_bytes
        for op in embedding_head_ops(cfg, Bq, 1 if decode else Sq, tp, prec=prec,
                                     with_loss=kind == "train"):
            t = op_time(hw, op)
            fl += t.flops
            by += t.dram_bytes
        return fl, by

    if kind == "train":
        fl, by = fwd_cost(B_dev, S, S, decode=False)
        # fwd + bwd(2x) + selective recompute of attention core (~score GEMMs)
        flops = 3.0 * fl
        bytes_ = 3.0 * by
        hq = max(cfg.num_heads // tp, 1)
        if cfg.family not in ("ssm",):
            for g in (
                GEMM("qk_re", S, S, cfg.head_dim, batch=B_dev * hq, bytes_in=prec,
                     weight_reuse=False),
                GEMM("av_re", S, cfg.head_dim, S, batch=B_dev * hq, bytes_in=prec,
                     weight_reuse=False),
            ):
                t = op_time(hw, g)
                flops += cfg.num_layers * t.flops
                bytes_ += cfg.num_layers * t.dram_bytes
        # optimizer streaming
        P_dev = total_param_count(cfg) / tp
        bytes_ += P_dev * ((2 + 4 + 4.1) if opt_8bit else (2 + 4 + 12)) * 2
        tokens = B * S
        mf = model_flops(cfg, tokens, train=True)
    elif kind == "prefill":
        flops, bytes_ = fwd_cost(B_dev, S, S, decode=False)
        tokens = B * S
        mf = model_flops(cfg, tokens, train=False)
    else:  # decode: one token with ctx = S
        # context-parallel cells (B < dp) shard the KV/ctx dim over data axes
        ctx = S if B >= dp else max(S // dp, 1)
        flops, bytes_ = fwd_cost(B_dev, 1, ctx, decode=True)
        tokens = B
        mf = model_flops(cfg, tokens, train=False)
    return CellCost(flops, bytes_, mf, tokens)
