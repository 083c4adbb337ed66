"""Transformer operator graphs (§3.1-3.2): per-device GEMM/mem-op lists for
train fwd/bwd, prefill (summarization) and decode (generation) phases, under a
Megatron TP/SP mapping.

Conventions (documented for the validation tables):
  * GEMM dims are *per-device* (already divided by TP).
  * Attention score/AV GEMMs are batched GEMMs over (batch x heads / tp).
  * Causal attention counts full S^2 score flops (the Megatron MFU convention;
    the paper's tables follow the same op-graph accounting).
  * Backward = dgrad + wgrad = 2x fwd flops per GEMM; recompute adds fwd work
    per the policy (§3.3).
  * Norm/softmax/dropout/residual are byte-counted MemOps (paper §1.2 —
    memory-bound elementwise class).

A copy of `repro.core.operators` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.roofline import GEMM, MemOp


@dataclass(frozen=True)
class Phase:
    TRAIN_FWD = "train_fwd"
    PREFILL = "prefill"
    DECODE = "decode"


def _gqa_dims(cfg: ModelConfig, tp: int):
    hq = max(cfg.num_heads // tp, 1)
    hkv = max(cfg.num_kv_heads // tp, 1)
    return hq, hkv, cfg.head_dim


def attn_ops(cfg: ModelConfig, B: int, S: int, ctx: int, tp: int, *, decode: bool,
             prec: int = 2) -> list:
    """MHA/GQA block ops. S = query length (1 for decode), ctx = key length."""
    d = cfg.d_model
    hq, hkv, dh = _gqa_dims(cfg, tp)
    if cfg.sliding_window is not None:
        ctx = min(ctx, cfg.sliding_window)
    T = B * S
    ops: list = [
        MemOp("ln1", 2 * T * d * prec + 2 * T * 4),
        GEMM("q_proj", T, hq * dh, d, bytes_in=prec),
        GEMM("kv_proj", T, 2 * hkv * dh, d, bytes_in=prec),
        # scores QK^T: batched skinny/fat GEMM over heads
        GEMM("qk", S, ctx, dh, batch=B * hq, bytes_in=prec, weight_reuse=False),
        MemOp("softmax", 3 * B * hq * S * ctx * prec),
        GEMM("av", S, dh, ctx, batch=B * hq, bytes_in=prec, weight_reuse=False),
        GEMM("o_proj", T, d, hq * dh, bytes_in=prec),
        MemOp("residual1", 3 * T * d * prec),
    ]
    if decode:
        # KV-cache read+append traffic (§3.5): the decode-phase memory tax
        ops.append(MemOp("kv_cache", 2 * B * ctx * hkv * dh * prec))
    return ops


def mlp_ops(cfg: ModelConfig, B: int, S: int, tp: int, *, d_ff: int | None = None,
            prec: int = 2) -> list:
    d = cfg.d_model
    ff = (d_ff or cfg.d_ff) // tp if (d_ff or cfg.d_ff) >= tp else 1
    T = B * S
    ops = [
        MemOp("ln2", 2 * T * d * prec + 2 * T * 4),
        GEMM("mlp_up", T, ff, d, bytes_in=prec),
    ]
    if cfg.gated_mlp:
        ops.append(GEMM("mlp_gate", T, ff, d, bytes_in=prec))
    ops += [
        MemOp("act", 2 * T * ff * prec),
        GEMM("mlp_down", T, d, ff, bytes_in=prec),
        MemOp("residual2", 3 * T * d * prec),
    ]
    return ops


def moe_ops(cfg: ModelConfig, B: int, S: int, tp: int, *, prec: int = 2) -> list:
    """Routed experts (EP over tp) + shared/dense branches (capacity-based)."""
    m = cfg.moe
    d = cfg.d_model
    T = B * S
    e_local = max(m.num_experts // tp, 1)
    cap = int(m.capacity_factor * T * m.top_k / m.num_experts)
    ops: list = [
        GEMM("router", T, m.num_experts, d, bytes_in=4),
        MemOp("dispatch", 2 * T * m.top_k * d * prec / tp),  # gather+scatter traffic
    ]
    n_mm = 3 if cfg.gated_mlp else 2
    ops.append(
        GEMM("experts", cap, m.d_ff * (n_mm - 1), d, batch=e_local, bytes_in=prec)
    )
    ops.append(GEMM("experts_down", cap, d, m.d_ff, batch=e_local, bytes_in=prec))
    if m.num_shared_experts:
        ops += mlp_ops(cfg, B, S, tp, d_ff=m.d_ff * m.num_shared_experts, prec=prec)[1:-1]
    if m.dense_residual:
        ops += mlp_ops(cfg, B, S, tp, d_ff=m.dense_d_ff or m.d_ff, prec=prec)[1:-1]
    return ops


def ssm_ops(cfg: ModelConfig, B: int, S: int, tp: int, *, decode: bool, prec: int = 2,
            chunk: int = 256) -> list:
    """Mamba2 SSD (chunked) or RWKV6 time/channel-mix op graph."""
    s = cfg.ssm
    d = cfg.d_model
    T = B * S
    if s.kind == "mamba2":
        d_inner = s.expand * d // tp
        H = max(d_inner // s.head_dim, 1)
        gn = s.n_groups * s.d_state
        proj = 2 * (s.expand * d) + 2 * gn + (s.expand * d // s.head_dim)
        ops = [
            MemOp("ln", 2 * T * d * prec),
            GEMM("in_proj", T, max(proj // tp, 1), d, bytes_in=prec),
            MemOp("conv", 3 * T * (d_inner + 2 * gn) * prec),
        ]
        if decode:
            ops += [
                MemOp("ssd_state", 2 * B * H * s.d_state * s.head_dim * 4),
                GEMM("ssd_update", 1, s.d_state * s.head_dim, 1, batch=B * H, bytes_in=4,
                     weight_reuse=False),
            ]
        else:
            Q = min(chunk, S)
            nc = max(S // Q, 1)
            ops += [
                GEMM("ssd_scores", Q, Q, s.d_state, batch=B * nc * s.n_groups,
                     bytes_in=prec, weight_reuse=False),
                GEMM("ssd_intra", Q, s.head_dim, Q, batch=B * nc * H, bytes_in=prec,
                     weight_reuse=False),
                GEMM("ssd_states", s.d_state, s.head_dim, Q, batch=B * nc * H,
                     bytes_in=prec, weight_reuse=False),
                GEMM("ssd_inter", Q, s.head_dim, s.d_state, batch=B * nc * H,
                     bytes_in=prec, weight_reuse=False),
            ]
        ops += [
            MemOp("gate_norm", 4 * T * d_inner * prec),
            GEMM("out_proj", T, d, d_inner, bytes_in=prec),
            MemOp("residual", 3 * T * d * prec),
        ]
        return ops
    # rwkv6
    dh = s.head_dim
    H = max(d // dh // tp, 1)
    dt = d // tp
    ops = [
        MemOp("ln1", 2 * T * d * prec),
        GEMM("ddlerp", T, 5 * s.mix_dim, d, bytes_in=prec),
        GEMM("rkvg", T, 4 * dt, d, bytes_in=prec),
        GEMM("decay_lora", T, s.decay_lora, d, bytes_in=prec),
    ]
    if decode:
        ops += [
            MemOp("wkv_state", 2 * B * H * dh * dh * 4),
            GEMM("wkv_update", dh, dh, 1, batch=B * H, bytes_in=4, weight_reuse=False),
        ]
    else:
        Q = 32
        nc = max(S // Q, 1)
        ops += [
            GEMM("wkv_intra", Q, Q * dh, 1, batch=B * nc * H, bytes_in=4,
                 weight_reuse=False),
            GEMM("wkv_out", Q, dh, Q, batch=B * nc * H, bytes_in=4, weight_reuse=False),
            MemOp("wkv_state_stream", B * nc * H * dh * dh * 4),
        ]
    ops += [
        GEMM("wo", T, d, dt, bytes_in=prec),
        MemOp("ln2", 2 * T * d * prec),
        GEMM("cm_k", T, cfg.d_ff // tp, d, bytes_in=prec),
        GEMM("cm_v", T, d, cfg.d_ff // tp, bytes_in=prec),
        GEMM("cm_r", T, dt, d, bytes_in=prec),
        MemOp("residuals", 6 * T * d * prec),
    ]
    return ops


def layer_ops(cfg: ModelConfig, B: int, S: int, ctx: int, tp: int, layer_idx: int, *,
              decode: bool, prec: int = 2) -> list:
    """Ops for one layer (per device)."""
    if cfg.ssm is not None and cfg.family in ("ssm", "hybrid"):
        ops = ssm_ops(cfg, B, S, tp, decode=decode, prec=prec)
        if cfg.family == "hybrid" and cfg.attn_every and layer_idx % cfg.attn_every == 0:
            ops = (
                attn_ops(cfg, B, S, ctx, tp, decode=decode, prec=prec)
                + mlp_ops(cfg, B, S, tp, prec=prec)
                + ops
            )
        return ops
    ops = attn_ops(cfg, B, S, ctx, tp, decode=decode, prec=prec)
    if cfg.moe is not None and layer_idx >= cfg.moe.first_k_dense:
        ops += moe_ops(cfg, B, S, tp, prec=prec)
    elif cfg.moe is not None:
        ops += mlp_ops(cfg, B, S, tp, d_ff=cfg.moe.dense_d_ff or cfg.d_ff, prec=prec)
    else:
        ops += mlp_ops(cfg, B, S, tp, prec=prec)
    return ops


def embedding_head_ops(cfg: ModelConfig, B: int, S: int, tp: int, *, prec: int = 2,
                       with_loss: bool = False) -> list:
    T = B * S
    d = cfg.d_model
    ops = [
        MemOp("embed_gather", T * d * prec),
        MemOp("final_norm", 2 * T * d * prec),
        GEMM("lm_head", T, max(cfg.vocab_size // tp, 1), d, bytes_in=prec),
    ]
    if with_loss:
        ops.append(MemOp("softmax_ce", 3 * T * max(cfg.vocab_size // tp, 1) * 4))
    return ops


def model_flops(cfg: ModelConfig, tokens: int, *, train: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) — §Roofline's 'useful'
    flops. N counts active params excluding embeddings; D = tokens."""
    n = active_param_count(cfg)
    mult = 6.0 if train else 2.0
    return mult * n * tokens


def active_param_count(cfg: ModelConfig) -> float:
    """Active (per-token) non-embedding parameters."""
    d = cfg.d_model
    n = 0.0
    for i in range(cfg.num_layers):
        if cfg.ssm is not None and cfg.family in ("ssm", "hybrid"):
            s = cfg.ssm
            if s.kind == "mamba2":
                d_inner = s.expand * d
                gn = s.n_groups * s.d_state
                n += d * (2 * d_inner + 2 * gn + d_inner // s.head_dim) + d_inner * d
            else:
                n += d * (4 * d + 5 * s.mix_dim + s.decay_lora) + 2 * d * cfg.d_ff + d * d
            if cfg.family == "hybrid" and cfg.attn_every and i % cfg.attn_every == 0:
                n += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
            continue
        n += _attn_params(cfg)
        if cfg.moe is not None and i >= cfg.moe.first_k_dense:
            m = cfg.moe
            n_mm = 3 if cfg.gated_mlp else 2
            n += d * m.num_experts  # router
            n += m.top_k * n_mm * d * m.d_ff  # active routed
            n += m.num_shared_experts * n_mm * d * m.d_ff
            if m.dense_residual:
                n += n_mm * d * (m.dense_d_ff or m.d_ff)
        elif cfg.moe is not None:
            n += _mlp_params(cfg, cfg.moe.dense_d_ff or cfg.d_ff)
        else:
            n += _mlp_params(cfg, cfg.d_ff)
    return n


def total_param_count(cfg: ModelConfig) -> float:
    """All parameters incl. embeddings and all experts."""
    d = cfg.d_model
    n = 2 * cfg.vocab_size * d  # embed + head
    for i in range(cfg.num_layers):
        if cfg.ssm is not None and cfg.family in ("ssm", "hybrid"):
            s = cfg.ssm
            if s.kind == "mamba2":
                d_inner = s.expand * d
                gn = s.n_groups * s.d_state
                n += d * (2 * d_inner + 2 * gn + d_inner // s.head_dim) + d_inner * d
            else:
                n += d * (4 * d + 5 * s.mix_dim + s.decay_lora) + 2 * d * cfg.d_ff + d * d
            if cfg.family == "hybrid" and cfg.attn_every and i % cfg.attn_every == 0:
                n += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
            continue
        n += _attn_params(cfg)
        if cfg.moe is not None and i >= cfg.moe.first_k_dense:
            m = cfg.moe
            n_mm = 3 if cfg.gated_mlp else 2
            n += d * m.num_experts + m.num_experts * n_mm * d * m.d_ff
            n += m.num_shared_experts * n_mm * d * m.d_ff
            if m.dense_residual:
                n += n_mm * d * (m.dense_d_ff or m.d_ff)
        elif cfg.moe is not None:
            n += _mlp_params(cfg, cfg.moe.dense_d_ff or cfg.d_ff)
        else:
            n += _mlp_params(cfg, cfg.d_ff)
    return n


def _attn_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    return d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim + (
        cfg.num_heads * cfg.head_dim * d
    )


def _mlp_params(cfg: ModelConfig, ff: int) -> float:
    return (3 if cfg.gated_mlp else 2) * cfg.d_model * ff
