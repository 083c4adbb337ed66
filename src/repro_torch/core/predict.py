"""End-to-end performance prediction (the paper's core deliverable).

train_step_time: per-batch training time under a Mapping — per-microbatch
fwd/bwd roofline times + TP collectives (ring, eq. 3) serialized per layer,
pipeline bubble per schedule (§3.2), PP p2p sends, DP gradient all-reduce
(partially overlapped with bwd), recompute overhead (§3.3), optimizer update.

inference_latency: prefill + token-by-token generation with KV cache growth,
TP all-reduces on the latency-optimal double binary tree (eq. 4) — the term
that makes multi-GPU decode scale poorly (§4.3, §6).

A copy of `repro.core.predict` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm as C
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.operators import embedding_head_ops, layer_ops
from repro_torch.core.parallelism import Mapping
from repro_torch.core.roofline import GEMM, op_time, total_time


@dataclass
class Breakdown:
    parts: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)  # inference: {"gen", "prompt", "batch"}

    @property
    def total(self) -> float:
        return sum(self.parts.values())

    @property
    def ttft(self) -> float:
        """Time-to-first-token: the prefill-side terms. This is the SLO
        definition shared with `repro.sim` and the serving benchmarks
        (0 for training breakdowns, which have no prefill terms)."""
        return sum(v for k, v in self.parts.items() if k.startswith("prefill"))

    @property
    def decode_total(self) -> float:
        """All per-generated-token terms (decode compute/comm + overhead)."""
        return sum(
            v for k, v in self.parts.items()
            if k.startswith("decode") or k == "overhead"
        )

    @property
    def tpot(self) -> float:
        """Mean time-per-output-token over the decode phase (0 when the
        breakdown carries no generation metadata, e.g. training)."""
        gen = self.meta.get("gen", 0)
        return self.decode_total / gen if gen else 0.0

    def as_dict(self) -> dict:
        return {**{k: float(v) for k, v in self.parts.items()}, "total": float(self.total)}


def _layer_fwd_time(cfg: ModelConfig, hw: HardwareSpec, B: int, S: int, tp: int,
                    prec: int, gemm_scale: float = 1.0) -> tuple[float, float]:
    """(gemm_time, memop_time) for one layer forward (per device)."""
    tg = tm = 0.0
    ops = layer_ops(cfg, B, S, S, tp, layer_idx=max(1, cfg.moe.first_k_dense if cfg.moe else 1),
                    decode=False, prec=prec)
    for op in ops:
        t = op_time(hw, op)
        if isinstance(op, GEMM):
            tg += t.t * gemm_scale
        else:
            tm += t.t
    return tg, tm


def train_step_time(cfg: ModelConfig, hw: HardwareSpec, m: Mapping, *,
                    global_batch: int, seq: int, intra_tp: bool = True) -> Breakdown:
    """Training time per batch (seconds) with component breakdown."""
    L = cfg.num_layers
    layers_per_stage = max(L // m.pp, 1)
    n_micro = max(global_batch // (m.dp * m.microbatch), 1)
    mb, S, prec, tp = m.microbatch, seq, m.prec, m.tp

    g_fwd, mem_fwd = _layer_fwd_time(cfg, hw, mb, S, tp, prec)
    t_layer_fwd = g_fwd + mem_fwd
    # bwd: dgrad+wgrad = 2x GEMM work; elementwise ~2x bytes
    t_layer_bwd = 2.0 * g_fwd + 1.5 * mem_fwd  # bwd elementwise reuse (calibrated)
    # recompute overhead (§3.3)
    if m.recompute == "full":
        t_layer_bwd += t_layer_fwd
    elif m.recompute == "selective":
        # recompute attention scores/softmax/AV only (~the score GEMMs + softmax)
        hq = max(cfg.num_heads // tp, 1)
        sc = GEMM("qk_re", S, S, cfg.head_dim, batch=mb * hq, bytes_in=prec,
                  weight_reuse=False)
        av = GEMM("av_re", S, cfg.head_dim, S, batch=mb * hq, bytes_in=prec,
                  weight_reuse=False)
        if cfg.family not in ("ssm",):
            t_layer_bwd += op_time(hw, sc).t + op_time(hw, av).t

    # TP collectives per layer (Megatron: 2 AR fwd + 2 AR bwd; SP keeps volume)
    net_tp = hw.net[0] if intra_tp else hw.net[1]
    K = mb * S * cfg.d_model * prec
    t_ar = C.allreduce(K, tp, net_tp, algo="ring") if tp > 1 else 0.0
    tp_fwd = 2.0 * t_ar
    tp_bwd = 2.0 * t_ar

    # embedding + head (+CE) on the edge stages, per microbatch
    head_ops = embedding_head_ops(cfg, mb, S, tp, prec=prec, with_loss=True)
    t_head_fwd, _ = total_time(hw, head_ops)
    t_head = 3.0 * t_head_fwd  # fwd + bwd

    t_mb_fwd = layers_per_stage * (t_layer_fwd + tp_fwd) + t_head_fwd
    t_mb_bwd = layers_per_stage * (t_layer_bwd + tp_bwd) + (t_head - t_head_fwd)
    t_steady = n_micro * (t_mb_fwd + t_mb_bwd)
    t_bubble = m.bubble_fraction(n_micro) * (t_mb_fwd + t_mb_bwd) * 1.0

    # PP p2p activation sends (per microbatch, per boundary, fwd+bwd)
    t_pp = 0.0
    if m.pp > 1:
        K_act = mb * S * cfg.d_model * prec
        # p2p sends overlap with compute in steady state; 25% residual exposed
        t_pp = 0.25 * 2.0 * (m.pp - 1) * C.p2p(K_act, hw.net[1]) * n_micro / max(m.pp, 1)

    # DP gradient all-reduce over the inter-node level, overlapped with bwd
    t_dp = 0.0
    if m.dp > 1:
        from repro_torch.core.operators import total_param_count

        K_grad = total_param_count(cfg) * prec / (m.tp * m.pp)
        t_dp_raw = C.allreduce(K_grad, m.dp, hw.net[1], algo="ring")
        t_dp = max(t_dp_raw - m.dp_overlap * n_micro * t_mb_bwd, t_dp_raw * 0.1)

    # optimizer update: stream params+grads+opt states (memory-bound)
    from repro_torch.core.operators import total_param_count

    P_dev = total_param_count(cfg) / (m.tp * m.pp)
    opt_bytes = P_dev * ((2 + 2 + 4.1) if m.opt_8bit else (2 + 2 + 12)) * 2  # r+w
    if m.zero1:
        opt_bytes /= max(m.dp, 1)
    t_opt = opt_bytes / (hw.dram.bw * hw.dram.util)

    return Breakdown(
        {
            "compute_fwd": n_micro * layers_per_stage * t_layer_fwd + n_micro * t_head_fwd,
            "compute_bwd": n_micro * layers_per_stage * t_layer_bwd
            + n_micro * (t_head - t_head_fwd),
            "tp_comm": n_micro * layers_per_stage * (tp_fwd + tp_bwd),
            "pipeline_bubble": t_bubble,
            "pp_comm": t_pp,
            "dp_comm": t_dp,
            "optimizer": t_opt,
        }
    )


def inference_latency(cfg: ModelConfig, hw: HardwareSpec, *, tp: int, batch: int,
                      prompt: int, gen: int, prec: int = 2,
                      per_token_overhead: float = 300e-6,
                      comm_algo: str = "tree") -> Breakdown:
    """End-to-end latency (s) for prompt summarization + `gen` generated tokens."""
    net = hw.net[0]
    d = cfg.d_model

    # ---- prefill ----
    ops = []
    for i in range(cfg.num_layers):
        ops += layer_ops(cfg, batch, prompt, prompt, tp, i, decode=False, prec=prec)
    t_prefill_comp, _ = total_time(hw, ops)
    t_head, _ = total_time(hw, embedding_head_ops(cfg, batch, 1, tp, prec=prec))
    K_pre = batch * prompt * d * prec
    n_ar_layers = _n_ar_layers(cfg)
    t_prefill_comm = 2.0 * n_ar_layers * C.allreduce(K_pre, tp, net, algo=comm_algo)
    t_prefill = t_prefill_comp + t_head + t_prefill_comm

    # ---- decode (per token; ctx grows prompt -> prompt+gen) ----
    t_dec_comp = 0.0
    K_tok = batch * d * prec
    t_ar_tok = C.allreduce(K_tok, tp, net, algo=comm_algo) if tp > 1 else 0.0
    # sample ctx at a few points and integrate (ctx-linear terms dominate)
    samples = 8
    for j in range(samples):
        ctx = prompt + (j + 0.5) * gen / samples
        ops = []
        for i in range(cfg.num_layers):
            ops += layer_ops(cfg, batch, 1, int(ctx), tp, i, decode=True, prec=prec)
        t, _ = total_time(hw, ops)
        t_dec_comp += t * (gen / samples)
    t_dec_head = gen * t_head
    t_dec_comm = gen * 2.0 * n_ar_layers * t_ar_tok
    t_overhead = gen * per_token_overhead

    return Breakdown(
        {
            "prefill_compute": t_prefill_comp + t_head,
            "prefill_comm": t_prefill_comm,
            "decode_compute": t_dec_comp + t_dec_head,
            "decode_comm": t_dec_comm,
            "overhead": t_overhead,
        },
        meta={"gen": gen, "prompt": prompt, "batch": batch},
    )


def _n_ar_layers(cfg: ModelConfig) -> float:
    """Layers with TP all-reduces (2 per layer); hybrid counts shared blocks."""
    if cfg.family == "hybrid" and cfg.attn_every:
        n_shared = len([i for i in range(cfg.num_layers) if i % cfg.attn_every == 0])
        return cfg.num_layers + 2 * n_shared
    return cfg.num_layers


def gemm_table(cfg: ModelConfig, hw: HardwareSpec, *, tp: int, batch: int, S: int,
               decode: bool, prec: int = 2) -> list:
    """Per-GEMM times + bound types for one layer — reproduces Table 4."""
    idx = max(1, cfg.moe.first_k_dense if cfg.moe else 1)
    ops = layer_ops(cfg, batch, 1 if decode else S, S, tp, idx, decode=decode, prec=prec)
    out = []
    for op in ops:
        t = op_time(hw, op)
        out.append(t)
    return out
