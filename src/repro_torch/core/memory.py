"""Training memory-footprint model (§3.3, §5.1 / Fig 4).

Activation sizes follow Korthikanti et al. [14] (the paper's reference):
per layer, fp16/bf16, MHA transformer:

    A_tot = s*b*h*(34 + 5*a*s/h)   bytes

with the tensor-parallel region divided by t, and the norm/dropout regions
divided by t only under sequence parallelism. Recomputation policies:

  * none       : L * A_tot
  * selective  : eq (2) — drop the softmax/dropout score terms (5*a*s^2*b)
  * full       : eq (1) — N_ckp layer-input checkpoints + one layer's working set

Weights/optimizer: mixed-precision training (2-byte weights/grads, fp32
master+m+v = 12 bytes) -> 16 bytes/param, divided by (t*p); optimizer part
further divided by dp under ZeRO-1; 8-bit optimizer states take 2 bytes + scales.

A copy of `repro.core.memory` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.operators import total_param_count


@dataclass(frozen=True)
class MemoryBreakdown:
    weights: float
    gradients: float
    optimizer: float
    activations: float

    @property
    def total(self) -> float:
        return self.weights + self.gradients + self.optimizer + self.activations

    def as_dict(self) -> dict:
        return {
            "weights": self.weights,
            "gradients": self.gradients,
            "optimizer": self.optimizer,
            "activations": self.activations,
            "total": self.total,
        }


def activation_per_layer(cfg: ModelConfig, b: int, s: int, tp: int, sp: bool,
                         prec: int = 2) -> dict:
    """Returns the per-layer activation terms (bytes) for one microbatch."""
    h = cfg.d_model
    a = cfg.num_heads
    # paper/[14] constants generalized to the config's mlp ratio & GQA
    kv_frac = cfg.num_kv_heads / max(cfg.num_heads, 1)
    mlp_ratio = cfg.d_ff / h * (1.5 if cfg.gated_mlp else 1.0)
    # tensor-parallel region (qkv/proj/mlp activations)
    tp_region = s * b * h * prec * (2 + 2 * kv_frac + 2 + 2 * 2 * mlp_ratio + 2)
    # norm/dropout/input region (10 s b h in [14])
    seq_region = s * b * h * prec * 5
    score_terms = {
        "softmax_in": a * s * s * b * prec,  # A_sm
        "dropout_mask": a * s * s * b * 1,  # A_do_mask
        "dropout_out": a * s * s * b * prec,  # A_do_out
        "scores_extra": 2 * a * s * s * b * prec,  # QK^T + attn-dropout input
    }
    moe_bytes = 0.0
    if cfg.moe is not None:
        # dispatch buffer + gathered rows + expert hidden (capacity-based MoE)
        m = cfg.moe
        tok = s * b * m.top_k * m.capacity_factor
        moe_bytes = prec * tok * (2 * h + m.d_ff)
    tp_div = max(tp, 1)
    seq_div = tp_div if sp else 1
    return {
        "moe": moe_bytes / tp_div,
        "tp_region": tp_region / tp_div,
        "seq_region": seq_region / seq_div,
        "scores": sum(score_terms.values()) / tp_div,
        "A_sm": score_terms["softmax_in"] / tp_div,
        "A_do_mask": score_terms["dropout_mask"] / tp_div,
        "A_do_out": score_terms["dropout_out"] / tp_div,
        "A_inp": s * b * h * prec / seq_div,
    }


def activation_memory(cfg: ModelConfig, b: int, s: int, tp: int, sp: bool,
                      recompute: str, *, n_ckp: int | None = None, prec: int = 2,
                      layers: int | None = None) -> float:
    """Total activation bytes per device for one in-flight microbatch."""
    L = layers if layers is not None else cfg.num_layers
    t = activation_per_layer(cfg, b, s, tp, sp, prec)
    a_tot = t["tp_region"] + t["seq_region"] + t["scores"] + t["moe"]
    a_inp = t["A_inp"]
    if recompute == "none":
        return L * a_tot
    if recompute == "selective":
        # eq (2): A_sel = L (A_tot - (A_sm + A_do_mask + A_do_out))
        return L * (a_tot - (t["A_sm"] + t["A_do_mask"] + t["A_do_out"]))
    if recompute == "full":
        # eq (1): A_full = N_ckp A_inp + L/N_ckp (A_tot - A_inp)
        n = n_ckp or L
        return n * a_inp + (L / n) * (a_tot - a_inp)
    raise ValueError(recompute)


def weight_optimizer_memory(cfg: ModelConfig, tp: int, pp: int, dp: int = 1, *,
                            zero1: bool = False, opt_8bit: bool = False,
                            prec: int = 2) -> tuple[float, float, float]:
    """(weights, gradients, optimizer) bytes per device."""
    P = total_param_count(cfg) / (tp * pp)
    if cfg.moe is not None and cfg.moe.shard_ff_dp:
        # expert ffn weights additionally sharded over the data axes
        m = cfg.moe
        n_mm = 3 if cfg.gated_mlp else 2
        expert = m.num_experts * n_mm * cfg.d_model * m.d_ff * cfg.num_layers / (tp * pp)
        P = (P - expert) + expert / max(dp, 1)
    weights = P * prec
    grads = P * prec if not zero1 else P * 4.0 / max(dp, 1)  # fp32, ZeRO-sharded
    opt_bytes_per_param = (2.0 + 2.1) if opt_8bit else 12.0
    opt = P * opt_bytes_per_param
    if zero1:
        opt /= max(dp, 1)
    return weights, grads, opt


def training_memory(cfg: ModelConfig, *, global_batch: int, seq: int, dp: int, tp: int,
                    pp: int, sp: bool, microbatch: int, recompute: str,
                    zero1: bool = False, opt_8bit: bool = False, prec: int = 2,
                    schedule: str = "1f1b") -> MemoryBreakdown:
    w, g, o = weight_optimizer_memory(cfg, tp, pp, dp, zero1=zero1, opt_8bit=opt_8bit,
                                      prec=prec)
    layers_per_stage = max(cfg.num_layers // pp, 1)
    # in-flight microbatches: 1F1B holds p microbatches on stage 0; GPipe holds m
    m = max(global_batch // (dp * microbatch), 1)
    in_flight = min(pp, m) if schedule in ("1f1b", "interleaved") else m
    act = activation_memory(cfg, microbatch, seq, tp, sp, recompute, prec=prec,
                            layers=layers_per_stage) * in_flight
    return MemoryBreakdown(w, g, o, act)
