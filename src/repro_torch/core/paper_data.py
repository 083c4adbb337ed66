"""Published data from the paper, for validation benchmarks.

Table 1  — Megatron A100 training times per batch ([28]/[14] as reported).
Table 2  — NVIDIA Llama-2 inference latencies (A100 / H100), 200+200 tokens.
Table 4  — GEMM-level bound types, Llama2-13B prefill, A100 vs H100.
Model configs: GPT family (Megatron papers), Llama-2 family.

A copy of `repro.core.paper_data` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig


def _gpt(name, L, h, a, vocab=51200) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", num_layers=L, d_model=h, num_heads=a,
        num_kv_heads=a, head_dim=h // a, d_ff=4 * h, vocab_size=vocab,
        norm="layernorm", act="gelu", gated_mlp=False,
    )


GPT_CONFIGS = {
    "gpt-7b": _gpt("gpt-7b", 32, 4096, 32),
    "gpt-22b": _gpt("gpt-22b", 48, 6144, 64),
    "gpt-175b": _gpt("gpt-175b", 96, 12288, 96),
    "gpt-310b": _gpt("gpt-310b", 96, 16384, 128),
    "gpt-530b": _gpt("gpt-530b", 105, 20480, 128),
    "gpt-1008b": _gpt("gpt-1008b", 128, 25600, 160),
}


def _llama2(name, L, h, a, kv, ff) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", num_layers=L, d_model=h, num_heads=a,
        num_kv_heads=kv, head_dim=h // a, d_ff=ff, vocab_size=32000,
        norm="rmsnorm", act="silu", gated_mlp=True,
    )


LLAMA2_CONFIGS = {
    "llama2-7b": _llama2("llama2-7b", 32, 4096, 32, 32, 11008),
    "llama2-13b": _llama2("llama2-13b", 40, 5120, 40, 40, 13824),
    "llama2-70b": _llama2("llama2-70b", 80, 8192, 64, 8, 28672),
}


@dataclass(frozen=True)
class Table1Row:
    model: str
    gpus: int
    batch: int
    dp: int
    tp: int
    pp: int
    sp: bool
    recompute: str
    t_ref: float  # seconds per batch, as published
    t_paper_pred: float  # the paper's own prediction


# seq 2048 for all rows
TABLE1 = [
    # ---- only TP and PP, full recompute ([28]) ----
    Table1Row("gpt-22b", 8, 4, 1, 8, 8 // 8, False, "full", 1.4, 1.4),
    Table1Row("gpt-175b", 64, 64, 1, 8, 8, False, "full", 18.1, 16.9),
    Table1Row("gpt-530b", 280, 280, 1, 8, 35, False, "full", 49.1, 46.8),
    Table1Row("gpt-1008b", 512, 512, 1, 8, 64, False, "full", 94.4, 87.9),
    # ---- TP, PP and SP, selective recompute ([14]) ----
    Table1Row("gpt-22b", 8, 4, 1, 8, 1, True, "selective", 1.1, 1.1),
    Table1Row("gpt-175b", 64, 64, 1, 8, 8, True, "selective", 13.8, 12.9),
    Table1Row("gpt-530b", 280, 280, 1, 8, 35, True, "selective", 37.8, 35.5),
    Table1Row("gpt-1008b", 512, 512, 1, 8, 64, True, "selective", 71.5, 69.1),
    # ---- DP, TP and PP, full recompute ([28]) ----
    Table1Row("gpt-310b", 1920, 2160, 15, 8, 16, False, "full", 37.6, 34.1),
    Table1Row("gpt-530b", 2520, 2520, 9, 8, 35, False, "full", 54.2, 51.2),
    Table1Row("gpt-1008b", 3072, 3072, 6, 8, 64, False, "full", 102.4, 100.7),
]


@dataclass(frozen=True)
class Table2Row:
    model: str
    gpus: int
    tp: int
    t_a100_ms: float
    t_a100_paper_pred: float
    t_h100_ms: float
    t_h100_paper_pred: float


# batch 1, prompt 200, gen 200 (§4.3)
TABLE2 = [
    Table2Row("llama2-70b", 8, 8, 4735, 4284, 3202, 3147),
    Table2Row("llama2-70b", 4, 4, 6403, 6019, 4116, 3986),
    Table2Row("llama2-70b", 2, 2, 10500, 10042, 6267, 6186),
    Table2Row("llama2-13b", 8, 8, 1693, 1514, 1201, 1209),
    Table2Row("llama2-13b", 4, 4, 1894, 1748, 1431, 1258),
    Table2Row("llama2-13b", 2, 2, 2499, 2492, 1717, 1617),
    Table2Row("llama2-13b", 1, 1, 3884, 4263, 2396, 2599),
    Table2Row("llama2-7b", 8, 8, 1187, 1096, 828, 899),
    Table2Row("llama2-7b", 4, 4, 1280, 1166, 924, 869),
    Table2Row("llama2-7b", 2, 2, 1544, 1526, 1143, 1016),
    Table2Row("llama2-7b", 1, 1, 2190, 2472, 1440, 1522),
]


# Table 4: GEMM bound types, Llama2-13B summarization (B=1, 200 tokens), half
# precision. Times in µs as printed in the paper.
TABLE4 = [
    # (gemm, t_a100_us, bound_a100, t_h100_us, bound_h100)
    ("qkv_proj", 82, "compute", 32, "memory"),
    ("qk", 3, "memory", 2, "memory"),
    ("av", 3, "memory", 2, "memory"),
    ("o_proj", 42, "compute", 17, "memory"),
    ("mlp_up", 216, "compute", 81, "memory"),
    ("mlp_down", 109, "compute", 42, "memory"),
]

# Fig 5: training-time scaling across GPU generations, GPT3-175B (normalized
# to B200-NVS-L = 1). Qualitative targets: ~35x A100->B200-NVS-L.
FIG5_SYSTEMS = [
    # (label, hw, net, batch, notes)
    ("A100-HDR", "a100", "hdr", 1024, ""),
    ("H100-NDR", "h100", "ndr", 1024, "~4x over A100"),
    ("H100-NVS", "h100", "nvs", 1024, ""),
    ("H200-NVS-L", "h200", "nvs", 4096, ""),
    ("B200-NDR", "b200", "ndr", 1024, ""),
    ("B200-NVS", "b200", "nvs", 1024, ""),
    ("B200-NVS-L", "b200", "nvs5", 4096, "reference"),
]
