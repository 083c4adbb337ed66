"""Architecture registry of the port: every config of the JAX package, and the
input specs of every (arch x shape) cell of the dry-run."""

from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    SMOKE_SHAPES,
    ModelConfig,
    MoECfg,
    ParallelConfig,
    ShapeSpec,
    SSMCfg,
    TrainConfig,
)

ARCHS = [
    "qwen3_14b",
    "starcoder2_3b",
    "h2o_danube_1p8b",
    "minitron_8b",
    "musicgen_large",
    "pixtral_12b",
    "arctic_480b",
    "deepseek_moe_16b",
    "zamba2_1p2b",
    "rwkv6_7b",
]

# CLI ids (assignment spelling) -> module names
ALIASES = {
    "qwen3-14b": "qwen3_14b",
    "starcoder2-3b": "starcoder2_3b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "minitron-8b": "minitron_8b",
    "musicgen-large": "musicgen_large",
    "pixtral-12b": "pixtral_12b",
    "arctic-480b": "arctic_480b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-7b": "rwkv6_7b",
}


def get_config(name: str) -> ModelConfig:
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod not in ARCHS:
        raise ValueError(f"{name!r} is not ported yet; ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Stand-ins on the meta device for the model-input part of a step (JAX's
    ShapeDtypeStructs: the same shapes and dtypes, nothing allocated).

    train  -> {tokens|embeds, labels}
    prefill-> {tokens|embeds}
    decode -> {tokens (B, 1)}  (the KV/state cache comes from
              Model.cache_shapes and is composed by the caller)
    """
    B, S = shape.global_batch, shape.seq_len

    def tok(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "decode":
        return {"tokens": tok(B, 1)}
    if cfg.input_mode == "embeds":
        inputs = {"embeds": torch.empty((B, S, cfg.d_model), dtype=cfg.compute_dtype,
                                        device="meta")}
    else:
        inputs = {"tokens": tok(B, S)}
    if shape.kind == "train":
        inputs["labels"] = tok(B, S)
    return inputs


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs; reason recorded when skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "skipped: pure full-attention arch — 524k dense-KV decode is excluded "
            "by the assignment (sub-quadratic attention required); see DESIGN.md §5"
        )
    return True, ""
