"""Architecture registry of the port: every config of the JAX package."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoECfg, SSMCfg  # noqa: F401

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
