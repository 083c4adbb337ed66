"""Architecture registry of the port (the configs ported so far)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

ARCHS = ["qwen3_14b"]

ALIASES = {"qwen3-14b": "qwen3_14b"}


def get_config(name: str) -> ModelConfig:
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod not in ARCHS:
        raise ValueError(f"{name!r} is not ported yet; ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)
