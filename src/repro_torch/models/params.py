"""Parameter trees of the port: its own seeded init, and the bridge from JAX.

Layout. Parameters are a nested dict of tensors with the same keys as the
JAX pytree (`embed/tok`, `layers/attn/wq`, ...). The per-layer weights stay
STACKED, `(L, ...)`, exactly as JAX's scan-over-layers keeps them; the model
loops over `layer_params(params, i)`, which takes views, so nothing is copied.
Every weight keeps the `x @ W` orientation, `(in, out)`, so no transpose is
needed anywhere.

The output head `lm_head/w` is held in float32. The logits are computed in
float32 (`Model._head`, as in JAX's `_head`), and casting the 5120 x 151936
head once here, instead of on every decode step, costs 3.1 GB once.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

HEAD = "lm_head/w"  # drawn or loaded in the param dtype, then held in float32


@dataclass(frozen=True)
class PD:
    """Parameter definition: shape, initializer, dtype override."""

    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones
    stddev: float = 0.02
    dtype: torch.dtype | None = None


FAMILIES = ("dense", "vlm", "audio")  # the families of the dense decoder


def _norm_defs(cfg: ModelConfig, *lead: int) -> dict:
    """A norm's gains (and LayerNorm's bias), fp32, with optional leading dims."""
    f32 = torch.float32
    if cfg.norm == "rmsnorm":
        return {"scale": PD((*lead, cfg.d_model), init="ones", dtype=f32)}
    if cfg.norm == "layernorm":
        return {"scale": PD((*lead, cfg.d_model), init="ones", dtype=f32),
                "bias": PD((*lead, cfg.d_model), init="zeros", dtype=f32)}
    raise ValueError(f"unknown norm {cfg.norm!r}")


def param_defs(cfg: ModelConfig) -> dict:
    """The PD tree of the dense decoder (the keys of JAX's `Model.param_defs`)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    D, L, F = cfg.d_model, cfg.num_layers, cfg.d_ff
    f32 = torch.float32
    attn = {
        "wq": PD((L, D, cfg.q_dim)),
        "wk": PD((L, D, cfg.kv_dim)),
        "wv": PD((L, D, cfg.kv_dim)),
        "wo": PD((L, cfg.q_dim, D)),
    }
    if cfg.qk_norm:
        attn["q_norm"] = PD((L, cfg.head_dim), init="ones", dtype=f32)
        attn["k_norm"] = PD((L, cfg.head_dim), init="ones", dtype=f32)
    mlp = {"wi": PD((L, D, F)), "wo": PD((L, F, D))}
    if cfg.gated_mlp:
        mlp["wg"] = PD((L, D, F))
    defs: dict[str, Any] = {
        "embed": {"tok": PD((cfg.vocab_size, D))},
        "final_norm": _norm_defs(cfg),
        "layers": {
            "ln1": _norm_defs(cfg, L),
            "attn": attn,
            "ln2": _norm_defs(cfg, L),
            "mlp": mlp,
        },
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = {"w": PD((D, cfg.vocab_size))}
    return defs


def _walk(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, path)
        else:
            yield path, v


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def count_params(cfg: ModelConfig) -> int:
    return sum(int(np.prod(pd.shape)) for _, pd in _walk(param_defs(cfg)))


def init_params(cfg: ModelConfig, seed: int, device: torch.device) -> dict:
    """The port's own init: each leaf drawn on `device` from its own generator.

    The generator of a leaf is seeded with the crc32 of `"{seed}/{path}"`,
    as JAX folds a crc32 of the path into its key, so a leaf does not depend
    on the others. The values are NOT JAX's bits (torch cannot reproduce
    `jax.random`): parity tests take JAX's parameters through `from_jax`.
    """
    params: dict = {}
    for path, pd in _walk(param_defs(cfg)):
        dtype = pd.dtype or cfg.pdtype
        if pd.init == "ones":
            t = torch.ones(pd.shape, dtype=dtype, device=device)
        elif pd.init == "zeros":
            t = torch.zeros(pd.shape, dtype=dtype, device=device)
        else:
            g = torch.Generator(device=device)
            g.manual_seed(zlib.crc32(f"{seed}/{path}".encode()) & 0x7FFFFFFF)
            t = torch.empty(pd.shape, dtype=dtype, device=device).normal_(0.0, pd.stddev, generator=g)
        _set(params, path, t.float() if path == HEAD else t)
    return params


def from_jax(params_np: dict, cfg: ModelConfig, device: torch.device) -> dict:
    """JAX's parameter pytree, already converted to numpy, as the port's tree.

    Values are copied bit for bit; only `lm_head/w` is widened to float32,
    which is exact. bfloat16 leaves may arrive as ml_dtypes bfloat16 arrays.
    """
    params: dict = {}
    for path, pd in _walk(param_defs(cfg)):
        a = _get(params_np, path)
        if tuple(a.shape) != pd.shape:
            raise ValueError(f"{path}: shape {a.shape} != {pd.shape}")
        dtype = pd.dtype or cfg.pdtype
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a copy: JAX's buffers are read-only
        _set(params, path, t.to(device=device, dtype=torch.float32 if path == HEAD else dtype))
    return params


def _get(tree: dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def layer_params(params: dict, i: int) -> dict:
    """Views of layer `i` of the stacked `(L, ...)` layer tree."""
    out: dict = {}
    for path, t in _walk(params["layers"]):
        _set(out, path, t[i])
    return out
