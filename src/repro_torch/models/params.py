"""Parameter trees of the port: its own seeded init, and the bridge from JAX.

Layout. Parameters are a nested dict of tensors with the same keys as the
JAX pytree (`embed/tok`, `layers/attn/wq`, ...). The per-layer weights stay
STACKED, `(L, ...)`, exactly as JAX's scan-over-layers keeps them; the model
loops over `layer_params(params, i)`, which takes views, so nothing is copied.
An MoE config's leading dense layers are not stacked: `head_layers/"0"/...`,
as in JAX, and `layers` then stacks the remaining `L - first_k_dense`. A
hybrid (zamba2) stacks its L Mamba2 layers `{ln1, mamba}` and keeps the one
shared attention + MLP block unstacked under `shared`; an RWKV6 config
stacks its L layers `{ln1, tm, ln2, cm}`.
Every weight keeps the `x @ W` orientation, `(in, out)`, so no transpose is
needed anywhere.

Sharding. Each PD carries JAX's logical axes, one a dim (a stacked leaf a
leading None); `param_specs` resolves them under the current rules, and
`distribute` places a tree on a DeviceMesh by them (`parallel/axes.py`).

The output head `lm_head/w`. JAX holds it in the param dtype and widens it
to float32 at each use (`Model._head`), and training keeps that: its grads,
its AdamW rounding and its checkpoint entry are in the param dtype
(`widen_head=False`). Serving may widen it once at load instead
(`widen_head=True`, the default of `init_params` and `from_jax`): the logits
are the same, exactly, and casting the 5120 x 151936 head once instead of on
every decode step costs 3.1 GB once.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.axes import logical_spec, placements, sanitize_pspec

HEAD = "lm_head/w"  # drawn or loaded in the param dtype; held in float32 when widened


@dataclass(frozen=True)
class PD:
    """Parameter definition: shape, logical axes per dim (JAX's), initializer, dtype
    override."""

    shape: tuple[int, ...]
    logical: tuple[Any, ...]  # one logical name (or None / tuple) a dim
    init: str = "normal"  # normal | zeros | ones | constant
    stddev: float = 0.02
    dtype: torch.dtype | None = None
    constant: float = 0.0

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _un(lead: tuple[int, ...]) -> tuple[None, ...]:
    """The logical axes of leading layer-stack dims: unsharded, as JAX's `stacked`."""
    return (None,) * len(lead)


FAMILIES = ("dense", "vlm", "audio", "moe", "hybrid", "ssm")


def _norm_defs(cfg: ModelConfig, *lead: int, kind: str | None = None) -> dict:
    """A norm's gains (and LayerNorm's bias), fp32, with optional leading dims; the
    norm is `cfg.norm` unless `kind` names one."""
    f32 = torch.float32
    kind = kind or cfg.norm
    ax = (*_un(lead), None)
    if kind == "rmsnorm":
        return {"scale": PD((*lead, cfg.d_model), ax, init="ones", dtype=f32)}
    if kind == "layernorm":
        return {"scale": PD((*lead, cfg.d_model), ax, init="ones", dtype=f32),
                "bias": PD((*lead, cfg.d_model), ax, init="zeros", dtype=f32)}
    raise ValueError(f"unknown norm {kind!r}")


def _mlp_defs(cfg: ModelConfig, ff: int, *lead: int) -> dict:
    D, un = cfg.d_model, _un(lead)
    # Megatron column -> row parallel
    mlp = {"wi": PD((*lead, D, ff), (*un, None, "tp")), "wo": PD((*lead, ff, D), (*un, "tp", None))}
    if cfg.gated_mlp:
        mlp["wg"] = PD((*lead, D, ff), (*un, None, "tp"))
    return mlp


def _moe_defs(cfg: ModelConfig, *lead: int) -> dict:
    """`repro.models.moe.moe_defs`: the router (held in float32), E experts, the
    shared experts as one MLP of their summed width, and arctic's dense branch.
    The expert dim shards over ep; under `shard_ff_dp` the ff dim also over the
    ZeRO axes (ZeRO-3 style: gathered at use, `models/moe.py`)."""
    m, D, un = cfg.moe, cfg.d_model, _un(lead)
    E, F = m.num_experts, m.d_ff
    ff_ax = "zero" if m.shard_ff_dp else None
    defs = {
        "router": PD((*lead, D, E), (*un, None, None), dtype=torch.float32),
        "wi": PD((*lead, E, D, F), (*un, "ep", None, ff_ax)),
        "wo": PD((*lead, E, F, D), (*un, "ep", ff_ax, None)),
    }
    if cfg.gated_mlp:
        defs["wg"] = PD((*lead, E, D, F), (*un, "ep", None, ff_ax))
    if m.num_shared_experts:
        defs["shared"] = _mlp_defs(cfg, F * m.num_shared_experts, *lead)
    if m.dense_residual:
        defs["dense"] = _mlp_defs(cfg, m.dense_d_ff or F, *lead)
    return defs


def _layer_defs(cfg: ModelConfig, moe_layer: bool, *lead: int) -> dict:
    """One decoder layer; MLP layers of an MoE config are `dense_d_ff` wide."""
    D, f32, un = cfg.d_model, torch.float32, _un(lead)
    col, row = (*un, None, "tp"), (*un, "tp", None)
    attn = {
        "wq": PD((*lead, D, cfg.q_dim), col),
        "wk": PD((*lead, D, cfg.kv_dim), col),
        "wv": PD((*lead, D, cfg.kv_dim), col),
        "wo": PD((*lead, cfg.q_dim, D), row),
    }
    if cfg.qk_norm:
        attn["q_norm"] = PD((*lead, cfg.head_dim), (*un, None), init="ones", dtype=f32)
        attn["k_norm"] = PD((*lead, cfg.head_dim), (*un, None), init="ones", dtype=f32)
    d = {"ln1": _norm_defs(cfg, *lead), "attn": attn, "ln2": _norm_defs(cfg, *lead)}
    if moe_layer:
        d["moe"] = _moe_defs(cfg, *lead)
    else:
        ff = cfg.moe.dense_d_ff if (cfg.moe and cfg.moe.dense_d_ff) else cfg.d_ff
        d["mlp"] = _mlp_defs(cfg, ff, *lead)
    return d


def _mamba2_defs(cfg: ModelConfig, *lead: int) -> dict:
    """`repro.models.mamba2.mamba2_defs`: the in-projection to (z, x, B, C, dt), the
    depthwise conv, and the float32 decay, skip, dt bias and gated-norm gains."""
    s, D, f32, un = cfg.ssm, cfg.d_model, torch.float32, _un(lead)
    d_inner = s.expand * D
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    tp = (*un, "tp")
    return {
        "w_in": PD((*lead, D, 2 * d_inner + 2 * s.n_groups * s.d_state + H), (*un, None, "tp")),
        "conv_w": PD((*lead, conv_dim, s.conv_width), (*un, "tp", None), stddev=0.1),
        "conv_b": PD((*lead, conv_dim), tp, init="zeros"),
        "a_log": PD((*lead, H), tp, init="constant", constant=0.5, dtype=f32),
        "d_skip": PD((*lead, H), tp, init="ones", dtype=f32),
        "dt_bias": PD((*lead, H), tp, init="zeros", dtype=f32),
        "norm": PD((*lead, d_inner), tp, init="ones", dtype=f32),
        "w_out": PD((*lead, d_inner, D), (*un, "tp", None)),
    }


def _rwkv6_layer_defs(cfg: ModelConfig, *lead: int) -> dict:
    """`repro.models.rwkv6.rwkv6_defs` with the layer's two norms, which are
    LayerNorm whatever `cfg.norm` says (`transformer.py::_rwkv_layer_defs`)."""
    s, D, F, f32, un = cfg.ssm, cfg.d_model, cfg.d_ff, torch.float32, _un(lead)
    H, k, r = D // s.head_dim, s.mix_dim, s.decay_lora
    ln = _norm_defs(cfg, *lead, kind="layernorm")
    rep, tp = (*un, None), (*un, "tp")
    col, row = (*un, None, "tp"), (*un, "tp", None)
    return {
        "ln1": ln,
        "tm": {
            "maa_x": PD((*lead, D), rep, init="zeros"),
            "maa": PD((*lead, 5, D), (*un, None, None), init="zeros"),  # w, k, v, r, g base mixes
            "mix_w1": PD((*lead, D, 5 * k), (*un, None, None)),
            "mix_w2": PD((*lead, 5, k, D), (*un, None, None, None)),
            "w0": PD((*lead, D), tp, init="constant", constant=-4.0, dtype=f32),
            "w_a": PD((*lead, D, r), (*un, None, None)),
            "w_b": PD((*lead, r, D), col),
            "wr": PD((*lead, D, D), col),
            "wk": PD((*lead, D, D), col),
            "wv": PD((*lead, D, D), col),
            "wg": PD((*lead, D, D), col),
            "wo": PD((*lead, D, D), row),
            "u": PD((*lead, H, s.head_dim), row, dtype=f32),  # the current token's bonus
            "ln_x": {"scale": PD((*lead, D), tp, init="ones", dtype=f32),
                     "bias": PD((*lead, D), tp, init="zeros", dtype=f32)},
        },
        "ln2": dict(ln),
        "cm": {
            "mu_k": PD((*lead, D), rep, init="zeros"),
            "mu_r": PD((*lead, D), rep, init="zeros"),
            "wk": PD((*lead, D, F), col),
            "wv": PD((*lead, F, D), row),
            "wr": PD((*lead, D, D), col),
        },
    }


def n_head_layers(cfg: ModelConfig) -> int:
    """Leading dense layers, kept unstacked under `head_layers` (deepseek's layer 0)."""
    return cfg.moe.first_k_dense if cfg.moe else 0


def param_defs(cfg: ModelConfig) -> dict:
    """The PD tree of the decoder (the keys of JAX's `Model.param_defs`).

    The first `n_head_layers` layers are dense and sit under `head_layers`,
    keyed "0", "1", ... and not stacked; the rest are stacked under `layers`,
    and are MoE layers when the config has an MoE block. A hybrid stacks its
    Mamba2 layers and adds the unstacked `shared` block; an RWKV6 config
    stacks its RWKV6 layers.
    """
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    n_head = n_head_layers(cfg)
    defs: dict[str, Any] = {
        # vocab-sharded over tp (Megatron-style embedding parallelism)
        "embed": {"tok": PD((cfg.vocab_size, cfg.d_model), ("tp", None))},
        "final_norm": _norm_defs(cfg),
    }
    if cfg.family == "hybrid":
        L = cfg.num_layers
        defs["layers"] = {"ln1": _norm_defs(cfg, L), "mamba": _mamba2_defs(cfg, L)}
        defs["shared"] = _layer_defs(cfg, False)  # one attn + MLP block, applied repeatedly
    elif cfg.family == "ssm":
        defs["layers"] = _rwkv6_layer_defs(cfg, cfg.num_layers)
    else:
        if n_head:
            defs["head_layers"] = {str(i): _layer_defs(cfg, False) for i in range(n_head)}
        defs["layers"] = _layer_defs(cfg, cfg.moe is not None, cfg.num_layers - n_head)
    if not cfg.tie_embeddings:
        defs["lm_head"] = {"w": PD((cfg.d_model, cfg.vocab_size), (None, "tp"))}
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


def param_specs(defs: dict) -> dict:
    """The spec tree of a PD tree under the current rules (JAX's `param_specs`)."""
    return {k: param_specs(v) if isinstance(v, dict) else logical_spec(*v.logical)
            for k, v in defs.items()}


def param_shapes(defs: dict) -> dict:
    """The shape tree of a PD tree."""
    return {k: param_shapes(v) if isinstance(v, dict) else v.shape for k, v in defs.items()}


def distribute(tree: dict, specs: dict, mesh) -> dict:
    """Each tensor of `tree` as a DTensor on `mesh`, placed by its spec (sanitized
    against its shape, as JAX's trainer sanitizes its shardings). Every rank holds
    the whole tensor already, so each keeps its own shard: nothing is sent."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = distribute(v, specs[k], mesh)
            continue
        spec = sanitize_pspec(specs[k], tuple(v.shape), mesh)
        out[k] = distribute_tensor(v, mesh, placements(spec, mesh), src_data_rank=None)
    return out


def init_params(cfg: ModelConfig, seed: int, device: torch.device, *,
                widen_head: bool = True) -> dict:
    """The port's own init: each leaf drawn on `device` from its own generator.

    The generator of a leaf is seeded with the crc32 of `"{seed}/{path}"`,
    as JAX folds a crc32 of the path into its key, so a leaf does not depend
    on the others. The values are NOT JAX's bits (torch cannot reproduce
    `jax.random`): parity tests take JAX's parameters through `from_jax`.
    `widen_head` holds `lm_head/w` in float32 (serving; see the module's
    docstring); training passes False.
    """
    params: dict = {}
    for path, pd in _walk(param_defs(cfg)):
        dtype = pd.dtype or cfg.pdtype
        if pd.init == "ones":
            t = torch.ones(pd.shape, dtype=dtype, device=device)
        elif pd.init == "zeros":
            t = torch.zeros(pd.shape, dtype=dtype, device=device)
        elif pd.init == "constant":
            t = torch.full(pd.shape, pd.constant, dtype=dtype, device=device)
        else:
            g = torch.Generator(device=device)
            g.manual_seed(zlib.crc32(f"{seed}/{path}".encode()) & 0x7FFFFFFF)
            t = torch.empty(pd.shape, dtype=dtype, device=device).normal_(0.0, pd.stddev, generator=g)
        _set(params, path, t.float() if widen_head and path == HEAD else t)
    return params


def from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor copy of a numpy array; ml_dtypes bfloat16 arrives through its bits."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a copy: JAX's buffers are read-only


def from_jax(params_np: dict, cfg: ModelConfig, device: torch.device, *,
             widen_head: bool = True) -> dict:
    """JAX's parameter pytree, already converted to numpy, as the port's tree.

    Values are copied bit for bit; with `widen_head` (serving) `lm_head/w`
    is widened to float32, which is exact. bfloat16 leaves may arrive as
    ml_dtypes bfloat16 arrays.
    """
    params: dict = {}
    for path, pd in _walk(param_defs(cfg)):
        a = _get(params_np, path)
        if tuple(a.shape) != pd.shape:
            raise ValueError(f"{path}: shape {a.shape} != {pd.shape}")
        dtype = torch.float32 if widen_head and path == HEAD else pd.dtype or cfg.pdtype
        _set(params, path, from_numpy(a).to(device=device, dtype=dtype))
    return params


def state_from_jax(state_np: dict, cfg: ModelConfig, device: torch.device) -> dict:
    """JAX's whole train state (numpy leaves) as the port's: `params` in JAX's
    dtypes (the head not widened), `opt` {m, v, step} with the `{q, s}` leaves of
    `adamw8bit`, and `grad_error` where present. Bit for bit."""
    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) else \
            from_numpy(np.asarray(t)).to(device)

    out = {"params": from_jax(state_np["params"], cfg, device, widen_head=False),
           "opt": tree(state_np["opt"])}
    if "grad_error" in state_np:
        out["grad_error"] = tree(state_np["grad_error"])
    return out


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


def unstacked_layers(params: dict, n: int) -> list[dict]:
    """Views of every layer of the stacked `(L, ...)` layer tree, through one
    `unbind` a leaf: under autograd each stacked leaf then gets its grad by one
    stack of the L layers' grads, not by L full-size scatters."""
    out: list[dict] = [{} for _ in range(n)]
    for path, t in _walk(params["layers"]):
        for i, view in enumerate(t.unbind(0)):
            _set(out[i], path, view)
    return out
