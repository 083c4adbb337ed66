"""GQA attention: full-sequence, prefill with a KV cache, and one-token decode over it.

Port of `repro.models.attention`. With `kernels=True` (the model's default)
the q/k norms run through the RMSNorm kernel, prefill through the
flash-attention kernel and decode through the flash-decode kernel; on CPU
tensors those wrappers run their plain versions. With `kernels=False` the
plain PyTorch path below runs on any device; it is the oracle the kernels
are held to on the card. `self_attention` (training) chooses its path as
JAX's does; see there. On a mesh (training) the heads shard over tp: the
qk-norms, RoPE and the attention core run on each rank's local heads
(`on_shards`), and the output projection's partial sums meet in JAX's
`shard(out, "dp", "sp", None)`.

Caches keep JAX's layout, (B, W, Hkv, dh), so parity tests compare like with
like; the kernels read them through strides. Unlike JAX, which returns new
arrays, caches are updated IN PLACE (JAX donates them to the same effect).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.flash_vjp import flash_attention_vjp
from repro_torch.models.layers import apply_rope, rms_head_norm
from repro_torch.parallel.axes import axes_size, is_dtensor, on_shards, shard

NEG_INF = -1e30


def _head_norm(scale: torch.Tensor, x: torch.Tensor, kernels: bool) -> torch.Tensor:
    """The qk-norm over each head's dh, on the local heads on a mesh."""
    if kernels:
        return on_shards(lambda t, s: rms_ops.rmsnorm(t, s, eps=1e-6), x, params=(scale,))
    return on_shards(lambda t, s: rms_head_norm(s, t), x, params=(scale,))


def _heads(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor, H: int) -> torch.Tensor:
    """x @ w as (B, S, H, dh). On a mesh the heads stay sharded over tp only where tp
    divides the kv heads, as q, k and v must be split alike (GSPMD pads the rest)."""
    B, S, _ = x.shape
    t = x @ w.to(x.dtype)
    if is_dtensor(t) and cfg.num_kv_heads % axes_size("tp"):
        t = shard(t, "dp", None, None)
    return t.view(B, S, H, cfg.head_dim)


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                 kernels: bool = True):
    """x: (B, S, D) -> q (B,S,Hkv,G,dh), k/v (B,S,Hkv,dh), RoPE'd + qk-normed."""
    B, S, _ = x.shape
    Hq, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _heads(cfg, x, p["wq"], Hq)
    k = _heads(cfg, x, p["wk"], Hkv)
    v = _heads(cfg, x, p["wv"], Hkv)
    if cfg.qk_norm:
        q = _head_norm(p["q_norm"], q, kernels)
        k = _head_norm(p["k_norm"], k, kernels)
    q = on_shards(lambda t: apply_rope(t, positions, cfg.rope_theta), q)
    k = on_shards(lambda t: apply_rope(t, positions, cfg.rope_theta), k)
    # heads shard over tp; seq stays unsharded here (sequence parallelism applies
    # only to the norm / residual regions)
    q = shard(q.view(B, S, Hkv, Hq // Hkv, dh), "dp", None, "tp", None, None)
    k = shard(k, "dp", None, "tp", None)
    v = shard(v, "dp", None, "tp", None)
    return q, k, v


def _dense_attention(q, k, v, q_pos, k_pos, window):
    """Plain O(S*T) attention. q: (B,S,Hkv,G,dh); k/v: (B,T,Hkv,dh)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    mask = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def _causal_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, kernels: bool):
    """Causal attention over the whole sequence: (out (B, S, D), k, v (B, S, Hkv, dh))."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, pos, kernels)
    if kernels:
        out = fa_ops.flash_attention(q, k, v, window=cfg.sliding_window)
    else:
        out = _dense_attention(q, k, v, pos, pos, cfg.sliding_window)
    return out.reshape(B, S, cfg.q_dim) @ p["wo"].to(out.dtype), k, v


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   kernels: bool = True) -> torch.Tensor:
    """Full-sequence causal attention (`Model.forward`, training): x (B, S, D) -> (B, S, D).

    Dispatches as JAX's does: dense attention when `attn_impl == "dense"` or
    S <= `attn_chunk`, else the flash VJP (`models/flash_vjp.py`): the CUDA
    forward and backward kernels on CUDA with `kernels`, any S; otherwise
    its plain twin, which needs S to be a multiple of `attn_chunk`, as JAX's
    does, and stays O(S * chunk) in memory.
    """
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, pos, kernels)
    if cfg.attn_impl == "dense" or S <= cfg.attn_chunk:
        out = on_shards(lambda *t: _dense_attention(*t, pos, pos, cfg.sliding_window), q, k, v)
    else:
        out = flash_attention_vjp(q, k, v, cfg.sliding_window, cfg.attn_chunk, kernels=kernels)
    out = out.reshape(B, S, cfg.q_dim) @ p["wo"].to(out.dtype)
    return shard(out, "dp", "sp", None)


# ----------------------------------------------------------------- KV caching
def cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    shp = (batch, cache_len(cfg, max_len), cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shp, dtype=cfg.compute_dtype, device=device),
        "v": torch.zeros(shp, dtype=cfg.compute_dtype, device=device),
    }


def prefill_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, max_len: int,
                      cache: dict | None = None, kernels: bool = True):
    """Full-sequence causal attention that also fills a decode-ready KV cache.

    Token t lands in cache slot t (full) or t % W (ring buffer, SWA). `cache`,
    if given, is a zeroed {"k", "v"} of (B, W, Hkv, dh) filled in place.
    Returns (out (B, S, D), cache).
    """
    B, S, _ = x.shape
    out, k, v = _causal_attention(cfg, p, x, kernels)

    W = cache_len(cfg, max_len)
    if cache is None:
        cache = init_attn_cache(cfg, B, max_len, x.device)
    if cfg.sliding_window is not None and S > W:
        # keep the last W tokens, permuted into ring order (slot = t mod W)
        tail_t = torch.arange(S - W, S, device=x.device)
        slots = torch.argsort(tail_t % W)
        cache["k"].copy_(k[:, tail_t][:, slots])
        cache["v"].copy_(v[:, tail_t][:, slots])
    elif S > W:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of {W}")
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    return out, cache


def decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict, pos: int,
                     kernels: bool = True):
    """One-token decode. x: (B, 1, D); pos: host int index of the current token.

    Writes the token's k/v into `cache` in place; returns (out (B, 1, D), cache).
    """
    B = x.shape[0]
    Hq, dh = cfg.num_heads, cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, kernels)

    K, V = cache["k"], cache["v"]
    W = K.shape[1]
    if cfg.sliding_window is None and pos >= W:
        raise ValueError(f"decode position {pos} is past the cache length {W}")
    write = pos % W
    K[:, write] = k[:, 0]
    V[:, write] = v[:, 0]

    if kernels:
        # the softmax does not depend on slot order, so the ring's valid slots
        # are exactly the first min(pos + 1, W)
        out = decode_ops.decode_attention_cache(q, K, V, min(pos + 1, W))
    else:
        slot = torch.arange(W, device=x.device)
        if cfg.sliding_window is not None:
            # slot i holds token t = pos - ((pos - i) mod W); valid iff t >= 0
            valid = pos - torch.remainder(pos - slot, W) >= 0
        else:
            valid = slot <= pos
        s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), K.float()) * dh**-0.5
        s = torch.where(valid, s, torch.tensor(NEG_INF, device=s.device))
        pr = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", pr.to(V.dtype), V)
    out = out.reshape(B, 1, Hq * dh) @ p["wo"].to(x.dtype)
    return out, cache
