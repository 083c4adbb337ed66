"""GQA attention: full-sequence, prefill with a KV cache, and one-token decode over it.

Port of `repro.models.attention`. With `kernels=True` (the model's default)
the q/k norms run through the RMSNorm kernel, prefill through the
flash-attention kernel and decode through the flash-decode kernel; on CPU
tensors those wrappers run their plain versions. With `kernels=False` the
plain PyTorch path below runs on any device; it is the oracle the kernels
are held to on the card. `self_attention` (training) chooses its path as
JAX's does; see there. On a mesh the heads shard over tp: the qk-norms,
RoPE and the attention core run on each rank's local heads (`on_shards`),
and the output projection's partial sums meet in JAX's `shard(out, "dp",
"sp", None)`. Where tp does not divide the kv heads, training and prefill pad
them with zero heads to a multiple of tp, as GSPMD pads JAX's head split
(`kv_heads_split`): each rank holds ceil(Hkv / tp) kv heads with their G
query heads, and runs the projections on those heads' columns of the
weights; decode, whose q is one token, keeps them whole. A KV cache on a
mesh is placed per `cache_axes` (JAX's): its kv heads on tp where tp divides
them, its length on cp (and on tp where the heads do not divide); decode
then runs the kernel on each rank's slots and joins the ranks' partial
outputs by their log-sum-exps (`lse_combine`).

Caches keep JAX's layout, (B, W, Hkv, dh), so parity tests compare like with
like; the kernels read them through strides. Unlike JAX, which returns new
arrays, caches are updated IN PLACE (JAX donates them to the same effect).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.flash_vjp import flash_attention_vjp
from repro_torch.models.layers import apply_rope, rms_head_norm
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.parallel.axes import (axes_size, is_dtensor, logical_spec, lse_combine, on_local,
                                       on_shards, shard, shard_param, shard_range, zeros)

NEG_INF = -1e30


def _head_norm(scale: torch.Tensor, x: torch.Tensor, kernels: bool) -> torch.Tensor:
    """The qk-norm over each head's dh, on the local heads on a mesh."""
    if kernels:
        return on_shards(lambda t, s: rms_ops.rmsnorm(t, s, eps=1e-6), x, params=(scale,))
    return on_shards(lambda t, s: rms_head_norm(s, t), x, params=(scale,))


def kv_heads_split(cfg: ModelConfig, x: torch.Tensor) -> int:
    """The kv heads that q, k and v are split into over tp on a mesh: Hkv, padded with
    zero heads to a multiple of tp where tp does not divide it, as GSPMD pads JAX's
    `shard(q, "dp", None, "tp", None, None)`, so that each rank holds ceil(Hkv / tp)
    kv heads with their G query heads; Hkv off a mesh."""
    Hkv = cfg.num_kv_heads
    if not is_dtensor(x):
        return Hkv
    tp = axes_size("tp")
    return -(-Hkv // tp) * tp


def _pad_heads(w: torch.Tensor, H: int, Hp: int, dim: int) -> torch.Tensor:
    """A projection weight whose flat dim `dim` holds H heads, widened with zero heads
    to Hp and split by head over tp: gathered whole first (its tp split of the flat
    dim does not line up with heads), each rank then keeping its own heads; w as it
    is where Hp = H. The zero heads' q, k and v are 0, their attention output 0, and
    their rows of the output projection 0: they add nothing."""
    if Hp == H:
        return w
    per = w.shape[dim] // H
    w = shard_param(w, None, None)
    pad = [0, 0] * (1 - dim) + [0, (Hp - H) * per]
    w = on_local(lambda t: torch.nn.functional.pad(t, pad), w, out=[w.placements])
    return shard(w, *(("tp", None) if dim == 0 else (None, "tp")))


def _heads(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor, H: int, Hkv: int) -> torch.Tensor:
    """x @ w as (B, S, H, dh), of `Hkv` kv heads. On a mesh the heads stay sharded over
    tp only where tp divides those kv heads, as q, k and v must be split alike."""
    B, S, _ = x.shape
    t = x @ w.to(x.dtype)
    if is_dtensor(t) and Hkv % axes_size("tp"):
        t = shard(t, "dp", None, None)
    return t.view(B, S, H, cfg.head_dim)


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
                 kernels: bool = True, pad: bool = False):
    """x: (B, S, D) -> q (B,S,Hkv,G,dh), k/v (B,S,Hkv,dh), RoPE'd + qk-normed. With
    `pad`, on a mesh, over `kv_heads_split` kv heads (zero heads after the real
    ones where tp does not divide Hkv); without it such heads are whole on
    every rank."""
    B, S, _ = x.shape
    Hkv, G, dh = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim
    Hp = kv_heads_split(cfg, x) if pad else Hkv
    q = _heads(cfg, x, _pad_heads(p["wq"], Hkv, Hp, 1), Hp * G, Hp)
    k = _heads(cfg, x, _pad_heads(p["wk"], Hkv, Hp, 1), Hp, Hp)
    v = _heads(cfg, x, _pad_heads(p["wv"], Hkv, Hp, 1), Hp, Hp)
    if cfg.qk_norm:
        q = _head_norm(p["q_norm"], q, kernels)
        k = _head_norm(p["k_norm"], k, kernels)
    q = on_shards(lambda t: apply_rope(t, positions, cfg.rope_theta), q)
    k = on_shards(lambda t: apply_rope(t, positions, cfg.rope_theta), k)
    # heads shard over tp; seq stays unsharded here (sequence parallelism applies
    # only to the norm / residual regions)
    q = shard(q.view(B, S, Hp, G, dh), "dp", None, "tp", None, None)
    k = shard(k, "dp", None, "tp", None)
    v = shard(v, "dp", None, "tp", None)
    return q, k, v


def _out_proj(cfg: ModelConfig, p: dict, out: torch.Tensor) -> torch.Tensor:
    """The row-parallel output projection of the attention output (B, S, Hp, G, dh),
    its kv heads `kv_heads_split`'s: `wo` padded alike."""
    B, S, Hp = out.shape[:3]
    wo = _pad_heads(p["wo"], cfg.num_kv_heads, Hp, 0)
    return out.reshape(B, S, -1) @ wo.to(out.dtype)


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
    q, k, v = _project_qkv(cfg, p, x, pos, kernels, pad=True)
    if kernels:
        out = on_shards(lambda *t: fa_ops.flash_attention(*t, window=cfg.sliding_window), q, k, v)
    elif cfg.attn_impl == "dense" or S <= cfg.attn_chunk or S % cfg.attn_chunk:
        out = on_shards(lambda *t: _dense_attention(*t, pos, pos, cfg.sliding_window), q, k, v)
    else:
        # JAX's prefill takes its chunked attention here (online softmax over
        # chunks, never more than a chunk's scores); the plain flash twin computes
        # the same function (JAX asserts S a multiple of the chunk, the port keeps
        # the dense path for other lengths)
        out = flash_attention_vjp(q, k, v, cfg.sliding_window, cfg.attn_chunk, kernels=False)
    return _out_proj(cfg, p, out), k, v


def self_attention(cfg: ModelConfig, p: dict, x: torch.Tensor,
                   kernels: bool = True) -> torch.Tensor:
    """Full-sequence causal attention (`Model.forward`, training): x (B, S, D) -> (B, S, D).

    Dispatches as JAX's does: dense attention when `attn_impl == "dense"` or
    S <= `attn_chunk`, else the flash VJP (`models/flash_vjp.py`): the CUDA
    forward and backward kernels on CUDA with `kernels`, any S; otherwise
    its plain twin, which needs S to be a multiple of `attn_chunk`, as JAX's
    does, and stays O(S * chunk) in memory.
    """
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, pos, kernels, pad=True)
    if cfg.attn_impl == "dense" or S <= cfg.attn_chunk:
        out = on_shards(lambda *t: _dense_attention(*t, pos, pos, cfg.sliding_window), q, k, v)
    else:
        out = flash_attention_vjp(q, k, v, cfg.sliding_window, cfg.attn_chunk, kernels=kernels)
    return shard(_out_proj(cfg, p, out), "dp", "sp", None)


# ----------------------------------------------------------------- KV caching
def cache_len(cfg: ModelConfig, max_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def cache_axes(cfg: ModelConfig, cp: bool = False) -> tuple:
    """The logical axes of a (B, W, Hkv, dh) KV cache under the current rules, JAX's:
    the kv heads on tp where tp divides them, the length on cp with `cp`;
    otherwise tp moves to the length dim (with cp ahead of it), so that a cache
    whose heads do not divide is split by length rather than replicated, and
    decode combines the ranks' partial softmaxes (`lse_combine`)."""
    tp = axes_size("tp")
    if tp > 1 and cfg.num_kv_heads % tp == 0:
        return ("dp", "cp" if cp else None, "tp", None)
    return ("dp", ("cp", "tp") if cp else "tp", None, None)


def attn_cache_specs(cfg: ModelConfig, cp: bool = False) -> dict:
    ax = cache_axes(cfg, cp)
    return {"k": ax, "v": ax}


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, device, cp: bool = False) -> dict:
    """A zeroed {"k", "v"} of (B, W, Hkv, dh), on a mesh placed per `cache_axes(cfg, cp)`."""
    shp = (batch, cache_len(cfg, max_len), cfg.num_kv_heads, cfg.head_dim)
    spec = logical_spec(*cache_axes(cfg, cp))
    return {k: zeros(shp, cfg.compute_dtype, device, spec) for k in ("k", "v")}


def _local_like(t: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """This rank's part of a (B, S, Hkv, ...) DTensor `t` with its batch and heads
    placed as the cache `K`'s and its sequence whole; `t` itself off a mesh."""
    if not is_dtensor(K):
        return t
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in K.placements]
    return t.redistribute(K.device_mesh, pl).to_local()


def _fill_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, ring: torch.Tensor | None):
    """Write the prompt's k, v (B, S, Hkv, dh) into the zeroed cache: token t at slot t,
    or with `ring` (the slots' tokens) the ring's W tokens; each rank its own slots."""
    K = cache["k"]
    lo, n, _ = shard_range(K, 1)
    for name, t in (("k", k), ("v", v)):
        t = _local_like(t, K)[:, :, :K.shape[2]]  # without `kv_heads_split`'s zero heads
        if ring is not None:
            t = t[:, ring]
        dst = cache[name].to_local() if is_dtensor(cache[name]) else cache[name]
        hi = min(lo + n, t.shape[1])
        if hi > lo:
            dst[:, :hi - lo] = t[:, lo:hi]


def prefill_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, max_len: int,
                      cache: dict | None = None, kernels: bool = True, cp: bool = False):
    """Full-sequence causal attention that also fills a decode-ready KV cache.

    Token t lands in cache slot t (full) or t % W (ring buffer, SWA). `cache`,
    if given, is a zeroed {"k", "v"} of (B, W, Hkv, dh), filled in place: on a
    mesh, placed per `cache_axes`, each rank writes its own slots and heads.
    Returns (out (B, S, D), cache).
    """
    B, S, _ = x.shape
    out, k, v = _causal_attention(cfg, p, x, kernels)

    W = cache_len(cfg, max_len)
    if cache is None:
        cache = init_attn_cache(cfg, B, max_len, x.device, cp)
    ring = None
    if cfg.sliding_window is not None and S > W:
        # keep the last W tokens, permuted into ring order (slot = t mod W)
        tail_t = torch.arange(S - W, S, device=x.device)
        ring = tail_t[torch.argsort(tail_t % W)]
    elif S > W:
        raise ValueError(f"prompt of {S} tokens does not fit a cache of {W}")
    _fill_cache(cache, k, v, ring)
    return out, cache


def _decode_part(q, K, V, n_valid: int, kernels: bool):
    """(out (B, 1, Hkv, G, dh), lse (B, 1, Hkv, G) float32) of q over the first
    `n_valid` slots of a cache part; with none valid, out 0 and lse NEG_INF, no
    launch (the kernel refuses n_valid = 0)."""
    if n_valid == 0:
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device))
    if kernels:
        return decode_ops.decode_attention_cache(q, K, V, n_valid, lse=True)
    B, _, Hkv, G, dh = q.shape
    out, lse = decode_attention_ref(q.reshape(B, Hkv, G, dh), K.transpose(1, 2), V.transpose(1, 2),
                                    n_valid, lse=True)
    return out.view(B, 1, Hkv, G, dh), lse.view(B, 1, Hkv, G)


def decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict, pos: int,
                     kernels: bool = True):
    """One-token decode. x: (B, 1, D); pos: host int index of the current token.

    Writes the token's k/v into `cache` in place; returns (out (B, 1, D), cache).
    On a mesh, placed per `cache_axes`: the rank that holds slot `pos % W`
    writes it, each rank attends over its own slots and heads, and where the
    length is split the ranks join their partial outputs by their log-sum-exps
    (`lse_combine`; a rank with no valid slot contributes none).
    """
    B = x.shape[0]
    Hq, dh = cfg.num_heads, cfg.head_dim
    # (S,) positions, S = 1: they broadcast over the batch, which a mesh may split
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, positions, kernels)

    K, V = cache["k"], cache["v"]
    W = K.shape[1]
    if cfg.sliding_window is None and pos >= W:
        raise ValueError(f"decode position {pos} is past the cache length {W}")
    write = pos % W
    if is_dtensor(K):
        return _decode_on_mesh(cfg, p, q, k, v, cache, pos, kernels), cache
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


def _decode_on_mesh(cfg, p, q, k, v, cache, pos: int, kernels: bool):
    """`decode_attention` on a placed cache: (out (B, 1, D))."""
    B = q.shape[0]
    K, V = cache["k"], cache["v"]
    W = K.shape[1]
    lo, n, dims = shard_range(K, 1)
    Kl, Vl = K.to_local(), V.to_local()
    if lo <= pos % W < lo + n:  # this rank holds the slot
        Kl[:, pos % W - lo] = _local_like(k, K)[:, 0]
        Vl[:, pos % W - lo] = _local_like(v, K)[:, 0]
    # the ring's valid slots are its first min(pos + 1, W) (the softmax does not
    # depend on slot order): this rank's are those of its part
    n_valid = min(max(min(pos + 1, W) - lo, 0), n)
    ql = _local_like(q, K)
    out, lse = _decode_part(ql, Kl, Vl, n_valid, kernels)
    out = lse_combine(out, lse, K.device_mesh, dims).to(q.dtype)
    pl = [Replicate() if isinstance(p_, Shard) and p_.dim == 1 else p_ for p_ in K.placements]
    out = DTensor.from_local(out, K.device_mesh, pl, run_check=False)
    return out.reshape(B, 1, cfg.q_dim) @ p["wo"].to(q.dtype)
