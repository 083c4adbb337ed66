"""RWKV6 "Finch": data-dependent-decay time mix and squared-ReLU channel mix.

Port of `repro.models.rwkv6`, which has no Pallas kernel: plain PyTorch on
every path. Attention-free: a per-head (dh x dh) float32 state, O(1) per
decoded token, no KV cache. The sequence path computes the linear recurrence
chunk by chunk (32 tokens): within a chunk as masked products through a
per-channel decay matrix whose exponents are backward cumulative log-decay
differences (<= 0, so `exp` never overflows), across chunks by a Python
loop over the carried state. Padding to a chunk multiple adds identity
steps, w = 1 and k = v = 0.

The decode functions update the state dicts they are given IN PLACE, as the
attention caches are.

On a mesh (JAX's shard sites: r, k and v on ("dp", None, "tp", None), each
mix's output on ("dp", "sp", None)) x stays on ("dp", "sp", None). Where
sequence parallelism splits it, each rank works on its own block of tokens, as
GSPMD keeps JAX's token-wise pad, ddlerp and channel mix: the token shift takes
the one row the block lacks from the previous block's rank (`axes.shift_rows`),
the ddlerp, the products, the decay and the whole channel mix run on the block
with the weights gathered whole (their gradients reduced back onto their
shards), and only r, k, v and w move to the heads layout, an all-to-all each,
for the chunk scan, the bonus `u` and the group norm on each rank's heads (`u`
and `ln_x` on their own shards); the scan's output moves back to the blocks
for the gate and the output projection. The state's shift row is the last
block's, broadcast (`axes.last_row`). Where nothing splits the sequence the
products run on the whole sequence against the weights' own shards, and the
output projection's partial sums meet in the closing `shard`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import group_norm_heads
from repro_torch.parallel.axes import (is_dtensor, last_row, on_local, on_shards, regrid, shard,
                                       shard_param, shift_rows, write)


def heads(cfg: ModelConfig):
    dh = cfg.ssm.head_dim
    return cfg.d_model // dh, dh


def _ddlerp(p: dict, x: torch.Tensor, xprev: torch.Tensor):
    """Data-dependent 5-way token-shift interpolation -> (xw, xk, xv, xr, xg)."""
    dt = x.dtype
    xx = xprev - x
    base = x + xx * p["maa_x"].to(dt)
    k5 = torch.tanh(base @ p["mix_w1"].to(dt))  # (..., 5k)
    k5 = k5.reshape(*k5.shape[:-1], 5, p["mix_w2"].shape[1])
    mixes = torch.einsum("...fk,fkd->...fd", k5, p["mix_w2"].to(dt)) + p["maa"].to(dt)
    out = x[..., None, :] + xx[..., None, :] * mixes  # (..., 5, d)
    return out.unbind(-2)


def _pinned(out: torch.Tensor) -> torch.Tensor:
    """A product's output (B, S, n), whole over the sequence, as its own layout: on a
    mesh the gradient comes back to it in this layout, not in one DTensor picks
    (split over the sequence too, or a partial sum reduced onto the tokens), which
    the product's backward would flatten into a strided shard of the tokens: one
    DTensor plans by a search over every mesh dim, and cannot always view back.
    Only where nothing splits the sequence: a split one runs on blocks."""
    return shard(out, "dp", None, None)


def _split(x: torch.Tensor) -> bool:
    """Whether mesh dims of more than one rank split x's sequence (dim 1): sequence
    parallelism in effect."""
    return is_dtensor(x) and any(isinstance(p, Shard) and p.dim == 1 and x.device_mesh.size(i) > 1
                                 for i, p in enumerate(x.placements))


def _whole(w: torch.Tensor, dt=None) -> torch.Tensor:
    """A weight cast to dt on its shards, then gathered whole on every rank."""
    w = w if dt is None else w.to(dt)
    return shard_param(w, *(None,) * w.dim())


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay in (0, 1), float32: w = exp(-exp(w0 + lora(xw)))."""
    dt = xw.dtype
    lora = torch.tanh(_pinned(xw @ p["w_a"].to(dt))) @ p["w_b"].to(dt)
    return torch.exp(-torch.exp(p["w0"] + lora.float()))


def _wkv_chunk_scan(r, k, v, w, u, chunk: int, init_state=None):
    """The chunked linear recurrence with a data-dependent per-channel decay.

    r, k, w: (B, S, H, K); v: (B, S, H, V); u: (H, K); all float32. The state
    S_t (H, K, V) = diag(w_t) S_{t-1} + k_t v_t^T, and out_t = r_t (S_{t-1} +
    diag(u) k_t v_t^T). Returns out (B, S, H, V) and the final state (B, H, K, V).
    """
    B, S, H, K = k.shape
    V = v.shape[-1]
    Q = min(chunk, S)
    S0 = S
    if S % Q:  # identity steps: w = 1 (no decay), k = v = 0 (no contribution)
        pad = Q - S % Q
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        S = S + pad
    nc = S // Q
    mask = torch.ones(Q, Q, dtype=torch.bool, device=k.device).tril(-1)  # j < i, strict
    state = (torch.zeros(B, H, K, V, dtype=torch.float32, device=k.device)
             if init_state is None else init_state)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        rc, kc, vc, wc = r[:, sl], k[:, sl], v[:, sl], w[:, sl]
        logw = torch.log(wc.clamp_min(1e-38))  # <= 0
        cum = logw.cumsum(1)  # (B, Q, H, K), decreasing
        cum_prev = cum - logw  # log prod_{t<i} w_t
        # intra-chunk: D[i, j] = exp(cum_prev_i - cum_j) for j < i (exponent <= 0)
        d = cum_prev[:, :, None] - cum[:, None, :]  # (B, i, j, H, K)
        d = d.masked_fill(~mask[None, :, :, None, None], float("-inf"))
        att = torch.einsum("bihk,bjhk,bijhk->bihj", rc, kc, torch.exp(d))
        y = torch.einsum("bihj,bjhv->bihv", att, vc)
        bonus = torch.einsum("bihk,hk,bihk->bih", rc, u, kc)  # the current token
        y = y + bonus[..., None] * vc
        y = y + torch.einsum("bihk,bhkv->bihv", rc * torch.exp(cum_prev), state)
        k_tail = kc * torch.exp(cum[:, -1:] - cum)  # exponents <= 0
        s_loc = torch.einsum("bjhk,bjhv->bhkv", k_tail, vc)
        state = torch.exp(cum[:, -1])[..., None] * state + s_loc
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S0], state


def _shift(x: torch.Tensor) -> torch.Tensor:
    """(x, the token shift of x (B, S, D): row t - 1 at t, zeros at 0). On a mesh x on
    ("dp", "sp", None), each rank shifting its own block, row 0 of it the
    previous block's last row (`shift_rows`); on ("dp", None, None) where no
    more than one rank splits the sequence."""
    x = shard(x, "dp", "sp", None)
    if not _split(x):
        x = shard(x, "dp", None, None)
    return x, shift_rows(x)


def _mixes(p: dict, x: torch.Tensor, xprev: torch.Tensor):
    """`_ddlerp` on each rank's rows (its weights replicated)."""
    keys = ("maa_x", "maa", "mix_w1", "mix_w2")
    return on_shards(lambda a, b, *w: _ddlerp(dict(zip(keys, w)), a, b), x, xprev,
                     params=tuple(p[k] for k in keys), n_out=5)


def _heads(t: torch.Tensor, H: int, dh: int) -> torch.Tensor:
    """(..., D) as (..., H, dh), the heads on tp (JAX's `shard(r, "dp", None, "tp", None)`)."""
    t = t.reshape(*t.shape[:-1], H, dh)
    return shard(t, "dp", *(None,) * (t.dim() - 3), "tp", None)


def _group_norm(p: dict, o: torch.Tensor) -> torch.Tensor:
    """`group_norm_heads` on each rank's heads, ln_x's gains on their own shards."""
    return on_shards(lambda t, s, b: group_norm_heads({"scale": s, "bias": b}, t), o,
                     params=(shard(p["ln_x"]["scale"], "tp"), shard(p["ln_x"]["bias"], "tp")))


def _block_products(p: dict, xw, xk, xv, xr, xg):
    """(xr @ wr, xk @ wk, xv @ wv, silu(xg @ wg), the decay) on each rank's block of
    tokens, from the weights gathered whole."""
    dt = xr.dtype
    keys = ("wr", "wk", "wv", "wg", "w_a", "w_b")

    def fn(xw, xk, xv, xr, xg, wr, wk, wv, wg, wa, wb, w0):
        return (xr @ wr, xk @ wk, xv @ wv, F.silu(xg @ wg),
                _decay({"w_a": wa, "w_b": wb, "w0": w0}, xw))

    return on_shards(fn, xw, xk, xv, xr, xg,
                     params=(*(_whole(p[k], dt) for k in keys), _whole(p["w0"])), n_out=5)


def time_mix_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, chunk: int = 32):
    """x: (B, S, D) -> (out (B, S, D), {"wkv" (B, H, dh, dh) fp32, "shift" (B, D)}).
    On a mesh the chunk scan and the group norm run on each rank's heads, and
    where the sequence is split the rest on each rank's block of it."""
    H, dh = heads(cfg)
    B, S, D = x.shape
    dt = x.dtype
    x, xprev = _shift(x)
    xw, xk, xv, xr, xg = _mixes(p, x, xprev)
    if _split(x):
        r, k, v, g, w = _block_products(p, xw, xk, xv, xr, xg)
        r, k, v, w = (_heads(t, H, dh) for t in (r, k, v, w))
    else:
        r = _heads(xr @ p["wr"].to(dt), H, dh)
        k = _heads(xk @ p["wk"].to(dt), H, dh)
        v = _heads(xv @ p["wv"].to(dt), H, dh)
        g = F.silu(xg @ p["wg"].to(dt))
        w = _heads(_decay(p, xw), H, dh)
    pl = getattr(r, "placements", None)  # (B, S, H, K): out alike, the state (B, H, K, V)
    out, state = on_local(lambda *t: _wkv_chunk_scan(*t, chunk), r.float(), k.float(), v.float(),
                          w, shard(p["u"], "tp", None), out=[pl, regrid(pl, {0: 0, 2: 1})])
    out = _group_norm(p, out.to(dt)).reshape(B, S, D)
    if _split(x):  # back to the blocks, an all-to-all, for the gate and the projection
        out = on_shards(lambda o, g_, wo: (o * g_) @ wo, shard(out, "dp", "sp", None), g,
                        params=(_whole(p["wo"], dt),))
    else:
        out = _pinned((out * g) @ p["wo"].to(dt))
    return shard(out, "dp", "sp", None), {"wkv": state, "shift": last_row(x)}


def _wkv_step(r, k, v, w, S_, u):
    """One token of the recurrence on the heads given: `S_` (B, H, K, V) advanced in
    place; returns out (B, H, V)."""
    a = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, S_ + u[None, :, :, None] * a)
    S_.copy_(w[..., None] * S_ + a)
    return o


def time_mix_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict) -> torch.Tensor:
    """x: (B, 1, D) -> out (B, 1, D); `state` {"wkv", "shift"} updated in place (on a
    mesh each rank's heads of "wkv", per `rwkv6_state_specs`)."""
    H, dh = heads(cfg)
    B, _, D = x.shape
    dt = x.dtype
    xt = x[:, 0]
    xw, xk, xv, xr, xg = _mixes(p, xt, state["shift"])
    r = _heads(xr @ p["wr"].to(dt), H, dh).float()
    k = _heads(xk @ p["wk"].to(dt), H, dh).float()
    v = _heads(xv @ p["wv"].to(dt), H, dh).float()
    g = F.silu(xg @ p["wg"].to(dt))
    w = _heads(_decay(p, xw), H, dh)
    o = on_local(_wkv_step, r, k, v, w, state["wkv"], shard(p["u"], "tp", None),
                 out=[getattr(r, "placements", None)])
    write(state["shift"], xt)
    o = _group_norm(p, o.to(dt).reshape(B, 1, H, dh))
    return ((o.reshape(B, D) * g) @ p["wo"].to(dt))[:, None, :]


def _channel_mix(p: dict, x: torch.Tensor, xprev: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xx = xprev - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    vk = _pinned(F.relu(xk @ p["wk"].to(dt)).square() @ p["wv"].to(dt))
    return torch.sigmoid(xr @ p["wr"].to(dt)) * vk


def channel_mix_seq(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (out, {"shift" (B, D)}). Where the sequence is split, all of it
    on each rank's block, from the weights gathered whole."""
    x, xprev = _shift(x)
    if _split(x):
        keys = ("mu_k", "mu_r", "wk", "wv", "wr")
        out = on_shards(lambda a, b, *w: _channel_mix(dict(zip(keys, w)), a, b), x, xprev,
                        params=tuple(_whole(p[k], x.dtype) for k in keys))
    else:
        out = _pinned(_channel_mix(p, x, xprev))
    return shard(out, "dp", "sp", None), {"shift": last_row(x)}


def channel_mix_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict) -> torch.Tensor:
    """x: (B, 1, D) -> out (B, 1, D); `state` {"shift"} updated in place."""
    xt = x[:, 0]
    out = _channel_mix(p, xt, state["shift"])
    write(state["shift"], xt)
    return out[:, None, :]


def init_rwkv6_state(cfg: ModelConfig, batch: int, device) -> dict:
    H, dh = heads(cfg)
    D, dt = cfg.d_model, cfg.compute_dtype
    return {
        "tm": {"wkv": torch.zeros(batch, H, dh, dh, dtype=torch.float32, device=device),
               "shift": torch.zeros(batch, D, dtype=dt, device=device)},
        "cm": {"shift": torch.zeros(batch, D, dtype=dt, device=device)},
    }


def rwkv6_state_specs(cfg: ModelConfig) -> dict:
    """The logical axes of the decode state, JAX's `rwkv6_state_specs`."""
    return {"tm": {"wkv": ("dp", "tp", None, None), "shift": ("dp", None)},
            "cm": {"shift": ("dp", None)}}
