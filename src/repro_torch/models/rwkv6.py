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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import group_norm_heads


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


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay in (0, 1), float32: w = exp(-exp(w0 + lora(xw)))."""
    dt = xw.dtype
    lora = torch.tanh(xw @ p["w_a"].to(dt)) @ p["w_b"].to(dt)
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


def time_mix_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, chunk: int = 32):
    """x: (B, S, D) -> (out (B, S, D), {"wkv" (B, H, dh, dh) fp32, "shift" (B, D)})."""
    H, dh = heads(cfg)
    B, S, D = x.shape
    dt = x.dtype
    xprev = F.pad(x, (0, 0, 1, 0))[:, :S]
    xw, xk, xv, xr, xg = _ddlerp(p, x, xprev)
    r = (xr @ p["wr"].to(dt)).reshape(B, S, H, dh)
    k = (xk @ p["wk"].to(dt)).reshape(B, S, H, dh)
    v = (xv @ p["wv"].to(dt)).reshape(B, S, H, dh)
    g = F.silu(xg @ p["wg"].to(dt))
    w = _decay(p, xw).reshape(B, S, H, dh)
    out, state = _wkv_chunk_scan(r.float(), k.float(), v.float(), w, p["u"], chunk)
    out = group_norm_heads(p["ln_x"], out.to(dt))
    return (out.reshape(B, S, D) * g) @ p["wo"].to(dt), {"wkv": state, "shift": x[:, -1]}


def time_mix_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict) -> torch.Tensor:
    """x: (B, 1, D) -> out (B, 1, D); `state` {"wkv", "shift"} updated in place."""
    H, dh = heads(cfg)
    B, _, D = x.shape
    dt = x.dtype
    xt = x[:, 0]
    xw, xk, xv, xr, xg = _ddlerp(p, xt, state["shift"])
    r = (xr @ p["wr"].to(dt)).reshape(B, H, dh).float()
    k = (xk @ p["wk"].to(dt)).reshape(B, H, dh).float()
    v = (xv @ p["wv"].to(dt)).reshape(B, H, dh).float()
    g = F.silu(xg @ p["wg"].to(dt))
    w = _decay(p, xw).reshape(B, H, dh)
    S_ = state["wkv"]  # (B, H, K, V)
    a = torch.einsum("bhk,bhv->bhkv", k, v)
    o = torch.einsum("bhk,bhkv->bhv", r, S_ + p["u"][None, :, :, None] * a)
    S_.copy_(w[..., None] * S_ + a)
    state["shift"].copy_(xt)
    o = group_norm_heads(p["ln_x"], o.to(dt).reshape(B, 1, H, dh))
    return ((o.reshape(B, D) * g) @ p["wo"].to(dt))[:, None, :]


def _channel_mix(p: dict, x: torch.Tensor, xprev: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    xx = xprev - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    vk = F.relu(xk @ p["wk"].to(dt)).square() @ p["wv"].to(dt)
    return torch.sigmoid(xr @ p["wr"].to(dt)) * vk


def channel_mix_seq(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (out, {"shift" (B, D)})."""
    xprev = F.pad(x, (0, 0, 1, 0))[:, :x.shape[1]]
    return _channel_mix(p, x, xprev), {"shift": x[:, -1]}


def channel_mix_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict) -> torch.Tensor:
    """x: (B, 1, D) -> out (B, 1, D); `state` {"shift"} updated in place."""
    xt = x[:, 0]
    out = _channel_mix(p, xt, state["shift"])
    state["shift"].copy_(xt)
    return out[:, None, :]


def init_rwkv6_state(cfg: ModelConfig, batch: int, device) -> dict:
    H, dh = heads(cfg)
    D, dt = cfg.d_model, cfg.compute_dtype
    return {
        "tm": {"wkv": torch.zeros(batch, H, dh, dh, dtype=torch.float32, device=device),
               "shift": torch.zeros(batch, D, dtype=dt, device=device)},
        "cm": {"shift": torch.zeros(batch, D, dtype=dt, device=device)},
    }
