"""Mixture-of-Experts with capacity-bounded gather/scatter dispatch.

Port of `repro.models.moe` (no Pallas kernel there: the expert products are
`jnp.einsum`, so here they are `torch.bmm`). Assignments are sorted by
expert (a stable sort, so a token's priority within an expert is its flat
index), each is given its position within its expert from the exclusive
cumulative counts, and rows are scattered into a static (E, C+1, D) buffer:
row C is the overflow scratch row, so a dropped assignment needs no dynamic
shape, and reading row C of the padded output gives it zeros.

Groups. As JAX, the port dispatches within G groups of contiguous tokens, G
being the size of the dp mesh axes (`_n_groups`), which is 1 off a mesh; the
capacity C is computed from a group's T / G tokens (T = B * S of the call, so
prefill, decode and `forward` each have their own C), and the load-balance
statistics are averaged over the groups. On a mesh each dp shard routes its
own group, and the experts shard over ep (`_moe_mesh`).

No host synchronisation: the expert counts come from `scatter_add_` over E
bins (not `bincount`, which reads the input's max on CUDA), and there is no
boolean-mask indexing, `nonzero` or `.item()` in the layer.

Combine (`combine`). JAX adds each assignment's weighted row into its
token with `.at[token_of].add` over the sorted assignments, which XLA's CPU
scatter does one update at a time in update order, rounding after each add.
The port reproduces that order and rounding bit for bit: a token's K rows
in ascending sorted position (ascending expert id), the first taken as is
and the others added one at a time in the compute dtype. It is K - 1
elementwise adds of (T, D), deterministic (a CUDA `index_add_` in bf16 adds
in a varying order), with no host synchronisation.

`routing_record()` keeps, while it is open, each call's routing: the top-k
expert ids and, per token, the gap between the k-th and (k+1)-th router
probability. It is off by default and keeps nothing then.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoECfg
from repro_torch.models.layers import activation
from repro_torch.models.mlp import apply_mlp
from repro_torch.parallel.axes import axes_size, is_dtensor, on_shards, shard

_RECORD: list | None = None  # the open routing record, if any
STATS = ("me", "ce", "z", "drop")  # a dispatch group's load-balance statistics


@contextlib.contextmanager
def routing_record():
    """Yields a list that gets one (top-k ids (T, K), gap (T,)) pair a layer call."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def capacity(m: MoECfg, tokens: int) -> int:
    """Static per-expert capacity."""
    c = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
    return max(c, m.top_k)


def _route(m: MoECfg, xf: torch.Tensor, router: torch.Tensor):
    """Router logits and probabilities in float32, and the (renormalised) top-k."""
    logits = xf.float() @ router  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, topi = torch.topk(probs, m.top_k, dim=-1)
    if m.norm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    if _RECORD is not None:
        top = torch.topk(probs, m.top_k + 1, dim=-1).values
        _RECORD.append((topi, top[:, -2] - top[:, -1]))
    return logits, probs, gate, topi


def combine(vals: torch.Tensor, w: torch.Tensor, order: torch.Tensor, T: int, K: int):
    """JAX's `zeros((T, D)).at[order // K].add(vals * w[:, None])`, rounding for rounding.

    vals (A, D) and w (A,) are in sorted order; sorted position i holds the
    assignment order[i] of token order[i] // K. Each token's K weighted rows
    are added in ascending sorted position, one add at a time in vals' dtype.
    """
    A = order.shape[0]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(A, device=order.device)  # the sorted position of each assignment
    rows = (vals * w[:, None])[rank.view(T, K).sort(-1).values]  # (T, K, D)
    y = rows[:, 0]
    for j in range(1, K):
        y = y + rows[:, j]
    return y


def _n_groups(T: int) -> int:
    """Dispatch groups = the data-shard count (GShard-style grouping), 1 off a mesh:
    routing, sort and scatter / gather happen within a group of T / G contiguous
    tokens, with a capacity of its own."""
    g = max(axes_size("dp"), 1)
    while T % g:
        g -= 1
    return g


def _dispatch(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor, C: int,
              stats: bool = True):
    """Route one token group xf (T, D) and scatter its rows into the (E, C, D)
    expert buffer: (h, (sorted_e, slot, order, w), the load-balance statistics or
    None without `stats`)."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    dt, dev = xf.dtype, xf.device
    T, D = xf.shape

    logits, probs, gate, topi = _route(m, xf, router)
    A = T * K
    flat_e = topi.reshape(A)
    order = torch.argsort(flat_e, stable=True)  # token priority within an expert
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(0, flat_e,
                                                                       torch.ones_like(flat_e))
    starts = counts.cumsum(0) - counts
    pos_in_e = torch.arange(A, device=dev) - starts[sorted_e]
    keep = pos_in_e < C
    slot = torch.where(keep, pos_in_e, C)  # C = the overflow scratch row
    token_of = order // K

    buf = torch.zeros(E, C + 1, D, dtype=dt, device=dev)
    # several dropped rows may land in row C: it is cut off, so no gradient flows from
    # it; `F.embedding` adds a token's K row gradients in a fixed order (`xf[token_of]`'s
    # backward adds them in a varying order on the CPU)
    buf[sorted_e, slot] = F.embedding(token_of, xf)
    w = (gate.reshape(A)[order] * keep).to(dt)
    if not stats:
        return buf[:, :C], (sorted_e, slot, order, w), None
    stats = {
        "me": probs.mean(0),
        "ce": counts.float() / A,
        "z": torch.logsumexp(logits, -1).square().mean(),
        "drop": (1.0 - keep.float().mean()).clamp(0.0, 1.0),
    }
    return buf[:, :C], (sorted_e, slot, order, w), stats


def _combine(K: int, out: torch.Tensor, sorted_e, slot, order, w) -> torch.Tensor:
    """The tokens' outputs (T, D) from the experts' (E, C, D): a dropped assignment
    reads the zeros row C."""
    E, _, D = out.shape
    out = torch.cat([out, torch.zeros(E, 1, D, dtype=out.dtype, device=out.device)], 1)
    return combine(out[sorted_e, slot], w, order, order.shape[0] // K, K)


def _experts(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """The expert MLPs on their buffer rows: (E, C, D) -> (E, C, D) by `torch.bmm`;
    on a mesh (G, E, C, D) with G over dp and E over ep, by `torch.einsum`, whose
    batch dims DTensor keeps sharded."""
    act, dt = activation(cfg.act), h.dtype
    if not is_dtensor(h):
        up = torch.bmm(h, p["wi"].to(dt))
        if "wg" in p:
            up = act(torch.bmm(h, p["wg"].to(dt))) * up
        else:
            up = act(up)
        return torch.bmm(up, p["wo"].to(dt))
    # under `shard_ff_dp` the ff dim is also on the ZeRO axes: gathered at use (ZeRO-3)
    wi, wo = (shard(p[k], "ep", None, None).to(dt) for k in ("wi", "wo"))
    up = torch.einsum("gecd,edf->gecf", h, wi)
    if "wg" in p:
        up = act(torch.einsum("gecd,edf->gecf", h, shard(p["wg"], "ep", None, None).to(dt))) * up
    else:
        up = act(up)
    return torch.einsum("gecf,efd->gecd", up, wo)


def _moe_groups(cfg: ModelConfig, p: dict, x: torch.Tensor, G: int, aux: bool):
    """The routed experts of x (B, S, D) in G groups of contiguous tokens, one after
    another: (y (T, D), the groups' statistics stacked (G, ...), or None)."""
    B, S, D = x.shape
    T = B * S
    C = capacity(cfg.moe, T // G)
    ys, stats = [], []
    for xg in x.reshape(G, T // G, D):
        h, route, st = _dispatch(cfg, p["router"], xg, C, aux)
        ys.append(_combine(cfg.moe.top_k, _experts(cfg, p, h), *route))
        stats.append(st)
    y = ys[0] if G == 1 else torch.cat(ys)
    return y, aux and {k: torch.stack([st[k] for st in stats]) for k in STATS}


def _moe_mesh(cfg: ModelConfig, p: dict, x: torch.Tensor, G: int, aux: bool):
    """`_moe_groups` on a mesh: each dp shard's tokens are its group (JAX's groups of
    contiguous tokens, the group dim over dp). Each rank routes and scatters its
    group (`on_shards`; replicated over tp), runs the experts of its ep shard on
    the buffer, the buffers are gathered back over ep, and it combines its tokens.
    Where the dp axes do not split the batch (B < G), every rank holds every token
    and routes all G groups, and runs the experts of its own group."""
    B, S, D = x.shape
    K, C = cfg.moe.top_k, capacity(cfg.moe, B * S // G)
    n_local = 1 if B % G == 0 else G  # the groups of a rank's tokens

    def dispatch(xl, router):
        outs = [_dispatch(cfg, router, g, C) for g in xl.reshape(n_local, -1, D)]
        h = torch.stack([o[0] for o in outs])
        route = [torch.stack([o[1][i] for o in outs]) for i in range(4)]
        return (h, *route, *(torch.stack([o[2][k] for o in outs]) for k in STATS))

    xg = shard(x, "dp", None, None)
    h, *rest = on_shards(dispatch, xg, params=(p["router"],), n_out=5 + len(STATS))
    route, st = rest[:4], dict(zip(STATS, rest[4:]))
    out = shard(_experts(cfg, p, shard(h, "dp", "ep", None, None)), "dp", None, None, None)
    # (G, T / G, D): each rank its group's tokens
    y = on_shards(lambda o, *r: _combine(K, o[0], *(t[0] for t in r))[None], out, *route)
    if B % G:  # the groups cut the batch's rows: gather them before the tokens' view
        y = shard(y, None, None, None)
    return y.reshape(B * S, D), st


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, *, aux: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux dict of the load-balance metrics).

    The routed experts run in `_n_groups` dispatch groups (1 off a mesh), the
    statistics averaged over the groups as in JAX. With `aux=False` the
    metrics are not returned (None in their place; JAX computes and discards
    them in prefill and decode).
    """
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    G = _n_groups(T)
    y, st = (_moe_mesh if is_dtensor(x) else _moe_groups)(cfg, p, x, G, aux)
    xf = x.reshape(T, D)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf, cfg.act)
    if "dense" in p:
        y = y + apply_mlp(p["dense"], xf, cfg.act)
    if is_dtensor(y):
        # on a mesh: the tokens as x's, so that they view back to (B, S, D), and the
        # gradient, which comes split over the sequence too (sp) and which a view
        # back to (T, D) would make a strided shard, pinned to the tokens' layout
        y = y.redistribute(xf.device_mesh, xf.placements)
        y = shard(y.view(B, S, D), "dp", None, None)
    else:
        y = y.view(B, S, D)
    if not aux:
        return y, None
    return y, {
        "moe_lb_loss": m.num_experts * (st["me"].mean(0) * st["ce"].mean(0)).sum(),
        "moe_z_loss": st["z"].mean(),
        "moe_drop_frac": st["drop"].mean(),
    }


def apply_moe_dense_reference(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """O(T*E) oracle: every expert on every token, masked by gates (tests only)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    act = activation(cfg.act)
    dt = x.dtype
    xf = x.reshape(T, D)
    _, _, gate, topi = _route(m, xf, p["router"])
    dense_gate = torch.zeros(T, m.num_experts, dtype=torch.float32, device=x.device)
    dense_gate.scatter_(1, topi, gate)
    up = torch.einsum("td,edf->tef", xf, p["wi"].to(dt))
    if "wg" in p:
        up = act(torch.einsum("td,edf->tef", xf, p["wg"].to(dt))) * up
    else:
        up = act(up)
    out = torch.einsum("tef,efd->ted", up, p["wo"].to(dt))
    y = torch.einsum("ted,te->td", out, dense_gate.to(dt))
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf, cfg.act)
    if "dense" in p:
        y = y + apply_mlp(p["dense"], xf, cfg.act)
    return y.reshape(B, S, D)
