"""Mixture-of-Experts with capacity-bounded gather/scatter dispatch.

Port of `repro.models.moe` (no Pallas kernel there: the expert products are
`jnp.einsum`, so here they are `torch.bmm`). Assignments are sorted by
expert (a stable sort, so a token's priority within an expert is its flat
index), each is given its position within its expert from the exclusive
cumulative counts, and rows are scattered into a static (E, C+1, D) buffer:
row C is the overflow scratch row, so a dropped assignment needs no dynamic
shape, and reading row C of the padded output gives it zeros.

Groups. JAX dispatches within G groups, G being the size of its dp mesh
axes (`_n_groups`), which is 1 off a mesh. The port has no mesh: G = 1, and
the capacity C is computed from the call's own T = B * S tokens, so prefill,
decode and `forward` each have their own C.

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

_RECORD: list | None = None  # the open routing record, if any


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


def _moe_group(cfg: ModelConfig, p: dict, xf: torch.Tensor, C: int, stats: bool):
    """Dispatch, expert products and combine for one token group. xf: (T, D)."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    dt, dev = xf.dtype, xf.device
    act = activation(cfg.act)
    T, D = xf.shape

    logits, probs, gate, topi = _route(m, xf, p["router"])
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
    h = buf[:, :C]
    up = torch.bmm(h, p["wi"].to(dt))
    if "wg" in p:
        up = act(torch.bmm(h, p["wg"].to(dt))) * up
    else:
        up = act(up)
    out = torch.cat([torch.bmm(up, p["wo"].to(dt)), torch.zeros(E, 1, D, dtype=dt, device=dev)], 1)

    vals = out[sorted_e, slot]  # (A, D); a dropped assignment reads the zeros row
    w = (gate.reshape(A)[order] * keep).to(dt)
    y = combine(vals, w, order, T, K)
    if not stats:
        return y, None
    return y, {
        "me": probs.mean(0),
        "ce": counts.float() / A,
        "z": torch.logsumexp(logits, -1).square().mean(),
        "drop": (1.0 - keep.float().mean()).clamp(0.0, 1.0),
    }


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor, *, aux: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux dict of the load-balance metrics).

    With `aux=False` the metrics are not computed and None is returned in
    their place (JAX computes and discards them in prefill and decode).
    """
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    y, stats = _moe_group(cfg, p, xf, capacity(m, T), aux)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xf, cfg.act)
    if "dense" in p:
        y = y + apply_mlp(p["dense"], xf, cfg.act)
    y = y.view(B, S, D)
    if not aux:
        return y, None
    return y, {
        "moe_lb_loss": m.num_experts * (stats["me"] * stats["ce"]).sum(),
        "moe_z_loss": stats["z"],
        "moe_drop_frac": stats["drop"],
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
