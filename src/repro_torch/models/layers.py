"""Shared layers: norms, rotary embeddings, activations, embedding/lm-head.

Plain PyTorch counterparts of `repro.models.layers`, with JAX's sharding
annotations (`shard`, identities off a mesh).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate

from repro_torch.parallel.axes import (ce_combine, on_local, on_shards, reduce_parts, shard,
                                       shard_range)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # JAX's gelu(approximate=True)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x).square()  # squared ReLU (Nemotron/minitron)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(f"unknown activation {name}")


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm / LayerNorm (when `p` has a bias) in fp32, cast back to the input dtype."""
    xf = x.float()
    if "bias" in p:  # layernorm, with the population variance
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the trailing head_dim (qwen3 qk_norm)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (S,) or (B, S). Half-split rotate_half, fp32 angles."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.to(torch.float32)[..., None] * freqs  # (S, dh/2) or (B, S, dh/2)
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def embed_lookup(p: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The token rows, JAX's `tok[tokens]`. `F.embedding`, whose backward adds a
    repeated token's rows in a fixed order on the CPU and on CUDA (indexing's
    backward adds them in a varying order on the CPU). On a mesh whose tp splits
    the table over the vocabulary, each rank looks up the tokens of its block and
    the rows are summed over tp (`VocabParallelEmbedding`): the table's gradient
    is formed on each rank's block alone."""
    tok = p["tok"]
    v0, _, split = shard_range(tok, 0)
    split = tuple(d for d in split if tok.device_mesh.size(d) > 1)
    if not split:
        return shard(F.embedding(tokens, tok).to(dtype), "dp", "sp", None)
    mesh = tok.device_mesh
    rows = [Replicate() if d in split else pl for d, pl in enumerate(tokens.placements)]
    out = on_local(lambda t, x: VocabParallelEmbedding.apply(t, x, v0, dtype, mesh, split),
                   tok, tokens.redistribute(mesh, rows), out=[rows])
    return shard(out, "dp", "sp", None)


class VocabParallelEmbedding(torch.autograd.Function):
    """The token rows of a table split over the vocabulary, in `dtype`: on each
    block of rows (table (Vb, d), the rows of the ids v0 .. v0 + Vb - 1, the tokens
    over the whole vocabulary) the rows of its tokens and zeros for the others,
    summed over the ranks of the mesh dims `dims` (none with `mesh` None: one
    block's part), which is exact, one part a token being non-zero. The backward
    forms the block's gradient alone, (Vb, d), with `F.embedding`'s backward and
    its fixed-order adds of a repeated token's rows; the tokens of other blocks
    add theirs to one more row, which is dropped, so no row of the block takes a
    term that the whole table's would not."""

    @staticmethod
    def forward(ctx, table, tokens, v0, dtype, mesh, dims):
        Vb = table.shape[0]
        i = tokens - v0
        inside = (i >= 0) & (i < Vb)
        ctx.save_for_backward(torch.where(inside, i, Vb))
        ctx.Vb, ctx.table_dtype = Vb, table.dtype
        rows = F.embedding(i.clamp(0, Vb - 1), table).masked_fill_(~inside[..., None], 0).to(dtype)
        return rows if mesh is None else reduce_parts(rows, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        grad = torch.ops.aten.embedding_dense_backward(g.to(ctx.table_dtype), idx, ctx.Vb + 1, -1,
                                                       False)
        return grad[:ctx.Vb], None, None, None, None, None


def lm_logits(p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x: (..., d) -> (..., vocab), computed in `dtype` (JAX promotes x to it);
    vocab-sharded on a mesh."""
    logits = x.to(dtype) @ p["w"].to(dtype)
    return shard(logits, "dp", None, "tp") if logits.dim() == 3 else shard(logits, "dp", "tp")


def chunk_ce(logits: torch.Tensor, y: torch.Tensor):
    """(per-token nll, argmax) of a chunk's float32 logits (..., V) at labels y (...),
    -1 where ignored (their nll is the logsumexp, masked by the caller): JAX's
    `chunk_loss` over the whole vocabulary. The gold logit is taken on each
    rank's rows on a mesh: DTensor's strategy for the gather's backward (a
    scatter into zeros) would replicate the chunk's float32 gradient over the
    data axes."""
    gold = on_shards(lambda lg, t: lg.gather(-1, t.clamp_min(0)[..., None])[..., 0], logits, y)
    return torch.logsumexp(logits, -1) - gold, logits.argmax(-1)


def ce_parts(logits: torch.Tensor, y: torch.Tensor, v0):
    """The vocab-parallel CE's local function on one block of the vocabulary: logits
    (..., Vb) float32 for the token ids v0 .. v0 + Vb - 1, labels y (...) over the
    whole vocabulary (v0 an int, or a tensor that broadcasts against y for parts on
    a leading dim). Returns (lse, gold, top, arg), `ce_combine`'s parts: the block's
    log-sum-exp, the label's logit where the label is in the block (0 elsewhere),
    the block's largest logit and its lowest global index."""
    Vb = logits.shape[-1]
    i = y - v0
    inside = (i >= 0) & (i < Vb)
    gold = logits.gather(-1, i.clamp(0, Vb - 1)[..., None])[..., 0]
    arg = logits.argmax(-1)
    top = logits.gather(-1, arg[..., None])[..., 0]
    return torch.logsumexp(logits, -1), torch.where(inside, gold, 0.0), top, arg + v0


class VocabParallelCE(torch.autograd.Function):
    """(per-token nll, argmax) of logits split over the vocabulary: `ce_parts` on
    each block, joined by `ce_combine` (over the ranks of the mesh dims `dims`, or
    over a leading dim of parts with `mesh` None). The backward is the softmax
    minus the one-hot of the label, on each block alone: exp(x - lse) - [y = v]."""

    @staticmethod
    def forward(ctx, logits, y, v0, mesh, dims):
        lse, gold, arg = ce_combine(*ce_parts(logits, y, v0), mesh, dims)
        ctx.save_for_backward(logits, y, lse)
        ctx.v0 = v0
        ctx.mark_non_differentiable(arg)
        return lse - gold, arg

    @staticmethod
    def backward(ctx, g, _):
        logits, y, lse = ctx.saved_tensors
        Vb = logits.shape[-1]
        i = y - ctx.v0
        inside = ((i >= 0) & (i < Vb)).to(logits.dtype)
        grad = torch.exp(logits - lse[..., None])
        grad = grad.scatter_add(-1, i.clamp(0, Vb - 1)[..., None].expand(*grad.shape[:-1], 1),
                                -inside.expand(grad.shape[:-1])[..., None])
        return grad * g[..., None], None, None, None, None


def group_norm_heads(p: dict, x: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head GroupNorm over head_dim (RWKV's ln_x), population variance. x: (..., H, dh)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    h, dh = x.shape[-2], x.shape[-1]
    return (y * p["scale"].reshape(h, dh) + p["bias"].reshape(h, dh)).to(x.dtype)
