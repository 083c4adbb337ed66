"""Shared layers: norms, rotary embeddings, activations, embedding/lm-head.

Plain PyTorch counterparts of `repro.models.layers`, with JAX's sharding
annotations (`shard`, identities off a mesh).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.axes import shard


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
    backward adds them in a varying order on the CPU). On a mesh the table is
    vocab-sharded over tp: each rank looks up its rows and the sum over tp
    (`shard`) gives every token's row."""
    return shard(F.embedding(tokens, p["tok"]).to(dtype), "dp", "sp", None)


def lm_logits(p: dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x: (..., d) -> (..., vocab), computed in `dtype` (JAX promotes x to it);
    vocab-sharded on a mesh."""
    logits = x.to(dtype) @ p["w"].to(dtype)
    return shard(logits, "dp", None, "tp") if logits.dim() == 3 else shard(logits, "dp", "tp")


def group_norm_heads(p: dict, x: torch.Tensor, eps: float = 64e-5) -> torch.Tensor:
    """Per-head GroupNorm over head_dim (RWKV's ln_x), population variance. x: (..., H, dh)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    h, dh = x.shape[-2], x.shape[-1]
    return (y * p["scale"].reshape(h, dh) + p["bias"].reshape(h, dh)).to(x.dtype)
