"""MLP block: gated (SiLU) or plain, Megatron column -> row partitioned on a mesh.
The products stay `torch.matmul`."""

from __future__ import annotations

import torch

from repro_torch.models.layers import activation
from repro_torch.parallel.axes import shard


def apply_mlp(p: dict, x: torch.Tensor, act_name: str) -> torch.Tensor:
    """(B, S, D) or (T, D) -> same rank. One logical all-reduce after wo."""
    act = activation(act_name)
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if "wg" in p:
        h = act(x @ p["wg"].to(dt)) * h
    else:
        h = act(h)
    if x.dim() == 3:
        h = shard(h, "dp", None, "tp")
        return shard(h @ p["wo"].to(dt), "dp", "sp", None)
    h = shard(h, "dp", "tp")
    return shard(h @ p["wo"].to(dt), "dp", None)
