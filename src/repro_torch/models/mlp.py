"""MLP block: gated (SiLU) or plain. The products stay `torch.matmul`."""

from __future__ import annotations

import torch

from repro_torch.models.layers import activation


def apply_mlp(p: dict, x: torch.Tensor, act_name: str) -> torch.Tensor:
    """(B, S, D) or (T, D) -> same rank."""
    act = activation(act_name)
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if "wg" in p:
        h = act(x @ p["wg"].to(dt)) * h
    else:
        h = act(h)
    return h @ p["wo"].to(dt)
