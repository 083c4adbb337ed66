"""int8 gradient quantization with error feedback (`repro.parallel.compression`).

JAX's docstring describes an int8 all-reduce over the data axes, but its
code is a quantize / dequantize round trip with the residual fed back into
the next step; under a mesh GSPMD applies it to the gradient it has already
reduced, with one absmax scale over the whole leaf. The port copies what
that code computes, and sends no int8 over the wire: per leaf, gf = g + e
in float32, a per-tensor absmax scale s, q = round(gf / s * 127) in int8,
and the new error gf - q * s / 127. On a mesh the leaf is a DTensor in its
reduced (ZeRO-1 or parameter) layout, the absmax is reduced over its
shards, and the error feedback keeps its parameter's layout.
"""

from __future__ import annotations

import torch

from repro_torch.parallel.axes import is_dtensor
from repro_torch.train.tree import tree_map


def _q8(x: torch.Tensor):
    s = x.abs().max() + 1e-12
    return torch.round(x / s * 127.0).to(torch.int8), s


def compress_gradients(grads: dict, error_fb: dict | None = None):
    """(grads after the round trip, in their dtypes; the new float32 error feedback)."""
    if error_fb is None:
        error_fb = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        if is_dtensor(g):  # the error feedback in the gradient's layout and back
            gf = g.float() + e.redistribute(g.device_mesh, g.placements)
        else:
            gf = g.float() + e
        q, s = _q8(gf)
        deq = q.float() * s / 127.0
        new_e = gf - deq
        if is_dtensor(g):
            new_e = new_e.redistribute(e.device_mesh, e.placements)
        return deq.to(g.dtype), new_e

    pairs = tree_map(one, grads, error_fb)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)
