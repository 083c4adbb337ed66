"""int8 gradient quantization with error feedback (`repro.parallel.compression`).

JAX's docstring describes an int8 all-reduce over the data axes, but its
code is a local quantize / dequantize round trip with the residual fed back
into the next step (ROADMAP C3). The port copies what the code computes:
per leaf, gf = g + e in float32, a per-tensor absmax scale, q =
round(gf / s * 127) in int8, and the new error gf - q * s / 127.
"""

from __future__ import annotations

import torch

from repro_torch.train.tree import tree_map


def _q8(x: torch.Tensor):
    s = x.abs().max() + 1e-12
    return torch.round(x / s * 127.0).to(torch.int8), s


def compress_gradients(grads: dict, error_fb: dict | None = None):
    """(grads after the round trip, in their dtypes; the new float32 error feedback)."""
    if error_fb is None:
        error_fb = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                            grads)
    def one(g, e):
        gf = g.float() + e
        q, s = _q8(gf)
        deq = q.float() * s / 127.0
        return deq.to(g.dtype), gf - deq

    pairs = tree_map(one, grads, error_fb)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)
