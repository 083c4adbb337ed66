"""The weights of a run, made by the benchmark from `--seed` on the device.

Both sides get them from here: the program as a parameter tree in its own
layout (the per-layer leaves stacked (L, ...) under `layers/`, every weight
`x @ W`, the norm gains float32), and the plain reference one layer at a time,
drawn again from the same seed. The configuration's family module
(`families/<family>.py`) names the leaves and their shapes. Every (leaf,
layer) has a generator of its own, seeded from a hash of the seed, the leaf's
path and the layer, so one layer can be drawn alone and comes out bit for bit
as in the whole tree.

Matrices are N(0, 0.02) in the configuration's dtype, as the program's own
init draws them; norm gains are N(1, 0.1) in float32, not ones, so that a
path that drops a gain shows.
"""

from __future__ import annotations

import hashlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def dtype_of(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["torch_dtype"]]


def _seed(seed: int, path: str, layer: int | None) -> int:
    digest = hashlib.sha256(f"{seed}/{path}/{layer}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def draw(fam, cfg: dict, seed: int, path: str, layer: int | None, device) -> torch.Tensor:
    """One leaf (`layer` None) or one layer's slice of a stacked leaf, as stored;
    `fam` is the configuration's family module."""
    leaves = fam.layer_leaves(cfg) if layer is not None else fam.top_leaves(cfg)
    shape, kind = leaves[path]
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, path, layer))
    if kind == "gain":
        return torch.empty(shape, dtype=torch.float32, device=device).normal_(1.0, 0.1, generator=g)
    return torch.empty(shape, dtype=dtype_of(cfg), device=device).normal_(0.0, 0.02, generator=g)


def _put(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def make(fam, cfg: dict, seed: int, device, *, head_fp32: bool) -> dict:
    """The program's parameter tree. `head_fp32` holds the output head in float32,
    as the program's serving path does (widening bf16 is exact)."""
    L = fam.sizes(cfg)["L"]
    tree: dict = {}
    for path in fam.top_leaves(cfg):
        t = draw(fam, cfg, seed, path, None, device)
        _put(tree, path, t.float() if head_fp32 and path == "lm_head/w" else t)
    for path, (shape, kind) in fam.layer_leaves(cfg).items():
        dtype = torch.float32 if kind == "gain" else dtype_of(cfg)
        t = torch.empty((L, *shape), dtype=dtype, device=device)
        for i in range(L):
            t[i].copy_(draw(fam, cfg, seed, path, i, device))
        _put(tree, "layers/" + path, t)
    return tree


def flat(tree: dict, prefix: str = "") -> dict:
    """{path: tensor} of a nested tree, paths joined by "/" in sorted order."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(tree[k], path) if isinstance(tree[k], dict) else {path: tree[k]})
    return out
