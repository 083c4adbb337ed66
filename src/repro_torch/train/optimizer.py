"""AdamW with float32 or int8-quantized moments (`repro.train.optimizer`).

The port keeps JAX's numerics: the learning rate and the bias corrections
are float32 tensors (JAX's `jnp` arithmetic), not Python floats; weight
decay applies to every leaf with ndim >= 2 in the stacked (L, ...) layout,
so the stacked norm gains are decayed too, as in JAX; `torch.round` and
`jnp.round` both round half to even, and the quantizer keeps JAX's order of
operations, x / s * 127.

ZeRO-1. On a mesh the moments are DTensors sharded over the `zero` axes (the
data axes) on top of their parameter's own tensor-parallel sharding
(`_zero1_spec`, `opt_state_specs`); `adamw_update` reads the gradient and the
parameter in the moments' layout, computes on the local shards, and puts the
new parameter back in its own layout: the all-gather that JAX's pinned
`out_shardings` insert. The int8 scales are absmaxes over whole rows (over
the whole leaf for 0/1-D), so where a row is split, the local maxima are
reduced over the mesh dims that split it.

Unlike JAX, which returns new arrays, `adamw_update` writes the new
parameters and moments into the tensors it is given (JAX's `Trainer`
donates the state to the same effect): a step then holds one copy of the
state, not two. A leaf of more than SLICE_ELEMENTS elements is updated, and
its square summed for the global norm, in slices along its leading axis
(`_slices`), so that the float32 temporaries (XLA fuses them in JAX) are
one slice's size: rwkv6-7b's (32, 4096, 14336) channel-mix leaves would
take 7.5 GB each.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, full

from repro_torch.configs.base import TrainConfig
from repro_torch.parallel.axes import (current_mesh, current_rules, entry_axes, is_dtensor,
                                       mesh_sizes, placements)
from repro_torch.train.tree import leaves, tree_map

# the largest leaf (in elements) that `adamw_update` and `global_norm` take at
# once: 256 MB a float32 temporary
SLICE_ELEMENTS = 1 << 26


def lr_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10%, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    total = max(cfg.steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / total, 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * cos


def _quantize(x: torch.Tensor, groups: tuple = ()) -> dict:
    """int8 + per-row absmax scale. 0/1-D tensors use a per-tensor scale. `groups`:
    the process groups over which the rows (the tensor, for 0/1-D) of a local
    shard are split, whose maxima are reduced."""
    xf = x.float()
    s = xf.abs().max() if x.dim() <= 1 else xf.abs().amax(-1, keepdim=True)
    for g in groups:
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=g)
    s = s + 1e-12
    q = torch.round(xf / s * 127.0).to(torch.int8)
    return {"q": q, "s": s.reshape(())} if x.dim() <= 1 else {"q": q, "s": s}


def _dequantize(qs: dict) -> torch.Tensor:
    return qs["q"].float() * qs["s"] / 127.0


def _is_quant(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def leaves_q(tree) -> list:
    """Leaves of a moment tree, a quantized `{q, s}` leaf as one (`is_leaf=_is_quant`)."""
    if isinstance(tree, dict) and not _is_quant(tree):
        return [x for k in sorted(tree) for x in leaves_q(tree[k])]
    return [tree]


def adamw_init(params: dict, cfg: TrainConfig, specs: dict | None = None) -> dict:
    """{m, v, step}: zero moments (int8 `{q, s}` for adamw8bit). With `specs`
    (`opt_state_specs`, sanitized) and DTensor params, each moment is a DTensor
    made on the params' mesh in its own layout, not gathered from a whole one."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def placed(p, spec, fill, dtype, shape=None):
        mesh = p.device_mesh
        return full(p.shape if shape is None else shape, fill, dtype=dtype, device_mesh=mesh,
                    placements=placements(spec, mesh))

    def moment(p, spec):
        if specs is None or not is_dtensor(p):
            return _quantize(zeros(p)) if cfg.optimizer == "adamw8bit" else zeros(p)
        if cfg.optimizer != "adamw8bit":
            return placed(p, spec, 0.0, torch.float32)
        # _quantize of zeros: q 0, s the 1e-12 floor
        s_shape = () if p.dim() <= 1 else (*p.shape[:-1], 1)
        return {"q": placed(p, spec["q"], 0, torch.int8),
                "s": placed(p, spec["s"], 1e-12, torch.float32, s_shape)}

    m = tree_map(moment, params, specs["m"] if specs else params)
    v = tree_map(moment, params, specs["v"] if specs else params)
    dev = leaves(params)[0].device
    return {"m": m, "v": v, "step": torch.zeros((), dtype=torch.int32, device=dev)}


# ------------------------------------------------------------------- sharding
def _zero1_spec(spec: tuple, shape: tuple[int, ...]) -> tuple:
    """Add the ZeRO axes to the largest unsharded, evenly divisible dim.

    A mesh axis may appear at most once in a spec, so a leaf that already uses
    a ZeRO axis (arctic's experts under `shard_ff_dp`) is left alone.
    """
    zero = current_rules().resolve("zero")
    mesh = current_mesh()
    if zero is None or mesh is None or len(shape) == 0:
        return spec
    zaxes = entry_axes(zero)
    zsize = math.prod(mesh_sizes(mesh)[a] for a in zaxes)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if {a for e in entries for a in entry_axes(e)} & set(zaxes):
        return spec
    cands = [i for i, e in enumerate(entries)
             if e is None and shape[i] >= zsize and shape[i] % zsize == 0]
    if not cands:
        return spec
    i = max(cands, key=lambda j: shape[j])
    entries[i] = zaxes if len(zaxes) > 1 else zaxes[0]
    return tuple(entries)


def opt_state_specs(param_specs_tree: dict, param_shapes_tree: dict, cfg: TrainConfig) -> dict:
    """The spec tree of `adamw_init`'s state: each moment the ZeRO-1 spec of its
    parameter's; an int8 moment's scale that spec without its last dim."""
    def moment(spec, shape):
        base = _zero1_spec(spec, shape)
        if cfg.optimizer != "adamw8bit":
            return base
        if len(shape) <= 1:
            return {"q": base, "s": ()}
        entries = list(base) + [None] * (len(shape) - len(base))
        return {"q": base, "s": (*entries[:-1], None)}

    mspec = tree_map(moment, param_specs_tree, param_shapes_tree)
    return {"m": mspec, "v": mspec, "step": ()}


def opt_state_shapes(param_shapes_tree: dict, cfg: TrainConfig) -> dict:
    """The shape tree of `adamw_init`'s state (JAX's `eval_shape` of it)."""
    def moment(shape):
        if cfg.optimizer != "adamw8bit":
            return shape
        return {"q": shape, "s": () if len(shape) <= 1 else (*shape[:-1], 1)}

    mshape = tree_map(moment, param_shapes_tree)
    return {"m": mshape, "v": mshape, "step": ()}



def _slices(p: torch.Tensor) -> list:
    """Ranges of the leading axis to update at a time: the whole leaf (None), or for a leaf
    of ndim >= 2 above SLICE_ELEMENTS, runs of as many leading rows as fit in it.
    The results are the same bits: every operation of the update is elementwise,
    the int8 scales are per row along the last axis, and the clip factor and the
    bias corrections are computed once before."""
    if p.dim() < 2 or p.numel() <= SLICE_ELEMENTS:
        return [None]
    n = max(1, SLICE_ELEMENTS // (p.numel() // p.shape[0]))
    return [slice(i, i + n) for i in range(0, p.shape[0], n)]


def _at(leaf, sl):
    """A leaf's rows `sl` (all of it for None), both tensors' of a quantized leaf."""
    if sl is None:
        return leaf
    return {k: v[sl] for k, v in leaf.items()} if isinstance(leaf, dict) else leaf[sl]


def _split_groups(t, dims) -> tuple:
    """The process groups of the mesh dims on which DTensor `t` is sharded along one
    of `dims` (all dims for None)."""
    return tuple(t.device_mesh.get_group(i) for i, pl in enumerate(t.placements)
                 if isinstance(pl, Shard) and (dims is None or pl.dim in dims))


def global_norm(tree) -> torch.Tensor:
    """The float32 norm of every leaf together; a leaf above SLICE_ELEMENTS summed
    slice by slice (`_slices`), so that its float32 square is one slice's size.
    A DTensor leaf (sharded or replicated, not partial) sums its local shard, and
    the sums are added over the mesh dims that shard it."""
    def sq(g):
        t = g.to_local() if is_dtensor(g) else g
        total = sum(_at(t, sl).float().square().sum() for sl in _slices(t))
        if not is_dtensor(g):
            return total
        assert not any(p.is_partial() for p in g.placements), g.placements
        pl = [Partial() if isinstance(p, Shard) else Replicate() for p in g.placements]
        return DTensor.from_local(total, g.device_mesh, pl).full_tensor()

    return torch.sqrt(torch.stack([sq(g) for g in leaves(tree)]).sum())


def _assign(dst, src) -> None:
    """Write a new value into a leaf, or into both tensors of a quantized leaf."""
    if isinstance(dst, dict):
        for k in dst:
            _assign(dst[k], src[k])
    else:
        dst.copy_(src)


def _local(t):
    return {k: _local(v) for k, v in t.items()} if isinstance(t, dict) else t.to_local()


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: TrainConfig):
    """(params, opt_state, stats): grad clip + AdamW + decoupled weight decay, in place.

    A DTensor leaf is updated on local shards in its moments' layout: the gradient
    and the parameter are redistributed to it, and the new parameter back to the
    parameter's own layout."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip > 0 else 1.0
    quant = cfg.optimizer == "adamw8bit"
    bc1 = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(p, g, m, v, decay: bool, groups: tuple):
        g = g.float() * clip
        mf = _dequantize(m) if quant else m
        vf = _dequantize(v) if quant else v
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g.square()
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only (and the stacked gains)
            update = update + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
        _assign(m, _quantize(mf, groups) if quant else mf)
        _assign(v, _quantize(vf, groups) if quant else vf)

    flat_m = leaves_q(opt_state["m"])
    flat_v = leaves_q(opt_state["v"])
    for p, g, m, v in zip(leaves(params), leaves(grads), flat_m, flat_v, strict=True):
        decay, groups, local, zpl = p.dim() >= 2, (), p, None
        if is_dtensor(p):
            ref = m["q"] if quant else m
            zpl = ref.placements
            g = g.redistribute(ref.device_mesh, zpl).to_local()
            # the scale's rows: split where the last dim (any dim, for 0/1-D) is
            groups = _split_groups(ref, None if p.dim() <= 1 else (p.dim() - 1,))
            local = (p if zpl == p.placements else p.redistribute(ref.device_mesh, zpl)).to_local()
            m, v = _local(m), _local(v)
        for sl in _slices(local):
            upd(*(_at(t, sl) for t in (local, g, m, v)), decay, groups)
        if zpl is not None and zpl != p.placements:
            # the ZeRO-1 all-gather of the new parameter into its own layout
            new = DTensor.from_local(local, p.device_mesh, zpl, shape=p.shape, stride=p.stride())
            p.to_local().copy_(new.redistribute(p.device_mesh, p.placements).to_local())
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
