"""Logical-axis sharding (`repro.parallel.axes`) over a `DeviceMesh` and DTensor.

Model code annotates tensors with *logical* axis names ("dp", "tp", "sp", "ep",
"cp", "zero"); a `ShardingRules` instance maps each logical name to zero or
more mesh axis names, as in JAX. A spec is a tuple with one entry a tensor dim:
None, a mesh axis name, or a tuple of them (JAX's PartitionSpec entries), and
`placements` turns it into DTensor placements, one a mesh dim.

  dp   - data-parallel axes (batch / token dims). Multi-pod: ("pod", "data").
  tp   - tensor-parallel (Megatron) axes for weights and head dims.
  ep   - expert-parallel axes for MoE expert dims (defaults to tp).
  sp   - sequence-parallel axes for activation seq dims.
  cp   - context-parallel axes for long-context KV/seq sharding.
  zero - extra axes for ZeRO-1 optimizer-state sharding (defaults to dp).

When no mesh is active every helper is a no-op, so the single-device path is
unchanged. `shard` is JAX's `with_sharding_constraint`: it redistributes a
DTensor to the annotated placements and passes a plain tensor through. Unlike
GSPMD, which pads a dim that a mesh axis does not divide, the port leaves such
a dim unsharded (`sanitize_pspec`), for activations as for parameters: the
function computed is the same.

`on_shards` runs the parts that work on local shards through `local_map`: the
kernels' autograd Functions and the per-head or per-row code around them. A mesh also
stands for a stand-in object with a `shape` dict (axis -> size), which is all
that `axes_size`, `sanitize_pspec` and the ZeRO-1 specs read.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


@dataclass(frozen=True)
class ShardingRules:
    dp: tuple[str, ...] = ()
    tp: tuple[str, ...] = ()
    sp: tuple[str, ...] = ()
    ep: tuple[str, ...] = ()
    cp: tuple[str, ...] = ()
    zero: tuple[str, ...] = ()

    def resolve(self, name):
        """Resolve one logical dim annotation to a spec entry."""
        if name is None:
            return None
        if isinstance(name, (tuple, list)):  # combination, e.g. ("dp", "tp")
            out: list[str] = []
            for n in name:
                r = self.resolve(n)
                if r is None:
                    continue
                out.extend(r if isinstance(r, tuple) else (r,))
            return tuple(out) if out else None
        axes = getattr(self, name, None)
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]


def make_rules(*, dp: tuple[str, ...] = (), tp: tuple[str, ...] = (),
               sequence_parallel: bool = False, context_parallel: tuple[str, ...] = (),
               zero1: bool = True) -> ShardingRules:
    return ShardingRules(dp=dp, tp=tp, sp=tp if sequence_parallel else (), ep=tp,
                         cp=context_parallel, zero=dp if zero1 else ())


_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh_ctx",
                                                      default=(None, ShardingRules()))


@contextlib.contextmanager
def use_mesh(mesh, rules: ShardingRules):
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_mesh():
    return _CTX.get()[0]


def current_rules() -> ShardingRules:
    return _CTX.get()[1]


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size}: of a DeviceMesh, or the `shape` dict of a stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def logical_spec(*names) -> tuple:
    """The spec (one entry a dim) of logical dim names under the current rules."""
    rules = current_rules()
    return tuple(rules.resolve(n) for n in names)


def axes_size(name: str) -> int:
    """Total device count behind a logical axis name (1 when no mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(current_rules().resolve(name)))


def sanitize_pspec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop mesh axes from dims they don't evenly divide; pad the spec to the rank."""
    sizes = mesh_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for i, e in enumerate(entries):
        size = math.prod(sizes[a] for a in entry_axes(e))
        out.append(e if e is not None and shape[i] % size == 0 and shape[i] >= size else None)
    return tuple(out)


def sanitize_spec_tree(spec_tree, shape_tree, mesh):
    """Tree-wise sanitize: a nested dict of specs against the matching dict of shapes."""
    if isinstance(spec_tree, dict):
        return {k: sanitize_spec_tree(v, shape_tree[k], mesh) for k, v in spec_tree.items()}
    return sanitize_pspec(spec_tree, shape_tree, mesh)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec on a DeviceMesh: Shard(d) on each mesh dim that
    shards tensor dim d, Replicate elsewhere. A dim sharded over several mesh axes
    takes them major to minor in the mesh's order, as JAX's entry lists them."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        axes = entry_axes(e)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec entry {e} is not in the mesh's axis order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def named_sharding(*names):
    """The placements of logical dim names on the current DeviceMesh; None off a mesh."""
    mesh = current_mesh()
    return None if mesh is None else placements(logical_spec(*names), mesh)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def shard(x, *names):
    """Redistribute a DTensor to the placements of `names` under the current rules
    (sanitized against its shape); the identity on anything else."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = sanitize_pspec(logical_spec(*names), tuple(x.shape), mesh)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def grad_placements(data_placements) -> tuple:
    """The gradient placements of a parameter replicated on every mesh dim, used
    with data of `data_placements`: a partial sum on each mesh dim that splits the
    data, replicated on the others."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate() for p in data_placements)


def on_shards(fn, *data, params=(), n_out: int = 1):
    """`fn(*data, *params)`: as is on plain tensors; on DTensors, on their local
    shards (`local_map`). Every `data` tensor shares the first one's placements, as
    do `fn`'s `n_out` outputs (a row-wise or per-head function: the kernels'
    autograd Functions, RoPE, the attention core); `params` are replicated on
    every mesh dim, and their gradients are partial sums where the data is split
    (`grad_placements`). The inputs are redistributed to those placements first."""
    if not is_dtensor(data[0]):
        return fn(*data, *params)
    # one placements list an argument or output (local_map reads a tuple of
    # placements as one entry an output)
    pl = list(data[0].placements)
    rep = [Replicate()] * len(pl)
    grad = list(grad_placements(pl))
    return local_map(fn, out_placements=pl if n_out == 1 else (pl,) * n_out,
                     in_placements=(pl,) * len(data) + (rep,) * len(params),
                     in_grad_placements=(pl,) * len(data) + (grad,) * len(params),
                     redistribute_inputs=True)(*data, *params)


def whole(t):
    """A DTensor as the plain tensor of its full value, the same on every rank
    (differentiable); anything else as is."""
    return t.full_tensor() if is_dtensor(t) else t

