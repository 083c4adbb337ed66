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

`on_shards` and `on_local` run the parts that work on local shards through
`local_map`: the kernels' autograd Functions and the per-head or per-row code
around them, per-head parameters (Mamba2's and RWKV6's) on their own shards.
`write` fills a placed cache or state in place, shard by shard, and
`lse_combine` joins the partial outputs of ranks that hold parts of a KV
cache's length, as flash-decode joins its splits. A mesh also
stands for a stand-in object with a `shape` dict (axis -> size), which is all
that `axes_size`, `sanitize_pspec` and the ZeRO-1 specs read.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
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


# the mesh and rules of the innermost `use_mesh`, for the whole process rather than
# one thread: autograd runs a CUDA backward, and with it the recompute of a
# checkpointed block, on its own device threads, which must see the forward's mesh
_ACTIVE: list = [(None, ShardingRules())]


@contextlib.contextmanager
def use_mesh(mesh, rules: ShardingRules):
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


def current_mesh():
    return _ACTIVE[-1][0]


def current_rules() -> ShardingRules:
    return _ACTIVE[-1][1]


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


def activation_pspec(names, shape: tuple[int, ...], mesh) -> tuple:
    """The sanitized spec of an activation's logical dim `names`, a dim of size 1 left
    unsharded: only a mesh axis of size 1 could split it, which is the identity,
    and DTensor cannot view such a sharded dim away (a matmul flattens (1, S, D)
    to (S, D))."""
    spec = sanitize_pspec(logical_spec(*names), shape, mesh)
    return tuple(None if n == 1 else e for e, n in zip(spec, shape))


def shard(x, *names):
    """Redistribute a DTensor to the placements of `names` under the current rules
    (`activation_pspec`); the identity on anything else."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          placements(activation_pspec(names, tuple(x.shape), mesh), x.device_mesh))


def grad_placements(arg_placements, split) -> tuple:
    """The gradient placements of an input placed `arg_placements` to a function
    whose work is split over the mesh dims `split`: as the input where it is
    sharded, a partial sum on the other mesh dims of `split`, replicated elsewhere."""
    return tuple(p if isinstance(p, Shard) else Partial() if i in split else Replicate()
                 for i, p in enumerate(arg_placements))


def on_local(fn, *args, out):
    """`fn(*args)` on the local shards of the DTensors among `args`, each as it is
    placed (anything else passes as it is); `out` is the placements of each of
    `fn`'s outputs, in pytree order, one list an output. The work is split over
    the mesh dims that shard any input, so each input's gradient is a partial sum
    on those of them that do not shard it (`grad_placements`). Off a mesh,
    `fn(*args)`."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    split = {i for a in dts for i, p in enumerate(a.placements) if isinstance(p, Shard)}
    ins = tuple(tuple(a.placements) if is_dtensor(a) else None for a in args)
    grads = tuple(grad_placements(a.placements, split) if is_dtensor(a) else None for a in args)
    # local_map reads a tuple as one entry an output, and a list as one output's placements
    outs = list(out[0]) if len(out) == 1 else tuple(list(p) for p in out)
    return local_map(fn, out_placements=outs, in_placements=ins, in_grad_placements=grads)(*args)


def on_shards(fn, *data, params=(), n_out: int = 1):
    """`fn(*data, *params)` on local shards (`on_local`): every `data` tensor is
    redistributed to the first one's placements, which `fn`'s `n_out` outputs
    share (a row-wise or per-head function: the kernels' autograd Functions, RoPE,
    the attention core); `params` keep their own placements (replicated, or split
    by head alongside per-head data), and each gets a gradient placed as it is,
    a partial sum where the data alone is split. As is on plain tensors."""
    if not is_dtensor(data[0]):
        return fn(*data, *params)
    # a partial sum is no rank's rows: each function here needs the values
    pl = tuple(Replicate() if p.is_partial() else p for p in data[0].placements)
    data = tuple(d.redistribute(d.device_mesh, pl) if is_dtensor(d) and d.placements != pl else d
                 for d in data)
    return on_local(fn, *data, *params, out=[pl] * n_out)


def regrid(pl, dims: dict) -> list | None:
    """Placements `pl` of a tensor carried to another tensor whose dim dims[d] holds the
    input's sharded dim d: Shard(d) becomes Shard(dims[d]). For the outputs of a
    local function whose shapes differ from its inputs' (a recurrence's final
    state). None for None."""
    if pl is None:
        return None
    return [Shard(dims[p.dim]) if isinstance(p, Shard) else p for p in pl]


def zeros(shape: tuple[int, ...], dtype, device, spec: tuple) -> torch.Tensor:
    """Zeros of `shape`: on a DeviceMesh a DTensor placed per `spec` (mesh axes,
    sanitized against the shape), each rank allocating only its own shard; plain
    zeros off a mesh and on the meta device (shapes alone)."""
    mesh = current_mesh()
    if not isinstance(mesh, DeviceMesh) or torch.device(device).type == "meta":
        return torch.zeros(shape, dtype=dtype, device=device)
    pl = placements(sanitize_pspec(spec, tuple(shape), mesh), mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device), mesh, pl,
                              run_check=False)


def write(dst, src) -> None:
    """`dst.copy_(src)` in place; on a DTensor `dst`, `src` (a DTensor) is placed as
    `dst` first (from a replicated value that takes a local slice, no message)
    and each rank copies its own shard, so nothing of the whole tensor is formed."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())


def lse_combine(o, lse, mesh=None, dims=()):
    """Flash-decode's combine of partial attention outputs over parts of a cache's
    length: o (..., dh) each part's output over its own slots, lse (...) its
    log-sum-exp of the scaled scores; returns the output over all of them, float32:
    m = max_r lse_r, o = sum_r exp(lse_r - m) o_r / sum_r exp(lse_r - m). A part
    with no valid slot gives o = 0, lse = NEG_INF (-1e30, not -inf: no NaN arises).
    With `mesh`, this rank holds one part and the parts are the ranks along the
    mesh dims `dims`, reduced by all-reduces in float32; without it, the parts lie
    on the leading dim of `o` and `lse`."""
    def reduce(t, op):
        if mesh is None:
            return t.amax(0) if op == "max" else t.sum(0)
        for d in dims:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                            group=mesh.get_group(d))
        return t

    lse = lse.float()
    w = torch.exp(lse - reduce(lse.clone(), "max"))
    return reduce(o.float() * w[..., None], "sum") / reduce(w, "sum")[..., None]


def whole(t):
    """A DTensor as the plain tensor of its full value, the same on every rank
    (differentiable); anything else as is."""
    return t.full_tensor() if is_dtensor(t) else t

