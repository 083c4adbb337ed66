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
GSPMD, which pads a dim that a mesh axis does not divide, `sanitize_pspec`
leaves such a dim unsharded, for activations as for parameters: the function
computed is the same. Where that would leave a rank more than JAX's specs give
it, the model pads or reduces by hand: attention pads its kv heads to a
multiple of tp (`models/attention.py::kv_heads_split`), and the CE reduces its
vocab-split logits over tp (`ce_combine`).

`on_shards` and `on_local` run the parts that work on local shards through
`local_map`: the kernels' autograd Functions and the per-head or per-row code
around them, per-head parameters (Mamba2's and RWKV6's) on their own shards.
`write` fills a placed cache or state in place, shard by shard; `shard_range`
and `block_of` give a rank's part of a split dim; `take_rows` moves a block
of a batch's rows to the ranks that need them, point to point; `shift_rows`
shifts a split sequence by one row, each rank receiving the row its block
lacks from its neighbour, and `last_row` takes a split sequence's last row
without gathering it. `shard` (and `whole`) move an activation by `move`, which
gathers a dim d > 0 into row slices of one contiguous buffer (`gather_rows`)
and reduces a partial sum onto such a dim row slice by row slice; `shard_param`
is `shard` for a weight at its use, which gathers a dim other than the first
into one buffer whose leading dim is the gathered one (`gather_dims`).
`lse_combine` joins the partial outputs of ranks that hold parts of a KV
cache's length, as flash-decode joins its splits, and `ce_combine` the CE's
parts of ranks that hold blocks of the vocabulary; both also join parts on a
leading dim (`reduce_parts`). `SumOverRanks` sums a local function's parts
over ranks, with the backward its use needs. A mesh also
stands for a stand-in object with a `shape` dict (axis -> size), which is all
that `axes_size`, `sanitize_pspec` and the ZeRO-1 specs read.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils._python_dispatch import _disable_current_modes


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
    (`activation_pspec`); the identity on anything else. Each gather of a dim d > 0
    whose shard has more than one row before d (L > 1: a (B_local, S, D) hidden
    state gathered on S) fills row slices of one contiguous buffer
    (`gather_rows`), and each reduce-scatter of a partial sum onto a dim d > 0 (an
    output projection's partial sums onto the sequence) reduces row slices of it
    as it stands; the other moves are DTensor's (`move`)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return move(x, placements(activation_pspec(names, tuple(x.shape), mesh), x.device_mesh))


def move(t, pl):
    """An activation, DTensor `t`, redistributed to placements `pl` as `shard` moves
    it: its gathers and reduce-scatters of a dim > 0 in row slices
    (`_move_last`), one collective a row of the L before the dim, so for a dim
    with few rows before it (a batch's, not a batch's and a sequence's)."""
    return _move_last(t, tuple(pl), rows=True)


def shard_param(w, *names):
    """`shard` of a weight at its use, each gather of a dim other than the first made
    into one buffer whose leading dim is the gathered one (`gather_dims`): the
    weight's users, matmuls and einsums, read the permuted view as it is. (An
    activation's would not: a matmul flattens a (B, S, D) view gathered on S into
    (B S, D) by a copy, so `shard` gathers activations into row slices.)"""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(w):
        return w
    return _move_last(w, placements(activation_pspec(names, tuple(w.shape), mesh),
                                    w.device_mesh), rows=False)


def _scattered_dims(t, pl) -> tuple[int, ...]:
    """The mesh dims of `t`'s Partial -> Shard(d) moves toward placements `pl` with
    d > 0 over more than one rank, where no other mesh dim splits d, in `t` or in
    `pl`. The others are left to `redistribute`."""
    def alone(i, d):
        return not any(type(r) is Shard and r.dim == d
                       for j, r in (*enumerate(pl), *enumerate(t.placements)) if j != i)
    return tuple(i for i, (p, q) in enumerate(zip(pl, t.placements))
                 if q.is_partial() and type(p) is Shard and p.dim > 0
                 and t.device_mesh.size(i) > 1 and alone(i, p.dim))


def _move_last(t, pl, rows: bool):
    """DTensor `t` redistributed to placements `pl`, each Shard(d) -> Replicate move
    with d > 0 over more than one rank made into one buffer: with `rows` by
    `_GatherRows` where some such move's shard has L > 1 rows before d (else
    DTensor's gather, whose dim-0 buffer then is the result's layout; DTensor's
    too for a nested split into uneven parts), and each Partial -> Shard(d) move
    with d > 0 over more than one rank, d split by no other mesh dim, by
    `_ScatterRows` (DTensor's reduce-scatter copies the partial sum in chunks
    along dim 0 first, at any L); without `rows`, the gathers by `gather_dims`.
    DTensor redistributes the other mesh dims first, so that these moves are the
    last step and each gradient's reduction onto the shards is a reduce-scatter,
    as DTensor's backward makes it (a redistribution after them would all-reduce
    it first)."""
    dm = t.device_mesh
    scatters = _scattered_dims(t, pl) if rows else ()
    mid = tuple(q if i in scatters or (type(q) is Shard and q.dim > 0 and p.is_replicate()
                                       and dm.size(i) > 1) else p
                for i, (p, q) in enumerate(zip(pl, t.placements)))
    if mid == pl:  # nothing to gather or scatter on a dim > 0: DTensor's redistribution
        return t.redistribute(dm, pl)
    if mid != tuple(t.placements):
        t = t.redistribute(dm, mid)
    if scatters:
        t = _ScatterRows.apply(t, tuple((i, pl[i].dim) for i in scatters))
    if not rows:
        t = gather_dims(t, pl)
    else:
        dims = _gathered_dims(t, pl)
        local = t.to_local().shape
        moves = _moves(t, dims)
        # one row (or a nested split of uneven parts) is left to DTensor's gather below
        if moves is not None and any(math.prod(local[:t.placements[i].dim]) > 1 for i in dims):
            t = _GatherRows.apply(t, moves)
    return t if tuple(t.placements) == tuple(pl) else t.redistribute(dm, pl)


class _GatherOnLeading(torch.autograd.Function):
    """A DTensor's Shard(d) -> Replicate moves, d > 0, on the mesh dims of `moves`
    ((mesh dim, size of d as that mesh dim splits it), innermost first), each
    gathered into one buffer whose leading dim is the gathered one: the local
    shard's dim d moved to the front (a copy of the local part, padded as DTensor
    pads an uneven split), one `all_gather_into_tensor` over the mesh dim, and the
    result a view of it with the dim moved back (DTensor gathers into dim 0 and
    then concatenates the chunks along d: two result-sized buffers at once). The
    values are DTensor's. One autograd node for all the moves: the backward is
    DTensor's redistribution of the gradient back to the input's placements, in
    one step, as `redistribute`'s backward is."""

    @staticmethod
    def forward(ctx, t, moves):
        mesh, pl = t.device_mesh, list(t.placements)
        ctx.mesh, ctx.placements = mesh, tuple(pl)
        out = t.to_local()
        for mesh_dim, size in moves:
            d, n = pl[mesh_dim].dim, mesh.size(mesh_dim)
            local = out.movedim(d, 0)
            rows = -(-size // n)  # torch.chunk's: every rank's shard padded to it
            if local.shape[0] < rows:
                local = torch.cat([local, local.new_zeros(rows - local.shape[0], *local.shape[1:])])
            buf = torch.ops._c10d_functional.all_gather_into_tensor(
                local.contiguous(), n, mesh.get_group(mesh_dim).group_name)
            out = torch.ops._c10d_functional.wait_tensor(buf).movedim(0, d).narrow(d, 0, size)
            pl[mesh_dim] = Replicate()
        return DTensor.from_local(out, mesh, pl, run_check=False, shape=t.shape, stride=t.stride())

    @staticmethod
    def backward(ctx, g):
        # as DTensor's backward: a gradient already whole where the input was a
        # partial sum stays whole
        pl = tuple(Replicate() if p.is_partial() and not q.is_partial() else p
                   for p, q in zip(ctx.placements, g.placements))
        return g.redistribute(ctx.mesh, pl), None


def _moves(t, mesh_dims) -> tuple | None:
    """((mesh dim, size of its d as that mesh dim splits it), ...) of a DTensor `t`
    placed Shard(d), d > 0, on each of `mesh_dims` (each the innermost mesh dim
    then left splitting its d, in order); None for a nested split of d that the
    outer mesh dims do not divide evenly."""
    pl, moves = list(t.placements), []
    for i in mesh_dims:
        d = pl[i].dim
        outer = math.prod(t.device_mesh.size(j) for j, q in enumerate(pl[:i])
                          if type(q) is Shard and q.dim == d)
        if t.shape[d] % outer:
            return None
        moves.append((i, t.shape[d] // outer))
        pl[i] = Replicate()
    return tuple(moves)


def _even_moves(t, mesh_dims) -> tuple:
    """`_moves`, refusing a nested split of uneven parts."""
    moves = _moves(t, mesh_dims)
    if moves is None:
        raise ValueError(f"a dim of {tuple(t.shape)} is split unevenly before one of mesh dims "
                         f"{tuple(mesh_dims)}: {t.placements}")
    return moves


def gather_on_leading(t, mesh_dims):
    """A DTensor `t` placed Shard(d), d > 0, on each of `mesh_dims` (`_moves`) as
    Replicate there, by `_GatherOnLeading`: one result-sized buffer a move, one
    autograd node."""
    return _GatherOnLeading.apply(t, _even_moves(t, mesh_dims))


def _gathered_dims(t, pl) -> list[int]:
    """The mesh dims, innermost first, of `t`'s Shard(d) -> Replicate moves toward
    placements `pl` with d > 0 over more than one rank, each the innermost mesh
    dim then left splitting its d. The others are left to `redistribute`: a move
    of dim 0, and one over a mesh dim of size 1 (no gather: DTensor's no-op)."""
    cur, dims = list(t.placements), []
    for i in reversed(range(len(pl))):
        p = cur[i]
        if type(p) is Shard and p.dim > 0 and t.device_mesh.size(i) > 1 and pl[i].is_replicate() \
                and not any(type(q) is Shard and q.dim == p.dim for q in cur[i + 1:]):
            dims.append(i)
            cur[i] = Replicate()
    return dims


def gather_dims(t, pl):
    """`t` with each of its Shard(d) -> Replicate moves toward placements `pl` made for
    d > 0 over more than one rank (`_gathered_dims`) by `gather_on_leading` (one
    result-sized buffer a move); `t` where there is none."""
    dims = _gathered_dims(t, pl)
    return gather_on_leading(t, dims) if dims else t


def _rows_gathered(local, d: int, n: int, size: int, group: str):
    """This rank's `local` shard of a dim d > 0 of `size` gathered over the n ranks of
    `group` into one contiguous buffer of the result's layout: each of the L rows
    before d (`local.view(L, -1)[i]`, contiguous) gathered into its slice of the
    result (the ranks' chunks contiguous in it, in rank order), one
    `all_gather_into_tensor_out` a row. An uneven split is padded as DTensor pads
    it (every rank's shard to torch.chunk's size) and the result narrowed."""
    rows = -(-size // n)
    if local.shape[d] < rows:
        pad = [0, 0] * (local.dim() - d - 1) + [0, rows - local.shape[d]]
        local = F.pad(local, pad)
    local = local.contiguous()
    L = math.prod(local.shape[:d])
    shape = list(local.shape)
    shape[d] = n * rows
    out = local.new_empty(shape)
    src, dst = local.view(L, -1), out.view(L, -1)
    for i in range(L):
        torch.ops._c10d_functional.all_gather_into_tensor_out(src[i], n, group, out=dst[i])
    for i in range(L):
        torch.ops._c10d_functional.wait_tensor(dst[i])
    return out.narrow(d, 0, size)


def _rows_scattered(full, d: int, n: int, size: int, op: str, group: str, rank: int):
    """This rank's shard of dim d > 0 of a partial sum `full` (dim d of `size`, whole
    over the n ranks of `group`), reduced by `op` over them: each of the L rows
    before d reduce-scattered from its contiguous slice of `full` into its slice
    of the shard, one `reduce_scatter_tensor_out` a row, with no copy of `full`
    (DTensor's `reduce_scatter_single` chunks it and concatenates the chunks on
    dim 0 first). An uneven split is padded as DTensor pads it and the shard
    narrowed to the rank's own size."""
    rows = -(-size // n)
    if size < n * rows:
        pad = [0, 0] * (full.dim() - d - 1) + [0, n * rows - size]
        full = F.pad(full, pad)
    full = full.contiguous()
    L = math.prod(full.shape[:d])
    shape = list(full.shape)
    shape[d] = rows
    out = full.new_empty(shape)
    src, dst = full.view(L, -1), out.view(L, -1)
    for i in range(L):
        torch.ops._c10d_functional.reduce_scatter_tensor_out(src[i], op, n, group, out=dst[i])
    for i in range(L):
        torch.ops._c10d_functional.wait_tensor(dst[i])
    return out.narrow(d, 0, min(rows, max(size - rank * rows, 0)))


class _GatherRows(torch.autograd.Function):
    """A DTensor's Shard(d) -> Replicate moves, d > 0, on the mesh dims of `moves`
    (`_moves`, innermost first), each gathered into row slices of one contiguous
    buffer of the result's layout (`_rows_gathered`): the result is contiguous,
    so a matmul flattens it without a copy, and there is no dim-0 buffer beside it
    (DTensor gathers into dim 0 and then concatenates the chunks along d). The
    values are DTensor's. One autograd node for all the moves; the backward is
    DTensor's `redistribute` backward: the gradient redistributed to the input's
    placements (the other mesh dims first, by DTensor), each moved mesh dim,
    outermost first, by its local chunk where the gradient is replicated there and
    by a row-slice reduce-scatter (`_rows_scattered`) where it is a partial sum."""

    @staticmethod
    def forward(ctx, t, moves):
        mesh, pl = t.device_mesh, list(t.placements)
        ctx.mesh, ctx.placements, ctx.moves = mesh, tuple(pl), moves
        out = t.to_local()
        for mesh_dim, size in moves:
            out = _rows_gathered(out, pl[mesh_dim].dim, mesh.size(mesh_dim), size,
                                 mesh.get_group(mesh_dim).group_name)
            pl[mesh_dim] = Replicate()
        return DTensor.from_local(out, mesh, pl, run_check=False, shape=t.shape, stride=t.stride())

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        # as DTensor's backward: a gradient already whole where the input was a
        # partial sum stays whole
        pl = tuple(Replicate() if p.is_partial() and not q.is_partial() else p
                   for p, q in zip(ctx.placements, g.placements))
        moved = [i for i, _ in ctx.moves]
        if not all(g.placements[i].is_partial() or g.placements[i].is_replicate() for i in moved):
            return g.redistribute(mesh, pl), None
        mid = tuple(g.placements[i] if i in moved else p for i, p in enumerate(pl))
        if mid != tuple(g.placements):
            g = g.redistribute(mesh, mid)
        local = g.to_local()
        for mesh_dim, size in reversed(ctx.moves):
            d, n, p = pl[mesh_dim].dim, mesh.size(mesh_dim), g.placements[mesh_dim]
            rank = mesh.get_local_rank(mesh_dim)
            if p.is_partial():
                local = _rows_scattered(local, d, n, size, p.reduce_op,
                                        mesh.get_group(mesh_dim).group_name, rank)
            else:  # DTensor's replicate-to-shard: the rank's chunk, a copy of its own
                rows = -(-size // n)
                local = local.narrow(d, min(rank * rows, size),
                                     min(rows, max(size - rank * rows, 0)))
                local = local.clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=g.shape,
                                  stride=g.stride()), None


def gather_rows(t, mesh_dims):
    """A DTensor `t` placed Shard(d), d > 0, on each of `mesh_dims` (`_moves`) as
    Replicate there, by `_GatherRows`: each move one contiguous result-sized buffer
    filled row slice by row slice, one autograd node; a partial-sum gradient is
    reduce-scattered row slice by row slice in place of DTensor's dim-0 copy."""
    return _GatherRows.apply(t, _even_moves(t, mesh_dims))


class _ScatterRows(torch.autograd.Function):
    """A DTensor's Partial -> Shard(d) moves, d > 0, on the mesh dims of `moves`
    ((mesh dim, d), d split by no other mesh dim), each reduce-scattered row slice
    by row slice from the partial sum as it stands into one contiguous shard
    (`_rows_scattered`), with no copy of the partial sum (DTensor's
    `reduce_scatter_single` chunks it and concatenates the chunks on dim 0). The
    values are DTensor's. The backward is DTensor's: the gradient placed as the
    input with each partial sum whole (Replicate), each moved mesh dim gathered
    into row slices (`_rows_gathered`) where the gradient is split there as the
    output is, the other mesh dims (and any other placement) by DTensor first."""

    @staticmethod
    def forward(ctx, t, moves):
        mesh, pl = t.device_mesh, list(t.placements)
        ctx.mesh, ctx.placements, ctx.moves = mesh, tuple(pl), moves
        out = t.to_local()
        for mesh_dim, d in moves:
            out = _rows_scattered(out, d, mesh.size(mesh_dim), t.shape[d], pl[mesh_dim].reduce_op,
                                  mesh.get_group(mesh_dim).group_name,
                                  mesh.get_local_rank(mesh_dim))
            pl[mesh_dim] = Shard(d)
        return DTensor.from_local(out, mesh, pl, run_check=False, shape=t.shape, stride=t.stride())

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        pl = tuple(Replicate() if p.is_partial() and not q.is_partial() else p
                   for p, q in zip(ctx.placements, g.placements))
        if not all(g.placements[i] == Shard(d) for i, d in ctx.moves):
            return g.redistribute(mesh, pl), None
        mid = tuple(g.placements[i] if i in dict(ctx.moves) else p for i, p in enumerate(pl))
        if mid != tuple(g.placements):
            g = g.redistribute(mesh, mid)
        local = g.to_local()
        for mesh_dim, d in reversed(ctx.moves):
            local = _rows_gathered(local, d, mesh.size(mesh_dim), g.shape[d],
                                   mesh.get_group(mesh_dim).group_name)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=g.shape,
                                  stride=g.stride()), None


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


def shard_range(t, dim: int):
    """(first index, count, mesh dims splitting it) of this rank's part of dim `dim`
    of a DTensor `t` sharded on it over those mesh dims, major to minor; the
    whole dim off a mesh or where it is not split."""
    if not is_dtensor(t):
        return 0, t.shape[dim], ()
    mesh = t.device_mesh
    return (*block_of(mesh.get_coordinate(), t.placements, mesh, t.shape[dim], dim),
            _split_dims(t, dim))


def block_of(coord, pl, mesh, n: int, dim: int = 0) -> tuple[int, int]:
    """(first, count) of the part of a dim `dim` of `n` that the rank at mesh
    coordinate `coord` holds under placements `pl`: its part where mesh dims shard
    the dim (major to minor, evenly), all of it elsewhere."""
    part, parts = 0, 1
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            part, parts = part * mesh.size(i) + coord[i], parts * mesh.size(i)
    return part * (n // parts), n // parts


def take_rows(t, start: int, stop: int, pl):
    """Rows [start, stop) of dim 0 of a DTensor `t`, as a DTensor placed `pl` (dim 0
    sharded over mesh dims that shard it in `t`, or not sharded; replicated on
    every other mesh dim, as `t` is). Each rank receives its part of the rows
    from the ranks that hold them, point to point within the ranks that differ
    from it only on the mesh dims sharding `t`'s rows (a collective-permute), and
    keeps what it holds itself: no rank forms more of `t` than its part of the
    result. Not differentiable (a batch's rows)."""
    mesh = t.device_mesh
    own = tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard))
    if any(t.placements[i].dim != 0 for i in own) or any(
            isinstance(p, Shard) and i not in own for i, p in enumerate(pl)):
        raise ValueError(f"take_rows moves rows of dim 0 only: {t.placements} -> {pl}")
    me, n = list(mesh.get_coordinate()), stop - start
    with _disable_current_modes():  # the rank grid is a real tensor, also under a fake mode
        ranks = mesh.mesh.tolist()
    peers = []  # (global rank, coordinate) of the ranks that differ from this one on `own`
    for c in itertools.product(*(range(mesh.size(i)) for i in own)):
        coord = list(me)
        for i, ci in zip(own, c):
            coord[i] = ci
        peers.append((functools.reduce(list.__getitem__, coord, ranks), coord))
    local = t.to_local()
    h0, hn = block_of(me, t.placements, mesh, t.shape[0])  # the rows this rank holds
    t0, tn = block_of(me, pl, mesh, n)  # and those of the result it needs
    t0 += start
    out = local.new_empty((tn, *local.shape[1:]))
    ops = []
    with torch.no_grad():
        for rank, coord in peers:
            s0, sn = block_of(coord, t.placements, mesh, t.shape[0])
            lo, hi = max(t0, s0), min(t0 + tn, s0 + sn)  # the peer's rows that this rank needs
            if coord == me:
                if lo < hi:
                    out[lo - t0:hi - t0] = local[lo - h0:hi - h0]
                continue
            if lo < hi:
                ops.append(dist.P2POp(dist.irecv, out[lo - t0:hi - t0], rank))
            q0, qn = block_of(coord, pl, mesh, n)
            lo, hi = max(start + q0, h0), min(start + q0 + qn, h0 + hn)  # this rank's it needs
            if lo < hi:
                ops.append(dist.P2POp(dist.isend, local[lo - h0:hi - h0].contiguous(), rank))
        for work in dist.batch_isend_irecv(ops) if ops else ():
            work.wait()
    shape = (n, *t.shape[1:])
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _split_dims(t, dim: int) -> tuple[int, ...]:
    """The mesh dims that shard dim `dim` of a DTensor `t`, major to minor."""
    return tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim == dim)


def _block_peers(mesh, own: tuple[int, ...]) -> tuple:
    """(global rank of the previous block, of the next block) of this rank along the
    mesh dims `own` that split a dim (major to minor), None past either end."""
    me = list(mesh.get_coordinate())
    sizes = [mesh.size(i) for i in own]
    b = 0
    for i, n in zip(own, sizes):
        b = b * n + me[i]
    with _disable_current_modes():  # the rank grid is a real tensor, also under a fake mode
        ranks = mesh.mesh.tolist()

    def rank_of(block):
        if not 0 <= block < math.prod(sizes):
            return None
        coord = list(me)
        for i, n in zip(reversed(own), reversed(sizes)):
            coord[i], block = block % n, block // n
        return functools.reduce(list.__getitem__, coord, ranks)

    return rank_of(b - 1), rank_of(b + 1)


def _swap_rows(send, recv, send_to, recv_from) -> None:
    """Send `send` to rank `send_to` and receive `recv` from `recv_from`, point to
    point (either None: no message that way)."""
    ops = []
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, recv, recv_from))
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), send_to))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()


class _ShiftRows(torch.autograd.Function):
    """A rank's block (B, s, ...) of a sequence shifted by one row: the previous
    block's last row (received from `left`; zeros for the first block), then the
    block's first s - 1 rows. The block's last row is sent to `right`. The
    backward moves the received row's gradient back to `left`, point to point."""

    @staticmethod
    def forward(ctx, t, left, right):
        ctx.left, ctx.right = left, right
        halo = t.new_zeros(t.shape[0], 1, *t.shape[2:])
        _swap_rows(t[:, -1:], halo, right, left)
        return torch.cat([halo, t[:, :-1]], 1)

    @staticmethod
    def backward(ctx, g):
        tail = g.new_zeros(g.shape[0], 1, *g.shape[2:])
        _swap_rows(g[:, :1], tail, ctx.left, ctx.right)
        return torch.cat([g[:, 1:], tail], 1), None, None


def shift_rows(t):
    """The token shift of a sequence t (B, S, ...): row i - 1 at row i, zeros at row 0,
    `F.pad(t, (.., 1, 0))[:, :S]`. On a DTensor whose sequence (dim 1) mesh dims
    split, each rank shifts its own block and gets the one row it lacks, the last
    row of the previous block, from the rank that holds it (a collective-permute
    of B_local x ... elements; the backward sends that row's gradient back): no
    rank forms more of the sequence than its block. Differentiable."""
    own = _split_dims(t, 1) if is_dtensor(t) else ()
    if not own:
        return on_shards(lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (1, 0))[:, :a.shape[1]], t)
    left, right = _block_peers(t.device_mesh, own)
    return on_local(lambda a: _ShiftRows.apply(a, left, right), t, out=[t.placements])


def last_row(t):
    """`t[:, -1]` of a sequence t (B, S, ...). On a DTensor whose sequence (dim 1) mesh
    dims split, the rank holding the last block broadcasts its last row along
    those mesh dims (minor first), placed as `t` is on every other dim: no rank
    gathers `t` for one row (DTensor's `select` on a split dim would). Not
    differentiable there (a state handed on, such as a prefill's token-shift row)."""
    own = _split_dims(t, 1) if is_dtensor(t) else ()
    if not own:
        return t[:, -1]
    mesh = t.device_mesh
    with torch.no_grad():
        row = t.to_local()[:, -1].contiguous()
        for i in reversed(own):
            dist.broadcast(row, group=mesh.get_group(i), group_src=mesh.size(i) - 1)
    pl = [Replicate() if i in own else Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
          else p for i, p in enumerate(t.placements)]
    shape = t.shape[:1] + t.shape[2:]
    return DTensor.from_local(row, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


_REDUCE = {"max": (dist.ReduceOp.MAX, torch.amax), "min": (dist.ReduceOp.MIN, torch.amin),
           "sum": (dist.ReduceOp.SUM, torch.sum)}


def reduce_parts(t, op: str, mesh=None, dims=()):
    """`t`'s parts reduced by `op` ("max", "min" or "sum"): with `mesh`, this rank
    holds one part and the parts are the ranks along the mesh dims `dims`
    (all-reduces in place, in t's dtype); without it, the parts lie on t's
    leading dim."""
    red, local = _REDUCE[op]
    if mesh is None:
        return local(t, 0)
    for d in dims:
        dist.all_reduce(t, op=red, group=mesh.get_group(d))
    return t


class SumOverRanks(torch.autograd.Function):
    """`t` summed over the ranks of the mesh dims `dims` (all-reduces, in float32, as
    one device's GEMM accumulates its products), the same on every rank, in t's
    dtype, inside a local function. The backward sums the gradient likewise
    where each rank goes on to use the sum in a function of its own part
    (`own_use`: the gradient a rank holds is its own share), and passes it as it
    is where the ranks go on with the sum as one replicated value (each holds the
    whole gradient)."""

    @staticmethod
    def forward(ctx, t, mesh, dims, own_use: bool):
        ctx.mesh, ctx.dims, ctx.own_use = mesh, dims, own_use
        return reduce_parts(t.to(torch.float32, copy=True), "sum", mesh, dims).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.own_use:
            g = reduce_parts(g.to(torch.float32, copy=True), "sum", ctx.mesh, ctx.dims).to(g.dtype)
        return g, None, None, None


def lse_combine(o, lse, mesh=None, dims=()):
    """Flash-decode's combine of partial attention outputs over parts of a cache's
    length: o (..., dh) each part's output over its own slots, lse (...) its
    log-sum-exp of the scaled scores; returns the output over all of them, float32:
    m = max_r lse_r, o = sum_r exp(lse_r - m) o_r / sum_r exp(lse_r - m). A part
    with no valid slot gives o = 0, lse = NEG_INF (-1e30, not -inf: no NaN arises).
    The parts are ranks or a leading dim, as `reduce_parts` reads them."""
    lse = lse.float()
    w = torch.exp(lse - reduce_parts(lse.clone(), "max", mesh, dims))
    return (reduce_parts(o.float() * w[..., None], "sum", mesh, dims)
            / reduce_parts(w, "sum", mesh, dims)[..., None])


def ce_combine(lse, gold, top, arg, mesh=None, dims=()):
    """The vocab-parallel CE's combine of its parts, each a block of the vocabulary:
    lse (...) each part's log-sum-exp of its logits, gold (...) the label's logit
    where the label lies in the part (0 elsewhere), top (...) the part's largest
    logit and arg (...) its lowest global index. Returns (lse, gold, argmax) over
    the whole vocabulary: m = max_r lse_r, lse = m + log sum_r exp(lse_r - m); gold
    the sum; argmax the lowest index among the parts whose top is the largest,
    as `torch.argmax` breaks ties over the whole. On a mesh, three all-reduces a
    mesh dim; the parts are ranks or a leading dim, as `reduce_parts` reads them."""
    mx = reduce_parts(torch.stack([lse, top], -1), "max", mesh, dims)
    m, best = mx[..., 0], mx[..., 1]
    s = reduce_parts(torch.stack([torch.exp(lse - m), gold], -1), "sum", mesh, dims)
    cand = torch.where(top == best, arg, torch.iinfo(arg.dtype).max)
    return m + torch.log(s[..., 0]), s[..., 1], reduce_parts(cand, "min", mesh, dims)


def whole(t):
    """A DTensor as the plain tensor of its full value, the same on every rank
    (differentiable): `full_tensor`, each gather of a dim d > 0 whose shard has
    L > 1 rows before d into row slices of one buffer (`move`, as `shard`'s);
    anything else as is."""
    if not is_dtensor(t):
        return t
    return move(t, (Replicate(),) * t.device_mesh.ndim).to_local()

