"""Compiled-HLO analysis: collective inventory + loop-aware cost accounting.

XLA's `compiled.cost_analysis()` counts a `while` body ONCE regardless of trip
count (verified empirically — see EXPERIMENTS.md §Methodology), and our models
deliberately use scan-over-layers / chunked-attention loops so 32k-sequence
steps fit in memory. This module therefore:

  * parses the post-SPMD HLO text into computations,
  * inventories every collective (all-reduce / all-gather / reduce-scatter /
    all-to-all / collective-permute) with its result bytes,
  * marks whether each sits inside a while body (loop-resident), so the
    roofline layer can apply the *known* trip counts (num scanned layers,
    chunk counts) that the HLO itself cannot carry.

The authoritative FLOP/byte numbers for §Roofline come from the analytic
operator graph in `repro.core.operators` (the paper's own methodology); the
raw cost_analysis numbers are recorded alongside as a cross-check.

A copy of `repro.core.hlo` (the port imports nothing of the JAX package): the
text functions are the original's, and `tests/test_torch_cellcost_hlo.py` holds
them to it. The aggregation is `summarize_collectives`, over `CollectiveOp`s
from any source. The port compiles no HLO, so it adds its own source of them:
`CollectiveInventory`, a dispatch mode that records each collective a step
dispatches on this rank (c10d's, the functional collectives' and DTensor's
Shard -> Shard all-to-all), on a fake
world under `FakeTensorMode` (the dry-run) as on a real process group (an
executed step). Its ops have `loop_depth` 0: the port's layer and chunk loops
are Python, each iteration an op of its own, so `once_bytes` is the step's whole
volume, which `collective_traffic_bytes(summary, trip_counts)` reconstructs from
an HLO summary.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
)

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """Total bytes of all array shapes in an HLO result type string."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class CollectiveOp:
    kind: str
    bytes: int
    shape: str
    op_name: str
    loop_depth: int  # number of enclosing while bodies (from JAX metadata)

    @property
    def in_loop(self) -> bool:
        return self.loop_depth > 0


_OP_NAME_RE = re.compile(r'op_name="([^"]*)"')


def parse_collectives(hlo_text: str) -> list[CollectiveOp]:
    """Inventory collectives using JAX-emitted metadata for loop residency.

    Every op lowered from inside a lax.scan/while carries
    `metadata={op_name=".../while/body/..."}`; the count of "while/body"
    segments gives the loop-nesting depth (e.g. a TP all-reduce inside the
    chunked-attention scan inside the layer scan has depth 2).
    """
    ops: list[CollectiveOp] = []
    for ln in hlo_text.splitlines():
        # skip async -done halves so -start/-done pairs count once
        if "-done(" in ln:
            continue
        for kind in COLLECTIVE_KINDS:
            if f" {kind}(" in ln or f" {kind}-start(" in ln:
                rhs = ln.split("=", 1)[1] if "=" in ln else ln
                shape_part = rhs.split(kind + "(")[0].split(kind + "-start(")[0]
                m = _OP_NAME_RE.search(ln)
                op_name = m.group(1) if m else ""
                ops.append(
                    CollectiveOp(
                        kind=kind,
                        bytes=_shape_bytes(shape_part),
                        shape=shape_part.strip(),
                        op_name=op_name,
                        loop_depth=op_name.count("while/body"),
                    )
                )
                break
    return ops


def summarize_collectives(ops: list[CollectiveOp]) -> dict:
    """Aggregated collective stats of `ops` (per-device bytes): by (kind,
    loop_depth), largest bytes first; `once_bytes` sums the ops outside any
    loop, `loop_bytes_per_iter` one iteration of those inside."""
    agg: dict[tuple[str, int], dict] = {}
    for op in ops:
        k = (op.kind, op.loop_depth)
        a = agg.setdefault(
            k, {"kind": op.kind, "loop_depth": op.loop_depth, "count": 0, "bytes": 0}
        )
        a["count"] += 1
        a["bytes"] += op.bytes
    out = [a for _, a in
           sorted(agg.items(), key=lambda kv: (-kv[1]["bytes"], kv[0]))]
    return {
        "ops": out,
        "once_bytes": sum(a["bytes"] for a in out if a["loop_depth"] == 0),
        "loop_bytes_per_iter": sum(a["bytes"] for a in out if a["loop_depth"] > 0),
        "n_ops": len(ops),
    }


def collective_summary(hlo_text: str) -> dict:
    """Aggregated collective stats for a compiled module (per-device bytes)."""
    return summarize_collectives(parse_collectives(hlo_text))


def collective_traffic_bytes(summary: dict, trip_counts: dict[int, int] | int) -> int:
    """Total per-device collective bytes with loop-resident ops multiplied.

    `trip_counts`: either a single multiplier for all loop-resident ops, or a
    {depth: multiplier} map (depth-2 ops get e.g. L * n_chunks).
    """
    total = summary["once_bytes"]
    for a in summary["ops"]:
        d = a["loop_depth"]
        if d == 0:
            continue
        mult = trip_counts if isinstance(trip_counts, int) else trip_counts.get(d, 1)
        total += a["bytes"] * mult
    return int(total)


# the collective kind of each op a step can dispatch, by (namespace, name): the
# functional collectives' result is their return value, c10d's the buffers of
# their first argument (written in place). A send is left out: the bytes it
# moves are its peer's result, counted there as a recv, as a collective-permute
# counts once on each rank (a functional `batch_p2p_ops` returns an empty tensor
# for each send and the buffer of each recv). A broadcast has no kind in
# `COLLECTIVE_KINDS`; it is kept under XLA's name for it, and c10d's reduce, gather
# and scatter, which XLA has no name for, under torch's.
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
    "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast",
}
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "collective-broadcast",
    "reduce_": "reduce",
    "gather_": "gather",
    "scatter_": "scatter",
}
# DTensor's Shard -> Shard move on a CUDA mesh (`_collective_utils.shard_dim_alltoall`,
# and on a CPU mesh under `launch.dryrun.shard_moves_as_alltoall`): an all-to-all
# whose result is this rank's local output, the padded buffer DTensor hands it
_DTENSOR = {"shard_dim_alltoall": "all-to-all"}
_KINDS = {"_c10d_functional": _FUNCTIONAL, "_c10d_functional_autograd": _FUNCTIONAL,
          "c10d": _C10D, "_dtensor": _DTENSOR}
# what these namespaces dispatch that moves no data of a step's own, or whose
# data another op counts
_NOT_COUNTED = {"wait_tensor", "_wrap_tensor_autograd", "check_for_nan", "barrier",
                "monitored_barrier_", "send", "isend"}

_HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int32: "s32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}


def _hlo_shape(t: torch.Tensor) -> str:
    dtype = _HLO_DTYPE.get(t.dtype, str(t.dtype).removeprefix("torch."))
    return f"{dtype}[{','.join(str(n) for n in t.shape)}]"


def _collective_kind(func) -> str | None:
    """The collective kind of a dispatched op (`None` for any other op). Read are the
    four namespaces of the collectives torch dispatches (`_c10d_functional`, its
    autograd twin, `c10d` and DTensor's `_dtensor`: every op that
    `torch.distributed._tools.fake_collectives` lists has a kind in `_KINDS` or
    stands in `_NOT_COUNTED`, `tests/test_torch_alltoall.py` checks it). The kind
    is one of `COLLECTIVE_KINDS`, "collective-broadcast", c10d's "reduce",
    "gather" or "scatter", or, for an op of these namespaces that has no entry
    here (a newer torch's), `namespace.name`, so that it is recorded, not lost."""
    ns = getattr(func, "namespace", None)
    if ns not in _KINDS:
        return None
    name = func._opname  # e.g. "all_gather_into_tensor", without the overload
    if name in _NOT_COUNTED:
        return None
    return _KINDS[ns].get(name, f"{ns}.{name}")


def is_collective(func) -> bool:
    """Whether a dispatched op is a collective that `CollectiveInventory` records."""
    return _collective_kind(func) is not None


class CollectiveInventory(TorchDispatchMode):
    """Records each collective dispatched on this rank while the mode is open, as
    a `CollectiveOp`: its kind (`_collective_kind`), the bytes of its result on
    this rank (what JAX's parser reads off the HLO result type), that result's
    shape in HLO's notation, the op's name, and `loop_depth` 0.

    Ops on DTensors are handed back (`NotImplemented`) so that DTensor turns
    them into the collectives and local ops it runs, which come through here.
    Open it inside a `FakeTensorMode`, so that it sees each op first.

    Each collective is recorded once, as the op this rank dispatches: what its
    implementation runs below it (the process group's own all-to-all inside
    `_dtensor.shard_dim_alltoall`, a fake implementation's local ops) runs while
    this mode's handler runs, with the mode off the stack, so it is not seen a
    second time."""

    def __init__(self):
        super().__init__()
        self.ops: list[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        kind = _collective_kind(func)
        if kind is not None:
            result = args[0] if func.namespace == "c10d" else out
            tensors = [t for t in tree_leaves(result) if isinstance(t, torch.Tensor)]
            shape = ", ".join(_hlo_shape(t) for t in tensors)
            self.ops.append(CollectiveOp(
                kind=kind, bytes=sum(t.numel() * t.element_size() for t in tensors),
                shape=f"({shape})" if len(tensors) > 1 else shape, op_name=str(func),
                loop_depth=0))
        return out

    def summary(self) -> dict:
        """`summarize_collectives` of the ops recorded: `collective_summary`'s
        shape, each op's bytes once (`once_bytes` the whole volume)."""
        return summarize_collectives(self.ops)
