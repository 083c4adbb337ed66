#!/usr/bin/env python3
"""Trace dry-run cells and count the Shard -> Shard moves, the Shard(d > 0) ->
Replicate gathers and the Partial -> Shard(d > 0) reduce-scatters each one makes.

  PYTHONPATH=src python scripts/dryrun_shard_moves.py --out DIR [--arch A ...]
      [--shape S ...] [--mesh single|multi|both]
  PYTHONPATH=src python scripts/dryrun_shard_moves.py --report DIR

Runs `python -m repro_torch.launch.dryrun --force`'s cells (`run_cell`, the cell
records written to DIR as the dry-run writes them, so `scripts/dryrun_compare.py`
reads them) with a counter around every Shard -> Shard redistribution: DTensor's
`Shard._to_new_shard_dim`, which pads the local tensor and hands it to the
`shard_dim_alltoall` that `torch.distributed.tensor.placement_types` calls. Each
move is recorded with the padded local tensor that function is given (shape,
dtype, bytes) and the size of the mesh dim it moves over, one file a cell under
DIR/moves/. Each gather that DTensor makes of a dim other than the first
(`Shard._to_replicate_tensor` with `dim > 0`, which gathers into dim 0 and then
concatenates the chunks along the dim: two result-sized buffers) is recorded
beside them with its local tensor, the mesh dim's size and the innermost frame
of `repro_torch` that asked for it. So is each reduce-scatter that DTensor makes
onto a dim other than the first (`Shard._reduce_shard_tensor` with `dim > 0`,
which copies the partial sum into chunks along dim 0 before it reduces:
`reduce_scatter_single`'s chunk-and-cat), with the partial tensor it is given.
Each gather and reduce-scatter also records L, the product of the dims before
its dim (of the local tensor, of the partial one): where L > 1 the port's own
row-slice gather (`axes.gather_rows`) can take the move. `--report` prints one
markdown row a cell: its moves, the largest moved local tensor, the bound on
what the move can change in the cell's peak, (mesh-dim size - 1) x that tensor,
its gathers and reduce-scatters on a dim > 0 (those with L > 1 in brackets)
with their largest result and their sites; then those gathers and
reduce-scatters summed over the cells by site. A CPU trace of fake tensors: no
device number. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import placement_types  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

GIB = 2**30


class MoveCounter:
    """While open, records each Shard -> Shard move: the padded local tensor that
    `placement_types.shard_dim_alltoall` is given (whatever function stands there),
    its dims and the mesh dim's size."""

    def __init__(self):
        self.moves: list[dict] = []

    def __enter__(self):
        shard = placement_types.Shard
        self._orig = orig = shard._to_new_shard_dim
        moves = self.moves

        @functools.wraps(orig)  # so that `inspect` reads DTensor's own source through it
        def counted(placement, local_tensor, mesh, mesh_dim, logical_shape, new_dim):
            inner = placement_types.shard_dim_alltoall

            def record(t, gather_dim, shard_dim, mesh_, mesh_dim_):
                moves.append({"shape": list(t.shape), "dtype": str(t.dtype).removeprefix("torch."),
                              "bytes": t.numel() * t.element_size(), "gather_dim": gather_dim,
                              "shard_dim": shard_dim, "mesh_dim_size": mesh_.size(mesh_dim_)})
                return inner(t, gather_dim, shard_dim, mesh_, mesh_dim_)

            placement_types.shard_dim_alltoall = record
            try:
                return orig(placement, local_tensor, mesh, mesh_dim, logical_shape, new_dim)
            finally:
                placement_types.shard_dim_alltoall = inner

        shard._to_new_shard_dim = counted
        return self

    def __exit__(self, *exc):
        placement_types.Shard._to_new_shard_dim = self._orig


def _site() -> str:
    """The innermost frames of `repro_torch` on the stack: the first outside
    `parallel/axes.py` and, where one lies between, the helper of `axes.py` it
    called, as "file.py:line function > axes.py:line function"."""
    frames = [fr for fr in traceback.extract_stack() if "repro_torch" in fr.filename]
    helper = ""
    for fr in reversed(frames):
        name = f"{Path(fr.filename).name}:{fr.lineno} {fr.name}"
        if not fr.filename.endswith("axes.py"):
            return name + helper
        helper = helper or f" > {name}"
    return helper.removeprefix(" > ") or "?"


class GatherCounter:
    """While open, records each gather DTensor makes of a dim other than the first:
    `Shard._to_replicate_tensor` of a `Shard(d)`, d > 0, with the local tensor it is
    given, the mesh dim's size, the result's bytes and the site that asked."""

    def __init__(self):
        self.gathers: list[dict] = []

    def __enter__(self):
        shard = placement_types.Shard
        self._orig = orig = shard._to_replicate_tensor
        gathers = self.gathers

        @functools.wraps(orig)
        def counted(placement, local_tensor, mesh, mesh_dim, logical_shape):
            if type(placement) is shard and placement.dim > 0:
                n = mesh.size(mesh_dim)
                nbytes = local_tensor.numel() * local_tensor.element_size()
                gathers.append({"shape": list(local_tensor.shape), "dim": placement.dim,
                                "lead": math.prod(local_tensor.shape[:placement.dim]),
                                "dtype": str(local_tensor.dtype).removeprefix("torch."),
                                "bytes": nbytes, "result_bytes": n * nbytes,
                                "mesh_dim_size": n, "site": _site()})
            return orig(placement, local_tensor, mesh, mesh_dim, logical_shape)

        shard._to_replicate_tensor = counted
        return self

    def __exit__(self, *exc):
        placement_types.Shard._to_replicate_tensor = self._orig


class ReduceScatterCounter:
    """While open, records each reduce-scatter DTensor makes onto a dim other than the
    first: `Shard._reduce_shard_tensor` of a `Shard(d)`, d > 0, with the partial
    tensor it is given, the mesh dim's size, the result's bytes and the site."""

    def __init__(self):
        self.scatters: list[dict] = []

    def __enter__(self):
        shard = placement_types.Shard
        self._orig = orig = shard._reduce_shard_tensor
        scatters = self.scatters

        @functools.wraps(orig)
        def counted(placement, tensor, mesh, reduce_op, mesh_dim):
            if type(placement) is shard and placement.dim > 0:
                n = mesh.size(mesh_dim)
                nbytes = tensor.numel() * tensor.element_size()
                scatters.append({"shape": list(tensor.shape), "dim": placement.dim,
                                 "lead": math.prod(tensor.shape[:placement.dim]),
                                 "dtype": str(tensor.dtype).removeprefix("torch."),
                                 "bytes": nbytes, "result_bytes": nbytes // n,
                                 "mesh_dim_size": n, "site": _site()})
            return orig(placement, tensor, mesh, reduce_op, mesh_dim)

        shard._reduce_shard_tensor = counted
        return self

    def __exit__(self, *exc):
        placement_types.Shard._reduce_shard_tensor = self._orig


def sweep(args) -> None:
    out = Path(args.out)
    (out / "moves").mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    dryrun.init_fake_world(256 if args.mesh == "single" else 512)
    try:
        for arch in args.arch:
            for shape in args.shape:
                for mp in meshes:
                    with MoveCounter() as counter, GatherCounter() as gathers, \
                            ReduceScatterCounter() as scatters:
                        rec = dryrun.run_cell(arch, shape, mp, str(out), force=True)
                    if rec["status"] == "skipped":
                        continue
                    name = f"{arch}__{shape}__{rec['mesh']}.json"
                    (out / "moves" / name).write_text(json.dumps(
                        {"status": rec["status"], "moves": counter.moves,
                         "gathers": gathers.gathers, "scatters": scatters.scatters}, indent=1))
                    print(f"  {len(counter.moves)} Shard -> Shard moves, "
                          f"{len(gathers.gathers)} Shard(d > 0) -> Replicate gathers, "
                          f"{len(scatters.scatters)} Partial -> Shard(d > 0) reduce-scatters")
    finally:
        dist.destroy_process_group()


def report(root: Path) -> None:
    print("| cell | mesh | status | Shard -> Shard moves | largest moved local tensor "
          "| bound on the peak's change GiB | Shard(d > 0) -> Replicate gathers (L > 1) "
          "| largest result GiB | sites | Partial -> Shard(d > 0) reduce-scatters (L > 1) "
          "| largest input GiB | sites |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for path in sorted((root / "moves").glob("*.json")):
        arch, shape, mesh = path.stem.split("__")
        rec = json.loads(path.read_text())
        moves = rec["moves"]
        big = max(moves, key=lambda m: m["bytes"], default=None)
        largest = (f"{tuple(big['shape'])} {big['dtype']} over {big['mesh_dim_size']}"
                   if big else "—")
        bound = ((big["mesh_dim_size"] - 1) * big["bytes"] / GIB) if big else 0.0
        cols = []
        for key, size in (("gathers", "result_bytes"), ("scatters", "bytes")):
            found = rec.get(key, [])
            rows = sum(g.get("lead", 0) > 1 for g in found)
            top = max((g[size] for g in found), default=0) / GIB
            sites = ", ".join(sorted({g["site"] for g in found})) or "—"
            cols.append(f"{len(found)} ({rows}) | {top:.3f} | {sites}")
        print(f"| {arch} {shape} | {mesh} | {rec['status']} | {len(moves)} | {largest} "
              f"| {bound:.3f} | {' | '.join(cols)} |")
    totals(root)


def totals(root: Path) -> None:
    """The gathers and reduce-scatters on a dim > 0 of every cell under `root`, summed
    by site: count, those with L > 1, and the cells they occur in."""
    sites: dict = {}
    for path in sorted((root / "moves").glob("*.json")):
        rec = json.loads(path.read_text())
        for key in ("gathers", "scatters"):
            for g in rec.get(key, []):
                row = sites.setdefault((key, g["site"]), [0, 0, set()])
                row[0] += 1
                row[1] += g.get("lead", 0) > 1
                row[2].add(path.stem)
    print("\n| kind | site | count | L > 1 | cells |")
    print("| --- | --- | --- | --- | --- |")
    for key in ("gathers", "scatters"):
        rows = {site: v for (k, site), v in sites.items() if k == key}
        for site, (n, lead, cells) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
            print(f"| {key} | {site} | {n} | {lead} | {len(cells)} |")
        print(f"| {key} | all | {sum(v[0] for v in rows.values())} "
              f"| {sum(v[1] for v in rows.values())} | {len(set().union(*(v[2] for v in rows.values())))} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--report")
    ap.add_argument("--arch", nargs="*", default=ARCHS)
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    args = ap.parse_args(argv)
    if args.report:
        report(Path(args.report))
    elif args.out:
        sweep(args)
    else:
        ap.error("give --out DIR (trace) or --report DIR")


if __name__ == "__main__":
    main()
