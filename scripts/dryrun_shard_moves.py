#!/usr/bin/env python3
"""Trace dry-run cells and count the Shard -> Shard moves each one makes.

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
DIR/moves/. `--report` prints one markdown row a cell: its moves, the largest
moved local tensor, and the bound on what the move can change in the cell's
peak, (mesh-dim size - 1) x that tensor. A CPU trace of fake tensors: no device
number. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
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


def sweep(args) -> None:
    out = Path(args.out)
    (out / "moves").mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    dryrun.init_fake_world(256 if args.mesh == "single" else 512)
    try:
        for arch in args.arch:
            for shape in args.shape:
                for mp in meshes:
                    with MoveCounter() as counter:
                        rec = dryrun.run_cell(arch, shape, mp, str(out), force=True)
                    if rec["status"] == "skipped":
                        continue
                    name = f"{arch}__{shape}__{rec['mesh']}.json"
                    (out / "moves" / name).write_text(json.dumps(
                        {"status": rec["status"], "moves": counter.moves}, indent=1))
                    print(f"  {len(counter.moves)} Shard -> Shard moves")
    finally:
        dist.destroy_process_group()


def report(root: Path) -> None:
    print("| cell | mesh | status | Shard -> Shard moves | largest moved local tensor "
          "| bound on the peak's change GiB |")
    print("| --- | --- | --- | --- | --- | --- |")
    for path in sorted((root / "moves").glob("*.json")):
        arch, shape, mesh = path.stem.split("__")
        rec = json.loads(path.read_text())
        moves = rec["moves"]
        big = max(moves, key=lambda m: m["bytes"], default=None)
        largest = (f"{tuple(big['shape'])} {big['dtype']} over {big['mesh_dim_size']}"
                   if big else "—")
        bound = ((big["mesh_dim_size"] - 1) * big["bytes"] / GIB) if big else 0.0
        print(f"| {arch} {shape} | {mesh} | {rec['status']} | {len(moves)} | {largest} "
              f"| {bound:.3f} |")


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
