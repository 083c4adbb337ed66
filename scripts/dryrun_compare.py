#!/usr/bin/env python3
"""Per-rank peaks of two dry-run sweeps side by side, beside the paper's memory model.

  PYTHONPATH=src python scripts/dryrun_compare.py BEFORE_DIR AFTER_DIR

Reads the cell records (`<arch>__<shape>__<mesh>.json`) that `python -m
repro_torch.launch.dryrun --out DIR` writes (for example one sweep of a
checkout of the parent commit and one of the change) and prints one markdown
row a cell found in either: the traced peak per rank before and after (GiB),
their difference ("0" where the bytes are equal), whether the flops and the
collectives (kind by kind, count and bytes) are equal, else the change's, and
for a train cell `core.memory.training_memory`'s total for the cell's own
policy and mesh (the §5.1 model that `pick_train_policy` fits to 16e9 x 0.9
bytes). A cell that is missing or in error says so. These are CPU traces of
fake tensors: no device number. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core.memory import training_memory  # noqa: E402
from repro_torch.launch.dryrun import ARCH_TRAIN_OVERRIDES  # noqa: E402

GIB = 2**30
MESHES = {"pod16x16": (16, 16), "pod2x16x16": (32, 16)}  # (dp, tp)


def _records(root: Path) -> dict:
    out = {}
    for path in sorted(root.glob("*__*__*.json")):
        rec = json.loads(path.read_text())
        out[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return out


def _peak(rec) -> str:
    if rec is None:
        return "not traced"
    if rec["status"] != "ok":
        return rec["status"]
    return f"{rec['memory']['peak_bytes_per_device'] / GIB:.2f}"


def model_gib(arch: str, shape_name: str, mesh: str, policy: dict) -> float:
    """`training_memory`'s total, GiB a rank, of a train cell under its policy."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    dp, tp = MESHES[mesh]
    per_replica = max(shape.global_batch // dp, 1)
    mem = training_memory(cfg, global_batch=shape.global_batch, seq=shape.seq_len, dp=dp, tp=tp,
                          pp=1, sp=True, microbatch=per_replica // policy["microbatches"],
                          recompute=policy["remat"], zero1=True,
                          opt_8bit=ARCH_TRAIN_OVERRIDES.get(arch, {}).get("optimizer") == "adamw8bit")
    return mem.total / GIB


def main(argv=None) -> None:
    before_dir, after_dir = (Path(a) for a in (argv or sys.argv[1:]))
    before, after = _records(before_dir), _records(after_dir)
    print("| cell | mesh | before GiB | after GiB | change GiB | flops | collectives "
          "| training_memory GiB |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for key in sorted(set(before) | set(after)):
        b, a = before.get(key), after.get(key)
        arch, shape, mesh = key
        change = flops = colls = "—"
        if b and a and b["status"] == a["status"] == "ok":
            d = a["memory"]["peak_bytes_per_device"] - b["memory"]["peak_bytes_per_device"]
            change = f"{d / GIB:+.3f}" if d else "0"
            fb, fa = b["cost"]["flops_per_device"], a["cost"]["flops_per_device"]
            flops = "equal" if fa == fb else f"{fb} -> {fa}"
            kb, ka = _kinds(b["collectives"]), _kinds(a["collectives"])
            colls = "equal" if ka == kb else "; ".join(
                f"{k} {kb.get(k, (0, 0))} -> {ka.get(k, (0, 0))}" for k in sorted(set(ka) | set(kb))
                if ka.get(k) != kb.get(k))
        policy = (a or b or {}).get("policy")
        model = f"{model_gib(arch, shape, mesh, policy):.2f}" if policy else "—"
        print(f"| {arch} {shape} | {mesh} | {_peak(b)} | {_peak(a)} | {change} | {flops} | {colls} "
              f"| {model} |")


def _kinds(summary: dict) -> dict:
    """{kind: (count, bytes)} of a record's collectives."""
    out: dict = {}
    for op in summary["ops"]:
        c, n = out.get(op["kind"], (0, 0))
        out[op["kind"]] = (c + op["count"], n + op["bytes"])
    return out


if __name__ == "__main__":
    main()
