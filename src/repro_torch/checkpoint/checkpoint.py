"""Fault-tolerant checkpointing: async, atomic (`repro.checkpoint.checkpoint`).

JAX's file format, so that a checkpoint written by either restores into the
other: <dir>/step_<N>/{manifest.json, arrays.npz}, a leaf's key its path
joined by "/", bfloat16 stored as uint16 with "bfloat16" in the manifest's
dtypes. Reading bfloat16 views the int16 bits as `torch.bfloat16`: no
`ml_dtypes` is needed. Writes go to a tmp dir, then `os.replace()`, so a
crash mid-write never corrupts the latest checkpoint. `save` copies the
state to the host, then writes on a background thread; `wait()` joins it.

On a mesh every rank calls `save`: each DTensor leaf is gathered whole
(`full_tensor`, a collective) and rank 0 writes JAX's format, so the files do
not depend on the mesh. `restore` distributes each leaf under the current mesh
(JAX's elastic re-shard): a DTensor target leaf takes its own mesh and
placements, or `placements` gives them; every rank reads the file and keeps
its shard.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from repro_torch.parallel.axes import is_dtensor
from repro_torch.train.tree import paths, tree_map


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _full(t):
    """A DTensor's full value, the same on every rank (DTensor's `full_tensor`);
    anything else as is."""
    return t.full_tensor() if is_dtensor(t) else t


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name): bfloat16 as its uint16 bits."""
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _flatten(tree) -> tuple[dict, dict]:
    out, dtypes = {}, {}
    for key, leaf in paths(tree):
        out[key], dtypes[key] = _to_numpy(leaf)
    return out, dtypes


def save_pytree(path: str, tree, step: int) -> None:
    tmp = f"{path}.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": sorted(arrays.keys()), "dtypes": dtypes}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def restore_pytree(path: str, target_tree, mesh=None, placements=None):
    """Restore into the structure of `target_tree` (a nested dict of tensors):
    shapes are checked, each leaf cast to its target's dtype and put on its
    target's device. A DTensor target leaf comes back a DTensor of its mesh and
    placements; `placements`, a matching tree of placements (None for a plain
    leaf), distributes the leaves on `mesh` instead."""
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: _from_numpy(z[k], dtypes.get(k, "")) for k in z.files}

    def one(key, leaf):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = arrays[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} vs {tuple(leaf.shape)}")
        t = t.to(device=leaf.device, dtype=leaf.dtype)
        if pls.get(key) is not None:
            return distribute_tensor(t, mesh, pls[key], src_data_rank=None)
        if is_dtensor(leaf):
            return distribute_tensor(t, leaf.device_mesh, leaf.placements, src_data_rank=None)
        return t

    pls = dict(paths(placements)) if placements is not None else {}
    return _nest(target_tree, {k: one(k, v) for k, v in paths(target_tree)})


def _nest(tree, flat: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _nest(v, flat, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    return flat[prefix]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def wait(self) -> None:
        """Join the write in flight; in a process group, then wait for every rank, so
        that a checkpoint rank 0 wrote is there for all."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def save(self, step: int, tree, *, async_: bool = True) -> None:
        self.wait()
        # copy to the host before handing over, so the train loop may update the
        # device tensors in place at once; a DTensor leaf gathered whole first by
        # DTensor (a weight has thousands of rows before its split dim: `axes.whole`'s
        # row slices would make as many calls)
        host_tree = tree_map(lambda t: _full(torch.as_tensor(t)).detach().to("cpu", copy=True),
                             tree)
        if not _writer():
            return

        def work():
            save_pytree(self._step_dir(step), host_tree, step)
            self._gc()

        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, target_tree, step: int | None = None, *, mesh=None, placements=None):
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return restore_pytree(self._step_dir(step), target_tree, mesh, placements), step

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
