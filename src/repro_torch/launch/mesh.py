"""Device meshes (`repro.launch.mesh`) over `torch.distributed`.

A mesh is a `DeviceMesh` with JAX's axis names, one rank a device. The default
process group must exist, or `torchrun`'s environment must be there to create
it from (`init_device_mesh` does); nothing here reads a cluster.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.parallel.axes import ShardingRules, make_rules, mesh_sizes


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str | None = None):
    """A DeviceMesh of `shape` named `axes` over the first prod(shape) ranks.

    Raises when the world is smaller than the mesh, as JAX's does when it has
    fewer devices. `device_type` ("cuda" or "cpu") defaults to CUDA where
    there is a card.
    """
    n = math.prod(shape)
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    if not dist.is_initialized() and "RANK" not in os.environ:  # one process, not torchrun's
        world = 1
    else:
        world = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} devices, have {world}")
    if not dist.is_initialized():  # torchrun's environment: gloo on the CPU, NCCL on CUDA
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    if n == world:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def parse_mesh(text: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """A launcher's `--mesh` ("2x4", "2x2x2") as (shape, axes): (data, model), or
    (pod, data, model) for three dims."""
    shape = tuple(int(x) for x in text.split("x"))
    if len(shape) not in (2, 3):
        raise ValueError(f"--mesh takes 2 or 3 dims, got {text!r}")
    return shape, ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 (data, model); multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def rules_for(mesh, shape=None, *, sequence_parallel: bool = True,
              zero1: bool = True) -> ShardingRules:
    """Default logical->mesh axis rules for a production mesh.

    Batch shards over ("pod", "data"); weights over "model". For decode shapes
    (anything with `kind` and `global_batch`, JAX's ShapeSpec) whose global
    batch is smaller than the dp axes, the data axis is repurposed for context
    parallelism over the KV/seq dim: `Model.prefill` and `decode_step` with
    `cp` place their caches by these rules (`Model.cache_pspecs`), and decode
    joins the ranks' partial outputs over the split length.
    """
    sizes = mesh_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    tp = ("model",) if "model" in sizes else ()
    cp: tuple[str, ...] = ()
    if shape is not None and shape.kind == "decode":
        if shape.global_batch < math.prod(sizes[a] for a in dp):
            cp = tuple(a for a in ("data",) if a in sizes)
            dp = tuple(a for a in ("pod",) if a in sizes)
            if shape.global_batch == 1:
                dp = ()
    return make_rules(dp=dp, tp=tp, sequence_parallel=sequence_parallel,
                      context_parallel=cp, zero1=zero1)
