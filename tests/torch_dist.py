"""Run a function on a few gloo processes of the CPU, for the mesh tests.

`spawn(fn, world, tmp)` starts `world` processes (spawned, so each imports
afresh), joins them into one gloo process group through a file under `tmp`
(no port), runs `fn(rank, world, *args)` on each with one thread, and returns
the ranks' results (torch-saved, so tensors come back). A process that fails,
or the whole run past `timeout` seconds, fails the caller.
"""

from __future__ import annotations

import importlib
import os
import time

import torch
import torch.multiprocessing as mp


def _worker(rank: int, world: int, init: str, target: str, args: tuple, out: str):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world)
    try:
        mod, name = target.split(":")
        result = getattr(importlib.import_module(mod), name)(rank, world, *args)
        torch.save(result, os.path.join(out, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp, *args, timeout: float = 120.0) -> list:
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    init = os.path.join(tmp, "pg_init")
    ctx = mp.start_processes(_worker, args=(world, init, f"{fn.__module__}:{fn.__name__}", args, tmp),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {world} processes ran past {timeout} s")
    return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False) for r in range(world)]
