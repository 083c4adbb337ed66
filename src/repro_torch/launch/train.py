"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --steps 50 \\
      --checkpoint-dir build/ckpt --checkpoint-every 10 [--resume]
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-14b --mesh 2x2 --device cpu

The command line trains the reduced config (`--reduced` is always on, as in
JAX's launcher) on CUDA unless `--device` names another. `--arch` and `run`
take every config, as JAX's launcher does, so a caller can train the
full-width model with the same code (`chip_smoke.py` does). `--mesh DxM`
(or `PxDxM`) trains on a (data, model) (or (pod, data, model)) mesh of
`torchrun`'s processes, gloo on the CPU and NCCL on CUDA, with JAX's rules:
batch over the data axes, weights over "model", ZeRO-1 over the data axes.
`--auto-plan`, `--chips`, `--hardware` wait for the planner's port (ROADMAP
A7b): they are accepted and refused.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_mesh, parse_mesh
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import make_rules
from repro_torch.train.trainer import Trainer


def mesh_and_rules(mesh, device: torch.device, rules=None):
    """(DeviceMesh, rules) of `mesh`: a DeviceMesh, or its `--mesh` text ("2x2"),
    built over the default process group on `device`'s type; `rules`, or JAX's
    launcher rules (dp the axes other than "model", tp "model")."""
    if isinstance(mesh, str):
        mesh = make_mesh(*parse_mesh(mesh), device_type=device.type)
    axes = tuple(mesh.mesh_dim_names)
    return mesh, rules or make_rules(dp=tuple(a for a in axes if a != "model"), tp=("model",))


def run(cfg: ModelConfig, *, device: str | torch.device | None = None, batch: int = 8,
        seq: int = 128, steps: int = 50, remat: str = "selective", optimizer: str = "adamw",
        microbatches: int = 1, grad_compress: bool = False, seed: int = 0,
        checkpoint_dir: str = "", checkpoint_every: int = 0, resume: bool = False,
        mesh=None, rules=None, log=print) -> dict:
    """Train `steps` steps of `SyntheticLM(vocab, seq, batch)` from the port's seeded init.

    `mesh` (a DeviceMesh or `--mesh` text; `mesh_and_rules`) trains on a mesh of
    the default process group's ranks, the batch over its data axes, under
    `rules` (e.g. `launch.mesh.rules_for(mesh)`, sequence parallelism on) or
    JAX's launcher rules.
    Returns each step's metrics (`history`: loss, ce, accuracy, grad_norm, lr,
    step_time_s, ...), the step times and losses, tokens a step, the peak
    device memory where the device is CUDA, and each step's kernel launches
    (the difference of `kernels.build.LAUNCHES` across the step, this rank's).
    """
    dev = resolve_device(device)
    rules = None
    if mesh is not None:
        mesh, rules = mesh_and_rules(mesh, dev, rules)
        if dev.type == "cuda":  # the mesh set this rank's card
            dev = torch.device("cuda", torch.cuda.current_device())
    model = Model(cfg)
    pcfg = ParallelConfig(remat=remat, microbatches=microbatches, grad_compress=grad_compress)
    tcfg = TrainConfig(steps=steps, optimizer=optimizer, seed=seed,
                       checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
    trainer = Trainer(model, pcfg, tcfg, dev, mesh=mesh, rules=rules)
    start = 0
    if resume and checkpoint_dir:
        try:
            state, start = trainer.resume()
            log(f"resumed from step {start}")
        except FileNotFoundError:
            state = trainer.init_state()
    else:
        state = trainer.init_state()
    data = Prefetcher(iter(SyntheticLM(cfg.vocab_size, seq, batch)))
    for _ in range(start):  # skip the steps already taken: a deterministic resume
        next(data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    history, launches = [], []
    for step in range(start, steps):
        before = dict(build.LAUNCHES)
        state, h = trainer.fit(state, data, steps=1, start_step=step, log=log)
        launches.append({k: n - before[k] for k, n in build.LAUNCHES.items()})
        history += h
    return {
        "history": history,
        "step_times": [h["step_time_s"] for h in history],
        "losses": [h["loss"] for h in history],
        "tokens_per_step": batch * seq,
        "params": model.param_count(),
        "launches_per_step": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=[*ALIASES, *ARCHS])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="always on, as in JAX's launcher: the command line trains reduced configs")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="selective", choices=["none", "selective", "full"])
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adamw8bit"])
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="",
                    help="DxM or PxDxM: train on a mesh of torchrun's processes")
    ap.add_argument("--auto-plan", action="store_true",
                    help="not yet: the analytical planner waits for ROADMAP A7b")
    ap.add_argument("--chips", type=int, default=256, help="with --auto-plan (ROADMAP A7b)")
    ap.add_argument("--hardware", default="tpu-v5e", help="with --auto-plan (ROADMAP A7b)")
    args = ap.parse_args()
    if args.auto_plan:
        raise SystemExit("--auto-plan: the analytical planner is not ported yet (ROADMAP A7b)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    # on a mesh every rank logs the same metrics: rank 0 prints them
    rank0 = not args.mesh or int(os.environ.get("RANK", "0")) == 0
    log = print if rank0 else (lambda *a, **k: None)
    out = run(cfg, device=args.device, batch=args.batch, seq=args.seq, steps=args.steps,
              remat=args.remat, optimizer=args.optimizer, microbatches=args.microbatches,
              grad_compress=args.grad_compress, checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.checkpoint_every, resume=args.resume,
              mesh=args.mesh or None, log=log)
    h = out["history"]
    if not h:
        log("done: no step left to take")
    else:
        where = f"mesh {args.mesh}, " if args.mesh else ""
        log(f"done: final loss {h[-1]['loss']:.4f}, straggler steps {h[-1]['slow_steps']} "
            f"({cfg.name} reduced, {where}{args.device})")
    if args.mesh:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
