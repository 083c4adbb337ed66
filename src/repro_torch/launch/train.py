"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --steps 50 \\
      --checkpoint-dir build/ckpt --checkpoint-every 10 [--resume]

The command line trains the reduced config (`--reduced` is always on, as in
JAX's launcher) on CUDA unless `--device` names another. `--arch` and `run`
take every config, as JAX's launcher does, so a caller can train the
full-width model with the same code (`chip_smoke.py` does). `--mesh` waits
for distribution (ROADMAP A6) and `--auto-plan`, `--chips`, `--hardware`
for the planner's port (ROADMAP A7): they are accepted and refused.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.configs.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.kernels import build
from repro_torch.models.transformer import Model
from repro_torch.train.trainer import Trainer


def run(cfg: ModelConfig, *, device: str | torch.device | None = None, batch: int = 8,
        seq: int = 128, steps: int = 50, remat: str = "selective", optimizer: str = "adamw",
        microbatches: int = 1, grad_compress: bool = False, seed: int = 0,
        checkpoint_dir: str = "", checkpoint_every: int = 0, resume: bool = False,
        log=print) -> dict:
    """Train `steps` steps of `SyntheticLM(vocab, seq, batch)` from the port's seeded init.

    Returns each step's metrics (`history`: loss, ce, accuracy, grad_norm, lr,
    step_time_s, ...), the step times and losses, tokens a step, the peak
    device memory where the device is CUDA, and each step's kernel launches
    (the difference of `kernels.build.LAUNCHES` across the step).
    """
    dev = resolve_device(device)
    model = Model(cfg)
    pcfg = ParallelConfig(remat=remat, microbatches=microbatches, grad_compress=grad_compress)
    tcfg = TrainConfig(steps=steps, optimizer=optimizer, seed=seed,
                       checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
    trainer = Trainer(model, pcfg, tcfg, dev)
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
    ap.add_argument("--mesh", default="", help="not yet: waits for distribution (ROADMAP A6)")
    ap.add_argument("--auto-plan", action="store_true",
                    help="not yet: the analytical planner waits for ROADMAP A7")
    ap.add_argument("--chips", type=int, default=256, help="with --auto-plan (ROADMAP A7)")
    ap.add_argument("--hardware", default="tpu-v5e", help="with --auto-plan (ROADMAP A7)")
    args = ap.parse_args()
    if args.mesh:
        raise SystemExit("--mesh: training on a mesh waits for distribution (ROADMAP A6)")
    if args.auto_plan:
        raise SystemExit("--auto-plan: the analytical planner is not ported yet (ROADMAP A7)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = run(cfg, device=args.device, batch=args.batch, seq=args.seq, steps=args.steps,
              remat=args.remat, optimizer=args.optimizer, microbatches=args.microbatches,
              grad_compress=args.grad_compress, checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.checkpoint_every, resume=args.resume)
    h = out["history"]
    if not h:
        print("done: no step left to take")
        return
    print(f"done: final loss {h[-1]['loss']:.4f}, straggler steps {h[-1]['slow_steps']} "
          f"({cfg.name} reduced, {args.device})")


if __name__ == "__main__":
    main()
