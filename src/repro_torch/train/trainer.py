"""Training driver (`repro.train.trainer`): checkpoint/restart, straggler watchdog.

On one device: JAX's `mesh` argument comes with distribution (ROADMAP A6). The state lives on
`device` and `fit` updates it in place (the JAX trainer donates it).
  * checkpoint/restart: `CheckpointManager` (async, atomic, JAX's format);
    `resume()` restores the latest step into the state's structure.
  * straggler mitigation: per-step wall-time EMA; steps slower than
    `factor` x EMA are flagged and counted.
  * data determinism: batches are keyed by (seed, step), so a restart
    resumes mid-epoch without data loss or duplication.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import tree_map


@dataclass
class StragglerWatchdog:
    factor: float = 2.5
    ema: float | None = None
    alpha: float = 0.2
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        self.slow_steps += slow
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, model: Model, pcfg: ParallelConfig, tcfg: TrainConfig, device):
        self.model, self.pcfg, self.tcfg = model, pcfg, tcfg
        self.device = torch.device(device)
        self.watchdog = StragglerWatchdog()
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
                     if tcfg.checkpoint_dir else None)
        self._step = make_train_step(model, pcfg, tcfg)

    def init_state(self, seed: int | None = None, params: dict | None = None) -> dict:
        """{params, opt[, grad_error]}: the port's seeded init (the head in the param
        dtype, as JAX holds it), or the given `params`."""
        if params is None:
            seed = self.tcfg.seed if seed is None else seed
            params = self.model.init(seed, self.device, widen_head=False)
        state = {"params": params, "opt": adamw_init(params, self.tcfg)}
        if self.pcfg.grad_compress:
            state["grad_error"] = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        return state

    def resume(self) -> tuple[dict, int]:
        """The latest checkpoint, restored into the structure of a fresh state."""
        if self.ckpt is None:
            raise ValueError("resume needs a checkpoint_dir")
        return self.ckpt.restore(self.init_state())

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def fit(self, state: dict, data_iter, *, steps: int, start_step: int = 0,
            log=print) -> tuple[dict, list[dict]]:
        """`steps` steps from `start_step`; each metric read on the host, so
        `step_time_s` ends in a device sync."""
        history = []
        for step_i in range(start_step, start_step + steps):
            batch = next(data_iter) if hasattr(data_iter, "__next__") else data_iter.batch(step_i)
            batch = self._batch(batch)
            t0 = time.perf_counter()
            state, metrics = self._step(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            sync(self.device)
            dt = time.perf_counter() - t0
            slow = self.watchdog.observe(dt)
            metrics.update(step=step_i, step_time_s=dt, straggler_flag=bool(slow),
                           slow_steps=self.watchdog.slow_steps)
            history.append(metrics)
            if step_i % max(self.tcfg.log_every, 1) == 0:
                log(f"step {step_i}: loss={metrics['loss']:.4f} gnorm={metrics['grad_norm']:.3f} "
                    f"dt={dt * 1e3:.0f}ms" + (" [STRAGGLER]" if slow else ""))
            if (self.ckpt is not None and self.tcfg.checkpoint_every
                    and (step_i + 1) % self.tcfg.checkpoint_every == 0):
                self.ckpt.save(step_i + 1, state)
        if self.ckpt is not None:
            self.ckpt.wait()
        return state, history
