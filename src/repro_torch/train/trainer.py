"""Training driver (`repro.train.trainer`): shardings, checkpoint/restart, straggler watchdog.

The state lives on `device` and `fit` updates it in place (the JAX trainer
donates it). On a mesh (`mesh`, a DeviceMesh, and `rules`) the parameters,
moments and error feedback are DTensors placed by their sanitized specs (the
moments' ZeRO-1 ones, `opt_state_specs`), each batch is placed on ("dp",
None), and every step runs under `use_mesh`; every rank gets the same
metrics. The dense and MoE families train on a mesh; the hybrid and ssm ones
wait for their sharding annotations (ROADMAP A6b).
  * checkpoint/restart: `CheckpointManager` (async, atomic, JAX's format);
    `resume()` restores the latest step under the current mesh (elastic: a
    job restarted on another mesh re-shards).
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
from torch.distributed.tensor import distribute_tensor

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models.params import distribute, param_defs, param_shapes
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import (ShardingRules, logical_spec, placements, sanitize_pspec,
                                       sanitize_spec_tree, use_mesh)
from repro_torch.train.optimizer import adamw_init, opt_state_shapes, opt_state_specs
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
    def __init__(self, model: Model, pcfg: ParallelConfig, tcfg: TrainConfig, device,
                 mesh=None, rules: ShardingRules | None = None):
        if mesh is not None and model.cfg.family in ("hybrid", "ssm"):
            raise NotImplementedError(
                f"{model.cfg.name}: the {model.cfg.family} family on a mesh waits for its "
                "sharding annotations (ROADMAP A6b)")
        self.model, self.pcfg, self.tcfg = model, pcfg, tcfg
        self.device = torch.device(device)
        self.mesh, self.rules = mesh, rules or ShardingRules()
        self.watchdog = StragglerWatchdog()
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir, keep=tcfg.keep_checkpoints)
                     if tcfg.checkpoint_dir else None)
        with self._ctx():
            self._step = make_train_step(model, pcfg, tcfg)
            if mesh is not None:
                pspecs, pshapes = model.pspecs(), param_shapes(param_defs(model.cfg))
                self._specs = {
                    "params": sanitize_spec_tree(pspecs, pshapes, mesh),
                    "opt": sanitize_spec_tree(opt_state_specs(pspecs, pshapes, tcfg),
                                              opt_state_shapes(pshapes, tcfg), mesh)}
                self._batch_spec = logical_spec("dp", None)

    def _ctx(self):
        return use_mesh(self.mesh, self.rules)

    def init_state(self, seed: int | None = None, params: dict | None = None) -> dict:
        """{params, opt[, grad_error]}: the port's seeded init (the head in the param
        dtype, as JAX holds it), or the given `params`; on a mesh, placed."""
        if params is None:
            seed = self.tcfg.seed if seed is None else seed
            params = self.model.init(seed, self.device, widen_head=False)
        specs = None
        if self.mesh is not None:
            params = distribute(params, self._specs["params"], self.mesh)
            specs = self._specs["opt"]
        state = {"params": params, "opt": adamw_init(params, self.tcfg, specs)}
        if self.pcfg.grad_compress:  # the error feedback is placed like the params
            state["grad_error"] = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                           params)
        return state

    def resume(self) -> tuple[dict, int]:
        """The latest checkpoint, restored under the current mesh into the structure
        and placements of a fresh state (elastic: any mesh)."""
        if self.ckpt is None:
            raise ValueError("resume needs a checkpoint_dir")
        return self.ckpt.restore(self.init_state())

    def _batch(self, batch: dict) -> dict:
        out = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}
        if self.mesh is None:
            return out
        # every rank draws the same global batch: each keeps its rows, nothing is sent
        def place(t):
            spec = sanitize_pspec(self._batch_spec, tuple(t.shape), self.mesh)
            return distribute_tensor(t, self.mesh, placements(spec, self.mesh), src_data_rank=None)

        return {k: place(v) for k, v in out.items()}

    def fit(self, state: dict, data_iter, *, steps: int, start_step: int = 0,
            log=print) -> tuple[dict, list[dict]]:
        """`steps` steps from `start_step`; each metric read on the host, so
        `step_time_s` ends in a device sync."""
        history = []
        for step_i in range(start_step, start_step + steps):
            batch = next(data_iter) if hasattr(data_iter, "__next__") else data_iter.batch(step_i)
            batch = self._batch(batch)
            t0 = time.perf_counter()
            with self._ctx():
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
