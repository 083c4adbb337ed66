"""Auto-parallelism planner: the paper's technique as a framework feature.

Given a model config, hardware, chip count and batch geometry, enumerate
(dp, tp, pp, sp, microbatch, recompute) mappings, filter by the §5.1 memory
model (must fit per-device HBM), and rank by predicted step time (§3.2's
mapping + the roofline/collective models). Used by `launch/train.py
--auto-plan` and validated by tests/test_planner.py.

A copy of `repro.core.planner` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.memory import training_memory
from repro_torch.core.parallelism import Mapping
from repro_torch.core.predict import train_step_time


@dataclass
class Plan:
    mapping: Mapping
    time: float
    memory: float
    fits: bool
    breakdown: dict

    def describe(self) -> str:
        fit = "fits" if self.fits else "OOM"
        return (
            f"{self.mapping.describe():48s} t={self.time * 1e3:9.1f} ms "
            f"mem={self.memory / 2**30:6.1f} GiB [{fit}]"
        )


def _divisors(n: int, cap: int | None = None) -> list[int]:
    out = [d for d in range(1, n + 1) if n % d == 0]
    return [d for d in out if cap is None or d <= cap]


def enumerate_mappings(cfg: ModelConfig, n_chips: int, global_batch: int, *,
                       max_tp: int | None = None, schedules=("1f1b",)) -> list[Mapping]:
    maps = []
    max_tp = max_tp or n_chips
    for tp in _divisors(n_chips, max_tp):
        rest = n_chips // tp
        for pp in _divisors(rest):
            if cfg.num_layers % pp:
                continue
            dp = rest // pp
            if global_batch % dp:
                continue
            per_replica = global_batch // dp
            for mb in (1, 2, 4, 8):
                if per_replica % mb:
                    continue
                for rec in ("none", "selective", "full"):
                    for sched in schedules if pp > 1 else ("1f1b",):
                        maps.append(
                            Mapping(dp=dp, tp=tp, pp=pp, sp=tp > 1, microbatch=mb,
                                    recompute=rec, schedule=sched,
                                    zero1=True)
                        )
    return maps


def plan(cfg: ModelConfig, hw: HardwareSpec, n_chips: int, *, global_batch: int,
         seq: int, top_k: int = 5, max_tp: int | None = None,
         mem_margin: float = 0.92) -> list[Plan]:
    """Returns the top_k feasible plans, best predicted step time first."""
    plans = []
    for m in enumerate_mappings(cfg, n_chips, global_batch, max_tp=max_tp):
        mem = training_memory(
            cfg, global_batch=global_batch, seq=seq, dp=m.dp, tp=m.tp, pp=m.pp,
            sp=m.sp, microbatch=m.microbatch, recompute=m.recompute,
            zero1=m.zero1, opt_8bit=m.opt_8bit, schedule=m.schedule,
        ).total
        fits = mem <= hw.dram.capacity * mem_margin
        if not fits:
            continue
        bd = train_step_time(cfg, hw, m, global_batch=global_batch, seq=seq)
        plans.append(Plan(m, bd.total, mem, fits, bd.as_dict()))
    plans.sort(key=lambda p: p.time)
    if not plans:
        raise ValueError(
            f"no feasible mapping for {cfg.name} on {n_chips} x {hw.name} "
            f"(batch {global_batch}, seq {seq}) — model does not fit"
        )
    return plans[:top_k]
