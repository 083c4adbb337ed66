"""Parallelism mapping descriptor (§3.2): DP x TP x PP x SP + schedule.

A copy of `repro.core.parallelism` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Mapping:
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sp: bool = False  # Megatron sequence parallelism (SP degree = tp)
    microbatch: int = 1  # sequences per pipeline microbatch (per replica)
    recompute: str = "selective"  # none | selective | full (§3.3)
    schedule: str = "1f1b"  # gpipe | 1f1b | interleaved (§3.2)
    vpp: int = 1  # interleave factor v (virtual pipeline stages per device)
    prec: int = 2  # training precision bytes
    zero1: bool = False
    opt_8bit: bool = False
    dp_overlap: float = 0.7  # fraction of grad all-reduce hidden under bwd

    @property
    def devices(self) -> int:
        return self.dp * self.tp * self.pp

    def describe(self) -> str:
        return (
            f"dp{self.dp}-tp{self.tp}-pp{self.pp}-sp{self.tp if self.sp else 1}"
            f"-mb{self.microbatch}-{self.recompute}-{self.schedule}"
        )

    def bubble_fraction(self, n_micro: int) -> float:
        """Pipeline bubble: (p-1)/m for GPipe/1F1B, (p-1)/(m*v) interleaved."""
        if self.pp <= 1:
            return 0.0
        if self.schedule == "interleaved":
            return (self.pp - 1) / (n_micro * max(self.vpp, 1))
        return (self.pp - 1) / n_micro

    def with_(self, **kw) -> "Mapping":
        return replace(self, **kw)
