"""A rehearsal of `chip_smoke.py`'s phase 11 (`plan`, PLAN_NOTE) on the CPU.

(a) The dry-run's traced peak of a training step of a reduced h2o-danube
(chunked attention, so the flash twin's blocks run) against the same step run
on real CPU tensors, whose live storage bytes a dispatch mode tracks as the
card's allocator counts them; the bar is the card's, 10%. (b) The prediction
lines: each number is the port's analytical model's own. (c) `--auto-plan` in a
subprocess.
"""

import dataclasses
import sys
import weakref
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.core import predict  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.core.memory import training_memory  # noqa: E402
from repro_torch.core.parallelism import Mapping  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from torch_threads import one_thread  # noqa: E402, F401

CPU = torch.device("cpu")


class LiveBytes(TorchDispatchMode):
    """The bytes of the real storages alive and their peak: what the dry-run's tracer
    counts on fake tensors, on real ones; with `block`, each storage rounded up to a
    multiple of it, as the card's caching allocator rounds each allocation."""

    def __init__(self, block: int = 1):
        super().__init__()
        self.live = self.peak = 0
        self.block = block
        self._seen = {}

    def _free(self, key, n):
        self._seen.pop(key, None)
        self.live -= n

    def track(self, tree):
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if id(st) not in self._seen:
                    n = -(-st.nbytes() // self.block) * self.block
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    self._seen[id(st)] = weakref.finalize(st, self._free, id(st), n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


def _cpu_step_peak(dev, cfg, batch, seq, remat, seed=0):
    """`chip_smoke._step_peak` on the CPU: the live bytes of a real step's storages."""
    model = chip_smoke.Model(cfg, kernels=False)
    tcfg = chip_smoke.TrainConfig()
    live = LiveBytes()
    with live:
        state = {"params": model.init(seed, dev, widen_head=False)}
        state["opt"] = adamw_init(state["params"], tcfg)
        data = chip_smoke.SyntheticLM(cfg.vocab_size, seq, batch).batch(0)
        b = {k: torch.as_tensor(np.asarray(v), dtype=torch.int32) for k, v in data.items()}
        step = make_train_step(model, chip_smoke.ParallelConfig(remat=remat), tcfg)
        state, _ = step(state, b)
        live.peak = live.live
        state, _ = step(state, b)
    return live.peak


def test_plan_memory_rehearsal():
    cfg = dataclasses.replace(chip_smoke.get_config("h2o_danube_1p8b").reduced(),
                              attn_impl="chunked", attn_chunk=16, loss_chunk=32)
    rec = chip_smoke.phase_plan_memory(CPU, "cpu", layers=2, batch=2, seq=64,
                                       remat="selective", measure=_cpu_step_peak, cfg=cfg)
    assert abs(rec["ratio"] - 1) <= chip_smoke.PLAN_MEM_TOL
    assert rec["flops"] > rec["model_flops"] > 0  # remat's recompute, masked blocks


def test_plan_model_rehearsal():
    danube = chip_smoke.get_config("h2o_danube_1p8b")
    run = {"batch": 2, "seq": 6144, "remat": "selective"}
    trains = {danube.name: {"step_s": 0.75, "peak_gib": 33.7}}
    serves = {danube.name: {"prefill_seconds": 0.5, "admissions": 2, "decode_seconds": 1.0,
                            "decode_steps": 40}}
    out = chip_smoke.phase_plan_model("cpu", serves, trains, {danube.name: (danube, 4, 4400, 32)},
                                      {danube.name: (danube, run)})
    m = Mapping(dp=1, tp=1, pp=1, microbatch=2, recompute="selective")
    t = out["train"][danube.name]
    assert t["step_s"] == predict.train_step_time(danube, H100_SXM, m, global_batch=2,
                                                  seq=6144).total
    assert t["peak_gib"] * 2**30 == training_memory(danube, global_batch=2, seq=6144, dp=1, tp=1,
                                                    pp=1, sp=False, microbatch=2,
                                                    recompute="selective").total
    s = out["serve"][danube.name]
    b = predict.inference_latency(danube, H100_SXM, tp=1, batch=4, prompt=4400, gen=32)
    assert (s["prefill_s"], s["decode_ms"]) == (b.ttft, 1e3 * b.tpot)
    assert (s["measured_prefill_s"], s["measured_decode_ms"]) == (0.25, 25.0)


def test_auto_plan_subprocess():
    plans = chip_smoke.phase_auto_plan()
    assert plans and all("[fits]" in p for p in plans)
