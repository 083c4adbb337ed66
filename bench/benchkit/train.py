"""A training cell: the port's `Trainer.fit`, built as `launch/train.py::run`
builds it, one step after another until the window closes.

Set-up builds one trainer and one state from the benchmark's weights and
drives them through the traffic's first `check_steps` steps by the same call
the window makes, on batches whose rows all differ; those steps are the
warm-up. The state's numbers that the check needs are read on the way: each
step's loss, each leaf's first moment after step 1 (AdamW's first moment is
then (1 - b1) times the clipped gradient, so its norm gives the gradient as
the optimizer got it), and each leaf's change over the steps. The same state
then trains through the window. After it the plain reference follows the
same steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from benchkit import weights as W
from benchkit.trace import Traced

TRACED_STEPS = (2, 5)  # the window's steps [2, 5) are traced in a `--trace 1` run


class Batches:
    """The traffic's batches: B rows of S + 1 Zipf-distributed tokens, drawn from the
    seed and the step (`SyntheticLM`'s marginal), shifted into tokens and labels."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.t, self.vocab, self.seed = traffic, vocab, seed

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed, step])
        z = rng.zipf(self.t["zipf"], size=(self.t["batch"], self.t["seq"] + 1))
        toks = ((z - 1) % self.vocab).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _norms(tree: dict) -> dict:
    return {p: float(t.float().norm()) for p, t in W.flat(tree).items()}


def _changes(fam, cfg: dict, seed: int, params: dict, device) -> dict:
    """Each leaf's norm of (now - as drawn), a layer at a time."""
    out = {}
    for path, t in W.flat(params).items():
        if path.startswith("layers/"):
            sq = sum(float((t[i].float() - W.draw(fam, cfg, seed, path[7:], i, device).float())
                           .square().sum()) for i in range(t.shape[0]))
        else:
            sq = float((t.float() - W.draw(fam, cfg, seed, path, None, device).float()).square().sum())
        out[path] = sq ** 0.5
    return out


def run(ctx) -> dict:
    cfg, traffic, dev, prog, fam = ctx.cfg, ctx.traffic, ctx.device, ctx.program, ctx.family
    hp = traffic["hyper"]
    tcfg = prog.TrainConfig(steps=hp["schedule_steps"], learning_rate=hp["learning_rate"],
                            warmup_steps=hp["warmup_steps"], weight_decay=hp["weight_decay"],
                            grad_clip=hp["grad_clip"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                            optimizer=traffic["optimizer"], log_every=1 << 30)
    trainer = prog.Trainer(prog.Model(ctx.port_cfg), prog.ParallelConfig(remat=traffic["remat"]),
                           tcfg, dev)
    state = trainer.init_state(params=W.make(fam, cfg, ctx.seed, dev, head_fp32=False))
    data = Batches(traffic, fam.sizes(cfg)["V"], ctx.seed)
    quiet = dict(log=lambda *a, **k: None)

    losses, first_moment = [], None
    for i in range(traffic["check_steps"]):
        state, h = trainer.fit(state, data, steps=1, start_step=i, **quiet)
        losses.append(h[0]["loss"])
        if i == 0:
            first_moment = _norms(state["opt"]["m"])
    change = _changes(fam, cfg, ctx.seed, state["params"], dev)

    start = ctx.open_window()
    deadline = start + ctx.seconds
    ends, step_s, traced, paused = [], [], None, 0.0
    i = traffic["check_steps"]
    while time.perf_counter() < deadline:
        lo, hi = TRACED_STEPS
        n = hi - lo if ctx.trace and len(ends) == lo else 1
        with Traced(n > 1, dev) as t:
            launches = dict(prog.LAUNCHES)
            for _ in range(n):
                with torch.profiler.record_function("trainer.fit"):
                    state, h = trainer.fit(state, data, steps=1, start_step=i, **quiet)
                ends.append(time.perf_counter() - paused)
                step_s.append(h[0]["step_time_s"])
                i += 1
        if t.on:  # the profiler's stop is no part of the window
            traced, paused, deadline = t, t.pause_s, deadline + t.pause_s
            launched = {k: c - launches[k] for k, c in prog.LAUNCHES.items()}
    ctx.close_window()
    if traced is not None:
        ctx.trace_summary = {**traced.summary(), "launches": launched}
    del state, trainer
    gc.collect()
    ctx.free()

    done = sum(e <= start + ctx.seconds for e in ends)
    tokens = traffic["batch"] * traffic["seq"]
    record = {"kind": "train", "steps": done, "attempted": done,
              "steps_wall_s": (ends[done - 1] - start) if done else float("nan"),
              "tokens": done * tokens, "step_time_s": step_s[:done],
              "step_flops": fam.train_step_flops(cfg, traffic["batch"], traffic["seq"])}
    record["checks"] = check(ctx, data, losses, first_moment, change)
    record["compared"] = traffic["check_steps"]
    return record


def gaps(prog: dict, ref: dict, skip: set = frozenset()) -> float:
    """The worst leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of that leaf and of the median leaf."""
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def numbers(losses: list, grad: dict, change: dict, ref: dict) -> dict:
    """The three numbers compared: the widest gap of a step's loss; the worst leaf's
    gap of its first clipped gradient's norm; the worst leaf's gap of its change
    over the steps, leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding: they move by round-off)."""
    med = statistics.median(ref["grad_raw"].values())
    still = {k for k, v in ref["grad_raw"].items() if v < 1e-3 * med}
    return {"loss_gap": max(abs(a - b) for a, b in zip(losses, ref["loss"])),
            "grad_gap": gaps(grad, ref["grad"]),
            "change_gap": gaps(change, ref["change"], still)}


def reference_steps(ctx, data: Batches, n: int, **kw) -> dict:
    """The reference's `n` steps from the seed's weights and the first `n` batches."""
    dev = ctx.device
    params = W.flat(W.make(ctx.family, ctx.cfg, ctx.seed, dev, head_fp32=False))
    batches = [tuple(torch.as_tensor(b[k], device=dev) for k in ("tokens", "labels"))
               for b in map(data.batch, range(n))]
    return ctx.reference.train_steps(ctx.cfg, params, batches, ctx.traffic["hyper"], **kw)


def check(ctx, data: Batches, losses: list, first_moment: dict, change: dict) -> dict:
    ctx.reference.exact_matmuls()
    b1 = ctx.traffic["hyper"]["b1"]
    ref = reference_steps(ctx, data, len(losses))
    got = numbers(losses, {k: v / (1 - b1) for k, v in first_moment.items()}, change, ref)
    if ctx.controls:  # the control and a planted fault, each in the program's place
        for name, kw in (("fp8", {"prec": "fp8"}), ("half_batch", {"half_batch": True})):
            other = reference_steps(ctx, data, len(losses), **kw)
            ctx.control_readings[name] = numbers(other["loss"], other["grad"], other["change"], ref)
    return {k: {"value": v, "limit": ctx.limits[k]} for k, v in got.items()}
