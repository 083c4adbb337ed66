"""One run of one cell: `python3 bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`.

Set-up (weights drawn on the card from the seed, the program built, the
cell's shapes warmed up), a window of `--seconds`, then the check against the
plain reference, with the program's state freed first. The last line of
standard output is the result: `correct`, `attempted`, `failed`, the cell's
end-to-end metrics (`--trace 0`) or per-layer metrics (`--trace 1`, with the
traced part's `busy_s`, `window_s` and a `breakdown`), the device, and last
the numbers compared beside their limits, which also end standard error.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from benchkit import weights as W
from benchkit.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def passes(check: dict) -> bool:
    """A number compared passes when it is no greater than its limit; None (the run
    gave nothing to compare) fails."""
    return check["value"] is not None and check["value"] <= check["limit"]


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def program() -> SimpleNamespace:
    """The system under test: the port's classes, and its launch counter."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.trainer import Trainer

    return SimpleNamespace(Model=Model, ServeEngine=ServeEngine, Request=Request, Trainer=Trainer,
                           ParallelConfig=ParallelConfig, TrainConfig=TrainConfig,
                           LAUNCHES=LAUNCHES)


def port_config(fam, cfg: dict):
    """The program's configuration of the file's model. Where the program names it
    (`port_name`), the program's own, which must agree with every field the
    family module (`fam`) reads from the file; otherwise (a test's tiny model)
    one built from those fields. A file the program cannot run as it states is
    refused."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig

    why = fam.refuse(cfg)
    if why:
        raise ValueError(f"{cfg['name']}: {why}")
    want = fam.port_fields(cfg)
    if "port_name" not in cfg:
        return ModelConfig(name=cfg["name"], **want)
    pc = get_config(cfg["port_name"])
    wrong = {k: (getattr(pc, k), v) for k, v in want.items() if getattr(pc, k) != v}
    if wrong:
        raise ValueError(f"{cfg['name']}: the program's config differs from the file: {wrong}")
    return pc


def smi() -> str:
    """The card's name, power limit, SM clock, power draw and temperature."""
    q = "name,power.limit,clocks.sm,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e.__class__.__name__})"
    return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()


class Context(SimpleNamespace):
    """What a cell's driver gets, and the window's bookkeeping."""

    log = staticmethod(log)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def weight(self, path: str, layer: int | None) -> torch.Tensor:
        return W.draw(self.family, self.cfg, self.seed, path, layer, self.device)

    def open_window(self) -> float:
        self.sync()
        gc.collect()
        gc.freeze()  # set-up's objects: no collection inside the window walks them again
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            log(f"[bench] device before the window: {smi()}")
            torch.cuda.reset_peak_memory_stats(self.device)
        self.start = time.perf_counter()
        self.setup_s = self.start - self.t0
        return self.start

    def close_window(self) -> None:
        self.sync()
        self.end = time.perf_counter()
        gc.unfreeze()
        if self.device.type == "cuda":
            self.window_peak = torch.cuda.max_memory_allocated(self.device)
            log(f"[bench] device after the window: {smi()}")
        bad = forbidden_modules()
        if bad:
            raise SystemExit(f"modules of JAX or the JAX package loaded: {bad}")

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(spec: Spec, name: str, *, seed: int, seconds: float, trace: bool, device,
             t0: float, controls: bool = False) -> dict:
    """The result line's object for one run of cell `name` (any device: the tests
    run it on the CPU; `main` refuses anything but the card). `controls` also
    reads the cell's control and planted faults (`calibrate.py`; never in the
    benchmark's own runs) into `out["controls"]`."""
    seed %= 2**64  # the generators take a non-negative seed
    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    fam = spec.family(cfg["family"])
    ctx = Context(cfg=cfg, traffic=traffic, limits=spec.limits(name), seed=seed, seconds=seconds,
                  trace=trace, device=torch.device(device), program=program(), family=fam,
                  reference=spec.reference(cfg["reference"]), t0=t0, trace_summary=None,
                  setup_peak=0, window_peak=0, controls=controls, control_readings={})
    ctx.port_cfg = port_config(fam, cfg)
    record = spec.driver(traffic["kind"]).run(ctx)
    log(f"[bench] set-up {ctx.setup_s:.1f} s, window {ctx.end - ctx.start:.1f} s, check "
        f"{time.perf_counter() - ctx.end:.1f} s")
    record.update(setup_s=ctx.setup_s, peak_window_bytes=ctx.window_peak, trace=ctx.trace_summary,
                  cfg=cfg, traffic=traffic, family=fam)
    metrics = {}
    for m in spec.metrics(name, trace):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(passes(c) for c in record["checks"].values())
    attempted = record["attempted"]
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": max(ctx.setup_peak, ctx.window_peak)}
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if correct else record["compared"], "metrics": metrics, "device": dev}
    if trace and ctx.trace_summary is not None:
        s = ctx.trace_summary
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    if controls:
        out["controls"] = ctx.control_readings
    out["checks"] = record["checks"]
    return out


def main(argv=None, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter() if t0 is None else t0
    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[bench] the cell needs {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    log(f"[bench] {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace} on "
        f"{smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = run_cell(spec, args.workload, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device="cuda", t0=t0)
    bad = forbidden_modules()
    if bad:
        log(f"[bench] modules of JAX or the JAX package loaded: {bad}: no result")
        return 3
    for k, c in out["checks"].items():
        log(f"[check] {k} = {c['value']!r} (limit {c['limit']!r}, "
            f"{'pass' if passes(c) else 'FAIL'})")
    print(json.dumps(out), flush=True)
    return 0
