#!/usr/bin/env python3
"""Step times of the training cell in a fresh process on one GPU.

  python3 scripts/train_step_times.py [--runs 2] [--steps 6]

Trains h2o-danube-1.8b at full width and depth through
`repro_torch.launch.train.run` as `chip_smoke.py`'s phase 7 does (B 2 x
6144 tokens of `SyntheticLM`, AdamW, remat selective), `--runs` times in
one process, and prints each run's step times (host clock, each ending in a
device sync) beside the CUDA caching allocator's counters (retries,
cudaMalloc and cudaFree calls). Set beside phase 7's step times, which come
after the serve phases in the same process, it separates the step itself
from what earlier phases leave behind. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_step_times: needs a CUDA device")
    cfg = get_config("h2o_danube_1p8b")
    for i in range(args.runs):
        out = run(cfg, device="cuda", batch=2, seq=6144, steps=args.steps, remat="selective",
                  log=lambda *_: None)
        stats = torch.cuda.memory_stats()
        print(f"run {i}: step s {[round(t, 4) for t in out['step_times']]}; allocator: "
              f"{stats['num_alloc_retries']} retries, {stats['num_device_alloc']} cudaMalloc, "
              f"{stats['num_device_free']} cudaFree", flush=True)
        del out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
