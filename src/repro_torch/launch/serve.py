"""Serving launcher: batched generation with the slot-based engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b --device cuda

`--arch` takes every config of the port (`repro_torch.configs.ALIASES`:
qwen3-14b, h2o-danube-1.8b, pixtral-12b, starcoder2-3b, minitron-8b,
musicgen-large, deepseek-moe-16b, arctic-480b, zamba2-1.2b, rwkv6-7b, or
their module names). The command line runs
the reduced config, as the JAX launcher does. `run` takes any config, so a
caller can serve the full-width model with the same code (`chip_smoke.py`
does).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Request, ServeEngine


def run(cfg: ModelConfig, *, device: str | torch.device | None = None, requests: int = 12,
        slots: int = 4, prompt_len: int | tuple[int, int] = 32, max_new: int = 16,
        max_len: int = 128, seed: int = 0) -> dict:
    """Serve `requests` random prompts on a model with the port's seeded init.

    `prompt_len` is a length, or an inclusive (lo, hi) range to draw each
    prompt's length from. Returns the served requests and the run's numbers:
    host seconds of prefill and of decode (each span ends in a device sync),
    admissions (and the request indices each admitted), decode steps, tokens,
    and the peak device memory where the device is CUDA.
    """
    dev = resolve_device(device)
    model = Model(cfg)
    params = model.init(seed, dev)
    engine = ServeEngine(model, params, max_len=max_len, slots=slots, seed=seed)

    rng = np.random.default_rng(seed)
    lo, hi = (prompt_len, prompt_len) if isinstance(prompt_len, int) else prompt_len
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab_size,
                                    size=int(rng.integers(lo, hi + 1))).astype(np.int32),
                max_new_tokens=max_new)
        for _ in range(requests)
    ]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    seconds = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    return {
        "requests": done,
        "seconds": seconds,
        "prefill_seconds": engine.prefill_seconds,
        "decode_seconds": engine.decode_seconds,
        "admissions": engine.admissions,
        "admitted": engine.admitted,
        "decode_steps": engine.decode_steps,
        "tokens": n_tok,
        "prompt_tokens": int(sum(len(r.prompt) for r in done)),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=[*ALIASES, *ARCHS])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    out = run(cfg, device=args.device, requests=args.requests, slots=args.slots,
              prompt_len=args.prompt_len, max_new=args.max_new, max_len=args.max_len)
    done, dt = out["requests"], out["seconds"]
    print(f"served {len(done)} requests, {out['tokens']} tokens in {dt:.2f}s "
          f"({out['tokens'] / dt:.1f} tok/s on {args.device}, reduced config)")
    if not all(r.done for r in done):
        raise SystemExit("not every request finished")


if __name__ == "__main__":
    main()
