#!/usr/bin/env python3
"""Time one checkout's kernels and serve phase on one GPU, to compare two commits.

  python3 scripts/chip_compare.py ROOT    # ROOT: a checkout of this repo

Run it on each checkout in turns (parent, change, change, parent) on one
card in one machine session: two calls may land on cards with other power
limits. Prints one line `COMPARE {json}` with
  - the device milliseconds of rmsnorm at (4096, 5120) and at the qk-norm's
    (163840, 128), of flash attention at q (4, 40, 1024, 128) with 8 kv
    heads, bf16 causal, and of decode attention at q (4, 8, 5, 128) over a
    (4, 2048, 8, 128) cache with n_valid 1100: each the mean of a CUDA graph
    of back-to-back calls, so the host's dispatch of each call does not
    count. Decode attention rotates over ROTATION cache pairs (268 MB), so
    that no call finds its cache in the 50 MB L2, as in serving, where ~26 GB
    of weights stream between two reads of a layer's cache;
  - the serve phase of ROOT's `chip_smoke.py` (qwen3-14b at full width and
    depth, 8 requests over 4 slots), after a short warm-up serve that takes
    the first-call costs: prefill seconds per admission, decode ms per step,
    new tokens per second and peak device memory.
The kernels, the model and the serve loop are ROOT's; only the timing is
this file's. Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROTATION = 8  # K/V cache pairs the decode timing rotates over


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of `fn()` over a CUDA graph of `iters` calls."""
    for _ in range(3):
        fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit("usage: chip_compare.py ROOT (on a machine with a CUDA device)")
    root = Path(sys.argv[1]).resolve()
    spec = importlib.util.spec_from_file_location("root_chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # puts ROOT/src first on the path and imports its package
    if not Path(cs.build.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"chip_compare: imported {cs.build.__file__}, not ROOT's package")
    dev = torch.device("cuda")
    cs.build.build()
    rng = np.random.default_rng(0)

    def rn(shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)

    x, sc = rn((4096, 5120)), 1 + 0.1 * rn((5120,), torch.float32)
    xh, sch = rn((163840, 128)), 1 + 0.1 * rn((128,), torch.float32)
    q, k, v = rn((4, 40, 1024, 128)), rn((4, 8, 1024, 128)), rn((4, 8, 1024, 128))
    qd = rn((4, 8, 5, 128))
    caches = itertools.cycle([tuple(rn((4, 2048, 8, 128)).transpose(1, 2) for _ in range(2))
                              for _ in range(ROTATION)])

    def decode_cold():
        kc, vc = next(caches)
        return cs.dec_ops.decode_attention(qd, kc, vc, 1100)

    out = {
        "root": sys.argv[1],
        "rmsnorm_4096x5120_ms": graph_ms(lambda: cs.rms_ops.rmsnorm(x, sc), 50),
        "rmsnorm_163840x128_ms": graph_ms(lambda: cs.rms_ops.rmsnorm(xh, sch, eps=1e-6), 50),
        "flash_4x40x1024x128_ms": graph_ms(lambda: cs.fa_ops.flash_attention_bhsd(q, k, v), 20),
        "decode_4x8x5x128_nv1100_ms": graph_ms(decode_cold, 6 * ROTATION),
        "decode_rotation_mb": ROTATION * 2 * 4 * 2048 * 8 * 128 * 2 / 1e6,
    }
    del x, xh, q, k, v, qd, caches
    cfg = cs.get_config("qwen3_14b")
    cs.phase_serve(dev, cfg, requests=4, max_new=2, seed=1)  # warm-up
    torch.cuda.empty_cache()
    serve = cs.phase_serve(dev, cfg, seed=0)
    admissions = serve["launches"]["flash_attention"] // cfg.num_layers
    out.update(prefill_s_per_admission=serve["prefill_seconds"] / admissions,
               admissions=admissions,
               decode_ms_per_step=1e3 * serve["decode_seconds"] / serve["decode_steps"],
               tok_s=serve["tokens"] / serve["seconds"],
               peak_gib=serve["max_memory_allocated"] / 2**30)
    print("COMPARE " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
