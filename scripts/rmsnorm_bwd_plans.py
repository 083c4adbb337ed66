#!/usr/bin/env python3
"""Time the RMSNorm backward kernel over launch plans on one GPU.

  python3 scripts/rmsnorm_bwd_plans.py [--top N]

For bf16 rows of danube's training batch (12288, 2560) and of qwen3-14b's
(4096, 5120), the plain norm and the fused residual norm, it launches
`csrc/rmsnorm_bwd.cu` directly through its C entry point with every plan
the kernel takes among: 1, 2 or 4 16-byte loads a thread, 1-4 rows a block
and 1-4 blocks an SM (132 SMs), checks each against the plain version, and
prints the N fastest plans beside the one `launch_plan` picks and the
bound (each row tensor read once, dx written once, over 3.35 TB/s). Each
time is the mean of a CUDA graph of 20 back-to-back calls (the kernel and
its partial-sum reduction). Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as rms_bwd  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref  # noqa: E402

HBM = 3.35e12  # H100 SXM bytes/s


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds of `fn()` over a CUDA graph of `iters` calls."""
    for _ in range(2):
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


def plans(rows: int, d: int, sms: int):
    nvec = d // 8
    for vpt in (1, 2, 4):
        lanes = 32 * -(-nvec // (32 * vpt))
        for rpb in (1, 2, 3, 4):
            if lanes * rpb > rms_bwd.MAX_THREADS or (rpb > 1 and rpb * d * 4 > 48 * 1024):
                continue
            for per_sm in (1, 2, 3, 4):
                yield rms_bwd.Plan(8, lanes, rpb, vpt, min(sms * per_sm, -(-rows // rpb)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_bwd_plans: needs a CUDA device")
    dev, bf = torch.device("cuda"), torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = build.library()
    rng = np.random.default_rng(0)
    for rows, d in ((12288, 2560), (4096, 5120)):
        x, res, dy, dr = (torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)).to(dev, bf)
                          for _ in range(4))
        sc = 1 + 0.1 * torch.from_numpy(rng.standard_normal(d, dtype=np.float32)).to(dev)
        for fused in (False, True):
            args_ = (x, res if fused else None, sc, dy, dr if fused else None)
            want_dx, want_ds = rmsnorm_bwd_ref(*args_)
            dx, ds = torch.empty_like(x), torch.empty(d, device=dev)
            ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
            timed = []
            for plan in plans(rows, d, sms):
                part = torch.empty((plan.blocks, d), device=dev)
                call = lambda p=plan, part=part: lib.launch_rmsnorm_bwd(  # noqa: E731
                    *(ptr(t) for t in (x, args_[1], sc, dy, args_[4], dx, part, ds)),
                    rows, d, 1e-5, 1, *p, build.stream_ptr(dev))  # the capture's stream in a graph
                if call() != 0:  # a plan the kernel does not take (too many loads a thread)
                    continue
                torch.cuda.synchronize()
                rel = ((dx.float() - want_dx.float()).norm() / want_dx.float().norm()).item()
                if not rel <= 1e-2 or not torch.allclose(ds, want_ds, rtol=1e-4, atol=1e-3):
                    raise AssertionError(f"plan {tuple(plan)}: dx rel {rel}")
                timed.append((graph_ms(call), tuple(plan)))
            timed.sort()
            chosen = tuple(rms_bwd.launch_plan(rows, d, 2, True, fused, sms))
            nbytes = (5 if fused else 3) * rows * d * 2
            print(f"({rows},{d}) {'fused' if fused else 'plain'}: bound {nbytes / HBM * 1e3:.4f} ms; "
                  f"launch_plan {chosen}: {dict((p, t) for t, p in timed).get(chosen, float('nan')):.4f} ms")
            for t, p in timed[:args.top]:
                print(f"    {t:.4f} ms  plan (vec, lanes, rows/block, loads/thread, blocks) {p}")


if __name__ == "__main__":
    main()
