#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py [--seed N]

Phases, each of which fails the run with a non-zero exit:
  1. device  - require CUDA; print the card's name, power limit and count;
  2. build   - compile the CUDA kernels from `src/repro_torch/csrc` (nvcc,
               sm_90a) and print each kernel's registers, shared memory and spills;
  3. kernels - hold each kernel to its plain PyTorch version on the card, at
               the serving shapes and at the JAX package's test sweeps, and
               time kernel, plain version, one library call and the bound
               (decode attention over a rotation of caches, so that its L2
               is cold, as it is in serving);
  4. parity  - qwen3-14b at full width and 2 layers in bf16: prefill and 8
               decode steps through the kernels against the plain path;
  5. serve   - qwen3-14b at full width and depth (40 layers, bf16, seeded
               init): 8 requests of 900-1100 prompt tokens over 4 slots,
               32 new tokens each; every kernel must launch in this phase,
               decode attention once a layer a decode step;
  6. trace   - one decode step of that model, timed and traced with
               torch.profiler: device busy time, idle share, top kernels.
Then one JSON line of the kernels and, last, the JSON result line.
Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref  # noqa: E402
from repro_torch.launch.serve import run as serve_run  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

PEAK_BF16 = 989e12  # H100 SXM dense tensor-core bf16 FLOP/s (data sheet)
PEAK_F32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores
HBM = 3.35e12  # H100 SXM bytes/s
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# COLD_L2_NOTE: in serving, each layer's cache is read once a step, with ~26 GB
# of weights streamed between two reads of it, so it is cold in the 50 MB L2.
# One (4, 2048, 8, 128) K/V pair is 33.5 MB, and a call reads 18 MB of it: timed
# back to back on one pair, every call after the first would read from L2. So
# the decode kernel and its library call are timed over a rotation of
# ROTATION pairs: a pair is read again only after 7 x 18 MB of other reads.
ROTATION = 8
# NORM_GAIN_NOTE: norm gains are drawn near one (1 + 0.1 N(0, 1)), as the
# model initialises them and as trained RMSNorm gains sit. With N(0, 1) gains
# the bf16 outputs reach 16, where one bf16 step is 0.0625: a last-bit
# difference between two float32 sums (the kernel's and torch's reduction
# orders) then flips a rounding past the 3e-2 bar without any fault.

KERNELS = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/rmsnorm.py:20"),
    "rmsnorm_residual": ("src/repro_torch/csrc/rmsnorm_residual.cu",
                         "src/repro/kernels/rmsnorm/rmsnorm.py:26"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/flash_attention.py:31"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/decode_attention.py:27"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    """Wait for the card (the CPU rehearsal in tests substitutes a no-op)."""
    torch.cuda.synchronize()


def time_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean device milliseconds of `fn()` over `iters` launches, after warm-up.

    With `graph`, the `iters` calls are captured in one CUDA graph and the
    replay is timed, so the host's dispatch of each call (the wrappers'
    checks, ctypes, allocation: tens of microseconds) does not count. A
    kernel shorter than that dispatch would otherwise be timed by the host.
    Kernels and library calls are timed so; the plain versions, which copy
    host scalars to the device, are timed as a plain loop.
    """
    for _ in range(warmup):
        fn()
    run = lambda: [fn() for _ in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """Least milliseconds for the work: the larger of bytes/HBM and flops/peak."""
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    tb, tf = nbytes / HBM, flops / peak
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def timing(shape: str, ms: float, plain_ms: float, library_ms, nbytes: float, flops: float,
           dtype: torch.dtype) -> dict:
    """One timed shape: the times, its bound, the achieved rate and the share of the bound."""
    bound_ms, by = bound(nbytes, flops, dtype)
    rate = (f"{nbytes / ms / 1e6:.1f} GB/s" if by == "bytes" else f"{flops / ms / 1e9:.1f} TFLOP/s")
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": by, "rate": rate, "share_of_bound": bound_ms / ms}


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ------------------------------------------------------------------ phase 1-2
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    _, seconds, text = build.build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[build] nvcc {seconds:.1f}s for {len(build.sources())} sources")
    fn = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and fn:
            log(f"[build] {fn}: {m.group(1)} registers, {m.group(2) or 0} B static smem, "
                f"{spills} B spill stores")
            fn = None
    # the decode kernel's clusters at the serving shape (qwen3-14b, 4 slots, n_valid 1100)
    plan = dec_kernel.card_plan(1100, 4, 8, 5, 128)
    log(f"[build] decode_attention serving plan: grid {plan.grid}, clusters of {plan.n_split} CTAs "
        f"({plan.grid[1] * plan.grid[2]} clusters), {plan.stages}-stage TMA ring, {plan.smem} B "
        f"shared memory a CTA; cudaOccupancyMaxActiveClusters: "
        f"{dec_kernel.max_active_clusters(plan, 128)} such clusters resident at once ({sms} SMs)")


# -------------------------------------------------------------------- phase 3
def phase_kernels(dev, *, rows=4096, d=5120, heads=40, B=4, Hq=40, Hkv=8, dh=128, S=1024,
                  fa_lens=(1000, 1024, 1100), T=2048, nvs=(1, 1000, 1100, 2048), nv=1100,
                  sweeps=True) -> dict:
    """Compare each kernel with its plain version and time it; returns per-kernel records.

    Compared at the serving shapes (prefill rows, qk-norm rows, prompt lengths
    `fa_lens`, cache fills `nvs`) and, with `sweeps`, at the JAX package's
    kernel-test sweeps; timed at rows x d (and rmsnorm also at the qk-norm's
    rows x heads by dh), S and nv; decode attention and its library call over
    a rotation of ROTATION caches (see COLD_L2_NOTE).
    """
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    rec: dict = {k: {"max_abs_err": 0.0} for k in KERNELS}

    def note(name, label, err, tol):
        log(f"[kernels] {name} {label}: max_abs_err {err:.3e} (tol {tol:g})")
        if not err < tol:
            raise AssertionError(f"{name} {label}: {err} >= {tol}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    # --- rmsnorm and rmsnorm_residual: hidden rows (eps 1e-5) and qk-norm rows (eps 1e-6)
    norm_cases = [(rows, d, 1e-5, bf), (rows * heads, dh, 1e-6, bf)]
    if sweeps:
        norm_cases += [(t, dd, 1e-5, dt) for t, dd in ((256, 512), (300, 256), (64, 1024))
                       for dt in (torch.float32, bf)]
    for t, dd, eps, dt in norm_cases:
        x, res = _randn(rng, (t, dd), dt, dev), _randn(rng, (t, dd), dt, dev)
        sc = 1 + 0.1 * _randn(rng, (dd,), torch.float32, dev)  # see NORM_GAIN_NOTE
        label = f"({t},{dd}) {str(dt)[6:]}"
        note("rmsnorm", label, _err(rms_ops.rmsnorm(x, sc, eps=eps), rmsnorm_ref(x, sc, eps=eps)),
             TOL[dt])
        y1, r1 = rms_ops.rmsnorm_residual(x, res, sc, eps=eps)
        y2, r2 = rmsnorm_residual_ref(x, res, sc, eps=eps)
        note("rmsnorm_residual", label, max(_err(y1, y2), _err(r1, r2)), TOL[dt])

    x, res = _randn(rng, (rows, d), bf, dev), _randn(rng, (rows, d), bf, dev)
    sc = 1 + 0.1 * _randn(rng, (d,), torch.float32, dev)
    scb = sc.to(bf)
    # each plain version is timed first, before a graph capture holds memory
    plain = time_ms(lambda: rmsnorm_ref(x, sc))
    rec["rmsnorm"].update(timing(
        f"x ({rows},{d}) bf16", time_ms(lambda: rms_ops.rmsnorm(x, sc), iters=50, graph=True),
        plain, time_ms(lambda: F.rms_norm(x, (d,), scb, 1e-5), iters=50, graph=True),
        2 * rows * d * 2 + d * 4, 4 * rows * d, bf))
    xh = _randn(rng, (rows * heads, dh), bf, dev)  # the qk-norm's rows (eps 1e-6)
    sch = 1 + 0.1 * _randn(rng, (dh,), torch.float32, dev)
    schb = sch.to(bf)
    plain = time_ms(lambda: rmsnorm_ref(xh, sch, eps=1e-6))
    rec["rmsnorm"]["extra"] = [timing(
        f"x ({rows * heads},{dh}) bf16 (qk-norm)",
        time_ms(lambda: rms_ops.rmsnorm(xh, sch, eps=1e-6), iters=50, graph=True), plain,
        time_ms(lambda: F.rms_norm(xh, (dh,), schb, 1e-6), iters=50, graph=True),
        2 * rows * heads * dh * 2 + dh * 4, 4 * rows * heads * dh, bf)]
    plain = time_ms(lambda: rmsnorm_residual_ref(x, res, sc))
    rec["rmsnorm_residual"].update(timing(
        f"x, res ({rows},{d}) bf16",
        time_ms(lambda: rms_ops.rmsnorm_residual(x, res, sc), iters=50, graph=True), plain, None,
        4 * rows * d * 2 + d * 4, 5 * rows * d, bf))

    # --- flash attention (prefill)
    fa_cases = [(B, Hq, Hkv, s, dh, None, bf) for s in fa_lens]
    if sweeps:
        fa_cases += [(b, hq, hk, s, e, w, dt)
                     for b, hq, hk, s, e, w in ((2, 4, 4, 256, 64, None), (1, 8, 2, 256, 128, None),
                                                (2, 4, 2, 384, 64, 128), (1, 2, 1, 300, 32, None))
                     for dt in (torch.float32, bf)]
    for b, hq, hk, s, e, w, dt in fa_cases:
        q = _randn(rng, (b, hq, s, e), dt, dev)
        k, v = _randn(rng, (b, hk, s, e), dt, dev), _randn(rng, (b, hk, s, e), dt, dev)
        note("flash_attention", f"B{b} Hq{hq} Hkv{hk} S{s} dh{e} win{w} {str(dt)[6:]}",
             _err(fa_ops.flash_attention_bhsd(q, k, v, window=w), attention_ref(q, k, v, window=w)),
             TOL[dt])
    q = _randn(rng, (B, Hq, S, dh), bf, dev)
    k, v = _randn(rng, (B, Hkv, S, dh), bf, dev), _randn(rng, (B, Hkv, S, dh), bf, dev)
    pairs = S * (S + 1) // 2
    plain = time_ms(lambda: attention_ref(q, k, v), iters=3)
    rec["flash_attention"].update(timing(
        f"q ({B},{Hq},{S},{dh}) kv heads {Hkv} bf16 causal",
        time_ms(lambda: fa_ops.flash_attention_bhsd(q, k, v), iters=50, graph=True), plain,
        time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
                iters=50, graph=True),
        (2 * B * Hq + 2 * B * Hkv) * S * dh * 2, 4 * dh * pairs * B * Hq, bf))

    # --- decode attention, cache in the model's (B, T, Hkv, dh) layout
    G = Hq // Hkv
    dec_cases = [(B, Hkv, G, T, dh, n, bf) for n in nvs]
    if sweeps:
        dec_cases += [(b, hk, g, t, e, n, dt)
                      for b, hk, g, t, e, n in ((2, 4, 2, 512, 64, 300), (1, 2, 6, 1024, 128, 1024),
                                                (2, 8, 1, 512, 64, 1), (1, 2, 4, 600, 32, 77),
                                                (1, 2, 5, 600, 64, 65), (2, 1, 16, 2048, 128, 1100))
                      for dt in (torch.float32, bf)]
    for b, hk, g, t, e, n, dt in dec_cases:
        qd = _randn(rng, (b, hk, g, e), dt, dev)
        kc, vc = _randn(rng, (b, t, hk, e), dt, dev), _randn(rng, (b, t, hk, e), dt, dev)
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        note("decode_attention", f"B{b} Hkv{hk} G{g} T{t} dh{e} nv{n} {str(dt)[6:]}",
             _err(dec_ops.decode_attention(qd, kt, vt, n), decode_attention_ref(qd, kt, vt, n)),
             TOL[dt])
    qd = _randn(rng, (B, Hkv, G, dh), bf, dev)
    pairs = [tuple(_randn(rng, (B, T, Hkv, dh), bf, dev).transpose(1, 2) for _ in range(2))
             for _ in range(ROTATION)]
    kt, vt = pairs[0]
    q_sdpa = qd.reshape(B, Hq, 1, dh)
    rot_mb = ROTATION * 2 * kt.numel() * kt.element_size() / 1e6

    def cold(fn):  # fn(k, v) over the pairs in turn (COLD_L2_NOTE)
        turn = itertools.cycle(pairs)
        return lambda: fn(*next(turn))

    kern = lambda k_, v_: dec_ops.decode_attention(qd, k_, v_, nv)  # noqa: E731
    sdpa = lambda k_, v_: F.scaled_dot_product_attention(  # noqa: E731
        q_sdpa, k_[:, :, :nv], v_[:, :, :nv], enable_gqa=True)
    plain = time_ms(lambda: decode_attention_ref(qd, kt, vt, nv))
    iters = 6 * ROTATION
    rec["decode_attention"].update(timing(
        f"q ({B},{Hkv},{G},{dh}) cache ({B},{T},{Hkv},{dh}) n_valid {nv} bf16, cold L2 "
        f"({ROTATION} K/V pairs rotated, {rot_mb:.1f} MB)",
        time_ms(cold(kern), iters=iters, graph=True), plain,
        time_ms(cold(sdpa), iters=iters, graph=True),
        2 * B * Hq * dh * 2 + 2 * B * Hkv * nv * dh * 2, 4 * B * Hq * nv * dh, bf))
    warm_k, warm_s = (time_ms(lambda: f(kt, vt), iters=iters, graph=True) for f in (kern, sdpa))
    log(f"[kernels] decode_attention timing: {iters} graph-captured calls over {ROTATION} K/V "
        f"cache pairs ({rot_mb:.1f} MB, a pair read again after {ROTATION - 1} x "
        f"{2 * B * Hkv * nv * dh * 2 / 1e6:.1f} MB of other reads); on one pair (warm L2, "
        f"not reported): kernel {warm_k:.4f} ms, SDPA {warm_s:.4f} ms")
    # what does not scale with the cache: one 64-slot tile per (batch, kv head), cold,
    # and a trivial kernel as one node of a graph (the launch alone)
    one_tile = time_ms(cold(lambda k_, v_: dec_ops.decode_attention(qd, k_, v_, min(64, T))),
                       iters=iters, graph=True)
    z = torch.zeros(16, device=dev)
    node = time_ms(lambda: z.add_(1), iters=iters, graph=True)
    log(f"[kernels] decode_attention floor: n_valid 64 (one tile per (batch, kv head)) "
        f"{one_tile:.4f} ms cold; a trivial kernel as a graph node {node:.4f} ms")
    del pairs, kt, vt
    for name, r in rec.items():
        for t in [r, *r.get("extra", [])]:
            lib_ms = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
            log(f"[kernels] {name} at {t['shape']}: kernel {t['ms']:.4f} ms ({t['rate']}, "
                f"{100 * t['share_of_bound']:.1f}% of bound), plain {t['plain_ms']:.4f} ms, "
                f"library {lib_ms} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return rec


# -------------------------------------------------------------------- phase 4
def phase_parity(dev, cfg, *, batch=2, prompt=300, steps=8, seed=0) -> dict:
    """Kernel path against the plain path on the card, both in the config's dtype.

    Tolerance: twice the bf16 floor, the distance between the plain path in
    bf16 and the plain path in float32 (same weights, same tokens, this run).
    The two bf16 paths compute the same function and round at different
    places (the fused residual norm reads the unrounded sum; the kernels sum
    in another order), so each lies about one floor from the float32 result
    and, by the triangle inequality, at most two floors from the other.
    """
    params = Model(cfg).init(seed, dev)
    params32 = cast_tree(params, torch.float32)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt + steps))).to(dev)
    max_len = prompt + steps
    runs = {}
    for label, model, p in (("kernels", Model(cfg), params), ("plain", Model(cfg, kernels=False), params),
                            ("plain_fp32", Model(cfg32, kernels=False), params32)):
        logits, cache = model.prefill(p, {"tokens": toks[:, :prompt]}, max_len)
        outs = [logits]
        for t in range(prompt, prompt + steps):
            logits, cache = model.decode_step(p, cache, toks[:, t:t + 1])
            outs.append(logits)
        runs[label] = torch.stack(outs)
        del cache
    if not torch.isfinite(runs["kernels"]).all():
        raise AssertionError("kernel path gave non-finite logits")
    err = _err(runs["kernels"], runs["plain"])
    floor = _err(runs["plain"], runs["plain_fp32"])
    tol = 2 * floor
    agree = (runs["kernels"].argmax(-1) == runs["plain"].argmax(-1)).float().mean().item()
    log(f"[parity] {cfg.name} d{cfg.d_model} L{cfg.num_layers} {cfg.dtype}: prefill + {steps} "
        f"decode steps, max_abs_err kernels vs plain {err:.4e}, tolerance {tol:.4e} (2 x bf16 "
        f"floor {floor:.4e}), kernels vs fp32 {_err(runs['kernels'], runs['plain_fp32']):.4e}, "
        f"max |logit| {runs['plain'].abs().max().item():.3f}, greedy agreement {agree:.4f}")
    if not err <= tol:
        raise AssertionError(f"parity: {err} > {tol}")
    return {"max_abs_err": err, "tolerance": tol, "greedy_agreement": agree}


def cast_tree(params: dict, dtype) -> dict:
    """A copy of a parameter tree with every floating leaf in `dtype`."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in params.items()}


# -------------------------------------------------------------------- phase 5
def phase_serve(dev, cfg, *, requests=8, slots=4, prompt_len=(900, 1100), max_new=32,
                max_len=2048, seed=0) -> dict:
    build.reset_launches()
    out = serve_run(cfg, device=dev, requests=requests, slots=slots, prompt_len=prompt_len,
                    max_new=max_new, max_len=max_len, seed=seed)
    launches = dict(build.LAUNCHES)
    done = out["requests"]
    if not all(r.done and len(r.out_tokens) == max_new for r in done):
        raise AssertionError("serve: not every request finished with its tokens")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError("serve: token out of the vocabulary")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched on the main path: {missing}")
    steps = out["decode_steps"]
    if launches["decode_attention"] != cfg.num_layers * steps:
        raise AssertionError(f"serve: {launches['decode_attention']} decode-attention launches in "
                             f"{steps} decode steps of {cfg.num_layers} layers")
    mem = out["max_memory_allocated"]
    admissions = launches["flash_attention"] // cfg.num_layers  # one flash launch a layer a prefill
    log(f"[serve] {cfg.name} L{cfg.num_layers} d{cfg.d_model} {cfg.dtype}: {len(done)} requests, "
        f"{out['prompt_tokens']} prompt tokens, {out['tokens']} new tokens in {out['seconds']:.3f}s "
        f"({out['tokens'] / out['seconds']:.2f} tok/s); prefill {out['prefill_seconds']:.3f}s "
        f"({out['prefill_seconds'] / max(admissions, 1):.3f}s per admission, {admissions} admissions), "
        f"decode {steps} steps {1e3 * out['decode_seconds'] / max(steps, 1):.3f} ms/step; "
        f"max_memory_allocated {mem / 2**30 if mem else 0:.2f} GiB; launches {launches}")
    return {**{k: v for k, v in out.items() if k != "requests"}, "launches": launches}


# -------------------------------------------------------------------- phase 6
def phase_trace(dev, cfg, *, slots=4, prompt=1024, steps=4, seed=0) -> dict:
    """Where a decode step's time goes, at the serve phase's shape.

    Times `steps` decode steps with the host clock (ending in a sync), then
    traces the same number of steps with `torch.profiler` and sums the device
    time of every kernel: the device's idle share of a step is one minus
    their ratio. Prints the kernels that take the most device time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = Model(cfg)
    params = model.init(seed, dev)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (slots, prompt + 2 * steps + 1))).to(dev)
    _, cache = model.prefill(params, {"tokens": toks[:, :prompt]}, prompt + 2 * steps + 1)
    model.decode_step(params, cache, toks[:, prompt:prompt + 1])  # warm-up
    sync()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        model.decode_step(params, cache, toks[:, prompt + i:prompt + i + 1])
    sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps + 1, 2 * steps + 1):
            model.decode_step(params, cache, toks[:, prompt + i:prompt + i + 1])
        sync()
    # device-side events only: a CPU op such as aten::mm also carries the
    # device time of the kernels it launched, which are listed themselves
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[trace] decode step at {slots} slots, pos ~{prompt}: wall {wall_ms:.3f} ms (host clock, "
        f"untraced), device busy {device_ms:.3f} ms, idle share {1 - device_ms / wall_ms:.3f}")
    for e in top:
        log(f"[trace]   {e.self_device_time_total / 1e3 / steps:9.3f} ms/step  "
            f"{e.count // steps:5d} calls/step  {e.key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_build()
    rec = phase_kernels(dev)
    full = get_config("qwen3_14b")
    phase_parity(dev, dataclasses.replace(full, num_layers=2), seed=args.seed)
    torch.cuda.empty_cache()
    serve = phase_serve(dev, full, seed=args.seed)
    torch.cuda.empty_cache()
    phase_trace(dev, full, seed=args.seed)
    kernels = [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": serve["launches"][name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "shape": r["shape"],
         **({"extra_shapes": r["extra"]} if "extra" in r else {})}
        for name, r in rec.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
