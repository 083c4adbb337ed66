#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

  python3 chip_smoke.py [--seed N]

Phases, each of which fails the run with a non-zero exit:
  1. device  - require CUDA; print the card's name, power limit and count;
  2. build   - compile the CUDA kernels from `src/repro_torch/csrc` (nvcc,
               sm_90a) and print each kernel's registers, shared memory and
               spills, and the decode kernel's cluster plans;
  3. kernels - hold each kernel to its plain PyTorch version on the card, at
               the serving shapes and at the JAX package's test sweeps, and
               time kernel, plain version, one library call and the bound
               (decode attention over a rotation of caches, so that its L2
               is cold, as it is in serving); the attention kernels also at
               h2o-danube's shapes (dh 80 on the tensor cores, a 4096 window),
               where the kernel launched with the padded width's scale must
               fail its check (ATTN_BAR_NOTE), and at zamba2's and musicgen's
               dh 64 with 32 kv heads (G 1);
  4. parity  - each config that fits one card (NOT_ON_ONE_CARD) at full width
               and 2 layers (PARITY_LAYERS: zamba2-1.2b at 7, one segment and
               a one-layer tail) in bf16: prefill and 8 decode steps through
               the kernels against the plain path, h2o-danube's prompt past
               its window, the 300-token prompt past one Mamba2 chunk (256)
               and RWKV6 chunks (32) and a multiple of neither; and the plain
               path's float32 `forward` against its own prefill and decode
               steps (the ring, and the recurrent states after a padded
               chunk, against a computation without them), `forward` and
               `loss` through the kernels against the plain path;
               deepseek-moe-16b (a dense layer, then an MoE layer) at dropless
               capacity, routing-aware, and in float32 too (ROUTING_NOTE);
  5. serve   - qwen3-14b at full width and depth (40 layers, bf16, seeded
               init): 8 requests of 900-1100 prompt tokens over 4 slots,
               32 new tokens each; then the other configs that fit one card
               at full width and depth (SERVE_TRAFFIC; h2o-danube's prompts
               pass its window; deepseek-moe-16b at its published capacity,
               zamba2-1.2b and rwkv6-7b, each with two admissions, which
               splice the recurrent states). Every kernel of a config's path
               must launch, and no other (rwkv6-7b's path has none), flash
               attention once an attention block an admission, decode
               attention once an attention block a decode step;
  6. trace   - after each config's serve, decode steps of that model at its
               serve shape, timed and traced with torch.profiler: device
               busy time, idle share, top kernels (and the device items of
               the MoE layer, of the Mamba2 layers and of the RWKV6 layers);
  7. train   - the training path: (after phase 3) the two backward kernels,
               flash attention's and RMSNorm's, against their plain versions
               (BWD_BAR_NOTE) at h2o-danube's training shape (q (2, 32, 6144,
               80), window 4096), qwen3-14b's, dh 64 at G 1, zamba2-1.2b's
               (q (2, 32, 4096, 64), 32 kv heads) and deepseek-moe-16b's (q
               (2, 16, 4096, 128), 16 kv heads) training shapes, and sweeps,
               with the forward kernel's LSE; bf16 at dh 64, 80 and 128 must
               run the flash backward's tensor-core kernels and float32 and
               dh 32 its fp32-tile ones (the profiler names them), and a
               second run of either kernel must give the same bits; the
               RMSNorm backward plain and fused at zamba2's and deepseek's
               rows (8192, 2048) too; each timed beside its plain version and
               PyTorch's backward (SDPA's, F.rms_norm's: a CUDA graph of
               forward and backward less one of the forward alone); (after
               phase 6) train parity at full width (TRAIN_PARITY, TRAIN_NOTE)
               for danube at 6144 tokens and qwen3-14b at 2048 (2 layers),
               zamba2 at 7 layers (a segment and a tail) at 4096, and
               deepseek at 2 layers (the dense layer, an MoE layer) at 2048,
               in float32 (routing identical, TRAIN_F32_TOL) and in bf16
               routing-aware (TRAIN_ROUTING_NOTE); the kernel path's loss and
               gradients identical under remat none, selective and full for
               each of those and for rwkv6-7b at 2 layers (REMAT_ONLY), with
               each policy's peak memory; a 2-layer danube Trainer resumed
               from a checkpoint; and the training runs through
               `launch.train.run` (TRAIN_RUNS): h2o-danube and zamba2-1.2b at
               full width and depth, deepseek-moe-16b at full width and 4
               layers, rwkv6-7b at full width and depth with int8 moments:
               step time, tokens/s, MFU (MFU_NOTE), peak memory, the MoE
               metrics, every kernel of each path launched and no other;
               then one step of each traced (device busy time, idle share,
               top kernels);
  8. mesh    - h2o-danube-1.8b at full width and depth trained on a (data,
               model) device mesh through `launch.train.run(mesh=...)`, the
               state DTensors and the kernels on local shards (MESH_NOTE): (a)
               one process, NCCL, (data 1, model 1), against phase 7's run;
               (b) two processes sharing the card over gloo, (data 1, model
               2), each rank on half the heads, against one device; which
               collectives gloo takes on CUDA tensors is printed; (c)
               zamba2-1.2b at full width and depth and (d) rwkv6-7b at full
               width and 2 layers on the (data 1, model 1) NCCL mesh under
               `rules_for(mesh)`, sequence parallelism on (MESH_SP_NOTE);
  9. cp serve - qwen3-14b at full width and depth served on that mesh under
               JAX's decode rules with context parallelism on "data": one
               prompt, greedy decode steps, the KV cache placed per
               `Model.cache_pspecs(cp=True)` and decode joining the ranks'
               partial outputs by their log-sum-exps (CP_NOTE), against the
               single-device kernel path;
 10. split   - the decode kernel's LSE output: a cache cut into 2 and 4
               contiguous parts, some with no valid slot, each part through
               the kernel, joined by `lse_combine`, against the whole cache's
               kernel and its plain version (SPLIT_NOTE); the kernel timed with
               and without the LSE output.
Then a table of the serve numbers, one JSON line of the kernels (the four
TPU kernels' ports and the two backward kernels) and, last, the JSON result
line. Needs one card; imports nothing of JAX.
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

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd as fa_bwd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref, attention_ref,  # noqa: E402
                                                     flash_attention_bwd_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_ref, rmsnorm_ref,  # noqa: E402
                                             rmsnorm_residual_ref)
from repro_torch.configs.base import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_mesh, rules_for  # noqa: E402
from repro_torch.launch.serve import run as serve_run  # noqa: E402
from repro_torch.launch.train import run as train_run  # noqa: E402
from repro_torch.models import mamba2, moe, rwkv6  # noqa: E402
from repro_torch.models.params import _walk, distribute, layer_params, param_defs  # noqa: E402
from repro_torch.parallel.axes import (lse_combine, make_rules, placements,  # noqa: E402
                                       sanitize_pspec, use_mesh)
from repro_torch.models.transformer import (AUX_KEYS, Model, _apply_mamba_layer,  # noqa: E402
                                            _apply_rwkv_layer, saved_record)
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.train.tree import paths  # noqa: E402

PEAK_BF16 = 989e12  # H100 SXM dense tensor-core bf16 FLOP/s (data sheet)
PEAK_F32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores
HBM = 3.35e12  # H100 SXM bytes/s
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# ATTN_BAR_NOTE: an attention output over n keys averages n rows of V, so its
# typical size is ~sqrt(e / n): 0.026 at n 4096, below the bf16 bar of 3e-2. There
# the absolute bar alone cannot tell a right kernel from one that, say, scales by
# the padded width (128 ** -0.5 at dh 80), which moves each output by about a
# fifth of its size. So bf16 attention is also held to REL_TOL, the norm of the
# difference over the norm of the plain output, a few times the plain bf16
# version's own distance from float32 (logged as the bf16 floor at h2o-danube's
# shapes). At those shapes the kernel is also launched with the padded width's
# scale, and the check must reject it.
REL_TOL = 1e-2
# tolerance of the serving invariant (the float32 forward against prefill and
# decode steps): the bar of tests/test_decode_equivalence.py
FORWARD_TOL = 2e-3
# ROUTING_NOTE: an MoE layer's top-k routing is a discrete decision, so a bar on
# logits alone is ill-posed across it. With random init the router logits spread
# ~0.9 and the 6th and 7th of 64 lie ~0.09 apart, while bf16 rounding moves a
# logit by ~4e-3: a few per cent of tokens may take another expert on the kernel
# path than on the plain path, which moves that token's output by about a sixth
# of an expert's, far over the bf16 floor. So phase 4 runs MoE configs at
# dropless capacity (one token's routing cannot drop another, as JAX's
# tests/test_decode_equivalence.py does), keeps each run's routing
# (`moe.routing_record`), and holds float32 to identical routing and bf16 to the
# logits bar at the positions that no differing routing reaches. A token that is
# routed differently must be a near tie: its gap (k-th minus (k+1)-th router
# probability) in the float32 run must be under MOE_GAP_MARGIN. The margin is the
# bf16 perturbation of that gap, its largest over the tokens routed alike, as
# measured by this phase on the CPU at deepseek's full width (vocabulary and
# expert width cut, which the router's input does not see) over seeds 0-2:
# 1.37e-3, 1.34e-3, 1.35e-3 on the kernel path (the kernels' plain versions),
# 1.57e-3, 1.04e-3, 1.30e-3 on the plain path; a flip needs a gap under twice
# the perturbation, and the margin is 2.5 x 1.6e-3 for the card's other rounding
# (tests/test_torch_smoke.py::test_moe_gap_margin_covers_the_bf16_perturbation).
# The run also requires that the gap moved by less than the margin at every
# token routed alike.
MOE_GAP_MARGIN = 4e-3
# float32 bar of phase 4's kernel-vs-plain logits: the kernels' float32 bar,
# scaled by the size of the logits (the bar's 2e-5 is for outputs of order one)
FP32_LOGIT_TOL = 2e-5
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

# phase 5's traffic for the configs after qwen3-14b (which keeps the defaults of
# `phase_serve`): h2o-danube's prompts pass its 4096-token window, so that each
# admission prefills past it and decode reads a full ring; the other dense configs
# at qwen3-14b's prompt lengths with half its requests and new tokens; and
# deepseek-moe-16b with 8 requests, so that a second admission prefills padding
# positions (which route and compete for expert capacity like any other token)
SERVE_TRAFFIC = {
    "h2o_danube_1p8b": dict(requests=8, prompt_len=(4200, 4600), max_new=32, max_len=8192),
    **{arch: dict(requests=4, prompt_len=(900, 1100), max_new=16, max_len=2048)
       for arch in ("pixtral_12b", "starcoder2_3b", "minitron_8b", "musicgen_large")},
    # 8 requests over 4 slots: a second admission splices the caches (for the
    # recurrent families, the Mamba2 and RWKV6 states on their slot axes)
    **{arch: dict(requests=8, prompt_len=(900, 1100), max_new=16, max_len=2048)
       for arch in ("deepseek_moe_16b", "zamba2_1p2b", "rwkv6_7b")},
}
# phase 4's depth where 2 layers do not run every block of the path: zamba2 at
# attn_every + 1 = 7 layers, one segment [shared block, 6 Mamba2 layers] and a tail
# [shared block, 1 Mamba2 layer], so both cache forms of the shared block run
PARITY_LAYERS = {"zamba2_1p2b": 7}
# ported configs that one card cannot hold, and why: phases 4-6 leave them out
NOT_ON_ONE_CARD = {"arctic_480b": "~960 GB of bf16 experts: needs a mesh of more than one card "
                                  "(ROADMAP A6.6)"}

# the backward kernels of the training path (phase 7): not ports of TPU kernels,
# since JAX computes both in jnp; `replaces` names that jnp counterpart
TRAIN_KERNELS = {
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "none (no TPU kernel): jnp src/repro/models/flash_vjp.py:90 _bwd_rule"),
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm_bwd.cu",
                    "none (no TPU kernel): autodiff of src/repro/models/layers.py:35 apply_norm"),
}
# BWD_BAR_NOTE: the backward kernels against their plain versions on the same
# inputs (the forward kernel's out and LSE): float32 max abs error <= 1e-4 x the
# plain output's max |value| (sums over thousands of terms in another order);
# bf16 relative error (norm of the difference over the norm of the plain output)
# <= REL_TOL, as ATTN_BAR_NOTE's: both compute in float32 and round once.
BWD_F32_TOL = 1e-4
# TRAIN_NOTE: phase 7's train parity holds the kernel path's loss and every
# gradient leaf to the plain path in bf16, against twice the bf16 floor (the
# plain bf16 path against the plain float32 path): per leaf by relative error
# (norm of the difference over the norm of the float32 leaf); the loss by its
# mean per-token CE, whose floor is the mean |CE difference| per token (a mean
# moves by at most that, so the same triangle argument as phase_parity's holds
# for it).
# TRAIN_F32_TOL: an MoE config's train parity in float32, where both paths must
# route every token alike, holds the loss and every gradient leaf by relative
# error (as TRAIN_NOTE's) within BWD_F32_TOL: the two paths compute the same
# function and differ only in the order of their sums (the kernels' reductions
# over keys and rows), each rounding at float32's 6e-8, and each backward
# kernel alone is held to BWD_F32_TOL of its output's size; a gradient leaf is a
# sum over the tokens of products of such outputs, which averages those
# differences rather than adding them.
TRAIN_F32_TOL = BWD_F32_TOL
# TRAIN_ROUTING_NOTE: in bf16 a few tokens may take another expert on one path
# than on another (ROUTING_NOTE), and a gradient sums over every token. So the
# bf16 MoE train parity finds the tokens routed differently by any of the
# kernel, plain and plain float32 paths (each must be a near tie, its float32
# gap under MOE_GAP_MARGIN), leaves the positions they reach out of the loss
# (label -1), and holds TRAIN_NOTE there. A token so left out still reaches the
# gradients through the load-balance loss, whose expert counts weight every
# token's router probabilities: the routers' gradients and, through them, the
# leaves before the routers (the embedding, the head layers, the MoE layers'
# attention and norms). Where any token differs, only the other leaves (the
# experts, routed and shared, the final norm and the head: MOE_UNREACHED) are
# compared; where none does, every leaf. Both runs at dropless capacity (C >= T),
# as phase 4's, so that one token's routing cannot drop another.
MOE_UNREACHED = ("layers/moe/wi", "layers/moe/wg", "layers/moe/wo", "layers/moe/shared/",
                 "final_norm/", "lm_head/")
TRAIN_PARITY = {"h2o_danube_1p8b": dict(batch=1, seq=6144), "qwen3_14b": dict(batch=1, seq=2048),
                "zamba2_1p2b": dict(batch=1, seq=4096), "deepseek_moe_16b": dict(batch=1, seq=2048)}
# configs held to remat identity alone (no kernel on their path: their two paths are one)
REMAT_ONLY = {"rwkv6_7b": dict(batch=1, seq=4096)}
# the training runs, each SyntheticLM(vocab, seq, batch) for `steps` steps, the first
# `warmup` left out of the step time; `layers` cuts the depth (deepseek-moe-16b: the
# dense layer and 3 of its 27 MoE layers, as its state at full depth, ~197 GB, does
# not fit one card); rwkv6-7b with JAX's policy for it, remat full (`repro.launch.
# dryrun.ARCH_TRAIN_OVERRIDES`) and int8 moments
TRAIN_RUNS = {
    "h2o_danube_1p8b": dict(batch=2, seq=6144, steps=6, warmup=2, remat="selective"),
    "zamba2_1p2b": dict(batch=2, seq=4096, steps=6, warmup=2, remat="selective"),
    "deepseek_moe_16b": dict(layers=4, batch=2, seq=4096, steps=6, warmup=2, remat="selective"),
    "rwkv6_7b": dict(batch=1, seq=4096, steps=4, warmup=1, remat="full", optimizer="adamw8bit"),
}
# the kernels of a training path (h2o-danube's, zamba2's, deepseek's: RMSNorm, no qk-norm)
TRAIN_PATH = ("flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_residual", "rmsnorm_bwd")
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"

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


def _rel(a, b) -> float:
    """Norm of the difference over the norm of `b` (ATTN_BAR_NOTE)."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _padded(dh: int) -> int:
    """The tensor-core kernels' tile width: whole 64-column swizzle rows."""
    return -(-dh // 64) * 64


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
    # the decode kernel's clusters at the serving shapes: qwen3-14b (4 slots, n_valid
    # 1100), h2o-danube (dh 80 in padded tiles, a full ring of 4096 slots),
    # deepseek-moe-16b (16 kv heads, G 1) and zamba2-1.2b (32 kv heads, G 1, dh 64)
    for name, (nv, Hkv, G, dh) in (("qwen3-14b", (1100, 8, 5, 128)),
                                   ("h2o-danube-1.8b", (4096, 8, 4, 80)),
                                   ("deepseek-moe-16b", (1100, 16, 1, 128)),
                                   ("zamba2-1.2b", (1100, 32, 1, 64))):
        plan = dec_kernel.card_plan(nv, 4, Hkv, G, dh)
        log(f"[build] decode_attention {name} plan: grid {plan.grid}, clusters of {plan.n_split} "
            f"CTAs ({plan.grid[1] * plan.grid[2]} clusters), {plan.stages}-stage TMA ring, "
            f"{plan.smem} B shared memory a CTA; cudaOccupancyMaxActiveClusters: "
            f"{dec_kernel.max_active_clusters(plan, dh)} such clusters resident at once ({sms} SMs)")


# -------------------------------------------------------------------- phase 3
def live_pairs(S: int, window: int | None) -> int:
    """Query-key pairs a causal attention over S positions computes, in a window if given."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def device_kernels(fn) -> set[str]:
    """Names of the device kernels that a call of `fn` launches (torch.profiler).

    `fn` runs twice while the profiler records: on the card it has been seen
    to miss the first kernels launched right after it starts (a flash
    backward at danube's shape came back as its last kernel alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
            sync()
    return {e.key for e in prof.key_averages() if e.device_type != DeviceType.CPU}


def _on_tensor_cores(dev, fn, kernel, name: str | tuple[str, ...], dh: int) -> None:
    """bf16 at dh 64, 80 or 128 must take the tensor-core kernels: the wrapper must
    route it there (the C launcher refuses a plan other than the wrapper's), and
    on the card the profiler, when it records the call, must name each of those
    kernels (`name<dh>`). A profiler session that records no device kernel at
    all says nothing either way, and is logged as such."""
    if dh not in (64, 80, 128):
        return
    if not kernel.on_tensor_cores(torch.bfloat16, dh):
        raise AssertionError(f"bf16 dh {dh} is routed off the tensor-core path")
    if dev.type != "cuda":  # the CPU rehearsal runs the plain versions
        return
    wanted = (name,) if isinstance(name, str) else name
    names = device_kernels(fn)
    missing = [w for w in wanted if not any(f"{w}<{dh}>" in n for n in names)]
    if names and missing:
        raise AssertionError(f"bf16 dh {dh} ran off the tensor-core path: {sorted(names)}")
    log(f"[kernels] {', '.join(f'{w}<{dh}>' for w in wanted)}: routed there; profiler: "
        + ("ran" if names else "recorded no device kernel in this session"))


def _on_fp32_tiles(dev, fn, dt, dh: int) -> None:
    """float32, and bf16 at dh 32, must take the flash backward's fp32-tile kernels
    (`fabwd::dkdv_kernel`, `fabwd::dq_kernel`) and no tensor-core kernel."""
    if fa_bwd.on_tensor_cores(dt, dh):
        raise AssertionError(f"{dt} dh {dh} is routed to the tensor cores")
    if dev.type != "cuda":
        return
    names = device_kernels(fn)
    if names and (not any("dkdv_kernel<" in n for n in names) or any("_tc_kernel" in n for n in names)):
        raise AssertionError(f"{dt} dh {dh} ran off the fp32-tile kernels: {sorted(names)}")


def _log_floor(name: str, label: str, ref, ref32) -> None:
    """The plain bf16 version's own distance from float32 (ATTN_BAR_NOTE)."""
    log(f"[kernels] {name} {label}: bf16 floor (plain bf16 vs plain float32) max_abs_err "
        f"{_err(ref, ref32):.3e}, rel_err {_rel(ref, ref32):.3e}")


def _flash_timing(rng, dev, check, B, Hq, Hkv, S, dh, window) -> dict:
    """Flash attention in bf16 at one shape: compared with its plain version, then
    timed beside it and SDPA (the window as a boolean mask where there is one)."""
    bf = torch.bfloat16
    q = _randn(rng, (B, Hq, S, dh), bf, dev)
    k, v = _randn(rng, (B, Hkv, S, dh), bf, dev), _randn(rng, (B, Hkv, S, dh), bf, dev)
    kern = lambda: fa_ops.flash_attention_bhsd(q, k, v, window=window)  # noqa: E731
    _on_tensor_cores(dev, kern, fa_kernel, "flash_attention_tc_kernel", dh)
    label = f"q ({B},{Hq},{S},{dh}) kv heads {Hkv} bf16 causal" + (f" window {window}" if window else "")
    ref = attention_ref(q, k, v, window=window)
    check("flash_attention", label, kern(), ref, bf)
    if _padded(dh) != dh:
        check("flash_attention", label, fa_ops.flash_attention_bhsd(
            q, k, v, window=window, scale=_padded(dh) ** -0.5), ref, bf, wrong=True)
        _log_floor("flash_attention", label, ref,
                   attention_ref(q.float(), k.float(), v.float(), window=window))
    del ref
    plain = time_ms(lambda: attention_ref(q, k, v, window=window), iters=3)
    if window is None:
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    else:
        i = torch.arange(S, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)  # noqa: E731
    return timing(label, time_ms(kern, iters=50, graph=True),
                  plain, time_ms(sdpa, iters=10, graph=True),
                  (2 * B * Hq + 2 * B * Hkv) * S * dh * 2, 4 * dh * live_pairs(S, window) * B * Hq, bf)


def _decode_timing(rng, dev, check, B, Hkv, G, T, dh, nv) -> dict:
    """Decode attention in bf16 at one shape, cache in the model's (B, T, Hkv, dh)
    layout: compared with its plain version, then timed beside it and SDPA over
    ROTATION cache pairs (COLD_L2_NOTE). Also logs, not reported, both on one
    pair (warm L2) and what does not scale with the cache: a one-tile call,
    cold, and a trivial kernel as one node of a graph (the launch alone)."""
    bf = torch.bfloat16
    qd = _randn(rng, (B, Hkv, G, dh), bf, dev)
    pairs = [tuple(_randn(rng, (B, T, Hkv, dh), bf, dev).transpose(1, 2) for _ in range(2))
             for _ in range(ROTATION)]
    kt, vt = pairs[0]
    q_sdpa = qd.reshape(B, Hkv * G, 1, dh)
    kern = lambda k_, v_, n=nv: dec_ops.decode_attention(qd, k_, v_, n)  # noqa: E731
    sdpa = lambda k_, v_: F.scaled_dot_product_attention(  # noqa: E731
        q_sdpa, k_[:, :, :nv], v_[:, :, :nv], enable_gqa=True)
    _on_tensor_cores(dev, lambda: kern(kt, vt), dec_kernel, "decode_tc_kernel", dh)
    rot_mb = ROTATION * 2 * kt.numel() * kt.element_size() / 1e6
    label = (f"q ({B},{Hkv},{G},{dh}) cache ({B},{T},{Hkv},{dh}) n_valid {nv} bf16, cold L2 "
             f"({ROTATION} K/V pairs rotated, {rot_mb:.1f} MB)")
    ref = decode_attention_ref(qd, kt, vt, nv)
    check("decode_attention", label, kern(kt, vt), ref, bf)
    if _padded(dh) != dh:
        check("decode_attention", label, dec_ops.decode_attention(
            qd, kt, vt, nv, scale=_padded(dh) ** -0.5), ref, bf, wrong=True)
        _log_floor("decode_attention", label, ref,
                   decode_attention_ref(qd.float(), kt.float(), vt.float(), nv))

    def cold(fn):  # fn(k, v) over the pairs in turn
        turn = itertools.cycle(pairs)
        return lambda: fn(*next(turn))

    plain = time_ms(lambda: decode_attention_ref(qd, kt, vt, nv))
    iters = 6 * ROTATION
    timed = timing(label, time_ms(cold(kern), iters=iters, graph=True), plain,
                   time_ms(cold(sdpa), iters=iters, graph=True),
                   2 * B * Hkv * G * dh * 2 + 2 * B * Hkv * nv * dh * 2, 4 * B * Hkv * G * nv * dh, bf)
    warm_k, warm_s = (time_ms(lambda: f(kt, vt), iters=iters, graph=True) for f in (kern, sdpa))
    one_tile = time_ms(cold(lambda k_, v_: kern(k_, v_, min(64, T))), iters=iters, graph=True)
    z = torch.zeros(16, device=dev)
    node = time_ms(lambda: z.add_(1), iters=iters, graph=True)
    log(f"[kernels] decode_attention at {label}: {iters} graph-captured calls over {ROTATION} K/V "
        f"cache pairs (a pair read again after {ROTATION - 1} x "
        f"{2 * B * Hkv * nv * dh * 2 / 1e6:.1f} MB of other reads); on one pair (warm L2, "
        f"not reported): kernel {warm_k:.4f} ms, SDPA {warm_s:.4f} ms; floor: n_valid 64 (one "
        f"tile per (batch, kv head)) {one_tile:.4f} ms cold, a trivial kernel as a graph node "
        f"{node:.4f} ms")
    return timed


def phase_kernels(dev, *, rows=4096, d=5120, heads=40, B=4, Hq=40, Hkv=8, dh=128, S=1024,
                  fa_lens=(1000, 1024, 1100), T=2048, nvs=(1, 1000, 1100, 2048), nv=1100,
                  danube_fa=(4, 32, 8, 4608, 80, 4096), danube_dec=(4, 8, 4, 4096, 80, 4096),
                  deepseek_dec=(4, 16, 1, 2048, 128, 1100), dh64_fa=(4, 32, 32, 1024, 64, None),
                  dh64_dec=(4, 32, 1, 2048, 64, 1100), sweeps=True) -> dict:
    """Compare each kernel with its plain version and time it; returns per-kernel records.

    Compared at the serving shapes (prefill rows, qk-norm rows, prompt lengths
    `fa_lens`, cache fills `nvs`) and, with `sweeps`, at the JAX package's
    kernel-test sweeps; timed at rows x d (and rmsnorm also at the qk-norm's
    rows x heads by dh), S and nv; decode attention and its library call over
    a rotation of ROTATION caches (see COLD_L2_NOTE). The attention kernels
    are also compared and timed at h2o-danube's serving shapes (`extra`):
    prefill `danube_fa` = (B, Hq, Hkv, S, dh, window), past its window, and
    decode `danube_dec` = (B, Hkv, G, T, dh, n_valid) on a full ring; decode
    also at deepseek-moe-16b's serving shape `deepseek_dec` (16 kv heads, G 1,
    so one row of the 64-row `wgmma` tile is live); both at zamba2-1.2b's and
    musicgen-large's dh 64, MHA with 32 kv heads (`dh64_fa`, `dh64_dec`).
    """
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    rec: dict = {k: {"max_abs_err": 0.0} for k in KERNELS}

    def note(name, label, err, tol):
        log(f"[kernels] {name} {label}: max_abs_err {err:.3e} (tol {tol:g})")
        if not err < tol:
            raise AssertionError(f"{name} {label}: {err} >= {tol}")
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    def check(name, label, out, ref, dt, wrong=False):
        """Attention against its plain version: the absolute bar and, in bf16, REL_TOL
        (ATTN_BAR_NOTE). With `wrong`, `out` comes from a wrong kernel call, which
        the check must reject."""
        err, rel = _err(out, ref), _rel(out, ref)
        passes = err < TOL[dt] and (dt != bf or rel < REL_TOL)
        if wrong:
            log(f"[kernels] {name} {label}, scale of the padded width {_padded(ref.shape[-1])}: "
                f"max_abs_err {err:.3e}, rel_err {rel:.3e} (rel tol {REL_TOL:g}): "
                f"{'accepted' if passes else 'rejected'}")
            if passes:
                raise AssertionError(f"{name} {label}: the check accepts the padded width's scale")
            return
        note(name, f"{label} rel_err {rel:.3e}" + (f" (rel tol {REL_TOL:g})" if dt == bf else ""),
             err, TOL[dt])
        if not passes:
            raise AssertionError(f"{name} {label}: rel_err {rel} >= {REL_TOL}")

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
                                                (2, 4, 2, 384, 64, 128), (1, 2, 1, 300, 32, None),
                                                (1, 32, 8, 300, 80, None), (2, 4, 2, 384, 80, 128))
                     for dt in (torch.float32, bf)]
    for b, hq, hk, s, e, w, dt in fa_cases:
        q = _randn(rng, (b, hq, s, e), dt, dev)
        k, v = _randn(rng, (b, hk, s, e), dt, dev), _randn(rng, (b, hk, s, e), dt, dev)
        check("flash_attention", f"B{b} Hq{hq} Hkv{hk} S{s} dh{e} win{w} {str(dt)[6:]}",
              fa_ops.flash_attention_bhsd(q, k, v, window=w), attention_ref(q, k, v, window=w), dt)
    rec["flash_attention"].update(_flash_timing(rng, dev, check, B, Hq, Hkv, S, dh, None))
    rec["flash_attention"]["extra"] = [_flash_timing(rng, dev, check, *danube_fa),
                                       _flash_timing(rng, dev, check, *dh64_fa)]

    # --- decode attention, cache in the model's (B, T, Hkv, dh) layout
    G = Hq // Hkv
    dec_cases = [(B, Hkv, G, T, dh, n, bf) for n in nvs]
    if sweeps:
        dec_cases += [(b, hk, g, t, e, n, dt)
                      for b, hk, g, t, e, n in ((2, 4, 2, 512, 64, 300), (1, 2, 6, 1024, 128, 1024),
                                                (2, 8, 1, 512, 64, 1), (1, 2, 4, 600, 32, 77),
                                                (1, 2, 5, 600, 64, 65), (2, 1, 16, 2048, 128, 1100),
                                                (4, 8, 4, 600, 80, 1), (4, 8, 4, 600, 80, 600))
                      for dt in (torch.float32, bf)]
    for b, hk, g, t, e, n, dt in dec_cases:
        qd = _randn(rng, (b, hk, g, e), dt, dev)
        kc, vc = _randn(rng, (b, t, hk, e), dt, dev), _randn(rng, (b, t, hk, e), dt, dev)
        kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
        check("decode_attention", f"B{b} Hkv{hk} G{g} T{t} dh{e} nv{n} {str(dt)[6:]}",
              dec_ops.decode_attention(qd, kt, vt, n), decode_attention_ref(qd, kt, vt, n), dt)
    rec["decode_attention"].update(_decode_timing(rng, dev, check, B, Hkv, G, T, dh, nv))
    rec["decode_attention"]["extra"] = [_decode_timing(rng, dev, check, *danube_dec),
                                        _decode_timing(rng, dev, check, *deepseek_dec),
                                        _decode_timing(rng, dev, check, *dh64_dec)]
    for name, r in rec.items():
        for t in [r, *r.get("extra", [])]:
            lib_ms = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
            log(f"[kernels] {name} at {t['shape']}: kernel {t['ms']:.4f} ms ({t['rate']}, "
                f"{100 * t['share_of_bound']:.1f}% of bound), plain {t['plain_ms']:.4f} ms, "
                f"library {lib_ms} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return rec


# -------------------------------------------------------------------- phase 4
def _prefill_decode(model, p, toks, prompt, steps):
    """Prefill `prompt` tokens, then decode the next `steps` teacher-forced: the
    logits (steps + 1, B, V) and the MoE layers' routing record of the run."""
    with moe.routing_record() as rec:
        logits, cache = model.prefill(p, {"tokens": toks[:, :prompt]}, prompt + steps)
        outs = [logits]
        for t in range(prompt, prompt + steps):
            logits, cache = model.decode_step(p, cache, toks[:, t:t + 1])
            outs.append(logits)
    return torch.stack(outs), rec


def _forward(model, p, toks, prompt):
    """`forward` over all of `toks`: the logits at the positions of `_prefill_decode`'s
    (steps + 1, B, V), the aux metrics and the routing record."""
    with moe.routing_record() as rec:
        hidden, aux = model.forward(p, {"tokens": toks})
        logits = model._head(p, hidden[:, prompt - 1:]).transpose(0, 1)
    return logits, aux, rec


def stack_routing(rec: list, n_moe: int, batch: int):
    """A routing record of consecutive model calls, each making one call a MoE
    layer in layer order, as (expert sets (n_moe, B, S, K), sorted within a token,
    and gaps (n_moe, B, S)) over the calls' S positions, on the host."""
    ids, gaps = [], []
    for layer in range(n_moe):
        calls = rec[layer::n_moe]
        ids.append(torch.cat([t.reshape(batch, -1, t.shape[-1]) for t, _ in calls], 1).sort(-1).values)
        gaps.append(torch.cat([g.reshape(batch, -1) for _, g in calls], 1))
    return torch.stack(ids).cpu(), torch.stack(gaps).float().cpu()


def routing_split(routes: dict, labels, first: int):
    """Where the runs `labels` route alike (ROUTING_NOTE).

    Returns the tokens (n_moe, B, S) whose expert set differs between any two of
    the runs, and the logits positions (P, B), from position `first` on, that no
    such token can reach: a token's own routing in the last MoE layer, and in an
    earlier MoE layer that of the token or any before it in its row (attention
    after that layer carries it on)."""
    ids = [routes[label][0] for label in labels]
    diff = torch.zeros(ids[0].shape[:-1], dtype=torch.bool)
    for a, b in itertools.combinations(ids, 2):
        diff |= (a != b).any(-1)
    reach = diff[-1] | diff[:-1].any(0).int().cummax(-1).values.bool()
    return diff, ~reach[:, first:].T


def _err_at(a, b, where) -> float:
    """Max abs difference of two (P, B, V) logits over the positions `where` (P, B)."""
    return (a.float() - b.float()).abs().amax(-1)[where].max().item() if where.any() else 0.0


def phase_parity(dev, cfg, *, batch=2, prompt=None, steps=8, seed=0) -> dict:
    """Kernel path against the plain path on the card, both in the config's dtype.

    Tolerance: twice the bf16 floor, the distance between the plain path in
    bf16 and the plain path in float32 (same weights, same tokens, this run).
    The two bf16 paths compute the same function and round at different
    places (the fused residual norm reads the unrounded sum; the kernels sum
    in another order), so each lies about one floor from the float32 result
    and, by the triangle inequality, at most two floors from the other.

    The prompt is 300 tokens, or 104 past the sliding window where there is
    one, so that the windowed prefill writes a ring and each decode step reads
    a full one (n_valid = W); 300 is past one Mamba2 chunk (256) and an RWKV6
    chunk (32) and a multiple of neither, so the sequence paths pad. The plain
    float32 path's `forward` over the same tokens, which keeps no cache, must
    then give its prefill and decode logits within FORWARD_TOL: the serving
    invariant, ring order and the recurrent states left by a padded chunk
    included. `forward` through the kernels (flash attention without a cache)
    is held to that float32 forward at the tolerance above. For a config
    without MoE layers, the `loss` (next-token CE over the same tokens, whole
    `loss_chunk`s of them) through the kernels is held to the plain path's
    within twice that tolerance: a token's CE moves by at most twice the
    largest change of its logits.

    An MoE config runs at dropless capacity and routing-aware (ROUTING_NOTE):
    the kernel path also in float32, where its routing must equal the plain
    float32 path's and its logits lie within FP32_LOGIT_TOL; the bf16 logits
    are compared at the positions no differing routing reaches, and a token
    routed differently must have a float32 gap under MOE_GAP_MARGIN. The
    drop fraction of a bf16 `forward` at the published capacity is logged.
    """
    if prompt is None:
        prompt = 300 if cfg.sliding_window is None else cfg.sliding_window + 104
    published = cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    params = Model(cfg).init(seed, dev)
    params32 = cast_tree(params, torch.float32)
    # the plain paths attend densely, the O(S^2) oracle: their flash twin would need
    # S to be a multiple of attn_chunk (as JAX's does), and danube's 4208 is not
    dense = dataclasses.replace(cfg, attn_impl="dense")
    cfg32 = dataclasses.replace(dense, dtype="float32", param_dtype="float32")
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt + steps))).to(dev)
    variants = [("kernels", Model(cfg), params), ("plain", Model(dense, kernels=False), params),
                ("plain_fp32", Model(cfg32, kernels=False), params32)]
    if cfg.moe is not None:
        variants.append(("kernels_fp32", Model(cfg32), params32))
    n_moe = Model(cfg).n_scan if cfg.moe is not None else 0
    runs, routes = {}, {}
    for label, model, p in variants:
        runs[label], rec = _prefill_decode(model, p, toks, prompt, steps)
        if n_moe:
            routes[label] = stack_routing(rec, n_moe, batch)
    if not torch.isfinite(runs["kernels"]).all():
        raise AssertionError("kernel path gave non-finite logits")
    alike = torch.ones(runs["kernels"].shape[:2], dtype=torch.bool)
    out = {}
    if n_moe:
        out.update(_routing_checks(cfg, runs, routes, prompt))
        alike = out.pop("alike").to(dev)
    err = _err_at(runs["kernels"], runs["plain"], alike)
    floor = _err_at(runs["plain"], runs["plain_fp32"], alike)
    tol = 2 * floor
    agree = (runs["kernels"].argmax(-1) == runs["plain"].argmax(-1)).float().mean().item()
    ring = "" if cfg.sliding_window is None else f" (window {cfg.sliding_window}: decode on a full ring)"
    where = "" if not n_moe else f" at the {int(alike.sum())} of {alike.numel()} positions routed alike"
    log(f"[parity] {cfg.name} d{cfg.d_model} L{cfg.num_layers} {cfg.dtype}: prefill {prompt}{ring} + "
        f"{steps} decode steps{where}, max_abs_err kernels vs plain {err:.4e}, tolerance {tol:.4e} "
        f"(2 x bf16 floor {floor:.4e}), kernels vs fp32 "
        f"{_err_at(runs['kernels'], runs['plain_fp32'], alike):.4e}, "
        f"max |logit| {runs['plain'].abs().max().item():.3f}, greedy agreement {agree:.4f}")
    if not err <= tol:
        raise AssertionError(f"parity: {err} > {tol}")
    fwd, fwd_routes = {}, {}
    for label, model, p in (("kernels", Model(cfg), params),
                            ("plain_fp32", Model(cfg32, kernels=False), params32)):
        fwd[label], _, rec = _forward(model, p, toks, prompt)
        if n_moe:
            fwd_routes[label] = stack_routing(rec, n_moe, batch)
    fwd_alike = kfwd_alike = torch.ones_like(alike)
    if n_moe:  # the float32 forward against the float32 prefill + decode, and the kernels against it
        fwd_alike = _routed_alike("forward fp32 vs its prefill + decode",
                                  {"fwd": fwd_routes["plain_fp32"], "plain_fp32": routes["plain_fp32"]},
                                  ("fwd", "plain_fp32"), "plain_fp32", prompt)[1].to(dev)
        kfwd_alike = _routed_alike("forward kernels vs forward fp32", fwd_routes,
                                   ("kernels", "plain_fp32"), "plain_fp32", prompt)[1].to(dev)
    fwd_err = _err_at(fwd["plain_fp32"], runs["plain_fp32"], fwd_alike)
    kfwd_err = _err_at(fwd["kernels"], fwd["plain_fp32"], kfwd_alike)
    log(f"[parity] {cfg.name} forward over {prompt + steps} tokens: float32 plain vs its prefill + "
        f"decode steps max_abs_err {fwd_err:.4e} (tol {FORWARD_TOL:g}); through the kernels vs "
        f"float32 plain {kfwd_err:.4e} (tolerance {tol:.4e})")
    if not fwd_err < FORWARD_TOL:
        raise AssertionError(f"parity: forward {fwd_err} >= {FORWARD_TOL}")
    if not kfwd_err <= tol:
        raise AssertionError(f"parity: forward through the kernels {kfwd_err} > {tol}")
    if not n_moe:
        out["loss"] = _loss_check(cfg, variants, toks, 2 * tol)
    if n_moe:
        _, aux, _ = _forward(Model(published), params, toks, prompt)
        out["drop_frac_published"] = float(aux["moe_drop_frac"])
        log(f"[parity] {cfg.name} bf16 forward over the same tokens at the published capacity "
            f"factor {published.moe.capacity_factor:g}: moe_drop_frac {out['drop_frac_published']:.4f} "
            "(read, not checked)")
    return {**out, "max_abs_err": err, "tolerance": tol, "greedy_agreement": agree,
            "forward_err": fwd_err}


def _loss_check(cfg, variants, toks, tol: float) -> dict:
    """`loss` of each variant over the first whole `loss_chunk`s of `toks` (or all of
    them when shorter than a chunk), the next token as each label; kernels against
    plain within `tol`."""
    S = toks.shape[1]
    n = S if S <= cfg.loss_chunk else S - S % cfg.loss_chunk
    labels = torch.cat([toks[:, 1:n], torch.full_like(toks[:, :1], -1)], 1)
    batch = {"tokens": toks[:, :n], "labels": labels}
    losses = {label: float(model.loss(p, batch)[0]) for label, model, p in variants}
    err = abs(losses["kernels"] - losses["plain"])
    log(f"[parity] {cfg.name} loss over {n} tokens: kernels {losses['kernels']:.6f}, plain "
        f"{losses['plain']:.6f}, plain float32 {losses['plain_fp32']:.6f}; kernels vs plain "
        f"{err:.4e} (tolerance {tol:.4e})")
    if not (np.isfinite(losses["kernels"]) and err <= tol):
        raise AssertionError(f"parity: loss through the kernels {err} > {tol}")
    return {**losses, "err": err}


def _routed_alike(what: str, routes: dict, labels, ref: str, prompt: int):
    """`routing_split` of the runs `labels`, checked: every token routed differently
    must have a gap under MOE_GAP_MARGIN in the run `ref`."""
    diff, alike = routing_split(routes, labels, prompt - 1)
    gaps = routes[ref][1][diff]
    log(f"[parity] routing, {what}: {int(diff.sum())} of {diff.numel()} token routings differ, "
        f"{int((~alike).sum())} of {alike.numel()} logits positions reached; their gaps in {ref} "
        f"{[f'{g:.2e}' for g in gaps.tolist()]} (margin {MOE_GAP_MARGIN:g})")
    if gaps.numel() and not gaps.max().item() < MOE_GAP_MARGIN:
        raise AssertionError(f"routing: {what}: a token routed differently at gap "
                             f"{gaps.max().item()} >= {MOE_GAP_MARGIN}")
    if not alike.any():
        raise AssertionError(f"routing: {what}: no position is routed alike")
    return diff, alike


def _routing_checks(cfg, runs, routes, prompt) -> dict:
    """ROUTING_NOTE's checks of the prefill + decode runs: float32 routing identical
    and logits within FP32_LOGIT_TOL; the bf16 runs' routing split."""
    f32_diff, _ = routing_split(routes, ("kernels_fp32", "plain_fp32"), prompt - 1)
    f32_err = _err(runs["kernels_fp32"], runs["plain_fp32"])
    f32_tol = FP32_LOGIT_TOL * max(1.0, runs["plain_fp32"].abs().max().item())
    log(f"[parity] {cfg.name} float32: kernels vs plain routing differs at {int(f32_diff.sum())} of "
        f"{f32_diff.numel()} token routings; logits max_abs_err {f32_err:.4e} (tol {f32_tol:.4e} = "
        f"{FP32_LOGIT_TOL:g} x max(1, max |logit|))")
    if f32_diff.any():
        raise AssertionError("parity: float32 kernel path routed differently from the plain path")
    if not f32_err <= f32_tol:
        raise AssertionError(f"parity: float32 logits {f32_err} > {f32_tol}")
    diff, alike = _routed_alike("bf16 kernels, bf16 plain, float32 plain", routes,
                                ("kernels", "plain", "plain_fp32"), "plain_fp32", prompt)
    shift = {}
    for label in ("kernels", "plain"):  # the gaps' bf16 perturbation where the routing agrees
        shift[label] = (routes[label][1] - routes["plain_fp32"][1]).abs()[~diff].max().item()
    log(f"[parity] {cfg.name} router gap perturbation at the tokens routed alike, against float32: "
        f"kernels {shift['kernels']:.3e}, plain {shift['plain']:.3e} (margin {MOE_GAP_MARGIN:g})")
    if not max(shift.values()) < MOE_GAP_MARGIN:
        raise AssertionError(f"routing: the bf16 gap perturbation {shift} reaches the margin")
    return {"alike": alike, "routing_diff": int(diff.sum()), "gap_shift": shift,
            "fp32_err": f32_err, "fp32_tol": f32_tol}


def cast_tree(params: dict, dtype) -> dict:
    """A copy of a parameter tree with every floating leaf in `dtype`."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in params.items()}


# -------------------------------------------------------------------- phase 5
def used_kernels(cfg) -> list[str]:
    """The kernels of a config's serve path: LayerNorm configs have no norm kernel, and
    RWKV6 (LayerNorm, no attention) none at all."""
    if cfg.family == "ssm":
        return []
    return ["rmsnorm", "rmsnorm_residual"] * (cfg.norm == "rmsnorm") + ["flash_attention",
                                                                        "decode_attention"]


def attention_blocks(cfg) -> int:
    """Attention blocks a token passes: one a layer; a hybrid's shared block at each
    of its applications (one a segment, one before the tail); none in RWKV6."""
    model = Model(cfg)
    if model.is_hybrid:
        return model.n_seg + bool(model.n_tail)
    return 0 if model.is_rwkv else cfg.num_layers


def phase_serve(dev, cfg, *, requests=8, slots=4, prompt_len=(900, 1100), max_new=32,
                max_len=2048, seed=0) -> dict:
    """Serve `requests` seeded prompts through `launch.serve.run` at the config's
    full width and depth; every kernel of its path must launch, and no other,
    flash attention once an attention block an admission and decode attention
    once an attention block a decode step (`attention_blocks`)."""
    build.reset_launches()
    out = serve_run(cfg, device=dev, requests=requests, slots=slots, prompt_len=prompt_len,
                    max_new=max_new, max_len=max_len, seed=seed)
    launches = dict(build.LAUNCHES)
    done = out["requests"]
    if not all(r.done and len(r.out_tokens) == max_new for r in done):
        raise AssertionError("serve: not every request finished with its tokens")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError("serve: token out of the vocabulary")
    used = used_kernels(cfg)
    missing = [k for k in used if launches[k] == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched on the main path: {missing}")
    stray = [k for k, n in launches.items() if n and k not in used]
    if stray:
        raise AssertionError(f"serve: {cfg.name} launched kernels off its path: {stray}")
    if not used:
        log(f"[serve] {cfg.name}: no kernel on its path (the {cfg.family} family runs plain "
            f"PyTorch, as in JAX): the empty set, every count 0: {launches}")
    steps, admissions = out["decode_steps"], out["admissions"]
    blocks = attention_blocks(cfg)
    if (launches["decode_attention"], launches["flash_attention"]) != (blocks * steps,
                                                                       blocks * admissions):
        raise AssertionError(f"serve: {launches['flash_attention']} flash and "
                             f"{launches['decode_attention']} decode-attention launches in "
                             f"{admissions} admissions and {steps} decode steps of {blocks} "
                             "attention blocks")
    mem = out["max_memory_allocated"]
    shortest = min(len(r.prompt) for r in done)
    # every prompt past the window: each admission prefills past it, and each
    # decode step (position >= the shortest prompt) reads a full ring, n_valid = W
    full_ring = cfg.sliding_window is not None and shortest > cfg.sliding_window
    if full_ring:
        log(f"[serve] {cfg.name}: shortest prompt {shortest} > window {cfg.sliding_window}: every "
            f"admission prefills past the window, every decode step reads a full ring "
            f"(n_valid {cfg.sliding_window})")
    log(f"[serve] {cfg.name} L{cfg.num_layers} d{cfg.d_model} {cfg.dtype}: {len(done)} requests, "
        f"{out['prompt_tokens']} prompt tokens, {out['tokens']} new tokens in {out['seconds']:.3f}s "
        f"({out['tokens'] / out['seconds']:.2f} tok/s); prefill {out['prefill_seconds']:.3f}s "
        f"({out['prefill_seconds'] / max(admissions, 1):.3f}s per admission, {admissions} admissions), "
        f"decode {steps} steps {1e3 * out['decode_seconds'] / max(steps, 1):.3f} ms/step; "
        f"max_memory_allocated {mem / 2**30 if mem else 0:.2f} GiB; launches {launches}")
    return {**{k: v for k, v in out.items() if k != "requests"}, "launches": launches,
            "admissions": admissions, "full_ring": full_ring}


# -------------------------------------------------------------------- phase 6
# the aten ops of an MoE layer whose device time phase 6 names: the expert
# products, the routing's top-k, sort and cumulative counts, and the dispatch's
# gathers and scatters
MOE_OPS = ("aten::bmm", "aten::topk", "aten::argsort", "aten::cumsum", "aten::scatter_add_",
           "aten::index", "aten::index_put_", "aten::softmax")


def phase_trace(dev, cfg, *, slots=4, prompt=1024, steps=4, seed=0) -> dict:
    """Where a decode step's time goes, at the serve phase's shape.

    Times `steps` decode steps with the host clock (ending in a sync), then
    traces the same number of steps with `torch.profiler` and sums the device
    time of every kernel: the device's idle share of a step is one minus
    their ratio. Prints the kernels that take the most device time and, for
    an MoE config, the device time of the MoE layer's ops (MOE_OPS).
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
    log(f"[trace] {cfg.name} decode step at {slots} slots, pos ~{prompt}: wall {wall_ms:.3f} ms "
        f"(host clock, untraced), device busy {device_ms:.3f} ms, "
        f"idle share {1 - device_ms / wall_ms:.3f}")
    for e in top:
        log(f"[trace]   {e.self_device_time_total / 1e3 / steps:9.3f} ms/step  "
            f"{e.count // steps:5d} calls/step  {e.key[:90]}")
    out = {"wall_ms": wall_ms, "device_ms": device_ms}
    if cfg.moe is not None:
        out["moe_ms"] = _moe_items(dev, cfg, model, params, prof, slots, steps)
    if cfg.ssm is not None:
        out["ssm_ms"] = _recurrent_items(dev, cfg, model, params, slots)
    return out


def _recurrent_items(dev, cfg, model, params, slots) -> dict:
    """Phase 6's Mamba2 or RWKV6 items: every such layer of the model, one decode step
    at the serve shape from a zeroed state, alone: traced, with the device time of
    each aten op that launched kernels (its own kernels, not its children's), and
    timed as one CUDA graph beside the bytes it must move (weights read once, the
    states read and written)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    hybrid = cfg.family == "hybrid"
    apply, init = ((_apply_mamba_layer, lambda: mamba2.init_mamba2_state(cfg, slots, dev))
                   if hybrid else
                   (_apply_rwkv_layer, lambda: rwkv6.init_rwkv6_state(cfg, slots, dev)))
    layers = [layer_params(params, i) for i in range(cfg.num_layers)]
    states = [init() for _ in layers]
    x = (0.5 * torch.randn(slots, 1, cfg.d_model, device=dev)).to(cfg.compute_dtype)
    step = lambda: [apply(cfg, p, x, "decode", st, kernels=model.kernels) for p, st in  # noqa: E731
                    zip(layers, states)]
    step()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        sync()
    items = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
             if e.device_type == DeviceType.CPU and e.self_device_time_total > 0}
    name = "Mamba2" if hybrid else "RWKV6"
    for k, ms in sorted(items.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[trace]   {name} layers: {k}: {ms:.3f} ms/step device time")
    nbytes = sum(t.numel() * t.element_size() for p in layers for t in _tensors(p))
    nbytes += 2 * sum(t.numel() * t.element_size() for st in states for t in _tensors(st))
    ms = time_ms(step, iters=2, graph=True)
    items[f"{name.lower()}_layers_alone"] = ms
    log(f"[trace]   {name}: the {len(layers)} {name} layers, one decode step at {slots} slots, timed "
        f"alone as one CUDA graph: {ms:.3f} ms; they move {nbytes / 1e9:.3f} GB (weights once, "
        f"states read and written), {nbytes / ms / 1e6:.1f} GB/s, bound {nbytes / HBM * 1e3:.3f} ms")
    return items


def _moe_items(dev, cfg, model, params, prof, slots, steps) -> dict:
    """Phase 6's MoE items: the device time of the MoE layers' ops in the trace, by
    the aten op that launched them (MOE_OPS), and the MoE layers alone at
    decode's shape, timed as one CUDA graph, beside the bytes of the weights
    they read: every expert's, whichever experts the tokens pick."""
    from torch.autograd import DeviceType

    items = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key in MOE_OPS and e.device_time_total > 0:
            items[e.key] = e.device_time_total / 1e3 / steps
            log(f"[trace]   MoE {e.key}: {items[e.key]:.3f} ms/step device time, "
                f"{e.count // steps} calls/step")
    layers = [layer_params(params, i)["moe"] for i in range(model.n_scan)]
    nbytes = sum(t.numel() * t.element_size() for p in layers for t in _tensors(p))
    x = torch.randn(slots, 1, cfg.d_model, device=dev).to(cfg.compute_dtype)
    ms = time_ms(lambda: [moe.apply_moe(cfg, p, x, aux=False) for p in layers], iters=2, graph=True)
    items["moe_layers_alone"] = ms
    log(f"[trace]   MoE: the {len(layers)} MoE layers at decode's shape ({slots} tokens, capacity "
        f"{moe.capacity(cfg.moe, slots)} of {cfg.moe.num_experts} experts) timed alone as one CUDA "
        f"graph: {ms:.3f} ms a step; they read {nbytes / 1e9:.3f} GB of weights (every expert), "
        f"{nbytes / ms / 1e6:.1f} GB/s, bound {nbytes / HBM * 1e3:.3f} ms")
    return items


def _tensors(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


# -------------------------------------------------------------------- phase 7
def _bwd_check(name, label, outs, refs, dt, rec) -> None:
    """Backward outputs against their plain versions (BWD_BAR_NOTE)."""
    for part, out, ref in zip(("dq", "dk", "dv") if len(outs) == 3 else ("dx", "dscale"), outs, refs):
        err, rel = _err(out, ref), _rel(out, ref)
        top = ref.float().abs().max().item()
        tol = BWD_F32_TOL * top if dt == torch.float32 else None
        ok = err <= tol if tol is not None else rel <= REL_TOL
        bar = f"tol {tol:.3e} (1e-4 x max |ref| {top:.3f})" if tol is not None else f"rel tol {REL_TOL:g}"
        log(f"[bwd] {name} {label} {part}: max_abs_err {err:.3e}, rel_err {rel:.3e} ({bar})")
        if not ok:
            raise AssertionError(f"{name} {label} {part}: max_abs_err {err}, rel_err {rel}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)


def _same_bits(name, label, fn, first) -> None:
    """A second run of a backward kernel must give the first run's bits: neither
    kernel uses atomics, so remat policies and resumed runs are bit for bit."""
    again = fn()
    if not all(torch.equal(a, b) for a, b in zip(again, first)):
        raise AssertionError(f"{name} {label}: two runs differ")


def _backward_ms(fwd, inputs, grad, iters: int) -> float:
    """Device milliseconds of PyTorch's backward of `fwd()` with respect to
    `inputs` (the library yardstick): a CUDA graph of forward + backward
    (`torch.autograd.grad`) less a CUDA graph of the same forward alone, both
    timed as the kernels are."""
    both = time_ms(lambda: torch.autograd.grad(fwd(), inputs, grad), iters=iters, warmup=1, graph=True)
    return both - time_ms(fwd, iters=iters, warmup=1, graph=True)


def _flash_bwd_case(rng, dev, B, Hq, Hkv, S, dh, window, dt):
    """q, k, v, dout at one shape, the forward kernel's out and LSE, and the plain
    LSE it is held to."""
    q = _randn(rng, (B, Hq, S, dh), dt, dev)
    k, v = _randn(rng, (B, Hkv, S, dh), dt, dev), _randn(rng, (B, Hkv, S, dh), dt, dev)
    dout = _randn(rng, (B, Hq, S, dh), dt, dev)
    chunk = 1024 if S % 1024 == 0 else S  # the plain version's blocks
    out, lse = fa_ops.flash_attention_lse_bhsd(q, k, v, window=window, chunk=chunk)
    _, lse_ref = attention_lse_ref(q, k, v, window=window, chunk=chunk)
    return (q, k, v, out, dout, lse), lse_ref, chunk


def _flash_bwd_timing(rng, dev, rec, B, Hq, Hkv, S, dh, window) -> dict:
    """The flash backward in bf16 at one shape: checked, then timed beside its plain
    version and SDPA's backward (the window as a boolean mask where there is one)."""
    bf = torch.bfloat16
    (q, k, v, out, dout, lse), lse_ref, chunk = _flash_bwd_case(rng, dev, B, Hq, Hkv, S, dh, window, bf)
    label = f"q ({B},{Hq},{S},{dh}) kv heads {Hkv} bf16 causal" + (f" window {window}" if window else "")
    lse_err = _err(lse, lse_ref)
    log(f"[bwd] flash_attention forward LSE at {label}: max_abs_err {lse_err:.3e} (tol "
        f"{BWD_F32_TOL * lse_ref.abs().max().item():.3e} = 1e-4 x max |lse|)")
    if not lse_err <= BWD_F32_TOL * lse_ref.abs().max().item():
        raise AssertionError(f"flash forward LSE {label}: {lse_err}")
    kern = lambda: fa_ops.flash_attention_bwd_bhsd(q, k, v, out, dout, lse, window=window,  # noqa: E731
                                                   chunk=chunk)
    _on_tensor_cores(dev, kern, fa_bwd, ("dkdv_tc_kernel", "dq_tc_kernel"), dh)
    ref = flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window, chunk=chunk)
    got = kern()
    _bwd_check("flash_attention_bwd", label, got, ref, bf, rec)
    _same_bits("flash_attention_bwd", label, kern, got)
    del ref, got
    plain = time_ms(lambda: flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window,
                                                    chunk=chunk), iters=1, warmup=1)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    mask = None
    if window is not None:
        i = torch.arange(S, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,  # noqa: E731
                                                  is_causal=mask is None, enable_gqa=True)
    nbytes = (4 * B * Hq + 4 * B * Hkv) * S * dh * 2 + B * Hq * S * 4
    return timing(label, time_ms(kern, iters=5, warmup=1, graph=True), plain,
                  _backward_ms(sdpa, (qs, ks, vs), dout, iters=3), nbytes,
                  10 * dh * live_pairs(S, window) * B * Hq, bf)


def _norm_bwd_timing(rng, dev, rec, rows, d, fused=False) -> dict:
    """The RMSNorm backward in bf16 at (rows, d), of the plain norm (ln1, final_norm)
    or, `fused`, of the residual-add norm (with the cotangent of its sum r):
    checked, then timed beside its plain version and `F.rms_norm`'s backward (of
    r = x + res and r itself where fused)."""
    bf = torch.bfloat16
    x, dy = _randn(rng, (rows, d), bf, dev), _randn(rng, (rows, d), bf, dev)
    res, dr = (_randn(rng, (rows, d), bf, dev) for _ in range(2)) if fused else (None, None)
    sc = 1 + 0.1 * _randn(rng, (d,), torch.float32, dev)  # see NORM_GAIN_NOTE
    label = f"x, dy ({rows},{d}) bf16" + (", fused: res, dr" if fused else "")
    kern = lambda: rms_ops.rmsnorm_backward(x, res, sc, dy, dr)  # noqa: E731
    got = kern()
    _bwd_check("rmsnorm_bwd", label, got, rmsnorm_bwd_ref(x, res, sc, dy, dr), bf, rec)
    _same_bits("rmsnorm_bwd", label, kern, got)
    plain = time_ms(lambda: rmsnorm_bwd_ref(x, res, sc, dy, dr))
    xs, ws = x.detach().clone().requires_grad_(), sc.to(bf).requires_grad_()
    if fused:
        rs = res.detach().clone().requires_grad_()
        norm = lambda: (lambda r: (F.rms_norm(r, (d,), ws, 1e-5), r))(xs + rs)  # noqa: E731
        inputs, grads = (xs, rs, ws), (dy, dr)
    else:
        norm = lambda: F.rms_norm(xs, (d,), ws, 1e-5)  # noqa: E731
        inputs, grads = (xs, ws), dy
    n_io = 5 if fused else 3  # x (res, dr), dy read; dx written
    return timing(label, time_ms(kern, iters=50, graph=True), plain,
                  _backward_ms(norm, inputs, grads, iters=20), n_io * rows * d * 2 + 2 * d * 4,
                  (9 if fused else 8) * rows * d, bf)


def phase_bwd_kernels(dev, *, danube=(2, 32, 8, 6144, 80, 4096), qwen=(4, 40, 8, 1024, 128, None),
                      dh64=(4, 32, 32, 1024, 64, None), zamba2=(2, 32, 32, 4096, 64, None),
                      deepseek=(2, 16, 16, 4096, 128, None),
                      norms=((12288, 2560), (4096, 5120), (8192, 2048)), fused_timed=((8192, 2048),),
                      qk_rows=163840, sweeps=True) -> dict:
    """The two backward kernels against their plain versions (BWD_BAR_NOTE), and timed.

    Flash backward at h2o-danube's training shape (`danube`: B, Hq, Hkv, S,
    dh, window; past the window), at qwen3-14b's (`qwen`), at dh 64 with G 1
    (`dh64`) and at the training shapes of zamba2-1.2b (`zamba2`) and
    deepseek-moe-16b (`deepseek`); each also checks the forward kernel's LSE
    against the plain LSE. With `sweeps`, float32 and bf16 at ragged S,
    windows and every head dim. RMSNorm backward at the training rows
    `norms`, plain and fused (with the cotangent of r), each timed plain and
    those of `fused_timed` fused too, and at qwen3's qk-norm rows (d 128, eps
    1e-6).
    """
    rng = np.random.default_rng(1)
    rec = {k: {"max_abs_err": 0.0} for k in TRAIN_KERNELS}
    if sweeps:
        for case in ((1, 8, 2, 300, 80, 128), (2, 4, 4, 256, 32, None), (1, 10, 2, 200, 128, None),
                     (2, 4, 1, 384, 64, 100)):
            for dt in (torch.float32, torch.bfloat16):
                (q, k, v, out, dout, lse), _, chunk = _flash_bwd_case(rng, dev, *case, dt)
                kern = lambda: fa_ops.flash_attention_bwd_bhsd(q, k, v, out, dout, lse,  # noqa: E731
                                                               window=case[5], chunk=chunk)
                if fa_bwd.on_tensor_cores(dt, case[4]):
                    _on_tensor_cores(dev, kern, fa_bwd, ("dkdv_tc_kernel", "dq_tc_kernel"), case[4])
                else:
                    _on_fp32_tiles(dev, kern, dt, case[4])
                label = (f"B{case[0]} Hq{case[1]} Hkv{case[2]} S{case[3]} dh{case[4]} win{case[5]} "
                         f"{str(dt)[6:]}")
                grads = kern()
                _bwd_check("flash_attention_bwd", label, grads,
                           flash_attention_bwd_ref(q, k, v, out, dout, lse, window=case[5],
                                                   chunk=chunk), dt, rec["flash_attention_bwd"])
                _same_bits("flash_attention_bwd", label, kern, grads)
    for rows, d, eps, fused, dt in [(r, dd, 1e-5, f, torch.bfloat16) for r, dd in norms
                                    for f in (False, True)] + [(qk_rows, 128, 1e-6, False, torch.bfloat16)] \
            + ([(300, 256, 1e-5, True, torch.float32), (33, 100, 1e-5, False, torch.float32),
                (33, 100, 1e-5, True, torch.bfloat16)] if sweeps else []):  # bf16 d 100: the scalar route
        x, res, dy, dr = (_randn(rng, (rows, d), dt, dev) for _ in range(4))
        sc = 1 + 0.1 * _randn(rng, (d,), torch.float32, dev)
        args = (x, res if fused else None, sc, dy, dr if fused else None)
        label = f"({rows},{d}) {'fused' if fused else 'plain'} eps {eps:g} {str(dt)[6:]}"
        kern = lambda: rms_ops.rmsnorm_backward(*args, eps=eps)  # noqa: E731
        got = kern()
        _bwd_check("rmsnorm_bwd", label, got, rmsnorm_bwd_ref(*args, eps=eps), dt, rec["rmsnorm_bwd"])
        _same_bits("rmsnorm_bwd", label, kern, got)
    rec["flash_attention_bwd"].update(_flash_bwd_timing(rng, dev, rec["flash_attention_bwd"], *danube))
    rec["flash_attention_bwd"]["extra"] = [
        _flash_bwd_timing(rng, dev, rec["flash_attention_bwd"], *shape)
        for shape in (qwen, dh64, zamba2, deepseek)]
    first, *rest = norms
    rec["rmsnorm_bwd"].update(_norm_bwd_timing(rng, dev, rec["rmsnorm_bwd"], *first))
    rec["rmsnorm_bwd"]["extra"] = [_norm_bwd_timing(rng, dev, rec["rmsnorm_bwd"], *n) for n in rest] + [
        _norm_bwd_timing(rng, dev, rec["rmsnorm_bwd"], *n, fused=True) for n in fused_timed]
    for name, r in rec.items():
        for t in [r, *r.get("extra", [])]:
            log(f"[bwd] {name} at {t['shape']}: kernel {t['ms']:.4f} ms ({t['rate']}, "
                f"{100 * t['share_of_bound']:.1f}% of bound), plain {t['plain_ms']:.4f} ms, "
                f"library {t['library_ms']:.4f} ms (kernel / library {t['ms'] / t['library_ms']:.3f}), "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return rec


def _token_ce(model, params, batch) -> torch.Tensor:
    """Each position's CE (B, S), float32, without autograd (TRAIN_NOTE)."""
    with torch.no_grad():
        x, _ = model.forward(params, batch)
        logits = model._head(params, x)
        return torch.logsumexp(logits, -1) - logits.gather(-1, batch["labels"].long()[..., None])[..., 0]


def _train_inputs(cfg, dev, batch: int, seq: int, seed: int):
    """The port's seeded init at `cfg` (the head in the param dtype, as trained) and
    one batch of seeded tokens with the next token as each label."""
    params = Model(cfg).init(seed, dev, widen_head=False)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                                 (batch, seq + 1))).to(dev)
    return params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _leaf_errors(cfg, runs, keys, what: str) -> float:
    """TRAIN_NOTE over the gradient leaves `keys` of `runs` (label -> {path: grad}):
    each leaf of the kernel path within twice its bf16 floor. Returns the worst
    ratio of a leaf's error to its floor."""
    worst = 0.0
    for key in keys:
        g32, gk, gp = runs["plain_fp32"][key], runs["kernels"][key], runs["plain"][key]
        if not torch.isfinite(gk).all():
            raise AssertionError(f"train parity {cfg.name}: non-finite gradient {key}")
        norm = g32.float().norm()
        rel_k = ((gk.float() - gp.float()).norm() / norm).item()
        leaf_floor = ((gp.float() - g32.float()).norm() / norm).item()
        worst = max(worst, rel_k / max(leaf_floor, 1e-30))
        log(f"[train-parity] {cfg.name}{what} grad {key}: rel_err kernels vs plain {rel_k:.3e} "
            f"(tolerance {2 * leaf_floor:.3e}; floor {leaf_floor:.3e}), kernels vs float32 "
            f"{((gk.float() - g32.float()).norm() / norm).item():.3e}")
        if not rel_k <= 2 * leaf_floor:
            raise AssertionError(f"train parity {cfg.name}: grad {key} {rel_k} > {2 * leaf_floor}")
    return worst


def phase_train_parity(dev, cfg, *, batch=1, seq=6144, seed=0):
    """The training path at the config's width and depth (2 layers in `main`; zamba2
    at PARITY_LAYERS'), bf16.

    The loss and every gradient leaf through the kernels against the plain
    path, at twice the bf16 floor (TRAIN_NOTE); then the kernel path under
    each remat policy (`phase_remat_identity`)."""
    model, plain = Model(cfg), Model(cfg, kernels=False)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params, data = _train_inputs(cfg, dev, batch, seq, seed)
    params32 = cast_tree(params, torch.float32)
    runs, losses, ce = {}, {}, {}
    for label, m, p in (("kernels", model, params), ("plain", plain, params),
                        ("plain_fp32", Model(cfg32, kernels=False), params32)):
        grads, met = loss_and_grads(m, p, data, "selective")
        runs[label], losses[label], ce[label] = dict(paths(grads)), float(met["loss"]), _token_ce(m, p, data)
    floor = (ce["plain"] - ce["plain_fp32"]).abs().mean().item()
    loss_err = abs(losses["kernels"] - losses["plain"])
    log(f"[train-parity] {cfg.name} L{cfg.num_layers} d{cfg.d_model} B{batch} S{seq} bf16: loss kernels "
        f"{losses['kernels']:.6f}, plain {losses['plain']:.6f}, plain float32 "
        f"{losses['plain_fp32']:.6f}; kernels vs plain {loss_err:.3e} (tolerance {2 * floor:.3e} = "
        f"2 x the mean per-token bf16 floor {floor:.3e})")
    if not (np.isfinite(losses["kernels"]) and loss_err <= 2 * floor):
        raise AssertionError(f"train parity {cfg.name}: loss {loss_err} > {2 * floor}")
    worst = _leaf_errors(cfg, runs, list(runs["plain_fp32"]), "")
    # the whole gradient's bf16 floor (every leaf together), for the mesh phase's grad norm
    sq = lambda a: sum(float((a(k).float() ** 2).sum()) for k in runs["plain_fp32"])  # noqa: E731
    grad_floor = (sq(lambda k: runs["plain"][k].float() - runs["plain_fp32"][k].float())
                  / sq(lambda k: runs["plain_fp32"][k])) ** 0.5
    del runs
    return {"loss_err": loss_err, "floor": floor, "grad_floor": grad_floor, "worst_leaf_ratio": worst,
            **phase_remat_identity(dev, cfg, params=params, data=data)}


def phase_train_parity_moe(dev, cfg, *, batch=1, seq=2048, seed=0):
    """An MoE config's training path (2 layers in `main`: the dense layer, then an
    MoE layer) at dropless capacity, kernels against the plain path.

    float32: every token routed alike on both paths (`moe.routing_record`),
    the loss and every gradient leaf within TRAIN_F32_TOL. bf16, routing-aware
    (TRAIN_ROUTING_NOTE): every token routed differently by any of the kernel,
    plain and plain float32 paths a near tie; the positions it reaches left out
    of the loss; the CE and the leaves MOE_UNREACHED (every leaf where no token
    differs) at twice the bf16 floor (TRAIN_NOTE). Then the kernel path at the
    published capacity under each remat policy (`phase_remat_identity`)."""
    # dropless: an expert takes a token at most once, so a capacity C >= T drops none
    drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=(cfg.moe.num_experts + 1) / cfg.moe.top_k))
    cfg32 = dataclasses.replace(drop, dtype="float32", param_dtype="float32")
    params, data = _train_inputs(cfg, dev, batch, seq, seed)
    params32 = cast_tree(params, torch.float32)
    variants = {"kernels": (Model(drop), params), "plain": (Model(drop, kernels=False), params),
                "plain_fp32": (Model(cfg32, kernels=False), params32), "kernels_fp32": (Model(cfg32), params32)}
    n_moe = Model(cfg).n_scan
    routes = {}
    for label, (m, p) in variants.items():
        with torch.no_grad(), moe.routing_record() as rec:
            m.forward(p, data)
        routes[label] = stack_routing(rec, n_moe, batch)
    # float32: identical routing, every leaf and the loss within TRAIN_F32_TOL
    f32_diff, _ = routing_split(routes, ("kernels_fp32", "plain_fp32"), 0)
    if f32_diff.any():
        raise AssertionError(f"train parity {cfg.name}: float32 routing differs at "
                             f"{int(f32_diff.sum())} tokens")
    f32 = {label: loss_and_grads(*variants[label], data, "selective") for label in ("kernels_fp32", "plain_fp32")}
    loss_rel = abs(float(f32["kernels_fp32"][1]["loss"]) / float(f32["plain_fp32"][1]["loss"]) - 1)
    worst32 = 0.0
    for (key, gk), (_, gp) in zip(paths(f32["kernels_fp32"][0]), paths(f32["plain_fp32"][0]), strict=True):
        rel = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item()
        worst32 = max(worst32, rel)
        if not (torch.isfinite(gk).all() and rel <= TRAIN_F32_TOL):
            raise AssertionError(f"train parity {cfg.name} float32: grad {key} rel_err {rel}")
    log(f"[train-parity] {cfg.name} L{cfg.num_layers} B{batch} S{seq} float32, dropless: routing "
        f"identical at all {f32_diff.numel()} token routings; loss kernels "
        f"{float(f32['kernels_fp32'][1]['loss']):.6f} vs plain {float(f32['plain_fp32'][1]['loss']):.6f} "
        f"(rel {loss_rel:.3e}); worst gradient leaf rel_err {worst32:.3e} (tol TRAIN_F32_TOL "
        f"{TRAIN_F32_TOL:g}) over {len(paths(f32['plain_fp32'][0]))} leaves")
    if not loss_rel <= TRAIN_F32_TOL:
        raise AssertionError(f"train parity {cfg.name} float32: loss rel {loss_rel}")
    del f32
    # bf16, routing-aware
    diff, _ = _routed_alike("train bf16 kernels, bf16 plain, float32 plain", routes,
                            ("kernels", "plain", "plain_fp32"), "plain_fp32", 1)
    reach = (diff[-1] | diff[:-1].any(0).int().cummax(-1).values.bool()).to(dev)  # (B, S)
    masked = {"tokens": data["tokens"], "labels": data["labels"].masked_fill(reach, -1)}
    runs, ce, tok = {}, {}, {}
    for label in ("kernels", "plain", "plain_fp32"):
        grads, met = loss_and_grads(*variants[label], masked, "selective")
        runs[label], ce[label] = dict(paths(grads)), float(met["ce"])
        tok[label] = _token_ce(*variants[label], data)[~reach]
    floor = (tok["plain"] - tok["plain_fp32"]).abs().mean().item()
    ce_err = abs(ce["kernels"] - ce["plain"])
    keys = [k for k in runs["plain_fp32"] if not diff.any() or k.startswith(MOE_UNREACHED)]
    log(f"[train-parity] {cfg.name} bf16, dropless: {int(reach.sum())} of {reach.numel()} positions "
        f"left out of the loss; CE kernels {ce['kernels']:.6f}, plain {ce['plain']:.6f}, plain float32 "
        f"{ce['plain_fp32']:.6f}; kernels vs plain {ce_err:.3e} (tolerance {2 * floor:.3e}); leaves "
        f"compared ({len(keys)} of {len(runs['plain_fp32'])}): {keys}")
    if not (np.isfinite(ce["kernels"]) and ce_err <= 2 * floor):
        raise AssertionError(f"train parity {cfg.name}: CE {ce_err} > {2 * floor}")
    worst = _leaf_errors(cfg, runs, keys, " bf16")
    del runs
    return {"routing_diff": int(diff.sum()), "fp32_worst_leaf": worst32, "fp32_loss_rel": loss_rel,
            "ce_err": ce_err, "floor": floor, "worst_leaf_ratio": worst, "compared": keys,
            **phase_remat_identity(dev, cfg, params=params, data=data)}


def phase_remat_identity(dev, cfg, *, params=None, data=None, batch=1, seq=4096, seed=0,
                         remats=("none", "selective", "full")) -> dict:
    """The kernel path's loss, metrics and every gradient under each remat policy:
    identical, with each policy's peak memory and the products selective remat
    saves in a forward (`transformer.saved_record`)."""
    model = Model(cfg)
    if params is None:
        params, data = _train_inputs(cfg, dev, batch, seq, seed)
    same, mems, ref, saved = True, {}, None, 0
    for remat in remats:
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with saved_record() as rec:
            grads, met = loss_and_grads(model, params, data, remat)
        sync()
        saved = max(saved, len(rec))
        mems[remat] = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        flat = (*(met[k] for k in sorted(met)), *(g for _, g in paths(grads)))
        if ref is None:
            ref = flat
        else:
            same &= all(torch.equal(a, b) for a, b in zip(flat, ref, strict=True))
        del grads
    log(f"[train-parity] {cfg.name} L{cfg.num_layers} kernel path under remat {', '.join(remats)}: "
        f"loss, metrics and gradients {'identical' if same else 'DIFFER'}; peak GiB "
        + ", ".join(f"{r} {m:.2f}" for r, m in mems.items())
        + f"; selective saves {saved} products a forward")
    if not same:
        raise AssertionError(f"train parity {cfg.name}: remat policies give other gradients")
    return {"peak_gib": mems, "saved_products": saved}


def phase_resume(dev, cfg, *, batch=1, seq=2048, steps=4, at=2, seed=0) -> dict:
    """A Trainer that saves a checkpoint at step `at` and a fresh one that resumes
    from it: its steps at..steps-1 against the uninterrupted run's, on the same
    data. The losses must agree within 1e-6 relative; whether they agree bit for
    bit is logged."""
    import shutil

    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed)
    quiet = dict(log=lambda *_: None)
    straight = Trainer(Model(cfg), ParallelConfig(), TrainConfig(steps=steps), dev)
    _, hist = straight.fit(straight.init_state(seed), data, steps=steps, **quiet)
    del straight
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    tc = TrainConfig(steps=steps, checkpoint_dir=str(CKPT_DIR), checkpoint_every=at)
    first = Trainer(Model(cfg), ParallelConfig(), tc, dev)
    first.fit(first.init_state(seed), data, steps=at, **quiet)
    del first
    second = Trainer(Model(cfg), ParallelConfig(), tc, dev)
    state, start = second.resume()
    _, resumed = second.fit(state, data, steps=steps - at, start_step=start, **quiet)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    a, b = [h["loss"] for h in resumed], [h["loss"] for h in hist[at:]]
    bitwise = a == b
    err = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    log(f"[resume] {cfg.name} L{cfg.num_layers} d{cfg.d_model} B{batch} S{seq}: checkpoint at step "
        f"{at}, resumed from {start}; steps {at}-{steps - 1} losses {a} vs uninterrupted {b}: "
        f"{'bit for bit' if bitwise else f'not bit for bit, max rel {err:.3e}'}")
    if start != at or not err <= 1e-6:
        raise AssertionError(f"resume: {a} vs {b}")
    return {"losses": a, "straight": b, "bitwise": bitwise}


def train_kernels(cfg) -> list[str]:
    """The kernels of a config's training path: those of its serve path but decode,
    and the backward kernel of each forward one."""
    used = used_kernels(cfg)
    need = {"flash_attention_bwd": "flash_attention", "rmsnorm_bwd": "rmsnorm"}
    return [k for k in TRAIN_PATH if need.get(k, k) in used]


# MFU_NOTE: a training step's model flops are 6 x the parameters whose products a
# token runs (`product_params`) x the tokens, plus attention's 14 dh flops a live
# query-key pair (4 dh forward, 10 dh backward) at each attention block; over the
# card's bf16 peak. The recompute of remat is not counted (it is overhead), and
# neither are Mamba2's SSD and RWKV6's WKV chunk scans (their products are
# batched over chunks and heads, and their elementwise work is most of them).
def product_params(cfg) -> int:
    """Parameters whose products a token runs: every leaf but the token table (a
    lookup; a tied head counts as the head), the routed experts at top_k of
    num_experts, a hybrid's shared block once an application."""
    total = 0
    for path, pd in _walk(param_defs(cfg)):
        n = int(np.prod(pd.shape))
        if path == "embed/tok" and not cfg.tie_embeddings:
            continue
        if cfg.moe is not None and re.fullmatch(r"layers/moe/w[igo]", path):
            n = n * cfg.moe.top_k // cfg.moe.num_experts
        if path.startswith("shared/"):
            n *= attention_blocks(cfg)
        total += n
    return total


def phase_train_run(dev, cfg, smi, *, batch=2, seq=6144, steps=6, warmup=2, remat="selective",
                    optimizer="adamw") -> dict:
    """The training path at the config's full width (and the depth given) through
    `launch.train.run`: every kernel of the path (`train_kernels`) must launch,
    and no other (decode attention never); every loss finite. Step time,
    tokens/s and MFU (MFU_NOTE) over the steps after `warmup`, peak memory,
    the MoE metrics where there are any, and the launches a step."""
    build.reset_launches()
    out = train_run(cfg, device=dev, batch=batch, seq=seq, steps=steps, remat=remat,
                    optimizer=optimizer, log=lambda *_: None)
    launches = dict(build.LAUNCHES)
    losses = out["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    path = train_kernels(cfg)
    missing = [k for k in path if launches[k] == 0]
    if missing:
        raise AssertionError(f"train: kernels never launched on the main path: {missing}")
    other = [k for k, n in launches.items() if n and k not in path]
    if other:
        raise AssertionError(f"train: kernels off {cfg.name}'s training path launched: {other}")
    step_s = float(np.mean(out["step_times"][warmup:]))
    tokens = out["tokens_per_step"]
    n_prod = product_params(cfg)
    attn = 14 * cfg.head_dim * live_pairs(seq, cfg.sliding_window) * batch * cfg.num_heads * \
        attention_blocks(cfg)
    flops = 6 * n_prod * tokens + attn
    mfu = flops / step_s / PEAK_BF16
    mem = (out["max_memory_allocated"] or 0) / 2**30
    per_step = out["launches_per_step"][-1]
    moe_metrics = ({k: [round(h[k], 5) for h in out["history"]] for k in AUX_KEYS}
                   if cfg.moe is not None else {})
    log(f"[train] {cfg.name} L{cfg.num_layers} d{cfg.d_model} {cfg.dtype} {out['params']} params "
        f"({n_prod} in a token's products), B{batch} x S{seq}, {optimizer}, remat {remat}, on "
        f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else dev} ({smi}): step {step_s:.4f} s (mean of steps {warmup}-"
        f"{steps - 1}; all: {[round(t, 4) for t in out['step_times']]}), {tokens / step_s:.1f} "
        f"tokens/s, losses {[round(x, 5) for x in losses]}, peak {mem:.2f} GiB, MFU {100 * mfu:.2f}% "
        f"({flops / 1e12:.1f} TFLOP a step: 6 x {n_prod} x tokens {6 * n_prod * tokens / 1e12:.1f} + "
        f"attention {attn / 1e12:.1f}); launches per step {per_step}"
        + (f"; kernels of its path: {path}" if path else "; no kernel on its path: none launched")
        + (f"; MoE metrics a step {moe_metrics}" if moe_metrics else ""))
    return {"step_s": step_s, "tokens_per_s": tokens / step_s, "losses": losses, "peak_gib": mem,
            "mfu": mfu, "launches": launches, "launches_per_step": per_step,
            "step_times": out["step_times"], "moe": moe_metrics}


def phase_train_trace(dev, cfg, *, batch=2, seq=6144, remat="selective", optimizer="adamw",
                      before=2, top=10) -> dict:
    """Where a training step's time goes, at the train run's shape: `before` steps
    (the last timed by the host clock, ending in a sync), then one more traced
    with torch.profiler: device busy time, idle share, the kernels that take the
    most device time, and the device time of each kernel of the port. Only the
    device's activity is traced: rwkv6-7b's step launches ~600,000 kernels, and
    tracing the host's ops too took minutes to record and sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer = Trainer(Model(cfg), ParallelConfig(remat=remat),
                      TrainConfig(steps=before + 1, optimizer=optimizer), dev)
    state = trainer.init_state()
    data = SyntheticLM(cfg.vocab_size, seq, batch)
    quiet = dict(log=lambda *_: None)
    state, hist = trainer.fit(state, data, steps=before, **quiet)
    wall_ms = hist[-1]["step_time_s"] * 1e3
    # (the CPU rehearsal, which has no device, traces its host ops)
    with profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda" else ProfilerActivity.CPU]) as prof:
        state, _ = trainer.fit(state, data, steps=1, start_step=before, **quiet)
        sync()
    del state
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[train-trace] {cfg.name} training step B{batch} x S{seq}, remat {remat}: wall {wall_ms:.1f} ms "
        f"(host clock, untraced), device busy {device_ms:.1f} ms, idle share "
        f"{max(0.0, 1 - device_ms / wall_ms):.3f}, {sum(e.count for e in events)} device items")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[train-trace]   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d} calls  {e.key[:90]}")
    ours = {}
    for e in events:  # the kernels of csrc/, by their C++ names
        for name in ("flash_attention_tc_kernel", "dkdv_tc_kernel", "dq_tc_kernel", "dkdv_kernel",
                     "dq_kernel", "delta_kernel", "rmsnorm_kernel", "rmsnorm_residual_kernel",
                     "rmsnorm_bwd_kernel", "reduce_partials_kernel"):
            if name in e.key:
                ours[name] = ours.get(name, 0.0) + e.self_device_time_total / 1e3
    log("[train-trace]   the port's kernels: " + (", ".join(f"{k} {v:.2f} ms" for k, v in ours.items())
                                                  or "none"))
    return {"wall_ms": wall_ms, "device_ms": device_ms, "kernels_ms": ours}


# MESH_NOTE: the mesh phase trains h2o-danube-1.8b at full width and depth on a
# (data, model) mesh through `launch.train.run(mesh=...)`, the parameters and
# moments DTensors and the kernels run on each rank's local shards. (a) in this
# process, a world of one (NCCL), mesh (data 1, model 1), at the training run's
# shape and seed: each step's loss within TRAIN_NOTE's bar (2 x the bf16 floor
# of danube's train parity) of phase 7's single-device run, and the kernel
# launches a step equal to that run's. (b) two processes sharing the one card,
# gloo (which stages CUDA tensors through the host), mesh (data 1, model 2): each
# rank runs the kernels on 16 of the 32 query heads and 4 of the 8 kv heads;
# step 1's loss within the same bar of a single-device run of the same batch,
# its grad norm within 2 x the whole gradient's bf16 floor (relative), and each
# rank's launches a step counted. Both are correctness runs: (b)'s collectives
# cross the host, so its times are no scaling number.
MESH = dict(batch=2, seq=6144, steps=3)
MESH_RANKS = dict(ranks=2, batch=1, seq=6144, steps=2)
MESH_DIR = ROOT / "build" / "chip_smoke_mesh"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh_log(what: str, cfg, out: dict, batch: int, seq: int, smi: str) -> str:
    mem = (out["max_memory_allocated"] or 0) / 2**30
    return (f"[mesh] {what} {cfg.name} L{cfg.num_layers} d{cfg.d_model} B{batch} x S{seq}: losses "
            f"{[round(x, 5) for x in out['losses']]}, grad norms "
            f"{[round(h['grad_norm'], 5) for h in out['history']]}, step times "
            f"{[round(t, 4) for t in out['step_times']]} s, peak {mem:.2f} GiB ({smi}), launches "
            f"per step {out['launches_per_step'][-1]}")


def _check_launches(what: str, per_step: dict, path) -> None:
    missing = [k for k in path if per_step.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"mesh {what}: kernels never launched on the main path: {missing}")


def _one_rank_group(backend: str, init_method):
    """The default process group as a world of this process alone."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method or f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)


def phase_mesh(dev, cfg, ref_losses: list, ref_launches: dict, floor: float, smi: str, *,
               batch=2, seq=6144, steps=3, backend="nccl", init_method=None, sp=False,
               label="(a)", remat="selective", optimizer="adamw") -> dict:
    """MESH_NOTE (a): `cfg` on a (data 1, model 1) mesh of this process alone,
    against a single-device run of `cfg` at the same shape and seed (phase 7's):
    its losses and its kernel launches a step, no kernel off its path. With
    `sp`, under `rules_for(mesh)`, sequence parallelism on (MESH_SP_NOTE);
    else JAX's launcher rules."""
    import torch.distributed as dist

    _one_rank_group(backend, init_method)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev.type)
        rules = rules_for(mesh) if sp else None
        build.reset_launches()
        out = train_run(cfg, device=dev, batch=batch, seq=seq, steps=steps, remat=remat,
                        optimizer=optimizer, mesh=mesh, rules=rules, log=lambda *_: None)
        launches = dict(build.LAUNCHES)
    finally:
        dist.destroy_process_group()
    what = f"{label} mesh (data 1, model 1), one process" + (", sequence parallel," if sp else ",")
    log(_mesh_log(what, cfg, out, batch, seq, smi))
    errs = [abs(a - b) for a, b in zip(out["losses"], ref_losses)]
    log(f"[mesh] {label} losses against the single-device run {[round(x, 5) for x in ref_losses[:steps]]}: "
        f"max |diff| {max(errs):.3e} (tolerance {2 * floor:.3e} = 2 x the bf16 floor)")
    if len(errs) != steps or not all(np.isfinite(out["losses"])) or not max(errs) <= 2 * floor:
        raise AssertionError(f"mesh {label}: losses {out['losses']} vs {ref_losses}")
    path = train_kernels(cfg)
    per_step = out["launches_per_step"][-1]
    _check_launches(label, per_step, path)
    if {k: per_step[k] for k in path} != {k: ref_launches[k] for k in path}:
        raise AssertionError(f"mesh {label}: launches a step {per_step} != {ref_launches}")
    stray = [k for k, n in per_step.items() if n and k not in path]
    if stray:
        raise AssertionError(f"mesh {label}: kernels off {cfg.name}'s training path launched: {stray}")
    if dev.type == "cuda":
        log(f"[mesh] {label} {cfg.name}: peak {(out['max_memory_allocated'] or 0) / 2**30:.2f} GiB "
            f"({smi})")
    return {**out, "launches": launches}


def _loss_floor(dev, cfg, *, batch: int, seq: int, seed: int = 0) -> float:
    """TRAIN_NOTE's floor of a config without kernels on its path: the mean per-token
    |CE| difference of the bf16 and float32 forward on a seeded batch, at the
    training run's init."""
    params, data = _train_inputs(cfg, dev, batch, seq, seed)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    ce = _token_ce(Model(cfg, kernels=False), params, data)
    ce32 = _token_ce(Model(cfg32, kernels=False), cast_tree(params, torch.float32), data)
    return (ce - ce32).abs().mean().item()


def phase_mesh_depth_cut(dev, cfg, smi, *, batch=1, seq=4096, steps=2, remat="full",
                         optimizer="adamw8bit", backend="nccl", init_method=None) -> dict:
    """MESH_SP_NOTE (d): `cfg` (cut in depth) on the one-process mesh under
    `rules_for(mesh)`, against a single-device run at the same depth, shape and
    seed in this process, at twice its bf16 floor (`_loss_floor`)."""
    quiet = dict(log=lambda *_: None)
    single = train_run(cfg, device=dev, batch=batch, seq=seq, steps=steps, remat=remat,
                       optimizer=optimizer, **quiet)
    log(_mesh_log("(d) single device,", cfg, single, batch, seq, smi))
    floor = _loss_floor(dev, cfg, batch=batch, seq=seq)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return phase_mesh(dev, cfg, single["losses"], single["launches_per_step"][-1], floor, smi,
                      batch=batch, seq=seq, steps=steps, backend=backend, init_method=init_method,
                      sp=True, label="(d)", remat=remat, optimizer=optimizer)


def _probe_rank(rank: int, world: int, device_type: str, out_dir: str) -> None:
    """One rank of the collective probe: gloo on card 0's (or the CPU's) tensors, each
    of all_reduce, all_gather_into_tensor and reduce_scatter_tensor through c10d
    and then through DTensor's redistributions
    (the functional collectives the mesh path runs), each logged to
    `out_dir/probe<rank>.log` before and after it, so that a collective that
    kills the process is named by the last line it left."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dev = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/probe_pg", rank=rank,
                            world_size=world)
    mesh = init_device_mesh(device_type, (world,), mesh_dim_names=("model",))
    x = torch.ones(4 * world, device=dev)

    def dt(placement, to):
        return lambda: DTensor.from_local(x, mesh, [placement]).redistribute(mesh, [to]).to_local()

    calls = {"all_reduce": lambda: dist.all_reduce(x.clone()),
             "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                 torch.empty(4 * world * world, device=dev), x),
             "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                 torch.empty(4, device=dev), x),
             "DTensor Partial->Replicate (all_reduce)": dt(Partial(), Replicate()),
             "DTensor Shard->Replicate (all_gather_into_tensor)": dt(Shard(0), Replicate()),
             "DTensor Partial->Shard (reduce_scatter_tensor)": dt(Partial(), Shard(0))}
    with open(f"{out_dir}/probe{rank}.log", "w") as f:
        for name, call in calls.items():
            print(f"try\t{name}", file=f, flush=True)
            try:
                call()
                if device_type == "cuda":
                    torch.cuda.synchronize()
                print(f"ok\t{name}", file=f, flush=True)
            except Exception as e:  # the probe reports what is refused
                print(f"refused\t{name}\t{type(e).__name__}: {str(e).splitlines()[0][:160]}",
                      file=f, flush=True)
    dist.destroy_process_group()


def probe_collectives(device_type: str, ranks: int, timeout: float = 120.0) -> dict:
    """Which collectives gloo takes on `device_type` tensors across `ranks` processes,
    through c10d and through DTensor: name -> "ok", the error it raised, or the
    signal that killed a rank in it."""
    import shutil

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    ctx = torch.multiprocessing.start_processes(
        _probe_rank, args=(ranks, device_type, str(MESH_DIR)), nprocs=ranks, join=False,
        start_method="spawn")
    died = None
    try:
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                died = f"still running after {timeout} s"
                break
    except torch.multiprocessing.ProcessExitedException as e:
        died = str(e)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out: dict = {}
    for r in range(ranks):
        path = MESH_DIR / f"probe{r}.log"
        status = {}  # each collective's last line: tried (and then killed), ok, or refused
        for line in (path.read_text().splitlines() if path.exists() else []):
            state, name, *err = line.split("\t")
            status[name] = {"try": f"killed the rank ({died})", "ok": "ok"}.get(state) or err[0]
        for name, st in status.items():
            if out.get(name, "ok") == "ok":
                out[name] = st
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return out


def _mesh_rank(rank: int, world: int, cfg, device_type: str, batch: int, seq: int, steps: int,
               out_dir: str) -> None:
    """One rank of MESH_NOTE (b): gloo through a file under `out_dir`, every rank on
    card 0 (or the CPU); writes its results to `out_dir/<rank>.pt`."""
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()  # a crash in a collective names its Python frame
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg", rank=rank, world_size=world)
    try:
        build.reset_launches()
        out = train_run(cfg, device=dev, batch=batch, seq=seq, steps=steps, remat="selective",
                        mesh=f"1x{world}", log=lambda *_: None)
        torch.save({**out, "launches": dict(build.LAUNCHES)}, f"{out_dir}/{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_mesh_ranks(dev, cfg, floor: float, grad_floor: float, smi: str, *, ranks=2, batch=1,
                     seq=6144, steps=2, timeout=900.0) -> list[dict]:
    """MESH_NOTE (b): `ranks` processes on a (data 1, model `ranks`) mesh, against a
    single-device run of the same batch in this process. First the collectives
    are probed (`probe_collectives`); where gloo refuses one on these tensors,
    (b) is left out, the collective named, and [] returned."""
    import shutil

    probe = probe_collectives(dev.type, ranks)
    log(f"[mesh] (b) gloo across {ranks} processes on {dev.type} tensors: {probe}")
    refused = {k: v for k, v in probe.items() if v != "ok"}
    if refused or not probe:
        log(f"[mesh] (b) left out: gloo refuses on {dev.type} tensors {refused or probe} (MESH_NOTE)")
        return []
    single = train_run(cfg, device=dev, batch=batch, seq=seq, steps=steps, remat="selective",
                       log=lambda *_: None)
    log(_mesh_log("(b) single device,", cfg, single, batch, seq, smi))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    ctx = torch.multiprocessing.start_processes(
        _mesh_rank, args=(ranks, cfg, dev.type, batch, seq, steps, str(MESH_DIR)), nprocs=ranks,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"mesh (b): the ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = [torch.load(MESH_DIR / f"{r}.pt", weights_only=False) for r in range(ranks)]
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    path = train_kernels(cfg)
    for r, out in enumerate(outs):
        log(_mesh_log(f"(b) mesh (data 1, model {ranks}), rank {r} of {ranks},", cfg, out, batch, seq, smi))
    loss_err = abs(outs[0]["losses"][0] - single["losses"][0])
    g, g1 = single["history"][0]["grad_norm"], outs[0]["history"][0]["grad_norm"]
    log(f"[mesh] (b) step 1 against one device: loss {outs[0]['losses'][0]:.6f} vs {single['losses'][0]:.6f}, "
        f"|diff| {loss_err:.3e} (tolerance {2 * floor:.3e}); grad norm {g1:.6f} vs {g:.6f}, rel "
        f"{abs(g1 - g) / g:.3e} (tolerance {2 * grad_floor:.3e} = 2 x the whole gradient's bf16 floor)")
    if any(o["losses"] != outs[0]["losses"] for o in outs):
        raise AssertionError(f"mesh (b): the ranks log other losses: {[o['losses'] for o in outs]}")
    if not (loss_err <= 2 * floor and abs(g1 - g) / g <= 2 * grad_floor):
        raise AssertionError(f"mesh (b): step 1 loss {loss_err} or grad norm {abs(g1 - g) / g} past the bar")
    for r, out in enumerate(outs):
        _check_launches(f"(b) rank {r}", out["launches_per_step"][-1], path)
    return outs



# MESH_SP_NOTE: the hybrid and ssm families on the one-process NCCL mesh (data 1,
# model 1) under `rules_for(mesh)`, JAX's dry-run rules, which turn sequence
# parallelism on: between blocks the activations are split by sequence over
# "model", each Mamba2 and RWKV6 mix gathers its sequence whole at its entry
# (the conv and the token shift read the previous rank's rows), and the SSD,
# the WKV scan and the kernels run on each rank's heads. (c) zamba2-1.2b at full
# width and depth at phase 7's shape, data and seed, each step's loss within
# TRAIN_NOTE's bar (2 x the bf16 floor of zamba2's train parity) of phase 7's
# run, the kernel launches a step equal to that run's (13 / 7 / 88 / 13 / 53).
# (d) rwkv6-7b at full width and 2 of its 32 layers (its state at full depth
# with phase 7's int8 moments fits, but a 2-layer step keeps the phase short),
# int8 moments and remat full as phase 7's run, against a single-device run of
# the same depth in this process, within twice the bf16 floor of its loss
# (`_loss_floor`). Every collective is over one rank: no communication is
# measured.
MESH_SP = {"zamba2_1p2b": dict(batch=2, seq=4096, steps=3),
           "rwkv6_7b": dict(layers=2, batch=1, seq=4096, steps=2, remat="full",
                            optimizer="adamw8bit")}
# CP_NOTE: phase 9 serves qwen3-14b at full width and depth on the (data 1, model 1)
# mesh under the rules JAX's dry-run gives a decode shape of global batch 1 on a
# data axis wider than the batch (`rules_for`): no dp, tp and sp on "model", cp on
# "data". (On one card the data axis is 1 wide, not wider than the batch, so
# `rules_for(mesh, shape)` itself would leave cp off; the rules are those of the
# stand-in CP_STANDIN and are checked equal.) The KV cache is placed per
# `cache_pspecs(cp=True)`, its length dim on "data"; each decode step runs the
# decode kernel with its LSE output on the rank's slots and joins the ranks by
# `lse_combine`. Bars: the last-token logits of the prefill and of every decode
# step within the distance between the single-device kernel path and the plain
# bf16 path on the same tokens (each of which lies about one bf16 floor from
# float32, so that distance is at most 2 x the floor: the float32 path does not
# fit the card at full depth), the greedy tokens identical, 40 flash launches at
# the prefill and 40 decode launches a step (one an attention layer).
CP_SERVE = dict(prompt=1024, steps=16)
CP_STANDIN = {"data": 2, "model": 1}
# SPLIT_NOTE: phase 10 holds the decode kernel's LSE output and the combine of a
# split cache: at qwen3-14b's decode shape (dh 128) and h2o-danube's (dh 80), the
# output with LSE equal bit for bit to the output without it, the output to its
# plain version at ATTN_BAR_NOTE's bars, and the LSE to the plain float32 LSE
# within LSE_TOL; then the cache cut into 2 and 4 contiguous parts, each part's
# (out, lse) from the kernel (a part with no valid slot gives 0 and NEG_INF
# without a launch, as `models/attention.py` does), joined by `lse_combine`, held
# to the whole cache's kernel output and to the plain version at ATTN_BAR_NOTE's
# bars. A second n_valid under a quarter of the cache leaves parts empty at 2
# parts as at 4.
# LSE_TOL: a row's LSE is the max scaled score plus log of the sum of exponentials
# (~3 + log 1100 ~ 10 at these shapes). The kernel's scores come from the same
# bf16 q and k as the plain version's, summed in float32 in another order (~1e-6
# relative at dh 128), and it adds exponentials in another order with exp2f (a
# few ulps): ~1e-5 absolute; the bar leaves ten times that.
LSE_TOL = 1e-4
SPLIT_CASES = ((4, 8, 5, 2048, 128, (1100, 500)), (4, 8, 4, 4096, 80, (4096, 1000)))
SPLIT_PARTS = (2, 4)


def _greedy(model, params, toks, steps: int, max_len: int, cp: bool = False, forced=None):
    """Prefill `toks` (B, S), then `steps` decode steps, each fed its own greedy token
    (or the token of `forced`, (B, steps)): (logits (steps + 1, B, V), tokens (B,
    steps), cache, kernel launches of the prefill, of the decode steps)."""
    build.reset_launches()
    logits, cache = model.prefill(params, {"tokens": toks}, max_len, cp=cp)
    pre = dict(build.LAUNCHES)
    outs, fed = [logits], []
    for i in range(steps):
        tok = logits.argmax(-1, keepdim=True) if forced is None else forced[:, i:i + 1]
        fed.append(tok)
        logits, cache = model.decode_step(params, cache, tok, cp=cp)
        outs.append(logits)
    sync()
    dec = {k: n - pre[k] for k, n in build.LAUNCHES.items()}
    return torch.stack(outs), torch.cat(fed, 1), cache, pre, dec


def _placement_errors(model, cache, cp: bool, mesh) -> list[str]:
    """The cache leaves not placed as `cache_pspecs(cp)` (sanitized) says."""
    specs, wrong = model.cache_pspecs(cp), []

    def walk(tree, spec, path):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            p = f"{path}/{k}" if path else str(k)
            if isinstance(v, (dict, tuple)):
                walk(v, spec[k], p)
            elif isinstance(v, torch.Tensor):
                want = placements(sanitize_pspec(spec[k], tuple(v.shape), mesh), mesh)
                if tuple(v.placements) != want:
                    wrong.append(f"{p}: {v.placements} != {want}")

    walk({k: v for k, v in cache.items() if k != "pos"}, specs, "")
    return wrong


def phase_cp_serve(dev, cfg, smi, *, prompt=1024, steps=16, seed=0, backend="nccl",
                   init_method=None) -> dict:
    """CP_NOTE: `cfg` served on the one-process mesh with context parallelism, against
    the single-device kernel path on the same prompt and parameters."""
    import types

    import torch.distributed as dist

    model = Model(cfg)
    plain = Model(dataclasses.replace(cfg, attn_impl="dense"), kernels=False)
    params = model.init(seed, dev)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                                 (1, prompt))).to(dev)
    max_len = prompt + steps
    t0 = time.perf_counter()
    ref, ref_toks, cache, _, _ = _greedy(model, params, toks, steps, max_len)
    single_s = time.perf_counter() - t0
    del cache
    plain_logits, _, cache, _, _ = _greedy(plain, params, toks, steps, max_len, forced=ref_toks)
    del cache
    tol = (plain_logits - ref).abs().max().item()
    rules = make_rules(dp=(), tp=("model",), sequence_parallel=True, context_parallel=("data",))
    standin = rules_for(types.SimpleNamespace(shape=CP_STANDIN),
                        types.SimpleNamespace(kind="decode", global_batch=1))
    if rules != standin:
        raise AssertionError(f"cp serve: rules {rules} != rules_for's {standin}")
    _one_rank_group(backend, init_method)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), dev.type)
        with use_mesh(mesh, rules):
            placed = distribute(params, model.pspecs(), mesh)
            del params
            t0 = time.perf_counter()
            out, out_toks, cache, pre, dec = _greedy(model, placed, toks, steps, max_len, cp=True)
            mesh_s = time.perf_counter() - t0
            wrong = _placement_errors(model, cache, True, mesh)
            kv = cache["layers"]["kv"]["k"]
            split = [str(p) for p in kv.placements]
    finally:
        dist.destroy_process_group()
    err = (out - ref).abs().max().item()
    same = torch.equal(out_toks, ref_toks)
    mem = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    log(f"[cp-serve] {cfg.name} L{cfg.num_layers} d{cfg.d_model} {cfg.dtype} on mesh (data 1, model 1), "
        f"rules {rules}: prompt {prompt} + {steps} greedy decode steps; logits max |diff| against the "
        f"single-device kernel path {err:.4e} (tolerance {tol:.4e}: kernels vs plain bf16 on the same "
        f"tokens), greedy tokens {'identical' if same else 'DIFFER'}; KV cache {tuple(kv.shape)} placed "
        f"{split}; launches at the prefill {pre}, in {steps} decode steps {dec}; wall {mesh_s:.3f} s "
        f"against {single_s:.3f} s on one device (host clock); peak {mem:.2f} GiB ({smi})")
    if not (torch.isfinite(out).all() and err <= tol and same):
        raise AssertionError(f"cp serve: logits {err} > {tol} or tokens differ")
    if wrong:
        raise AssertionError(f"cp serve: cache leaves placed otherwise than cache_pspecs: {wrong}")
    blocks = attention_blocks(cfg)
    if (pre["flash_attention"], dec["decode_attention"]) != (blocks, blocks * steps):
        raise AssertionError(f"cp serve: {pre['flash_attention']} flash launches at the prefill and "
                             f"{dec['decode_attention']} decode launches in {steps} steps, not "
                             f"{blocks} and {blocks * steps}")
    stray = [k for k in dec if dec[k] and k not in used_kernels(cfg)]
    if stray:
        raise AssertionError(f"cp serve: kernels off the serve path launched: {stray}")
    launches = {k: pre[k] + dec[k] for k in pre}
    return {"err": err, "tol": tol, "launches": launches, "seconds": mesh_s}


def _split_combine(qd, kt, vt, nv: int, parts: int):
    """The decode of qd over the cache (kt, vt) cut into `parts` contiguous parts of
    its slots, each through the kernel with its LSE (none for an empty part),
    joined by `lse_combine`: (out in qd's dtype, the parts' valid counts)."""
    T = kt.shape[2]
    n = T // parts
    outs, lses, counts = [], [], []
    for r in range(parts):
        nvr = min(max(nv - r * n, 0), n)
        counts.append(nvr)
        if nvr == 0:
            outs.append(torch.zeros(qd.shape, dtype=torch.float32, device=qd.device))
            lses.append(torch.full(qd.shape[:-1], -1e30, dtype=torch.float32, device=qd.device))
            continue
        o, lse = dec_ops.decode_attention(qd, kt[:, :, r * n:(r + 1) * n], vt[:, :, r * n:(r + 1) * n],
                                          nvr, lse=True)
        outs.append(o)
        lses.append(lse)
    return lse_combine(torch.stack(outs), torch.stack(lses)).to(qd.dtype), counts


def phase_split_decode(dev, *, cases=SPLIT_CASES, parts=SPLIT_PARTS, timed=True) -> dict:
    """SPLIT_NOTE: the decode kernel's LSE output and a split cache's combine, bf16;
    then the kernel timed with and without its LSE output over ROTATION caches
    (COLD_L2_NOTE), at each case's first n_valid. Returns the worst errors and
    the timings."""
    rng = np.random.default_rng(1)
    bf = torch.bfloat16
    worst = {"out": 0.0, "lse": 0.0, "combined": 0.0}
    empty, timings = 0, []

    def bars(label, out, ref):
        err, rel = _err(out, ref), _rel(out, ref)
        log(f"[split] {label}: max_abs_err {err:.3e} (tol {TOL[bf]:g}), rel_err {rel:.3e} "
            f"(tol {REL_TOL:g})")
        if not (err < TOL[bf] and rel < REL_TOL):
            raise AssertionError(f"split: {label}: {err}, {rel}")
        return err

    for B, Hkv, G, T, dh, nvs in cases:
        qd = _randn(rng, (B, Hkv, G, dh), bf, dev)
        kt, vt = (_randn(rng, (B, T, Hkv, dh), bf, dev).transpose(1, 2) for _ in range(2))
        for nv in nvs:
            label = f"q ({B},{Hkv},{G},{dh}) cache ({B},{T},{Hkv},{dh}) n_valid {nv}"
            out, lse = dec_ops.decode_attention(qd, kt, vt, nv, lse=True)
            if not torch.equal(out, dec_ops.decode_attention(qd, kt, vt, nv)):
                raise AssertionError(f"split: {label}: the output with LSE differs from the one without")
            ref = decode_attention_ref(qd, kt, vt, nv)
            _, lse32 = decode_attention_ref(qd.float(), kt.float(), vt.float(), nv, lse=True)
            worst["out"] = max(worst["out"], bars(f"{label} kernel with LSE vs plain", out, ref))
            lse_err = _err(lse, lse32)
            log(f"[split] {label} LSE vs plain float32: max_abs_err {lse_err:.3e} (tol {LSE_TOL:g}; "
                f"LSE from {lse32.min().item():.3f} to {lse32.max().item():.3f})")
            if not lse_err <= LSE_TOL:
                raise AssertionError(f"split: {label}: LSE {lse_err} > {LSE_TOL}")
            worst["lse"] = max(worst["lse"], lse_err)
            for n in parts:
                comb, counts = _split_combine(qd, kt, vt, nv, n)
                empty += counts.count(0)
                what = f"{label} in {n} parts (valid slots {counts})"
                worst["combined"] = max(worst["combined"], bars(f"{what} vs the whole cache's kernel",
                                                                comb, out),
                                        bars(f"{what} vs plain", comb, ref))
    if not empty:
        raise AssertionError("split: no part without a valid slot")
    if timed:
        for B, Hkv, G, T, dh, nvs in cases:
            timings.append(_lse_timing(rng, dev, B, Hkv, G, T, dh, nvs[0]))
    return {**worst, "empty_parts": empty, "timings": timings}


def _lse_timing(rng, dev, B, Hkv, G, T, dh, nv) -> dict:
    """The decode kernel with and without its LSE output, and the plain version with
    it, at one shape over ROTATION cache pairs (COLD_L2_NOTE)."""
    bf = torch.bfloat16
    qd = _randn(rng, (B, Hkv, G, dh), bf, dev)
    pairs = [tuple(_randn(rng, (B, T, Hkv, dh), bf, dev).transpose(1, 2) for _ in range(2))
             for _ in range(ROTATION)]

    def cold(lse):
        turn = itertools.cycle(pairs)
        return lambda: dec_ops.decode_attention(qd, *next(turn), nv, lse=lse)

    iters = 6 * ROTATION
    kt, vt = pairs[0]
    plain = time_ms(lambda: decode_attention_ref(qd, kt, vt, nv, lse=True))
    with_lse, without = time_ms(cold(True), iters=iters, graph=True), time_ms(cold(False), iters=iters,
                                                                                graph=True)
    label = (f"q ({B},{Hkv},{G},{dh}) cache ({B},{T},{Hkv},{dh}) n_valid {nv} bf16, with LSE, cold L2 "
             f"({ROTATION} K/V pairs rotated)")
    t = timing(label, with_lse, plain, None,
               2 * B * Hkv * G * dh * 2 + 2 * B * Hkv * nv * dh * 2 + B * Hkv * G * 4,
               4 * B * Hkv * G * nv * dh, bf)
    log(f"[split] decode_attention at {label}: {with_lse:.4f} ms with LSE, {without:.4f} ms without "
        f"(the same launch but the null pointer), plain with LSE {plain:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    return {**t, "ms_without_lse": without}

def train_config(arch: str):
    """A training run's config: full width, `layers` deep where TRAIN_RUNS cuts it."""
    cfg = get_config(arch)
    layers = TRAIN_RUNS[arch].get("layers")
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_build()
    rec = phase_kernels(dev)
    t7 = time.perf_counter()
    rec.update(phase_bwd_kernels(dev))
    t7 = time.perf_counter() - t7  # phase 7's seconds: its kernel part here, its training part below
    for arch in ARCHS:
        if arch in NOT_ON_ONE_CARD:
            log(f"[parity] {arch} left out: {NOT_ON_ONE_CARD[arch]}")
            continue
        phase_parity(dev, dataclasses.replace(get_config(arch), num_layers=PARITY_LAYERS.get(arch, 2)),
                     seed=args.seed)
        torch.cuda.empty_cache()
    full = get_config("qwen3_14b")
    serves = {full.name: phase_serve(dev, full, seed=args.seed)}
    torch.cuda.empty_cache()
    serves[full.name]["trace"] = phase_trace(dev, full, seed=args.seed)
    for arch, traffic in SERVE_TRAFFIC.items():
        cfg = get_config(arch)
        serves[cfg.name] = serve = phase_serve(dev, cfg, seed=args.seed, **traffic)
        if cfg.sliding_window is not None and not serve["full_ring"]:
            raise AssertionError(f"serve: {cfg.name}'s traffic never filled its window")
        torch.cuda.empty_cache()
        serve["trace"] = phase_trace(dev, cfg, prompt=sum(traffic["prompt_len"]) // 2, seed=args.seed)
        torch.cuda.empty_cache()
    log("[serve] config            tok/s   prefill s/admission   decode ms/step   peak GiB   "
        "traced step: wall ms, device ms, idle")
    for name, r in serves.items():
        t = r["trace"]
        log(f"[serve] {name:17s} {r['tokens'] / r['seconds']:7.2f}   "
            f"{r['prefill_seconds'] / max(r['admissions'], 1):19.3f}   "
            f"{1e3 * r['decode_seconds'] / max(r['decode_steps'], 1):14.3f}   "
            f"{(r['max_memory_allocated'] or 0) / 2**30:8.2f}   "
            f"{t['wall_ms']:.3f}, {t['device_ms']:.3f}, {1 - t['device_ms'] / t['wall_ms']:.3f}")
    t_train = time.perf_counter()
    parity = {}
    for arch, shape in TRAIN_PARITY.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=PARITY_LAYERS.get(arch, 2))
        parity[arch] = (phase_train_parity_moe if cfg.moe else phase_train_parity)(
            dev, cfg, seed=args.seed, **shape)
        torch.cuda.empty_cache()
    for arch, shape in REMAT_ONLY.items():
        phase_remat_identity(dev, dataclasses.replace(get_config(arch), num_layers=2), seed=args.seed,
                             **shape)
        torch.cuda.empty_cache()
    phase_resume(dev, dataclasses.replace(get_config("h2o_danube_1p8b"), num_layers=2), seed=args.seed)
    torch.cuda.empty_cache()
    trains = {}
    for arch, run in TRAIN_RUNS.items():
        cfg = train_config(arch)
        shape = {k: v for k, v in run.items() if k != "layers"}
        trains[cfg.name] = phase_train_run(dev, cfg, smi, **shape)
        torch.cuda.empty_cache()
        phase_train_trace(dev, cfg, batch=run["batch"], seq=run["seq"], remat=run["remat"],
                          optimizer=run.get("optimizer", "adamw"))
        torch.cuda.empty_cache()
    t7 += time.perf_counter() - t_train
    t_mesh = time.perf_counter()
    danube, floors = train_config("h2o_danube_1p8b"), parity["h2o_danube_1p8b"]
    run7 = trains[danube.name]
    mesh = phase_mesh(dev, danube, run7["losses"], run7["launches_per_step"], floors["floor"], smi, **MESH)
    torch.cuda.empty_cache()
    ranks = phase_mesh_ranks(dev, danube, floors["floor"], floors["grad_floor"], smi, **MESH_RANKS)
    t_mesh = time.perf_counter() - t_mesh
    torch.cuda.empty_cache()
    t_new = time.perf_counter()  # phases 8 (c), (d), 9 and 10, added with context parallelism
    split = phase_split_decode(dev)
    dec = rec["decode_attention"]
    dec["lse"] = split["timings"]
    dec["max_abs_err"] = max(dec["max_abs_err"], split["out"], split["combined"])
    torch.cuda.empty_cache()
    zamba2 = train_config("zamba2_1p2b")
    run7 = trains[zamba2.name]
    mesh_c = phase_mesh(dev, zamba2, run7["losses"], run7["launches_per_step"],
                        parity["zamba2_1p2b"]["floor"], smi, sp=True, label="(c)",
                        **MESH_SP["zamba2_1p2b"])
    torch.cuda.empty_cache()
    cut = {k: v for k, v in MESH_SP["rwkv6_7b"].items() if k != "layers"}
    rwkv = dataclasses.replace(get_config("rwkv6_7b"), num_layers=MESH_SP["rwkv6_7b"]["layers"])
    log(f"[mesh] (d) {rwkv.name} at full width and {rwkv.num_layers} of its "
        f"{get_config('rwkv6_7b').num_layers} layers (cut: MESH_SP_NOTE)")
    mesh_d = phase_mesh_depth_cut(dev, rwkv, smi, **cut)
    torch.cuda.empty_cache()
    cp = phase_cp_serve(dev, full, smi, seed=args.seed, **CP_SERVE)
    torch.cuda.empty_cache()
    t_new = time.perf_counter() - t_new
    runs = {**{c: r["launches"] for c, r in serves.items()},
            **{f"train {c}": r["launches"] for c, r in trains.items()},
            f"mesh {danube.name} (1x1)": mesh["launches"],
            **{f"mesh {danube.name} (1x{len(ranks)}) rank {i}": r["launches"] for i, r in enumerate(ranks)},
            f"mesh {zamba2.name} (1x1, sequence parallel)": mesh_c["launches"],
            f"mesh {rwkv.name} L{rwkv.num_layers} (1x1, sequence parallel)": mesh_d["launches"],
            f"cp serve {full.name} (1x1)": cp["launches"]}
    log(f"[done] command phases took {time.perf_counter() - t0:.1f}s, of which phase 7 {t7:.1f}s, "
        f"the mesh phase's (a) and (b) {t_mesh:.1f}s, and its (c) and (d), the cp serve and the "
        f"split phases {t_new:.1f}s")
    # launches: each main-path run's counts (set to 0 before it, read after it), summed
    # over the serve runs, the training runs and the mesh runs (each rank's)
    sources = {**KERNELS, **TRAIN_KERNELS}
    kernels = [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": sum(r[name] for r in runs.values()),
         "launches_by_config": {c: r[name] for c, r in runs.items()},
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "shape": r["shape"],
         **({"extra_shapes": r["extra"]} if "extra" in r else {}),
         **({"lse_shapes": r["lse"]} if "lse" in r else {})}
        for name, r in rec.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
