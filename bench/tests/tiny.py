"""A tiny copy of the benchmark for the CPU tests: the real harness, metrics and
reference, with tiny bf16 configurations, traffic and cells beside them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

TINY = {
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-05,
    "rope_theta": 10000.0, "sliding_window": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "vocab_size": 256, "qk_norm": True, "qk_norm_eps": 1e-06,
    "family": "dense", "reference": "dense", "source": "a test's tiny model",
}
TINY_SWA = {**TINY, "qk_norm": False, "sliding_window": 16, "num_hidden_layers": 3}
# the kernels' smallest tensor-core head dim, for the card
TINY64 = {**TINY, "hidden_size": 256, "intermediate_size": 512, "head_dim": 64, "vocab_size": 1024}

SERVE = {"kind": "serve", "slots": 4, "max_len": 256, "requests_per_call": 8,
         "prompt_len": [8, 40], "new_tokens": [6, 16], "lengths_seed": 1, "check_requests": 8,
         "warmup": {"requests": 5, "prompt_len": 40, "new_tokens": 2}}
# prompts up to 40 and positions past 60 against tiny-swa's window of 16: the prefill
# keeps a prompt's last 16 tokens in the ring, and decode wraps it
HYPER = {"learning_rate": 3e-4, "warmup_steps": 10, "schedule_steps": 1000, "weight_decay": 0.1,
         "grad_clip": 1.0, "b1": 0.9, "b2": 0.95, "eps": 1e-8}
TRAIN = {"kind": "train", "batch": 2, "seq": 32, "zipf": 1.3, "remat": "selective",
         "optimizer": "adamw", "check_steps": 3, "hyper": HYPER}

# set as the cells' limits are, from readings at these sizes on the CPU: the
# program's widest served gap <= 0.0017, the fp8 control's >= 0.0063 (seeds 0-8); the
# program's loss gap <= 2.6e-4 and grad gap <= 1.6e-3, the fp8 control's grad gap
# >= 9.1e-3, half the batch's >= 0.055 (grad) and >= 0.13 (change) (seeds 0-2)
# tiny64's training traffic is longer than the port's `attn_chunk` (1024), so that its
# steps run the flash kernels
TRAIN2K = {**TRAIN, "batch": 1, "seq": 2048}

SERVE_LIMITS = {"schedule_mismatches": 0, "served_gap": 0.004}
TRAIN_LIMITS = {"loss_gap": 0.002, "grad_gap": 0.005, "change_gap": 0.03}


def make_root(tmp: Path) -> Path:
    """A checkout with the benchmark's folder copied and tiny cells added beside the
    real ones: `tiny.serve`, `tiny.train`, `tiny-swa.serve`, `tiny-swa.train`, and
    `tiny64.serve`, `tiny64.train` for the card."""
    root = tmp / "root"
    bench = root / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for name, cfg in (("tiny", TINY), ("tiny-swa", TINY_SWA), ("tiny64", TINY64)):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test", "file": f"bench/configs/{name}.json",
                                "reduced": [], "why": "test"})
    for name, traffic in (("test.serve", SERVE), ("test.train", TRAIN), ("test.train2k", TRAIN2K)):
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    for cell, cfg, traffic, limits in (("tiny.serve", "tiny", "test.serve", SERVE_LIMITS),
                                       ("tiny.train", "tiny", "test.train", TRAIN_LIMITS),
                                       ("tiny-swa.serve", "tiny-swa", "test.serve", SERVE_LIMITS),
                                       ("tiny-swa.train", "tiny-swa", "test.train", TRAIN_LIMITS),
                                       ("tiny64.serve", "tiny64", "test.serve", SERVE_LIMITS),
                                       ("tiny64.train", "tiny64", "test.train2k", TRAIN_LIMITS)):
        (bench / "cells" / f"{cell}.json").write_text(json.dumps(limits))
        spec["workloads"].append({"name": cell, "config": cfg, "traffic": traffic, "chips": 1,
                                  "why": "test"})
    like = {"tiny.serve": "h2o-danube-1.8b.serve.docs", "tiny.train": "h2o-danube-1.8b.train.s6k",
            "tiny-swa.serve": "h2o-danube-1.8b.serve.docs",
            "tiny-swa.train": "h2o-danube-1.8b.train.s6k",
            "tiny64.serve": "h2o-danube-1.8b.serve.docs", "tiny64.train": "h2o-danube-1.8b.train.s6k"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c, real in like.items() if real in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
