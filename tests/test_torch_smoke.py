"""A rehearsal of `chip_smoke.py`'s phases 3-6 on the CPU, at a tiny size.

The same phase functions run with `device="cpu"`, where every kernel wrapper
takes its plain version; a host clock stands in for the CUDA event timer.
The serve phase must then fail its launch check, since no kernel launched.
"""

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")


def _host_ms(fn, iters=2, warmup=1):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _tiny():
    return chip_smoke.get_config("qwen3_14b").reduced(dtype="bfloat16", param_dtype="bfloat16")


def test_phase_kernels_rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "time_ms", _host_ms)
    rec = chip_smoke.phase_kernels(CPU, rows=32, d=256, heads=4, B=1, Hq=4, Hkv=2, dh=32, S=80,
                                   fa_lens=(70, 80), T=96, nvs=(1, 50, 96), nv=40, sweeps=False)
    assert set(rec) == set(chip_smoke.KERNELS)
    for r in rec.values():
        assert r["bound_by"] in ("bytes", "operations") and r["bound_ms"] > 0
        assert {"ms", "plain_ms", "library_ms", "max_abs_err"} <= r.keys()
    assert rec["rmsnorm_residual"]["library_ms"] is None


def test_phase_parity_rehearsal():
    out = chip_smoke.phase_parity(CPU, _tiny(), batch=2, prompt=20, steps=3)
    assert 0 <= out["max_abs_err"] <= out["tolerance"]


def test_phase_serve_rehearsal_fails_without_launches():
    cfg = dataclasses.replace(_tiny(), num_layers=1)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_serve(CPU, cfg, requests=3, slots=2, prompt_len=(9, 14), max_new=3,
                               max_len=32)


def test_phase_trace_rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    cfg = dataclasses.replace(_tiny(), num_layers=1)
    out = chip_smoke.phase_trace(CPU, cfg, slots=2, prompt=12, steps=2)
    assert out["wall_ms"] > 0 and out["device_ms"] == 0  # no CUDA kernel runs on a CPU


def test_bound_picks_the_larger_time():
    ms, by = chip_smoke.bound(3.35e12, 0.0, torch.bfloat16)
    assert (ms, by) == (1e3, "bytes")
    ms, by = chip_smoke.bound(0.0, 989e12 * 2, torch.bfloat16)
    assert (ms, by) == (2e3, "operations")
