"""A rehearsal of `chip_smoke.py`'s phases 3-6 on the CPU, at a tiny size.

The same phase functions run with `device="cpu"`, where every kernel wrapper
takes its plain version; a host clock stands in for the CUDA event timer.
The serve phase must then fail its launch check, since no kernel launched.
The training phases' rehearsals are in `test_torch_smoke_train.py` (zamba2's
train parity alone in `test_torch_smoke_train_zamba2.py`), deepseek-moe-16b's
full-width phase 4 and 7 rehearsals in `test_torch_smoke_moe.py`: one file
each, so that no one file sets the wall time of a parallel run.
"""

import dataclasses
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from torch_threads import one_thread  # noqa: E402, F401

CPU = torch.device("cpu")


def _host_ms(fn, iters=2, warmup=1, graph=False):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _tiny(arch="qwen3_14b"):
    return chip_smoke.get_config(arch).reduced(dtype="bfloat16", param_dtype="bfloat16")


def test_phase_kernels_rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "time_ms", _host_ms)
    rec = chip_smoke.phase_kernels(CPU, rows=32, d=256, heads=4, B=1, Hq=4, Hkv=2, dh=32, S=80,
                                   fa_lens=(70, 80), T=96, nvs=(1, 50, 96), nv=40,
                                   danube_fa=(1, 4, 2, 100, 80, 64), danube_dec=(1, 2, 2, 128, 80, 128),
                                   deepseek_dec=(1, 4, 1, 96, 128, 50), dh64_fa=(1, 4, 4, 90, 64, None),
                                   dh64_dec=(1, 4, 1, 96, 64, 50), sweeps=False)
    assert set(rec) == set(chip_smoke.KERNELS)
    for r in rec.values():
        assert r["bound_by"] in ("bytes", "operations") and r["bound_ms"] > 0
        assert {"ms", "plain_ms", "library_ms", "max_abs_err"} <= r.keys()
    assert rec["rmsnorm_residual"]["library_ms"] is None
    (qk,) = rec["rmsnorm"]["extra"]  # the qk-norm's rows, timed beside F.rms_norm
    assert qk["shape"].startswith("x (128,32)") and qk["library_ms"] is not None
    assert f"cold L2 ({chip_smoke.ROTATION} K/V pairs rotated" in rec["decode_attention"]["shape"]
    # h2o-danube's shapes (dh 80, a window) beside the main ones, with every key of a row
    fa80, fa64 = rec["flash_attention"]["extra"]  # and zamba2's / musicgen's dh-64 rows
    dec80, dec_moe, dec64 = rec["decode_attention"]["extra"]  # and deepseek-moe-16b's G 1 row
    assert fa80["shape"] == "q (1,4,100,80) kv heads 2 bf16 causal window 64"
    assert dec80["shape"].startswith("q (1,2,2,80) cache (1,128,2,80) n_valid 128")
    assert dec_moe["shape"].startswith("q (1,4,1,128) cache (1,96,4,128) n_valid 50")
    # bytes: K and V up to n_valid, q and the output once each
    assert dec_moe["bound_ms"] == chip_smoke.bound(2 * 4 * 128 * 2 + 2 * 4 * 50 * 128 * 2,
                                                   4 * 4 * 50 * 128, torch.bfloat16)[0]
    assert fa64["shape"] == "q (1,4,90,64) kv heads 4 bf16 causal"
    assert dec64["shape"].startswith("q (1,4,1,64) cache (1,96,4,64) n_valid 50")
    for t in (fa80, fa64, dec80, dec_moe, dec64):
        assert {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by"} <= t.keys()
    # the flash bound counts the live pairs of the window: 64 * 65 / 2 + 36 * 64
    assert fa80["bound_ms"] == chip_smoke.bound((2 * 4 + 2 * 2) * 100 * 80 * 2, 4 * 80 * (2080 + 2304) * 4,
                                                torch.bfloat16)[0]


def test_live_pairs():
    assert chip_smoke.live_pairs(4608, 4096) * 128 == 1_342_439_424  # h2o-danube's prefill
    assert chip_smoke.live_pairs(10, None) == chip_smoke.live_pairs(10, 10) == 55


@pytest.mark.parametrize("arch", ["qwen3_14b", "starcoder2_3b", "h2o_danube_1p8b",
                                  "deepseek_moe_16b", "zamba2_1p2b", "rwkv6_7b"])
def test_phase_parity_rehearsal(arch):
    """h2o-danube takes the phase's own prompt, past its window (16 when reduced);
    deepseek-moe-16b runs the routing-aware checks (ROUTING_NOTE); zamba2 and
    rwkv6 take the phase's own 300-token prompt, past a padded chunk, zamba2 at
    PARITY_LAYERS' depth (a segment and a tail when reduced too: 3 layers at
    attn_every 2). Every config but the MoE one also holds its `loss`."""
    cfg = _tiny(arch)
    if arch in chip_smoke.PARITY_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every + 1)
    recurrent = cfg.family in ("hybrid", "ssm")
    out = chip_smoke.phase_parity(CPU, cfg, batch=2, steps=3,
                                  prompt=None if cfg.sliding_window or recurrent else 20)
    assert 0 <= out["max_abs_err"] <= out["tolerance"]
    assert 0 <= out["forward_err"] < chip_smoke.FORWARD_TOL
    assert ("loss" in out) == (cfg.moe is None)
    if cfg.family == "ssm":  # no kernel on its path: the two paths are one
        assert out["max_abs_err"] == 0.0 and out["loss"]["err"] == 0.0


def test_relative_bar_rejects_the_padded_width_scale():
    """At dh 80 the tensor-core tiles are 128 wide; attention scaled by 128 ** -0.5
    passes the absolute bf16 bar at a full ring but not the relative one."""
    assert chip_smoke._padded(80) == 128 and chip_smoke._padded(64) == 64
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g).to(torch.bfloat16)
               for s in ((1, 2, 4, 80), (1, 2, 4096, 80), (1, 2, 4096, 80)))
    ref = chip_smoke.decode_attention_ref(q, k, v, 4096)
    right = chip_smoke.decode_attention_ref(q.float(), k.float(), v.float(), 4096)
    wrong = chip_smoke.decode_attention_ref(q, k, v, 4096, scale=128 ** -0.5)
    assert chip_smoke._rel(right, ref) < chip_smoke.REL_TOL < chip_smoke._rel(wrong, ref)
    assert chip_smoke._err(right, ref) < chip_smoke.TOL[torch.bfloat16]


@pytest.mark.parametrize("arch", ["qwen3_14b", "musicgen_large", "deepseek_moe_16b", "zamba2_1p2b"])
def test_phase_serve_rehearsal_fails_without_launches(arch):
    cfg = _tiny(arch)  # deepseek: its dense layer and one MoE layer; zamba2: a segment and a tail
    cfg = cfg if cfg.moe else dataclasses.replace(cfg, num_layers=3 if cfg.attn_every else 1)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_serve(CPU, cfg, requests=3, slots=2, prompt_len=(9, 14), max_new=3,
                               max_len=32)


def test_phase_serve_rehearsal_rwkv6_launches_nothing(capsys):
    """rwkv6's path has no kernel: the check accepts the empty set, says so, and
    counts the admissions from the engine (two here: 3 requests over 2 slots)."""
    out = chip_smoke.phase_serve(CPU, _tiny("rwkv6_7b"), requests=3, slots=2, prompt_len=(9, 14),
                                 max_new=3, max_len=32)
    assert out["admissions"] == 2 and not any(out["launches"].values())
    assert "no kernel on its path" in capsys.readouterr().out


def test_attention_blocks():
    """One a layer; zamba2's shared block at each application (6 segments and a
    tail: 7); none in rwkv6."""
    get = chip_smoke.get_config
    assert [chip_smoke.attention_blocks(get(a)) for a in ("qwen3_14b", "zamba2_1p2b", "rwkv6_7b")] \
        == [40, 7, 0]
    assert chip_smoke.attention_blocks(dataclasses.replace(get("zamba2_1p2b"), num_layers=36)) == 6


def test_serve_traffic_and_used_kernels():
    """Phase 5 serves every config of the registry that one card holds, and names
    why for the others; h2o-danube's prompts pass its window; LayerNorm configs
    use the attention kernels alone; deepseek-moe-16b all four kernels, with a
    second admission."""
    assert {"qwen3_14b", *chip_smoke.SERVE_TRAFFIC, *chip_smoke.NOT_ON_ONE_CARD} == set(chip_smoke.ARCHS)
    assert not set(chip_smoke.SERVE_TRAFFIC) & set(chip_smoke.NOT_ON_ONE_CARD)
    assert set(chip_smoke.NOT_ON_ONE_CARD) == {"arctic_480b"}
    deepseek = chip_smoke.get_config("deepseek_moe_16b")
    traffic = chip_smoke.SERVE_TRAFFIC["deepseek_moe_16b"]
    assert traffic["requests"] > 4 and deepseek.moe.capacity_factor == 1.25
    assert chip_smoke.used_kernels(deepseek) == list(chip_smoke.KERNELS)
    danube = chip_smoke.get_config("h2o_danube_1p8b")
    traffic = chip_smoke.SERVE_TRAFFIC["h2o_danube_1p8b"]
    assert traffic["prompt_len"][0] > danube.sliding_window and traffic["max_len"] >= 4600 + 32
    assert chip_smoke.used_kernels(danube) == list(chip_smoke.KERNELS)
    assert chip_smoke.used_kernels(chip_smoke.get_config("minitron_8b")) == ["flash_attention",
                                                                             "decode_attention"]
    # the recurrent families: zamba2 runs all four kernels in its shared block and
    # Mamba2 layers, rwkv6 none; each with a second admission
    assert chip_smoke.used_kernels(chip_smoke.get_config("zamba2_1p2b")) == list(chip_smoke.KERNELS)
    assert chip_smoke.used_kernels(chip_smoke.get_config("rwkv6_7b")) == []
    for arch in ("zamba2_1p2b", "rwkv6_7b"):
        t = chip_smoke.SERVE_TRAFFIC[arch]
        assert t == dict(requests=8, prompt_len=(900, 1100), max_new=16, max_len=2048)
    assert chip_smoke.PARITY_LAYERS == {"zamba2_1p2b": chip_smoke.get_config("zamba2_1p2b").attn_every + 1}


def test_phase_trace_rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    cfg = dataclasses.replace(_tiny(), num_layers=1)
    out = chip_smoke.phase_trace(CPU, cfg, slots=2, prompt=12, steps=2)
    assert out["wall_ms"] > 0 and out["device_ms"] == 0  # no CUDA kernel runs on a CPU


def test_phase_trace_rehearsal_moe(monkeypatch):
    """deepseek-moe-16b's trace also times its MoE layers alone (a host clock here)."""
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    monkeypatch.setattr(chip_smoke, "time_ms", _host_ms)
    out = chip_smoke.phase_trace(CPU, _tiny("deepseek_moe_16b"), slots=2, prompt=12, steps=2)
    assert out["wall_ms"] > 0 and out["device_ms"] == 0
    assert set(out["moe_ms"]) == {"moe_layers_alone"}  # no device time to attribute on a CPU


@pytest.mark.parametrize("arch", ["zamba2_1p2b", "rwkv6_7b"])
def test_phase_trace_rehearsal_recurrent(arch, monkeypatch):
    """zamba2's and rwkv6's traces also run their Mamba2 / RWKV6 layers alone (a
    host clock here, and no device time to name on a CPU)."""
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    monkeypatch.setattr(chip_smoke, "time_ms", _host_ms)
    out = chip_smoke.phase_trace(CPU, _tiny(arch), slots=2, prompt=12, steps=2)
    assert out["wall_ms"] > 0 and out["device_ms"] == 0
    assert set(out["ssm_ms"]) == {"mamba2_layers_alone" if arch.startswith("zamba") else
                                  "rwkv6_layers_alone"}


def test_bound_picks_the_larger_time():
    ms, by = chip_smoke.bound(3.35e12, 0.0, torch.bfloat16)
    assert (ms, by) == (1e3, "bytes")
    ms, by = chip_smoke.bound(0.0, 989e12 * 2, torch.bfloat16)
    assert (ms, by) == (2e3, "operations")


def test_timing_reports_rate_and_share_of_bound():
    t = chip_smoke.timing("x", 0.05, 0.5, None, 3.35e12 * 0.025e-3, 1.0, torch.bfloat16)
    assert t["bound_by"] == "bytes" and abs(t["share_of_bound"] - 0.5) < 1e-12
    assert t["rate"] == "1675.0 GB/s"  # half of 3.35 TB/s
    t = chip_smoke.timing("q", 0.1, 1.0, 0.2, 1.0, 989e12 * 0.05e-3, torch.bfloat16)
    assert t["bound_by"] == "operations" and t["rate"].endswith("TFLOP/s")
    assert abs(t["share_of_bound"] - 0.5) < 1e-12
