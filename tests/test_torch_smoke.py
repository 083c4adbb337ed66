"""A rehearsal of `chip_smoke.py`'s phases 3-6 on the CPU, at a tiny size.

The same phase functions run with `device="cpu"`, where every kernel wrapper
takes its plain version; a host clock stands in for the CUDA event timer.
The serve phase must then fail its launch check, since no kernel launched.
"""

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

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


def test_moe_gap_margin_covers_the_bf16_perturbation():
    """Phase 4 on the CPU at deepseek-moe-16b's full width (2 layers; the
    vocabulary and the expert width cut, which the router's input does not
    see): the bf16 perturbation of the router's k-th minus (k+1)-th gap stays
    within half of MOE_GAP_MARGIN (ROUTING_NOTE), the float32 paths route
    alike, and every bf16 routing that differs is a near tie."""
    full = chip_smoke.get_config("deepseek_moe_16b")
    cfg = dataclasses.replace(full, num_layers=2, vocab_size=512,
                              moe=dataclasses.replace(full.moe, d_ff=16))
    out = chip_smoke.phase_parity(CPU, cfg)
    assert max(out["gap_shift"].values()) < chip_smoke.MOE_GAP_MARGIN / 2
    assert out["routing_diff"] > 0 and out["fp32_err"] <= out["fp32_tol"]
    assert 0 <= out["max_abs_err"] <= out["tolerance"]
    assert 0 < out["drop_frac_published"] < 1  # capacity 1.25 drops, dropless did not


def test_phase_bwd_kernels_rehearsal(monkeypatch):
    """Phase 7's backward kernels at tiny shapes: every row carries the JSON keys;
    the flash bound counts 10 dh flops a live pair at the bf16 peak; the zamba2
    and deepseek training rows, and the fused RMSNorm backward timed beside
    F.rms_norm's backward of the sum."""
    monkeypatch.setattr(chip_smoke, "time_ms", _host_ms)
    rec = chip_smoke.phase_bwd_kernels(CPU, danube=(1, 4, 2, 128, 80, 64), qwen=(1, 4, 2, 64, 128, None),
                                       dh64=(1, 4, 4, 64, 64, None), zamba2=(1, 4, 4, 96, 64, None),
                                       deepseek=(1, 2, 2, 80, 128, None),
                                       norms=((48, 256), (16, 512), (40, 128)), fused_timed=((40, 128),),
                                       qk_rows=64, sweeps=False)
    assert set(rec) == set(chip_smoke.TRAIN_KERNELS)
    for r in rec.values():
        for t in [r, *r["extra"]]:
            assert {"ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "shape"} <= t.keys()
            assert t["library_ms"] is not None and t["bound_ms"] > 0
        assert r["max_abs_err"] == 0.0  # the CPU runs the plain versions against themselves
    fa = rec["flash_attention_bwd"]
    assert fa["shape"] == "q (1,4,128,80) kv heads 2 bf16 causal window 64"
    flops = 10 * 80 * chip_smoke.live_pairs(128, 64) * 4
    nbytes = (4 * 4 + 4 * 2) * 128 * 80 * 2 + 4 * 128 * 4
    assert fa["bound_ms"] == chip_smoke.bound(nbytes, flops, torch.bfloat16)[0]
    assert [t["shape"] for t in fa["extra"]][2:] == ["q (1,4,96,64) kv heads 4 bf16 causal",
                                                    "q (1,2,80,128) kv heads 2 bf16 causal"]
    norm = rec["rmsnorm_bwd"]
    assert norm["bound_by"] == "bytes"
    assert [t["shape"] for t in norm["extra"]] == ["x, dy (16,512) bf16", "x, dy (40,128) bf16",
                                                   "x, dy (40,128) bf16, fused: res, dr"]
    fused = norm["extra"][-1]  # x, res, dy, dr read and dx written, the gains
    assert fused["bound_ms"] == chip_smoke.bound(5 * 40 * 128 * 2 + 2 * 128 * 4, 9 * 40 * 128,
                                                 torch.bfloat16)[0]


@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen3_14b", "zamba2_1p2b"])
def test_phase_train_parity_rehearsal(arch, monkeypatch):
    """danube through the flash twin (attn_impl chunked, past its window), qwen3 with
    its qk-norms, zamba2 at PARITY_LAYERS' depth (a segment and a tail when reduced
    too: 3 layers at attn_every 2) past a Mamba2 chunk. On the CPU the kernel path
    runs the kernels' plain versions, which still differ from the plain path where
    the fused residual norm reads the unrounded sum: within the bars, about one
    floor apart. Then the remat policies, identical, and the products selective
    remat saves: zamba2's one segment's, the shared block's seven and two a Mamba2
    layer (the unwrapped tail saves none)."""
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    cfg = dataclasses.replace(_tiny(arch), attn_impl="chunked")
    if arch in chip_smoke.PARITY_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=cfg.attn_every + 1)
    out = chip_smoke.phase_train_parity(CPU, cfg, batch=1, seq=320 if cfg.attn_every else 64)
    assert 0 < out["loss_err"] <= 2 * out["floor"] and out["worst_leaf_ratio"] <= 2
    assert set(out["peak_gib"]) == {"none", "selective", "full"}
    assert out["saved_products"] == (7 + 2 * cfg.attn_every if cfg.attn_every else 7 * cfg.num_layers)


def test_phase_train_parity_moe_rehearsal(monkeypatch, capsys):
    """deepseek-moe-16b's train parity at full width on the CPU (2 layers; the
    vocabulary and the expert width cut, which the router's input does not see):
    float32 routed alike with every leaf within TRAIN_F32_TOL; bf16 routing-aware
    (TRAIN_ROUTING_NOTE), where tokens do route differently, so only the leaves
    MOE_UNREACHED are compared, each within twice its floor; then the remat
    policies at the published capacity."""
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    full = chip_smoke.get_config("deepseek_moe_16b")
    cfg = dataclasses.replace(full, num_layers=2, vocab_size=512,
                              moe=dataclasses.replace(full.moe, d_ff=16))
    out = chip_smoke.phase_train_parity_moe(CPU, cfg, batch=1, seq=256)
    assert out["routing_diff"] > 0 and out["fp32_worst_leaf"] <= chip_smoke.TRAIN_F32_TOL
    assert 0 <= out["ce_err"] <= 2 * out["floor"] and out["worst_leaf_ratio"] <= 2
    assert out["compared"] and all(k.startswith(chip_smoke.MOE_UNREACHED) for k in out["compared"])
    assert {"layers/moe/wi", "lm_head/w", "final_norm/scale"} <= set(out["compared"])
    assert "identical" in capsys.readouterr().out
    # the dense head layer's seven products; the MoE layer's q, k, v, o, router, shared three
    assert out["saved_products"] == 7 + 8


def test_phase_remat_identity_rehearsal_rwkv6(monkeypatch):
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    out = chip_smoke.phase_remat_identity(CPU, _tiny("rwkv6_7b"), batch=1, seq=96)
    assert out["saved_products"] == 2 * 11  # each layer: 8 in the time mix, 3 in the channel mix


def test_phase_resume_rehearsal(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "CKPT_DIR", tmp_path / "ckpt")
    cfg = dataclasses.replace(_tiny("h2o_danube_1p8b"), attn_impl="chunked")
    out = chip_smoke.phase_resume(CPU, cfg, seq=64)
    assert out["bitwise"] and len(out["losses"]) == 2
    assert not (tmp_path / "ckpt").exists()  # cleaned up


@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "zamba2_1p2b", "deepseek_moe_16b"])
def test_phase_train_run_rehearsal_fails_without_launches(arch):
    cfg = _tiny(arch)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_train_run(CPU, cfg, "cpu", batch=2, seq=32, steps=2, warmup=1)


def test_phase_train_run_rehearsal_rwkv6(capsys):
    """rwkv6's training path has no kernel: the check accepts the empty set and says
    so; int8 moments, remat full."""
    out = chip_smoke.phase_train_run(CPU, _tiny("rwkv6_7b"), "cpu", batch=1, seq=64, steps=2, warmup=1,
                                     remat="full", optimizer="adamw8bit")
    assert len(out["losses"]) == 2 and not any(out["launches"].values()) and out["moe"] == {}
    assert "no kernel on its path: none launched" in capsys.readouterr().out


def test_training_constants():
    """The runs: danube's SyntheticLM(32000, 6144, 2) as before; zamba2 at full depth,
    deepseek at 4 layers (its dense layer and 3 MoE layers) with the published
    capacity (C 960 at 8192 tokens), rwkv6 with JAX's remat full and int8 moments;
    each a full-width config. The parity shapes pass danube's window and the
    attn_chunk (the flash path), zamba2's a Mamba2 chunk."""
    runs = chip_smoke.TRAIN_RUNS
    assert runs["h2o_danube_1p8b"] == dict(batch=2, seq=6144, steps=6, warmup=2, remat="selective")
    assert runs["rwkv6_7b"]["remat"] == "full" and runs["rwkv6_7b"]["optimizer"] == "adamw8bit"
    danube = chip_smoke.get_config("h2o_danube_1p8b")
    assert chip_smoke.TRAIN_PARITY["h2o_danube_1p8b"]["seq"] > danube.sliding_window
    for arch in ("qwen3_14b", "zamba2_1p2b", "deepseek_moe_16b"):
        assert chip_smoke.TRAIN_PARITY[arch]["seq"] > chip_smoke.get_config(arch).attn_chunk
    assert chip_smoke.TRAIN_PARITY["zamba2_1p2b"]["seq"] > 256
    deepseek = chip_smoke.train_config("deepseek_moe_16b")
    assert deepseek.num_layers == 4 and deepseek.moe.first_k_dense == 1
    assert chip_smoke.moe.capacity(deepseek.moe, 2 * 4096) == 960
    for arch in runs:
        full = chip_smoke.get_config(arch)
        assert chip_smoke.train_config(arch).d_model == full.d_model
    assert chip_smoke.train_config("zamba2_1p2b") == chip_smoke.get_config("zamba2_1p2b")
    assert set(chip_smoke.TRAIN_PATH) <= set(chip_smoke.KERNELS) | set(chip_smoke.TRAIN_KERNELS)
    assert "decode_attention" not in chip_smoke.TRAIN_PATH
    assert chip_smoke.train_kernels(chip_smoke.get_config("rwkv6_7b")) == []
    assert chip_smoke.train_kernels(deepseek) == list(chip_smoke.TRAIN_PATH)


def test_product_params():
    """MFU_NOTE's parameters: deepseek at 4 layers runs 0.55 B of its 2.27 B (top 6
    of 64 routed experts, no token table), zamba2 its shared block 7 times."""
    get = chip_smoke.get_config
    deepseek = chip_smoke.train_config("deepseek_moe_16b")
    assert chip_smoke.Model(deepseek).param_count() == 2_267_039_744
    assert chip_smoke.product_params(deepseek) == 552_093_696
    zamba2 = get("zamba2_1p2b")
    shared = sum(int(np.prod(pd.shape)) for path, pd in
                 chip_smoke._walk(chip_smoke.param_defs(zamba2)) if path.startswith("shared/"))
    table = zamba2.vocab_size * zamba2.d_model
    assert chip_smoke.product_params(zamba2) == 1_180_459_648 - table * (not zamba2.tie_embeddings) + 6 * shared
    rwkv6 = get("rwkv6_7b")
    assert chip_smoke.product_params(rwkv6) == 7_577_018_368 - rwkv6.vocab_size * rwkv6.d_model


def test_phase_train_trace_rehearsal(monkeypatch):
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    out = chip_smoke.phase_train_trace(CPU, _tiny("h2o_danube_1p8b"), batch=2, seq=32)
    assert out["wall_ms"] > 0 and out["device_ms"] == 0 and out["kernels_ms"] == {}
