"""A rehearsal of `chip_smoke.py`'s training phases (7 and the mesh phase) on the
CPU, at a tiny size; zamba2's train parity is in `test_torch_smoke_train_zamba2.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_smoke import CPU, _host_ms, _tiny, chip_smoke
from torch_threads import one_thread  # noqa: F401


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


def train_parity_rehearsal(arch, monkeypatch):
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


@pytest.mark.parametrize("arch", ["h2o_danube_1p8b", "qwen3_14b"])
def test_phase_train_parity_rehearsal(arch, monkeypatch):
    train_parity_rehearsal(arch, monkeypatch)


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


def _mesh_single(cfg, **shape):
    return chip_smoke.train_run(cfg, device=CPU, remat="selective", log=lambda *_: None, **shape)


def test_phase_mesh_rehearsal(tmp_path, capsys):
    """Phase 8 (a) on the CPU: a 2-layer danube on a (data 1, model 1) mesh of one gloo
    process, through `launch.train.run(mesh=...)`. A mesh of one computes what one
    device computes, op for op: the losses equal the single-device run's exactly
    (a bar of 0); then the launch check fails, as no kernel launches on a CPU."""
    cfg = dataclasses.replace(_tiny("h2o_danube_1p8b"), attn_impl="chunked")
    single = _mesh_single(cfg, batch=2, seq=32, steps=2)
    with pytest.raises(AssertionError, match="never launched"):
        chip_smoke.phase_mesh(CPU, cfg, single["losses"], single["launches_per_step"][-1], 0.0, "cpu",
                              batch=2, seq=32, steps=2, backend="gloo",
                              init_method=f"file://{tmp_path}/pg")
    out = capsys.readouterr().out
    assert "[mesh] (a) mesh (data 1, model 1)" in out and "max |diff| 0.000e+00" in out


def test_phase_mesh_ranks_rehearsal(monkeypatch, tmp_path, capsys):
    """Phase 8 (b) on the CPU: two gloo processes on (data 1, model 2), each on half of
    the heads of a 2-layer danube; the collectives probed first, every one taken;
    the ranks' losses equal, step 1 within bf16-sized bars of one device; then the
    launch check fails."""
    monkeypatch.setattr(chip_smoke, "MESH_DIR", tmp_path / "mesh")
    cfg = dataclasses.replace(_tiny("h2o_danube_1p8b"), attn_impl="chunked")
    with pytest.raises(AssertionError, match=r"\(b\) rank 0: kernels never launched"):
        chip_smoke.phase_mesh_ranks(CPU, cfg, 1e-2, 1e-2, "cpu", ranks=2, batch=2, seq=32, steps=2,
                                    timeout=120)
    out = capsys.readouterr().out
    probe = "{'all_reduce': 'ok', 'all_gather_into_tensor': 'ok', 'reduce_scatter_tensor': 'ok', " \
        "'DTensor Partial->Replicate (all_reduce)': 'ok', 'DTensor Shard->Replicate " \
        "(all_gather_into_tensor)': 'ok', 'DTensor Partial->Shard (reduce_scatter_tensor)': 'ok'}"
    assert f"[mesh] (b) gloo across 2 processes on cpu tensors: {probe}" in out
    assert out.count("[mesh] (b) mesh (data 1, model 2), rank") == 2
