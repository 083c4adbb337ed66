"""A rehearsal of `chip_smoke.py`'s mesh (c) and (d), cp serve and split phases on
the CPU at tiny sizes, one gloo process a mesh (data 1, model 1), as on the card.
A mesh of one computes what one device computes: the losses and logits equal
the single-device run's; where a config's path has kernels, the launch checks
then fail, as no kernel launches on a CPU."""

import dataclasses

import pytest

from test_torch_smoke import CPU, _host_ms, _tiny, chip_smoke
from torch_threads import one_thread  # noqa: F401


def test_phase_mesh_sp_rehearsal(tmp_path, capsys):
    """(c): zamba2 at 5 layers (two segments and a tail) under `rules_for(mesh)`,
    sequence parallelism on; the same losses as one device (a bar of 0)."""
    cfg = dataclasses.replace(_tiny("zamba2_1p2b"), num_layers=5)
    single = chip_smoke.train_run(cfg, device=CPU, batch=2, seq=64, steps=2, log=lambda *_: None)
    with pytest.raises(AssertionError, match=r"mesh \(c\): kernels never launched"):
        chip_smoke.phase_mesh(CPU, cfg, single["losses"], single["launches_per_step"][-1], 0.0, "cpu",
                              batch=2, seq=64, steps=2, backend="gloo",
                              init_method=f"file://{tmp_path}/pg", sp=True, label="(c)")
    out = capsys.readouterr().out
    assert "[mesh] (c) mesh (data 1, model 1), one process, sequence parallel," in out
    assert "max |diff| 0.000e+00" in out


def test_phase_mesh_depth_cut_rehearsal(tmp_path, capsys):
    """(d): rwkv6 (no kernel on its path) with int8 moments and remat full, against
    its single-device run at twice the floor of its bf16 loss; no kernel launches."""
    out = chip_smoke.phase_mesh_depth_cut(CPU, _tiny("rwkv6_7b"), "cpu", batch=1, seq=64, steps=2,
                                          backend="gloo", init_method=f"file://{tmp_path}/pg")
    assert not any(out["launches"].values())
    text = capsys.readouterr().out
    assert "[mesh] (d) single device," in text and "max |diff| 0.000e+00" in text


def test_phase_cp_serve_rehearsal(monkeypatch, tmp_path, capsys):
    """Phase 9 at qwen3's reduced width: the logits equal the single-device path's,
    the greedy tokens too, the cache placed as JAX's rules say; then the launch
    check."""
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    with pytest.raises(AssertionError, match="cp serve: 0 flash launches at the prefill"):
        chip_smoke.phase_cp_serve(CPU, _tiny("qwen3_14b"), "cpu", prompt=20, steps=4, backend="gloo",
                                  init_method=f"file://{tmp_path}/pg")
    out = capsys.readouterr().out
    assert "logits max |diff| against the single-device kernel path 0.0000e+00" in out
    # tp of 1 does not shard the kv heads (JAX's `cache_axes`): the length over (data, model)
    assert "greedy tokens identical" in out and "placed ['S(2)', 'S(2)']" in out


def test_phase_split_decode_rehearsal(monkeypatch):
    """Phase 10 at tiny shapes (dh 128 and 80): the plain (out, lse) of the parts
    joined equal the whole; empty parts at 2 and at 4 parts; the timing rows carry
    the JSON keys and the time without the LSE output."""
    monkeypatch.setattr(chip_smoke, "time_ms", _host_ms)
    monkeypatch.setattr(chip_smoke, "ROTATION", 2)
    out = chip_smoke.phase_split_decode(CPU, cases=((1, 2, 5, 256, 128, (110, 50)),
                                                    (1, 2, 4, 128, 80, (128, 30))))
    assert out["empty_parts"] >= 4 and out["lse"] <= 1e-5
    for t in out["timings"]:
        assert {"ms", "ms_without_lse", "plain_ms", "bound_ms", "bound_by", "shape"} <= t.keys()
