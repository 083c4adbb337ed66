"""`chip_smoke.py`'s phase 4 and phase 7 rehearsals at deepseek-moe-16b's full width
on the CPU (2 layers; the vocabulary and the expert width cut): the routing
margin of the bf16 parity and the routing-aware train parity."""

import dataclasses

from test_torch_smoke import CPU, chip_smoke
from torch_threads import one_thread  # noqa: F401


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
