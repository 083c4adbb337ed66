"""A rehearsal of `chip_smoke.py`'s phase 12 (`sim`, SIM_NOTE) on the CPU.

(a) phase 5's serve at reduced width, then the simulated schedule against the
engine's; a schedule that differs must fail. (b) each config's cache at reduced
width against its leaves and the §3.5 formula, the allocation counted by
`test_torch_smoke_plan.LiveBytes` with each storage rounded up to the caching
allocator's 512-byte block, as the card's allocator does; a growth that
differs must fail. (c) the
simulated numbers of phase 5's nine serves at full width, from the prompt
lengths `launch.serve.run` draws, are the ones PERF.md predicts. (d) the two
command lines in subprocesses. (e) the DSE point.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from test_torch_smoke_plan import LiveBytes  # noqa: E402
from torch_threads import one_thread  # noqa: E402, F401

CPU = torch.device("cpu")
# PERF.md's prediction for phase 12 (c): admissions, decode steps, tok/s, prefill s
# an admission, decode ms a step
PREDICTED = {
    "qwen3-14b": (2, 62, 177.6, 0.3014, 13.530),
    "h2o-danube-1.8b": (2, 62, 252.2, 0.3882, 3.853),
    "pixtral-12b": (1, 15, 146.5, 0.2673, 11.297),
    "starcoder2-3b": (1, 15, 480.7, 0.0806, 3.499),
    "minitron-8b": (1, 15, 253.7, 0.1480, 6.956),
    "musicgen-large": (1, 15, 457.8, 0.0859, 3.592),
    "deepseek-moe-16b": (2, 30, 616.0, 0.0703, 2.242),
    "zamba2-1.2b": (2, 30, 840.4, 0.0433, 2.188),
    "rwkv6-7b": (2, 30, 243.8, 0.1652, 6.484),
}


def _serve(arch, monkeypatch, **kw):
    """Phase 5 at reduced width on the CPU. No kernel launches there, so the
    launch checks are told the path has none (rwkv6's case on the card)."""
    monkeypatch.setattr(chip_smoke, "used_kernels", lambda cfg: [])
    monkeypatch.setattr(chip_smoke, "attention_blocks", lambda cfg: 0)
    cfg = get_config(arch).reduced()
    traffic = dict(requests=7, slots=3, prompt_len=(5, 20), max_new=6, max_len=40, **kw)
    return cfg, chip_smoke.phase_serve(CPU, cfg, **traffic)


@pytest.mark.parametrize("arch", ["qwen3_14b", "deepseek_moe_16b", "zamba2_1p2b", "rwkv6_7b"])
def test_schedule_rehearsal(arch, monkeypatch):
    cfg, serve = _serve(arch, monkeypatch)
    assert serve["admissions"] == 3 and serve["admitted"] == [[0, 1, 2], [3, 4, 5], [6]]
    out = chip_smoke.phase_sim_schedule(cfg, serve)
    assert (out["sim"]["admissions"], out["sim"]["decode_steps"]) == (3, 15)
    assert all(v > 0 for v in [*out["sim"].values(), *out["measured"].values()])


def test_schedule_mismatch_fails(monkeypatch):
    cfg, serve = _serve("qwen3_14b", monkeypatch)
    for key, value, what in (("decode_steps", serve["decode_steps"] + 1, "decode steps"),
                             ("admitted", [[0, 1], [2, 3, 4], [5, 6]], "admissions"),
                             ("out_counts", [6] * 6 + [5], "outputs")):
        with pytest.raises(AssertionError, match=what):
            chip_smoke.phase_sim_schedule(cfg, {**serve, key: value})


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_rehearsal(arch):
    cfg = get_config(arch).reduced(dtype="bfloat16", param_dtype="bfloat16")  # as on the card
    mode = LiveBytes(block=chip_smoke.ALLOC_BLOCK)
    with mode:
        out = chip_smoke.phase_sim_kv(CPU, cfg, 3, 40, 10**6, allocated=lambda dev: mode.live)
    assert out["allocated"] >= out["leaves"] == out["formula"] > 0
    with pytest.raises(AssertionError, match="grew the allocation"):
        with LiveBytes(block=chip_smoke.ALLOC_BLOCK) as off:
            chip_smoke.phase_sim_kv(CPU, cfg, 3, 40, None,
                                    allocated=lambda dev: off.live + 512 if off.live else 0)


def _phase5_serve(arch: str, requests=8, prompt_len=(900, 1100), max_new=32, max_len=2048,
                  slots=4) -> dict:
    """What phase 5 keeps of a serve, from `launch.serve.run`'s draws at seed 0 (each
    request's length, then its tokens, from one generator), every request ending
    with its `max_new` tokens; no model runs."""
    rng = np.random.default_rng(0)
    lens = []
    for _ in range(requests):
        lens.append(int(rng.integers(prompt_len[0], prompt_len[1] + 1)))
        rng.integers(0, get_config(arch).vocab_size, size=lens[-1])
    return {"prompt_lens": lens, "max_new": max_new, "slots": slots, "max_len": max_len}


def test_predicted_numbers():
    """(c)'s simulated numbers for phase 5's exact prompts are PERF.md's prediction."""
    traffic = {"qwen3_14b": {}, **chip_smoke.SERVE_TRAFFIC}
    assert _phase5_serve("qwen3_14b")["prompt_lens"][:4] == [1070, 940, 1046, 943]
    for arch, kw in traffic.items():
        cfg = get_config(arch)
        res = chip_smoke._sim_of(cfg, _phase5_serve(arch, **kw))
        batches = chip_smoke.sim_admissions(res)
        served = {**_phase5_serve(arch, **kw), "decode_steps": res.decode_steps,
                  "admissions": len(batches), "admitted": batches,
                  "out_counts": [r.output for r in res.records], "prefill_seconds": 1.0,
                  "decode_seconds": 1.0, "tokens": 1, "seconds": 1.0}
        sim = chip_smoke.phase_sim_schedule(cfg, served)["sim"]
        got = (sim["admissions"], sim["decode_steps"], round(sim["tok_s"], 1),
               round(sim["prefill_s"], 4), round(sim["decode_ms"], 3))
        assert got == PREDICTED[cfg.name], cfg.name


def test_cli_rehearsal(tmp_path):
    out = chip_smoke.phase_sim_cli(args=chip_smoke.SIM_CLI[:-1] + ["20", "--sweep", "2,4"],
                                   out_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "sim.chunked.jsonl", "sim.continuous.jsonl", "sim.static.jsonl"]
    assert out["sim"][0].startswith("# qwen3-14b on H100-SXM")
    assert any(ln.startswith("per-replica utilization") for ln in out["report"])


def test_dse_rehearsal():
    pt = chip_smoke.phase_sim_dse("cpu")
    assert (pt["node"], pt["dram"], pt["net"]) == ("N5", "HBM3", "NDR-x8")
    assert 0.15 <= pt["f_core"] <= 0.72 and pt["time"] > 0


def test_sim_phase_configs_are_the_serves():
    """Phase 12 prices each of phase 5's nine serves with its own config."""
    names = {get_config(a).name for a in ("qwen3_14b", *chip_smoke.SERVE_TRAFFIC)}
    assert names == set(PREDICTED) and len(names) == 9
    assert dataclasses.is_dataclass(chip_smoke._sim_of(get_config("qwen3_14b"),
                                                       _phase5_serve("qwen3_14b")))
