"""A rehearsal of `chip_smoke.py`'s phase 13 (`cluster`, CLUSTER_NOTE) on the CPU.

(b) the handoff at `reduced()` in bf16, as on the card, for qwen3-14b,
h2o-danube (its prompt past the reduced window of 16), zamba2-1.2b and rwkv6-7b:
the bytes copied are `kv_handoff_bytes`, and the decode from the NaN-filled copy
is the source's, bit for bit; a copy that moves other bytes, leaves a live slot
behind, or hands over a different state must fail. (c) the simulated numbers of
the fleet at full width, from the draws phase 13 makes at seed 0, are the ones
PERF.md predicts, and so are the handoff's bytes and prices. (d) the three
command lines in subprocesses. Phase 13 (a) is rehearsed in
`tests/test_torch_cluster_engine.py`.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import comm
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models.transformer import cache_leaves
from repro_torch.sim import ServingCostModel
from torch_threads import one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
HANDOFF = {"qwen3_14b": 21, "h2o_danube_1p8b": 23, "zamba2_1p2b": 21, "rwkv6_7b": 21}
# PERF.md's prediction for phase 13 (c), from the port's simulator at seed 0:
# rids of each admission, decode steps, prefill s an admission, decode ms a step,
# makespan s, tok/s
PREDICTED = [([[0, 2], [4], [6], [8], [10]], 95, 0.1146, 2.534, 0.8139, 202.7),
             ([[1, 3], [5], [7], [9], [11]], 86, 0.1148, 2.616, 0.7991, 206.5)]
# the handoff's bytes at the prompts phase 13 draws at seed 0, and their price in ms
# over NVLink4 and NDR-IB
PREDICTED_HANDOFF = {"qwen3-14b": (1070, 175_308_800, 0.466, 4.130),
                     "h2o-danube-1.8b": (4541, 251_658_240, 0.666, 5.926),
                     "zamba2-1.2b": (1070, 102_196_224, 0.275, 2.410),
                     "rwkv6-7b": (1070, 34_078_720, 0.097, 0.807)}


@pytest.fixture
def no_launches(monkeypatch):
    monkeypatch.setattr(chip_smoke, "used_kernels", lambda cfg: [])
    monkeypatch.setattr(chip_smoke, "attention_blocks", lambda cfg: 0)


def _case(arch):
    cfg = get_config(arch).reduced(dtype="bfloat16", param_dtype="bfloat16")  # as on the card
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=HANDOFF[arch])
    return cfg, toks.astype(np.int32)


@pytest.mark.parametrize("arch", list(HANDOFF))
def test_handoff_rehearsal(arch, no_launches):
    cfg, toks = _case(arch)
    out = chip_smoke.phase_cluster_handoff(CPU, cfg, toks, 40, steps=6)
    assert out["bytes"] > 0 and out["prompt"] == len(toks)
    if cfg.sliding_window is not None:
        assert len(toks) > cfg.sliding_window  # the whole ring moves


def test_handoff_copies_the_live_positions_only():
    """The copy leaves every attention position past the prompt as it was (NaN) and
    fills every other leaf."""
    cfg, toks = _case("zamba2_1p2b")
    model = chip_smoke.Model(cfg)
    params = model.init(0, CPU)
    _, P = model.prefill(params, {"tokens": torch.from_numpy(toks[None])}, 40)
    D = model.init_cache(1, 40, CPU)
    for _, t, _ in cache_leaves(D):
        t.fill_(float("nan"))
    chip_smoke.handoff_copy(P, D, len(toks))
    for path, t, axis in cache_leaves(D):
        if path.endswith(("/k", "/v")):
            assert not t.narrow(axis + 1, 0, len(toks)).isnan().any(), path
            assert t.narrow(axis + 1, len(toks), 40 - len(toks)).isnan().all(), path
        else:
            assert not t.isnan().any(), path
    assert D["pos"] == P["pos"] == len(toks)


def test_handoff_refuses_other_bytes_and_other_state(no_launches, monkeypatch):
    cfg, toks = _case("qwen3_14b")
    real = chip_smoke.handoff_copy

    def short(P, D, prompt):  # one live position left behind: a NaN is read
        return real(P, D, prompt - 1)

    monkeypatch.setattr(chip_smoke, "handoff_copy", short)
    with pytest.raises(AssertionError, match="B copied.*read a NaN"):
        chip_smoke.phase_cluster_handoff(CPU, cfg, toks, 40, steps=4)

    def counted_twice(P, D, prompt):
        return 2 * real(P, D, prompt)

    monkeypatch.setattr(chip_smoke, "handoff_copy", counted_twice)
    with pytest.raises(AssertionError, match="B copied, kv_handoff_bytes gives"):
        chip_smoke.phase_cluster_handoff(CPU, cfg, toks, 40, steps=4)

    def perturbed(P, D, prompt):
        n = real(P, D, prompt)
        D["layers"]["kv"]["v"][:, :, :prompt] *= 2  # a different state, every byte counted
        return n

    monkeypatch.setattr(chip_smoke, "handoff_copy", perturbed)
    with pytest.raises(AssertionError, match="tokens|logits differ"):
        chip_smoke.phase_cluster_handoff(CPU, cfg, toks, 40, steps=4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_decode_never_reads_past_n_valid(dtype):
    """The plain decode version reads only the first n_valid slots, as the kernel
    does: a NaN tail gives the bits of a zero tail (on the card:
    `tests/test_torch_gpu.py::test_decode_attention_nan_tail_is_never_read`)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
               for s in ((2, 2, 3, 32), (2, 2, 64, 32), (2, 2, 64, 32)))
    outs = []
    for fill in (0.0, float("nan")):
        k[:, :, 37:], v[:, :, 37:] = fill, fill
        outs.append(decode_attention_ref(q, k, v, 37, lse=True))
    assert torch.isfinite(outs[1][0].float()).all()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_jax_oracle_reads_the_dead_slots():
    """ROADMAP C14, pinned: JAX's plain decode (`repro/kernels/decode_attention/ref.py`)
    weights the slots at or past n_valid by 0 and still reads them, so a NaN there
    is its output; the port's plain version and the kernel read none."""
    import jax.numpy as jnp

    from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref

    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in ((1, 2, 3, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    k[:, :, 37:], v[:, :, 37:] = np.nan, np.nan
    assert np.isnan(np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 37))).all()
    port = decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), 37)
    assert torch.isfinite(port).all()


def test_predicted_numbers():
    """(c)'s simulated numbers, from phase 13's draws at seed 0, are PERF.md's."""
    cfg = get_config("h2o_danube_1p8b")
    lens, news, prompts = chip_smoke.cluster_traffic(cfg, 0)
    assert lens[:3] == [4541, 4455, 4404] and news[:3] == [24, 28, 40]
    assert [len(p) for p in prompts] == lens
    cres = chip_smoke.simulate_fleet(cfg, lens, news, ["mixed"] * 2, 2)
    got = []
    for res in cres.replica_results:
        s = chip_smoke.sim_numbers(res)
        got.append((chip_smoke.sim_admissions(res), s["decode_steps"], round(s["prefill_s"], 4),
                    round(s["decode_ms"], 3), round(s["makespan_s"], 4), round(s["tok_s"], 1)))
    assert got == PREDICTED
    assert round(cres.makespan, 4) == 0.8139
    for arch in chip_smoke.HANDOFF:
        c = get_config(arch)
        prompt = len(chip_smoke.handoff_prompt(c, 0, chip_smoke.HANDOFF[arch]["prompt_len"]))
        b = ServingCostModel(c, H100_SXM, tp=1, ctx_quantum=1).kv_handoff_bytes(prompt)
        priced = tuple(round(1e3 * comm.p2p(b, net), 3) for net in (H100_SXM.net[0],
                                                                    H100_SXM.net[-1]))
        assert (prompt, b, *priced) == PREDICTED_HANDOFF[c.name], c.name
    disagg = chip_smoke.phase_cluster_disagg(cfg, lens, news, 251_658_240, 2)
    assert (disagg.xfer_count, disagg.xfer_bytes) == (12, 3_019_898_880)
    assert (round(disagg.xfer_seconds, 6), round(disagg.makespan, 4)) == (0.071116, 1.2121)
    with pytest.raises(AssertionError, match="disaggregated fleet moved"):
        chip_smoke.phase_cluster_disagg(cfg, lens, news, 251_658_240 - 2, 2)


def test_cli_rehearsal(tmp_path):
    out = chip_smoke.phase_cluster_cli(args=[*chip_smoke.CLUSTER_CLI, "--requests", "40"],
                                       plan=[*chip_smoke.CLUSTER_PLAN, "--requests", "40",
                                             "--plan-max-replicas", "3"], out_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cl.colocated.jsonl",
                                                         "cl.disaggregated.jsonl"]
    assert out["cluster"][0].startswith("# qwen3-14b cluster | 4 replicas [h100]")
    assert any(ln.startswith("per-replica utilization") for ln in out["report"])
    assert out["plan"][0].startswith("# capacity plan: qwen3-14b @ 32 qps")
