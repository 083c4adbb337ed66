"""CPU tests of the benchmark's harness: its arithmetic, its loaders, its result
line, and that a run's check fails when the timed path is broken underneath.

  PYTHONPATH=src python -m pytest -q bench/tests

The tiny cells (`tiny.py`) run the real harness, metrics and reference on the
CPU through the port's plain paths; `gpu`-marked tests need the card."""

from __future__ import annotations

import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from benchkit import harness, serve
from benchkit import yardstick as Y
from benchkit.spec import Spec
from tiny import SERVE, make_root

CONFIGS = ("qwen3-14b", "h2o-danube-1.8b")
D = Spec().family("dense")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(scope="module")
def spec(root):
    return Spec(root, root / "bench")


def run(spec, cell, trace=False, **kw):
    return harness.run_cell(spec, cell, seed=2**31 + 11, seconds=kw.pop("seconds", 2.0),
                            trace=trace, device="cpu", t0=time.perf_counter(), **kw)


# ------------------------------------------------------------------ arithmetic
def _cfg(name):
    return {**json.loads((Spec().dir / "configs" / f"{name}.json").read_text()), "name": name}


def test_product_params_hand_counts():
    """MFU_NOTE's product parameters, by hand from the published sizes."""
    q = 40 * (5120 * 5120 + 2 * 5120 * 1024 + 5120 * 5120 + 3 * 5120 * 17408 + 2 * 5120 + 2 * 128) \
        + 5120 + 5120 * 151936
    d = 24 * (2560 * 2560 + 2 * 2560 * 640 + 2560 * 2560 + 3 * 2560 * 6912 + 2 * 2560) \
        + 2560 + 2560 * 32000
    assert D.product_params(_cfg("qwen3-14b")) == q
    assert D.product_params(_cfg("h2o-danube-1.8b")) == d


@pytest.mark.parametrize("name", CONFIGS)
def test_params_match_the_program(name):
    """Every parameter, and the product ones, against the program's own count."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import count_params

    cfg, pc = _cfg(name), get_config(name)
    assert D.total_params(cfg) == count_params(pc)
    assert D.product_params(cfg) == count_params(pc) - pc.vocab_size * pc.d_model


def test_live_pairs_and_flops_by_hand():
    assert Y.live_pairs(5, None) == 15
    assert Y.live_pairs(6, 4) == 1 + 2 + 3 + 4 + 4 + 4
    assert Y.live_pairs(6144, 4096) == 4096 * 4097 // 2 + 2048 * 4096
    assert Y.live_pairs(1024, 4096) == 1024 * 1025 // 2
    d = _cfg("h2o-danube-1.8b")
    n = D.product_params(d)
    assert D.train_step_flops(d, 4, 6144) == 6 * n * 4 * 6144 + 14 * 80 * 16_779_264 * 4 * 32 * 24
    assert D.train_step_flops(d, 24, 1024) == 6 * n * 24 * 1024 + 14 * 80 * 524_800 * 24 * 32 * 24


def test_flash_work_by_hand():
    """(flops, bytes) of tiny calls, counted by hand: bf16 q, k, v, o (and the LSE)."""
    # B 1, Hq 2, Hkv 1, S 3, dh 4: 6 live pairs a head
    assert Y.flash_fwd_work(1, 2, 1, 3, 4, None, False) == (4 * 4 * 6 * 2, 2 * 3 * 4 * (2 + 2 + 1 + 1))
    assert Y.flash_fwd_work(1, 2, 1, 3, 4, None, True)[1] == 2 * 3 * 4 * 6 + 4 * 2 * 3
    # backward: q, o, dout, dq (Hq each), k, v, dk, dv (Hkv each), the LSE
    assert Y.flash_bwd_work(1, 2, 1, 3, 4, 2) == (10 * 4 * 5 * 2, 2 * 3 * 4 * (4 * 2 + 4 * 1) + 4 * 2 * 3)
    assert Y.bound_s(989e12, 0) == pytest.approx(1.0)
    assert Y.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_serve_flops_by_hand():
    q = _cfg("qwen3-14b")
    n, head = D.product_params(q), 5120 * 151936
    assert D.prompt_flops(q, 10) == 2 * (n - head) * 10 + 2 * head + 4 * 128 * 40 * 40 * 55
    assert D.decode_flops(q, 7) == 2 * n + 4 * 128 * 40 * 40 * 7
    d = _cfg("h2o-danube-1.8b")
    n, head = D.product_params(d), 2560 * 32000
    assert D.prompt_flops(d, 5000) == (2 * (n - head) * 5000 + 2 * head
                                       + 4 * 80 * 32 * 24 * Y.live_pairs(5000, 4096))
    assert D.decode_flops(d, 5000) == 2 * n + 4 * 80 * 32 * 24 * 4096


# ------------------------------------------------------------------ engine numbers
def _req(n_prompt, tokens):
    return types.SimpleNamespace(prompt=np.zeros(n_prompt, np.int32), out_tokens=list(tokens))


def test_itl_and_tokens_from_stamps():
    """Tokens and gaps of the calls completed in the window; the cut call left out."""
    calls = [{"requests": [_req(10, [1, 2, 3]), _req(20, [4])],
              "stamps": [[0.0, 0.5, 1.5], [0.2]], "cut": False, "end": 2.0},
             {"requests": [_req(10, [5, 6])], "stamps": [[2.5, 2.6]], "cut": True, "end": 3.0}]
    n = {"admissions": 1, "admitted": [[0, 1]], "decode_steps": 2, "prefill_seconds": 0.3,
         "decode_seconds": 0.2}
    r = serve.summarize(D, _cfg("h2o-danube-1.8b"), {"slots": 4}, calls, [n, n], 0.0)
    assert r["tokens"] == 4 and r["attempted"] == 2 and r["calls"] == 1 and r["calls_s"] == 2.0
    assert r["itl_ms"] == [500.0, 1000.0]
    spec = Spec()
    r["kind"] = "serve"
    assert spec.reader("itl_p95_ms")(r) == pytest.approx(975.0)
    assert spec.reader("out_tok_s.serve")(r) == 2.0
    assert spec.reader("decode_ms_per_step.serve")(r) == pytest.approx(100.0)
    assert spec.reader("prefill_s_per_admission.serve")(r) == pytest.approx(0.3)


def test_prefill_useful_share_from_admitted():
    """Admitted prompt tokens over slots x the admission's longest prompt."""
    reqs = [_req(10, []), _req(20, []), _req(5, [])]
    calls = [{"requests": reqs, "stamps": [[], [], []], "cut": False, "end": 1.0}]
    counters = [{"admissions": 2, "admitted": [[0, 1], [2]], "decode_steps": 0,
                 "prefill_seconds": 0.0, "decode_seconds": 0.0}]
    r = serve.summarize(D, _cfg("h2o-danube-1.8b"), {"slots": 4}, calls, counters, 0.0)
    assert (r["prompt_tokens"], r["prefill_rows_tokens"]) == (35, 4 * 20 + 4 * 5)
    assert Spec().reader("prefill_useful_share.serve")(r) == pytest.approx(35.0)


def test_schedule_is_the_engines():
    """The worked-out schedule against the port's engine at a tiny size: each
    admission's requests, and the cache position of every decode step."""
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import Request, ServeEngine

    from tiny import TINY

    cfg = {**TINY, "name": "tiny"}
    model = serve.Recorder(Model(harness.port_config(D, cfg)))
    seen = []
    real = model._model.decode_step

    def decode_step(params, cache, tokens, *a, **k):
        seen.append((cache["pos"], tokens[:, 0].tolist()))
        return real(params, cache, tokens, *a, **k)

    model._model.decode_step = decode_step
    from benchkit import weights as W

    engine = ServeEngine(model, W.make(D, cfg, 0, "cpu", head_fp32=True), max_len=256, slots=3)
    lens, news = [12, 30, 7, 25, 9, 16, 3], [4, 2, 6, 1, 3, 5, 2]
    reqs = [Request(prompt=np.arange(1, n + 1, dtype=np.int32), max_new_tokens=m)
            for n, m in zip(lens, news)]
    model.start(reqs, 0, float("inf"))
    engine.serve(reqs)
    admitted, plan = serve.schedule(lens, news, 3)
    assert admitted == engine.admitted
    # the decode steps' positions are those the schedule feeds tokens at, and each
    # request is fed all but its last token
    assert [pos for pos, _ in seen] == sorted({p for _, fed in plan for p in fed})
    assert len(seen) == engine.decode_steps
    assert [len(fed) for _, fed in plan] == [n - 1 for n in news]
    assert [S for S, _ in plan] == [max(lens[i] for i in a) for a in admitted for i in a]


def test_cache_view_by_hand():
    """A ring of 4 slots: prompt 0-2 at slots 0-2; fed tokens at positions 5, 6, 7
    (slots 1, 2, 3). Token 1 is overwritten by position 5, token 2 by 6; slot 3
    is never written before position 7 writes it, so the tokens at 5 and 6 each
    attend one zero slot."""
    until, gaps = serve.cache_view(np.array([0, 1, 2, 5, 6, 7]), 3, 4)
    assert until.tolist() == [6, 3, 4, 6, 6, 6]
    assert gaps.tolist() == [0, 0, 0, 1, 1, 0]
    # no ring: nothing is overwritten, and the slots 3 and 4 stay zero
    until, gaps = serve.cache_view(np.array([0, 1, 2, 5, 6, 7]), 3, None)
    assert until.tolist() == [6] * 6 and gaps.tolist() == [0, 0, 0, 2, 2, 2]


# ------------------------------------------------------------------ loaders
def test_cells_and_metrics_by_name(spec):
    real = Spec()
    names = {w["name"] for w in real.data["workloads"]}
    assert names == {"h2o-danube-1.8b.serve.docs", "h2o-danube-1.8b.train.s6k",
                     "h2o-danube-1.8b.train.s1k"}
    for w in real.data["workloads"]:
        kind = real.traffic(w["traffic"])["kind"]
        assert callable(real.driver(kind).run)
        assert set(real.limits(w["name"])) and real.config(w["config"])["reference"] == "dense"
        fam = real.family(real.config(w["config"])["family"])
        for f in ("sizes", "refuse", "port_fields", "layer_leaves", "top_leaves", "product_params",
                  "total_params", "train_step_flops", "prompt_flops", "decode_flops"):
            assert callable(getattr(fam, f)), f
        for trace in (False, True):
            for m in real.metrics(w["name"], trace):
                assert callable(real.reader(m["name"]))
    assert [m["name"] for m in real.metrics("h2o-danube-1.8b.serve.docs", False)] == [
        "itl_p95_ms", "setup_s"]
    assert "mfu.train" in [m["name"] for m in real.metrics("h2o-danube-1.8b.train.s1k", True)]


def test_an_added_cell_is_picked_up(root, spec):
    """The tiny root adds configuration, traffic and cell files and entries in
    BENCHMARK.json, and edits no file of the benchmark's folder."""
    real = Spec()
    for sub in ("benchkit", "families", "metrics", "reference"):
        for f in (real.dir / sub).glob("*.py"):
            assert (spec.dir / sub / f.name).read_bytes() == f.read_bytes()
    assert spec.cell("tiny.serve")["traffic"] == "test.serve"
    assert spec.traffic("test.serve") == SERVE
    assert "served_gap" in spec.limits("tiny.serve")


def test_configs_agree_with_the_program():
    for c in Spec().data["configs"]:
        cfg = Spec().config(c["name"])
        assert harness.port_config(Spec().family(cfg["family"]), cfg).name == c["name"]


def test_a_file_the_program_cannot_run_is_refused():
    """qwen3-14b's published RMSNorm eps is 1e-06; the port fixes 1e-05."""
    cfg = _cfg("qwen3-14b")
    assert cfg["rms_norm_eps"] == 1e-06
    with pytest.raises(ValueError, match="eps"):
        harness.port_config(D, cfg)
    assert D.refuse({**cfg, "rms_norm_eps": 1e-05}) is None


def test_forbidden_modules_by_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_x", types.ModuleType("repro_torch_x"))
    monkeypatch.setitem(sys.modules, "reprox.y", types.ModuleType("reprox.y"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "repro"]


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert harness.main(["--workload", "h2o-danube-1.8b.serve.docs", "--seed", "1",
                         "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------------ whole runs
@pytest.mark.parametrize("cell", ["tiny.serve", "tiny.train", "tiny-swa.serve", "tiny-swa.train"])
def test_result_line(spec, cell):
    for trace in (False, True):
        out = run(spec, cell, trace)
        assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(out)[-1] == "checks"
        assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
        want = {m["name"] for m in spec.metrics(cell, trace)}
        assert set(out["metrics"]) <= want
        assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
        if trace:
            assert {"busy_s", "window_s"} <= set(out["device"])
            assert all(len(out["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
            if cell.endswith("serve"):  # the serving rate stands per layer
                assert "out_tok_s.serve" in out["metrics"]
        else:
            assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
        json.loads(json.dumps(out))


def test_controls_fail_the_tiny_limits(spec):
    """The control, the reference in fp8 in the program's place, and for training
    half of each batch left out, each fail a number that sound runs pass."""
    for cell in ("tiny.serve", "tiny.train"):
        out = run(spec, cell, controls=True)
        lim = spec.limits(cell)
        assert out["correct"]
        for name, readings in out["controls"].items():
            assert any(v > lim[k] for k, v in readings.items()), (cell, name, readings)


def test_broken_token_fails(spec, monkeypatch):
    """A token altered where it is produced: one decode step's logits favour token 7."""
    from repro_torch.models.transformer import Model

    real, calls = Model.decode_step, []

    def decode_step(self, *a, **k):
        logits, cache = real(self, *a, **k)
        calls.append(1)
        if len(calls) % 5 == 3:
            logits[:, 7] += 100.0
        return logits, cache

    monkeypatch.setattr(Model, "decode_step", decode_step)
    assert run(spec, "tiny.serve")["correct"] is False


def test_unchanged_state_fails(spec, monkeypatch):
    """A step that returns its state unchanged."""
    from repro_torch.train import train_step

    monkeypatch.setattr(train_step, "adamw_update",
                        lambda p, g, o, c: (p, o, {"grad_norm": torch.zeros(()),
                                                  "lr": torch.zeros(())}))
    out = run(spec, "tiny.train")
    assert out["correct"] is False and out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_fails(spec, monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.models.transformer import Model

    real = Model.loss

    def loss(self, params, batch, remat=None):
        half = {k: v[:len(v) // 2] for k, v in batch.items()}
        return real(self, params, half, remat=remat)

    monkeypatch.setattr(Model, "loss", loss)
    assert run(spec, "tiny.train")["correct"] is False


# ------------------------------------------------------------------ on the card
@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["tiny64.serve", "tiny64.train"])
def test_tiny_cell_on_the_card(spec, cell):
    """A tiny cell at dh 64 through the kernels on the card, traced: every number
    compared is read, the device was busy, and the flash rooflines come out of the
    trace within 105%. (Its limits were set on the CPU's plain paths; the cells'
    own runs decide `correct` on the card.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = harness.run_cell(spec, cell, seed=2**31 + 23, seconds=10.0, trace=True, device="cuda",
                           t0=time.perf_counter())
    assert all(c["value"] is not None for c in out["checks"].values()), out["checks"]
    assert out["device"]["busy_s"] > 0
    rooflines = [v["value"] for k, v in out["metrics"].items() if "roofline" in k]
    assert len(rooflines) == (1 if cell.endswith("serve") else 2), out["metrics"]
    assert all(0 < v <= 105 for v in rooflines), out["metrics"]
