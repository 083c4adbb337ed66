"""The port's copy of the analytical model (`repro_torch.core`) against `repro.core`.

The nine modules are copies over the port's `ModelConfig`: every plan, memory
breakdown, step time, latency and GEMM time must equal JAX's for the same
config and hardware (times within 1e-12 relative, the rest exactly), and the
training launcher's `--auto-plan` must print what JAX's prints, line for line.
"""

import dataclasses
import sys

import pytest
from hypkit import given, settings, st

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.core import hardware as jhw
from repro.core import memory as jmem
from repro.core import paper_data as jpaper
from repro.core import parallelism as jpar
from repro.core import planner as jplanner
from repro.core import predict as jpredict
from repro.launch import train as jtrain
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import hardware as thw
from repro_torch.core import memory as tmem
from repro_torch.core import paper_data as tpaper
from repro_torch.core import parallelism as tpar
from repro_torch.core import planner as tplanner
from repro_torch.core import predict as tpredict
from repro_torch.launch import train as ttrain
from torch_threads import one_thread  # noqa: F401

REL = 1e-12
# every hardware of the registry, once each (the aliases name the same specs)
HARDWARE = sorted({spec.name: name for name, spec in thw._REGISTRY.items()}.values())
PAPER = [*tpaper.GPT_CONFIGS, *tpaper.LLAMA2_CONFIGS]


def _configs(name):
    """(the port's config, JAX's) of an arch or a paper config."""
    if name in ARCHS:
        return get_config(name), jax_get_config(name)
    table = "GPT_CONFIGS" if name in tpaper.GPT_CONFIGS else "LLAMA2_CONFIGS"
    return getattr(tpaper, table)[name], getattr(jpaper, table)[name]


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0), (a, b)


def _same_breakdown(a, b):
    assert a.meta == b.meta and set(a.parts) == set(b.parts)
    for k in a.parts:
        _close(a.parts[k], b.parts[k])


def test_registries_match():
    assert set(thw._REGISTRY) == set(jhw._REGISTRY)
    for name in thw._REGISTRY:
        assert dataclasses.asdict(thw.get_hardware(name)) == \
            dataclasses.asdict(jhw.get_hardware(name))
    assert sorted(ARCHS) == sorted(JAX_ARCHS) and len(HARDWARE) == 5
    for name in PAPER:
        ours, theirs = _configs(name)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _plans(mod, cfg, hw, **kw):
    try:
        return mod.plan(cfg, hw, **kw)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("name", [*ARCHS, *PAPER])
def test_plan_matches_jax_on_every_hardware(name):
    """plan() at 64 chips, batch 64 x 2048 (and 8 chips for the small configs'
    other regime): equal mappings and memory, times within 1e-12."""
    ours_cfg, jax_cfg = _configs(name)
    for hw in HARDWARE:
        for chips in (8, 64):
            kw = dict(global_batch=chips, seq=2048, max_tp=64)
            ours = _plans(tplanner, ours_cfg, thw.get_hardware(hw), n_chips=chips, **kw)
            theirs = _plans(jplanner, jax_cfg, jhw.get_hardware(hw), n_chips=chips, **kw)
            if isinstance(theirs, str):  # no feasible mapping: the same refusal
                assert ours == theirs
                continue
            assert [dataclasses.asdict(p.mapping) for p in ours] == \
                [dataclasses.asdict(p.mapping) for p in theirs]
            for a, b in zip(ours, theirs, strict=True):
                assert a.memory == b.memory and a.fits == b.fits
                _close(a.time, b.time)
                assert a.describe() == b.describe()
                assert set(a.breakdown) == set(b.breakdown)
                for k in a.breakdown:
                    _close(a.breakdown[k], b.breakdown[k])


MAPPINGS = dict(
    name=st.sampled_from([*ARCHS, *PAPER]),
    hw=st.sampled_from(HARDWARE),
    dp=st.sampled_from([1, 2, 4]),
    tp=st.sampled_from([1, 2, 4, 8]),
    pp=st.sampled_from([1, 2, 4]),
    microbatch=st.sampled_from([1, 2]),
    recompute=st.sampled_from(["none", "selective", "full"]),
    schedule=st.sampled_from(["1f1b", "gpipe", "interleaved"]),
    zero1=st.booleans(),
    opt_8bit=st.booleans(),
    sp=st.booleans(),
)


@settings(max_examples=40, deadline=None)
@given(**MAPPINGS)
def test_memory_and_step_time_match_jax(name, hw, dp, tp, pp, microbatch, recompute, schedule,
                                        zero1, opt_8bit, sp):
    ours_cfg, jax_cfg = _configs(name)
    kw = dict(dp=dp, tp=tp, pp=pp, sp=sp, microbatch=microbatch, recompute=recompute,
              schedule=schedule, zero1=zero1, opt_8bit=opt_8bit)
    batch = dp * microbatch * 4
    ours = tmem.training_memory(ours_cfg, global_batch=batch, seq=1024, **kw)
    theirs = jmem.training_memory(jax_cfg, global_batch=batch, seq=1024, **kw)
    assert ours.as_dict() == theirs.as_dict()
    tm, jm = tpar.Mapping(**kw), jpar.Mapping(**kw)
    _same_breakdown(tpredict.train_step_time(ours_cfg, thw.get_hardware(hw), tm,
                                             global_batch=batch, seq=1024),
                    jpredict.train_step_time(jax_cfg, jhw.get_hardware(hw), jm,
                                             global_batch=batch, seq=1024))


@settings(max_examples=30, deadline=None)
@given(name=st.sampled_from([*ARCHS, *PAPER]), hw=st.sampled_from(HARDWARE),
       tp=st.sampled_from([1, 2, 8]), batch=st.sampled_from([1, 4, 16]),
       prompt=st.sampled_from([200, 1000]), gen=st.sampled_from([16, 200]),
       decode=st.booleans())
def test_inference_latency_and_gemm_table_match_jax(name, hw, tp, batch, prompt, gen, decode):
    ours_cfg, jax_cfg = _configs(name)
    ours_hw, jax_hw = thw.get_hardware(hw), jhw.get_hardware(hw)
    a = tpredict.inference_latency(ours_cfg, ours_hw, tp=tp, batch=batch, prompt=prompt, gen=gen)
    b = jpredict.inference_latency(jax_cfg, jax_hw, tp=tp, batch=batch, prompt=prompt, gen=gen)
    _same_breakdown(a, b)
    _close(a.ttft, b.ttft)
    _close(a.tpot, b.tpot)
    ours = tpredict.gemm_table(ours_cfg, ours_hw, tp=tp, batch=batch, S=prompt, decode=decode)
    theirs = jpredict.gemm_table(jax_cfg, jax_hw, tp=tp, batch=batch, S=prompt, decode=decode)
    assert len(ours) == len(theirs)
    for x, y in zip(ours, theirs):
        assert (x.name, x.bound) == (y.name, y.bound)
        for f in ("t", "t_compute", "t_dram", "t_l2", "flops", "dram_bytes"):
            _close(getattr(x, f), getattr(y, f))


def test_planner_feasible_and_sorted():
    """`tests/test_core_model.py::test_planner_feasible_and_sorted` on the port's copy."""
    plans = tplanner.plan(tpaper.GPT_CONFIGS["gpt-175b"], thw.A100_80G, 64, global_batch=64,
                          seq=2048, max_tp=8)
    assert plans and all(p.fits for p in plans)
    times = [p.time for p in plans]
    assert times == sorted(times)
    for p in plans:
        assert p.mapping.devices == 64


def test_planner_oom_raises():
    """`tests/test_core_model.py::test_planner_oom_raises` on the port's copy."""
    with pytest.raises(ValueError):
        tplanner.plan(tpaper.GPT_CONFIGS["gpt-1008b"], thw.A100_80G, 8, global_batch=8,
                      seq=2048, max_tp=8)


@pytest.mark.parametrize("argv", [
    ["--arch", "gpt-175b", "--auto-plan", "--chips", "1024", "--batch", "1024"],
    ["--arch", "qwen3-14b", "--auto-plan", "--chips", "8", "--hardware", "h100"],
])
def test_auto_plan_prints_what_jax_prints(argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    jtrain.main()
    theirs = capsys.readouterr().out.splitlines()
    ttrain.main()
    ours = capsys.readouterr().out.splitlines()
    assert len(ours) >= 2 and ours[0].startswith("auto-plan: ")
    assert ours == theirs
