"""A rehearsal of `chip_smoke.py`'s phase 14 (`cost`, COST_NOTE) on the CPU.

(a) The lint gate and `--list-rules` in subprocesses, as the phase runs them.
(b) The cell-cost lines with the measured numbers stubbed: each row is
`cell_cost`'s own for the H100. (c) A 2-layer reduced h2o-danube step on a
one-rank gloo world against the dry-run's trace of it: the inventories are
equal (and a difference fails the phase), then the launch check fails, as no
kernel launches on a CPU.
"""

import dataclasses

import pytest

from repro_torch.configs.base import ShapeSpec
from repro_torch.core.cellcost import cell_cost
from repro_torch.core.hardware import H100_SXM
from repro_torch.launch import dryrun
from repro_torch.lint import all_rules
from test_torch_smoke import CPU, _tiny, chip_smoke
from torch_threads import one_thread  # noqa: F401


def test_phase_lint_rehearsal(capsys):
    codes = chip_smoke.phase_lint()
    assert codes == [r.code for r in all_rules()] and len(codes) == chip_smoke.LINT_RULES
    assert "[cost] (a) repro_torch.lint: clean (1 path(s) checked); --list-rules: 11 rules" in \
        capsys.readouterr().out


def test_phase_cost_rehearsal(capsys):
    danube = chip_smoke.get_config("h2o_danube_1p8b")
    rwkv = chip_smoke.get_config("rwkv6_7b")
    runs = {"danube": (danube, chip_smoke.TRAIN_RUNS["h2o_danube_1p8b"]),
            "rwkv": (rwkv, chip_smoke.TRAIN_RUNS["rwkv6_7b"])}
    trains = {"danube": {"step_s": 0.75}, "rwkv": {"step_s": 25.0}}
    serves = {"danube": {"prefill_seconds": 0.5, "admissions": 2, "decode_seconds": 1.0,
                         "decode_steps": 40}}
    plan = {"flops": 22.0e12, "model_flops": 18.0e12}
    danube2 = dataclasses.replace(danube, num_layers=2)
    rows = chip_smoke.phase_cost("cpu", serves, trains, {"danube": (danube, 4, 4400, 32)}, runs,
                                 plan, danube2)
    want = {
        "train danube": cell_cost(danube, ShapeSpec("danube", 6144, 2, "train"), dp=1, tp=1,
                                  hw=H100_SXM),
        "train rwkv": cell_cost(rwkv, ShapeSpec("rwkv", 4096, 1, "train"), dp=1, tp=1,
                                opt_8bit=True, hw=H100_SXM),
        "prefill danube": cell_cost(danube, ShapeSpec("d", 4400, 4, "prefill"), dp=1, tp=1,
                                    hw=H100_SXM),
        "decode danube": cell_cost(danube, ShapeSpec("d", 4416, 4, "decode"), dp=1, tp=1,
                                   hw=H100_SXM),
        "train h2o-danube-1.8b L2": cell_cost(danube2, ShapeSpec("p", 6144, 2, "train"), dp=1,
                                              tp=1, hw=H100_SXM),
    }
    assert set(rows) == set(want)
    for label, c in want.items():
        r = rows[label]
        assert (r["flops"], r["dram_bytes"]) == (c.flops_per_device, c.dram_bytes_per_device)
        assert (r["compute_s"], r["memory_s"]) == (c.flops_per_device / 989e12,
                                                   c.dram_bytes_per_device / 3.35e12)
    assert rows["train rwkv"]["dram_bytes"] != cell_cost(
        rwkv, ShapeSpec("rwkv", 4096, 1, "train"), dp=1, tp=1, hw=H100_SXM).dram_bytes_per_device
    assert rows["prefill danube"]["measured prefill s an admission"] == 0.25
    assert rows["decode danube"]["measured decode ms a step"] == 25.0
    assert rows["train h2o-danube-1.8b L2"]["traced flops"] == 22.0e12
    assert capsys.readouterr().out.count("[cost] (b) ") == 5


def _different(execute):
    """`execute_cell` whose inventory gains one all-reduce the trace never saw."""
    def run(*a, **k):
        out = execute(*a, **k)
        c = out["collectives"]
        c["ops"] = c["ops"] + [{"kind": "all-reduce", "loop_depth": 0, "count": 1, "bytes": 4}]
        c["once_bytes"] += 4
        c["n_ops"] += 1
        return out
    return run


@pytest.mark.parametrize("case", ["as run", "a collective more"])
def test_phase_inventory_rehearsal(case, tmp_path, monkeypatch, capsys):
    cfg = dataclasses.replace(_tiny("h2o_danube_1p8b"), attn_impl="chunked")
    if case == "a collective more":
        monkeypatch.setattr(dryrun, "execute_cell", _different(dryrun.execute_cell))
    match = "never launched" if case == "as run" else "!= the trace's"
    with pytest.raises(AssertionError, match=match):
        chip_smoke.phase_inventory(CPU, "cpu", cfg=cfg, layers=2, batch=2, seq=32, backend="gloo",
                                   init_method=f"file://{tmp_path}/pg")
    out = capsys.readouterr().out
    assert "[cost] (c) h2o-danube-1.8b L2 B2 x S32, remat selective" in out
    assert ("equal;" in out) == (case == "as run")
    zero = "{'all-reduce': (0, 0), 'all-gather': (0, 0), 'reduce-scatter': (0, 0), " \
        "'all-to-all': (0, 0), 'collective-permute': (0, 0)}"
    assert f"fake one-rank world {zero}" in out
