"""The port's cell cost (`repro_torch.core.cellcost`) and collective inventory
(`repro_torch.core.hlo`) against JAX's (`repro.core.cellcost`, `repro.core.hlo`).

* `cell_cost` equals JAX's field for field, with `==`, on every arch, every
  shape `applicable` admits, three (dp, tp) and both optimizers; with
  `hw=H100_SXM` its flops are unchanged.
* The HLO text functions equal JAX's on `tests/test_substrate.py::SAMPLE_HLO`
  and on the HLO of a program JAX compiles for 4 host devices (a subprocess,
  since the device count is set before `import jax`): an all-gather, a psum, a
  psum_scatter and an all_to_all inside a `lax.scan` of N steps.
* The same collectives on the same shapes and dtypes, issued through the
  functional collectives in a Python loop of N steps on a fake 4-rank world
  under `CollectiveInventory`, give JAX's bytes per op, N times JAX's count,
  and JAX's `collective_traffic_bytes(summary, {1: N})` as `once_bytes`.
* A reduced qwen3 training step executed on (data 2, model 2) gloo processes
  under the inventory dispatches, on every rank, the collectives that the
  dry-run's trace of the same cell on a fake 2x2 world records.
"""

import contextlib
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.core import cellcost as jcellcost
from repro.core import hlo as jhlo
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import cellcost, hlo
from repro_torch.core.hardware import H100_SXM
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, rules_for
from test_substrate import SAMPLE_HLO
from torch_dist import spawn
from torch_threads import one_thread  # noqa: F401

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = [(16, 16), (32, 16), (1, 1)]
N = 3  # the scan's trip count, and the port's loop's

# XLA:CPU normalizes bf16 collectives to float32 (it converts before the
# all-gather), so a bf16 gather would come out of the compiler as an f32 one;
# the program is float32 throughout, and the port's dtypes are held to JAX's
# byte counts by `test_inventory_bytes_are_the_hlo_result_bytes`.
JAX_PROGRAM = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import sys
    sys.path.insert(0, {str(SRC)!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))

    def body(c, _):
        ag = jax.lax.all_gather(c, "x", axis=0, tiled=True)           # (32, 16)
        ps = jax.lax.psum(c, "x")                                      # (8, 16)
        rs = jax.lax.psum_scatter(c, "x", scatter_dimension=0, tiled=True)  # (2, 16)
        a2a = jax.lax.all_to_all(c, "x", 0, 0, tiled=True)            # (8, 16)
        return c + ag[8:16] + ps + jnp.tile(rs, (4, 1)) + a2a, None

    def f(x):
        return jax.lax.scan(body, x, None, length={N})[0]

    g = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("x"), out_specs=P("x")))
    print(g.lower(jnp.zeros((32, 16), jnp.float32)).compile().as_text())
""")


@pytest.fixture(scope="module")
def jax_hlo() -> str:
    """The compiled HLO text of `JAX_PROGRAM`, compiled once for the module."""
    res = subprocess.run([sys.executable, "-c", JAX_PROGRAM], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.fixture
def fake_world():
    def make(n):
        dryrun.init_fake_world(n)
        return dist.group.WORLD
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- cell cost


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_cell_cost_equals_jax(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    n = 0
    for name, shape in tconfigs.SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        assert tconfigs.applicable(cfg, shape) == jconfigs.applicable(jcfg, jshape)
        if not tconfigs.applicable(cfg, shape)[0]:
            continue
        for dp, tp in MESHES:
            for opt_8bit in (False, True):
                ours = cellcost.cell_cost(cfg, shape, dp=dp, tp=tp, opt_8bit=opt_8bit)
                theirs = jcellcost.cell_cost(jcfg, jshape, dp=dp, tp=tp, opt_8bit=opt_8bit)
                assert vars(ours) == vars(theirs), (name, dp, tp, opt_8bit)
                n += 1
    assert n >= 3 * 2 * 3


def test_cell_cost_on_h100_keeps_the_flops():
    """`hw` moves the DRAM bytes (the GEMMs' L2 blocking), never the flops."""
    moved = 0
    for arch in tconfigs.ARCHS:
        cfg = tconfigs.get_config(arch)
        for shape in tconfigs.SHAPES.values():
            if not tconfigs.applicable(cfg, shape)[0]:
                continue
            for dp, tp in MESHES:
                tpu = cellcost.cell_cost(cfg, shape, dp=dp, tp=tp)
                gpu = cellcost.cell_cost(cfg, shape, dp=dp, tp=tp, hw=H100_SXM)
                assert (gpu.flops_per_device, gpu.model_flops_global, gpu.tokens) == (
                    tpu.flops_per_device, tpu.model_flops_global, tpu.tokens)
                moved += gpu.dram_bytes_per_device != tpu.dram_bytes_per_device
    assert moved > 0


# ---------------------------------------------------------------- HLO text


def _text_functions_agree(text: str, trips) -> dict:
    assert [vars(o) for o in hlo.parse_collectives(text)] == [
        vars(o) for o in jhlo.parse_collectives(text)]
    summary = hlo.collective_summary(text)
    assert summary == jhlo.collective_summary(text)
    for t in trips:
        assert hlo.collective_traffic_bytes(summary, t) == jhlo.collective_traffic_bytes(summary, t)
    return summary


def test_text_functions_equal_jax_on_sample_hlo():
    summary = _text_functions_agree(SAMPLE_HLO, [1, 7, {1: 10, 2: 100}, {2: 3}])
    assert summary["n_ops"] == 3 and hlo.COLLECTIVE_KINDS == jhlo.COLLECTIVE_KINDS


def test_text_functions_equal_jax_on_a_compiled_program(jax_hlo):
    summary = _text_functions_agree(jax_hlo, [N, {1: N}, {1: N, 2: 5}])
    kinds = {a["kind"]: a for a in summary["ops"]}
    # XLA:CPU emits each of the four as its own kind, once, inside the scan's body
    assert set(kinds) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert all(a["count"] == 1 and a["loop_depth"] == 1 for a in kinds.values())


def _funcol_step(c, group):
    ag = funcol.all_gather_single(c, 0, group)
    ps = funcol.all_reduce(c, "sum", group)
    rs = funcol.reduce_scatter_single(c, "sum", 0, group)
    a2a = funcol.all_to_all_single(c, None, None, group)
    return c + ag[8:16] + ps + rs.repeat(4, 1) + a2a


@pytest.mark.parametrize("fake", [False, True], ids=["real tensors", "FakeTensorMode"])
def test_inventory_of_the_same_collectives_equals_jax(jax_hlo, fake_world, fake):
    """`JAX_PROGRAM`'s collectives through the functional collectives, N times in a
    Python loop on a fake 4-rank world: kind by kind JAX's bytes per op and N x its
    count, and JAX's trip-count total as `once_bytes`."""
    group = fake_world(4)
    inventory = hlo.CollectiveInventory()
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else contextlib.nullcontext()
    with mode, inventory:
        c = torch.zeros(8, 16)
        for _ in range(N):
            c = _funcol_step(c, group)
    jsum = jhlo.collective_summary(jax_hlo)
    ours = inventory.summary()
    theirs = {a["kind"]: a for a in jsum["ops"]}
    assert {a["kind"] for a in ours["ops"]} == set(theirs)
    for a in ours["ops"]:
        j = theirs[a["kind"]]
        assert a["loop_depth"] == 0 and a["count"] == N * j["count"], a
        assert a["bytes"] // a["count"] == j["bytes"] // j["count"] and a["bytes"] == N * j["bytes"]
    assert ours["once_bytes"] == jhlo.collective_traffic_bytes(jsum, {1: N}) == N * 3200
    assert ours["loop_bytes_per_iter"] == 0 and ours["n_ops"] == N * jsum["n_ops"]


def _c10d_calls(x):
    """c10d's calls, each with the kind and the result the inventory must record."""
    ag = torch.empty((4 * x.shape[0],) + x.shape[1:], dtype=x.dtype)
    rs = torch.empty((x.shape[0] // 4,) + x.shape[1:], dtype=x.dtype)
    a2a, parts = torch.empty_like(x), [torch.empty_like(x) for _ in range(4)]
    return [
        ("all-reduce", x, lambda: dist.all_reduce(x)),
        ("all-gather", ag, lambda: dist.all_gather_into_tensor(ag, x)),
        ("all-gather", parts, lambda: dist.all_gather(parts, x)),
        ("reduce-scatter", rs, lambda: dist.reduce_scatter_tensor(rs, x)),
        ("all-to-all", a2a, lambda: dist.all_to_all_single(a2a, x)),
        ("collective-broadcast", x, lambda: dist.broadcast(x, 0)),
        ("collective-permute", x, lambda: (dist.send(x, 1), dist.recv(x, 1))),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.int8])
def test_inventory_bytes_are_the_hlo_result_bytes(fake_world, dtype):
    """c10d's in-place calls and the functional collectives map to their kinds; a
    send is its peer's recv, counted once; each op's bytes are its result's, and
    JAX's parser reads the same bytes off the shape the inventory writes."""
    group = fake_world(4)
    x = torch.ones(8, 16, dtype=dtype)
    calls = _c10d_calls(x)
    inventory = hlo.CollectiveInventory()
    with inventory:
        for _, _, call in calls:
            call()
        funcol.all_gather_single(x, 0, group).wait()
    assert [o.kind for o in inventory.ops] == [k for k, _, _ in calls] + ["all-gather"]
    for op, (_, result, _) in zip(inventory.ops, calls):
        result = result if isinstance(result, list) else [result]
        assert op.bytes == sum(t.numel() * t.element_size() for t in result)
    for op in inventory.ops:
        assert op.loop_depth == 0 and jhlo._shape_bytes(op.shape) == op.bytes, op


# ------------------------------------------------- executed against traced

CELL = ShapeSpec("train_64", 64, 8, "train")
POLICY = (1, "selective")


def executed_qwen3(rank, world):
    """One rank of a reduced qwen3 training step on (data 2, model 2), under the
    inventory: its summary and loss."""
    cfg = tconfigs.get_config("qwen3-14b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = dryrun.execute_cell(cfg, CELL, mesh, rules_for(mesh, CELL), device="cpu",
                              policy=POLICY)
    return {"collectives": out["collectives"], "loss": out["metrics"]["loss"],
            "shapes": [(o.shape, o.bytes) for o in out["ops"]]}


def test_executed_step_dispatches_the_traced_collectives(tmp_path, fake_world):
    """Every rank of the executed step dispatches, kind by kind in count and bytes,
    what `trace_cell` of the same cell records on a fake 2x2 world, in JAX's
    `collective_summary` shape."""
    ranks = spawn(executed_qwen3, 4, tmp_path / "pg", timeout=150)
    fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = tconfigs.get_config("qwen3-14b").reduced()
    traced = dryrun.trace_cell(cfg, CELL, mesh, rules_for(mesh, CELL), policy=POLICY,
                               log=lambda *_: None)["collectives"]
    assert set(traced) == {"ops", "once_bytes", "loop_bytes_per_iter", "n_ops"}
    assert all(set(a) == {"kind", "loop_depth", "count", "bytes"} for a in traced["ops"])
    kinds = {a["kind"] for a in traced["ops"]}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= kinds <= set(hlo.COLLECTIVE_KINDS)
    assert traced["n_ops"] > 0 and traced["once_bytes"] > 0 and traced["loop_bytes_per_iter"] == 0
    for r in ranks:
        assert r["collectives"] == traced
        assert torch.isfinite(torch.tensor(r["loss"]))
        assert all(jhlo._shape_bytes(s) == b for s, b in r["shapes"])
    assert len({r["loss"] for r in ranks}) == 1

