"""The port's dry-run (`repro_torch.launch.dryrun`) against JAX's (`repro.launch.dryrun`).

The cell definitions (`SHAPES`, `SMOKE_SHAPES`, `applicable`, `input_specs`),
the training policy and the batch specs must equal JAX's; every placement the
dry-run builds must follow JAX's sanitized specs; a full-size cell traces on a
fake world of 256 ranks; and a sweep resumes from its cached cells and goes on
past a cell that raises. The traces of every family's reduced config on fake
2x4 and 2x2x2 worlds are in `test_torch_dryrun_cells.py`.

Each test that needs a world makes a fake one (`fake_world`) and destroys it
after, so no process group outlives the test in this worker.
"""

import json
import math
import types

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro import configs as jconfigs
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.launch import dryrun as jdry
from repro.launch import mesh as jmesh
from repro.models.transformer import Model as JaxModel
from repro.parallel import axes as jaxes
from repro.train import optimizer as jopt
from repro_torch import configs as tconfigs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.models.transformer import Model
from repro_torch.parallel import axes as taxes
from torch_threads import one_thread  # noqa: F401

PRODUCTION = {"16x16": (("data", "model"), (16, 16)),
              "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture
def fake_world():
    """A fake world of `n` ranks for the test (`dryrun.init_fake_world`), destroyed
    after it."""
    def make(n):
        dryrun.init_fake_world(n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _standins(axes, shape):
    """(JAX's stand-in mesh, the port's) of one mesh: a `shape` dict is all that
    JAX's `use_mesh`, `axes_size` and `sanitize_pspec` read."""
    return (types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes),
            types.SimpleNamespace(shape=shape, mesh_dim_names=axes))


def _entries(spec, rank):
    entries = tuple(spec)
    return entries + (None,) * (rank - len(entries))


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


def _torch_leaves(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, tuple)):
            out.update(_torch_leaves(v, path))
        else:
            out[path] = v
    return out


def test_shapes_match_jax():
    for name in ("SHAPES", "SMOKE_SHAPES"):
        ours, theirs = getattr(tconfigs, name), getattr(jconfigs, name)
        assert {k: vars(v) for k, v in ours.items()} == {k: vars(v) for k, v in theirs.items()}


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_applicable_and_input_specs_match_jax(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for table in ("SHAPES", "SMOKE_SHAPES"):
        for name, shape in getattr(tconfigs, table).items():
            jshape = getattr(jconfigs, table)[name]
            assert tconfigs.applicable(cfg, shape) == jconfigs.applicable(jcfg, jshape)
            ours, theirs = tconfigs.input_specs(cfg, shape), jconfigs.input_specs(jcfg, jshape)
            assert list(ours) == list(theirs)
            for k, t in ours.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == theirs[k].shape
                assert str(t.dtype).removeprefix("torch.") == jnp.dtype(theirs[k].dtype).name


@pytest.mark.parametrize("mesh", list(PRODUCTION))
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_train_policy_and_batch_specs_match_jax(arch, mesh):
    """`pick_train_policy` (with JAX's per-arch overrides and budget) and
    `batch_pspecs`, for every train shape, under each package's `rules_for` on a
    stand-in of the production mesh."""
    jm, tm = _standins(*PRODUCTION[mesh])
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dryrun.ARCH_TRAIN_OVERRIDES == jdry.ARCH_TRAIN_OVERRIDES
    over = dryrun.ARCH_TRAIN_OVERRIDES.get(arch, {})
    for table in ("SHAPES", "SMOKE_SHAPES"):
        for name, shape in getattr(tconfigs, table).items():
            jshape = getattr(jconfigs, table)[name]
            with jaxes.use_mesh(jm, jmesh.rules_for(jm, jshape)):
                jspecs = {k: tuple(v) for k, v in jdry.batch_pspecs(jcfg, jshape).items()}
                jpolicy = jdry.pick_train_policy(jcfg, jshape, dict(over))
            with taxes.use_mesh(tm, tmesh.rules_for(tm, shape)):
                tspecs = dryrun.batch_pspecs(cfg, shape)
                tpolicy = dryrun.pick_train_policy(cfg, shape, dict(over))
            assert tspecs == jspecs
            if shape.kind == "train":
                assert tpolicy == jpolicy


def _jax_specs(arch, shape_name, axes, sizes, table="SMOKE_SHAPES", reduced=True):
    """JAX's sanitized specs and shapes of a cell's params, moments (train) or cache
    (decode), on a stand-in of the mesh, under JAX's `rules_for`."""
    jm, _ = _standins(axes, sizes)
    jcfg = jconfigs.get_config(arch)
    jcfg = jcfg.reduced() if reduced else jcfg
    jshape = getattr(jconfigs, table)[shape_name]
    model = JaxModel(jcfg)
    rules = jmesh.rules_for(jm, jshape)
    cp = bool(rules.cp)
    out = {}
    if jshape.kind == "decode":  # shapes off the mesh: JAX's init places by a real mesh
        cshapes = model.cache_shapes(jshape.global_batch, jshape.seq_len, cp=cp)
    with jaxes.use_mesh(jm, rules):
        pshapes = model.pshapes()
        out["params"] = (jaxes.sanitize_spec_tree(model.pspecs(), pshapes, jm), pshapes)
        if jshape.kind == "train":
            tcfg = JaxTrainConfig(optimizer=dryrun.ARCH_TRAIN_OVERRIDES.get(arch, {}).get(
                "optimizer", "adamw"))
            oshapes = jax.eval_shape(lambda p: jopt.adamw_init(p, tcfg), pshapes)
            out["opt"] = (jaxes.sanitize_spec_tree(jopt.opt_state_specs(model.pspecs(), pshapes,
                                                                        tcfg), oshapes, jm),
                          oshapes)
        elif jshape.kind == "decode":
            out["cache"] = (jaxes.sanitize_spec_tree(model.cache_pspecs(cp=cp), cshapes, jm),
                            cshapes)
    return out


@pytest.mark.parametrize("mesh", [(("data", "model"), (2, 4)),
                                  (("pod", "data", "model"), (2, 2, 2))])
@pytest.mark.parametrize("arch", ["qwen3_14b", "deepseek_moe_16b", "arctic_480b", "zamba2_1p2b",
                                  "rwkv6_7b", "pixtral_12b", "musicgen_large"])
def test_every_placement_follows_jax_specs(arch, mesh, fake_world):
    """The state `build_state` places for each cell kind, leaf by leaf: the DTensor's
    placements are those of JAX's sanitized spec, its global shape JAX's, and the
    per-rank parameter bytes the sum over JAX's specs and shapes."""
    axes, sizes = mesh
    fake_world(math.prod(sizes))
    dm = tmesh.make_mesh(sizes, axes, "cpu")
    cfg = tconfigs.get_config(arch).reduced()
    for name in ("train_4k", "decode_32k", "long_500k"):
        shape = tconfigs.SMOKE_SHAPES[name]
        jax_specs = _jax_specs(arch, name, axes, sizes)
        rules = tmesh.rules_for(dm, shape)
        tcfg = TrainConfig(optimizer=dryrun.ARCH_TRAIN_OVERRIDES.get(arch, {}).get("optimizer",
                                                                                    "adamw"))
        with taxes.use_mesh(dm, rules), FakeTensorMode():
            state = dryrun.build_state(Model(cfg, kernels=False), shape, dm, tcfg, bool(rules.cp))
        for part, (specs, shapes) in jax_specs.items():
            ours = _torch_leaves(state[part])
            # JAX's cache position is an int32 scalar leaf, the port's a host int
            jspecs = {k: v for k, v in _jax_leaves(specs).items() if k != "pos"}
            jshapes = _jax_leaves(shapes)
            assert set(jspecs) == {k for k, v in ours.items() if isinstance(v, torch.Tensor)}, part
            jbytes = 0
            for path, spec in jspecs.items():
                t, jshape = ours[path], jshapes[path]
                entries = _entries(spec, len(jshape.shape))
                assert tuple(t.shape) == jshape.shape, path
                if isinstance(t, DTensor):
                    assert tuple(t.placements) == taxes.placements(entries, dm), path
                else:  # a scalar leaf (the step count): replicated in JAX
                    assert all(e is None for e in entries), path
                local = [n // math.prod(sizes[axes.index(a)] for a in taxes.entry_axes(e))
                         for n, e in zip(jshape.shape, entries)]
                jbytes += math.prod(local) * jnp.dtype(jshape.dtype).itemsize
            if part == "params":
                assert dryrun.local_bytes(state["params"]) == jbytes


def test_full_size_decode_cell_traces(fake_world):
    """qwen3-14b decode_32k on the one-pod production mesh (16 x 16 of a fake world of
    256 ranks): ok, this rank's cache a 256th of the whole, collectives counted."""
    fake_world(256)
    trace, mesh, model = dryrun.lower_cell("qwen3_14b", "decode_32k", False)
    assert tuple(mesh.shape) == (16, 16) and mesh.device_type == "cpu"
    mem = trace["memory"]
    cfg = tconfigs.get_config("qwen3_14b")
    whole = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads * cfg.head_dim * 2  # k, v bf16
    assert mem["cache_bytes"] == whole // 256
    assert mem["param_bytes"] < model.param_count() * 2 / 8  # sharded over tp
    assert mem["peak_bytes_per_device"] >= mem["param_bytes"] + mem["cache_bytes"]
    assert trace["cost"]["flops_per_device"] > 0 and trace["collectives"]


def test_sweep_resumes_and_records_errors(tmp_path, monkeypatch, capsys):
    """`main` writes a record a cell, skips the cached ok ones on a second run, and
    records a cell that raises as an error (with its traceback) and goes on."""
    calls = []

    def lower(arch, shape_name, multi_pod, mesh=None, shape=None):
        calls.append((arch, shape_name, multi_pod))
        if arch == "rwkv6_7b":
            raise RuntimeError("boom")
        trace = {"trace_s": 0.0, "memory": {"param_bytes": 1, "peak_bytes_per_device": 3},
                 "cost": {"flops_per_device": 2},
                 "collectives": {}}
        return trace, None, Model(tconfigs.get_config(arch), kernels=False)

    monkeypatch.setattr(dryrun, "lower_cell", lower)
    argv = ["--arch", "qwen3_14b", "rwkv6_7b", "--shape", "decode_32k", "long_500k",
            "--mesh", "single", "--out", str(tmp_path)]
    assert dryrun.main(argv) == 1
    out = capsys.readouterr().out
    assert "dry-run done: 1 ok, 2 failed, 1 skipped (n/a)" in out
    rec = json.loads((tmp_path / "rwkv6_7b__decode_32k__pod16x16.json").read_text())
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: boom"
    assert "Traceback" in rec["traceback"]
    rec = json.loads((tmp_path / "qwen3_14b__long_500k__pod16x16.json").read_text())
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    rec = json.loads((tmp_path / "qwen3_14b__decode_32k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256 and rec["param_count"] > 0
    calls.clear()
    assert dryrun.main(argv) == 1
    assert "[skip cached] qwen3_14b__decode_32k__pod16x16" in capsys.readouterr().out
    assert ("qwen3_14b", "decode_32k", False) not in calls  # cached
    assert ("rwkv6_7b", "decode_32k", False) in calls  # an error is traced again
    assert not dist.is_initialized()  # main leaves no world behind
