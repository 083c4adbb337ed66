"""A Shard -> Shard move as the all-to-all that NCCL runs (ROADMAP C17, C18), and the
microbatch gradients accumulated in place (C19).

- C18: `torch.ops._dtensor.shard_dim_alltoall`, what DTensor dispatches for a
  Shard -> Shard redistribution on a CUDA mesh, is recorded by
  `CollectiveInventory` once, as an `all-to-all` of its result's bytes; every
  collective torch lists (`torch.distributed._tools.fake_collectives`) has a
  kind in `core/hlo.py` or stands in its `_NOT_COUNTED`.
- C17: under `launch.dryrun.shard_moves_as_alltoall` (which `trace_cell` and
  `execute_cell` open) a Shard -> Shard move on a CPU mesh is that all-to-all of
  local buffers: traced on a fake world, no all-gather and no mesh-size copy; on
  4 gloo processes its values equal DTensor's all-gather fallback's bit for bit,
  forward and backward, float32 and bf16, on a dim the mesh divides and on one
  it does not, and the executed inventory equals the traced one.
- C19: a train step's microbatch gradients are added into one float32
  accumulator in place: the loss, metrics and gradients equal the former
  `tree_map` form's bit for bit (off a mesh and on (data 2, model 2) gloo, float32
  and bf16), and a traced microbatched step holds one float32 accumulator, not two.

No JAX: these are the port's own faults, held to the port's plain forms.
"""

import contextlib
import dataclasses
import sys

import pytest
import torch
import torch.distributed as dist
from torch.distributed._tools import fake_collectives
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils._pytree import tree_leaves

from torch_dist import spawn

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, ShapeSpec, TrainConfig
from repro_torch.core import hlo
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, rules_for
from repro_torch.models.params import distribute, param_defs, param_shapes
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import ShardingRules, use_mesh
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.tree import leaves, paths, tree_map
from torch_threads import one_thread  # noqa: F401

WORLD = 16  # the production mesh's tp, the size of the dim a move crosses
# (global shape, old shard dim, new shard dim): 4 ranks divide both dims; they
# divide neither of the other's, so DTensor pads before the op and unpads after
GLOO_CASES = {"even": ((2, 8, 12), 2, 1), "uneven": ((3, 10, 6), 2, 1)}


@pytest.fixture
def fake_world():
    def make(n):
        dryrun.init_fake_world(n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _placed(mesh, local_shape, global_shape, placements, dtype=torch.float32):
    stride = [1] * len(global_shape)
    for d in range(len(global_shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * global_shape[d + 1]
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype), mesh, placements,
                              run_check=False, shape=torch.Size(global_shape), stride=tuple(stride))


# ---------------------------------------------------------------- C18

@pytest.mark.parametrize("fake", [True, False], ids=["fake-tensors", "real-tensors"])
def test_shard_dim_alltoall_is_one_all_to_all_of_its_result(fake, fake_world):
    """The op DTensor dispatches on a CUDA mesh is recorded once, as an all-to-all of
    the bytes of this rank's result; not dropped (the parent recorded nothing), and
    not counted again through what its implementation runs below it."""
    fake_world(4)
    group = dist.group.WORLD.group_name
    mode = dryrun.StepTracer() if fake else contextlib.nullcontext()
    inventory = hlo.CollectiveInventory()
    with mode:
        x = torch.empty(8, 16, dtype=torch.bfloat16) if fake else torch.randn(8, 16)
        with inventory:
            out = torch.ops._dtensor.shard_dim_alltoall(x, 0, 1, group)
    assert tuple(out.shape) == (32, 4)
    assert [(o.kind, o.bytes) for o in inventory.ops] == [
        ("all-to-all", out.numel() * out.element_size())]
    assert inventory.ops[0].shape == ("bf16[32,4]" if fake else "f32[32,4]")


def _listed_collectives():
    ops = fake_collectives.functional_collectives | fake_collectives.non_functional_collectives
    return sorted(ops, key=str)


@pytest.mark.parametrize("op", _listed_collectives(), ids=str)
def test_every_collective_torch_lists_has_a_kind_or_is_left_out_by_name(op):
    """An op of a namespace torch dispatches collectives from is either counted under
    a kind that `core/hlo.py` names for it or left out by name (`_NOT_COUNTED`): a
    collective DTensor starts to dispatch is not silently uncounted, as its
    all-to-all was."""
    name = op._opname
    assert op.namespace in hlo._KINDS, op
    assert (name in hlo._KINDS[op.namespace]) != (name in hlo._NOT_COUNTED), op
    assert hlo.is_collective(op) == (name not in hlo._NOT_COUNTED)


# ---------------------------------------------------------------- C17, traced

def test_traced_shard_move_is_an_all_to_all_of_local_buffers(fake_world):
    """Shard(2) -> Shard(1) over a fake 16-rank dim under `StepTracer` and the helper:
    one all-to-all of the local output, no all-gather, and the trace's peak at most
    the local input plus the output (DTensor's CPU fallback holds the gathered 16
    local tensors). The helper puts DTensor's function back on exit."""
    from torch.distributed.tensor import _collective_utils, placement_types

    fake_world(WORLD)
    mesh = init_device_mesh("cpu", (WORLD,))
    tracer, inventory = dryrun.StepTracer(), hlo.CollectiveInventory()
    with tracer, tracer.quiet_dtensor_meta(), dryrun.shard_moves_as_alltoall():
        assert placement_types.shard_dim_alltoall is not _collective_utils.shard_dim_alltoall
        with dryrun.shard_moves_as_alltoall():  # re-entrant
            pass
        x = _placed(mesh, (4, 64, 8), (4, 64, 8 * WORLD), [Shard(2)], torch.bfloat16)
        tracer.track(x)
        tracer.reset_peak()
        with inventory:
            y = x.redistribute(mesh, [Shard(1)])
    assert placement_types.shard_dim_alltoall is _collective_utils.shard_dim_alltoall
    local = y.to_local()
    assert tuple(local.shape) == (4, 64 // WORLD, 8 * WORLD)
    nbytes = local.numel() * local.element_size()
    assert [(o.kind, o.bytes) for o in inventory.ops] == [("all-to-all", nbytes)]
    assert tracer.peak <= 2 * nbytes


def test_trace_cell_and_execute_cell_open_the_helper(fake_world, monkeypatch):
    """`trace_cell` and `execute_cell` run a cell's step with the helper open: a step
    that moves a tensor Shard -> Shard over tp records one all-to-all of the local
    result, traced on fake tensors and executed on real ones alike."""
    fake_world(4)
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    seen = []

    def step(model, shape, state, tcfg, policy, cp):
        x = _placed(mesh, (2, 8, 3), (2, 8, 12), [Replicate(), Shard(2)])
        seen.append(tuple(x.redistribute(mesh, [Replicate(), Shard(1)]).to_local().shape))

    monkeypatch.setattr(dryrun, "_run_step", step)
    monkeypatch.setattr(dryrun, "build_state", lambda *a, **k: {"params": {}})
    cfg, shape = get_config("qwen3-14b").reduced(), ShapeSpec("p", 8, 2, "prefill")
    rules = rules_for(mesh, shape)
    traced = dryrun.trace_cell(cfg, shape, mesh, rules, log=lambda *_: None)["collectives"]
    executed = dryrun.execute_cell(cfg, shape, mesh, rules, device="cpu")["collectives"]
    assert [(a["kind"], a["count"], a["bytes"]) for a in traced["ops"]] == [
        ("all-to-all", 1, 2 * 2 * 12 * 4)]
    assert executed == traced
    assert seen == [(2, 2, 12)] * 2


def test_helper_refuses_an_unexpected_site(monkeypatch):
    """Where DTensor's Shard -> Shard call is not the function the helper replaces
    (another torch), it raises, naming torch's version, instead of opening."""
    from torch.distributed.tensor import placement_types

    monkeypatch.setattr(placement_types, "shard_dim_alltoall", lambda *a: None)
    with pytest.raises(RuntimeError, match=torch.__version__.replace("+", r"\+")):
        with dryrun.shard_moves_as_alltoall():
            pass


# ---------------------------------------------------------------- C17, on gloo

def _moves(mesh, full, old, new, helper):
    """(local result, local input gradient, the inventory's summary) of a move of
    `full` from Shard(old) to Shard(new) and of a backward through it."""
    x = distribute_tensor(full, mesh, [Shard(old)]).requires_grad_(True)
    inventory = hlo.CollectiveInventory()
    with dryrun.shard_moves_as_alltoall() if helper else contextlib.nullcontext():
        with inventory:
            y = x.redistribute(mesh, [Shard(new)])
        local = y.to_local()
        w = torch.arange(local.numel(), dtype=local.dtype).reshape(local.shape) + dist.get_rank()
        (local.float() * w.float()).sum().backward()
    return local.detach(), x.grad.to_local(), inventory.summary(), y.full_tensor()


def gloo_moves(rank, world, case):
    mesh = init_device_mesh("cpu", (world,))
    shape, old, new = GLOO_CASES[case]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        full = torch.randn(shape, generator=torch.Generator().manual_seed(7)).to(dtype)
        a2a = _moves(mesh, full, old, new, True)
        gather = _moves(mesh, full, old, new, False)
        out[case, str(dtype)] = {
            "value": torch.equal(a2a[0], gather[0]),
            "grad": torch.equal(a2a[1], gather[1]),
            "chunk": torch.equal(a2a[0], full.chunk(world, new)[rank]),
            "full": torch.equal(a2a[3], full),
            "summary": a2a[2], "fallback": gather[2]}
    return out


@pytest.mark.parametrize("case", sorted(GLOO_CASES))
def test_gloo_moves_equal_the_fallback_and_the_trace(case, tmp_path, fake_world):
    """On 4 gloo processes, with the helper open, the move's local result and the
    backward's gradient equal DTensor's all-gather fallback's bit for bit, and the
    result is `full_tensor()`'s chunk; each rank's inventory (one all-to-all, the
    backward's outside it) equals the trace of the same move on a fake world of 4."""
    ranks = spawn(gloo_moves, 4, tmp_path / "pg", case, timeout=120)
    shape, old, new = GLOO_CASES[case]
    fake_world(4)
    mesh = init_device_mesh("cpu", (4,))
    for dtype in (torch.float32, torch.bfloat16):
        tracer, inventory = dryrun.StepTracer(), hlo.CollectiveInventory()
        with tracer, tracer.quiet_dtensor_meta(), dryrun.shard_moves_as_alltoall():
            x = distribute_tensor(torch.empty(shape, dtype=dtype), mesh, [Shard(old)])
            with inventory:
                x.redistribute(mesh, [Shard(new)])
        traced = inventory.summary()
        assert [a["kind"] for a in traced["ops"]] == ["all-to-all"]
        for r in ranks:
            got = r[case, str(dtype)]
            assert got["value"] and got["grad"] and got["chunk"] and got["full"], got
            assert got["summary"] == traced
            assert [a["kind"] for a in got["fallback"]["ops"]] == ["all-gather"]


# ---------------------------------------------------------------- C19

def _old_form(grads: list, metrics: list, n: int):
    """The former accumulation: a new float32 tree a microbatch (`tree_map`)."""
    g_acc = tree_map(lambda a: a.float() / n, grads[0])
    m_acc = {k: v / n for k, v in metrics[0].items()}
    for g, m in zip(grads[1:], metrics[1:]):
        g_acc = tree_map(lambda a, b: a + b.float() / n, g_acc, g)
        m_acc = {k: m_acc[k] + m[k] / n for k in m_acc}
    return g_acc, m_acc


@contextlib.contextmanager
def _grads_not_applied():
    """The gradients and metrics each train step hands the optimizer, which is
    skipped, so the state is the same for every step."""
    seen, orig = [], ts.adamw_update

    def grab(params, grads, opt, tcfg):
        seen.append(grads)
        return params, opt, {}

    ts.adamw_update = grab
    try:
        yield seen
    finally:
        ts.adamw_update = orig


def _accumulated_and_old(cfg, n, mesh=None, rules=None, batch=4, seq=16):
    """(the step's (grads, metrics) at `n` microbatches, the former form's of the
    same microbatches' gradients): each microbatch's gradients from a step of one
    microbatch on its rows (`train_step._rows`, as the step cuts them)."""
    model = Model(cfg)
    params = model.init(0, torch.device("cpu"), widen_head=False)
    tcfg = TrainConfig()
    with use_mesh(mesh, rules or ShardingRules()):
        if mesh is not None:
            params = distribute(params, model.pspecs(), mesh)
        state = {"params": params, "opt": adamw_init(params, tcfg)}
        data = SyntheticLM(cfg.vocab_size, seq, batch).batch(0)
        full = {k: torch.as_tensor(v) for k, v in data.items()}
        if mesh is not None:
            from repro_torch.parallel.axes import placements, sanitize_pspec
            specs = dryrun.batch_pspecs(cfg, ShapeSpec("t", seq, batch, "train"))
            full = {k: distribute_tensor(v, mesh, placements(
                sanitize_pspec(specs[k], tuple(v.shape), mesh), mesh)) for k, v in full.items()}
        with _grads_not_applied() as seen:
            _, metrics = ts.make_train_step(model, ParallelConfig(microbatches=n), tcfg)(state, full)
            mb, parts = batch // n, []
            for i in range(n):
                rows = {k: ts._rows(v, i * mb, (i + 1) * mb) for k, v in full.items()}
                parts.append(ts.make_train_step(model, ParallelConfig(), tcfg)(state, rows)[1])
    return (seen[0], metrics), _old_form(seen[1:], parts, n)


def _bit_equal(a, b) -> bool:
    a = a.to_local() if isinstance(a, DTensor) else a
    b = b.to_local() if isinstance(b, DTensor) else b
    return a.dtype == b.dtype and torch.equal(a, b)


def _same(new, old) -> dict:
    (g, m), (g_old, m_old) = new, old
    return {"grads": all(_bit_equal(a, b) for a, b in zip(leaves(g), leaves(g_old))),
            "placements": [getattr(a, "placements", None) == getattr(b, "placements", None)
                           for a, b in zip(leaves(g), leaves(g_old))],
            "metrics": {k: _bit_equal(m[k], m_old[k]) for k in m_old},
            "dtypes": {a.dtype for a in leaves(g)}}


BF16 = dict(param_dtype="bfloat16", dtype="bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_in_place_accumulation_equals_the_tree_map_form(dtype):
    """Off a mesh, 3 microbatches: gradients (float32) and metrics bit for bit."""
    cfg = get_config("qwen3-14b").reduced()
    cfg = dataclasses.replace(cfg, **BF16) if dtype == "bfloat16" else cfg
    same = _same(*_accumulated_and_old(cfg, 3, batch=6))
    assert same["grads"] and all(same["metrics"].values()), same
    assert same["dtypes"] == {torch.float32}


def mesh_accumulation(rank, world):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = get_config("qwen3-14b").reduced()
    out = {}
    for name, c in (("float32", cfg), ("bfloat16", dataclasses.replace(cfg, **BF16))):
        new, old = _accumulated_and_old(c, 2, mesh, rules_for(mesh))
        out[name] = _same(new, old)
        out[name]["dtensors"] = all(isinstance(a, DTensor) for a in leaves(new[0]))
    return out


def test_in_place_accumulation_on_a_mesh_equals_the_tree_map_form(tmp_path):
    """On (data 2, model 2) gloo, 2 microbatches, DTensor leaves in their ZeRO-1
    layout: every rank's shards and metrics bit for bit, placements equal."""
    for r in spawn(mesh_accumulation, 4, tmp_path / "pg", timeout=150):
        for same in r.values():
            assert same["dtensors"] and same["grads"] and all(same["placements"]), same
            assert all(same["metrics"].values()) and same["dtypes"] == {torch.float32}, same


def test_mismatched_placements_are_refused():
    """A DTensor gradient placed otherwise than its accumulator is not added."""
    class Fake:  # the two attributes `_add_scaled` compares
        def __init__(self, placements):
            self.device_mesh, self.placements = "mesh", placements

    acc, g = Fake((Shard(0),)), Fake((Shard(1),))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ts, "is_dtensor", lambda x: isinstance(x, Fake))
        with pytest.raises(ValueError, match="placed otherwise"):
            ts._add_scaled(acc, [g], 0, 2)


def _in_accumulation() -> bool:
    """Whether the caller runs in the train step's `accumulate`, outside the
    microbatch's own forward and backward (`grads_of`)."""
    names, f = set(), sys._getframe()
    while f is not None:
        names.add(f.f_code.co_name)
        f = f.f_back
    return "accumulate" in names and "grads_of" not in names


class _AccTracer(dryrun.StepTracer):
    """`StepTracer` that keeps the most bytes alive at once of the float32 storages
    of a parameter's shape that the step's accumulation makes: the accumulators and
    their temporaries (the model's own float32 copies, as its float32 head's, are
    made in `grads_of` and left out)."""

    shapes: set = set()
    last = None

    def __init__(self):
        super().__init__()
        self.made: dict[int, int] = {}
        self.most = 0
        _AccTracer.last = self

    def track(self, tree) -> None:
        super().track(tree)
        for t in tree_leaves(tree):
            if (isinstance(t, torch.Tensor) and not isinstance(t, DTensor)
                    and t.dtype == torch.float32 and tuple(t.shape) in self.shapes
                    and _in_accumulation()):
                self.made[id(t.untyped_storage())] = t.untyped_storage().nbytes()
        self.most = max(self.most, sum(self.made.values()))

    def _free(self, key: int, nbytes: int) -> None:
        self.made.pop(key, None)
        super()._free(key, nbytes)


def test_traced_microbatch_step_holds_one_float32_accumulator(monkeypatch):
    """A bf16 qwen3 at `reduced()` width, traced with 4 microbatches off a mesh: the
    float32 tensors of a parameter's shape that the accumulation makes come to at
    most one accumulator tree (4 bytes a parameter) and one leaf's temporary at
    once, where the former form held two trees at once."""
    cfg = dataclasses.replace(get_config("qwen3-14b").reduced(), **BF16)
    shapes = [tuple(s) for _, s in paths(param_shapes(param_defs(cfg)))]
    monkeypatch.setattr(_AccTracer, "shapes", set(shapes))
    monkeypatch.setattr(dryrun, "StepTracer", _AccTracer)
    dryrun.trace_cell(cfg, ShapeSpec("t", 8, 8, "train"), None, ShardingRules(),
                      policy=(4, "full"), log=lambda *_: None)
    one_tree = sum(4 * torch.Size(s).numel() for s in shapes)
    one_leaf = max(4 * torch.Size(s).numel() for s in shapes)
    assert one_tree <= _AccTracer.last.most <= one_tree + one_leaf


# ---------------------------------------------------------------- chip_smoke rehearsals

def _cpu_step_peak(dev, cfg, batch, seq, remat, seed=0, microbatches=1):
    """`chip_smoke._step_peak` on the CPU: the live bytes of a real step's storages."""
    from test_torch_smoke_plan import LiveBytes, chip_smoke

    model = Model(cfg, kernels=False)
    tcfg = TrainConfig()
    live = LiveBytes()
    with live:
        state = {"params": model.init(seed, dev, widen_head=False)}
        state["opt"] = adamw_init(state["params"], tcfg)
        data = SyntheticLM(cfg.vocab_size, seq, batch).batch(0)
        b = {k: torch.as_tensor(v, dtype=torch.int32) for k, v in data.items()}
        step = ts.make_train_step(model, chip_smoke.ParallelConfig(
            remat=remat, microbatches=microbatches), tcfg)
        state, _ = step(state, b)
        live.peak = live.live
        state, _ = step(state, b)
    return live.peak


def test_plan_accumulate_rehearsal(capsys):
    """Phase 11 (d) on the CPU: a reduced danube at 2 microbatches, its traced peak
    within the card's bar of the live bytes of the same step run, and the
    accumulation bit for bit the former form's of the same microbatch gradients."""
    from test_torch_smoke_plan import chip_smoke

    cfg = dataclasses.replace(get_config("h2o_danube_1p8b").reduced(), attn_impl="chunked",
                              attn_chunk=16, loss_chunk=32)
    rec = chip_smoke.phase_plan_accumulate(torch.device("cpu"), "cpu", layers=2, batch=2, seq=64,
                                           measure=_cpu_step_peak, cfg=cfg)
    assert abs(rec["ratio"] - 1) <= chip_smoke.PLAN_MEM_TOL
    assert rec["microbatches"] == 2 and not rec["grads_differ"] and not rec["metrics_differ"]
    assert rec["accumulator"] == 4 * Model(dataclasses.replace(cfg, num_layers=2)).param_count()
    assert "[plan] (d) h2o-danube-1.8b L2 B2 x S64, remat selective, 2 microbatches" in \
        capsys.readouterr().out


def test_phase_alltoall_rehearsal(tmp_path, capsys):
    """Phase 14 (d) on a one-rank gloo group of the CPU: one all-to-all of the result's
    bytes, the output the input, the helper opened and closed."""
    from test_torch_smoke_plan import chip_smoke

    rec = chip_smoke.phase_alltoall(torch.device("cpu"), "cpu", shape=(64, 32), backend="gloo",
                                    init_method=f"file://{tmp_path}/pg")
    assert [r[:2] for r in rec["recorded"]] == [("all-to-all", 64 * 32 * 2)] and rec["equal"]
    assert "opened True, closed True" in capsys.readouterr().out
