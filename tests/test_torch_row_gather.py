"""An activation gathered on a dim other than the first into row slices of one
contiguous buffer, and its partial-sum gradient reduce-scattered the same way
(ROADMAP C22); `make_mesh`'s default device.

- `parallel.axes.gather_rows` (which `axes.shard` takes for a Shard(d) ->
  Replicate move, d > 0, whose shard has L > 1 rows before d) gathers each of
  the L rows into its slice of the result, one `all_gather_into_tensor_out` a
  row; its backward reduce-scatters a partial-sum gradient row by row into the
  shard, one `reduce_scatter_tensor_out` a row, and takes a replicated one's
  chunk. On gloo its values and gradients equal DTensor's `redistribute` bit for
  bit, with DTensor's placements: float32 and bf16, even and uneven splits, L = 1
  and L > 1, 3-D and 4-D, the batch split on "data" beside the sequence on
  "model", and the sequence split on both.
- Traced on a fake world, the gather holds the result alone and its backward the
  shard alone, where DTensor's hold a dim-0 buffer or a dim-0 copy beside them;
  the collectives' bytes are DTensor's, in L calls.
- A one-layer qwen3 step at `reduced()` on (data 2, model 2) gloo, whose norm
  outputs and hidden state take the row gather, matches one device at the mesh
  tests' bar, and its executed collectives equal its trace.
- `launch.mesh.make_mesh` without a device type wants CUDA, and raises without
  it; "cpu" builds a gloo mesh.

No JAX: these are the port's own faults, held to DTensor's own forms.
"""

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from torch_dist import spawn

from repro_torch.core import hlo
from repro_torch.launch import dryrun
from repro_torch.parallel import axes
from torch_threads import one_thread  # noqa: F401

# name: (global shape, gathered dim); on 2 ranks
CASES = {
    "3d_rows": ((3, 8, 5), 1),  # L = 3
    "3d_rows_uneven": ((2, 7, 3), 1),  # L = 2, 7 rows over 2 ranks
    "4d_rows": ((2, 3, 6, 4), 2),  # L = 6
    "4d_rows_uneven": ((2, 2, 5, 3), 2),
    "3d_one_row": ((1, 8, 5), 1),  # L = 1: DTensor's gather under `shard`
    "4d_one_row_uneven": ((1, 5, 3, 2), 1),
}
STEP_TOL = 1e-5  # `tests/test_torch_mesh.py`'s: step 1 on a mesh against one device


def on_two(rank, world):
    """Every 2-process case in one spawn: the row gather, the row reduce-scatter and
    `make_mesh`'s default."""
    return {"gather": gloo_rows(rank, world), "scatter": gloo_scatter(rank, world),
            "mesh": mesh_default(rank, world)}


def on_four(rank, world):
    """Every (data 2, model 2) case in one spawn: the nested row gather, the row
    reduce-scatter beside the batch on "data" and the one-layer qwen3 step."""
    return {"gather": gloo_nested(rank, world), "scatter": gloo_scatter_2x2(rank, world),
            "qwen3": qwen3_one_layer(rank, world)}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return spawn(on_two, 2, tmp_path_factory.mktemp("two"), timeout=150)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return spawn(on_four, 4, tmp_path_factory.mktemp("four"), timeout=180)


@pytest.fixture
def fake_world():
    def make(n):
        dryrun.init_fake_world(n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _weights(shape, dtype):
    n = torch.Size(shape).numel()
    return torch.arange(n, dtype=torch.float32).reshape(shape).sin().to(dtype)


def _moved(mesh, full, pl_in, pl_out, route, grad_kind):
    """(local result, is it contiguous, input gradient's local shard and placements,
    the gradient's full value, result placements, result's full value) of `full`
    placed `pl_in` moved to `pl_out` and a backward through it. `route`: "rows"
    (`axes.gather_rows` on every moved mesh dim), "shard" (`axes.move`, `shard`'s
    choice) or "dtensor" (`redistribute`). `grad_kind`: "replicate" (a replicated
    use) or "partial" (a gradient that arrives as a partial sum on the moved mesh
    dims)."""
    x = distribute_tensor(full, mesh, pl_in).requires_grad_(True)
    if route == "rows":
        y = axes.gather_rows(x, axes._gathered_dims(x, pl_out))
    elif route == "shard":
        y = axes.move(x, pl_out)
    else:
        y = x.redistribute(mesh, pl_out)
    local, whole = y.to_local().detach().clone(), y.detach().full_tensor()
    contiguous = y.to_local().is_contiguous()
    w = _weights(full.shape, full.dtype)
    if grad_kind == "replicate":
        loss = (y * distribute_tensor(w, mesh, list(pl_out))).float().sum()
        loss.backward()
    else:
        moved = [i for i, (p, q) in enumerate(zip(pl_in, pl_out)) if p != q]
        gpl = [Partial() if i in moved else q for i, q in enumerate(pl_out)]
        g = distribute_tensor(w, mesh, list(pl_out)).to_local() / (dist.get_rank() + 1)
        y.backward(DTensor.from_local(g, mesh, gpl, run_check=False))
    return (local, contiguous, x.grad.to_local(), x.grad.placements, x.grad.full_tensor(),
            y.placements, whole)


def _compare(mesh, full, pl_in, pl_out, routes):
    out = {}
    for kind in ("replicate", "partial"):
        ref = _moved(mesh, full, pl_in, pl_out, "dtensor", kind)
        for route in routes:
            got = _moved(mesh, full, pl_in, pl_out, route, kind)
            out[route, kind] = {
                "value": torch.equal(got[0], ref[0]) and torch.equal(got[6], full),
                "grad": torch.equal(got[2], ref[2]) and torch.equal(got[4], ref[4]),
                "placements": (got[3], ref[3], got[5], ref[5]),
                "contiguous": got[1]}
    return out


def gloo_rows(rank, world):
    mesh = init_device_mesh("cpu", (world,))
    out = {}
    for name, (shape, dim) in CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            full = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(dtype)
            res = _compare(mesh, full, [Shard(dim)], [Replicate()], ("rows", "shard"))
            out.update({(name, str(dtype), *k): v for k, v in res.items()})
    return out


def test_row_gather_matches_dtensor_redistribute_on_gloo(two):
    """On 2 gloo processes the row-slice gather of a Shard(d) tensor, d > 0, equals
    DTensor's `redistribute` to Replicate bit for bit, and the whole tensor, in
    every case: float32 and bf16, even and uneven, L = 1 and L > 1, 3-D and 4-D;
    its gradient, from a replicated use and from a partial sum, equals DTensor's
    bit for bit with DTensor's placements; the result is contiguous (a matmul
    flattens it without a copy). `shard`'s route equals both."""
    for res in (r["gather"] for r in two):
        assert len(res) == len(CASES) * 2 * 2 * 2
        for key, r in res.items():
            assert r["value"], key
            assert r["grad"], key
            got, ref, out_got, out_ref = r["placements"]
            assert got == ref and out_got == out_ref == (Replicate(),), key
            assert r["contiguous"] or "uneven" in key[0], key


def gloo_nested(rank, world):
    """The (data 2, model 2) layouts an activation takes: the batch on "data" with
    the sequence on "model" gathered over "model" (`shard`'s (dp, sp) -> (dp,
    None)), and the sequence split on both gathered whole, even and uneven."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    layouts = {"batch_data_seq_model": ((4, 6, 3), [Shard(0), Shard(1)], [Shard(0), Replicate()]),
               "seq_on_both": ((3, 8, 2, 3), [Shard(1), Shard(1)], [Replicate(), Replicate()]),
               "seq_on_both_4d_uneven": ((2, 4, 3, 2), [Shard(2), Shard(2)],
                                         [Replicate(), Replicate()])}
    for name, (shape, pl_in, pl_out) in layouts.items():
        for dtype in (torch.float32, torch.bfloat16):
            full = torch.randn(shape, generator=torch.Generator().manual_seed(5)).to(dtype)
            if name == "seq_on_both_4d_uneven":  # 3 rows over 2 x 2 ranks: `shard`'s route
                res = _compare(mesh, full, pl_in, pl_out, ("shard",))
            else:
                res = _compare(mesh, full, pl_in, pl_out, ("rows", "shard"))
            out.update({(name, str(dtype), *k): v for k, v in res.items()})
    return out


def test_nested_row_gather_matches_dtensor_on_a_2x2_gloo_mesh(four):
    """On (data 2, model 2) gloo processes the row gather of an activation's layouts
    equals DTensor's values and gradients bit for bit, with its placements."""
    for res in (r["gather"] for r in four):
        assert res
        for key, r in res.items():
            assert r["value"], key
            assert r["grad"], key
            got, ref, out_got, out_ref = r["placements"]
            assert got == ref and out_got == out_ref, key


def _scattered(mesh, parts, pl_in, pl_out, route, grad_kind):
    """(local result, result's full value, the input gradient's local value and
    placements) of a partial sum (this rank's part `parts`, placed `pl_in`) moved
    to `pl_out` by `axes.move`, `shard`'s route ("shard"), or DTensor's
    ("dtensor"), and a backward through it from a use split as the result
    ("shard") or a gradient
    that arrives as a partial sum ("partial")."""
    leaf = parts.clone().requires_grad_(True)
    x = DTensor.from_local(leaf, mesh, pl_in, run_check=False)
    seen = []
    x.register_hook(lambda g: seen.append(g))
    y = (axes.move(x, pl_out) if route == "shard"
         else x.redistribute(mesh, pl_out))
    local, whole = y.to_local().detach().clone(), y.detach().full_tensor()
    w = _weights(y.shape, parts.dtype)
    if grad_kind == "shard":
        (y * distribute_tensor(w, mesh, list(pl_out))).float().sum().backward()
    else:
        moved = [i for i, (p, q) in enumerate(zip(pl_in, pl_out)) if p != q]
        g = distribute_tensor(w, mesh, [Replicate() if i in moved else q
                                        for i, q in enumerate(pl_out)]).to_local()
        y.backward(DTensor.from_local(g / (dist.get_rank() + 1), mesh,
                                      [Partial() if i in moved else q
                                       for i, q in enumerate(pl_out)], run_check=False))
    return local, whole, seen[0].to_local(), seen[0].placements, y.placements


def _compare_scatter(mesh, parts, pl_in, pl_out):
    out = {}
    for kind in ("shard", "partial"):
        got = _scattered(mesh, parts, pl_in, pl_out, "shard", kind)
        ref = _scattered(mesh, parts, pl_in, pl_out, "dtensor", kind)
        out[kind] = {"value": torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                     "grad": torch.equal(got[2], ref[2]),
                     "placements": (got[3], ref[3], got[4], ref[4])}
    return out


def gloo_scatter(rank, world):
    """Partial -> Shard(d) moves, d > 0, each rank's part its own: on 2 ranks (every
    case of `CASES`), and on (data 2, model 2) the batch on "data" with the
    partial sum over "model" reduced onto the sequence (an output projection's)."""
    out = {}
    mesh = init_device_mesh("cpu", (world,))
    for name, (shape, dim) in CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            parts = torch.randn(shape, generator=torch.Generator().manual_seed(7 + rank)).to(dtype)
            res = _compare_scatter(mesh, parts, [Partial()], [Shard(dim)])
            out.update({(name, str(dtype), k): v for k, v in res.items()})
    return out


def gloo_scatter_2x2(rank, world):
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for name, (local, dim) in {"batch_data_seq_model": ((2, 6, 3), 1),
                               "batch_data_4d_uneven": ((3, 2, 5, 2), 2)}.items():
        for dtype in (torch.float32, torch.bfloat16):
            parts = torch.randn(local, generator=torch.Generator().manual_seed(9 + rank)).to(dtype)
            res = _compare_scatter(mesh, parts, [Shard(0), Partial()], [Shard(0), Shard(dim)])
            out.update({(name, str(dtype), k): v for k, v in res.items()})
    return out


@pytest.mark.parametrize("world", [2, 4], ids=["2", "2x2"])
def test_row_scatter_matches_dtensor_redistribute_on_gloo(world, request):
    """On gloo processes `axes.shard`'s reduce-scatter of a partial sum onto a dim
    d > 0, row slice by row slice from the partial sum as it stands, equals
    DTensor's `redistribute` bit for bit: float32 and bf16, even and uneven, L = 1
    and L > 1, 3-D and 4-D, and beside the batch split on "data"; its backward
    (the gradient's gather into row slices, or DTensor's for a partial-sum
    gradient) gives DTensor's gradient bit for bit, with DTensor's placements."""
    for res in (r["scatter"] for r in request.getfixturevalue("two" if world == 2 else "four")):
        assert len(res) == (len(CASES) * 4 if world == 2 else 8)
        for key, r in res.items():
            assert r["value"], key
            assert r["grad"], key
            got, ref, out_got, out_ref = r["placements"]
            assert got == ref and out_got == out_ref, key


# ---------------------------------------------------------------- traced

def _placed(mesh, local_shape, global_shape, placements, dtype=torch.float32):
    stride = torch.empty(global_shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype), mesh, placements,
                              run_check=False, shape=torch.Size(global_shape), stride=stride)


@pytest.mark.parametrize("route", ["port", "dtensor"])
def test_traced_row_gather_and_its_backward_hold_no_dim0_copy(route, fake_world):
    """A (B_local 4, S, D) bf16 hidden state split on S over a fake 16-rank "model"
    dim, gathered by `axes.shard` to (dp, None, None): the port's gather holds the
    result alone (DTensor's: its dim-0 buffer and the result), and the backward of
    a partial-sum gradient holds the shard alone (DTensor's: a copy of the whole
    gradient in chunks along dim 0 as well). The collectives' bytes are DTensor's:
    one all-gather and one reduce-scatter there, four of each (a row each) here."""
    n, B, s, D = 16, 4, 8, 24
    fake_world(n)
    mesh = init_device_mesh("cpu", (1, n), mesh_dim_names=("data", "model"))
    rules = axes.ShardingRules(dp=("data",), tp=("model",), sp=("model",))
    tracer, inventory = dryrun.StepTracer(), hlo.CollectiveInventory()
    result, shard = B * s * n * D * 2, B * s * D * 2
    with axes.use_mesh(mesh, rules), tracer, tracer.quiet_dtensor_meta():
        x = _placed(mesh, (B, s, D), (B, n * s, D), [Shard(0), Shard(1)], torch.bfloat16)
        x.requires_grad_(True)
        tracer.track(x)
        tracer.reset_peak()
        base = tracer.live
        with inventory:
            if route == "port":
                y = axes.shard(x, "dp", None, None)
            else:
                y = x.redistribute(mesh, [Shard(0), Replicate()])
        fwd_peak = tracer.peak - base
        assert y.placements == (Shard(0), Replicate())
        assert tuple(y.to_local().shape) == (B, n * s, D)
        assert y.to_local().is_contiguous()
        g = DTensor.from_local(torch.empty(B, n * s, D, dtype=torch.bfloat16), mesh,
                               [Shard(0), Partial()], run_check=False)
        tracer.track(g)
        tracer.reset_peak()
        base = tracer.live
        with inventory:
            y.backward(g)
        bwd_peak = tracer.peak - base
        assert x.grad.placements == (Shard(0), Shard(1))
        assert tuple(x.grad.to_local().shape) == (B, s, D)
    ops = [(o.kind, o.bytes) for o in inventory.ops]
    if route == "port":
        assert fwd_peak == result
        assert bwd_peak == shard
        assert ops == [("all-gather", result // B)] * B + [("reduce-scatter", shard // B)] * B
    else:
        assert fwd_peak >= 2 * result
        assert bwd_peak >= result + shard
        assert ops == [("all-gather", result), ("reduce-scatter", shard)]


@pytest.mark.parametrize("route", ["port", "dtensor"])
def test_traced_row_scatter_and_its_backward_hold_no_dim0_copy(route, fake_world):
    """An output projection's partial sums (B_local 4, S, D) bf16 over a fake 16-rank
    "model" dim reduced onto the sequence by `axes.shard` to (dp, sp, None): the
    port's reduce-scatter holds the shard alone (DTensor's: a copy of the whole
    partial sum in chunks along dim 0 as well), and the backward of a gradient
    split as the output holds the result alone (DTensor's: its dim-0 gather
    buffer as well). The bytes are DTensor's, in four calls of each (a row each)."""
    n, B, s, D = 16, 4, 8, 24
    fake_world(n)
    mesh = init_device_mesh("cpu", (1, n), mesh_dim_names=("data", "model"))
    rules = axes.ShardingRules(dp=("data",), tp=("model",), sp=("model",))
    tracer, inventory = dryrun.StepTracer(), hlo.CollectiveInventory()
    result, shard = B * s * n * D * 2, B * s * D * 2
    with axes.use_mesh(mesh, rules), tracer, tracer.quiet_dtensor_meta():
        x = _placed(mesh, (B, n * s, D), (B, n * s, D), [Shard(0), Partial()], torch.bfloat16)
        x.requires_grad_(True)
        tracer.track(x)
        tracer.reset_peak()
        base = tracer.live
        with inventory:
            y = (axes.shard(x, "dp", "sp", None) if route == "port"
                 else x.redistribute(mesh, [Shard(0), Shard(1)]))
        fwd_peak = tracer.peak - base
        assert y.placements == (Shard(0), Shard(1))
        assert tuple(y.to_local().shape) == (B, s, D) and y.to_local().is_contiguous()
        g = _placed(mesh, (B, s, D), (B, n * s, D), [Shard(0), Shard(1)], torch.bfloat16)
        tracer.track(g)
        tracer.reset_peak()
        base = tracer.live
        with inventory:
            y.backward(g)
        bwd_peak = tracer.peak - base
        assert x.grad.placements == (Shard(0), Replicate())
        assert tuple(x.grad.to_local().shape) == (B, n * s, D)
    ops = [(o.kind, o.bytes) for o in inventory.ops]
    if route == "port":
        assert fwd_peak == shard
        assert bwd_peak == result
        assert ops == [("reduce-scatter", shard // B)] * B + [("all-gather", result // B)] * B
    else:
        assert fwd_peak >= result + shard
        assert bwd_peak >= 2 * result
        assert ops == [("reduce-scatter", shard), ("all-gather", result)]


def test_shard_leaves_one_row_and_dim0_moves_to_dtensor(fake_world):
    """`axes.shard` takes the row gather only where a moved shard has L > 1 rows
    before its dim: a (1, S, D) state gathered on S (L = 1) and a dim-0 gather stay
    DTensor's one `all_gather_into_tensor` into the result's layout; a mesh dim of
    size 1 moves nothing."""
    fake_world(4)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    rules = axes.ShardingRules(dp=("data",), tp=("model",), sp=("model",))
    with axes.use_mesh(mesh, rules), dryrun.StepTracer() as tracer, tracer.quiet_dtensor_meta():
        for local, glob, pl, names, out, calls in (
                ((1, 4, 6), (1, 16, 6), [Replicate(), Shard(1)], ("dp", None, None),
                 (Replicate(), Replicate()), 1),
                ((2, 4, 6), (2, 16, 6), [Shard(0), Shard(1)], ("dp", None, None),
                 (Shard(0), Replicate()), 2),
                ((2, 4, 6), (8, 4, 6), [Replicate(), Shard(0)], (None, None, None),
                 (Replicate(), Replicate()), 1),
                ((2, 4, 6), (2, 4, 6), [Shard(1), Replicate()], (None, None, None),
                 (Replicate(), Replicate()), 0)):
            inventory = hlo.CollectiveInventory()
            with inventory:
                y = axes.shard(_placed(mesh, local, glob, pl), *names)
            assert y.placements == out
            assert [o.op_name.split(".")[1] for o in inventory.ops] == (
                ["all_gather_into_tensor_out"] * 2 if calls == 2
                else ["all_gather_into_tensor"] * calls)


# ------------------------------------------------- a step against one device

def qwen3_one_layer(rank, world):
    """One rank of a one-layer reduced qwen3 training step on (data 2, model 2), sp
    on: the loss and gradients against one device, and the executed step's
    collectives (under the inventory) with the ops each row gather makes."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeSpec, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh, rules_for
    from repro_torch.models.transformer import Model
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.trainer import Trainer
    from repro_torch.train.tree import paths

    cfg = get_config("qwen3-14b").reduced(num_layers=1)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cell = ShapeSpec("train_64", 64, 8, "train")
    rules = rules_for(mesh, cell)
    batch = SyntheticLM(cfg.vocab_size, 64, 8).batch(0)
    tcfg, pcfg = TrainConfig(steps=1, log_every=100), ParallelConfig()
    cpu = torch.device("cpu")
    t0 = Trainer(Model(cfg), pcfg, tcfg, cpu)
    t1 = Trainer(Model(cfg), pcfg, tcfg, cpu, mesh=mesh, rules=rules)
    s0, s1 = t0.init_state(), t1.init_state()
    g0, m0 = loss_and_grads(t0.model, s0["params"], t0._batch(batch), pcfg.remat)
    inventory = hlo.CollectiveInventory()
    with t1._ctx(), inventory:
        g1, m1 = loss_and_grads(t1.model, s1["params"], t1._batch(batch), pcfg.remat)
    leaves1 = dict(paths(g1))
    diffs = {k: float((axes.whole(leaves1[k]) - v).abs().max()) for k, v in paths(g0)}
    names = [o.op_name.split(".")[1] for o in inventory.ops]
    executed = dryrun.execute_cell(cfg, cell, mesh, rules, device="cpu", policy=(1, "selective"))
    return {"loss_d": float(abs(m0["loss"] - m1["loss"])), "grads": diffs,
            "rows": (names.count("all_gather_into_tensor_out"),
                     names.count("reduce_scatter_tensor_out")),
            "collectives": executed["collectives"]}


def test_one_layer_qwen3_step_on_a_2x2_mesh_matches_one_device(four, fake_world):
    """A one-layer reduced qwen3 step on (data 2, model 2) gloo, sp on, whose norm
    outputs and final hidden state (B_local 4 rows) take the row gather forward
    and its reduce-scatter backward, equals one device within the mesh tests' bar
    on every rank, loss and every gradient leaf; its executed collectives equal
    `trace_cell`'s of the same cell on a fake 2x2 world, kind by kind."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_mesh, rules_for

    ranks = [r["qwen3"] for r in four]
    fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cell = ShapeSpec("train_64", 64, 8, "train")
    cfg = get_config("qwen3-14b").reduced(num_layers=1)
    traced = dryrun.trace_cell(cfg, cell, mesh, rules_for(mesh, cell), policy=(1, "selective"),
                               log=lambda *_: None)["collectives"]
    for r in ranks:
        assert r["loss_d"] <= STEP_TOL
        assert max(r["grads"].values()) <= STEP_TOL, r["grads"]
        gathers, scatters = r["rows"]
        assert gathers >= 3 * 4 and scatters >= 3 * 4  # two norms and the loss's, 4 rows each
        assert r["collectives"] == traced


# ---------------------------------------------------------------- make_mesh

def mesh_default(rank, world):
    from repro_torch.launch.mesh import make_mesh

    try:
        make_mesh((world,), ("data",))
        default = "built"
    except RuntimeError as e:
        default = str(e)
    mesh = make_mesh((world,), ("data",), "cpu")
    x = distribute_tensor(torch.arange(4.0), mesh, [Shard(0)])
    return {"default": default, "type": mesh.device_type,
            "backend": dist.get_backend(mesh.get_group(0)), "sum": float(x.full_tensor().sum())}


def test_make_mesh_default_wants_cuda_and_cpu_builds_gloo(two):
    """`make_mesh` without a device type is a CUDA mesh: on this CPU-only machine it
    raises, as `repro_torch.resolve_device` does (no silent CPU mesh); "cpu" still
    builds the gloo mesh, whose DTensors move."""
    assert not torch.cuda.is_available()
    for r in (r["mesh"] for r in two):
        assert r["default"] == "CUDA is not available; pass device='cpu' to run on the CPU"
        assert (r["type"], r["backend"], r["sum"]) == ("cpu", "gloo", 6.0)


def test_phase_row_gather_rehearsal(tmp_path):
    """Phase 14 (d)'s row gather on a one-rank gloo group of the CPU: four all-gathers
    and four reduce-scatters of a row's bytes, as the fake one-rank world's trace
    records them; the output the input and the gradient the upstream one, as
    DTensor's functional collectives give them (one all-gather, one reduce-scatter
    of the whole)."""
    from test_torch_smoke_plan import chip_smoke

    rec = chip_smoke.phase_row_gather(torch.device("cpu"), "cpu", shape=(4, 64, 32),
                                      backend="gloo", init_method=f"file://{tmp_path}/pg")
    row = 64 * 32 * 2
    want = [("all-gather", row)] * 4 + [("reduce-scatter", row)] * 4
    assert rec["recorded"] == rec["traced"] == want
    assert rec["equal"] and rec["grad_equal"]
    assert rec["dtensor"] == [("all-gather", 4 * row), ("reduce-scatter", 4 * row)]
    assert rec["rise"] is None
