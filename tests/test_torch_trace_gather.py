"""A collective's result counted once in the dry-run's trace, and a gather on a dim
other than the first into one buffer (ROADMAP C21).

- (a) Under `launch.dryrun.StepTracer` a functional collective's `wait_tensor`
  hands back its input, as a process group's does: an `all_gather_into_tensor`
  and its wait raise the live bytes by the result once, and lower them when the
  result dies (FakeTensorMode's own wait made a second tensor, counted beside
  the first).
- (b) `parallel.axes.gather_dims` (which `axes.shard_param` calls for a weight at
  its use) makes a Shard(d) -> Replicate move with d > 0 into one buffer whose
  leading dim is the gathered one. On 2 gloo processes its values and gradients equal DTensor's
  `redistribute` bit for bit, with the gradient DTensor's placements, float32 and
  bf16, on a dim the mesh divides and on one it does not; traced on a fake world
  it holds the result and one local-sized buffer, where DTensor's own gather
  holds the result twice; MoE's experts read the gathered weights without a copy.

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

# (global shape, gathered dim): 2 ranks divide dim 2 of the first and not of the second
GLOO_CASES = {"even": ((3, 4, 8), 2), "uneven": ((2, 6, 5), 2), "dim1": ((4, 6, 3), 1)}


@pytest.fixture
def fake_world():
    def make(n):
        dryrun.init_fake_world(n)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _placed(mesh, local_shape, global_shape, placements, dtype=torch.float32):
    stride = torch.empty(global_shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype), mesh, placements,
                              run_check=False, shape=torch.Size(global_shape), stride=stride)


# ---------------------------------------------------------------- (a)

def test_a_functional_collective_and_its_wait_hold_one_result(fake_world):
    """On a fake world of 4, `all_gather_into_tensor` then `wait_tensor` raise the
    tracer's live bytes by the result once, the wait's output is the result's
    storage, and the live bytes fall back when the result dies; the inventory
    records one all-gather of the result's bytes."""
    fake_world(4)
    group = dist.group.WORLD.group_name
    tracer, inventory = dryrun.StepTracer(), hlo.CollectiveInventory()
    with tracer:
        x = torch.empty(8, 21, dtype=torch.float32)  # 672 B, the result 2688 B
        tracer.track(x)
        before = tracer.live
        with inventory:
            out = torch.ops._c10d_functional.all_gather_into_tensor(x, 4, group)
            waited = torch.ops._c10d_functional.wait_tensor(out)
        assert waited.untyped_storage()._cdata == out.untyped_storage()._cdata
        del out
        nbytes = waited.numel() * waited.element_size()
        assert nbytes == 2688
        assert tracer.live - before == nbytes
        assert tracer.peak - before == nbytes
        del waited
        assert tracer.live == before
    assert [(o.kind, o.bytes) for o in inventory.ops] == [("all-gather", 2688)]


def test_dtensor_gather_is_counted_once_per_buffer_it_makes(fake_world):
    """DTensor's own Shard(0) -> Replicate (`funcol`, its async wrapper, a wait) holds
    one result-sized buffer in the trace: the wait's copy is gone."""
    fake_world(4)
    mesh = init_device_mesh("cpu", (4,))
    tracer = dryrun.StepTracer()
    with tracer, tracer.quiet_dtensor_meta():
        x = _placed(mesh, (8, 16), (32, 16), [Shard(0)])
        tracer.track(x)
        tracer.reset_peak()
        before = tracer.live
        y = x.redistribute(mesh, [Replicate()]).to_local()
        result = y.numel() * y.element_size()
    assert tracer.peak - before == result


# ---------------------------------------------------------------- (b), traced

@pytest.mark.parametrize("dim", [1, 2])
def test_traced_gather_on_a_later_dim_holds_one_result(dim, fake_world):
    """A Shard(d) -> Replicate move over a fake 16-rank dim, d > 0: through
    `axes.gather_dims` the trace's peak is the result plus one local-sized buffer
    (the shard's dim moved to the front), where DTensor's `redistribute` holds the
    dim-0 gather and the concatenated result at once; one all-gather of the
    result's bytes both ways, and the result a view on the gathered buffer."""
    n = 16
    fake_world(n)
    mesh = init_device_mesh("cpu", (n,))
    local_shape = [4, 6, 10]
    global_shape = list(local_shape)
    global_shape[dim] *= n
    peaks, ops = {}, {}
    for route in ("port", "dtensor"):
        tracer, inventory = dryrun.StepTracer(), hlo.CollectiveInventory()
        with tracer, tracer.quiet_dtensor_meta():
            x = _placed(mesh, local_shape, global_shape, [Shard(dim)], torch.bfloat16)
            tracer.track(x)
            tracer.reset_peak()
            before = tracer.live
            with inventory:
                y = (axes.gather_dims(x, (Replicate(),)) if route == "port"
                     else x.redistribute(mesh, [Replicate()]))
            local = y.to_local()
            assert tuple(local.shape) == tuple(global_shape)
            assert y.placements == (Replicate(),)
            peaks[route] = tracer.peak - before
            ops[route] = [(o.kind, o.bytes) for o in inventory.ops]
            if route == "port":
                assert not local.is_contiguous()  # a view of the gathered buffer
    result = 2 * torch.Size(global_shape).numel()
    assert peaks["port"] == result + result // n
    assert peaks["dtensor"] >= 2 * result
    assert ops["port"] == ops["dtensor"] == [("all-gather", result)]


def test_shard_param_takes_the_gather_for_a_later_dim(fake_world):
    """`axes.shard_param` gathering a weight's dim > 0 (a ZeRO-3 weight's ff dim, as
    MoE's experts gather theirs at use) goes through the one-buffer gather, then
    DTensor's redistribution for the other mesh dims; `axes.shard` gathers an
    activation into row slices, whose result is contiguous (a matmul over the
    permuted view would copy it back)."""
    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = axes.ShardingRules(dp=("data",), tp=("model",), ep=("model",))
    tracer = dryrun.StepTracer()
    with axes.use_mesh(mesh, rules), tracer, tracer.quiet_dtensor_meta():
        w = _placed(mesh, (4, 6, 5), (8, 6, 10), [Shard(2), Shard(0)], torch.bfloat16)
        tracer.track(w)
        tracer.reset_peak()
        before = tracer.live
        g = axes.shard_param(w, "ep", None, None)
        assert g.placements == (Replicate(), Shard(0))
        assert tuple(g.to_local().shape) == (4, 6, 10)
        assert not g.to_local().is_contiguous()
        result = 4 * 6 * 10 * 2
        assert tracer.peak - before == result + result // 2
        x = _placed(mesh, (2, 3, 8), (4, 6, 8), [Shard(0), Shard(1)])
        y = axes.shard(x, "dp", None, None)
        assert y.placements == (Shard(0), Replicate()) and y.to_local().is_contiguous()


class _NewStorages(dryrun.StepTracer):
    """`StepTracer` that keeps the bytes of every storage it starts to track."""

    def __init__(self):
        super().__init__()
        self.new: list[tuple[int, tuple]] = []

    def track(self, tree) -> None:
        for t in torch.utils._pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor) and t.device.type != "meta":
                st = t.untyped_storage()
                if id(st) not in self._freed:
                    self.new.append((st.nbytes(), tuple(t.shape)))
        super().track(tree)


def test_moe_experts_use_the_gathered_weights_without_a_copy(fake_world):
    """MoE's experts at use gather their ZeRO-3 weights (the ff dim, a dim > 0, over
    "data"): each gather makes one weight-sized buffer, and the einsums read the
    gathered view as it is, with no second weight-sized copy (DTensor's own gather
    made two, and the trace counted the first twice)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = axes.ShardingRules(dp=("data",), tp=("model",), ep=("model",), zero=("data",))
    cfg = get_config("arctic_480b").reduced()
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    tracer = _NewStorages()
    with axes.use_mesh(mesh, rules), tracer, tracer.quiet_dtensor_meta():
        p = {"wi": _placed(mesh, (E // 2, D, F // 2), (E, D, F), [Shard(2), Shard(0)]),
             "wg": _placed(mesh, (E // 2, D, F // 2), (E, D, F), [Shard(2), Shard(0)]),
             "wo": _placed(mesh, (E // 2, F // 2, D), (E, F, D), [Shard(1), Shard(0)])}
        h = _placed(mesh, (1, E // 2, 16, D), (2, E, 16, D), [Shard(0), Shard(1)])
        tracer.track((p, h))
        tracer.new.clear()
        moe._experts(cfg, p, h)
    weight = E // 2 * D * F * 4  # a weight's local bytes once gathered over "data"
    assert [n for n, _ in tracer.new if n >= weight] == [weight] * 3, tracer.new


def _dtensor_shard(t, *names):
    """`axes.shard`'s placements, reached by DTensor's own `redistribute`."""
    mesh = axes.current_mesh()
    return t.redistribute(t.device_mesh, axes.placements(
        axes.activation_pspec(names, tuple(t.shape), mesh), t.device_mesh))


@pytest.mark.parametrize("nested", [False, True], ids=["data", "pod-data"])
def test_moe_experts_dispatch_dtensors_collectives_forward_and_backward(nested, fake_world,
                                                                        monkeypatch):
    """MoE's experts with their ZeRO-3 weights gathered by `shard_param` dispatch the
    collectives DTensor's `shard` does, forward and backward, kind by kind and
    byte for byte, and hold no more at their peak: each weight's gradient is
    reduced onto its shards as DTensor's backward reduces it, also where the ff
    dim is split over two mesh dims (pod, data), whose two gathers are one
    autograd node (a redistribution after them, or a node a gather, would
    all-reduce it first)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    fake_world(8 if nested else 4)
    cfg = get_config("arctic_480b").reduced()
    E, D, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    if nested:
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        rules = axes.ShardingRules(dp=("pod", "data"), tp=("model",), ep=("model",),
                                   zero=("pod", "data"))
        zero, ff, groups = [Shard(2), Shard(2)], F // 4, 4
    else:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        rules = axes.ShardingRules(dp=("data",), tp=("model",), ep=("model",), zero=("data",))
        zero, ff, groups = [Shard(2)], F // 2, 2
    ops, grads, peaks = {}, {}, {}
    for route in ("port", "dtensor"):
        if route == "dtensor":
            monkeypatch.setattr(moe, "shard_param", _dtensor_shard)
        tracer, inventory = dryrun.StepTracer(), hlo.CollectiveInventory()
        with axes.use_mesh(mesh, rules), tracer, tracer.quiet_dtensor_meta():
            p = {"wi": _placed(mesh, (E // 2, D, ff), (E, D, F), [*zero, Shard(0)]),
                 "wg": _placed(mesh, (E // 2, D, ff), (E, D, F), [*zero, Shard(0)]),
                 "wo": _placed(mesh, (E // 2, ff, D), (E, F, D),
                               [*(Shard(1) for _ in zero), Shard(0)])}
            p = {k: v.requires_grad_(True) for k, v in p.items()}
            h = _placed(mesh, (1, E // 2, 16, D), (groups, E, 16, D),
                        [*(Shard(0) for _ in zero), Shard(1)])
            tracer.track((p, h))
            tracer.reset_peak()
            base = tracer.live
            with inventory:
                moe._experts(cfg, p, h).sum().backward()
        ops[route] = [(o.kind, o.bytes) for o in inventory.ops]
        grads[route] = {k: v.grad.placements for k, v in p.items()}
        peaks[route] = tracer.peak - base
    assert ops["port"] == ops["dtensor"]
    assert {k for k, _ in ops["port"]} == ({"all-gather", "all-reduce", "reduce-scatter"} if nested
                                          else {"all-gather", "reduce-scatter"})
    assert grads["port"] == grads["dtensor"] == {k: v.placements for k, v in p.items()}
    assert peaks["port"] <= peaks["dtensor"]


# ---------------------------------------------------------------- (b), on gloo

def _gathered(mesh, full, dim, port, grad_kind):
    """(local result, input gradient's local shard and placements, the gradient's
    full value) of a Shard(dim) -> Replicate move of `full` and of a backward
    through it: `grad_kind` "replicate" (a replicated weight), "shard" (the
    result times a tensor split on dim 0) or "partial" (a gradient that arrives
    as a partial sum)."""
    x = distribute_tensor(full, mesh, [Shard(dim)]).requires_grad_(True)
    y = axes.gather_dims(x, (Replicate(),)) if port else x.redistribute(mesh, [Replicate()])
    local = y.to_local().detach().clone()
    w = torch.arange(full.numel(), dtype=torch.float32).reshape(full.shape).sin().to(full.dtype)
    if grad_kind == "replicate":
        loss = (y * distribute_tensor(w, mesh, [Replicate()])).float().sum()
    elif grad_kind == "shard":
        loss = (y * distribute_tensor(w, mesh, [Shard(0)])).float().sum()
    else:
        wp = DTensor.from_local(w / (dist.get_rank() + 1), mesh, [Partial()], run_check=False)
        loss = (y * wp).float().sum()
    loss.backward()
    return local, x.grad.to_local(), x.grad.placements, x.grad.full_tensor()


def gloo_gather(rank, world, case):
    mesh = init_device_mesh("cpu", (world,))
    shape, dim = GLOO_CASES[case]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        full = torch.randn(shape, generator=torch.Generator().manual_seed(11)).to(dtype)
        for kind in ("replicate", "shard", "partial"):
            port = _gathered(mesh, full, dim, True, kind)
            ref = _gathered(mesh, full, dim, False, kind)
            out[str(dtype), kind] = {
                "value": torch.equal(port[0], ref[0]) and torch.equal(port[0], full),
                "grad": torch.equal(port[1], ref[1]) and torch.equal(port[3], ref[3]),
                "placements": (port[2], ref[2]),
                "shape": tuple(port[0].shape)}
    return out


@pytest.mark.parametrize("case", sorted(GLOO_CASES))
def test_gather_matches_dtensor_redistribute_on_gloo(case, tmp_path):
    """On 2 gloo processes the one-buffer gather of a Shard(d) tensor, d > 0, equals
    DTensor's `redistribute` to Replicate bit for bit, and the whole tensor; its
    gradient, from a replicated, a split and a partial-sum use, equals DTensor's
    bit for bit with DTensor's placements; float32 and bf16."""
    shape, _ = GLOO_CASES[case]
    for res in spawn(gloo_gather, 2, tmp_path, case, timeout=120):
        for key, r in res.items():
            assert r["value"], key
            assert r["grad"], key
            assert r["placements"][0] == r["placements"][1], key
            assert r["shape"] == shape, key


def test_shard_param_off_a_mesh_and_on_a_plain_tensor_is_the_identity():
    t = torch.randn(3, 4)
    assert axes.shard_param(t, None, "tp") is t
    with axes.use_mesh(None, axes.ShardingRules()):
        assert axes.shard_param(t, None, "tp") is t
