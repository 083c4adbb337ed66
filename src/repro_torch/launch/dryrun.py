"""Multi-pod dry-run (`repro.launch.dryrun`): trace every (arch x shape x mesh) cell.

For each cell this proves, without hardware:
  * the sharding config is coherent (every state leaf is placed by its
    sanitized spec, and the step runs on those placements),
  * the step fits per-device memory (the tracked peak of live bytes),
  * and counts this rank's flops and the step's collectives.

JAX lowers and compiles each cell on 512 host devices. The port traces it
instead, with real Python and no data:

  * a fake process group (`torch.testing._internal.distributed.fake_pg`,
    backend "fake"): this process is rank 0 of a world of 512 ranks (256 for
    `--mesh single`), and every collective returns at once. The one-pod
    mesh takes the first 256 ranks, as JAX's takes the first 256 devices.
  * `FakeTensorMode`: every tensor has a shape, a dtype and a device and no
    storage, so a 480 B-parameter state allocates nothing. The tensors are
    CPU tensors on a "cpu" DeviceMesh, on any machine: a "cuda" mesh would
    set a card for each rank, and the trace needs none. Device type changes
    no shape and no byte count.
  * `StepTracer`, a FakeTensorMode that sees every op run on this rank's
    local tensors (below DTensor, which runs its ops on its local shards):
    it sums their flops (`torch.utils.flop_counter`'s formulas; JAX's
    `cost_analysis()`) and tracks the bytes of live storages, whose peak
    stands for JAX's `memory_analysis()`; what DTensor runs on global-shape
    stand-ins to propagate an op's sharding is left out, and a functional
    collective's `wait_tensor` hands back its input, as on a process group;
  * `CollectiveInventory` (`core/hlo.py`) records each collective this rank
    dispatches, with the bytes of its result, in the shape of JAX's HLO
    `collective_summary`. `execute_cell` runs the same step for real on a
    process group under the same inventory, to hold the trace to it.

Each cell runs the model with `kernels=False`, the config's own `attn_impl`,
as JAX's dry-run lowers the full configs through its jnp attention rather
than Pallas; the CUDA kernels cannot run on tensors without data. A decode
cell decodes at position S - 1, the last slot of a full cache.

Results are cached incrementally to build/dryrun/<cell>.json so the full
sweep is resumable. Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A ...] [--shape S ...]
      [--mesh single|multi|both] [--out DIR] [--force]
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config, input_specs
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeSpec, TrainConfig
from repro_torch.core.hlo import CollectiveInventory, is_collective
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.models.params import param_defs, param_shapes
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import (axes_size, logical_spec, placements, sanitize_pspec,
                                       use_mesh)
from repro_torch.train.optimizer import opt_state_shapes, opt_state_specs
from repro_torch.train.train_step import make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")

# per-arch training policy overrides (JAX's, `repro.launch.dryrun`):
# arctic-480b needs 8-bit optimizer state to fit a single v5e pod;
# rwkv6's intra-layer chunk scan needs full recomputation (selective remat
# saves per-chunk decay matrices -> O(S/Q) blowup).
ARCH_TRAIN_OVERRIDES = {
    # 8-bit optimizer + deep accumulation
    "arctic_480b": {"optimizer": "adamw8bit", "microbatches_floor": 32},
    "rwkv6_7b": {"remat": "full"},
}


def init_fake_world(size: int) -> None:
    """Make this process rank 0 of a fake world of `size` ranks, whose collectives
    return at once without moving data; a fake world of at least that size already
    there is kept, any other process group refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < size:
            raise RuntimeError(f"the dry-run needs a fake world of {size} ranks; another "
                               "process group is open")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """`_collective_utils.shard_dim_alltoall` as it runs on a CUDA mesh, on any mesh:
    the all-to-all of local buffers over `mesh_dim`."""
    group = mesh.get_group(mesh_dim).group_name
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group)


@contextlib.contextmanager
def shard_moves_as_alltoall():
    """While open, a Shard -> Shard redistribution on a CPU mesh runs as it does on a
    CUDA mesh: `torch.ops._dtensor.shard_dim_alltoall`, an all-to-all of the padded
    local buffers, where DTensor's `_collective_utils.shard_dim_alltoall` takes on a
    CPU mesh an all-gather over the mesh dim and keeps one chunk (mesh-dim size times
    the local tensor for a moment, recorded as an all-gather). On a CUDA mesh nothing
    changes. It replaces the name `shard_dim_alltoall` in `torch.distributed.tensor.
    placement_types`, which `Shard._to_new_shard_dim` calls between its padding of
    the local tensor and its unpadding, and puts the original back on exit. It
    refuses to open, naming torch's version, where that name or that call is not
    what it expects. On a gloo group without an all-to-all for a dtype the op
    raises: there is no return to the all-gather. Re-entrant."""
    from torch.distributed.tensor import _collective_utils, placement_types

    orig = getattr(placement_types, "shard_dim_alltoall", None)
    if orig is _alltoall:
        yield
        return
    caller = inspect.getsource(placement_types.Shard._to_new_shard_dim)
    if (orig is not _collective_utils.shard_dim_alltoall or "shard_dim_alltoall(" not in caller
            or not hasattr(torch.ops._dtensor, "shard_dim_alltoall")):
        raise RuntimeError(f"torch {torch.__version__}: `placement_types.shard_dim_alltoall` is "
                           "not `_collective_utils.shard_dim_alltoall` called by "
                           "`Shard._to_new_shard_dim`, or `torch.ops._dtensor.shard_dim_alltoall` "
                           "is missing: a Shard -> Shard move cannot be made an all-to-all here")
    placement_types.shard_dim_alltoall = _alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


class StepTracer(FakeTensorMode):
    """FakeTensorMode that counts this rank's work: the flops of every op on local
    fake tensors (an op on DTensors is counted where DTensor runs it, on the local
    shards), and the bytes of the storages alive, with their peak. `track` adds
    tensors made before (the state); a storage counts once, however many views
    it has, until it is freed. A functional collective's result is one storage:
    `_c10d_functional.wait_tensor` gives back its input, as a process group's
    does, where FakeTensorMode would give a new tensor of its own (two storages
    for one result, the first held by DTensor's async wrapper); so does a
    collective's `out=` variant its `out`."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._freed: dict[int, weakref.finalize] = {}
        self._quiet = 0

    def _free(self, key: int, nbytes: int) -> None:
        self._freed.pop(key, None)
        self.live -= nbytes

    def track(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            st = t.untyped_storage()
            # lint: disable-next=D104 -- identity map of the live storages: keys are
            # only looked up, never iterated or ordered
            key = id(st)
            if key in self._freed:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._freed[key] = weakref.finalize(st, self._free, key, n)

    def reset_peak(self) -> None:
        self.peak = self.live

    @contextlib.contextmanager
    def quiet_dtensor_meta(self):
        """While open, what DTensor's sharding propagation runs to learn an op's
        global output (stand-ins of the global shapes, made under this mode) is
        neither counted nor tracked: no rank computes or holds it."""
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name)

        def quiet(prop, *a, **k):
            self._quiet += 1
            try:
                return orig(prop, *a, **k)
            finally:
                self._quiet -= 1

        setattr(ShardingPropagator, name, quiet)
        try:
            yield
        finally:
            setattr(ShardingPropagator, name, orig)

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket is torch.ops._c10d_functional.wait_tensor:
            # on a process group the wait hands back its input, the collective's result
            # (one storage); FakeTensorMode's would make a second tensor beside it
            return args[0]
        tensors = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        # a collective holds its result: what its fake implementation makes on the
        # way (the mesh-dim copies of `_dtensor.shard_dim_alltoall`'s) is no rank's
        inner = is_collective(func)
        self._quiet += inner
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._quiet -= inner
        if inner and "out" in kwargs:
            # a collective writing into a given buffer hands that buffer back, as a
            # process group's does; FakeTensorMode's makes a new tensor
            return kwargs["out"]
        if self._quiet or any(isinstance(t, DTensor) for t in tensors):
            return out  # the DTensor level: its local ops come through here too
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        self.track([t for t in tree_leaves(out) if isinstance(t, FakeTensor)])
        return out


def batch_pspecs(cfg, shape):
    """Spec tree for the input batch under current rules."""
    specs = {}
    parts = input_specs(cfg, shape)
    for k, v in parts.items():
        if k == "embeds":
            specs[k] = logical_spec("dp", None, None)
        else:
            specs[k] = logical_spec("dp", None)
    return specs


def pick_train_policy(cfg, shape, over: dict) -> tuple[int, str]:
    """Choose (microbatches, remat) with the paper's memory model (§5.1):
    smallest accumulation count whose predicted footprint fits v5e HBM.
    This is the auto-planner applied to the fixed production mesh."""
    from repro_torch.core.memory import training_memory

    if "remat" in over:
        remats = [over["remat"]]
    else:
        remats = ["selective", "full"]
    dp = max(axes_size("dp"), 1)
    per_replica = max(shape.global_batch // dp, 1)
    budget = 16e9 * 0.9
    # engineering floors over the analytic model: MoE dispatch buffers, ssm
    # chunk-scan residuals, and the fp32 grad accumulators exceed the
    # closed-form activation terms
    floor = {"moe": 8, "ssm": 2, "hybrid": 2}.get(cfg.family, 2)
    floor = max(floor, over.get("microbatches_floor", 1))
    for n_micro in (1, 2, 4, 8, 16, 32):
        if n_micro < floor:
            continue
        if per_replica % n_micro or per_replica // n_micro < 1:
            continue
        for remat in remats:
            mem = training_memory(
                cfg, global_batch=shape.global_batch, seq=shape.seq_len, dp=dp,
                tp=max(axes_size("tp"), 1), pp=1, sp=True,
                microbatch=per_replica // n_micro, recompute=remat, zero1=True,
                opt_8bit=over.get("optimizer") == "adamw8bit",
            )
            if mem.total <= budget:
                return n_micro, remat
    return per_replica, remats[-1]


def placed(shape: tuple[int, ...], dtype: torch.dtype, spec: tuple, mesh) -> torch.Tensor:
    """An empty tensor of global `shape` (under a fake mode: no storage): off a mesh a
    plain one; on a DeviceMesh a DTensor placed by `spec` sanitized against the
    shape, holding only this rank's local shard."""
    if mesh is None:
        return torch.empty(shape, dtype=dtype)
    pl = placements(sanitize_pspec(spec, tuple(shape), mesh), mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    stride = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _tree(shapes, specs, dtypes, mesh):
    """`placed` over matching trees of shapes, specs and dtypes (a dtype tree may be
    one dtype for all); other leaves (a cache's host `pos`) are kept as they are."""
    if isinstance(shapes, dict):
        return {k: _tree(shapes[k], specs[k], dtypes[k] if isinstance(dtypes, dict) else dtypes,
                         mesh) for k in shapes}
    if isinstance(shapes, tuple) and shapes and not isinstance(shapes[0], int):
        return tuple(_tree(s, sp, dtypes, mesh) for s, sp in zip(shapes, specs))
    if isinstance(shapes, torch.Tensor):  # a meta tensor: its shape and dtype
        return placed(tuple(shapes.shape), shapes.dtype, specs, mesh)
    if isinstance(shapes, tuple):
        return placed(shapes, dtypes, specs, mesh)
    return shapes


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor of a tree."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def param_dtypes(cfg: ModelConfig) -> dict:
    """Each parameter's dtype, in the tree of `param_defs`: as JAX holds it (the head
    in the param dtype)."""
    def walk(defs):
        return {k: walk(v) if isinstance(v, dict) else v.dtype or cfg.pdtype
                for k, v in defs.items()}
    return walk(param_defs(cfg))


def _opt_dtypes(pdt: dict, tcfg: TrainConfig) -> dict:
    quant = tcfg.optimizer == "adamw8bit"

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return {"q": torch.int8, "s": torch.float32} if quant else torch.float32

    m = walk(pdt)
    return {"m": m, "v": m, "step": torch.int32}


def build_state(model: Model, shape: ShapeSpec, mesh, tcfg: TrainConfig | None = None,
                cp: bool = False) -> dict:
    """A cell's inputs under a fake mode and the current rules, each leaf placed by
    its sanitized spec on `mesh` (plain tensors off a mesh): `params` (`pspecs`, in
    JAX's dtypes), `batch` (`batch_pspecs`), and `opt` (`opt_state_specs`, with
    `tcfg`) for a train cell or `cache` (`cache_pspecs`, `pos` at the last slot)
    for a decode cell."""
    cfg = model.cfg
    pshapes = param_shapes(param_defs(cfg))
    out = {"params": _tree(pshapes, model.pspecs(), param_dtypes(cfg), mesh),
           "batch": _tree(input_specs(cfg, shape), batch_pspecs(cfg, shape), None, mesh)}
    if shape.kind == "train":
        out["opt"] = _tree(opt_state_shapes(pshapes, tcfg),
                           opt_state_specs(model.pspecs(), pshapes, tcfg),
                           _opt_dtypes(param_dtypes(cfg), tcfg), mesh)
        out["opt"]["step"] = torch.zeros((), dtype=torch.int32)
    elif shape.kind == "decode":
        out["cache"] = _tree(model.cache_shapes(shape.global_batch, shape.seq_len, cp=cp),
                             model.cache_pspecs(cp=cp), None, mesh)
        out["cache"]["pos"] = shape.seq_len - 1  # the last slot: a full cache
    return out


def _cell_policy(cfg: ModelConfig, shape: ShapeSpec, over: dict, policy, log):
    """(TrainConfig, (microbatches, remat)) of a train cell under the current rules:
    `over`'s optimizer, and `policy` or `pick_train_policy`'s; (None, None) else."""
    if shape.kind != "train":
        return None, None
    tcfg = TrainConfig(**{k: v for k, v in over.items() if k not in ("remat", "microbatches_floor")})
    policy = tuple(policy or pick_train_policy(cfg, shape, over))
    log(f"    [policy] {cfg.name}/{shape.name}: microbatches={policy[0]} remat={policy[1]}")
    return tcfg, policy


def _run_step(model: Model, shape: ShapeSpec, state: dict, tcfg, policy, cp: bool):
    """The cell's step on `state` (consumed): a train step (ZeRO-1, `policy`), the
    prefill or a decode step."""
    params, batch = state.pop("params"), state.pop("batch")
    if shape.kind == "train":
        step = make_train_step(model, ParallelConfig(microbatches=policy[0], remat=policy[1],
                                                     zero1=True), tcfg)
        return step({"params": params, "opt": state.pop("opt")}, batch)[1]
    if shape.kind == "prefill":
        return model.prefill(params, batch, max_len=shape.seq_len, cp=cp)
    return model.decode_step(params, state.pop("cache"), batch["tokens"], cp=cp)


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, rules, *, policy=None,
               over: dict | None = None, log=print) -> dict:
    """Trace one step of `cfg` at `shape` on `mesh` (None: off a mesh) under `rules`.

    Builds the state as fake tensors placed by the sanitized specs (`build_state`),
    then runs the train step (policy (microbatches, remat), or
    `pick_train_policy`'s), the prefill or a decode step, with `kernels=False`.
    Returns the trace: trace_s, memory (param, opt, cache bytes of this rank,
    peak_bytes_per_device: the tracked peak with the state and the batch
    included), cost (flops_per_device), collectives (`CollectiveInventory`'s
    summary, JAX's `collective_summary` shape: ops by kind with count and bytes,
    once_bytes, loop_bytes_per_iter, n_ops) and, for a train cell, the policy.
    """
    over = dict(over or {})
    model = Model(cfg, kernels=False)
    tracer = StepTracer()
    inventory = CollectiveInventory()
    t0 = time.perf_counter()
    out: dict = {}
    with use_mesh(mesh, rules), tracer, tracer.quiet_dtensor_meta(), shard_moves_as_alltoall():
        cp = bool(rules.cp)
        tcfg, policy = _cell_policy(cfg, shape, over, policy, log)
        if policy is not None:
            out["policy"] = {"microbatches": policy[0], "remat": policy[1]}
        state = build_state(model, shape, mesh, tcfg, cp)
        mem = {"param_bytes": local_bytes(state["params"]),
               "opt_bytes": local_bytes(state.get("opt")),
               "cache_bytes": local_bytes(state.get("cache"))}
        tracer.track(state)
        tracer.reset_peak()
        with inventory:
            _run_step(model, shape, state, tcfg, policy, cp)
    mem["peak_bytes_per_device"] = tracer.peak
    out.update(trace_s=round(time.perf_counter() - t0, 1), memory=mem,
               cost={"flops_per_device": tracer.flops}, collectives=inventory.summary())
    return out


def _fill(state: dict, vocab: int, seed: int) -> None:
    """Seeded values for `build_state`'s empty tensors, drawn on the host in the
    tree's order, so that every rank draws the same for the same local shape: the
    params N(0, 0.02), the batch's token ids in the vocabulary, the rest (moments,
    a cache) zero."""
    g = torch.Generator().manual_seed(seed)
    for part, tree in state.items():
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if not isinstance(t, torch.Tensor):
                continue
            if part == "params" and t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=g) * 0.02)
            elif part == "batch" and not t.is_floating_point():
                t.copy_(torch.randint(0, vocab, t.shape, generator=g))
            elif part == "batch":
                t.copy_(torch.randn(t.shape, generator=g))
            else:
                t.zero_()


def execute_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, rules, *, device, policy=None,
                 kernels: bool = False, seed: int = 0) -> dict:
    """`trace_cell`'s step run for real: the same state (`build_state`, this rank's
    shards on `device`, seeded by `_fill`), policy and step on `mesh`, a process
    group of real ranks, under `rules`, with `kernels` as given. Returns
    collectives (`CollectiveInventory`'s summary, as `trace_cell`'s), the ops
    themselves and, for a train cell, the step's metrics."""
    model = Model(cfg, kernels=kernels)
    inventory = CollectiveInventory()
    out: dict = {}
    with use_mesh(mesh, rules), shard_moves_as_alltoall():
        cp = bool(rules.cp)
        tcfg, policy = _cell_policy(cfg, shape, {}, policy, lambda *_: None)
        with torch.device(device):
            state = build_state(model, shape, mesh, tcfg, cp)
        _fill(state, cfg.vocab_size, seed)
        with inventory:
            result = _run_step(model, shape, state, tcfg, policy, cp)
    if shape.kind == "train":
        out["metrics"] = {k: float(v.full_tensor() if isinstance(v, DTensor) else v)
                          for k, v in result.items()}
    out.update(collectives=inventory.summary(), ops=inventory.ops)
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool, mesh=None, shape=None, cfg=None):
    """Trace one cell on the production mesh (or `mesh`) of a fake world: (trace,
    mesh, model), as JAX's returns (lowered, mesh, model). `cfg` replaces the
    arch's config (a reduced one, in tests)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        init_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = rules_for(mesh, shape)
    over = ARCH_TRAIN_OVERRIDES.get(arch, {})
    return trace_cell(cfg, shape, mesh, rules, over=over), mesh, Model(cfg, kernels=False)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, force: bool):
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(path) and not force:
        with open(path) as fh:
            rec = json.load(fh)
        if rec.get("status") == "ok":
            print(f"[skip cached] {cell_id}")
            return rec

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = applicable(cfg, shape)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "devices": 512 if multi_pod else 256,
        "status": "skipped",
        "reason": reason,
    }
    if ok:
        try:
            trace, mesh, model = lower_cell(arch, shape_name, multi_pod)
            rec.update(status="ok", param_count=model.param_count(), **trace)
            print(f"[ok] {cell_id}: trace {rec['trace_s']}s, "
                  f"peak/dev {rec['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB")
        except Exception as e:  # record failure for triage, keep sweeping
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
            print(f"[FAIL] {cell_id}: {type(e).__name__}: {e}")
    else:
        print(f"[skip n/a] {cell_id}: {reason}")

    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(rec, fh, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=ARCHS)
    ap.add_argument("--shape", nargs="*", default=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--out", default=os.path.normpath(OUT_DIR))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    init_fake_world(256 if args.mesh == "single" else 512)
    n_ok = n_fail = n_skip = 0
    try:
        for arch in args.arch:
            for shape_name in args.shape:
                for mp in meshes:
                    rec = run_cell(arch, shape_name, mp, args.out, args.force)
                    s = rec["status"]
                    n_ok += s == "ok"
                    n_fail += s == "error"
                    n_skip += s == "skipped"
    finally:
        with contextlib.suppress(Exception):
            dist.destroy_process_group()
    print(f"dry-run done: {n_ok} ok, {n_fail} failed, {n_skip} skipped (n/a)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
