"""RWKV6's token shift, ddlerp and channel mix on a rank's own sequence block, with
a one-row halo (ROADMAP C20).

- `parallel.axes.shift_rows` on (data 2, model 2) gloo processes, the sequence
  split over "model": each rank's block shifted by one row, its first row the
  previous block's last, forward and backward equal to the whole sequence's
  `F.pad` shift bit for bit, float32 and bf16; `axes.last_row` the whole
  sequence's last row bit for bit.
- `models.rwkv6.time_mix_seq` and `channel_mix_seq` at `reduced()` on the same
  mesh under `rules_for(mesh)` (sequence parallelism on), S 48 split in two
  blocks of 24, so that a block boundary falls inside the first 32-token chunk:
  output, state (`shift` the whole sequence's last row, bit for bit; `wkv`) and
  every gradient against one device at the mesh tests' bar (1e-5, float32);
  the ddlerp and the channel mix run on the (B / 2, 24, D) blocks.
- a fake-world trace of rwkv6-7b at full width, 1 layer, train_4k on the
  production 16 x 16 mesh: no rank forms a (B_local, S, 5, D) tensor, the
  ddlerp runs on (B_local, 256, 4096) blocks, and the trace's peak stays under
  the parent's whole-sequence layout's.

No JAX: the port on a mesh is held to the port on one device, which
`tests/test_torch_rwkv6.py` holds to JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from torch_dist import spawn

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh, rules_for
from repro_torch.models import rwkv6
from repro_torch.models.params import _rwkv6_layer_defs, distribute, init_params, param_specs
from repro_torch.parallel import axes
from test_torch_mesh import STEP_TOL
from torch_threads import one_thread  # noqa: F401

B, S = 4, 48  # two blocks of 24 over "model": the boundary inside chunk [0, 32)


def _placed(t, mesh, *names):
    return distribute_tensor(t, mesh, axes.placements(axes.activation_pspec(
        names, tuple(t.shape), mesh), mesh))


# ---------------------------------------------------------------- the helper

def gloo_shift(rank, world):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = rules_for(mesh)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(B, S, 8, generator=gen).to(dtype)
        g = torch.randn(B, S, 8, generator=gen).to(dtype)
        ref_x = x.clone().requires_grad_(True)
        ref = F.pad(ref_x, (0, 0, 1, 0))[:, :S]
        (ref.float() * g.float()).sum().backward()
        with axes.use_mesh(mesh, rules):
            xd = _placed(x, mesh, "dp", "sp", None).requires_grad_(True)
            y = axes.shift_rows(xd)
            last = axes.last_row(xd)
            (y * _placed(g, mesh, "dp", "sp", None)).float().sum().backward()
        out[str(dtype)] = {
            "split": xd.placements == (Shard(0), Shard(1)) and y.placements == xd.placements,
            "local": tuple(y.to_local().shape),
            "fwd": torch.equal(y.full_tensor(), ref.detach()),
            "bwd": torch.equal(xd.grad.full_tensor(), ref_x.grad),
            "last": torch.equal(last.full_tensor(), x[:, -1]),
            "last_placed": tuple(last.placements)}
    return out


def test_shift_rows_equals_the_whole_sequence_shift_on_gloo(tmp_path):
    """Each rank's block shifted with its neighbour's last row equals the whole
    sequence's shift, and its gradient the whole shift's gradient, bit for bit;
    the last row is the whole sequence's, placed ("dp", None)."""
    for res in spawn(gloo_shift, 4, tmp_path, timeout=120):
        for dtype, r in res.items():
            assert r["split"], dtype
            assert r["local"] == (B // 2, S // 2, 8), dtype
            assert r["fwd"] and r["bwd"], dtype
            assert r["last"], dtype
            assert r["last_placed"] == (Shard(0), Replicate()), dtype


def test_halo_and_last_row_are_one_row_each_in_the_inventory():
    """On a fake 16 x 16 world, rank 0 (the first sequence block) sends its last row
    forward and receives the next block's row gradient backward: one
    collective-permute of B_local x D elements (a recv is counted where it lands);
    the last row is one collective-broadcast of B_local x D; nothing is gathered."""
    from repro_torch.core.hlo import CollectiveInventory

    dryrun.init_fake_world(256)
    try:
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        tracer, inventory = dryrun.StepTracer(), CollectiveInventory()
        with axes.use_mesh(mesh, rules_for(mesh)), tracer, tracer.quiet_dtensor_meta():
            x = DTensor.from_local(torch.empty(8, 256, 64, dtype=torch.bfloat16), mesh,
                                   [Shard(0), Shard(1)], run_check=False,
                                   shape=torch.Size((128, 4096, 64)),
                                   stride=(4096 * 64, 64, 1)).requires_grad_(True)
            with inventory:
                axes.shift_rows(x).float().sum().backward()
                axes.last_row(x)
    finally:
        dist.destroy_process_group()
    row = 8 * 64 * 2
    assert [(o.kind, o.bytes) for o in inventory.ops] == [("collective-permute", row),
                                                           ("collective-broadcast", row)]


# ---------------------------------------------------------------- the mixes

def _layer(cfg):
    params = init_params(cfg, 0, torch.device("cpu"), widen_head=False)["layers"]
    take = lambda t: {k: take(v) if isinstance(v, dict) else v[0].clone() for k, v in t.items()}  # noqa: E731
    return take(params)


def _run(cfg, part, p, x, g):
    """(out, state, {name: gradient}) of `part`'s loss sum(out * g)."""
    fn = rwkv6.time_mix_seq if part == "tm" else rwkv6.channel_mix_seq
    out, state = fn(cfg, p, x)
    (out * g).sum().backward()
    grads = {"x": x.grad}
    grads.update({k: v.grad for k, v in p.items() if not isinstance(v, dict)})
    grads.update({f"ln_x/{k}": v.grad for k, v in p.get("ln_x", {}).items()})
    return out, state, grads


def gloo_mixes(rank, world, part):
    cfg = get_config("rwkv6-7b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = rules_for(mesh)
    layer = _layer(cfg)[part]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model), dtype=np.float32))

    def leafy(tree):
        return {k: leafy(v) if isinstance(v, dict) else v.clone().requires_grad_(True)
                for k, v in tree.items()}

    p0, x0 = leafy(layer), x.clone().requires_grad_(True)
    out0, state0, grads0 = _run(cfg, part, p0, x0, g)
    seen = []  # the token rows each ddlerp / channel mix works on
    orig = {"ddlerp": rwkv6._ddlerp, "cm": rwkv6._channel_mix}

    def record(name):
        def fn(p, x, xprev, *a):
            seen.append((name, tuple(x.shape)))
            return orig[name](p, x, xprev, *a)
        return fn

    rwkv6._ddlerp, rwkv6._channel_mix = record("ddlerp"), record("cm")
    try:
        with axes.use_mesh(mesh, rules):
            specs = param_specs(_rwkv6_layer_defs(cfg))[part]
            p1 = distribute(leafy(layer), specs, mesh)
            p1 = {k: {kk: vv.detach().requires_grad_(True) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.detach().requires_grad_(True)
                  for k, v in p1.items()}
            x1 = _placed(x, mesh, "dp", "sp", None).requires_grad_(True)
            out1, state1, grads1 = _run(cfg, part, p1, x1, _placed(g, mesh, "dp", "sp", None))
    finally:
        rwkv6._ddlerp, rwkv6._channel_mix = orig["ddlerp"], orig["cm"]
    diffs = {k: float((axes.whole(grads1[k]) - v).abs().max()) for k, v in grads0.items()}
    return {"sp": rules.sp, "out": float((axes.whole(out1) - out0).abs().max().detach()),
            "out_placed": tuple(out1.placements),
            "shift": torch.equal(axes.whole(state1["shift"]), state0["shift"]),
            "wkv": (float((axes.whole(state1["wkv"]) - state0["wkv"]).abs().max())
                    if "wkv" in state0 else 0.0),
            "grads": diffs, "grad_placed": {  # each as its parameter, or a partial sum
                k: (tuple(grads1[k].placements), tuple(p1[k].placements))  # where it is whole
                for k in grads1 if k in p1 and any(
                    a != b and not (a.is_partial() and b.is_replicate())
                    for a, b in zip(grads1[k].placements, p1[k].placements))},
            "seen": seen}


@pytest.mark.parametrize("part", ["tm", "cm"])
def test_mixes_on_sequence_blocks_match_one_device(part, tmp_path):
    """The time mix and the channel mix with the sequence split over "model" equal
    one device's: output, state and every gradient within the mesh tests' bar, the
    shift row bit for bit; each gradient placed as its parameter (a partial sum
    over the ranks where the parameter is whole); the ddlerp and
    the channel mix see a rank's (B / 2, S / 2, D) block, never the sequence."""
    cfg = get_config("rwkv6-7b").reduced()
    for res in spawn(gloo_mixes, 4, tmp_path, part, timeout=150):
        assert res["sp"] == ("model",)
        assert res["out"] <= STEP_TOL, res["out"]
        assert res["out_placed"] == (Shard(0), Shard(1))
        assert res["shift"]
        assert res["wkv"] <= STEP_TOL, res["wkv"]
        assert max(res["grads"].values()) <= STEP_TOL, res["grads"]
        assert not res["grad_placed"], res["grad_placed"]
        name = "ddlerp" if part == "tm" else "cm"
        assert res["seen"] == [(name, (B // 2, S // 2, cfg.d_model))]


# ---------------------------------------------------------------- the trace

class _Shapes(dryrun.StepTracer):
    """`StepTracer` that keeps the shape of every storage it tracks."""

    made: list = []

    def __init__(self):
        super().__init__()
        self.shapes: list[tuple[int, ...]] = []
        _Shapes.made.append(self)

    def track(self, tree) -> None:
        for t in torch.utils._pytree.tree_leaves(tree):
            if isinstance(t, torch.Tensor) and not axes.is_dtensor(t):
                self.shapes.append(tuple(t.shape))
        super().track(tree)


def test_traced_rwkv6_7b_layer_works_on_its_blocks(monkeypatch):
    """rwkv6-7b at full width and 1 layer, train_4k on a fake 16 x 16 world, one
    microbatch without remat (B_local 16): no tracked tensor is a (16, 4096, 5,
    4096) or any (B_local, S, 5, D); the ddlerp runs on (16, 256, 4096) blocks;
    and the peak a rank is under 14 GiB, where the whole-sequence layout's was
    19.40 (two (16, 4096, 5, 4096) bf16 ddlerp tensors of 2.5 GiB among them)."""
    cfg = dataclasses.replace(get_config("rwkv6_7b"), num_layers=1)
    shape = SHAPES["train_4k"]
    seen = []
    orig = rwkv6._ddlerp

    def record(p, x, xprev):
        seen.append(tuple(x.shape))
        return orig(p, x, xprev)

    monkeypatch.setattr(rwkv6, "_ddlerp", record)
    monkeypatch.setattr(dryrun, "StepTracer", _Shapes)
    dryrun.init_fake_world(256)
    try:
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        trace = dryrun.trace_cell(cfg, shape, mesh, rules_for(mesh, shape), policy=(1, "none"),
                                  over=dryrun.ARCH_TRAIN_OVERRIDES["rwkv6_7b"],
                                  log=lambda *_: None)
    finally:
        dist.destroy_process_group()
    shapes = _Shapes.made[-1].shapes
    assert not [s for s in shapes if len(s) == 4 and s[2:] == (5, 4096) and s[1] > 256]
    assert seen and set(seen) == {(16, 256, 4096)}
    assert trace["memory"]["peak_bytes_per_device"] < 14 * 2**30


# ---------------------------------------------------------------- chip_smoke

def test_phase_layout_rwkv6_rehearsal(capsys):
    """Phase 16 (c) at `reduced()` width on the CPU: 4 sequence blocks, each with its
    neighbour's last row, against the whole sequence within the phase's bar, the
    five mixes bit for bit (elementwise on each row)."""
    from test_torch_smoke_plan import chip_smoke

    cfg = get_config("rwkv6-7b").reduced()
    rec = chip_smoke.phase_layout_rwkv6(torch.device("cpu"), "cpu", cfg, batch=2, seq=64,
                                        blocks=4, memory=False)
    assert rec["worst_floors"] <= 2
    assert {"xw", "xk", "xv", "xr", "xg"} <= set(rec["exact"])
    assert "as 4 sequence blocks each with its left neighbour's last row" in capsys.readouterr().out


def test_phase_alltoall_rehearsal_gathers_a_later_dim(tmp_path):
    """Phase 14 (d)'s gather on a one-rank gloo group of the CPU: one all-gather of the
    result's bytes through `axes.gather_dims`, the output the input."""
    from test_torch_smoke_plan import chip_smoke

    rec = chip_smoke.phase_alltoall(torch.device("cpu"), "cpu", shape=(64, 32), backend="gloo",
                                    init_method=f"file://{tmp_path}/pg")
    assert rec["gathered"] == [("all-gather", 64 * 32 * 2)]
