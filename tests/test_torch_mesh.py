"""The port's training on a device mesh, held to its single-device run.

Gloo processes on the CPU (`torch_dist.spawn`), at `reduced()` sizes in float32
as JAX's tests run. JAX's own mesh runs fail under this jax (ROADMAP C1), so
the oracle is the port's single-device Trainer, which the train tests hold to
JAX; any sharding computes the single-device function. Every rank computes the
single-device reference itself and returns the differences.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torch_dist import spawn

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import is_dtensor, make_rules, use_mesh, whole
from repro_torch.train.train_step import loss_and_grads
from repro_torch.train.trainer import Trainer
from repro_torch.train.tree import paths
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
STEP_TOL = 1e-5  # step 1 on a mesh against one device: float32 sums in another order
LOSS_TOL = 2e-3  # a few steps on, `tests/test_multidevice.py`'s bar


def _trainer(cfg, pcfg, tcfg, mesh=None, rules=None):
    return Trainer(Model(cfg), pcfg, tcfg, CPU, mesh=mesh, rules=rules)


def _grad_diffs(cfg, pcfg, mesh, rules, batch, groups_mesh=None):
    """(loss diff, {leaf: max abs diff}, every grad a DTensor, (products selective remat
    saves on one device, on the mesh)) of one loss-and-grads on the mesh against one
    device (under `groups_mesh`, a stand-in mesh, for MoE dispatch groups)."""
    tcfg = TrainConfig(steps=3, log_every=100)
    t0, t1 = _trainer(cfg, pcfg, tcfg), _trainer(cfg, pcfg, tcfg, mesh, rules)
    s0, s1 = t0.init_state(), t1.init_state()
    with use_mesh(groups_mesh, rules), transformer.saved_record() as saved0:
        g0, m0 = loss_and_grads(t0.model, s0["params"], t0._batch(batch), pcfg.remat)
    with t1._ctx(), transformer.saved_record() as saved1:
        g1, m1 = loss_and_grads(t1.model, s1["params"], t1._batch(batch), pcfg.remat)
    leaves1 = dict(paths(g1))
    diffs = {k: float((whole(leaves1[k]) - v).abs().max()) for k, v in paths(g0)}
    return (float(abs(m0["loss"] - m1["loss"])), diffs,
            all(is_dtensor(v) for v in leaves1.values()), (len(saved0), len(saved1)))


def qwen3_dp_tp(rank, world):
    cfg = get_config("qwen3-14b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = make_rules(dp=("data",), tp=("model",))
    data = SyntheticLM(cfg.vocab_size, 64, 8)
    loss_d, diffs, placed, saved = _grad_diffs(cfg, ParallelConfig(), mesh, rules, data.batch(0))
    tcfg = TrainConfig(steps=3, log_every=100)
    h0 = _trainer(cfg, ParallelConfig(), tcfg).fit(
        _trainer(cfg, ParallelConfig(), tcfg).init_state(), data, steps=3, log=lambda *_: None)[1]
    t1 = _trainer(cfg, ParallelConfig(), tcfg, mesh, rules)
    h1 = t1.fit(t1.init_state(), data, steps=3, log=lambda *_: None)[1]
    refused = []  # a mesh larger than the world, as JAX refuses one larger than its devices
    for make in (lambda: make_mesh((2, 4), ("data", "model"), "cpu"), make_production_mesh):
        try:
            make()
        except ValueError as e:
            refused.append(str(e))
    refused = refused == ["mesh (2, 4) needs 8 devices, have 4", "mesh (16, 16) needs 256 devices, have 4"]
    return {"loss_d": loss_d, "grads": diffs, "placed": placed, "saved": saved, "refused": refused,
            "losses": ([h["loss"] for h in h0], [h["loss"] for h in h1]),
            "gnorm": (h0[0]["grad_norm"], h1[0]["grad_norm"])}


def test_qwen3_on_data_and_model_axes_matches_one_device(tmp_path):
    out = spawn(qwen3_dp_tp, 4, tmp_path, timeout=150)
    for r in out:
        assert r["placed"] and r["loss_d"] <= STEP_TOL and r["refused"]
        # selective remat sees the local products under DTensor: q, k, v, o, MLP's three a layer
        assert r["saved"] == (7 * 2, 7 * 2)
        assert max(r["grads"].values()) <= STEP_TOL, r["grads"]
        assert abs(r["gnorm"][0] - r["gnorm"][1]) <= STEP_TOL
        for a, b in zip(*r["losses"]):
            assert abs(a - b) < LOSS_TOL, r["losses"]
    assert all(r["losses"] == out[0]["losses"] for r in out)  # every rank logs the same


def _standin(mesh_shape: dict):
    """A mesh as `axes_size` reads it: the dispatch groups of a mesh on one device."""
    import types

    return types.SimpleNamespace(shape=mesh_shape)


def _reference_steps(cfg, pcfg, tcfg, data, steps, groups_mesh, rules):
    """`steps` train steps on one device under a stand-in mesh (its MoE dispatch groups)."""
    from repro_torch.train.train_step import make_train_step

    t0 = _trainer(cfg, pcfg, tcfg)
    state, hist = t0.init_state(), []
    step = make_train_step(t0.model, pcfg, tcfg)
    with use_mesh(groups_mesh, rules):
        for i in range(steps):
            state, m = step(state, t0._batch(data.batch(i)))
            hist.append({k: float(v) for k, v in m.items()})
    return hist


def deepseek_pod_dp_tp(rank, world):
    cfg = get_config("deepseek-moe-16b").reduced()
    axes = ("pod", "data", "model")
    mesh = make_mesh((2, 1, 2), axes, "cpu")
    rules = make_rules(dp=("pod", "data"), tp=("model",))
    standin = _standin(dict(zip(axes, (2, 1, 2))))
    data = SyntheticLM(cfg.vocab_size, 32, 8)
    loss_d, diffs, placed, saved = _grad_diffs(cfg, ParallelConfig(), mesh, rules, data.batch(0),
                                               groups_mesh=standin)
    pcfg, tcfg = ParallelConfig(microbatches=2), TrainConfig(steps=2, log_every=100)
    h0 = _reference_steps(cfg, pcfg, tcfg, data, 2, standin, rules)
    t1 = _trainer(cfg, pcfg, tcfg, mesh, rules)
    h1 = t1.fit(t1.init_state(), data, steps=2, log=lambda *_: None)[1]
    keys = ("loss", "grad_norm", "moe_lb_loss", "moe_z_loss", "moe_drop_frac")
    return {"loss_d": loss_d, "grads": diffs, "placed": placed, "saved": saved,
            "step1": {k: (h0[0][k], h1[0][k]) for k in keys},
            "losses": ([h["loss"] for h in h0], [h["loss"] for h in h1])}


def test_deepseek_on_pod_data_model_axes_with_microbatches(tmp_path):
    """deepseek-moe-16b on (pod 2, data 1, model 2): its dispatch groups are the two
    dp shards (capacity from each group's tokens, JAX's `_n_groups`), so the
    reference is one device running the same two groups; the experts on ep."""
    out = spawn(deepseek_pod_dp_tp, 4, tmp_path, timeout=150)
    for r in out:
        assert r["placed"] and r["loss_d"] <= STEP_TOL
        # selective remat's saved products (`test_torch_train_families.py`'s count): the
        # dense layer's 7; the MoE layer's q, k, v, o, the shared experts' 3 and a router
        # product a group, both groups' on one device, its own group's on each rank
        assert r["saved"] == (7 + 4 + 3 + 2, 7 + 4 + 3 + 1)
        assert max(r["grads"].values()) <= STEP_TOL, r["grads"]
        for k, (a, b) in r["step1"].items():
            assert abs(a - b) <= STEP_TOL, (k, a, b)
        for a, b in zip(*r["losses"]):
            assert abs(a - b) < LOSS_TOL
    assert out[0]["step1"]["moe_drop_frac"][0] > 0  # capacity drops: the groups matter


def starcoder2_compressed(rank, world):
    cfg = get_config("starcoder2-3b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = make_rules(dp=("data",), tp=("model",))
    data = SyntheticLM(cfg.vocab_size, 32, 8)
    runs = {}
    for compress, opt in ((True, "adamw"), (False, "adamw8bit")):
        pcfg = ParallelConfig(grad_compress=compress, zero1=True)
        tcfg = TrainConfig(steps=2, log_every=100, optimizer=opt)
        t0, t1 = _trainer(cfg, pcfg, tcfg), _trainer(cfg, pcfg, tcfg, mesh, rules)
        runs[opt] = (t0.fit(t0.init_state(), data, steps=2, log=lambda *_: None),
                     t1.fit(t1.init_state(), data, steps=2, log=lambda *_: None))
    (s0, h0), (s1, h1) = runs["adamw"]
    params, err = dict(paths(s1["params"])), dict(paths(s1["grad_error"]))
    moments = dict(paths(s1["opt"]["m"]))
    # each int8 moment against one device's, in codes of one device's scale
    codes = {}
    (s0, _), (s1, _) = runs["adamw8bit"]
    for name in ("m", "v"):
        one, placed = dict(paths(s0["opt"][name])), dict(paths(s1["opt"][name]))
        for k in (k.removesuffix("/q") for k in one if k.endswith("/q")):
            q0, sc0 = one[k + "/q"].float(), one[k + "/s"]
            deq1 = whole(placed[k + "/q"]).float() * whole(placed[k + "/s"])
            codes[f"{name}/{k}"] = float(((deq1 - q0 * sc0) / sc0).abs().max())
    return {"losses": ([h["loss"] for h in h0], [h["loss"] for h in h1]), "codes": codes,
            "err_placed": all(err[k].placements == p.placements for k, p in params.items()),
            "zero": {k: (p.placements, moments[k].placements) for k, p in params.items()}}


def test_starcoder2_compressed_gradients_and_zero1(tmp_path):
    """Gradient compression (a global absmax scale a leaf, the error feedback placed
    like the params) under ZeRO-1; then ZeRO-1 with int8 moments, whose row scales
    are reduced where the ZeRO axis splits a row (the stacked norm gains, the final
    norm), without compression, whose level flips would move the moments' codes."""
    from torch.distributed.tensor import Shard

    out = spawn(starcoder2_compressed, 4, tmp_path, timeout=150)
    for r in out:
        for a, b in zip(*r["losses"]):
            assert abs(a - b) <= STEP_TOL, r["losses"]
        assert r["err_placed"]  # the error feedback is placed like the params
        # the same codes to within one (the gradients' sums in another order), and the
        # same scales: a row's absmax over all its shards
        assert max(r["codes"].values()) <= 1.01, r["codes"]
    # ZeRO-1: the moments of a matrix are sharded over data on top of the param's own
    pl, ml = out[0]["zero"]["layers/mlp/wi"]
    assert not isinstance(pl[0], Shard) and isinstance(ml[0], Shard) and pl[1] == ml[1]


def elastic_restore(rank, world, ckpt_dir, saved):
    cfg = get_config("qwen3-14b").reduced()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = make_rules(dp=("data",), tp=("model",))
    data = SyntheticLM(cfg.vocab_size, 32, 8)
    tcfg = TrainConfig(steps=4, log_every=100, checkpoint_dir=ckpt_dir, checkpoint_every=1)
    t = _trainer(cfg, ParallelConfig(), tcfg, mesh, rules)
    state, step = t.ckpt.restore(t.init_state(), 1)
    equal = all(torch.equal(whole(v), saved[k]) for k, v in paths(state))
    placed = all(is_dtensor(v) for k, v in paths(state) if k != "opt/step")
    state, hist = t.fit(state, data, steps=2, start_step=1, log=lambda *_: None)
    final = {k: whole(v).clone() for k, v in paths(state)}
    t2 = _trainer(cfg, ParallelConfig(), tcfg, mesh, rules)
    state2, step2 = t2.ckpt.restore(t2.init_state(), 2)
    state2, hist2 = t2.fit(state2, data, steps=1, start_step=2, log=lambda *_: None)
    resumed = all(torch.equal(whole(v), final[k]) for k, v in paths(state2))
    # JAX's reshard test: an (8, 8) array saved on one process, restored on (data, model)
    from torch.distributed.tensor import Shard

    w, _ = CheckpointManager(os.path.join(ckpt_dir, "w")).restore(
        {"w": torch.zeros(8, 8)}, mesh=mesh, placements={"w": (Shard(0), Shard(1))})
    return {"step": step, "equal": equal, "placed": placed, "resumed": resumed,
            "losses": (hist[-1]["loss"], hist2[-1]["loss"]), "w_local": w["w"].to_local(),
            "w_whole": whole(w["w"])}


def test_elastic_restore_from_one_process_onto_a_mesh(tmp_path):
    """Save on one process, restore on (data 2, model 2): the arrays equal, every
    leaf placed; then a mesh run saved at each step resumes bit for bit."""
    cfg = get_config("qwen3-14b").reduced()
    ckpt = str(tmp_path / "ckpt")
    tcfg = TrainConfig(steps=1, log_every=100, checkpoint_dir=ckpt, checkpoint_every=1)
    t = _trainer(cfg, ParallelConfig(), tcfg)
    state, _ = t.fit(t.init_state(), SyntheticLM(cfg.vocab_size, 32, 8), steps=1,
                     log=lambda *_: None)
    saved = {k: v.clone() for k, v in paths(state)}
    CheckpointManager(os.path.join(ckpt, "w")).save(
        1, {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}, async_=False)
    out = spawn(elastic_restore, 4, tmp_path / "pg", ckpt, saved, timeout=150)
    for rank, r in enumerate(out):
        assert r["step"] == 1 and r["equal"] and r["placed"] and r["resumed"]
        assert r["losses"][0] == r["losses"][1]
        np.testing.assert_array_equal(r["w_whole"].numpy().ravel(), np.arange(64))
        i, j = divmod(rank, 2)  # this rank's (data, model) coordinate
        np.testing.assert_array_equal(r["w_local"].numpy(),
                                      np.arange(64).reshape(8, 8)[4 * i:4 * i + 4, 4 * j:4 * j + 4])


def test_launcher_trains_on_a_mesh_under_torchrun(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--arch", "qwen3-14b", "--mesh", "2x2",
         "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "32"],
        capture_output=True, text=True, timeout=150, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    done = [ln for ln in res.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1 and "mesh 2x2" in done[0]  # rank 0 alone prints
