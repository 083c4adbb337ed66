"""The hybrid and ssm families, and qwen3, trained on a device mesh with sequence
parallelism, held to the port's single-device run.

Gloo processes on the CPU (`torch_dist.spawn`), (data 2, model 2) under
`rules_for(mesh)`, which turns sequence parallelism on (JAX's dry-run rules),
at `reduced()` sizes in float32. The bars are `tests/test_torch_mesh.py`'s:
step 1's loss, grad_norm and every gradient leaf within 1e-5 of one device,
the losses within 2e-3 over 3 steps. Every rank computes the single-device
reference itself and returns the differences.
"""

import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import Shard

from torch_dist import spawn

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_mesh, rules_for
from repro_torch.parallel.axes import whole
from repro_torch.train.tree import paths
from test_torch_mesh import LOSS_TOL, ROOT, STEP_TOL, _grad_diffs, _trainer
from torch_threads import one_thread  # noqa: F401

# zamba2 at 5 layers: two segments [shared block, 2 Mamba2 layers] and a tail
# [shared block, 1 Mamba2 layer], so both cache forms and the shared block's
# gradient summed over three applications run; 96 tokens, three RWKV6 chunks
RUNS = {
    "zamba2-1.2b": (dict(num_layers=5), TrainConfig(steps=3, log_every=100), 96),
    "rwkv6-7b": (dict(), TrainConfig(steps=3, log_every=100, optimizer="adamw8bit"), 96),
    "qwen3-14b": (dict(), TrainConfig(steps=3, log_every=100), 64),
}


def train_on_mesh(rank, world, arch, ckpt_dir):
    overrides, tcfg, seq = RUNS[arch]
    cfg = get_config(arch).reduced(**overrides)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = rules_for(mesh)
    data = SyntheticLM(cfg.vocab_size, seq, 8)
    pcfg = ParallelConfig()
    loss_d, diffs, placed, _ = _grad_diffs(cfg, pcfg, mesh, rules, data.batch(0))
    t0 = _trainer(cfg, pcfg, tcfg)
    h0 = t0.fit(t0.init_state(), data, steps=3, log=lambda *_: None)[1]
    tcfg1 = TrainConfig(**{**vars(tcfg), "checkpoint_dir": ckpt_dir, "checkpoint_every": 1})
    t1 = _trainer(cfg, pcfg, tcfg1, mesh, rules)
    s1, h1 = t1.fit(t1.init_state(), data, steps=3, log=lambda *_: None)
    final = {k: whole(v).clone() for k, v in paths(s1)}
    # restore step 2 on a fresh Trainer and take step 3 again: the same state bit for bit
    t2 = _trainer(cfg, pcfg, tcfg1, mesh, rules)
    s2, at = t2.ckpt.restore(t2.init_state(), 2)
    s2, _ = t2.fit(s2, data, steps=1, start_step=2, log=lambda *_: None)
    resumed = at == 2 and all(torch.equal(whole(v), final[k]) for k, v in paths(s2))
    # elastic: the mesh run's last checkpoint restored on one device, whole
    t3 = _trainer(cfg, pcfg, tcfg1)
    s3, at = t3.ckpt.restore(t3.init_state(), 3)
    elastic = at == 3 and all(torch.equal(v, final[k]) for k, v in paths(s3))
    moments = {k: tuple(v.placements) for k, v in paths(s1["opt"]) if hasattr(v, "placements")}
    return {"loss_d": loss_d, "grads": diffs, "placed": placed, "resumed": resumed and elastic,
            "losses": ([h["loss"] for h in h0], [h["loss"] for h in h1]),
            "gnorm": (h0[0]["grad_norm"], h1[0]["grad_norm"]), "sp": rules.sp,
            "zero": any(isinstance(p[0], Shard) for p in moments.values())}


@pytest.mark.parametrize("arch", list(RUNS))
def test_trains_on_data_and_model_axes_with_sp_as_one_device(arch, tmp_path):
    """Step 1 leaf by leaf and three steps against one device (int8 moments for
    rwkv6); ZeRO-1 shards the moments over data; a checkpoint of the mesh run
    restored on a fresh Trainer resumes bit for bit, and restored on one device
    (elastic) equals the mesh run's state."""
    out = spawn(train_on_mesh, 4, tmp_path / "pg", arch, os.fspath(tmp_path / "ckpt"), timeout=150)
    for r in out:
        assert (r["sp"], r["placed"], r["zero"], r["resumed"]) == (("model",), True, True, True)
        assert r["loss_d"] <= STEP_TOL, r["loss_d"]
        assert max(r["grads"].values()) <= STEP_TOL, r["grads"]
        assert abs(r["gnorm"][0] - r["gnorm"][1]) <= STEP_TOL
        for a, b in zip(*r["losses"]):
            assert abs(a - b) < LOSS_TOL, r["losses"]
    assert all(r["losses"] == out[0]["losses"] for r in out)  # every rank logs the same


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_launcher_trains_the_recurrent_families_on_a_mesh(arch, tmp_path):
    """`launch.train --mesh 2x2` under `torchrun` takes the hybrid and ssm families."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "repro_torch.launch.train", "--arch", arch, "--mesh", "2x2", "--device", "cpu",
         "--steps", "2", "--batch", "4", "--seq", "32"],
        capture_output=True, text=True, timeout=150, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    done = [ln for ln in res.stdout.splitlines() if ln.startswith("done:")]
    assert len(done) == 1 and "mesh 2x2" in done[0]
