"""The port's Trainer and launcher on the CPU (no JAX): a resumed Trainer bit for
bit, the loss going down through the launcher's `run`, the command line, and a
batch of embeds. The helpers and bars of `test_torch_train.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models.transformer import Model
from repro_torch.train.train_step import loss_and_grads
from repro_torch.train.trainer import Trainer
from test_torch_train import CPU, S, TCFG
from torch_threads import one_thread  # noqa: F401


def test_trainer_resume_is_bit_for_bit(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, and a fresh Trainer that
    resumes at step 2 and takes steps 2-3 of the same data."""
    cfg = get_config("h2o_danube_1p8b").reduced(attn_impl="chunked")
    data = tdata.SyntheticLM(cfg.vocab_size, S, 2)
    quiet = dict(log=lambda *_: None)
    straight = Trainer(Model(cfg), ParallelConfig(), TrainConfig(**TCFG), CPU)
    _, hist = straight.fit(straight.init_state(), data, steps=4, **quiet)
    tc = TrainConfig(**TCFG, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    first = Trainer(Model(cfg), ParallelConfig(), tc, CPU)
    first.fit(first.init_state(), data, steps=2, **quiet)
    second = Trainer(Model(cfg), ParallelConfig(), tc, CPU)
    state, start = second.resume()
    assert start == 2
    _, resumed = second.fit(state, data, steps=2, start_step=start, **quiet)
    assert [h["loss"] for h in resumed] == [h["loss"] for h in hist[2:]]
    assert [h["grad_norm"] for h in resumed] == [h["grad_norm"] for h in hist[2:]]


def test_training_reduces_the_loss():
    """The quickstart's check, through the launcher's `run` on the CPU."""
    cfg = get_config("qwen3_14b").reduced(num_layers=2, d_model=128, d_ff=256)
    out = tlaunch.run(cfg, device="cpu", batch=8, seq=32, steps=30, log=lambda *_: None)
    assert len(out["losses"]) == 30 and all(np.isfinite(out["losses"]))
    assert np.mean(out["losses"][-5:]) < out["losses"][0] - 0.3
    assert out["max_memory_allocated"] is None  # not a device number on the CPU
    assert all(not any(n.values()) for n in out["launches_per_step"])  # plain versions: no launch


def test_launcher_command_line(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["train", "--arch", "starcoder2-3b", "--device", "cpu",
                                     "--steps", "2", "--batch", "2", "--seq", "32"])
    tlaunch.main()
    assert "done: final loss" in capsys.readouterr().out
    # a mesh needs its processes (torchrun's; `tests/test_torch_mesh.py`): one process
    # is a world of one device, as JAX's launcher refuses a mesh larger than its devices
    monkeypatch.setattr("sys.argv", ["train", "--arch", "qwen3-14b", "--device", "cpu",
                                     "--mesh", "2x4"])
    with pytest.raises(ValueError, match=r"mesh \(2, 4\) needs 8 devices, have 1"):
        tlaunch.main()
    # the analytical planner (`repro_torch.core.planner`) prints its plans and touches
    # no device; `tests/test_torch_planner.py` holds them to JAX's line for line
    monkeypatch.setattr("sys.argv", ["train", "--arch", "qwen3-14b", "--device", "cpu",
                                     "--auto-plan"])
    tlaunch.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "auto-plan: qwen3-14b on 256 x TPU-v5e, batch 8"
    assert len(out) > 1
    assert all(line.startswith("  dp") and "[fits]" in line for line in out[1:])


def test_embeds_batch_trains_the_rest():
    """A vlm config fed embeds: its token table gets zero gradients, as in JAX."""
    cfg = dataclasses.replace(get_config("pixtral_12b").reduced(), input_mode="embeds")
    model = Model(cfg)
    params = model.init(0, CPU, widen_head=False)
    rng = np.random.default_rng(0)
    batch = {"embeds": torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model), dtype=np.float32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))}
    grads, _ = loss_and_grads(model, params, batch, "selective")
    assert not grads["embed"]["tok"].any() and grads["lm_head"]["w"].any()
