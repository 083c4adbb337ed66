"""What a rank holds of the batch, the token table and Mamba2's columns on a mesh
(ROADMAP C15, C16, and Mamba2's whole columns).

- The microbatch split moves rows, point to point within the dp ranks
  (`axes.take_rows`): microbatch i is the global rows [i B / n, (i + 1) B / n),
  JAX's reshape, and no rank holds more than its own rows of one microbatch.
- The token lookup is vocab-parallel (`layers.VocabParallelEmbedding`): the
  table's gradient is formed on each rank's block, (V / tp, d), never whole.
- Mamba2's in-projection, conv and SSD run on each rank's own columns
  (`mamba2.own_columns`): no training or prefill tensor on a tp rank carries
  `conv_dim` or `d_in_proj` columns (decode keeps them whole: one token).

Gloo processes on the CPU (`torch_dist.spawn`) at `reduced()` sizes in float32,
held to the port's single-device run at `tests/test_torch_mesh.py`'s bars (step
1 within 1e-5 leaf by leaf, losses within 2e-3 over 3 steps) and
`tests/test_torch_mesh_serve.py`'s (logits within 2e-3, greedy tokens equal).
Every rank records the local shapes its step computes (`LocalShapes`).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Partial, Shard

from torch_dist import spawn

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import make_mesh, rules_for
from repro_torch.models import mamba2
from repro_torch.models.params import distribute
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import make_rules, use_mesh, whole
from repro_torch.train import train_step as ts
from repro_torch.train.train_step import loss_and_grads
from repro_torch.train.tree import paths
from test_torch_mesh import LOSS_TOL, STEP_TOL, _standin, _trainer
from test_torch_mesh_layout import QWEN3, ZAMBA2_G2, LocalShapes
from test_torch_mesh_serve import LOGIT_TOL
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
PIXTRAL = dataclasses.replace(get_config("pixtral_12b").reduced(), input_mode="embeds")
DEEPSEEK = get_config("deepseek-moe-16b").reduced()


class Embeds:
    """Seeded batches of embeddings and labels, the same on every rank."""

    def __init__(self, cfg, seq: int, batch: int):
        self.cfg, self.seq, self.batch_size = cfg, seq, batch

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(step)
        B, S = self.batch_size, self.seq
        return {"embeds": rng.standard_normal((B, S, self.cfg.d_model), dtype=np.float32),
                "labels": rng.integers(0, self.cfg.vocab_size, (B, S)).astype(np.int32)}


@contextlib.contextmanager
def first_update_grads():
    """The gradients the first optimizer update of a train step is given: the
    microbatches' accumulated gradients."""
    seen, orig = {}, ts.adamw_update

    def grab(params, grads, opt, tcfg):
        seen.setdefault("grads", grads)
        return orig(params, grads, opt, tcfg)

    ts.adamw_update = grab
    try:
        yield seen
    finally:
        ts.adamw_update = orig


def _steps_on_mesh(cfg, pcfg, mesh, rules, data, shapes, groups_mesh=None, steps=3):
    """(step 1's accumulated gradients' max |diff| leaf by leaf, the losses of one
    device and of the mesh) over `steps` train steps; `shapes` records the mesh's
    first step; `groups_mesh`, a stand-in mesh, gives one device the MoE dispatch
    groups of the mesh's dp shards."""
    tcfg = TrainConfig(steps=steps, log_every=100)
    t0, t1 = _trainer(cfg, pcfg, tcfg), _trainer(cfg, pcfg, tcfg, mesh, rules)
    s0, s1 = t0.init_state(), t1.init_state()
    losses = ([], [])
    for i in range(steps):
        groups = use_mesh(groups_mesh, rules) if groups_mesh else contextlib.nullcontext()
        with first_update_grads() as g0, groups:
            s0, m0 = t0._step(s0, t0._batch(data.batch(i)))
        batch = t1._batch(data.batch(i))  # each rank keeps its rows of the global batch
        record = shapes if i == 0 else contextlib.nullcontext()
        with first_update_grads() as g1, t1._ctx(), record:
            s1, m1 = t1._step(s1, batch)
        if i == 0:
            leaves1 = dict(paths(g1["grads"]))
            diffs = {k: float((whole(leaves1[k]) - v).abs().max()) for k, v in paths(g0["grads"])}
        losses[0].append(float(m0["loss"]))
        losses[1].append(float(whole(m1["loss"])))
    return diffs, losses


def embeds_rows(rank, world):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    shapes = LocalShapes()
    diffs, losses = _steps_on_mesh(PIXTRAL, ParallelConfig(microbatches=2), mesh, rules_for(mesh),
                                   Embeds(PIXTRAL, 32, 8), shapes)
    # a batch tensor's local blocks: (rows, S, d_model)
    rows = {s[0] for s in shapes.shapes if len(s) == 3 and s[1:] == (32, PIXTRAL.d_model)}
    return {"grads": diffs, "losses": losses, "rows": rows}


def test_embeds_microbatches_move_rows_only(tmp_path):
    """pixtral-12b from embeddings, 2 microbatches of a global batch of 8 on (data 2,
    model 2): step 1's accumulated gradients within 1e-5 of one device leaf by leaf
    and three losses within 2e-3; no local tensor of the batch's shape holds more
    rows than the rank's own, 8 / 2 of the batch and 8 / 2 / 2 of a microbatch (the
    split gathered all 8 before)."""
    out = spawn(embeds_rows, 4, tmp_path, timeout=150)
    for r in out:
        assert max(r["grads"].values()) <= STEP_TOL, r["grads"]
        for a, b in zip(*r["losses"]):
            assert abs(a - b) < LOSS_TOL, r["losses"]
        # its own rows of the batch (a view of them) and of each microbatch, nothing more
        assert r["rows"] == {8 // 2, 8 // 2 // 2}, r["rows"]


def rows_moved(rank, world):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.parallel.axes import take_rows

    out = {}
    batch = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    for axes, dp in ((("data", "model"), (Shard(0), Replicate())),
                     (("pod", "data"), (Shard(0), Shard(0)))):
        mesh = make_mesh((2, 2), axes, "cpu")
        t = distribute_tensor(batch, mesh, dp, src_data_rank=None)
        for start, stop, pl in ((4, 8, dp), (1, 4, (Replicate(), Replicate()))):
            part = take_rows(t, start, stop, pl)
            out[(axes, start, stop)] = (tuple(part.placements) == pl,
                                        torch.equal(part.full_tensor(), batch[start:stop]),
                                        tuple(part.to_local().shape))
    return out


def test_take_rows_moves_each_rank_its_rows(tmp_path):
    """`axes.take_rows` on 4 gloo processes: a batch of 8 rows on dp (data 2, or
    pod 2 x data 2) gives rows [4, 8) placed as the batch, each rank 4 / dp of
    them, and rows [1, 4), which dp does not divide, whole on every rank, both
    equal to the global slice."""
    out = spawn(rows_moved, 4, tmp_path, timeout=120)
    for r in out:
        for (axes, start, stop), (placed, equal, local) in r.items():
            rows = (stop - start) // (2 if axes[0] == "data" else 4) if start == 4 else stop - start
            assert placed and equal and local == (rows, 3), (axes, start, stop, r)


def moe_partition(rank, world):
    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    rules = make_rules(dp=("data",), tp=("model",))
    standin = _standin({"data": 2, "model": 1})
    diffs, losses = _steps_on_mesh(DEEPSEEK, ParallelConfig(microbatches=2), mesh, rules,
                                   SyntheticLM(DEEPSEEK.vocab_size, 32, 8), LocalShapes(),
                                   groups_mesh=standin)
    return {"grads": diffs, "losses": losses}


def test_moe_microbatches_keep_the_partition(tmp_path):
    """deepseek-moe-16b, 2 microbatches on (data 2, model 1): each microbatch is
    the same global rows as on one device, so its routing under capacity is the
    same (one device runs the mesh's dp shards as its dispatch groups); step 1
    leaf by leaf within 1e-5 and three losses within 2e-3."""
    out = spawn(moe_partition, 2, tmp_path, timeout=150)
    for r in out:
        assert max(r["grads"].values()) <= STEP_TOL, r["grads"]
        for a, b in zip(*r["losses"]):
            assert abs(a - b) < LOSS_TOL, r["losses"]


def table_grad(rank, world):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = rules_for(mesh)
    data = SyntheticLM(QWEN3.vocab_size, 32, 8)
    tcfg = TrainConfig(steps=3, log_every=100)
    t0, t1 = _trainer(QWEN3, ParallelConfig(), tcfg), _trainer(QWEN3, ParallelConfig(), tcfg, mesh,
                                                               rules)
    s0, s1 = t0.init_state(), t1.init_state()
    g0, m0 = loss_and_grads(t0.model, s0["params"], t0._batch(data.batch(0)), None)
    shapes = LocalShapes()
    with t1._ctx(), shapes:
        g1, m1 = loss_and_grads(t1.model, s1["params"], t1._batch(data.batch(0)), None)
    leaves1 = dict(paths(g1))
    tok = g1["embed"]["tok"]
    diffs = {k: float((whole(leaves1[k]) - v).abs().max()) for k, v in paths(g0)}
    steps = _steps_on_mesh(QWEN3, ParallelConfig(), mesh, rules, data, LocalShapes())[1]
    return {"loss_d": float(abs(m0["loss"] - whole(m1["loss"]))), "grads": diffs, "steps": steps,
            "tok": (tuple(tok.to_local().shape), [str(p) for p in tok.placements]),
            "whole": (QWEN3.vocab_size, QWEN3.d_model) in shapes.shapes}


def test_token_table_gradient_stays_split(tmp_path):
    """qwen3 on (data 2, model 2), sp on: step 1 within 1e-5 of one device leaf by
    leaf and three losses within 2e-3; `embed/tok`'s gradient is (V / tp, d) on
    every rank, split over model and a partial sum over data, and no (V, d) tensor
    is made in the step."""
    out = spawn(table_grad, 4, tmp_path, timeout=150)
    V, d = QWEN3.vocab_size, QWEN3.d_model
    for r in out:
        assert r["loss_d"] <= STEP_TOL and max(r["grads"].values()) <= STEP_TOL, r["grads"]
        for a, b in zip(*r["steps"]):
            assert abs(a - b) < LOSS_TOL, r["steps"]
        assert r["tok"] == ((V // 2, d), [str(Partial()), str(Shard(0))]), r["tok"]
        assert not r["whole"]


def _wide(shapes: set, cfg) -> set:
    """The recorded shapes of activations (3 dims or more) whose last dim is Mamba2's
    whole `conv_dim` or `d_in_proj`."""
    d_inner, H, conv_dim = mamba2.dims(cfg)
    cols = {conv_dim, 2 * d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state + H}
    return {s for s in shapes if len(s) >= 3 and s[-1] in cols}


def _serve_prefill_shapes(cfg, mesh, prompt: int, steps: int, max_len: int):
    """(logits max |diff|, tokens equal, the prefill's local shapes) of a greedy serve
    on the mesh against one device."""
    model = Model(cfg)
    params = model.init(0, CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, prompt)))
    shapes = LocalShapes()

    def greedy(p, record):
        with record:
            logits, cache = model.prefill(p, {"tokens": toks}, max_len)
        outs, out_toks = [logits], []
        for _ in range(steps):
            tok = logits.argmax(-1, keepdim=True)
            out_toks.append(int(tok[0, 0]))
            logits, cache = model.decode_step(p, cache, tok)
            outs.append(logits)
        return torch.cat(outs), out_toks

    ref, ref_toks = greedy(params, contextlib.nullcontext())
    with use_mesh(mesh, make_rules(tp=("model",))):
        out, out_toks = greedy(distribute(params, model.pspecs(), mesh), shapes)
    return float((out - ref).abs().max()), ref_toks == out_toks, shapes.shapes


def mamba2_columns(rank, world, mesh_shape):
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    rules = rules_for(mesh)
    data = SyntheticLM(ZAMBA2_G2.vocab_size, 32, 8)
    tcfg = TrainConfig(steps=3, log_every=100)
    t0, t1 = (_trainer(ZAMBA2_G2, ParallelConfig(), tcfg),
              _trainer(ZAMBA2_G2, ParallelConfig(), tcfg, mesh, rules))
    s0, s1 = t0.init_state(), t1.init_state()
    g0, m0 = loss_and_grads(t0.model, s0["params"], t0._batch(data.batch(0)), None)
    shapes = LocalShapes()
    with t1._ctx(), shapes:
        g1, m1 = loss_and_grads(t1.model, s1["params"], t1._batch(data.batch(0)), None)
    leaves1 = dict(paths(g1))
    diffs = {k: float((whole(leaves1[k]) - v).abs().max()) for k, v in paths(g0)}
    steps = _steps_on_mesh(ZAMBA2_G2, ParallelConfig(), mesh, rules, data, LocalShapes())[1]
    err, same, served = _serve_prefill_shapes(ZAMBA2_G2, mesh, prompt=7, steps=5, max_len=16)
    return {"loss_d": float(abs(m0["loss"] - whole(m1["loss"]))), "grads": diffs, "steps": steps,
            "err": err, "same": same, "wide": (_wide(shapes.shapes, ZAMBA2_G2),
                                               _wide(served, ZAMBA2_G2))}


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_mamba2_runs_on_its_own_columns(mesh_shape, tmp_path):
    """zamba2 with 2 groups (16 heads) on (data 1, model 4), 4 heads a rank in one
    group, and on (data 2, model 2), a group a rank: step 1 within 1e-5 of one
    device leaf by leaf, three losses within 2e-3, the prefill and five greedy
    decode steps as one device; no local tensor of the training step or of the
    prefill has `conv_dim` or `d_in_proj` columns."""
    out = spawn(mamba2_columns, 4, tmp_path, mesh_shape, timeout=180)
    for r in out:
        assert r["loss_d"] <= STEP_TOL and max(r["grads"].values()) <= STEP_TOL, r["grads"]
        for a, b in zip(*r["steps"]):
            assert abs(a - b) < LOSS_TOL, r["steps"]
        assert r["err"] <= LOGIT_TOL and r["same"], r
        assert r["wide"] == (set(), set()), r["wide"]


def test_phase_layout_rehearsal(monkeypatch, capsys):
    """`chip_smoke.py`'s phase 16 (LAYOUT_NOTE) at a tiny width on the CPU: the token
    table's 16 vocab blocks give the whole lookup and the whole gradient's rows bit
    for bit (repeated tokens among them); a Mamba2 layer of 2 groups as tp 4's
    shards of 4 heads, past one chunk, within twice its bf16 floor leaf by leaf
    (the output, both states, every gradient)."""
    from test_torch_smoke import chip_smoke

    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    table = chip_smoke.phase_layout_table(CPU, "cpu", vocab=1024, d=32, batch=2, seq=64, blocks=16,
                                          memory=False)
    assert table["lookup_equal"] and table["grad_exact"] == 16 and table["repeats"] > 0, table
    layer = chip_smoke.phase_layout_mamba2(CPU, "cpu", ZAMBA2_G2, batch=2, seq=300, tp=4,
                                           memory=False)
    assert layer["worst_floors"] <= 2, layer
    text = capsys.readouterr().out
    assert "16 of 16" in text and "as tp 4's 4 shards of 4 heads" in text
