"""What a rank holds on a tp mesh: the shard JAX's logical axes give it, not a
gathered copy (ROADMAP C12).

- The CE is vocab-parallel: a chunk's logits stay split over tp, (B, chunk, V /
  tp) a rank, their log-sum-exp, gold logit and argmax combined over the ranks
  (`layers.VocabParallelCE`, `axes.ce_combine`).
- Mamba2's heads split over tp wherever a rank's heads lie in one group
  (zamba2's 64 heads in 2 groups on tp 16: 4 a rank).
- Attention's kv heads split over tp where tp does not divide them, padded with
  zero heads as GSPMD pads JAX's `shard(q, "dp", None, "tp", None, None)`: each
  rank holds ceil(Hkv / tp) kv heads with their query heads.

Gloo processes on the CPU (`torch_dist.spawn`) at `reduced()` sizes in float32,
held to the port's single-device run at `tests/test_torch_mesh.py`'s bars (step
1 within 1e-5 leaf by leaf, losses within 2e-3 over 3 steps) and
`tests/test_torch_mesh_serve.py`'s (logits within 2e-3, greedy tokens equal);
and the dry-run's trace on fake worlds (`dryrun.init_fake_world`). Every rank
records the local shapes its step computes (`LocalShapes`, below DTensor) or the
local inputs of the attention core and the SSD.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from torch_dist import spawn

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, ShapeSpec, TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import dryrun
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.mesh import make_mesh, rules_for
from repro_torch.models import attention, mamba2
from repro_torch.models.params import distribute
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import ShardingRules, current_mesh, make_rules, use_mesh, whole
from repro_torch.train.train_step import loss_and_grads
from repro_torch.train.tree import paths
from test_torch_mesh import LOSS_TOL, STEP_TOL, _trainer
from test_torch_mesh_serve import LOGIT_TOL, _greedy
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
QWEN3 = get_config("qwen3-14b").reduced()  # 4 query heads, 2 kv heads: uneven on tp 4
ZAMBA2_G2 = get_config("zamba2_1p2b").reduced(
    ssm=dataclasses.replace(get_config("zamba2_1p2b").reduced().ssm, n_groups=2))  # 16 heads


class LocalShapes(TorchDispatchMode):
    """Records the shape of every tensor an op makes on this rank's local tensors
    (ops on DTensors are handed back, so that their local ops come through; the
    fake and meta stand-ins of global shapes that DTensor's sharding propagation
    makes hold no data and are left out)."""

    def __init__(self):
        super().__init__()
        self.shapes: set[tuple[int, ...]] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.shapes.update(tuple(t.shape) for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor)
                           and t.device.type != "meta")
        return out


@dataclasses.dataclass
class Seen:
    """The local inputs of the attention core and of the SSD (sequence and step)."""

    attn: list = dataclasses.field(default_factory=list)  # q's local (Hkv, G)
    ssd: list = dataclasses.field(default_factory=list)  # xh's local heads, B's groups


def watch() -> Seen:
    """Wraps the attention core (the plain dense one of training, the flash
    wrapper of the prefill) and the SSD (sequence and step), in this process, so
    that each call on a mesh records its local shapes in the returned `Seen`."""
    seen = Seen()
    dense, flash, ssd, step = (attention._dense_attention, fa_ops.flash_attention, mamba2._ssd,
                               mamba2._ssd_step)

    def note(where, shape):
        if isinstance(current_mesh(), DeviceMesh):
            where.append(shape)

    def core(fn):
        return lambda q, *a, **k: note(seen.attn, tuple(q.shape[2:4])) or fn(q, *a, **k)

    def seq(chunk, xh, dtr, Bm, *a):
        note(seen.ssd, (xh.shape[2], Bm.shape[2]))
        return ssd(chunk, xh, dtr, Bm, *a)

    def one(xh, dtr, Bm, *a):
        note(seen.ssd, (xh.shape[1], Bm.shape[1]))
        return step(xh, dtr, Bm, *a)

    attention._dense_attention, fa_ops.flash_attention = core(dense), core(flash)
    mamba2._ssd, mamba2._ssd_step = seq, one
    return seen


def _train_diffs(cfg, mesh, rules, data, shapes=None):
    """(loss diff, {leaf: max abs diff}, (accuracy on one device, on the mesh)) of one
    loss-and-grads on the mesh against one device; `shapes` records the mesh step's
    local shapes."""
    tcfg = TrainConfig(steps=3, log_every=100)
    t0, t1 = _trainer(cfg, ParallelConfig(), tcfg), _trainer(cfg, ParallelConfig(), tcfg, mesh, rules)
    s0, s1 = t0.init_state(), t1.init_state()
    g0, m0 = loss_and_grads(t0.model, s0["params"], t0._batch(data.batch(0)), None)
    with t1._ctx(), (shapes or contextlib.nullcontext()):
        g1, m1 = loss_and_grads(t1.model, s1["params"], t1._batch(data.batch(0)), None)
    leaves1 = dict(paths(g1))
    diffs = {k: float((whole(leaves1[k]) - v).abs().max()) for k, v in paths(g0)}
    return float(abs(m0["loss"] - whole(m1["loss"]))), diffs, (float(m0["accuracy"]),
                                                                float(whole(m1["accuracy"])))


def _three_steps(cfg, mesh, rules, data):
    """The three-step histories of one device and of the mesh."""
    tcfg = TrainConfig(steps=3, log_every=100)
    t0, t1 = _trainer(cfg, ParallelConfig(), tcfg), _trainer(cfg, ParallelConfig(), tcfg, mesh, rules)
    h0 = t0.fit(t0.init_state(), data, steps=3, log=lambda *_: None)[1]
    h1 = t1.fit(t1.init_state(), data, steps=3, log=lambda *_: None)[1]
    return [(a["loss"], b["loss"], a["accuracy"], b["accuracy"]) for a, b in zip(h0, h1)]


def vocab_on_mesh(rank, world, mesh_shape):
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    rules = make_rules(dp=("data",), tp=("model",))
    data = SyntheticLM(QWEN3.vocab_size, 64, 8)
    shapes = LocalShapes()
    loss_d, diffs, acc = _train_diffs(QWEN3, mesh, rules, data, shapes)
    # the logits of a chunk: (rows, loss_chunk, vocab or a block of it)
    logits = {s[-1] for s in shapes.shapes if len(s) == 3 and s[1] == QWEN3.loss_chunk
              and s[-1] >= QWEN3.vocab_size // mesh_shape[1]}
    return {"loss_d": loss_d, "grads": diffs, "acc": acc, "logits": logits,
            "steps": _three_steps(QWEN3, mesh, rules, data)}


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_vocab_parallel_ce_trains_as_one_device(mesh_shape, tmp_path):
    """(a) qwen3 on (data 2, model 2) and (data 1, model 4): each rank's chunk
    logits are its vocab block, (B, chunk, V / tp), never the whole vocabulary;
    step 1 within 1e-5 of one device leaf by leaf, three losses within 2e-3, and
    the accuracy equal at every step."""
    out = spawn(vocab_on_mesh, 4, tmp_path, mesh_shape, timeout=150)
    for r in out:
        assert r["logits"] == {QWEN3.vocab_size // mesh_shape[1]}, r["logits"]
        assert r["loss_d"] <= STEP_TOL and max(r["grads"].values()) <= STEP_TOL, r
        assert r["acc"][0] == r["acc"][1], r["acc"]
        for loss0, loss1, acc0, acc1 in r["steps"]:
            assert abs(loss0 - loss1) < LOSS_TOL and acc0 == acc1, r["steps"]


def _serve(cfg, mesh, prompt, steps, max_len):
    """(logits max |diff|, tokens equal) of a greedy serve on the mesh against one device."""
    model = Model(cfg)
    params = model.init(0, CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, prompt)))
    ref, ref_toks, _ = _greedy(model, params, {"tokens": toks}, steps, max_len)
    with use_mesh(mesh, make_rules(tp=("model",))):
        placed = distribute(params, model.pspecs(), mesh)
        out, out_toks, _ = _greedy(model, placed, {"tokens": toks}, steps, max_len)
    return float((out - ref).abs().max()), ref_toks == out_toks


def heads_on_mesh(rank, world, arch):
    cfg = {"qwen3": QWEN3, "zamba2": ZAMBA2_G2}[arch]
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    seen = watch()
    data = SyntheticLM(cfg.vocab_size, 32, 8)
    loss_d, diffs, _ = _train_diffs(cfg, mesh, rules_for(mesh), data)
    trained, seen.attn, seen.ssd = (seen.attn, seen.ssd), [], []
    err, same = _serve(cfg, mesh, prompt=7, steps=5, max_len=16)
    return {"loss_d": loss_d, "grads": diffs, "steps": _three_steps(cfg, mesh, rules_for(mesh), data),
            "trained": trained, "served": (seen.attn, seen.ssd), "err": err, "same": same}


@pytest.mark.parametrize("arch", ["qwen3", "zamba2"])
def test_heads_split_over_tp_train_and_serve_as_one_device(arch, tmp_path):
    """(b) qwen3's 2 kv heads and (c) zamba2's shared block (2 kv heads) and its 16
    Mamba2 heads in 2 groups, on (data 1, model 4): the attention core sees at
    most ceil(2 / 4) = 1 kv head a rank, with its G query heads, in training and
    in the prefill; the SSD sees 16 / 4 heads and their one group, in training,
    prefill and decode. Step 1 and three steps as one device; the prefill and
    five greedy decode steps as one device."""
    out = spawn(heads_on_mesh, 4, tmp_path, arch, timeout=150)
    cfg = {"qwen3": QWEN3, "zamba2": ZAMBA2_G2}[arch]
    G = cfg.num_heads // cfg.num_kv_heads
    for r in out:
        for attn, ssd in (r["trained"], r["served"]):
            assert attn and set(attn) == {(1, G)}, attn
            if arch == "zamba2":
                assert ssd and set(ssd) == {(16 // 4, 1)}, ssd
        assert r["loss_d"] <= STEP_TOL and max(r["grads"].values()) <= STEP_TOL, r
        for loss0, loss1, _, _ in r["steps"]:
            assert abs(loss0 - loss1) < LOSS_TOL, r["steps"]
        assert r["err"] <= LOGIT_TOL and r["same"], r


@pytest.fixture
def fake_tp4():
    """A fake world of 4 ranks and its (data 1, model 4) mesh; destroyed after."""
    dryrun.init_fake_world(4)
    yield make_mesh((1, 4), ("data", "model"), "cpu")
    dist.destroy_process_group()


def _peak(cfg, shape, mesh):
    rules = rules_for(mesh) if mesh is not None else ShardingRules()
    trace = dryrun.trace_cell(cfg, shape, mesh, rules, policy=(1, "full"), log=lambda *_: None)
    return trace["memory"]["peak_bytes_per_device"]


def test_traced_train_peak_grows_with_the_vocab_like_v_over_tp(fake_tp4):
    """(d) The dry-run's traced peak of a train step: doubling the vocabulary grows
    the tp-4 rank's peak by at most 0.4 of the growth off a mesh (the logits, their
    gradient, the head and its moments all split four ways)."""
    shape = ShapeSpec("train_vocab", 256, 8, "train")
    grow = {}
    for mesh in (None, fake_tp4):
        small, large = (_peak(QWEN3.reduced(vocab_size=v, loss_chunk=256), shape, mesh)
                        for v in (4096, 8192))
        grow[mesh is None] = large - small
    assert 0 < grow[False] <= 0.4 * grow[True], grow


@pytest.mark.parametrize("part", ["attention", "mamba2"])
def test_a_rank_holds_its_share_of_the_heads(part, fake_tp4, monkeypatch):
    """(e) On the fake (data 1, model 4) world, a train step's attention core holds
    ceil(Hkv / tp) / Hkv of q's bytes (3 kv heads: each rank one of the 4 padded
    ones), and its SSD 1 / tp of xh's (16 heads in 2 groups)."""
    B, S, tp = 2, 64, 4
    seen = []
    if part == "attention":
        cfg = QWEN3.reduced(num_heads=6, num_kv_heads=3)
        core = attention._dense_attention
        monkeypatch.setattr(attention, "_dense_attention",
                            lambda q, *a: seen.append(q.numel() * q.element_size()) or core(q, *a))
        heads = cfg.num_kv_heads
        share = math.ceil(heads / tp)  # of `heads`
        whole = B * S * cfg.num_heads * cfg.head_dim * 4  # q (B, S, Hkv, G, dh), float32
    else:
        cfg = ZAMBA2_G2
        ssd = mamba2._ssd
        monkeypatch.setattr(mamba2, "_ssd", lambda c, xh, *a: seen.append(xh.numel() * xh.element_size())
                            or ssd(c, xh, *a))
        heads = mamba2.dims(cfg)[1]
        share = heads // tp
        whole = B * S * heads * cfg.ssm.head_dim * 4  # xh (B, S, H, P), float32
    _peak(cfg, ShapeSpec("train_heads", S, B, "train"), fake_tp4)
    assert seen and all(nbytes * heads == whole * share for nbytes in seen), (seen, whole)


def test_phase_vocab_split_rehearsal(monkeypatch, capsys):
    """`chip_smoke.py`'s phase 15 (VOCAB_NOTE) at a tiny width on the CPU: the
    logits cut into 16 vocab blocks on a leading dim, each through the mesh
    path's local function and joined by its combine, give the whole-vocab CE's
    loss, nll sum and gradients within 1e-5 relative, its hits and every argmax,
    and the planted tie across blocks 3 and 4 resolves to the lower column."""
    from test_torch_smoke import chip_smoke

    monkeypatch.setattr(chip_smoke, "sync", lambda: None)
    out = chip_smoke.phase_vocab_split(CPU, "cpu", d=64, vocab=1024, batch=2, chunk=32, blocks=16,
                                       memory=False)
    assert max(out[k] for k in ("loss", "nll", "dx", "dw")) <= chip_smoke.VOCAB_TOL, out
    assert out["hits"] > out["tokens"] // 8
    text = capsys.readouterr().out
    assert "argmax differs at 0 of 64 tokens; the planted tie at columns 197 and 263: whole 197, " \
           "split 197" in text
