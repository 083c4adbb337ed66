"""The port's optimizer and gradient compression against JAX's, on the same numpy trees.

`repro_torch.train.optimizer` (lr_schedule, _quantize, adamw_update with
fp32 and int8 moments) and `repro_torch.parallel.compression` against
`repro.train.optimizer` and `repro.parallel.compression`. float32; the
learning rate and bias corrections are float32 in both, so values agree to
a few ulp (bar 1e-6 relative); int8 codes are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.parallel import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.configs.base import TrainConfig
from repro_torch.parallel import compression as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import paths
from torch_threads import one_thread  # noqa: F401

REL = 1e-6


def _tree(rng):
    """A parameter tree with JAX's kinds of leaves: matrices, a stacked (L, d) gain
    (decayed, as JAX decays every ndim >= 2 leaf) and a plain vector (not decayed)."""
    return {"layers": {"w": rng.standard_normal((2, 8, 16), dtype=np.float32) * 0.02,
                       "ln": {"scale": np.ones((2, 16), np.float32)}},
            "final_norm": {"scale": 1 + 0.1 * rng.standard_normal(16).astype(np.float32)},
            "embed": {"tok": rng.standard_normal((32, 16), dtype=np.float32) * 0.02}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _check(t_tree, j_tree, rel=REL):
    jp = dict(paths(jax.tree.map(np.asarray, j_tree)))
    tp = dict(paths(t_tree))
    assert tp.keys() == jp.keys()
    for k, a in jp.items():
        b = tp[k].numpy()
        assert b.dtype == a.dtype, k
        if a.dtype == np.int8:
            np.testing.assert_array_equal(b, a, k)
        else:
            np.testing.assert_allclose(b, a, rtol=rel, atol=rel * max(np.abs(a).max(), 1e-30),
                                       err_msg=k)


def test_lr_schedule_matches_jax():
    for tc in (dict(steps=20, warmup_steps=3), dict(steps=5, warmup_steps=10),
               dict(steps=100, warmup_steps=0, learning_rate=1e-3)):
        for step in range(0, 25):
            j = float(jopt.lr_schedule(JaxTrainConfig(**tc), jnp.int32(step)))
            t = topt.lr_schedule(TrainConfig(**tc), torch.tensor(step, dtype=torch.int32))
            assert t.dtype == torch.float32
            assert abs(float(t) - j) <= REL * abs(j), (tc, step)


@pytest.mark.parametrize("shape", [(), (7,), (5, 9), (2, 3, 11)])
def test_quantize_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    x.reshape(-1)[:1] = 0.5 * np.abs(x).max()  # a value that sits on a rounding midpoint
    j = jopt._quantize(jnp.asarray(x))
    t = topt._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    assert t["s"].shape == j["s"].shape
    np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))
    np.testing.assert_array_equal(topt._dequantize(t).numpy(), np.asarray(jopt._dequantize(j)))


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_adamw_update_matches_jax(optimizer):
    rng = np.random.default_rng(2)
    params = _tree(rng)
    tc = dict(steps=10, warmup_steps=2, optimizer=optimizer)
    jcfg, tcfg = JaxTrainConfig(**tc), TrainConfig(**tc)
    jp = jax.tree.map(jnp.asarray, params)
    jo = jopt.adamw_init(jp, jcfg)
    tp = _to_torch(params)
    to = topt.adamw_init(tp, tcfg)
    _check(to, jo)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), params)
        jp, jo, jstats = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, grads), jo, jcfg)
        tp, to, tstats = topt.adamw_update(tp, _to_torch(grads), to, tcfg)
        for k in ("grad_norm", "lr"):
            assert abs(float(tstats[k]) - float(jstats[k])) <= REL * abs(float(jstats[k])), k
        _check(tp, jp)
        _check(to, jo)
    assert int(to["step"]) == 3 and to["step"].dtype == torch.int32


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(3))
    j = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert abs(float(topt.global_norm(_to_torch(tree))) - j) <= REL * j


def test_compress_gradients_matches_jax():
    """Two rounds with error feedback: the round-tripped grads and the errors."""
    rng = np.random.default_rng(4)
    tree = _tree(rng)
    j_err = t_err = None
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), tree)
        jg, j_err = jcomp.compress_gradients(jax.tree.map(jnp.asarray, grads), j_err)
        tg, t_err = tcomp.compress_gradients(_to_torch(grads), t_err)
        _check(tg, jg)
        _check(t_err, j_err)


def test_bf16_leaves_round_as_jax():
    """A bf16 parameter's update is computed in float32 and rounded once to bf16."""
    rng = np.random.default_rng(5)
    w = (0.02 * rng.standard_normal((16, 32))).astype(np.float32)
    g = rng.standard_normal((16, 32)).astype(np.float32)
    jcfg, tcfg = JaxTrainConfig(warmup_steps=1), TrainConfig(warmup_steps=1)
    jp = {"w": jnp.asarray(w, jnp.bfloat16)}
    jp, _, _ = jopt.adamw_update(jp, {"w": jnp.asarray(g, jnp.bfloat16)}, jopt.adamw_init(jp, jcfg),
                                 jcfg)
    tp = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    tp, _, _ = topt.adamw_update(tp, {"w": torch.from_numpy(g).to(torch.bfloat16)},
                                 topt.adamw_init(tp, tcfg), tcfg)
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].view(torch.int16).numpy(),
                                  np.asarray(jp["w"]).view(np.int16))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_sliced_update_is_bit_for_bit_the_whole_leaf_update(optimizer, monkeypatch):
    """Leaves above SLICE_ELEMENTS are updated in runs of leading rows (the last run
    shorter), the others at once: three steps give the same bits as updating every
    leaf whole, parameters (float32 and bf16) and moments (int8 codes and scales).
    Without clipping, so that the update does not read the global norm, whose
    sliced sums add in another order: it agrees to float32 rounding."""
    rng = np.random.default_rng(6)
    tree = {"stacked": rng.standard_normal((7, 4, 8), dtype=np.float32),  # runs of 2 rows
            "wide": rng.standard_normal((10, 12), dtype=np.float32),  # runs of 5 rows
            "small": rng.standard_normal((3, 8), dtype=np.float32),  # below: at once
            "vec": rng.standard_normal(80, dtype=np.float32)}  # 1-D: never sliced
    tcfg = TrainConfig(steps=10, warmup_steps=2, optimizer=optimizer, grad_clip=0.0)
    grads = [{k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in tree.items()}
             for _ in range(3)]
    runs, norms = [], []
    for limit in (64, 1 << 40):
        monkeypatch.setattr(topt, "SLICE_ELEMENTS", limit)
        tp = _to_torch(tree)
        tp["bf16"] = tp["stacked"].to(torch.bfloat16)
        to = topt.adamw_init(tp, tcfg)
        for g in grads:
            gt = _to_torch(g)
            gt["bf16"] = gt["stacked"].to(torch.bfloat16)
            tp, to, stats = topt.adamw_update(tp, gt, to, tcfg)
        runs.append((tp, to))
        norms.append(float(stats["grad_norm"]))
        if limit == 64:
            assert [len(topt._slices(tp[k])) for k in ("stacked", "wide", "small", "vec")] == [4, 2, 1, 1]
    (p1, o1), (p2, o2) = runs
    for (k, a), (_, b) in zip(paths({"p": p1, "o": o1}), paths({"p": p2, "o": o2}), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert abs(norms[0] - norms[1]) <= REL * norms[1]
