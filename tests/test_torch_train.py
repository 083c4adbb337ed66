"""The port's training path against JAX's on the CPU.

`repro_torch.train.train_step.make_train_step` against
`repro.train.train_step.make_train_step` from the same state (JAX's init,
through `state_from_jax`) on the same numpy batches, for qwen3-14b and
starcoder2-3b at `reduced()` (dense attention) and h2o-danube at
`reduced(attn_impl="chunked")` with S = 64 > attn_chunk 16, which goes through
the flash VJP twin and the 16-token window. float32. Bars: per-step loss,
grad_norm and lr within 1e-5 relative (GRAD_REL; the same function with sums
in another order); gradients leaf by leaf within 1e-5 of the leaf's largest
magnitude; parameters after three AdamW steps within PARAM_REL of theirs
(see there). Also: remat invariance, microbatches with compression and int8
moments, the bf16 head, the data pipeline and checkpoints both ways. The
MoE, hybrid and RWKV6 families are held to JAX in
`test_torch_train_families.py`; the Trainer and the launcher are tested in
`test_torch_trainer.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs.base import ParallelConfig as JaxParallelConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data import pipeline as jdata
from repro.models.transformer import Model as JaxModel
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.data import pipeline as tdata
from repro_torch.models.params import state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.train.trainer import Trainer
from repro_torch.train.tree import paths
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
GRAD_REL = 1e-5
# AdamW divides each step by sqrt(v) ~ |g|, so where a gradient is near zero a
# 1e-7 difference in it moves the update by up to lr: after three steps the
# parameters agree to ~5e-5 of a leaf's largest magnitude (measured 4.9e-5 on
# danube's wv), not to the gradients' 1e-7
PARAM_REL = 2e-4
S = 64
TCFG = dict(steps=10, warmup_steps=2)

# pytest.mark.slow: JAX compiles a train step per case
CASES = {"qwen3_14b": {}, "starcoder2_3b": {}, "h2o_danube_1p8b": {"attn_impl": "chunked"}}


def _configs(arch, **over):
    return jax_get_config(arch).reduced(**over), get_config(arch).reduced(**over)


def _state(jcfg, cfg, tcfg, pcfg=None):
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    jstate = {"params": params, "opt": jopt.adamw_init(params, tcfg)}
    if pcfg is not None and pcfg.grad_compress:
        jstate["grad_error"] = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    return jm, jstate, state_from_jax(jax.tree.map(np.asarray, jstate), cfg, CPU)


def _batches(vocab, n, B=2, seed=0, seq=S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (B, seq + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _leaves_close(t_tree, j_tree, rel):
    jp = dict(paths(jax.tree.map(np.asarray, j_tree)))
    tp = dict(paths(t_tree))
    assert tp.keys() == jp.keys()
    for k, a in jp.items():
        b = tp[k].float().numpy() if tp[k].dtype == torch.bfloat16 else tp[k].numpy()
        assert np.abs(b - np.asarray(a, np.float32)).max() <= rel * max(np.abs(a).max(), 1e-30), k


def _run_both(jm, jstate, state, model, pcfg, jpcfg, tcfg, jtcfg, batches, after_step=None):
    jstep = jax.jit(jax_make_train_step(jm, jpcfg, jtcfg))
    step = make_train_step(model, pcfg, tcfg)
    for i, b in enumerate(batches):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "ce", "accuracy", "grad_norm", "lr"):
            assert _rel(met[k], jmet[k]) <= GRAD_REL, (i, k, float(met[k]), float(jmet[k]))
        if after_step is not None:
            after_step(i, jstate, state)
    return jstate, state


@pytest.mark.slow
@pytest.mark.parametrize("arch", CASES)
def test_train_step_matches_jax(arch):
    jcfg, cfg = _configs(arch, **CASES[arch])
    jm, jstate, state = _state(jcfg, cfg, JaxTrainConfig(**TCFG))
    batches = _batches(cfg.vocab_size, 3)
    b0 = batches[0]
    jgrads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b, remat="selective")[0]))(
        jstate["params"], {k: jnp.asarray(v) for k, v in b0.items()})
    grads, _ = loss_and_grads(Model(cfg), state["params"],
                              {k: torch.from_numpy(v) for k, v in b0.items()}, "selective")
    _leaves_close(grads, jgrads, GRAD_REL)
    jstate, state = _run_both(jm, jstate, state, Model(cfg), ParallelConfig(), JaxParallelConfig(),
                              TrainConfig(**TCFG), JaxTrainConfig(**TCFG), batches)
    _leaves_close(state["params"], jstate["params"], PARAM_REL)


@pytest.mark.slow
def test_microbatches_compression_and_int8_moments_match_jax():
    """Two microbatches (fp32 accumulation, metrics averaged, the first seeding
    the accumulators), int8 gradient compression with error feedback and int8
    AdamW moments, together, against JAX over two steps."""
    jcfg, cfg = _configs("qwen3_14b")
    tc = dict(TCFG, optimizer="adamw8bit")
    pc = dict(microbatches=2, grad_compress=True, remat="full")
    jm, jstate, state = _state(jcfg, cfg, JaxTrainConfig(**tc), JaxParallelConfig(**pc))

    def error_feedback_alike(i, jstate, state):
        """After the first step, where the compressor's inputs agree to GRAD_REL:
        the error gf - q s / 127 (at most s / 254) moves one for one with gf, so
        it is held at GRAD_REL of the scale s = 254 x max |error|; where gf sits
        that close to a rounding midpoint, q may round the other way and move it
        by a whole step s / 127, at no more than 0.1% of the elements."""
        if i:
            return
        jerr = dict(paths(jax.tree.map(np.asarray, jstate["grad_error"])))
        off = n = 0
        for k, t in paths(state["grad_error"]):
            off += int((np.abs(t.numpy() - jerr[k]) > GRAD_REL * 254 * np.abs(jerr[k]).max()).sum())
            n += t.numel()
        assert off <= 1e-3 * n, off

    jstate, state = _run_both(jm, jstate, state, Model(cfg), ParallelConfig(**pc),
                              JaxParallelConfig(**pc), TrainConfig(**tc), JaxTrainConfig(**tc),
                              _batches(cfg.vocab_size, 2, B=4), error_feedback_alike)
    assert set(state) == {"params", "opt", "grad_error"}
    assert state["opt"]["m"]["embed"]["tok"]["q"].dtype == torch.int8


def test_remat_policies_give_the_same_gradients():
    """none, selective and full recompute the same ops in the same order: bit for bit."""
    cfg = get_config("h2o_danube_1p8b").reduced(attn_impl="chunked")
    model = Model(cfg)
    params = model.init(0, CPU, widen_head=False)
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg.vocab_size, 1)[0].items()}
    runs = [loss_and_grads(model, params, batch, remat) for remat in ("none", "selective", "full")]
    for grads, met in runs[1:]:
        assert torch.equal(met["loss"], runs[0][1]["loss"])
        for (k, a), (_, b) in zip(paths(grads), paths(runs[0][0])):
            assert torch.equal(a, b), k


@pytest.mark.slow
def test_bf16_step_keeps_the_head_in_bf16_as_jax():
    """bf16 params: `lm_head/w` stays bf16 after a step, as JAX's, and equals it
    bit for bit at over 99.9% of its elements (0.99925 measured). The first
    AdamW update moves an element by ~lr (1.5e-4), about one bf16 step, the
    way the gradient's sign says; where the gradient is near zero the two
    frameworks' bf16 activations, rounded in other places, can give it
    opposite signs, so an element differs by at most twice the move."""
    jcfg, cfg = _configs("qwen3_14b", dtype="bfloat16", param_dtype="bfloat16")
    jm, jstate, state = _state(jcfg, cfg, JaxTrainConfig(**TCFG))
    assert state["params"]["lm_head"]["w"].dtype == torch.bfloat16
    b = _batches(cfg.vocab_size, 1)[0]
    jstate, _ = jax.jit(jax_make_train_step(jm, JaxParallelConfig(), JaxTrainConfig(**TCFG)))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, met = make_train_step(Model(cfg), ParallelConfig(), TrainConfig(**TCFG))(
        state, {k: torch.from_numpy(v) for k, v in b.items()})
    w = state["params"]["lm_head"]["w"]
    assert w.dtype == torch.bfloat16
    j = np.asarray(jstate["params"]["lm_head"]["w"]).astype(np.float32)
    t = w.float().numpy()
    assert (t == j).mean() > 0.999
    # each moved by lr (1 + weight decay * |p|) at most, then rounded to its bf16 step
    bound = 2 * float(met["lr"]) * 1.01 + np.abs(j) * 2.0**-7
    assert (np.abs(t - j) <= bound).all()


def test_synthetic_lm_and_corpus_match_jax(tmp_path):
    for kw in (dict(seed=0), dict(seed=3, num_hosts=2, host_id=1)):
        j, t = jdata.SyntheticLM(512, 33, 4, **kw), tdata.SyntheticLM(512, 33, 4, **kw)
        for step in (0, 1, 7):
            a, b = j.batch(step), t.batch(step)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    docs = [np.arange(n) for n in (5, 9, 3, 30)]
    assert np.array_equal(jdata.pack_documents(docs, 7, 99), tdata.pack_documents(docs, 7, 99))
    path = tmp_path / "tok.bin"
    np.arange(4000, dtype=np.int32).tofile(path)
    j, t = jdata.MemmapCorpus(str(path), 15, 4, seed=2), tdata.MemmapCorpus(str(path), 15, 4, seed=2)
    for step in (0, 5, 80):
        assert all(np.array_equal(j.batch(step)[k], t.batch(step)[k]) for k in ("tokens", "labels"))
    assert [b["tokens"][0, 0] for b in tdata.Prefetcher(iter([{"tokens": np.ones((1, 1)) * i}
                                                              for i in range(3)]))] == [0, 1, 2]


def _jax_trainer_state(tmp_path, optimizer):
    jcfg = jax_get_config("qwen3_14b").reduced()
    tc = JaxTrainConfig(**TCFG, optimizer=optimizer, checkpoint_dir=str(tmp_path / "jax"))
    tr = JaxTrainer(JaxModel(jcfg), JaxParallelConfig(grad_compress=True), tc)
    state, _ = tr.fit(tr.init_state(), jdata.SyntheticLM(jcfg.vocab_size, 32, 2), steps=1,
                      log=lambda *_: None)
    return tr, state


@pytest.mark.slow
@pytest.mark.parametrize("optimizer", ["adamw", "adamw8bit"])
def test_checkpoints_restore_across_jax_and_the_port(tmp_path, optimizer):
    """A JAX checkpoint restores into the port's Trainer bit for bit, and the
    port's into JAX's: every leaf of params, opt {m, v, step} (int8 {q, s}
    leaves with adamw8bit) and grad_error."""
    jtr, jstate = _jax_trainer_state(tmp_path, optimizer)
    jtr.ckpt.save(1, jstate, async_=False)
    cfg = get_config("qwen3_14b").reduced()
    tc = TrainConfig(**TCFG, optimizer=optimizer, checkpoint_dir=str(tmp_path / "jax"))
    tr = Trainer(Model(cfg), ParallelConfig(grad_compress=True), tc, CPU)
    restored, step = tr.resume()
    assert step == 1
    expect = state_from_jax(jax.tree.map(np.asarray, jstate), cfg, CPU)
    for (k, a), (k2, b) in zip(paths(restored), paths(expect), strict=True):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    # and back: the port writes, JAX restores into its own structure
    tckpt.CheckpointManager(str(tmp_path / "port")).save(1, restored, async_=False)
    back, _ = jckpt.CheckpointManager(str(tmp_path / "port")).restore(
        jax.eval_shape(lambda: jstate))
    for (k, a), (_, b) in zip(paths(jax.tree.map(np.asarray, back)),
                              paths(jax.tree.map(np.asarray, jstate)), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def test_bf16_checkpoint_round_trip(tmp_path):
    cfg = get_config("h2o_danube_1p8b").reduced(dtype="bfloat16", param_dtype="bfloat16")
    tr = Trainer(Model(cfg), ParallelConfig(), TrainConfig(**TCFG), CPU)
    state = tr.init_state(seed=1)
    tckpt.save_pytree(str(tmp_path / "s"), state, 0)
    back = tckpt.restore_pytree(str(tmp_path / "s"), tr.init_state(seed=2))
    for (k, a), (_, b) in zip(paths(back), paths(state)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert state["params"]["lm_head"]["w"].dtype == torch.bfloat16
