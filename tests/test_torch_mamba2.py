"""The port's Mamba2 layer, the zamba2 hybrid and its serving against the JAX package.

All in float32 with JAX's weights (through `from_jax` for the model):

- the layer: `mamba2_seq` against JAX's at S = 5, 300 (chunk 256) and 40, 48
  (chunk 16), with 1 and 2 groups (at 2, head h reads group h // 8, which a
  `repeat` in place of `repeat_interleave` would get wrong): the output and
  the `ssd` state at every S, the `conv` state where JAX's is right (S <=
  chunk, or S a multiple of it; ROADMAP C11); 3 decode steps after the
  sequence against JAX's `mamba2_seq` over S + 3 tokens, and, where JAX's
  state is right, against JAX's `mamba2_decode` too;
- C11 pinned: at S = 300 JAX's conv state has width 0, the port's width 3,
  equal to the last 3 pre-conv rows of the in-projection;
- zamba2 at `reduced(num_layers=5)` (2 segments of [shared block, 2 Mamba2
  layers], then the shared block and a 1-layer tail) with 2 groups, on the
  kernel path and the plain path: `forward`, `loss`, prefill of 48 tokens and
  4 decode steps against JAX's; prefill of 300 and 4 decode steps against
  JAX's `forward` over the same tokens, which JAX's own decode misses (C11);
- serving: the port's `ServeEngine` against JAX's with one admission (slots
  >= requests), and with two admissions against a loop over JAX's `prefill`
  and `decode_step` that splices each cache leaf on its slot axis (JAX's
  `_admit` cannot, ROADMAP C9); 3 slots against 2 segments of 2 layers, so
  that no axis length equals the slot count (C7).

Bars: layer outputs and states within 2e-5 (max |y| is ~1); logits within
2e-3 (`tests/test_decode_equivalence.py`'s bar); greedy tokens identical;
`loss` metrics within 1e-5.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import mamba2 as jmamba
from repro.models.params import init_params as jax_init_params
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import mamba2
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import SLOT_AXES, Model, cache_leaves
from repro_torch.serve.engine import Request, ServeEngine
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.slow  # JAX compiles each shape and model

CPU = torch.device("cpu")
TOL = 2e-3
LAYER_TOL = 2e-5


def _cfgs(groups=1, **overrides):
    out = []
    for get in (jax_get_config, get_config):
        cfg = get("zamba2_1p2b").reduced(**overrides)
        out.append(dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=groups)))
    return out


def _layer(groups):
    """JAX's Mamba2 defs drawn at seed 0, with the constant leaves (a_log, d_skip,
    dt_bias, norm, conv_b) redrawn at random, as numpy and as torch tensors."""
    jcfg, cfg = _cfgs(groups)
    p = jax.tree.map(np.asarray, jax_init_params(jmamba.mamba2_defs(jcfg), jax.random.PRNGKey(0),
                                                 jnp.float32))
    rng = np.random.default_rng(groups)
    H = p["a_log"].shape[0]
    p["a_log"] = rng.uniform(-1.0, 1.5, H).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2.0, 0.5, H).astype(np.float32)
    p["d_skip"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    p["norm"] = (1 + 0.1 * rng.standard_normal(p["norm"].shape)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(np.float32)
    return jcfg, cfg, p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _jax_right(S, chunk):
    """JAX's conv state is right where the sequence needs no chunk padding (C11)."""
    return S <= chunk or S % chunk == 0


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("S,chunk", [(5, 256), (40, 16), (48, 16), (300, 256)])
def test_mamba2_seq_and_decode_match_jax(groups, S, chunk):
    jcfg, cfg, jp, tp = _layer(groups)
    assert mamba2.dims(cfg) == jmamba.dims(jcfg) and mamba2.dims(cfg)[1] // groups == 16 // groups
    steps = 3
    x = 0.5 * np.random.default_rng(S).standard_normal((2, S + steps, cfg.d_model), dtype=np.float32)
    seq = jax.jit(lambda p, x: jmamba.mamba2_seq(jcfg, p, x, chunk=chunk))
    jy, jst = seq(jp, jnp.asarray(x[:, :S]))
    y, st = mamba2.mamba2_seq(cfg, tp, torch.from_numpy(x[:, :S]), chunk=chunk)
    assert _err(y, jy) < LAYER_TOL and _err(st["ssd"], jst["ssd"]) < LAYER_TOL
    W = cfg.ssm.conv_width
    assert st["conv"].shape == (2, mamba2.dims(cfg)[2], W - 1)
    if _jax_right(S, chunk):
        assert _err(st["conv"], jst["conv"]) < LAYER_TOL
    # decode after the sequence against JAX's sequence path over the longer input
    jfull, _ = seq(jp, jnp.asarray(x))
    ys = [mamba2.mamba2_decode(cfg, tp, torch.from_numpy(x[:, t:t + 1]), st) for t in range(S, S + steps)]
    assert _err(torch.cat(ys, 1), np.asarray(jfull)[:, S:]) < LAYER_TOL
    if _jax_right(S, chunk):
        dec = jax.jit(lambda p, x, s: jmamba.mamba2_decode(jcfg, p, x, s))
        jy1, jst1 = dec(jp, jnp.asarray(x[:, S:S + 1]), jst)
        _, st1 = mamba2.mamba2_seq(cfg, tp, torch.from_numpy(x[:, :S]), chunk=chunk)
        y1 = mamba2.mamba2_decode(cfg, tp, torch.from_numpy(x[:, S:S + 1]), st1)
        assert _err(y1, jy1) < LAYER_TOL
        assert _err(st1["ssd"], jst1["ssd"]) < LAYER_TOL and _err(st1["conv"], jst1["conv"]) < LAYER_TOL


def test_conv_state_past_one_chunk_c11():
    """ROADMAP C11: past one chunk with padding, JAX slices the unpadded pre-conv
    input with the padded length. At S = 300 its conv state is empty; the port's
    is the last W - 1 = 3 pre-conv rows: the (x, B, C) columns of x @ w_in."""
    jcfg, cfg, jp, tp = _layer(2)
    S, W = 300, cfg.ssm.conv_width
    x = 0.5 * np.random.default_rng(0).standard_normal((1, S, cfg.d_model), dtype=np.float32)
    _, jst = jax.jit(lambda p, x: jmamba.mamba2_seq(jcfg, p, x))(jp, jnp.asarray(x))
    d_inner, _, conv_dim = mamba2.dims(cfg)
    assert jst["conv"].shape == (1, conv_dim, 0)
    _, st = mamba2.mamba2_seq(cfg, tp, torch.from_numpy(x))
    oracle = (x @ jp["w_in"])[:, S - (W - 1):, d_inner:d_inner + conv_dim].transpose(0, 2, 1)
    assert st["conv"].shape == (1, conv_dim, W - 1)
    assert _err(st["conv"], oracle) < 1e-5
    # shorter than the window (S = 2 < W - 1): a zero column on the left, as the
    # zero-padded conv input has it
    _, st = mamba2.mamba2_seq(cfg, tp, torch.from_numpy(x[:, :2]))
    rows = (x[:, :2] @ jp["w_in"])[:, :, d_inner:d_inner + conv_dim].transpose(0, 2, 1)
    assert not st["conv"][..., 0].any() and _err(st["conv"][..., 1:], rows) < 1e-5


def test_segsum_masks_above_the_diagonal():
    a = torch.tensor([[0.5, -1.0, 2.0]])
    out = mamba2._segsum(a)
    np.testing.assert_allclose(np.asarray(jmamba._segsum(jnp.asarray(a.numpy()))), out.numpy())
    assert torch.isinf(out[0, 0, 1]) and out[0, 2, 0] == 1.0


# ------------------------------------------------------------------- the model
B, S_SHORT, S_LONG, STEPS = 2, 48, 300, 4


@pytest.fixture(scope="module")
def case():
    jcfg, cfg = _cfgs(2, num_layers=5)
    jm = JaxModel(jcfg)
    assert jm._hybrid_split(jm.init(jax.random.PRNGKey(0))["layers"])[2:] == (2, 1)
    jparams = jm.init(jax.random.PRNGKey(8))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_LONG + STEPS)).astype(np.int32)
    fwd_fn = jax.jit(lambda p, t: jm._head(p, jm.forward(p, {"tokens": t})[0]))
    fwd = np.asarray(fwd_fn(jparams, jnp.asarray(tokens[:, :64])))
    fwd_long = np.asarray(fwd_fn(jparams, jnp.asarray(tokens)))
    labels = rng.integers(0, cfg.vocab_size, (B, 64)).astype(np.int32)
    labels[:, ::2] = fwd.argmax(-1)[:, ::2]
    labels[0, :7] = -1
    _, met = jax.jit(jm.loss)(jparams, {"tokens": jnp.asarray(tokens[:, :64]),
                                        "labels": jnp.asarray(labels)})

    def jax_decode(S0):
        logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=S0 + STEPS))(
            jparams, {"tokens": jnp.asarray(tokens[:, :S0])})
        dec = jax.jit(jm.decode_step)
        outs = [np.asarray(logits)]
        for i in range(S0, S0 + STEPS):
            logits, cache = dec(jparams, cache, jnp.asarray(tokens[:, i:i + 1]))
            outs.append(np.asarray(logits))
        return np.stack(outs)

    return SimpleNamespace(cfg=cfg, tparams=tparams, tokens=tokens, labels=labels, fwd=fwd,
                           fwd_long=np.moveaxis(fwd_long[:, S_LONG - 1:], 1, 0),
                           decode=jax_decode(S_SHORT), decode_long=jax_decode(S_LONG),
                           loss={k: float(met[k]) for k in met})


def _prefill_decode(model, params, tokens, S0):
    t = torch.from_numpy(tokens)
    logits, cache = model.prefill(params, {"tokens": t[:, :S0]}, max_len=S0 + STEPS)
    outs = [logits]
    for i in range(S0, S0 + STEPS):
        logits, cache = model.decode_step(params, cache, t[:, i:i + 1])
        outs.append(logits)
    assert cache["pos"] == S0 + STEPS
    return torch.stack(outs).numpy(), cache


@pytest.mark.parametrize("kernels", [True, False])
def test_prefill_decode_matches_jax(case, kernels):
    ours, cache = _prefill_decode(Model(case.cfg, kernels=kernels), case.tparams, case.tokens,
                                  S_SHORT)
    assert _err(ours, case.decode) < TOL
    assert (ours.argmax(-1) == case.decode.argmax(-1)).all()
    # JAX's cache structure: 2 segments of 2 Mamba2 layers, then a 1-layer tail
    assert set(cache) == {"seg", "tail", "pos"} and len(cache["tail"]["mamba"]) == 1
    assert cache["seg"]["mamba"]["ssd"].shape[:3] == (2, 2, B)
    assert cache["seg"]["shared"]["k"].shape[:2] == (2, B)
    assert {p: a for p, _, a in cache_leaves(cache)} == {
        "seg/shared/k": 1, "seg/shared/v": 1, "seg/mamba/ssd": 2, "seg/mamba/conv": 2,
        "tail/shared/k": 0, "tail/shared/v": 0, "tail/mamba/0/ssd": 0, "tail/mamba/0/conv": 0}


@pytest.mark.parametrize("kernels", [True, False])
def test_decode_after_a_long_prefill_matches_jax_forward(case, kernels):
    """Prefill of 300 tokens (past one 256-token chunk, padded): JAX's decode from
    its own cache misses its forward (C11); the port's meets it."""
    ours, _ = _prefill_decode(Model(case.cfg, kernels=kernels), case.tparams, case.tokens, S_LONG)
    assert _err(ours, case.fwd_long) < TOL
    assert (ours.argmax(-1) == case.fwd_long.argmax(-1)).all()
    assert _err(case.decode_long[0], case.fwd_long[0]) < TOL  # the prefill logits are right in JAX
    assert _err(case.decode_long[1:], case.fwd_long[1:]) > 10 * TOL  # its decode is not


@pytest.mark.parametrize("kernels", [True, False])
def test_forward_and_loss_match_jax(case, kernels):
    model = Model(case.cfg, kernels=kernels)
    batch = {"tokens": torch.from_numpy(case.tokens[:, :64])}
    x, aux = model.forward(case.tparams, batch)
    assert all(float(v) == 0.0 for v in aux.values())
    assert _err(model._head(case.tparams, x), case.fwd) < TOL
    loss, met = model.loss(case.tparams, {**batch, "labels": torch.from_numpy(case.labels)})
    assert 0.2 < case.loss["accuracy"] < 0.8 and float(loss) == float(met["loss"])
    for k, v in case.loss.items():
        assert abs(float(met[k]) - v) < 1e-5, (k, float(met[k]), v)


# ---------------------------------------------------------------------- serving
def _prompts(cfg, n, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(12, 22))).astype(np.int32)
               for _ in range(n)]
    return prompts, [int(k) for k in rng.integers(3, 7, size=n)]


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = _cfgs(2, num_layers=5)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(9))
    return jm, jparams, cfg, from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)


def test_serve_one_admission_matches_jax_engine(served):
    jm, jparams, cfg, tparams = served
    prompts, new = _prompts(cfg, 3, 9)
    jeng = JaxEngine(jm, jparams, max_len=64, slots=3)
    teng = ServeEngine(Model(cfg), tparams, max_len=64, slots=3)
    jdone = jeng.serve([JaxRequest(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    tdone = teng.serve([Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert teng.admissions == 1 and teng.decode_steps == jeng.decode_steps


def _jax_slot_axis(path) -> int:
    keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
    name = "/".join(keys[:2]) if keys[0] == "seg" else keys[0]
    return SLOT_AXES[name]


def _jax_serve(jm, jparams, prompts, new, slots, max_len):
    """The engine's schedule over JAX's `prefill` and `decode_step`, splicing each
    cache leaf on its slot axis in numpy: the tokens of each request, the decode steps."""
    prefill = {}
    dec = jax.jit(jm.decode_step)
    pending = list(range(len(prompts)))
    active, outs = [None] * slots, [[] for _ in prompts]
    cache = logits = None
    steps = 0
    while pending or any(a is not None for a in active):
        admit = []
        for s in range(slots):
            if active[s] is None and pending:
                active[s] = pending.pop(0)
                admit.append(s)
        if admit:
            S = max(len(prompts[active[s]]) for s in admit)
            toks = np.zeros((slots, S), np.int32)
            for s in admit:
                toks[s, S - len(prompts[active[s]]):] = prompts[active[s]]
            fn = prefill.setdefault(S, jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len)))
            new_logits, new_cache = fn(jparams, {"tokens": jnp.asarray(toks)})
            new_logits = np.array(new_logits)
            new_cache = jax.tree.map(np.asarray, new_cache)
            if cache is None:
                cache, logits = new_cache, new_logits
            else:
                def splice(path, old, fresh):
                    if old.ndim == 0:
                        return np.maximum(old, fresh)
                    idx = [slice(None)] * old.ndim
                    idx[_jax_slot_axis(path)] = admit
                    out = old.copy()
                    out[tuple(idx)] = fresh[tuple(idx)]
                    return out
                cache = jax.tree_util.tree_map_with_path(splice, cache, new_cache)
                logits[admit] = new_logits[admit]
        nxt = np.zeros((slots,), np.int32)
        live = [s for s in range(slots) if active[s] is not None]
        for s in live:
            tok = int(np.argmax(logits[s]))
            outs[active[s]].append(tok)
            nxt[s] = tok
            if len(outs[active[s]]) >= new[active[s]]:
                active[s] = None
        if not any(active[s] is not None for s in live):
            continue
        logits, cache = dec(jparams, cache, jnp.asarray(nxt)[:, None])
        logits, cache = np.array(logits), jax.tree.map(np.asarray, cache)
        steps += 1
    return outs, steps


def test_serve_two_admissions_match_jax_with_slot_axis_splice(served):
    jm, jparams, cfg, tparams = served
    prompts, new = _prompts(cfg, 5, 10)
    teng = ServeEngine(Model(cfg), tparams, max_len=64, slots=3)
    tdone = teng.serve([Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    ref, steps = _jax_serve(jm, jparams, prompts, new, slots=3, max_len=64)
    assert teng.admissions >= 2 and all(r.done for r in tdone)
    assert [r.out_tokens for r in tdone] == ref and teng.decode_steps == steps


def test_admit_splices_every_leaf_on_its_slot_axis():
    """An admission into slot 1 replaces slot 1 of every leaf (seg/shared on axis
    1, seg/mamba on axis 2, the tail on axis 0) and leaves slots 0 and 2 alone."""
    cfg = _cfgs(2, num_layers=5)[1]
    model = Model(cfg)
    params = model.init(0, CPU)
    eng = ServeEngine(model, params, max_len=32, slots=3)
    active = [Request(prompt=np.arange(5, dtype=np.int32) + 1, max_new_tokens=2),
              Request(prompt=np.arange(7, dtype=np.int32) + 9, max_new_tokens=2), None]
    cache, logits = eng._admit([0], active, None, None)
    before = {p: t.clone() for p, t, _ in cache_leaves(cache)}
    cache, _ = eng._admit([1], active, cache, logits)
    toks = np.zeros((3, 7), np.int32)
    toks[1] = active[1].prompt
    _, fresh = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 32)
    fresh = {p: t for p, t, _ in cache_leaves(fresh)}
    for path, t, axis in cache_leaves(cache):
        for s in (0, 2):
            assert torch.equal(t.select(axis, s), before[path].select(axis, s)), path
        assert torch.equal(t.select(axis, 1), fresh[path].select(axis, 1)), path
        assert not torch.equal(t.select(axis, 1), before[path].select(axis, 1)), path
