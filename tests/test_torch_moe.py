"""The port's MoE layer, MoE models and MoE serving against the JAX package's.

All in float32 with JAX's weights through `from_jax`:

- the layer: `apply_moe` against JAX's `apply_moe` on the same x, at the
  cases of `tests/test_moe.py` (dropless with 0 and 2 shared experts and with
  arctic's dense residual; a tight capacity of 0.26 that drops tokens); the
  dense reference against JAX's; `capacity` against JAX's;
- the model, for deepseek-moe-16b (a leading dense layer, shared experts)
  and arctic-480b (the dense residual) at `reduced()`, and deepseek at a
  capacity factor of 0.5, where prefill drops tokens, with `kernels=True`
  and `kernels=False`: prefill of 48 tokens plus 16 teacher-forced decode
  steps, `forward`, and the `loss` metrics with the aux term;
- serving deepseek at `reduced()`: 7 requests over 3 slots, so that later
  admissions prefill padding rows and splice the head layer's cache.

Bars: the layer's y within 1e-5, its aux within 1e-6 with `moe_drop_frac`
equal; logits within 2e-3 (`tests/test_decode_equivalence.py`'s bar);
`loss` metrics within 1e-5; served tokens and decode steps identical.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.params import init_params as jax_init_params
from repro.models.transformer import AUX_KEYS
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.params import from_jax, layer_params
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import Request, ServeEngine
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.slow  # JAX compiles each reduced model

CPU = torch.device("cpu")
B, S, S0 = 2, 64, 48
TOL = 2e-3


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _layer_cfgs(E=8, k=2, cf=8.0, d=32, ff=16, shared=0, dense_res=False):
    """`tests/test_moe.py::_setup`'s layer, as a JAX and a port config."""
    out = []
    for get in (jax_get_config, get_config):
        base = get("deepseek_moe_16b").reduced()
        m = dataclasses.replace(base.moe, num_experts=E, top_k=k, capacity_factor=cf, d_ff=ff,
                                num_shared_experts=shared, dense_residual=dense_res,
                                dense_d_ff=ff if dense_res else 0, first_k_dense=0)
        out.append(dataclasses.replace(base, moe=m, d_model=d))
    return out


@pytest.mark.parametrize("cf,shared,dense_res,T", [(8.0, 0, False, 24), (8.0, 2, False, 24),
                                                   (8.0, 0, True, 24), (0.26, 0, False, 64)])
def test_layer_matches_jax(cf, shared, dense_res, T):
    jcfg, cfg = _layer_cfgs(cf=cf, shared=shared, dense_res=dense_res)
    jp = jax_init_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(0), jnp.float32)
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    assert tp["router"].dtype == torch.float32
    x = 0.5 * np.random.default_rng(1).standard_normal((2, T, cfg.d_model), dtype=np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(jcfg, p, x))(jp, jnp.asarray(x))
    y, aux = moe.apply_moe(cfg, tp, torch.from_numpy(x))
    assert np.abs(y.numpy() - np.asarray(jy)).max() < 1e-5
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert abs(float(aux[k]) - float(jaux[k])) < 1e-6, k
    assert float(aux["moe_drop_frac"]) == float(jaux["moe_drop_frac"])
    assert (float(aux["moe_drop_frac"]) > 0) == (cf < 1)  # the tight case drops, dropless does not
    ref = moe.apply_moe_dense_reference(cfg, tp, torch.from_numpy(x)).numpy()
    assert np.abs(ref - np.asarray(jmoe.apply_moe_dense_reference(jcfg, jp, jnp.asarray(x)))).max() < 1e-5
    if cf > 1:  # dropless: the dispatch equals the dense oracle
        assert np.abs(y.numpy() - ref).max() < 1e-5
    y2, none = moe.apply_moe(cfg, tp, torch.from_numpy(x), aux=False)
    assert none is None and torch.equal(y, y2)


def test_capacity_matches_jax():
    jcfg, cfg = _layer_cfgs()
    for cf in (1e-6, 0.26, 0.5, 1.25, 2.0, 8.0):
        jm, m = (dataclasses.replace(c.moe, capacity_factor=cf) for c in (jcfg, cfg))
        for tokens in (1, 2, 4, 7, 96, 128, 4400):
            assert moe.capacity(m, tokens) == jmoe.capacity(jm, tokens), (cf, tokens)
    ds = get_config("deepseek_moe_16b").moe  # the serve traffic's prefill and decode
    assert (moe.capacity(ds, 4400), moe.capacity(ds, 4)) == (515, 6)


def test_routing_record_is_off_by_default():
    cfg = get_config("deepseek_moe_16b").reduced()
    lp = layer_params(Model(cfg).init(0, CPU), 0)["moe"]
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    moe.apply_moe(cfg, lp, x)
    assert moe._RECORD is None
    with moe.routing_record() as rec:
        moe.apply_moe(cfg, lp, x)
    assert moe._RECORD is None and len(rec) == 1
    topi, gap = rec[0]
    assert topi.shape == (10, cfg.moe.top_k) and gap.shape == (10,) and (gap >= 0).all()


# case id -> (arch, MoE overrides of reduced())
CASES = {
    "deepseek_moe_16b": ("deepseek_moe_16b", {}),
    "arctic_480b": ("arctic_480b", {}),
    "deepseek_moe_16b-cf0.5": ("deepseek_moe_16b", {"capacity_factor": 0.5}),
}


def _reduced(get, arch, moe_overrides):
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_overrides))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, over = CASES[request.param]
    jcfg, cfg = _reduced(jax_get_config, arch, over), _reduced(get_config, arch, over)
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(5))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    x, jaux = jax.jit(jm.forward)(jparams, batch)
    fwd = np.asarray(jax.jit(jm._head)(jparams, x))
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, ::2] = fwd.argmax(-1)[:, ::2]  # hits, so that the accuracy is ~0.5
    labels[0, :7] = -1  # ignored
    _, met = jax.jit(jm.loss)(jparams, {"tokens": batch["tokens"], "labels": jnp.asarray(labels)})
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=S))(
        jparams, {"tokens": jnp.asarray(tokens[:, :S0])})
    dec = jax.jit(jm.decode_step)
    outs = [np.asarray(logits)]
    for i in range(S0, S):
        logits, cache = dec(jparams, cache, jnp.asarray(tokens[:, i:i + 1]))
        outs.append(np.asarray(logits))
    return SimpleNamespace(cfg=cfg, tparams=tparams, tokens=tokens, labels=labels, fwd=fwd,
                           decode=np.stack(outs), loss={k: float(met[k]) for k in met},
                           drop=float(jaux["moe_drop_frac"]))


@pytest.mark.parametrize("kernels", [True, False])
def test_prefill_decode_matches_jax(case, kernels):
    model = Model(case.cfg, kernels=kernels)
    t = torch.from_numpy(case.tokens)
    logits, cache = model.prefill(case.tparams, {"tokens": t[:, :S0]}, max_len=S)
    assert set(cache) == ({"head_layers", "layers", "pos"} if model.n_head else {"layers", "pos"})
    assert model.n_head == (case.cfg.name == "deepseek-moe-16b")
    outs = [logits]
    for i in range(S0, S):
        logits, cache = model.decode_step(case.tparams, cache, t[:, i:i + 1])
        outs.append(logits)
    ours = torch.stack(outs).numpy()
    err = np.abs(ours - case.decode).max()
    assert err < TOL, err
    assert (ours.argmax(-1) == case.decode.argmax(-1)).all()


@pytest.mark.parametrize("kernels", [True, False])
def test_forward_matches_jax(case, kernels):
    x, aux = Model(case.cfg, kernels=kernels).forward(case.tparams,
                                                      {"tokens": torch.from_numpy(case.tokens)})
    err = np.abs(Model(case.cfg)._head(case.tparams, x).numpy() - case.fwd).max()
    assert err < TOL, err
    assert float(aux["moe_drop_frac"]) == case.drop
    # deepseek's reduced capacity of 2.0 keeps every token here; 0.5 drops some
    assert (case.drop > 0) == (case.cfg.moe.capacity_factor < 1)


@pytest.mark.parametrize("kernels", [True, False])
def test_loss_matches_jax(case, kernels):
    loss, met = Model(case.cfg, kernels=kernels).loss(
        case.tparams, {"tokens": torch.from_numpy(case.tokens), "labels": torch.from_numpy(case.labels)})
    assert 0.2 < case.loss["accuracy"] < 0.8  # the labels hold hits and misses
    assert float(loss) == float(met["loss"]) and float(met["loss"]) > float(met["ce"])
    assert sorted(met) == sorted(case.loss) == sorted(["loss", "ce", "accuracy", *AUX_KEYS])
    for k, v in case.loss.items():
        assert abs(float(met[k]) - v) < 1e-5, (k, float(met[k]), v)


def test_serve_tokens_and_decode_steps_match_jax():
    """7 requests over 3 slots with prompts of 12-21 tokens: later admissions
    prefill rows of token-0 padding (which route and compete for capacity like
    any other), and splice the head layer's (B, ...) cache as well as the
    stacked (L, B, ...) one. 3 slots against 1 stacked layer: not ROADMAP C7."""
    jcfg, cfg = jax_get_config("deepseek_moe_16b").reduced(), get_config("deepseek_moe_16b").reduced()
    assert cfg.moe.first_k_dense == 1 and cfg.num_layers - 1 != 3
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(6))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(12, 22))).astype(np.int32)
               for _ in range(7)]
    new = [int(n) for n in rng.integers(3, 7, size=7)]
    jeng = JaxEngine(jm, jparams, max_len=64, slots=3)
    teng = ServeEngine(Model(cfg), tparams, max_len=64, slots=3)
    jdone = jeng.serve([JaxRequest(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    tdone = teng.serve([Request(prompt=p, max_new_tokens=n) for p, n in zip(prompts, new)])
    assert [r.out_tokens for r in tdone] == [r.out_tokens for r in jdone]
    assert all(r.done for r in tdone) and teng.decode_steps == jeng.decode_steps


def test_admit_splices_the_head_layers():
    """An admission replaces the admitted slot of the head layer's (B, ...) cache
    too, and leaves the other slots as they were."""
    cfg = get_config("deepseek_moe_16b").reduced()
    model = Model(cfg)
    params = model.init(0, CPU)
    eng = ServeEngine(model, params, max_len=32, slots=3)
    active = [Request(prompt=np.arange(5, dtype=np.int32) + 1, max_new_tokens=2),
              Request(prompt=np.arange(7, dtype=np.int32) + 9, max_new_tokens=2), None]
    cache, logits = eng._admit([0], active, None, None)
    before = {k: v.clone() for k, v in cache["head_layers"]["0"]["kv"].items()}
    cache, _ = eng._admit([1], active, cache, logits)
    toks = np.zeros((3, 7), np.int32)
    toks[1] = active[1].prompt
    _, fresh = model.prefill(params, {"tokens": torch.from_numpy(toks)}, 32)
    for k, v in cache["head_layers"]["0"]["kv"].items():
        assert torch.equal(v[0], before[k][0]) and torch.equal(v[2], before[k][2])
        assert torch.equal(v[1], fresh["head_layers"]["0"]["kv"][k][1])
        assert not torch.equal(v[1], before[k][1])


def test_padding_rows_take_capacity_from_the_admitted_prompt():
    """ROADMAP C8: `_admit` prefills every slot's row, the rows not admitted are
    token 0 (as is the left padding), and those positions route and take expert
    capacity like any other token, ahead of the later slots (the stable sort's
    priority is the flat index). So at a capacity that drops, one prompt gets
    other logits in slot 2, behind two rows of token 0, than in slot 0 ahead of
    them (the same batch shape, so the same capacity), in JAX and, reproducing
    it, in the port."""
    # 3 layers: drops in the first MoE layer reach the last token through the
    # second's attention (with one MoE layer, only the last token's own routing would)
    jcfg, cfg = (dataclasses.replace(c, num_layers=3) for c in (
        _reduced(jax_get_config, "deepseek_moe_16b", {"capacity_factor": 0.5}),
        _reduced(get_config, "deepseek_moe_16b", {"capacity_factor": 0.5})))
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(7))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    prompt = np.random.default_rng(7).integers(1, cfg.vocab_size, 16).astype(np.int32)
    first, behind = np.zeros((3, 16), np.int32), np.zeros((3, 16), np.int32)
    first[0] = behind[2] = prompt
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, max_len=32)[0])
    j_first = np.asarray(prefill(jparams, {"tokens": jnp.asarray(first)}))[0]
    j_behind = np.asarray(prefill(jparams, {"tokens": jnp.asarray(behind)}))[2]
    assert np.abs(j_first - j_behind).max() > TOL  # more than the bar the packages meet
    model = Model(cfg)
    t_first = model.prefill(tparams, {"tokens": torch.from_numpy(first)}, 32)[0][0].numpy()
    t_behind = model.prefill(tparams, {"tokens": torch.from_numpy(behind)}, 32)[0][2].numpy()
    assert np.abs(t_first - j_first).max() < TOL and np.abs(t_behind - j_behind).max() < TOL
    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    t_first, t_behind = (Model(dropless).prefill(tparams, {"tokens": torch.from_numpy(b)}, 32)[0][i]
                         for b, i in ((first, 0), (behind, 2)))
    assert torch.allclose(t_first, t_behind, atol=1e-5)  # dropless: the slot does not matter
