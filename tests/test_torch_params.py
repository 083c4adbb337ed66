"""The port's configs and parameter trees against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import ALIASES as JAX_ALIASES
from repro.configs import get_config as jax_get_config
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import ALIASES, ARCHS, get_config
from repro_torch.models import params as tparams
from repro_torch.models.transformer import Model
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
# each dense-family config, with JAX's Model.param_count() at full size
PARAM_COUNTS = {
    "qwen3_14b": 14_768_307_200,
    "starcoder2_3b": 3_180_705_792,
    "h2o_danube_1p8b": 1_831_201_280,
    "minitron_8b": 7_734_829_056,
    "musicgen_large": 2_424_705_024,
    "pixtral_12b": 12_247_782_400,
    "deepseek_moe_16b": 16_375_728_128,
    "arctic_480b": 476_850_275_328,
    "zamba2_1p2b": 1_180_459_648,
    "rwkv6_7b": 7_577_018_368,
}


def test_registry_holds_the_dense_family():
    """Every config of the JAX package is in the port's registry, with JAX's aliases."""
    assert sorted(ARCHS) == sorted(PARAM_COUNTS) == sorted(JAX_ALIASES.values())
    assert ALIASES == JAX_ALIASES
    with pytest.raises(ValueError, match="not ported"):
        get_config("llama-405b")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_jax(reduced, arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    for f in dataclasses.fields(ours):
        if f.name == "ssm" and ours.ssm is not None:  # two SSMCfg types: field by field
            assert dataclasses.asdict(ours.ssm) == dataclasses.asdict(theirs.ssm)
            continue
        if f.name == "moe" and ours.moe is not None:  # two MoECfg types: field by field
            for g in dataclasses.fields(ours.moe):
                assert getattr(ours.moe, g.name) == getattr(theirs.moe, g.name), g.name
            # every field, `shard_ff_dp` too (it places the experts on a mesh)
            assert {g.name for g in dataclasses.fields(theirs.moe)} == {
                g.name for g in dataclasses.fields(ours.moe)}
            continue
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert (ours.q_dim, ours.kv_dim) == (theirs.q_dim, theirs.kv_dim)
    assert str(ours.compute_dtype).removeprefix("torch.") == str(theirs.compute_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_jax_at_full_width(arch):
    # counted from the shapes alone: nothing is allocated
    assert Model(get_config(arch)).param_count() == PARAM_COUNTS[arch]
    assert JaxModel(jax_get_config(arch)).param_count() == PARAM_COUNTS[arch]


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_round_trips_bit_equal(dtype, arch):
    jcfg = jax_get_config(arch).reduced(dtype=dtype, param_dtype=dtype)
    cfg = get_config(arch).reduced(dtype=dtype, param_dtype=dtype)
    jparams = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0)))
    ours = dict(_leaves(tparams.from_jax(jparams, cfg, CPU)))
    theirs = dict(_leaves(jparams))
    assert ours.keys() == theirs.keys()
    for path, a in theirs.items():
        t = ours[path]
        assert tuple(t.shape) == a.shape, path
        if path == "lm_head/w":  # widened to float32 once at load, exactly
            assert t.dtype == torch.float32
            t = t.to(getattr(torch, dtype))
        if dtype == "bfloat16" and a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16), path)
        else:
            np.testing.assert_array_equal(t.numpy(), a, path)


# leaves that JAX initialises to a constant (zeros, ones or another value)
CONSTANT_LEAVES = ("bias", "scale", "_norm", "conv_b", "a_log", "d_skip", "dt_bias", "mamba/norm",
                   "w0", "maa_x", "maa", "mu_k", "mu_r")


@pytest.mark.parametrize("arch", ["qwen3_14b", "starcoder2_3b", "deepseek_moe_16b", "zamba2_1p2b",
                                  "rwkv6_7b"])
def test_own_init_is_seeded_per_leaf(arch):
    cfg = get_config(arch).reduced()
    a, b = tparams.init_params(cfg, 0, CPU), tparams.init_params(cfg, 0, CPU)
    c = tparams.init_params(cfg, 1, CPU)
    jdefs = dict(_leaves(jax.tree.map(np.asarray, JaxModel(jax_get_config(arch).reduced()).init(
        jax.random.PRNGKey(0)))))
    for (path, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b), _leaves(c)):
        assert torch.equal(x, y), path
        assert tuple(x.shape) == jdefs[path].shape, path
        if path.endswith(CONSTANT_LEAVES):  # the same constants as JAX's
            np.testing.assert_array_equal(x.numpy(), jdefs[path], path)
        elif path.endswith("conv_w"):  # Mamba2's conv weights: stddev 0.1
            assert not torch.equal(x, z) and abs(x.float().std().item() - 0.1) < 0.02, path
        else:
            assert not torch.equal(x, z), path
            assert abs(x.float().std().item() - 0.02) < 0.005, path
    # leaves of one shape draw from their own generators
    top, block = {"zamba2_1p2b": ("shared", "attn"), "rwkv6_7b": ("layers", "tm")}.get(
        arch, ("layers", "attn"))
    assert not torch.equal(a[top][block]["wk"], a[top][block]["wv"])
    assert a["lm_head"]["w"].dtype == torch.float32
    if cfg.moe is not None:  # the router is held in float32, as JAX's
        assert a["layers"]["moe"]["router"].dtype == torch.float32
        assert a["layers"]["moe"]["wi"].dtype == cfg.pdtype


def test_layer_params_are_views():
    cfg = get_config("qwen3_14b").reduced()
    p = tparams.init_params(cfg, 0, CPU)
    lp = tparams.layer_params(p, 1)
    assert lp["attn"]["wq"].data_ptr() == p["layers"]["attn"]["wq"][1].data_ptr()
    assert lp["ln2"]["scale"].shape == (cfg.d_model,)
