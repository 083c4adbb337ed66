"""The port's Model (prefill + decode) against the JAX Model, same weights and tokens.

Bars: logits within 2e-3, as `tests/test_decode_equivalence.py` requires of
JAX's own prefill + decode against its forward (in float32 the two packages
agree to about 1e-5); greedy tokens identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import Model
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.slow  # JAX compiles the reduced model

CPU = torch.device("cpu")
B, S, S0 = 2, 48, 32


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_get_config("qwen3_14b").reduced(), get_config("qwen3_14b").reduced()
    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(1))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jm, jparams, cfg, tparams, tokens


def _port_logits(model, params, tokens):
    """Prefill S0 tokens, then teacher-forced decode: logits (S - S0 + 1, B, V)."""
    t = torch.from_numpy(tokens)
    logits, cache = model.prefill(params, {"tokens": t[:, :S0]}, max_len=S)
    outs = [logits]
    for i in range(S0, S):
        logits, cache = model.decode_step(params, cache, t[:, i:i + 1])
        outs.append(logits)
    assert cache["pos"] == S
    return torch.stack(outs[:-1]).numpy(), logits.numpy()


@pytest.mark.parametrize("kernels", [True, False])
def test_port_prefill_decode_matches_jax_prefill_decode(setup, kernels):
    jm, jparams, cfg, tparams, tokens = setup
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=S))(
        jparams, {"tokens": jnp.asarray(tokens[:, :S0])})
    ref = [np.asarray(logits)]
    dec = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    for i in range(S0, S):
        logits, cache = dec(jparams, cache, jnp.asarray(tokens[:, i:i + 1]))
        ref.append(np.asarray(logits))
    ours, last = _port_logits(Model(cfg, kernels=kernels), tparams, tokens)
    err = max(np.abs(ours - np.stack(ref[:-1])).max(), np.abs(last - ref[-1]).max())
    assert err < 2e-3, err
    assert (ours.argmax(-1) == np.stack(ref[:-1]).argmax(-1)).all()


def test_port_prefill_decode_matches_jax_forward(setup):
    jm, jparams, cfg, tparams, tokens = setup
    x, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
    full = np.asarray(jm._head(jparams, x))  # (B, S, V)
    ours, _ = _port_logits(Model(cfg), tparams, tokens)
    err = np.abs(ours - np.moveaxis(full[:, S0 - 1:S - 1], 1, 0)).max()
    assert err < 2e-3, err


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_model_refuses_unported_families(family):
    """The recurrent families run only with the block JAX builds them from (RWKV6
    for ssm, Mamba2 and a shared-block period for hybrid): a dense config
    relabelled, or a pure-Mamba2 ssm stack, is refused, not run as another model."""
    cfg = dataclasses.replace(get_config("qwen3_14b").reduced(), family=family)
    with pytest.raises(NotImplementedError, match="not a stack JAX builds"):
        Model(cfg)
    other = "rwkv6_7b" if family == "hybrid" else "zamba2_1p2b"
    with pytest.raises(NotImplementedError, match="not a stack JAX builds"):
        Model(dataclasses.replace(get_config(other).reduced(), family=family, attn_every=2))
    Model(get_config("zamba2_1p2b" if family == "hybrid" else "rwkv6_7b"))


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "arctic_480b"])
def test_model_accepts_the_moe_family(arch):
    """Both MoE configs build at full size (nothing is allocated): deepseek with
    its leading dense layer outside the stack, arctic with none."""
    model = Model(get_config(arch))
    assert model.cfg.family == "moe"
    assert (model.n_head, model.n_scan) == ((1, 27) if arch == "deepseek_moe_16b" else (0, 35))
