"""The port in bfloat16 against the JAX package in bfloat16 (ROADMAP C10).

- The MoE combine: `moe.combine` against JAX's `zeros((T, D)).at[token_of]
  .add(vals * w[:, None])` on the same random `vals`, `w` and `order` (T 64,
  K 6, D 256), bit for bit in bfloat16 and in float32: XLA's CPU scatter adds
  one update at a time in update order, rounding after each add, and the
  port adds a token's rows in that order.
- Whole models: reduced qwen3-14b and deepseek-moe-16b with
  `dtype = param_dtype = "bfloat16"` and the same `from_jax` weights, prefill
  of 48 tokens and 4 decode steps, port against JAX, on the kernel path (the
  kernels' plain versions here) and the plain path. The bar is twice the bf16
  floor, the distance of JAX in bf16 from JAX in float32 on the same weights
  (upcast) and tokens, as `chip_smoke.py`'s phase 4 sets its bar. deepseek
  runs at dropless capacity, and its logits are compared where the three runs
  route alike: its one MoE layer is the last layer, so a token's routing
  reaches its own logits only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import Model
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
B, S0, STEPS = 2, 48, 4


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_combine_matches_jax_scatter_add_bit_for_bit(dtype):
    T, K, D = 64, 6, 256
    A = T * K
    rng = np.random.default_rng(3)
    vals = 4 * rng.standard_normal((A, D), dtype=np.float32)
    w = rng.random(A, dtype=np.float32)
    order = rng.permutation(A)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jv, jw = jnp.asarray(vals).astype(jd), jnp.asarray(w).astype(jd)
    ref = jnp.zeros((T, D), jd).at[jnp.asarray(order) // K].add(jv * jw[:, None])
    ours = moe.combine(torch.from_numpy(vals).to(td), torch.from_numpy(w).to(td),
                       torch.from_numpy(order), T, K)
    assert ours.dtype == td
    bits = np.int16 if dtype == "bfloat16" else np.int32
    np.testing.assert_array_equal(ours.view(getattr(torch, bits.__name__)).numpy(),
                                  np.asarray(ref).view(bits))
    # summing a token's rows and rounding once is another function in bf16
    if dtype == "bfloat16":
        rank = np.argsort(order)
        once = (torch.from_numpy(vals).to(td) * torch.from_numpy(w).to(td)[:, None]).float()
        once = once[torch.from_numpy(rank).view(T, K)].sum(1).to(td)
        assert not torch.equal(once, ours)


def _record_jax_routing(monkeypatch) -> list:
    """Wrap JAX's `_moe_group` so that each call also reports its top-k expert ids."""
    rec, orig = [], jmoe._moe_group

    def wrapped(cfg, p, xf, C):
        probs = jax.nn.softmax(xf.astype(jnp.float32) @ p["router"], axis=-1)
        _, topi = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(lambda t: rec.append(np.sort(np.asarray(t), -1)), topi, ordered=True)
        return orig(cfg, p, xf, C)

    monkeypatch.setattr(jmoe, "_moe_group", wrapped)
    return rec


def _configs(get, arch, dtype):
    cfg = get(arch).reduced(dtype=dtype, param_dtype=dtype)
    if cfg.moe is not None:  # dropless: one token's routing cannot drop another
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    return cfg


def _jax_run(jm, params, toks, rec):
    """JAX's prefill of S0 tokens and STEPS decode steps: logits (STEPS + 1, B, V) and
    each MoE call's sorted top-k ids."""
    rec.clear()
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, max_len=S0 + STEPS))(
        params, {"tokens": jnp.asarray(toks[:, :S0])})
    dec = jax.jit(jm.decode_step)
    outs = [np.asarray(logits)]
    for i in range(S0, S0 + STEPS):
        logits, cache = dec(params, cache, jnp.asarray(toks[:, i:i + 1]))
        outs.append(np.asarray(logits))
    jax.effects_barrier()
    return np.stack(outs).astype(np.float32), list(rec)


def _logit_tokens(calls: list) -> np.ndarray:
    """Top-k ids (STEPS + 1, B, K) of the tokens whose logits are compared: the
    prefill's last token of each row, then each decode step's token."""
    first = calls[0].reshape(B, S0, -1)[:, -1]
    return np.stack([first, *[c.reshape(B, -1) for c in calls[1:]]])


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["qwen3_14b", "deepseek_moe_16b"])
def test_bf16_prefill_decode_within_twice_the_bf16_floor(arch, monkeypatch):
    rec = _record_jax_routing(monkeypatch)
    jcfg, jcfg32, cfg = (_configs(jax_get_config, arch, "bfloat16"),
                         _configs(jax_get_config, arch, "float32"),
                         _configs(get_config, arch, "bfloat16"))
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(11))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (B, S0 + STEPS)).astype(np.int32)
    ref, jroute = _jax_run(jm, params, toks, rec)
    ref32, jroute32 = _jax_run(JaxModel(jcfg32), params32, toks, rec)
    tparams = from_jax(jax.tree.map(np.asarray, params), cfg, CPU)
    assert tparams["layers"]["attn"]["wq"].dtype == torch.bfloat16
    t = torch.from_numpy(toks)
    for kernels in (True, False):
        model = Model(cfg, kernels=kernels)
        with moe.routing_record() as trec:
            logits, cache = model.prefill(tparams, {"tokens": t[:, :S0]}, S0 + STEPS)
            outs = [logits]
            for i in range(S0, S0 + STEPS):
                logits, cache = model.decode_step(tparams, cache, t[:, i:i + 1])
                outs.append(logits)
        ours = torch.stack(outs).numpy()
        alike = np.ones(ours.shape[:2], bool)
        if cfg.moe is not None:
            assert model.n_scan == 1  # the MoE layer is the last: routing reaches its own token only
            routes = [_logit_tokens(r) for r in
                      ([np.sort(ti.numpy(), -1) for ti, _ in trec], jroute, jroute32)]
            alike = (routes[0] == routes[1]).all(-1) & (routes[1] == routes[2]).all(-1)
            assert alike.mean() >= 0.75, alike
        err = np.abs(ours - ref).max(-1)[alike].max()
        floor = np.abs(ref - ref32).max(-1)[alike].max()
        assert 0 < err <= 2 * floor, (kernels, err, floor)
