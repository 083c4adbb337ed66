"""The port's prefill and decode on a device mesh, held to its single-device run.

Gloo processes on the CPU (`torch_dist.spawn`) at `reduced()` sizes in float32.
Each rank serves one prompt greedily twice with the same seeded parameters:
on one device, then placed on the mesh under JAX's decode rules
(`rules_for` with a decode shape of global batch 1, which puts context
parallelism on "data" where the data axis is wider than the batch), and
returns the differences. Bars: `tests/test_decode_equivalence.py`'s 2e-3 on
the logits, greedy tokens identical (`tests/test_system.py`), and every cache
leaf placed as `Model.cache_pspecs` says.
"""

import types

import numpy as np
import pytest
import torch

from torch_dist import spawn

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh, rules_for
from repro_torch.models.params import distribute
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import placements, sanitize_pspec, use_mesh
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")
LOGIT_TOL = 2e-3
DECODE_1 = types.SimpleNamespace(kind="decode", global_batch=1)  # JAX's ShapeSpec, as rules_for reads it


def _greedy(model, params, batch, steps, max_len, cp=False):
    """Prefill, then `steps` greedy decode steps: (logits (steps + 1, V), tokens, cache)."""
    logits, cache = model.prefill(params, batch, max_len, cp=cp)
    outs, toks = [logits], []
    for _ in range(steps):
        tok = logits.argmax(-1, keepdim=True)
        toks.append(int(tok[0, 0]))
        logits, cache = model.decode_step(params, cache, tok, cp=cp)
        outs.append(logits)
    return torch.cat(outs), toks, cache


def _leaves(tree, specs, path=""):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        p = f"{path}/{k}" if path else str(k)
        if isinstance(v, (dict, tuple)):
            yield from _leaves(v, specs[k], p)
        elif isinstance(v, torch.Tensor):
            yield p, v, specs[k]


def serve_on_mesh(rank, world, arch, overrides, mesh_shape, prompt, steps, max_len):
    cfg = get_config(arch).reduced(**overrides)
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    rules = rules_for(mesh, DECODE_1)
    cp = bool(rules.cp)
    model = Model(cfg)
    params = model.init(0, CPU)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prompt)))
    batch = {"tokens": toks}
    if cfg.input_mode == "embeds":
        batch["embeds"] = torch.from_numpy(rng.standard_normal((1, prompt, cfg.d_model),
                                                               dtype=np.float32))
    ref, ref_toks, _ = _greedy(model, params, batch, steps, max_len)
    with use_mesh(mesh, rules):
        placed = distribute(params, model.pspecs(), mesh)
        out, out_toks, cache = _greedy(model, placed, batch, steps, max_len, cp=cp)
        specs = model.cache_pspecs(cp)
        wrong = [p for p, t, spec in _leaves({k: v for k, v in cache.items() if k != "pos"}, specs)
                 if tuple(t.placements) != placements(sanitize_pspec(spec, tuple(t.shape), mesh), mesh)]
        # the attention caches' length dim: (..., B, W, Hkv, dh)
        split = [p for p, t, _ in _leaves({k: v for k, v in cache.items() if k != "pos"}, specs)
                 if p[-2:] in ("/k", "/v") and any(getattr(pl, "dim", None) == t.dim() - 3
                                                   for pl in t.placements)]
    return {"err": float((out - ref).abs().max()), "tokens": (ref_toks, out_toks), "cp": cp,
            "wrong": wrong, "split": split, "pos": cache["pos"]}


CASES = {
    # cp on data (2 ranks), kv heads on model; a prompt shorter than half the
    # cache, so the data rank holding its second half starts with no valid slot
    "qwen3-14b": (dict(), (2, 2), 5, 6, 16),
    # a prompt past the window of 16: the ring is written in ring order and split
    # over data, every decode step reading all 16 slots
    "h2o-danube-1.8b": (dict(), (2, 2), 24, 5, 40),
    # Mamba2 states on model (by head; the conv state by column), the shared
    # block's cache at each application split over data
    "zamba2-1.2b": (dict(), (2, 2), 7, 5, 16),
    # one kv head: tp does not divide it, so the cache's length splits over model
    "qwen3-14b kv1": (dict(num_kv_heads=1), (1, 2), 5, 6, 16),
    # RWKV6's states on model by head (no KV cache: nothing splits by length)
    "rwkv6-7b": (dict(), (2, 2), 7, 5, 16),
    # the MoE family: the dense head layer's cache and the stacked MoE layers'
    "deepseek-moe-16b": (dict(), (2, 2), 5, 5, 16),
    # a prompt of embeddings (the vlm stub frontend), then tokens
    "pixtral-12b": (dict(), (2, 2), 5, 5, 16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_with_cp_match_one_device(case, tmp_path):
    overrides, mesh_shape, prompt, steps, max_len = CASES[case]
    out = spawn(serve_on_mesh, int(np.prod(mesh_shape)), tmp_path, case.split()[0], overrides,
                mesh_shape, prompt, steps, max_len, timeout=150)
    for r in out:
        assert r["err"] <= LOGIT_TOL, r["err"]
        assert r["tokens"][0] == r["tokens"][1]
        assert not r["wrong"], r["wrong"]
        assert r["pos"] == prompt + steps
        assert bool(r["split"]) != case.startswith("rwkv6"), r["split"]
    assert out[0]["cp"] == (mesh_shape[0] > 1)
