"""The port's KV-cache and recurrent-state layouts against JAX's, and the combine
of a split cache's partial outputs.

No process: as in `tests/test_torch_axes.py`, JAX's `cache_pspecs` and
sanitizers read only a stand-in mesh's `shape`, and the port reads the same
stand-in. Every config at full size, on the 2x4, 2x2x2 and 16x16 stand-ins,
under `rules_for` with each decode shape of JAX's `SHAPES` (context
parallelism on "data" where the batch is smaller than the data axes), as JAX's
dry-run lowers `decode_step`.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES
from repro.launch import mesh as jmesh
from repro.models.transformer import Model as JaxModel
from repro.parallel import axes as jaxes
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import NEG_INF, decode_attention_ref
from repro_torch.launch import mesh as tmesh
from repro_torch.models.transformer import Model
from repro_torch.parallel import axes as taxes
from test_torch_axes import MESHES, _check_placements, _jax_leaves, _meshes, _norm
from torch_threads import one_thread  # noqa: F401

DECODE = [s for s in SHAPES.values() if s.kind == "decode"]


def _leaves(tree, path=""):
    """{path: leaf} of a port cache or spec tree (dicts and the hybrid tail's tuple)."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        p = f"{path}/{k}" if path else str(k)
        if isinstance(v, dict) or (isinstance(v, tuple) and v and isinstance(v[0], dict)):
            out.update(_leaves(v, p))
        else:
            out[p] = v
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_and_shapes_match_jax(arch, mesh):
    """`Model.cache_pspecs(cp)`, raw and sanitized against `cache_shapes`, equals
    JAX's leaf by leaf, and the port's DTensor placements of the sanitized specs
    say what JAX's entries say; `cache_shapes` equals JAX's in shape and dtype
    (`pos`, a host int in the port, is JAX's int32 scalar)."""
    jm, tm = _meshes(mesh)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    model, jmodel = Model(cfg), JaxModel(jcfg)
    for shape in DECODE:
        jr, tr = jmesh.rules_for(jm, shape), tmesh.rules_for(tm, shape)
        cp = bool(jr.cp)
        assert cp == bool(tr.cp)
        jshapes = jmodel.cache_shapes(shape.global_batch, shape.seq_len, cp=cp)  # no mesh: shapes only
        tshapes = _leaves(model.cache_shapes(shape.global_batch, shape.seq_len, cp=cp))
        with jaxes.use_mesh(jm, jr):
            jspecs = jmodel.cache_pspecs(cp=cp)
            jsan = _jax_leaves(jaxes.sanitize_spec_tree(jspecs, jshapes, jm))
        with taxes.use_mesh(tm, tr):
            tspecs = _leaves(model.cache_pspecs(cp=cp))
        jspecs, jshapes = _jax_leaves(jspecs), dict(
            (k, v) for k, v in _jax_leaves(jax.tree.map(lambda a: a, jshapes)).items())
        assert tspecs.keys() == jspecs.keys() == tshapes.keys(), (shape.name, sorted(tspecs))
        for k, spec in tspecs.items():
            js = jshapes[k]
            if k == "pos":
                assert (tshapes[k], spec, js.shape, str(js.dtype)) == (0, (), (), "int32")
                continue
            t = tshapes[k]
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == (js.shape, str(js.dtype))
            rank = len(js.shape)
            assert _norm(spec, rank) == _norm(jspecs[k], rank), (shape.name, k)
            san = taxes.sanitize_pspec(spec, js.shape, tm)
            assert san == _norm(jsan[k], rank), (shape.name, k)
            _check_placements(san, tm)


def _split(q, k, v, n_valid, parts, order=None):
    """The plain decode of q over a (B, Hkv, T, dh) cache cut into `parts` contiguous
    parts of its slots (in `order`, a ring's, when given), combined: (out, the
    parts' valid counts)."""
    if order is not None:
        k, v = k[:, :, order], v[:, :, order]
    T = k.shape[2]
    n = T // parts
    outs, lses, counts = [], [], []
    for r in range(parts):
        nv = min(max(n_valid - r * n, 0), n)
        counts.append(nv)
        if nv == 0:
            outs.append(torch.zeros(q.shape))
            lses.append(torch.full(q.shape[:-1], NEG_INF))
            continue
        o, lse = decode_attention_ref(q, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
                                      nv, lse=True)
        outs.append(o)
        lses.append(lse)
    return taxes.lse_combine(torch.stack(outs), torch.stack(lses)), counts


@pytest.mark.parametrize("T, n_valid, parts", [(2048, 1000, 2), (2048, 1100, 4), (512, 100, 4),
                                               (64, 1, 8)])
def test_lse_combine_of_cache_parts_equals_the_whole_cache(T, n_valid, parts):
    """flash-decode's combine (`lse_combine`) over contiguous parts of a cache, the
    parts past n_valid empty (o 0, lse NEG_INF, no NaN), equals the whole cache's
    plain decode to 1e-6 in float32; the plain LSE is the log of the softmax's
    normaliser."""
    rng = np.random.default_rng(T + parts)
    q = torch.from_numpy(rng.standard_normal((2, 2, 4, 64), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, T, 64), dtype=np.float32)) for _ in range(2))
    whole, lse = decode_attention_ref(q, k, v, n_valid, lse=True)
    out, counts = _split(q, k, v, n_valid, parts)
    assert 0 in counts and sum(counts) == n_valid  # an empty part
    assert torch.isfinite(out).all() and (out - whole).abs().max() <= 1e-6
    s = torch.einsum("bhgd,bhkd->bhgk", q, k[:, :, :n_valid]) * 64 ** -0.5
    assert (lse - torch.logsumexp(s, -1)).abs().max() <= 1e-6


@pytest.mark.parametrize("parts", [2, 4])
def test_lse_combine_of_a_split_ring_equals_the_whole(parts):
    """A sliding-window ring past its window (slot = t mod W, every slot valid),
    cut into parts in ring order: the combine equals the whole window's decode
    in token order, as the softmax does not depend on slot order."""
    rng = np.random.default_rng(parts)
    W, pos = 16, 37  # tokens 22..37 in the ring
    q = torch.from_numpy(rng.standard_normal((1, 2, 3, 32), dtype=np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, W, 32), dtype=np.float32)) for _ in range(2))
    tokens = torch.arange(pos - W + 1, pos + 1)
    ring = torch.argsort(tokens % W)  # slot s holds the token ring[s] of the window
    whole = decode_attention_ref(q, k, v, W)
    out, counts = _split(q, k, v, W, parts, order=ring)
    assert counts == [W // parts] * parts and (out - whole).abs().max() <= 1e-6


def test_decode_wrapper_returns_the_lse_on_the_cpu():
    """`decode_attention(..., lse=True)` (the kernel's plain version on a CPU tensor)
    and its model-layout form give the plain (out, lse)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 1, 2, 4, 32), dtype=np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((2, 40, 2, 32), dtype=np.float32))
              for _ in range(2))
    out, lse = dec_ops.decode_attention_cache(q, kc, vc, 33, lse=True)
    ref, ref_lse = decode_attention_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), 33, lse=True)
    assert out.shape == (2, 1, 2, 4, 32) and lse.shape == (2, 1, 2, 4)
    assert torch.equal(out[:, 0], ref) and torch.equal(lse[:, 0], ref_lse)
    assert torch.equal(dec_ops.decode_attention_cache(q, kc, vc, 33), out)


def test_the_mesh_is_seen_from_other_threads():
    """Autograd runs a CUDA backward, and with it a checkpointed block's recompute,
    on its own device threads: `use_mesh` holds for the whole process, so the
    recompute places its tensors as the forward did."""
    import threading
    import types

    standin = types.SimpleNamespace(shape={"data": 2, "model": 2})
    rules = taxes.make_rules(dp=("data",), tp=("model",))
    seen = []
    with taxes.use_mesh(standin, rules):
        t = threading.Thread(target=lambda: seen.append((taxes.current_mesh(), taxes.axes_size("tp"))))
        t.start()
        t.join()
    assert seen == [(standin, 2)] and taxes.current_mesh() is None
