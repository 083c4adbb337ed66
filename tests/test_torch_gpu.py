"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: they skip where there is no CUDA device (decided inside the
fixture, so every worker collects the same tests). This file imports no JAX,
so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the JAX package's kernel bars (`tests/test_kernels.py`):
2e-5 in float32 (sums taken in another order) and 3e-2 in bfloat16.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.decode_attention import flash_decode
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,D,eps", [(256, 512, 1e-5), (300, 256, 1e-5), (64, 1024, 1e-5),
                                     (1000, 5120, 1e-5), (4000, 128, 1e-6), (4, 5120, 1e-5),
                                     (40000, 128, 1e-6), (7, 5120, 1e-5), (33, 100, 1e-5)])
def test_rmsnorm_kernels(dev, dtype, T, D, eps):
    rng = np.random.default_rng(2)
    x, res = _randn(rng, (T, D), dtype, dev), _randn(rng, (T, D), dtype, dev)
    # gains near one, as in the model; see NORM_GAIN_NOTE in chip_smoke.py
    sc = 1 + 0.1 * _randn(rng, (D,), torch.float32, dev)
    n0 = dict(build.LAUNCHES)
    y = rms_ops.rmsnorm(x, sc, eps=eps)
    y1, r1 = rms_ops.rmsnorm_residual(x, res, sc, eps=eps)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm"] == n0["rmsnorm"] + 1
    assert build.LAUNCHES["rmsnorm_residual"] == n0["rmsnorm_residual"] + 1
    assert _err(y, rmsnorm_ref(x, sc, eps=eps)) < TOL[dtype]
    y2, r2 = rmsnorm_residual_ref(x, res, sc, eps=eps)
    assert _err(y1, y2) < TOL[dtype] and _err(r1, r2) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,Hq,Hkv,S,dh,win",
    [(2, 4, 4, 256, 64, None), (1, 8, 2, 256, 128, None), (2, 4, 2, 384, 64, 128),
     (1, 2, 1, 300, 32, None), (1, 40, 8, 1000, 128, None)],
)
def test_flash_attention_kernel(dev, dtype, B, Hq, Hkv, S, dh, win):
    rng = np.random.default_rng(0)
    q = _randn(rng, (B, Hq, S, dh), dtype, dev)
    k, v = _randn(rng, (B, Hkv, S, dh), dtype, dev), _randn(rng, (B, Hkv, S, dh), dtype, dev)
    n0 = build.LAUNCHES["flash_attention"]
    out = fa_ops.flash_attention_bhsd(q, k, v, window=win)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == n0 + 1
    assert _err(out, attention_ref(q, k, v, window=win)) < TOL[dtype]


def _model_layout_case(dev, dtype, B, S, Hkv, G, dh, window=None, seed=3):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, S, Hkv, G, dh), dtype, dev)
    k, v = _randn(rng, (B, S, Hkv, dh), dtype, dev), _randn(rng, (B, S, Hkv, dh), dtype, dev)
    n0 = build.LAUNCHES["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == n0 + 1
    ref = attention_ref(q.reshape(B, S, Hkv * G, dh).transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), window=window)
    assert _err(out, ref.transpose(1, 2).reshape(B, S, Hkv, G, dh)) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_model_layout(dev, dtype):
    _model_layout_case(dev, dtype, 2, 200, 2, 5, 128)


@pytest.mark.parametrize("B,S,Hkv,G,dh,win", [(4, 1100, 8, 5, 128, None), (1, 2048, 8, 5, 128, None),
                                              (2, 1000, 2, 4, 64, 128)])
def test_flash_attention_tensor_cores_serving_shapes(dev, B, S, Hkv, G, dh, win):
    """The bf16 tensor-core kernel at the serve path's shapes (qwen3-14b: 40 query
    heads over 8 kv heads, dh 128, S not a multiple of the tiles) and at dh 64
    with a window."""
    _model_layout_case(dev, torch.bfloat16, B, S, Hkv, G, dh, window=win, seed=4)


def test_flash_attention_rejects_misaligned_views(dev):
    z = torch.zeros(1, 2, 8, 68, device=dev, dtype=torch.bfloat16)[..., :64]  # 136-byte rows
    ok = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    n0 = build.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_attention_bhsd(z, ok, ok)
    assert build.LAUNCHES["flash_attention"] == n0


def test_rmsnorm_scalar_path_on_misaligned_rows(dev):
    """x starting 2 bytes past a 16-byte boundary takes the scalar loads."""
    rng = np.random.default_rng(5)
    x = _randn(rng, (7 * 5120 + 1,), torch.bfloat16, dev)[1:].view(7, 5120)
    sc = 1 + 0.1 * _randn(rng, (5120,), torch.float32, dev)
    n0 = build.LAUNCHES["rmsnorm"]
    y = rms_ops.rmsnorm(x, sc)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm"] == n0 + 1
    assert _err(y, rmsnorm_ref(x, sc)) < TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,Hkv,G,T,dh,nv",
    [(2, 4, 2, 512, 64, 300), (1, 2, 6, 1024, 128, 1024), (2, 8, 1, 512, 64, 1),
     (1, 2, 4, 600, 32, 77), (4, 8, 5, 2048, 128, 1), (4, 8, 5, 2048, 128, 1000),
     (4, 8, 5, 2048, 128, 2048), (4, 8, 5, 2048, 128, 1100), (1, 2, 5, 600, 64, 63),
     (1, 2, 5, 600, 64, 64), (1, 2, 5, 600, 64, 65), (2, 1, 16, 2048, 128, 1100),
     (1, 1, 1, 2048, 64, 2047), (2, 4, 6, 600, 128, 300)],
)
def test_decode_attention_kernel(dev, dtype, B, Hkv, G, T, dh, nv):
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, Hkv, G, dh), dtype, dev)
    # the cache in the model's (B, T, Hkv, dh) layout, handed over as a strided view
    kc, vc = _randn(rng, (B, T, Hkv, dh), dtype, dev), _randn(rng, (B, T, Hkv, dh), dtype, dev)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    n0 = build.LAUNCHES["decode_attention"]
    out = flash_decode(q, k, v, nv)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == n0 + 1
    assert _err(out, decode_attention_ref(q, k, v, nv)) < TOL[dtype]


def _decode_case(dev, dtype, B, Hkv, G, T, dh, seed=12):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, Hkv, G, dh), dtype, dev)
    kc, vc = _randn(rng, (B, T, Hkv, dh), dtype, dev), _randn(rng, (B, T, Hkv, dh), dtype, dev)
    return q, kc, vc


@pytest.mark.parametrize("dtype,dh,nv", [(torch.bfloat16, 128, 1100), (torch.bfloat16, 64, 65),
                                         (torch.bfloat16, 32, 77), (torch.float32, 128, 1100)])
def test_decode_attention_nan_tail_is_never_read(dev, dtype, dh, nv):
    """Slots at or past n_valid may hold anything, NaN included: the result is
    bitwise the one with a zero tail (the TMA maps end at n_valid)."""
    q, kc, vc = _decode_case(dev, dtype, 4, 8, 5, 2048, dh)
    outs = []
    for fill in (0.0, float("nan")):
        kc[:, nv:], vc[:, nv:] = fill, fill
        outs.append(flash_decode(q, kc.transpose(1, 2), vc.transpose(1, 2), nv))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[1].float()).all() and torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_cuda_graph_replay(dev, dtype):
    """A call captured in a CUDA graph and replayed equals the eager call."""
    q, kc, vc = _decode_case(dev, dtype, 4, 8, 5, 2048, 128)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)
    eager = flash_decode(q, k, v, 1100)
    flash_decode(q, k, v, 1100)  # warm-up on the capture's stream
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = flash_decode(q, k, v, 1100)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_decode_attention_clusters_fit_one_wave(dev):
    """The serving plan's clusters (8 CTAs of ~97 KB) are resident at once on an H100."""
    from repro_torch.kernels.decode_attention import decode_attention as dec

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dec.launch_plan(1100, 4, 8, 5, 128, tensor_cores=True, sms=sms)
    assert dec.max_active_clusters(plan, 128) >= 1


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 256, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x, torch.ones(256, device=dev))
    q = torch.zeros(1, 2, 4, 96, device=dev)
    with pytest.raises(ValueError):
        flash_decode(q, torch.zeros(1, 2, 8, 96, device=dev), torch.zeros(1, 2, 8, 96, device=dev), 3)
    with pytest.raises(TypeError):
        flash_decode(torch.zeros(1, 2, 4, 64, device=dev), torch.zeros(1, 2, 8, 64, device=dev),
                     torch.zeros(1, 2, 8, 64, device=dev), torch.tensor(3, device=dev))
    n0 = build.LAUNCHES["decode_attention"]
    kv = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    padded = torch.zeros(1, 2, 8, 68, device=dev, dtype=torch.bfloat16)[..., :64]  # 136-byte rows
    with pytest.raises(ValueError, match="16-byte"):  # TMA cannot read it
        flash_decode(torch.zeros(1, 2, 4, 64, device=dev, dtype=torch.bfloat16), padded, kv, 3)
    with pytest.raises(ValueError):  # mixed dtypes
        flash_decode(torch.zeros(1, 2, 4, 64, device=dev), kv, kv, 3)
    assert build.LAUNCHES["decode_attention"] == n0
