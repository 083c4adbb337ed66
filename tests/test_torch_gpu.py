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
                                     (1000, 5120, 1e-5), (4000, 128, 1e-6)])
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


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_model_layout(dev, dtype):
    rng = np.random.default_rng(3)
    B, S, Hkv, G, dh = 2, 200, 2, 5, 128
    q = _randn(rng, (B, S, Hkv, G, dh), dtype, dev)
    k, v = _randn(rng, (B, S, Hkv, dh), dtype, dev), _randn(rng, (B, S, Hkv, dh), dtype, dev)
    out = fa_ops.flash_attention(q, k, v)
    ref = attention_ref(q.reshape(B, S, Hkv * G, dh).transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2))
    assert _err(out, ref.transpose(1, 2).reshape(B, S, Hkv, G, dh)) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,Hkv,G,T,dh,nv",
    [(2, 4, 2, 512, 64, 300), (1, 2, 6, 1024, 128, 1024), (2, 8, 1, 512, 64, 1),
     (1, 2, 4, 600, 32, 77), (4, 8, 5, 2048, 128, 1), (4, 8, 5, 2048, 128, 1000),
     (4, 8, 5, 2048, 128, 2048)],
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
