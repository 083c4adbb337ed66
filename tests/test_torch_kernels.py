"""The port's kernel modules on the CPU, against the JAX package's kernels.

The plain versions (`repro_torch.kernels.*.ref`, which CPU tensors take)
are held to JAX's oracles over the sweeps of `tests/test_kernels.py`, and
one case per kernel to the JAX wrapper running the Pallas kernel in
interpret mode. The Python around each CUDA kernel (layouts, strides,
`n_valid`, the ragged end) is checked by replaying the kernel's addressing
from `launch_args` on the CPU. The kernels themselves run in
`tests/test_torch_gpu.py`, on the card.

Tolerances: 2e-5 in float32 (the same function, sums in another order) and
3e-2 in bfloat16, the bars of `tests/test_kernels.py`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decode_attention import ops as jax_dec_ops
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention import ops as jax_fa_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.rmsnorm import ops as jax_rms_ops
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.rmsnorm.ref import rmsnorm_residual_ref as jax_rmsnorm_residual_ref
from repro_torch.kernels.decode_attention import decode_attention as dec_kernel
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]


def _pair(a: np.ndarray, dtype: str):
    """The same array for both packages, rounded to `dtype` by each (both round to nearest even)."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _err(j, t) -> float:
    return float(np.abs(np.asarray(j, np.float32) - t.float().numpy()).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,D", [(256, 512), (300, 256), (64, 1024)])
def test_rmsnorm_plain_vs_jax_oracle(dtype, T, D):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.standard_normal((T, D), dtype=np.float32), dtype)
    rj, rt = _pair(rng.standard_normal((T, D), dtype=np.float32), dtype)
    sj, st = _pair(rng.standard_normal((D,), dtype=np.float32), "float32")
    assert _err(jax_rmsnorm_ref(xj, sj), rms_ops.rmsnorm(xt, st)) < TOL[dtype]
    assert _err(jax_rmsnorm_ref(xj, sj, eps=1e-6), rms_ops.rmsnorm(xt, st, eps=1e-6)) < TOL[dtype]
    yj, r2j = jax_rmsnorm_residual_ref(xj, rj, sj)
    yt, r2t = rms_ops.rmsnorm_residual(xt, rt, st)
    assert _err(yj, yt) < TOL[dtype] and _err(r2j, r2t) < TOL[dtype]


FA_CASES = [
    (2, 4, 4, 256, 64, None),  # MHA
    (1, 8, 2, 256, 128, None),  # GQA 4:1
    (2, 4, 2, 384, 64, 128),  # GQA + sliding window
    (1, 2, 1, 300, 32, None),  # S not a block multiple
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,S,dh,win", FA_CASES)
def test_flash_attention_plain_vs_jax_oracle(dtype, B, Hq, Hkv, S, dh, win):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.standard_normal((B, Hq, S, dh), dtype=np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, Hkv, S, dh), dtype=np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, Hkv, S, dh), dtype=np.float32), dtype)
    err = _err(jax_attention_ref(qj, kj, vj, window=win), fa_ops.flash_attention_bhsd(qt, kt, vt, window=win))
    assert err < TOL[dtype], err


DEC_CASES = [
    (2, 4, 2, 512, 64, 300),
    (1, 2, 6, 1024, 128, 1024),
    (2, 8, 1, 512, 64, 1),  # one valid slot
    (1, 2, 4, 600, 32, 77),  # T not a block multiple
    (1, 2, 5, 600, 32, 600),  # G = 5, as qwen3-14b
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hkv,G,T,dh,nv", DEC_CASES)
def test_decode_attention_plain_vs_jax_oracle(dtype, B, Hkv, G, T, dh, nv):
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng.standard_normal((B, Hkv, G, dh), dtype=np.float32), dtype)
    kj, kt = _pair(rng.standard_normal((B, Hkv, T, dh), dtype=np.float32), dtype)
    vj, vt = _pair(rng.standard_normal((B, Hkv, T, dh), dtype=np.float32), dtype)
    err = _err(jax_decode_ref(qj, kj, vj, jnp.int32(nv)), dec_ops.decode_attention(qt, kt, vt, nv))
    assert err < TOL[dtype], err


# ------------------------------------------------ against the Pallas kernels (interpret mode)
@pytest.mark.slow
def test_rmsnorm_vs_pallas_interpret():
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.standard_normal((300, 256), dtype=np.float32), "float32")
    rj, rt = _pair(rng.standard_normal((300, 256), dtype=np.float32), "float32")
    sj, st = _pair(rng.standard_normal((256,), dtype=np.float32), "float32")
    assert _err(jax_rms_ops.rmsnorm(xj, sj), rms_ops.rmsnorm(xt, st)) < 2e-5
    yj, r2j = jax_rms_ops.rmsnorm_residual(xj, rj, sj)
    yt, r2t = rms_ops.rmsnorm_residual(xt, rt, st)
    assert _err(yj, yt) < 2e-5 and _err(r2j, r2t) < 2e-5


@pytest.mark.slow
def test_flash_attention_vs_pallas_interpret():
    rng = np.random.default_rng(6)
    B, S, Hkv, G, dh = 1, 200, 2, 2, 32
    qj, qt = _pair(rng.standard_normal((B, S, Hkv, G, dh), dtype=np.float32), "float32")
    kj, kt = _pair(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32), "float32")
    vj, vt = _pair(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32), "float32")
    out = jax_fa_ops.flash_attention(qj, kj, vj, window=64)
    assert _err(out, fa_ops.flash_attention(qt, kt, vt, window=64)) < 2e-5


@pytest.mark.slow
def test_decode_attention_vs_pallas_interpret():
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng.standard_normal((1, 2, 5, 32), dtype=np.float32), "float32")
    kj, kt = _pair(rng.standard_normal((1, 2, 600, 32), dtype=np.float32), "float32")
    vj, vt = _pair(rng.standard_normal((1, 2, 600, 32), dtype=np.float32), "float32")
    out = jax_dec_ops.decode_attention(qj, kj, vj, jnp.int32(77))
    assert _err(out, dec_ops.decode_attention(qt, kt, vt, 77)) < 2e-5


# ------------------------------------- the kernels' addressing, replayed on the CPU
def _gather(t: torch.Tensor, shape, strides) -> torch.Tensor:
    """What a kernel reads from `t`'s storage at base + sum(i * stride), unit stride last."""
    return torch.as_strided(t, shape, (*strides, 1), t.storage_offset())


def _replay_flash(q, k, v, out, args):
    """The flash kernel's arithmetic, reading and writing only through `launch_args`."""
    B, Hq, Hkv, S, dh, *rest = args
    st, window, scale = rest[:12], rest[12], rest[13]
    qs = _gather(q, (B, Hq, S, dh), st[0:3])
    ks, vs = _gather(k, (B, Hkv, S, dh), st[3:6]), _gather(v, (B, Hkv, S, dh), st[6:9])
    G = Hq // Hkv
    kh, vh = ks[:, torch.arange(Hq) // G], vs[:, torch.arange(Hq) // G]
    s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), kh.float()) * scale
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    ok = (j <= i) & ((j > i - window) if window > 0 else True)
    p = torch.softmax(torch.where(ok, s, torch.tensor(-1e30)), -1)
    _gather(out, (B, Hq, S, dh), st[9:12]).copy_(torch.einsum("bhqk,bhkd->bhqd", p, vh.float()))


@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_launch_args_model_layout(window):
    """Model-layout q/k/v/out views go to the kernel as strides, never as copies."""
    rng = np.random.default_rng(8)
    B, S, Hkv, G, dh = 2, 70, 2, 3, 32
    q = torch.from_numpy(rng.standard_normal((B, S, Hkv, G, dh), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32))
    out = torch.zeros_like(q)
    views = (q.view(B, S, Hkv * G, dh).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             out.view(B, S, Hkv * G, dh).transpose(1, 2))
    args = fa_kernel.launch_args(*views, scale=None, window=window)
    assert args[:5] == (B, Hkv * G, Hkv, S, dh) and args[-2] == (window or 0)
    assert all(a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
               for a, b in zip(views, (q, k, v, out)))
    _replay_flash(*views, args)
    np.testing.assert_allclose(out.numpy(), fa_ops.flash_attention(q, k, v, window=window).numpy(),
                               atol=2e-5)


def test_flash_attention_launch_args_reject():
    z = torch.zeros
    with pytest.raises(ValueError):  # head_dim the kernel has no instance for
        fa_kernel.launch_args(z(1, 2, 8, 48), z(1, 1, 8, 48), z(1, 1, 8, 48), z(1, 2, 8, 48),
                              scale=None, window=None)
    with pytest.raises(ValueError):  # Hq not a multiple of Hkv
        fa_kernel.launch_args(z(1, 3, 8, 32), z(1, 2, 8, 32), z(1, 2, 8, 32), z(1, 3, 8, 32),
                              scale=None, window=None)
    with pytest.raises(ValueError):  # head_dim not unit-stride
        q = z(1, 2, 32, 8).transpose(2, 3)
        fa_kernel.launch_args(q, z(1, 1, 8, 32), z(1, 1, 8, 32), z(1, 2, 8, 32), scale=None,
                              window=None)


@pytest.mark.parametrize("nv,sms", [(1, 132), (37, 132), (300, 132), (300, 4), (1100, 132)])
def test_decode_attention_launch_args_cache_layout(nv, sms):
    """The (B, T, Hkv, dh) cache reaches the kernel as strides, split into chunks whose
    partial softmaxes combine to the whole; slots >= n_valid are never read."""
    rng = np.random.default_rng(9)
    B, T, Hkv, G, dh = 2, 1100, 2, 5, 32
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, dh), dtype=np.float32))
    kc = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh), dtype=np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh), dtype=np.float32))
    args = dec_kernel.launch_args(q, kc.transpose(1, 2), vc.transpose(1, 2), nv, scale=None,
                                  sms=sms)
    assert args[:5] == (B, Hkv, G, T, dh) and args[11] == nv
    chunk, n_split, scale = args[12:15]
    assert chunk % dec_kernel.TILE == 0 and (n_split - 1) * chunk < nv <= n_split * chunk
    ks = _gather(kc, (B, Hkv, nv, dh), args[5:8])
    vs = _gather(vc, (B, Hkv, nv, dh), args[8:11])
    parts = []  # pass 1: (m, l, acc) of each chunk
    for c in range(n_split):
        s = torch.einsum("bhgd,bhkd->bhgk", q, ks[:, :, c * chunk:(c + 1) * chunk]) * scale
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(-1, keepdim=True), p @ vs[:, :, c * chunk:(c + 1) * chunk]))
    M = torch.stack([m for m, _, _ in parts]).amax(0)  # pass 2
    acc = sum(torch.exp(m - M) * a for m, _, a in parts)
    den = sum(torch.exp(m - M) * l_ for m, l_, _ in parts)
    ref = dec_ops.decode_attention_cache(q.view(B, 1, Hkv, G, dh), kc, vc, nv)[:, 0]
    np.testing.assert_allclose((acc / den).numpy(), ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("heads", [1, 4, 32, 64, 300])
def test_decode_split_covers_the_valid_slots(heads):
    for nv in list(range(1, 300)) + [1000, 1100, 2048, 32768]:
        chunk, n_split = dec_kernel.split_slots(nv, heads, 132)
        assert chunk % dec_kernel.TILE == 0 and (n_split - 1) * chunk < nv <= n_split * chunk
        assert heads * n_split <= max(heads, 2 * 132 + heads)  # no more blocks than needed


def test_decode_attention_launch_args_reject():
    q, kv = torch.zeros(1, 2, 5, 32), torch.zeros(1, 2, 16, 32)
    with pytest.raises(TypeError):  # n_valid read from a device tensor would sync
        dec_kernel.launch_args(q, kv, kv, torch.tensor(3), scale=None)
    with pytest.raises(ValueError):
        dec_kernel.launch_args(q, kv, kv, 17, scale=None)
    with pytest.raises(ValueError):
        dec_kernel.launch_args(q, kv, kv, 0, scale=None)
    with pytest.raises(ValueError):  # more query heads per kv head than the kernel holds
        dec_kernel.launch_args(torch.zeros(1, 2, 17, 32), kv, kv, 3, scale=None)
