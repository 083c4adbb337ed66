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
from repro_torch.kernels.rmsnorm import rmsnorm as rms_kernel
from torch_replay import gather, tma_box
from torch_threads import one_thread  # noqa: F401

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
    (1, 32, 8, 300, 80, None),  # h2o-danube's heads at dh 80
    (2, 4, 2, 384, 80, 128),  # dh 80 + sliding window
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
    (4, 8, 4, 600, 80, 1),  # h2o-danube's heads at dh 80
    (4, 8, 4, 600, 80, 600),
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


@pytest.mark.slow
@pytest.mark.parametrize("B,Hq,Hkv,S,dh,win", [(1, 32, 8, 300, 80, None), (2, 4, 2, 384, 80, 128)])
def test_flash_attention_dh80_vs_pallas_interpret(B, Hq, Hkv, S, dh, win):
    """The TPU kernel takes any dh (its blocks span the head): at h2o-danube's
    80 it agrees with the port's plain version, which CPU tensors take."""
    rng = np.random.default_rng(12)
    qj, qt = _pair(rng.standard_normal((B, Hq, S, dh), dtype=np.float32), "float32")
    kj, kt = _pair(rng.standard_normal((B, Hkv, S, dh), dtype=np.float32), "float32")
    vj, vt = _pair(rng.standard_normal((B, Hkv, S, dh), dtype=np.float32), "float32")
    out = jax_fa_ops.flash_attention_bhsd(qj, kj, vj, window=win)
    assert _err(out, fa_ops.flash_attention_bhsd(qt, kt, vt, window=win)) < 2e-5


@pytest.mark.slow
@pytest.mark.parametrize("nv", [1, 600])
def test_decode_attention_dh80_vs_pallas_interpret(nv):
    rng = np.random.default_rng(13)
    qj, qt = _pair(rng.standard_normal((4, 8, 4, 80), dtype=np.float32), "float32")
    kj, kt = _pair(rng.standard_normal((4, 8, 600, 80), dtype=np.float32), "float32")
    vj, vt = _pair(rng.standard_normal((4, 8, 600, 80), dtype=np.float32), "float32")
    out = jax_dec_ops.decode_attention(qj, kj, vj, jnp.int32(nv))
    assert _err(out, dec_ops.decode_attention(qt, kt, vt, nv)) < 2e-5


# ------------------------------------- the kernels' addressing, replayed on the CPU
def _replay_flash(q, k, v, out, args):
    """The flash kernel's arithmetic, reading and writing only through `launch_args`.

    Off the tensor-core path (no boxes) the kernel reads elements through the
    strides. On it, every load is a TMA box of the 4-D (dh, heads, S, B) map
    built from the strides: Q in `box_q`-row blocks, K and V in `box_k`-key
    tiles walked per 64-row warpgroup from the window's first live tile to the
    diagonal, with the key < S mask explicit. The Q boxes must rebuild q and
    the K/V boxes k and v, with zeros past S."""
    B, Hq, Hkv, S, dh, *rest = args
    st, (box_d, box_q, box_k), window, scale = rest[:12], rest[12:15], rest[15], rest[16]
    G = Hq // Hkv
    if box_d == 0:
        qs = gather(q, (B, Hq, S, dh), st[0:3])
        ks, vs = gather(k, (B, Hkv, S, dh), st[3:6]), gather(v, (B, Hkv, S, dh), st[6:9])
        kh, vh = ks[:, torch.arange(Hq) // G], vs[:, torch.arange(Hq) // G]
        s = torch.einsum("bhqd,bhkd->bhqk", qs.float(), kh.float()) * scale
        i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
        ok = (j <= i) & ((j > i - window) if window > 0 else True)
        p = torch.softmax(torch.where(ok, s, torch.tensor(-1e30)), -1)
        gather(out, (B, Hq, S, dh), st[9:12]).copy_(torch.einsum("bhqk,bhkd->bhqd", p, vh.float()))
        return

    def tile(t, heads, strides, rows, pos):  # (B, heads, rows, dh) from ceil(dh / box_d) boxes
        dims, byte_strides = (dh, heads, S, B), [x * t.element_size() for x in (strides[1], strides[2], strides[0])]
        boxes = [tma_box(t, dims, byte_strides, (box_d, heads, rows, B), (c, 0, pos, 0))
                 for c in range(0, dh, box_d)]
        whole = torch.cat(boxes, -1).transpose(1, 2)
        assert not whole[..., dh:].any()  # dh 80: the padded columns arrive as zeros
        return whole[..., :dh]

    n_qb, n_kb = -(-S // box_q), -(-S // box_k)
    q_all = torch.cat([tile(q, Hq, st[0:3], box_q, qb * box_q) for qb in range(n_qb)], 2)
    k_all = torch.cat([tile(k, Hkv, st[3:6], box_k, kb * box_k) for kb in range(n_kb)], 2)
    v_all = torch.cat([tile(v, Hkv, st[6:9], box_k, kb * box_k) for kb in range(n_kb)], 2)
    for whole, t, heads, sts in ((q_all, q, Hq, st[0:3]), (k_all, k, Hkv, st[3:6]), (v_all, v, Hkv, st[6:9])):
        assert torch.equal(whole[:, :, :S], gather(t, (B, heads, S, dh), sts))
        assert not whole[:, :, S:].any()  # zero fill past S
    k_all, v_all = k_all[:, torch.arange(Hq) // G], v_all[:, torch.arange(Hq) // G]
    o = gather(out, (B, Hq, S, dh), st[9:12])
    wg_rows = 64
    for qb in range(n_qb):
        q0 = qb * box_q
        kb_lo = max(0, q0 - window + 1) // box_k if window > 0 else 0
        kb_hi = -(-min(S, q0 + box_q) // box_k)
        for w0 in range(q0, q0 + box_q, wg_rows):  # one warpgroup's rows
            if w0 >= S:
                continue
            w_lo = max(0, w0 - window + 1) // box_k if window > 0 else 0
            w_hi = -(-min(S, w0 + wg_rows) // box_k)
            qt = q_all[:, :, w0:w0 + wg_rows].float()
            rows = torch.arange(w0, w0 + wg_rows)[:, None]
            m = torch.full((B, Hq, wg_rows, 1), -1e30)
            l, acc = torch.zeros_like(m), torch.zeros(B, Hq, wg_rows, dh)
            for kb in range(max(kb_lo, w_lo), min(kb_hi, w_hi)):
                keys = torch.arange(kb * box_k, (kb + 1) * box_k)[None, :]
                kt, vt = k_all[:, :, keys[0]].float(), v_all[:, :, keys[0]]
                ok = (keys <= rows) & (keys < S) & ((keys > rows - window) if window > 0 else True)
                s = torch.where(ok, torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale, torch.tensor(-1e30))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p, corr = torch.exp(s - m_new), torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(vt.dtype).float() @ vt.float()
                m = m_new
            n = min(S, w0 + wg_rows) - w0
            o[:, :, w0:w0 + n] = (acc / l.clamp_min(1e-30))[:, :, :n].to(o.dtype)


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


@pytest.mark.parametrize("S", [70, 300, 1100])
@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("G", [3, 5])
def test_flash_attention_tma_boxes_model_layout(S, window, G):
    """bf16 at dh 64 takes the TMA path: the boxes that `launch_args` plans over
    the model-layout views rebuild q, k, v, and the tile walk rebuilds out."""
    rng = np.random.default_rng(10)
    B, Hkv, dh = 2, 1, 64
    q = torch.from_numpy(rng.standard_normal((B, S, Hkv, G, dh), dtype=np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)).bfloat16()
    out = torch.zeros_like(q)
    views = (q.view(B, S, Hkv * G, dh).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             out.view(B, S, Hkv * G, dh).transpose(1, 2))
    args = fa_kernel.launch_args(*views, scale=None, window=window)
    assert args[17:20] == (fa_kernel.BOX_D, fa_kernel.BLOCK_Q, fa_kernel.BLOCK_K)
    _replay_flash(*views, args)
    ref = fa_ops.flash_attention(q, k, v, window=window)
    assert (ref.float() - out.float()).abs().max().item() < TOL["bfloat16"]


@pytest.mark.parametrize("S,window", [(300, None), (4608 // 16, 96)])
def test_flash_attention_tma_boxes_dh80(S, window):
    """bf16 at dh 80 takes the TMA path in tiles of two 64-column boxes: the
    second box reads columns 64-79 and zero-fills the rest, and the tile walk
    over those padded tiles rebuilds the attention."""
    rng = np.random.default_rng(14)
    B, Hkv, G, dh = 1, 2, 4, 80
    q = torch.from_numpy(rng.standard_normal((B, S, Hkv, G, dh), dtype=np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((B, S, Hkv, dh), dtype=np.float32)).bfloat16()
    out = torch.zeros_like(q)
    views = (q.view(B, S, Hkv * G, dh).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             out.view(B, S, Hkv * G, dh).transpose(1, 2))
    args = fa_kernel.launch_args(*views, scale=None, window=window)
    assert args[17:20] == (64, 128, 64) and args[-1] == 80**-0.5
    _replay_flash(*views, args)
    ref = fa_ops.flash_attention(q, k, v, window=window)
    assert (ref.float() - out.float()).abs().max().item() < TOL["bfloat16"]


def test_flash_attention_launch_args_reject_misaligned():
    """TMA needs 16-byte aligned bases and outer strides; the fp32-tile path does not."""
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt)  # noqa: E731
    ok = (z(1, 2, 8, 64), z(1, 1, 8, 64), z(1, 1, 8, 64), z(1, 2, 8, 64))
    assert fa_kernel.launch_args(*ok, scale=None, window=None)[17:20] == (64, 128, 64)
    shifted = z(2 * 8 * 64 + 1)[1:].view(1, 2, 8, 64)  # base 2 bytes past a boundary
    padded = z(1, 1, 8, 68)[..., :64]  # rows 136 bytes apart
    for i, bad in ((0, shifted), (1, padded), (3, shifted)):
        views = list(ok)
        views[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            fa_kernel.launch_args(*views, scale=None, window=None)
    f32 = [t.float() for t in ok]
    f32[1] = z(1, 1, 8, 65, dt=torch.float32)[..., :64]  # 260-byte rows: fine without TMA
    assert fa_kernel.launch_args(*f32, scale=None, window=None)[17:20] == (0, 0, 0)


@pytest.mark.parametrize("kernel", [fa_kernel, dec_kernel], ids=["flash", "decode"])
def test_on_tensor_cores_routes_bf16_head_dims(kernel):
    """bf16 at dh 64, 80 and 128 takes the tensor-core kernel; dh 32 and fp32 do not."""
    for dh in (64, 80, 128):
        assert kernel.on_tensor_cores(torch.bfloat16, dh)
        assert not kernel.on_tensor_cores(torch.float32, dh)
    assert not kernel.on_tensor_cores(torch.bfloat16, 32)


@pytest.mark.parametrize("d", [5120, 1024, 512, 256, 128, 100])
@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("rows", [1, 7, 33, 300])
def test_rmsnorm_launch_plan_covers_each_element_once(d, elem_size, rows):
    """Replay `csrc/rmsnorm.cu`'s indexing from the plan: every element of every
    row is loaded by exactly one thread, in loads that stay inside the row."""
    for aligned in (True, False):
        plan = rms_kernel.launch_plan(rows, d, elem_size, aligned)
        vec, lanes, rpb, vpt, blocks = plan
        assert vec == (16 // elem_size if aligned and d % (16 // elem_size) == 0 else 1)
        assert lanes * rpb <= 1024 and (lanes * rpb) % 32 == 0 and vpt in (1, 2, 4, 8)
        assert (lanes <= 32 and lanes & (lanes - 1) == 0) or rpb == 1
        assert (blocks - 1) * rpb < rows <= blocks * rpb
        tid = np.arange(lanes * rpb)
        row = np.arange(blocks)[:, None] * rpb + tid[None, :] // lanes  # (block, thread)
        load = (tid % lanes)[None, :, None] + np.arange(vpt)[None, None, :] * lanes
        live = (row[:, :, None] < rows) & (load < d // vec)
        shape = (blocks, lanes * rpb, vpt, vec)  # (block, thread, j, e)
        elem = np.broadcast_to(load[..., None] * vec + np.arange(vec), shape)
        count = np.zeros((rows, d), np.int64)
        r = np.broadcast_to(row[:, :, None, None], shape)
        sel = np.broadcast_to(live[..., None], shape)
        np.add.at(count, (r[sel], elem[sel]), 1)
        assert (count == 1).all()


def test_rmsnorm_launch_plan_rejects_rows_too_wide():
    assert rms_kernel.launch_plan(1, 8 * 8 * 1024, 2, True).vecs_per_thread == 8
    with pytest.raises(ValueError, match="wider"):
        rms_kernel.launch_plan(1, 8 * 8 * 1024 + 8, 2, True)


LOG2E = 1.4426950408889634


def _replay_decode(q, k, v, args):
    """The decode kernel's arithmetic, reading only through `launch_args` and its plan.

    On the tensor-core path every K/V tile is a TMA box of the 4-D (dh, Hkv,
    slots, B) map whose slot extent is the plan's (n_valid): the boxes must
    rebuild k and v below it and hold zeros past it. Off it, the kernel reads
    the valid slots through the strides. Each CTA of a cluster runs the online
    softmax over its tiles (the tensor-core kernel in log2 units, p rounded to
    v's dtype), then the cluster combine: rescale each CTA's (m, l, acc) to the
    common max and divide, each rank writing its slice of the dh columns."""
    B, Hkv, G, T, dh, *rest = args
    kst, vst = rest[0:3], rest[3:6]
    nv, n_split, tiles_per_cta, stages, smem, box_d, box_slots, extent, scale = rest[6:15]
    plan = dec_kernel.LaunchPlan(n_split, tiles_per_cta, stages, smem, (box_d, box_slots), extent,
                                 (n_split, Hkv, B))
    n_tiles = -(-nv // dec_kernel.TILE)
    assert extent == nv and (box_d, box_slots) in ((0, 0), (dec_kernel.BOX_D, dec_kernel.TILE))
    padded = (B, Hkv, n_tiles * dec_kernel.TILE, dh)
    if box_d:
        def tiles_of(t, st):  # (B, Hkv, n_tiles * TILE, dh) from ceil(dh / box_d) boxes a tile
            dims, bs = (dh, Hkv, extent, B), [x * t.element_size() for x in (st[1], st[2], st[0])]
            whole = torch.cat([torch.cat([tma_box(t, dims, bs, (box_d, Hkv, box_slots, B), (c, 0, j * box_slots, 0))
                                          for c in range(0, dh, box_d)], -1)
                               for j in range(n_tiles)], 1).transpose(1, 2)
            assert whole.shape[-1] == dec_kernel.tile_cols(dh) and (whole[..., dh:] == 0).all()
            return whole[..., :dh]  # dh 80: the padded columns arrive as zeros
        K, V = tiles_of(k, kst), tiles_of(v, vst)
        for whole, t, st in ((K, k, kst), (V, v, vst)):
            assert torch.equal(whole[:, :, :nv], gather(t, (B, Hkv, nv, dh), st))
            assert (whole[:, :, nv:] == 0).all()  # zero fill past n_valid, whatever the cache holds
    else:
        K, V = torch.zeros(padded, dtype=k.dtype), torch.zeros(padded, dtype=v.dtype)
        K[:, :, :nv], V[:, :, :nv] = gather(k, (B, Hkv, nv, dh), kst), gather(v, (B, Hkv, nv, dh), vst)
    exp = torch.exp2 if box_d else torch.exp
    parts = []
    for t0, n_t in dec_kernel.cta_tiles(plan, nv):
        m = torch.full((B, Hkv, G, 1), -1e30)
        l, acc = torch.zeros_like(m), torch.zeros(B, Hkv, G, dh)
        for j in range(t0, t0 + n_t):
            slots = torch.arange(j * dec_kernel.TILE, (j + 1) * dec_kernel.TILE)
            s = torch.einsum("bhgd,bhkd->bhgk", q.float(), K[:, :, slots].float())
            s = torch.where(slots < nv, s * scale * (LOG2E if box_d else 1.0), torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p, corr = exp(s - m_new), exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p.to(V.dtype).float() @ V[:, :, slots].float()
            m = m_new
        parts.append((m if box_d else m * LOG2E, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp2(m - M) for m, _, _ in parts]
    inv = 1 / sum(w_ * l_ for w_, (_, l_, _) in zip(w, parts)).clamp_min(1e-30)
    out = torch.zeros(B, Hkv, G, dh)
    cols = dec_kernel.slice_cols(dh, n_split)
    assert cols % 4 == 0 and dh <= n_split * cols < dh + 4 * n_split
    for rank in range(n_split):  # each CTA writes its slice of the columns (maybe none)
        c = slice(min(dh, rank * cols), min(dh, (rank + 1) * cols))
        out[..., c] = sum(w_ * a[..., c] for w_, (_, _, a) in zip(w, parts)) * inv
    return out.to(q.dtype)


@pytest.mark.parametrize("nv,sms", [(1, 132), (37, 132), (300, 132), (300, 4), (1100, 132)])
def test_decode_attention_launch_args_cache_layout(nv, sms):
    """The (B, T, Hkv, dh) cache reaches the kernel as strides; the CTAs of a cluster
    split the valid tiles and their partial softmaxes combine to the whole (fp32)."""
    rng = np.random.default_rng(9)
    B, T, Hkv, G, dh = 2, 1100, 2, 5, 32
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, dh), dtype=np.float32))
    kc = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh), dtype=np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh), dtype=np.float32))
    kc[:, nv:], vc[:, nv:] = float("nan"), float("nan")  # stale slots are never read
    args = dec_kernel.launch_args(q, kc.transpose(1, 2), vc.transpose(1, 2), nv, scale=None,
                                  sms=sms)
    assert args[:5] == (B, Hkv, G, T, dh) and args[11] == nv
    assert args[14] == 0 and args[16:19] == (0, 0, nv)  # fp32: no ring, no TMA boxes
    out = _replay_decode(q, kc.transpose(1, 2), vc.transpose(1, 2), args)
    ref = dec_ops.decode_attention_cache(q.view(B, 1, Hkv, G, dh), kc.nan_to_num(0.0),
                                         vc.nan_to_num(0.0), nv)[:, 0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


def _check_plan(plan, nv, B, Hkv, G, dh, tensor_cores):
    """Every valid slot is read by exactly one CTA of its cluster, no CTA is
    empty, tile counts differ by at most one, and the plan fits the card."""
    assert 1 <= plan.n_split <= dec_kernel.MAX_CLUSTER and plan.grid == (plan.n_split, Hkv, B)
    shares = dec_kernel.cta_tiles(plan, nv)
    counts = [n for _, n in shares]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    cover = np.zeros(-(-nv // dec_kernel.TILE) * dec_kernel.TILE, np.int64)
    for t0, n_t in shares:
        cover[t0 * dec_kernel.TILE:(t0 + n_t) * dec_kernel.TILE] += 1
        assert t0 * dec_kernel.TILE < nv  # every CTA's first tile holds a valid slot
    assert (cover == 1).all() and len(cover) - nv < dec_kernel.TILE
    assert plan.slot_extent == nv  # boxes reach no slot at or past n_valid
    assert plan.smem <= 232448  # the shared memory one CTA may use on Hopper (227 KB)
    # the receive area holds what every rank pushes: acc [n][G][ceil(dh / n)], m and l [8][16]
    recv = dec_kernel.recv_floats(dh)
    assert plan.n_split * G * dec_kernel.slice_cols(dh, plan.n_split) + 2 * 8 * 16 <= recv
    if tensor_cores:
        stage = 2 * dec_kernel.TILE * dec_kernel.tile_cols(dh) * 2  # dh 80: stages of 128 columns
        assert plan.box == (dec_kernel.BOX_D, dec_kernel.TILE) and 1 <= plan.stages <= max(counts)
        assert plan.stages * stage <= dec_kernel.RING_BYTES
        assert plan.stages == min(max(counts), dec_kernel.RING_BYTES // stage)
        assert 2 * (plan.smem + 1024) <= 228 * 1024  # two CTAs an SM, with the 1 KB each reserves
        assert plan.smem == plan.stages * stage + 4 * recv + 8 * plan.stages + 1024
    else:
        assert plan.box == (0, 0) and plan.stages == 0


@pytest.mark.parametrize("heads", [1, 4, 32, 64, 300])
def test_decode_split_covers_the_valid_slots(heads):
    for nv in list(range(1, 300)) + [1000, 1100, 2048, 32768]:
        for tc in (True, False):
            plan = dec_kernel.launch_plan(nv, 1, heads, 5, 128, tensor_cores=tc, sms=132)
            _check_plan(plan, nv, 1, heads, 5, 128, tc)
            # no other split has fewer tiles on its critical path (longest CTA x waves)
            fits, tiles = dec_kernel.resident_estimate(132), -(-nv // dec_kernel.TILE)

            def path(n):
                per = -(-tiles // n)
                return per * -(-heads // fits(n, dec_kernel.cta_smem(per, 5, 128, tc)[1]))

            costs = [path(n) for n in range(1, min(8, tiles) + 1)]
            assert path(plan.n_split) == min(costs) and costs.index(min(costs)) + 1 == plan.n_split


def test_decode_launch_plan_counts_waves():
    """A split whose clusters do not all fit at once pays for a second wave: at
    the serving shape, 30 resident clusters of 8 (as an H100 reports for ~100 KB
    CTAs) make 8 CTAs of 3 tiles take two waves, so 6 CTAs of 3 tiles win."""
    resident = lambda n, smem: {8: 30, 7: 32, 6: 39}.get(n, 264 // n)  # noqa: E731
    plan = dec_kernel.launch_plan(1100, 4, 8, 5, 128, tensor_cores=True, resident=resident)
    assert plan.n_split == 6 and [n for _, n in dec_kernel.cta_tiles(plan, 1100)] == [3] * 6
    roomy = dec_kernel.launch_plan(1100, 4, 8, 5, 128, tensor_cores=True, resident=lambda n, smem: 64)
    assert roomy.n_split == 6  # 7 and 8 CTAs also have a 3-tile CTA: the smallest split wins


@pytest.mark.parametrize("nv", [1, 63, 64, 65, 300, 1100, 2048])
@pytest.mark.parametrize("dh", [64, 80, 128])
def test_decode_launch_plan_replay(nv, dh):
    """The plan over G 1..16 and B * Hkv 2..32, on both kernels."""
    for G in (1, 2, 5, 6, 16):
        for B, Hkv in ((1, 2), (2, 2), (2, 4), (4, 4), (4, 8)):
            for tc in (True, False):
                plan = dec_kernel.launch_plan(nv, B, Hkv, G, dh, tensor_cores=tc, sms=132)
                _check_plan(plan, nv, B, Hkv, G, dh, tc)


@pytest.mark.parametrize("G", [1, 4, 5, 12, 16])
def test_decode_launch_plan_dh80(G):
    """h2o-danube's dh 80 over every n_valid of its 4096-slot ring: stages of
    128 padded columns (32 KB), the ring within its budget and the CTA under
    the 232,448 B a block may use, on both kernels and at 4 x 8 heads."""
    for nv in range(1, 4097):
        for tc in (True, False):
            plan = dec_kernel.launch_plan(nv, 4, 8, G, 80, tensor_cores=tc, sms=132)
            _check_plan(plan, nv, 4, 8, G, 80, tc)
    assert dec_kernel.cta_smem(3, G, 80, True)[1] == 3 * 32768 + 4 * dec_kernel.recv_floats(80) + 24 + 1024


@pytest.mark.parametrize("nv", [1, 65, 1100, 4096])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_decode_attention_dh80_combine(nv, G):
    """At dh 80 (fp32-tile kernel) the CTAs' partials combine, each rank writing
    its slice of the 80 columns, to the plain version within 2e-5."""
    rng = np.random.default_rng(15)
    B, T, Hkv, dh = 1, 4096, 2, 80
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, dh), dtype=np.float32))
    kc = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh), dtype=np.float32))
    vc = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh), dtype=np.float32))
    args = dec_kernel.launch_args(q, kc.transpose(1, 2), vc.transpose(1, 2), nv, scale=None)
    assert args[4] == 80 and args[-1] == 80**-0.5 and args[14] == 0
    out = _replay_decode(q, kc.transpose(1, 2), vc.transpose(1, 2), args)
    ref = dec_ops.decode_attention_cache(q.view(B, 1, Hkv, G, dh), kc, vc, nv)[:, 0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)


def test_decode_launch_plan_serving_shape():
    """qwen3-14b's decode at 4 slots: 32 clusters of 6 CTAs (one wave at two an
    SM), 18 tiles as 3 each, and a 3-stage ring that holds them all."""
    plan = dec_kernel.launch_plan(1100, 4, 8, 5, 128, tensor_cores=True, sms=132)
    assert plan.grid == (6, 8, 4) and plan.tiles_per_cta == 3 and plan.stages == 3
    assert [n for _, n in dec_kernel.cta_tiles(plan, 1100)] == [3] * 6
    assert plan.smem == 3 * 32768 + 4 * dec_kernel.recv_floats(128) + 24 + 1024


@pytest.mark.parametrize("nv,T,G,dh", [(1, 600, 5, 64), (65, 600, 2, 128), (600, 600, 6, 64),
                                       (1100, 2048, 5, 128), (300, 2048, 16, 128), (1, 600, 16, 80),
                                       (65, 600, 1, 80), (4096, 4096, 4, 80)])
def test_decode_tma_boxes_model_layout(nv, T, G, dh):
    """bf16 at dh 64, 80 and 128 takes the TMA path: the boxes over the model-layout
    cache rebuild its valid rows with zeros past n_valid (a NaN tail is never
    read), and the cluster's combine rebuilds the attention."""
    rng = np.random.default_rng(11)
    B, Hkv = 2, 2
    q = torch.from_numpy(rng.standard_normal((B, Hkv, G, dh), dtype=np.float32)).bfloat16()
    kc = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh), dtype=np.float32)).bfloat16()
    vc = torch.from_numpy(rng.standard_normal((B, T, Hkv, dh), dtype=np.float32)).bfloat16()
    ref = dec_ops.decode_attention_cache(q.view(B, 1, Hkv, G, dh), kc, vc, nv)[:, 0]
    kc[:, nv:], vc[:, nv:] = float("nan"), float("nan")
    args = dec_kernel.launch_args(q, kc.transpose(1, 2), vc.transpose(1, 2), nv, scale=None)
    assert args[14] >= 1 and args[16:19] == (dec_kernel.BOX_D, dec_kernel.TILE, nv)  # a ring; extent n_valid
    out = _replay_decode(q, kc.transpose(1, 2), vc.transpose(1, 2), args)
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() < TOL["bfloat16"]


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


def test_decode_attention_launch_args_reject_misaligned():
    """TMA needs 16-byte aligned bases and outer strides; the fp32-tile path does not."""
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt)  # noqa: E731
    q, kv = z(1, 2, 5, 64), z(1, 2, 16, 64)
    assert dec_kernel.launch_args(q, kv, kv, 9, scale=None)[16:18] == (64, 64)
    shifted = z(2 * 16 * 64 + 1)[1:].view(1, 2, 16, 64)  # base 2 bytes past a boundary
    padded = z(1, 2, 16, 68)[..., :64]  # rows 136 bytes apart
    for bad in (shifted, padded):
        for k, v in ((bad, kv), (kv, bad)):
            with pytest.raises(ValueError, match="16-byte"):
                dec_kernel.launch_args(q, k, v, 9, scale=None)
    f32 = z(1, 2, 16, 65, dt=torch.float32)[..., :64]  # 260-byte rows: fine without TMA
    assert dec_kernel.launch_args(q.float(), f32, f32, 9, scale=None)[16:18] == (0, 0)
