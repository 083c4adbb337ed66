"""The Python around the two backward kernels, on the CPU, without a card.

The flash backward's routing (`on_tensor_cores`), its launch plan (grids and
TMA boxes) and `launch_args` over the model layout's strided views: the
tensor-core route's tile walks (dK/dV by key tile over the G query heads'
live query tiles, dQ by query tile over its live key tiles) are replayed
from the launch arguments, every load a TMA box, with P and dS rounded to
bf16 as the kernels round them, and must rebuild the plain version's dq, dk
and dv at BWD_BAR_NOTE's bf16 bar (chip_smoke.py): relative error 1e-2. The
RMSNorm backward's launch plan: every element of every row is loaded by one
thread, in loads that stay inside the row, and the blocks' partial dscale
sums add up to the plain version's. No JAX here: these run in seconds.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import flash_attention_bwd as fa_bwd
from repro_torch.kernels.flash_attention.ref import attention_lse_ref, flash_attention_bwd_ref
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as rms_bwd
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
from torch_replay import gather, tma_box

REL_TOL = 1e-2  # BWD_BAR_NOTE: the backward kernels' bf16 bar


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _model_layout(rng, B, S, Hkv, G, dh, dtype=torch.bfloat16):
    """q, k, v, out, dout, dq, dk, dv as the autograd Function hands them over:
    (B, H, S, dh) views of the model's (B, S, H, dh) tensors; and the LSE."""
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)

    heads = lambda t: t.reshape(B, S, -1, dh).transpose(1, 2)  # noqa: E731
    q5, do5 = randn(B, S, Hkv, G, dh), randn(B, S, Hkv, G, dh)
    k4, v4 = randn(B, S, Hkv, dh), randn(B, S, Hkv, dh)
    out, lse = attention_lse_ref(heads(q5), heads(k4), heads(v4))
    grads = torch.zeros_like(q5), torch.zeros_like(k4), torch.zeros_like(v4)
    return (heads(q5), heads(k4), heads(v4), out, heads(do5), *map(heads, grads)), lse


def _live(q, key, S, window):
    ok = (key <= q) & (q < S)
    return ok & (key > q - window) if window else ok


def _replay_bwd(q, k, v, out, dout, lse, dq, dk, dv, args):
    """The tensor-core route's arithmetic, reading only through `launch_args`:
    every q, k, v, dout tile a TMA box of the 4-D (dh, heads, S, B) map built
    from the strides (the boxes must rebuild the tensors, zeros past S and past
    dh), out and the outputs through their strides. delta = rowsum(dout * out),
    then the dK/dV walk and the dQ walk, P and dS rounded to bf16 before their
    products; dq, dk, dv are written where the kernels write them (rows < S)."""
    B, Hq, Hkv, S, dh, *rest = args
    st, boxes, window, scale = rest[:24], tuple(rest[24:27]), rest[27], rest[28]
    plan = fa_bwd.launch_plan(B, Hq, Hkv, S, dh, q.dtype)
    assert boxes == plan.boxes == (fa_kernel.BOX_D, fa_bwd.BLOCK, fa_bwd.BLOCK)
    box_d, T, G = boxes[0], boxes[1], Hq // Hkv
    n, dp = plan.dkdv_grid[0], -(-dh // box_d) * box_d
    assert plan.dkdv_grid == (n, Hkv, B) and plan.dq_grid == (n, Hq, B) and (n - 1) * T < S <= n * T

    def tiles(t, heads, strides):  # (B, heads, n T, dp) from the boxes of n tiles
        dims = (dh, heads, S, B)
        byte_strides = [x * t.element_size() for x in (strides[1], strides[2], strides[0])]
        whole = torch.cat([torch.cat([tma_box(t, dims, byte_strides, (box_d, heads, T, B), (c, 0, i * T, 0))
                                      for c in range(0, dp, box_d)], -1).transpose(1, 2)
                           for i in range(n)], 2)
        assert torch.equal(whole[:, :, :S, :dh], gather(t, (B, heads, S, dh), strides))
        assert not whole[:, :, S:].any() and not whole[..., dh:].any()  # zero fill
        return whole.float()

    Q, K, V, dO = (tiles(q, Hq, st[0:3]), tiles(k, Hkv, st[3:6]), tiles(v, Hkv, st[6:9]),
                   tiles(dout, Hq, st[12:15]))
    pad = lambda x: torch.nn.functional.pad(x, (0, n * T - S))  # noqa: E731  stats read as 0 past S
    delta = pad((gather(dout, (B, Hq, S, dh), st[12:15]).float()
                 * gather(out, (B, Hq, S, dh), st[9:12]).float()).sum(-1))
    L = pad(lse)
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    rows = lambda i: torch.arange(i * T, (i + 1) * T)  # noqa: E731

    dK, dV = torch.zeros(B, Hkv, n * T, dp), torch.zeros(B, Hkv, n * T, dp)
    for kt in range(n):  # dK/dV blocks (key tile, every kv head and batch at once)
        keys = rows(kt)
        q_end = min(S, kt * T + T - 1 + window) if window else S
        for g in range(G):
            h = torch.arange(Hkv) * G + g
            for qt in range(kt, -(-q_end // T)):
                qs = rows(qt)
                Qt, dOt = Q[:, h][:, :, qs], dO[:, h][:, :, qs]
                ok = _live(qs[None, :], keys[:, None], S, window)
                pT = torch.where(ok, torch.exp(K[:, :, keys] @ Qt.transpose(2, 3) * scale
                                               - L[:, h][:, :, None, qs]), torch.zeros(()))
                dsT = pT * (V[:, :, keys] @ dOt.transpose(2, 3) - delta[:, h][:, :, None, qs]) * scale
                dV[:, :, keys] += bf(pT) @ dOt
                dK[:, :, keys] += bf(dsT) @ Qt
    dQ = torch.zeros(B, Hq, n * T, dp)
    Kh, Vh = K[:, torch.arange(Hq) // G], V[:, torch.arange(Hq) // G]
    for qt in range(n):  # dQ blocks (query tile, every query head and batch at once)
        qs = rows(qt)
        kt_lo = max(0, qt * T - window + 1) // T if window else 0
        for kt in range(kt_lo, -(-min(S, qt * T + T) // T)):
            keys = rows(kt)
            ok = _live(qs[:, None], keys[None, :], S, window)
            p = torch.where(ok, torch.exp(Q[:, :, qs] @ Kh[:, :, keys].transpose(2, 3) * scale
                                          - L[:, :, qs, None]), torch.zeros(()))
            ds = p * (dO[:, :, qs] @ Vh[:, :, keys].transpose(2, 3) - delta[:, :, qs, None]) * scale
            dQ[:, :, qs] += bf(ds) @ Kh[:, :, keys]
    for t, acc, heads, strides in ((dq, dQ, Hq, st[15:18]), (dk, dK, Hkv, st[18:21]),
                                   (dv, dV, Hkv, st[21:24])):
        gather(t, (B, heads, S, dh), strides).copy_(acc[:, :, :S, :dh])


@pytest.mark.parametrize("B,S,Hkv,G,dh,window", [
    (2, 200, 2, 1, 64, None), (1, 300, 2, 4, 80, 96), (1, 130, 2, 5, 128, None),
    (1, 256, 1, 4, 64, 64), (2, 70, 1, 5, 80, None), (1, 300, 3, 1, 128, 100)])
def test_flash_bwd_tile_walks_rebuild_the_gradients(B, S, Hkv, G, dh, window):
    """bf16 at dh 64, 80 and 128, G 1, 4 and 5, ragged S, with and without a
    window: the model layout's views go to the kernels as strides (nothing
    copied), and the tensor-core route's walks rebuild dq, dk and dv."""
    views, lse = _model_layout(np.random.default_rng(11), B, S, Hkv, G, dh)
    args = fa_bwd.launch_args(*views, scale=None, window=window)
    assert args[:5] == (B, Hkv * G, Hkv, S, dh) and args[-2:] == (window or 0, dh**-0.5)
    _replay_bwd(*views[:5], lse, *views[5:], args)
    q, k, v, out, dout = views[:5]
    refs = flash_attention_bwd_ref(q, k, v, out, dout, lse, window=window)
    for name, got, ref in zip(("dq", "dk", "dv"), views[5:], refs):
        assert _rel(got, ref) <= REL_TOL, name


def test_flash_bwd_routes_bf16_head_dims_to_the_tensor_cores():
    """bf16 at dh 64, 80 and 128 plans TMA boxes of 64 columns by 64 rows; float32
    and bf16 at dh 32 plan none (the fp32-tile kernels). Both routes launch one
    dK/dV block a (key tile, kv head, batch) and one dQ block a (query tile,
    query head, batch)."""
    for dh in (64, 80, 128):
        assert fa_bwd.on_tensor_cores(torch.bfloat16, dh)
        assert not fa_bwd.on_tensor_cores(torch.float32, dh)
        assert fa_bwd.launch_plan(2, 32, 8, 6144, dh, torch.bfloat16) == ((64, 64, 64), (96, 8, 2), (96, 32, 2))
        assert fa_bwd.launch_plan(4, 40, 8, 1000, dh, torch.float32) == ((0, 0, 0), (16, 8, 4), (16, 40, 4))
    assert not fa_bwd.on_tensor_cores(torch.bfloat16, 32)
    assert fa_bwd.launch_plan(1, 4, 1, 65, 32, torch.bfloat16).boxes == (0, 0, 0)
    views, _ = _model_layout(np.random.default_rng(12), 1, 70, 2, 3, 32, torch.float32)
    assert fa_bwd.launch_args(*views, scale=None, window=None)[29:32] == (0, 0, 0)


def test_flash_bwd_launch_args_reject_misaligned():
    """The tensor-core route needs 16-byte aligned bases and outer strides of q,
    k, v, dout (TMA) and dq, dk, dv (16-byte stores); out is read by the delta
    kernel element by element and may be anything. float32 needs none of it."""
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt)  # noqa: E731
    ok = [z(1, 2, 8, 64), z(1, 1, 8, 64), z(1, 1, 8, 64), z(1, 2, 8, 64), z(1, 2, 8, 64),
          z(1, 2, 8, 64), z(1, 1, 8, 64), z(1, 1, 8, 64)]
    assert fa_bwd.launch_args(*ok, scale=None, window=None)[29:32] == (64, 64, 64)
    shifted = lambda heads: z(heads * 8 * 64 + 1)[1:].view(1, heads, 8, 64)  # noqa: E731  base 2 bytes off
    padded = lambda heads: z(1, heads, 8, 68)[..., :64]  # noqa: E731  rows 136 bytes apart
    for i, name in enumerate(fa_bwd.NAMES):
        heads = ok[i].shape[1]
        for bad in (shifted(heads), padded(heads)):
            views = list(ok)
            views[i] = bad
            if name == "out":
                assert fa_bwd.launch_args(*views, scale=None, window=None)[29:32] == (64, 64, 64)
                continue
            with pytest.raises(ValueError, match=f"{name} needs a 16-byte"):
                fa_bwd.launch_args(*views, scale=None, window=None)
    f32 = [t.float() for t in ok]
    f32[1] = z(1, 1, 8, 65, dt=torch.float32)[..., :64]  # 260-byte rows: fine without TMA
    assert fa_bwd.launch_args(*f32, scale=None, window=None)[29:32] == (0, 0, 0)
    with pytest.raises(ValueError, match="one dtype"):
        fa_bwd.launch_args(*ok[:7], ok[7].float(), scale=None, window=None)


@pytest.mark.parametrize("d", [5120, 2560, 1024, 256, 128, 100])
@pytest.mark.parametrize("elem_size", [2, 4])
@pytest.mark.parametrize("rows", [1, 7, 33, 300])
def test_rmsnorm_bwd_launch_plan_covers_each_element_once(d, elem_size, rows):
    """Replay `csrc/rmsnorm_bwd.cu`'s indexing from the plan: every element of
    every row is loaded by exactly one thread in one turn, in loads inside the
    row; blocks fit the kernel's limits and its shared memory."""
    for aligned, fused in ((True, False), (True, True), (False, False), (False, True)):
        plan = rms_bwd.launch_plan(rows, d, elem_size, aligned, fused, sms=4)
        vec, lanes, rpb, vpt, blocks = plan
        assert vec == (16 // elem_size if aligned and d % (16 // elem_size) == 0 else 1)
        threads = lanes * rpb
        assert threads <= rms_bwd.MAX_THREADS and threads % 32 == 0 and vpt in (1, 2, 4, 8, 16, 32)
        assert vec * vpt <= rms_bwd.max_elems(fused)  # what 128 registers a thread hold
        assert (lanes <= 32 and lanes & (lanes - 1) == 0) or lanes % 32 == 0
        assert rpb * d * 4 <= 48 * 1024 or rpb == 1  # the row groups' dscale sums
        assert 1 <= blocks <= 4 * max(1, rms_bwd.RESIDENT_THREADS // threads) and blocks <= -(-rows // rpb)
        turns = -(-rows // (blocks * rpb))
        tid = np.arange(threads)
        row = ((np.arange(turns)[:, None, None] * blocks + np.arange(blocks)[None, :, None]) * rpb
               + tid[None, None, :] // lanes)  # (turn, block, thread)
        load = (tid % lanes)[None, None, :, None] + np.arange(vpt) * lanes
        live = (row[..., None] < rows) & (load < d // vec)
        shape = (turns, blocks, threads, vpt, vec)
        elem = np.broadcast_to(load[..., None] * vec + np.arange(vec), shape)
        r = np.broadcast_to(row[..., None, None], shape)
        sel = np.broadcast_to(live[..., None], shape)
        count = np.zeros((rows, d), np.int64)
        np.add.at(count, (r[sel], elem[sel]), 1)
        assert (count == 1).all()


@pytest.mark.parametrize("rows,d,fused,plan", [
    (12288, 2560, False, (8, 160, 1, 2, 396)), (12288, 2560, True, (8, 160, 1, 2, 396)),
    (4096, 5120, False, (8, 160, 1, 4, 396)), (4096, 5120, True, (8, 320, 1, 2, 132)),
    (163840, 128, False, (8, 16, 16, 1, 264)), (33, 100, True, (1, 32, 8, 4, 5))])
def test_rmsnorm_bwd_launch_plan_training_shapes(rows, d, fused, plan):
    """bf16 rows of danube's training batch (d 2560) and of qwen3-14b (d 5120):
    16-byte loads, as few a thread as keep a row to 192 threads, fewer in the
    fused norm (which also holds res); qwen3's qk-norm rows (d 128): 16 lanes a
    row, 16 rows a block; d 100 takes the scalar route. On an H100 (132 SMs)
    the blocks fill the card once at 512 threads an SM."""
    assert rms_bwd.launch_plan(rows, d, 2, True, fused) == plan
    assert rms_bwd.launch_plan(rows, d, 2, False, fused).vec == 1


@pytest.mark.parametrize("rows,d,fused", [(300, 256, True), (33, 100, False), (700, 2560, False)])
def test_rmsnorm_bwd_partial_sums_add_up(rows, d, fused):
    """dscale as the kernels form it: each block's rows (turn k serves rows
    (k blocks + block) rows_per_block + group), summed per block, then the
    blocks' partial sums added in block order: the plain version's dscale."""
    rng = np.random.default_rng(13)
    x, res, dy = (torch.from_numpy(rng.standard_normal((rows, d), dtype=np.float32)) for _ in range(3))
    sc = 1 + 0.1 * torch.from_numpy(rng.standard_normal(d, dtype=np.float32))
    r = x + res if fused else x
    terms = dy * r * torch.rsqrt(r.square().mean(-1, keepdim=True) + 1e-5)
    plan = rms_bwd.launch_plan(rows, d, 4, True, fused, sms=2)
    row = np.arange(rows)
    block = (row // plan.rows_per_block) % plan.blocks
    partial = torch.stack([terms[torch.from_numpy(block == b)].sum(0) for b in range(plan.blocks)])
    _, want = rmsnorm_bwd_ref(x, res if fused else None, sc, dy)
    torch.testing.assert_close(partial.sum(0), want, rtol=1e-5, atol=1e-4)
