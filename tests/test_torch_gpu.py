"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: they skip where there is no CUDA device (decided inside the
fixture, so every worker collects the same tests). This file imports no JAX,
so it runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the JAX package's kernel bars (`tests/test_kernels.py`):
2e-5 in float32 (sums taken in another order) and 3e-2 in bfloat16.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.decode_attention import flash_decode
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import flash_attention_bwd as fa_bwd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref, attention_ref,
                                                     flash_attention_bwd_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref, rmsnorm_residual_ref
from repro_torch.configs import get_config
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.params import init_params, layer_params
from repro_torch.models.transformer import Model

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
     (1, 2, 1, 300, 32, None), (1, 40, 8, 1000, 128, None), (1, 32, 8, 300, 80, None),
     (2, 4, 2, 384, 80, 128)],
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
                                              (2, 1000, 2, 4, 64, 128), (1, 4608, 8, 4, 80, 4096),
                                              (2, 1000, 2, 12, 128, None), (2, 1000, 32, 1, 64, None)])
def test_flash_attention_tensor_cores_serving_shapes(dev, B, S, Hkv, G, dh, win):
    """The bf16 tensor-core kernel at the serve path's shapes (qwen3-14b: 40 query
    heads over 8 kv heads, dh 128, S not a multiple of the tiles), at dh 64
    with a window, at h2o-danube's (dh 80 in padded tiles, a prompt past its
    4096-token window), starcoder2's G 12 and musicgen's G 1."""
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
     (1, 1, 1, 2048, 64, 2047), (2, 4, 6, 600, 128, 300), (4, 8, 4, 600, 80, 1),
     (4, 8, 4, 600, 80, 600), (4, 8, 4, 4096, 80, 4096), (1, 2, 5, 600, 80, 65),
     (4, 2, 12, 2048, 128, 1100), (4, 32, 1, 2048, 64, 1100), (4, 16, 1, 2048, 128, 1100)],
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hkv,G,T,dh,nv", [(4, 8, 5, 2048, 128, 1100), (4, 8, 4, 4096, 80, 4096),
                                             (1, 2, 4, 600, 32, 77), (4, 32, 1, 2048, 64, 1),
                                             (2, 1, 16, 2048, 128, 700)])
def test_decode_attention_lse_output(dev, dtype, B, Hkv, G, T, dh, nv):
    """With `lse` the same launch writes the log-sum-exp of the scaled scores beside
    an output equal bit for bit to the one without it; the LSE within 1e-4 of the
    plain float32 LSE (`SPLIT_NOTE`'s LSE_TOL in chip_smoke.py)."""
    rng = np.random.default_rng(3)
    q = _randn(rng, (B, Hkv, G, dh), dtype, dev)
    k, v = (_randn(rng, (B, T, Hkv, dh), dtype, dev).transpose(1, 2) for _ in range(2))
    n0 = build.LAUNCHES["decode_attention"]
    out, lse = flash_decode(q, k, v, nv, lse=True)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == n0 + 1
    assert lse.shape == (B, Hkv, G) and lse.dtype == torch.float32
    assert torch.equal(out, flash_decode(q, k, v, nv))
    _, lse32 = decode_attention_ref(q.float(), k.float(), v.float(), nv, lse=True)
    assert _err(lse, lse32) <= 1e-4


def _decode_case(dev, dtype, B, Hkv, G, T, dh, seed=12):
    rng = np.random.default_rng(seed)
    q = _randn(rng, (B, Hkv, G, dh), dtype, dev)
    kc, vc = _randn(rng, (B, T, Hkv, dh), dtype, dev), _randn(rng, (B, T, Hkv, dh), dtype, dev)
    return q, kc, vc


@pytest.mark.parametrize("dtype,dh,nv", [(torch.bfloat16, 128, 1100), (torch.bfloat16, 64, 65),
                                         (torch.bfloat16, 32, 77), (torch.float32, 128, 1100),
                                         (torch.bfloat16, 80, 1100), (torch.float32, 80, 77)])
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


@pytest.mark.parametrize("nv,G,dh", [(1100, 5, 128), (4096, 4, 80)])
def test_decode_attention_clusters_fit_one_wave(dev, nv, G, dh):
    """The serving plans' clusters (qwen3-14b's, and h2o-danube's on a full
    4096-slot ring at dh 80) are resident at once on an H100."""
    from repro_torch.kernels.decode_attention import decode_attention as dec

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dec.launch_plan(nv, 4, 8, G, dh, tensor_cores=True, sms=sms)
    assert dec.max_active_clusters(plan, dh) >= 1


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(4, 256, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x, torch.ones(256, device=dev))
    q = torch.zeros(1, 2, 4, 96, device=dev)  # head dims 48 and 96: no config, no instance
    with pytest.raises(ValueError):
        flash_decode(q, torch.zeros(1, 2, 8, 96, device=dev), torch.zeros(1, 2, 8, 96, device=dev), 3)
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bhsd(q.bfloat16(), q[:, :1].bfloat16(), q[:, :1].bfloat16())
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


def _moe_case(cf):
    """deepseek-moe-16b's MoE layer at `reduced()`, float32 on the CPU, with x."""
    cfg = get_config("deepseek_moe_16b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    p = layer_params(init_params(cfg, 0, torch.device("cpu")), 0)["moe"]
    x = 0.5 * torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(0))
    return cfg, p, x


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def test_moe_layer_on_cuda_matches_cpu(dev):
    """The MoE layer (plain PyTorch, no kernel of its own) on the card against the
    same call on the CPU, float32, at a capacity that drops tokens: the same
    routing, the same drops, y within the float32 bar."""
    cfg, p, x = _moe_case(0.5)
    with moe.routing_record() as rec:
        y, aux = moe.apply_moe(cfg, p, x)
        yc, auxc = moe.apply_moe(cfg, _to(p, dev), x.to(dev))
    assert float(aux["moe_drop_frac"]) > 0
    assert torch.equal(rec[0][0], rec[1][0].cpu())
    assert float(auxc["moe_drop_frac"]) == float(aux["moe_drop_frac"])
    assert _err(yc.cpu(), y) < TOL[torch.float32]
    for k in ("moe_lb_loss", "moe_z_loss"):
        assert abs(float(auxc[k]) - float(aux[k])) < 1e-5, k


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_layer_makes_no_host_sync(dev, dtype):
    """Under `set_sync_debug_mode("error")` any call that waits for the card
    raises: the layer, its dispatch and its aux make none."""
    cfg, p, x = _moe_case(0.5)
    p, x = _to(p, dev), x.to(dev, dtype)
    p = {k: v if k == "router" or isinstance(v, dict) else v.to(dtype) for k, v in p.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.apply_moe(cfg, p, x)
        y2, _ = moe.apply_moe(cfg, p, x, aux=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(y.float()).all() and torch.equal(y, y2)
    assert 0 < float(aux["moe_drop_frac"]) < 1


def _zamba2(dtype="float32", **over):
    """zamba2 at `reduced(**over)` with 2 groups, and its parameters on the CPU."""
    cfg = get_config("zamba2_1p2b").reduced(dtype=dtype, param_dtype=dtype, **over)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=2))
    return cfg, init_params(cfg, 0, torch.device("cpu"))


def _state_tol(ref):
    """The float32 bar for a recurrent state, whose entries sum many products: 2e-5
    relative to its largest entry where that passes one."""
    return TOL[torch.float32] * max(1.0, ref.abs().max().item())


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def test_mamba2_layer_on_cuda_matches_cpu(dev):
    """Mamba2 (plain PyTorch, no kernel in JAX either) on the card against the CPU,
    float32: the sequence path past a padded chunk (S 300), its states, and 3
    decode steps from them."""
    cfg, params = _zamba2()
    p = layer_params(params, 0)["mamba"]
    x = 0.5 * torch.randn(2, 303, cfg.d_model, generator=torch.Generator().manual_seed(0))
    y, st = mamba2.mamba2_seq(cfg, p, x[:, :300])
    yc, stc = mamba2.mamba2_seq(cfg, _to(p, dev), x[:, :300].to(dev))
    assert _err(yc.cpu(), y) < TOL[torch.float32]
    for k in ("ssd", "conv"):
        assert _err(stc[k].cpu(), st[k]) < _state_tol(st[k]), k
    for t in range(300, 303):
        d = mamba2.mamba2_decode(cfg, p, x[:, t:t + 1], st)
        dc = mamba2.mamba2_decode(cfg, _to(p, dev), x[:, t:t + 1].to(dev), stc)
        assert _err(dc.cpu(), d) < TOL[torch.float32]
    assert _err(stc["ssd"].cpu(), st["ssd"]) < _state_tol(st["ssd"])


def test_rwkv6_layer_on_cuda_matches_cpu(dev):
    """RWKV6's time mix and channel mix (plain PyTorch) on the card against the CPU,
    float32: the sequence path past a padded chunk (S 40), then 2 decode steps."""
    cfg = get_config("rwkv6_7b").reduced()
    p = layer_params(init_params(cfg, 0, torch.device("cpu")), 0)
    x = torch.randn(2, 42, cfg.d_model, generator=torch.Generator().manual_seed(1))
    for part, seq, dec in (("tm", rwkv6.time_mix_seq, rwkv6.time_mix_decode),
                           ("cm", rwkv6.channel_mix_seq, rwkv6.channel_mix_decode)):
        y, st = seq(cfg, p[part], x[:, :40])
        yc, stc = seq(cfg, _to(p[part], dev), x[:, :40].to(dev))
        assert _err(yc.cpu(), y) < TOL[torch.float32], part
        st, stc = _clone(st), _clone(stc)
        for t in (40, 41):
            d = dec(cfg, p[part], x[:, t:t + 1], st)
            dc = dec(cfg, _to(p[part], dev), x[:, t:t + 1].to(dev), stc)
            assert _err(dc.cpu(), d) < TOL[torch.float32], part
        for k in st:
            assert _err(stc[k].cpu(), st[k]) < _state_tol(st[k]), (part, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_decode_steps_make_no_host_sync(dev, dtype):
    """Under `set_sync_debug_mode("error")` any call that waits for the card
    raises: a whole zamba2 decode step (a segment and a tail: the Mamba2 layers,
    the shared block through the norm and attention kernels, the head) and a
    whole rwkv6 decode step make none."""
    zcfg, zp = _zamba2(dtype, num_layers=3)
    rcfg = get_config("rwkv6_7b").reduced(dtype=dtype, param_dtype=dtype)
    rp = init_params(rcfg, 0, torch.device("cpu"))
    toks = torch.randint(0, zcfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(0))
    for cfg, p in ((zcfg, zp), (rcfg, rp)):
        model, p, t = Model(cfg), _to(p, dev), toks.to(dev)
        _, cache = model.prefill(p, {"tokens": t[:, :20]}, 24)
        n0 = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(20, 23):
                logits, cache = model.decode_step(p, cache, t[:, i:i + 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(logits).all() and cache["pos"] == 23
        blocks = 2 if cfg.family == "hybrid" else 0  # zamba2's shared block at both applications
        assert build.LAUNCHES["decode_attention"] - n0["decode_attention"] == 3 * blocks


# The backward kernels' bars (BWD_BAR_NOTE in chip_smoke.py): float32 max abs error
# <= 1e-4 x the plain output's max |value| (sums in another order); bf16 relative
# error (norm of the difference over the plain output's norm) <= 1e-2: both
# compute in float32 and round once.
def _bwd_close(out, ref, dtype):
    if dtype == torch.float32:
        assert _err(out, ref) <= 1e-4 * ref.abs().max().item()
    else:
        assert ((out.float() - ref.float()).norm() / ref.float().norm()).item() <= 1e-2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "B,Hq,Hkv,S,dh,win",
    [(2, 4, 4, 256, 64, None), (1, 8, 2, 256, 128, None), (2, 4, 2, 384, 64, 128),
     (1, 2, 1, 300, 32, None), (1, 40, 8, 1000, 128, None), (1, 32, 8, 300, 80, None),
     (2, 4, 2, 384, 80, 128), (1, 8, 2, 1100, 80, 512), (1, 4, 1, 64, 128, 1),
     (2, 10, 2, 500, 80, 200), (1, 32, 32, 256, 64, None), (1, 32, 32, 200, 128, 64),
     (1, 8, 2, 700, 128, 256), (2, 16, 4, 1000, 64, None), (1, 4, 1, 130, 80, None)],
)
def test_flash_attention_bwd_kernel(dev, dtype, B, Hq, Hkv, S, dh, win):
    """The forward kernel's LSE and the backward kernel against their plain versions,
    in the model layout's strided views; bf16 at dh 64, 80 and 128 on the tensor
    cores at G 1, 4 and 5, with and without a window, at ragged S. A second call
    gives the same bits (no atomics)."""
    rng = np.random.default_rng(5)
    q5 = _randn(rng, (B, S, Hkv, Hq // Hkv, dh), dtype, dev)
    k4, v4 = _randn(rng, (B, S, Hkv, dh), dtype, dev), _randn(rng, (B, S, Hkv, dh), dtype, dev)
    q, k, v = q5.reshape(B, S, Hq, dh).transpose(1, 2), k4.transpose(1, 2), v4.transpose(1, 2)
    dout = _randn(rng, (B, Hq, S, dh), dtype, dev)
    n0 = dict(build.LAUNCHES)
    out, lse = fa_ops.flash_attention_lse_bhsd(q, k, v, window=win)
    _, lse_ref = attention_lse_ref(q, k, v, window=win)
    assert _err(lse, lse_ref) <= 1e-4 * lse_ref.abs().max().item()
    grads = fa_ops.flash_attention_bwd_bhsd(q, k, v, out, dout, lse, window=win)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention_bwd"] == n0["flash_attention_bwd"] + 1
    refs = flash_attention_bwd_ref(q, k, v, out, dout, lse, window=win)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        if win == 1 and name != "dv":
            # one key a query: P = 1, so dS = dP - delta = do.v - do.o is exactly
            # zero, and both versions return only the rounding of two float32 sums
            assert g.abs().max().item() <= 1e-4 and r.abs().max().item() <= 1e-4, name
        else:
            _bwd_close(g, r, dtype)
    again = fa_ops.flash_attention_bwd_bhsd(q, k, v, out, dout, lse, window=win)
    assert all(torch.equal(a, b) for a, b in zip(again, grads))


@pytest.mark.parametrize("dtype,dh,tc", [(torch.bfloat16, 64, True), (torch.bfloat16, 80, True),
                                         (torch.bfloat16, 128, True), (torch.bfloat16, 32, False),
                                         (torch.float32, 64, False), (torch.float32, 80, False)])
def test_flash_attention_bwd_runs_its_route_by_name(dev, dtype, dh, tc):
    """The profiler names the kernels a backward call runs: bf16 at dh 64, 80 and 128
    the tensor-core ones (`dkdv_tc_kernel<dh>`, `dq_tc_kernel<dh>`), float32 and
    bf16 at dh 32 the fp32-tile ones (`fabwd::dkdv_kernel`, `fabwd::dq_kernel`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(8)
    B, Hq, Hkv, S = 1, 8, 2, 200
    q, dout = _randn(rng, (B, Hq, S, dh), dtype, dev), _randn(rng, (B, Hq, S, dh), dtype, dev)
    k, v = _randn(rng, (B, Hkv, S, dh), dtype, dev), _randn(rng, (B, Hkv, S, dh), dtype, dev)
    out, lse = fa_ops.flash_attention_lse_bhsd(q, k, v)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):  # the profiler may miss the first kernels after it starts
            fa_ops.flash_attention_bwd_bhsd(q, k, v, out, dout, lse)
            torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if e.device_type != DeviceType.CPU}
    if not names:
        pytest.skip("the profiler recorded no device kernel")
    ran = lambda w: any(w in n for n in names)  # noqa: E731
    if tc:
        assert ran(f"dkdv_tc_kernel<{dh}>") and ran(f"dq_tc_kernel<{dh}>"), names
        assert not ran("dkdv_kernel<"), names
    else:
        assert ran("dkdv_kernel<") and ran("dq_kernel<") and not ran("_tc_kernel"), names


def test_flash_attention_bwd_rejects_misaligned_views(dev):
    """The tensor-core route refuses what TMA and its 16-byte stores cannot take."""
    rng = np.random.default_rng(9)
    ok = [_randn(rng, (1, h, 64, 64), torch.bfloat16, dev) for h in (2, 1, 1, 2, 2)]
    out, lse = fa_ops.flash_attention_lse_bhsd(*ok[:3])
    grads = [torch.empty_like(t) for t in ok[:3]]
    bad = torch.zeros(1, 2, 64, 68, device=dev, dtype=torch.bfloat16)[..., :64]  # 136-byte rows
    n0 = build.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError, match="16-byte"):
        fa_bwd.flash_attention_bwd(*ok[:3], out, bad, lse, *grads)
    with pytest.raises(ValueError, match="16-byte"):
        fa_bwd.flash_attention_bwd(*ok[:3], out, ok[4], lse, bad, *grads[1:])
    assert build.LAUNCHES["flash_attention_bwd"] == n0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T,D,eps,fused", [(256, 512, 1e-5, False), (300, 256, 1e-5, True),
                                           (1000, 2560, 1e-5, True), (4000, 128, 1e-6, False),
                                           (7, 5120, 1e-5, False), (33, 100, 1e-5, True),
                                           (12288, 2560, 1e-5, False), (3, 1024, 1e-5, True)])
def test_rmsnorm_bwd_kernel(dev, dtype, T, D, eps, fused):
    rng = np.random.default_rng(6)
    x, res, dy, dr = (_randn(rng, (T, D), dtype, dev) for _ in range(4))
    sc = 1 + 0.1 * _randn(rng, (D,), torch.float32, dev)
    args = (x, res if fused else None, sc, dy, dr if fused else None)
    n0 = build.LAUNCHES["rmsnorm_bwd"]
    dx, dscale = rms_ops.rmsnorm_backward(*args, eps=eps)
    torch.cuda.synchronize()
    assert build.LAUNCHES["rmsnorm_bwd"] == n0 + 1
    rdx, rdscale = rmsnorm_bwd_ref(*args, eps=eps)
    _bwd_close(dx, rdx, dtype)
    _bwd_close(dscale, rdscale, torch.float32)  # float32 whatever the rows' dtype
    again = rms_ops.rmsnorm_backward(*args, eps=eps)  # no atomics: the same bits
    assert torch.equal(again[0], dx) and torch.equal(again[1], dscale)


def test_wrappers_never_drop_a_gradient(dev):
    """On CUDA the norm and flash wrappers are autograd Functions over the kernels;
    the forward-only wrappers refuse inputs that require grad."""
    rng = np.random.default_rng(7)
    x, res, dy = (_randn(rng, (4, 6, 256), torch.float32, dev) for _ in range(3))
    sc = (1 + 0.1 * _randn(rng, (256,), torch.float32, dev)).requires_grad_()
    xs, rs = x.clone().requires_grad_(), res.clone().requires_grad_()
    y, r = rms_ops.rmsnorm_residual(xs, rs, sc)
    gx, gr, gs = torch.autograd.grad((y, r), (xs, rs, sc), (dy, dy))
    rdx, rds = rmsnorm_bwd_ref(x.view(-1, 256), res.view(-1, 256), sc.detach(), dy.view(-1, 256),
                               dy.view(-1, 256))
    assert _err(gx.view(-1, 256), rdx) < 1e-5 and torch.equal(gx, gr) and _err(gs, rds) < 1e-4
    gx, gs = torch.autograd.grad(rms_ops.rmsnorm(xs, sc), (xs, sc), dy)
    rdx, rds = rmsnorm_bwd_ref(x.view(-1, 256), None, sc.detach(), dy.view(-1, 256))
    assert _err(gx.view(-1, 256), rdx) < 1e-5 and _err(gs, rds) < 1e-4
    q = _randn(rng, (1, 96, 2, 3, 64), torch.float32, dev).requires_grad_()
    k, v = (_randn(rng, (1, 96, 2, 64), torch.float32, dev).requires_grad_() for _ in range(2))
    out = fa_ops.flash_attention(q, k, v, window=40)
    got = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    from repro_torch.models.flash_vjp import flash_attention_vjp
    want = torch.autograd.grad(flash_attention_vjp(q, k, v, 40, 32, kernels=False), (q, k, v),
                               torch.ones_like(out))
    for a, b in zip(got, want):
        assert _err(a, b) <= 1e-4 * b.abs().max().item()
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.flash_attention_bhsd(q.transpose(1, 2).reshape(1, 6, 96, 64), k.transpose(1, 2),
                                    v.transpose(1, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        dec_ops.decode_attention(q[:, :1].reshape(1, 2, 3, 64), k.transpose(1, 2),
                                 v.transpose(1, 2), 10)
    with torch.no_grad():  # serving: no grad, no refusal, no LSE
        fa_ops.flash_attention(q, k, v, window=40)


def test_train_step_on_cuda_matches_cpu(dev):
    """Two float32 AdamW steps of reduced danube through the flash VJP (S 64 past
    attn_chunk 16 and the window): the CUDA kernels against the CPU's plain twin."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train.trainer import Trainer

    cfg = get_config("h2o_danube_1p8b").reduced(attn_impl="chunked")
    data = SyntheticLM(cfg.vocab_size, 64, 2)
    hist = {}
    for d in (torch.device("cpu"), dev):
        tr = Trainer(Model(cfg), ParallelConfig(), TrainConfig(steps=4, warmup_steps=1), d)
        state = tr.init_state(params=_to(init_params(cfg, 0, torch.device("cpu"), widen_head=False), d))
        n0 = dict(build.LAUNCHES)
        _, hist[d.type] = tr.fit(state, data, steps=2, log=lambda *_: None)
        if d.type == "cuda":
            assert all(build.LAUNCHES[k] > n0[k] for k in ("flash_attention", "flash_attention_bwd",
                                                           "rmsnorm", "rmsnorm_residual", "rmsnorm_bwd"))
    for a, b in zip(hist["cuda"], hist["cpu"]):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), k


@pytest.mark.parametrize("arch,over", [("qwen3_14b", {}), ("h2o_danube_1p8b", {"attn_impl": "chunked"})])
def test_mesh_of_one_on_cuda_computes_the_single_device_step(dev, tmp_path, arch, over):
    """A (data 1, model 1) mesh of one NCCL process: the parameters DTensors and every
    kernel entered through `local_map` on its local shard (the whole tensor here),
    so the loss and every gradient equal one device's bit for bit, with as many
    launches of each kernel (qwen3's qk-norms; danube's flash VJP, S 64 past
    attn_chunk 16 and the window)."""
    import torch.distributed as dist

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.axes import make_rules, whole
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.train.trainer import Trainer
    from repro_torch.train.tree import paths

    cfg = get_config(arch).reduced(**over)
    batch = SyntheticLM(cfg.vocab_size, 64, 2).batch(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        runs = []
        for m in (None, mesh):
            tr = Trainer(Model(cfg), ParallelConfig(), TrainConfig(), dev, mesh=m,
                         rules=make_rules(dp=("data",), tp=("model",)))
            state = tr.init_state()
            n0 = dict(build.LAUNCHES)
            with tr._ctx():
                grads, met = loss_and_grads(tr.model, state["params"], tr._batch(batch), "selective")
            torch.cuda.synchronize()
            runs.append(({k: whole(v) for k, v in paths(grads)}, met,
                         {k: build.LAUNCHES[k] - n0[k] for k in n0}))
    finally:
        dist.destroy_process_group()
    (g0, m0, n0), (g1, m1, n1) = runs
    assert n0 == n1 and n1["rmsnorm"] > 0 and n1["rmsnorm_bwd"] > 0
    assert torch.equal(m0["loss"], m1["loss"])
    for k, v in g0.items():
        assert torch.equal(v, g1[k]), k
