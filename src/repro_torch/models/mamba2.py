"""Mamba2 (SSD) block: the chunked sequence path and the one-token recurrent step.

Port of `repro.models.mamba2`, which has no Pallas kernel: plain PyTorch on
every path. The sequence is split into chunks of Q tokens (256); within a
chunk the recurrence is a masked (Q x Q) product, across chunks a Python
loop carries the float32 (B, H, N, P) state. d_inner = expand * d_model,
H = d_inner / head_dim heads, state size N, G groups: head h reads the B and
C of group h // (H / G), as `jnp.repeat` does (`repeat_interleave` here).

The dtypes follow JAX's: products in the compute dtype, the decay, dt and
chunk states in float32, the masked intra-chunk matrix cast to the compute
dtype before its product with x, the inter-chunk term cast back before the
sum. Padding to a chunk multiple adds steps with x = 0 and dt = 0 (decay 1),
which change nothing.

The decode-ready conv state is the last W - 1 rows of the zero-left-padded
pre-conv input, right for every S. JAX slices the unpadded input with the
padded length there (`mamba2.py:167`), which is wrong whenever S > Q and
S % Q != 0; the port does not copy that.

`mamba2_decode` updates the state dict it is given IN PLACE, as the
attention caches are, and makes no host synchronisation.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.axes import axes_size, is_dtensor, on_local, regrid, shard, write


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, H, conv_dim


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(..., d_in_proj) -> z, x, B, C, dt."""
    s = cfg.ssm
    d_inner, H, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, H], dim=-1)


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-5):
    """RMSNorm of y * silu(z): the product in the compute dtype, the norm in float32."""
    yf = (y * F.silu(z)).float()
    ms = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * scale).to(y.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with [i, j] = sum of a[j+1..i], -inf above the diagonal."""
    Q = a.shape[-1]
    cs = a.cumsum(-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def _heads_split(cfg: ModelConfig) -> str | None:
    """"tp" where the heads shard over tp on a mesh: a rank's heads must be whole
    groups, or all read the one group; None (replicated) elsewhere."""
    s = cfg.ssm
    tp = axes_size("tp")
    H = dims(cfg)[1]
    ok = tp > 1 and H % tp == 0 and (s.n_groups == 1 or s.n_groups % tp == 0)
    return "tp" if ok else None


def _conv(cfg: ModelConfig, zxbcdt: torch.Tensor, cw: torch.Tensor, cb: torch.Tensor):
    """The in-projection split and the depthwise causal conv over (x, B, C), a sum of W
    shifts in the compute dtype: (z, xh (B, S, H, P), B, C (B, S, G, N), dt raw
    (B, S, H), the decode-ready conv state (B, conv_dim, W - 1): the last W - 1
    rows of the zero-left-padded pre-conv input)."""
    s = cfg.ssm
    d_inner, H, _ = dims(cfg)
    G, N, P, W = s.n_groups, s.d_state, s.head_dim, s.conv_width
    B_, S, _ = zxbcdt.shape
    dt_c = zxbcdt.dtype
    z, xc, Bm, Cm, dtr = _split_proj(cfg, zxbcdt)
    conv_in = F.pad(torch.cat([xc, Bm, Cm], dim=-1), (0, 0, W - 1, 0))  # (B, S + W - 1, conv_dim)
    cw = cw.to(dt_c)
    conv = sum(conv_in[:, i:i + S] * cw[:, i] for i in range(W))
    xbc = F.silu(conv + cb.to(dt_c))
    conv_state = conv_in[:, S:].transpose(1, 2).contiguous()
    xh, Bm, Cm = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    return (z, xh.reshape(B_, S, H, P), Bm.reshape(B_, S, G, N), Cm.reshape(B_, S, G, N), dtr,
            conv_state)


def _ssd(chunk: int, xh, dtr, Bm, Cm, a_log, d_skip, dt_bias):
    """The chunked SSD over the heads given (a rank's own on a mesh): xh (B, S, H, P),
    dt raw (B, S, H), B and C (B, S, G, N) of those heads' groups, the heads' decay,
    skip and dt bias -> (y (B, S, H * P), final state (B, H, N, P) float32)."""
    B_, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, S)
    pad = (Q - S % Q) % Q
    dt_c = xh.dtype
    hpg = H // G
    dt = F.softplus(dtr.float() + dt_bias)  # (B, S, H)
    A = -torch.exp(a_log)  # (H,)
    if pad:  # x = 0 (no input) and dt = 0 (decay 1)
        xh, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xh, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (S + pad) // Q
    xh = xh.reshape(B_, nc, Q, H, P)
    Br = Bm.reshape(B_, nc, Q, G, N)
    Cr = Cm.reshape(B_, nc, Q, G, N)
    dt = dt.reshape(B_, nc, Q, H)
    dA = dt * A  # negative

    # intra-chunk, quadratic in Q
    Lmat = torch.exp(_segsum(dA.transpose(-1, -2)))  # (B, nc, H, Q, Q)
    scores = torch.einsum("bcign,bcjgn->bcgij", Cr, Br).repeat_interleave(hpg, dim=2)
    M = scores * Lmat * dt.transpose(-1, -2)[..., None, :]  # weighted by dt_j, float32
    y_intra = torch.einsum("bchij,bcjhp->bcihp", M.to(dt_c), xh)

    # chunk-local states
    cum = dA.cumsum(2)  # (B, nc, Q, H)
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)
    Bh = Br.repeat_interleave(hpg, dim=3)  # (B, nc, Q, H, N)
    s_loc = torch.einsum("bcjhn,bcjh,bcjhp->bchnp", Bh.float(), decay_to_end * dt, xh.float())

    # inter-chunk scan: the state entering each chunk
    chunk_decay = torch.exp(cum[:, :, -1])  # (B, nc, H)
    state = torch.zeros(B_, H, N, P, dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = chunk_decay[:, c, :, None, None] * state + s_loc[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)

    Ch = Cr.repeat_interleave(hpg, dim=3)
    y_inter = torch.einsum("bcihn,bchnp,bcih->bcihp", Ch.float(), prev_states,
                           torch.exp(cum)).to(dt_c)
    y = y_intra + y_inter + xh * d_skip.to(dt_c)[:, None]
    return y.reshape(B_, nc * Q, H * P)[:, :S], state  # drop the padding


def _whole_cols(zxbcdt, p):
    """The in-projection's output and the conv's weights with their columns whole on
    a mesh: the concatenations [z | x | B | C | dt] and [x | B | C] that JAX shards
    over tp do not line up with heads, and the split needs every column. The batch
    stays on dp, and the sequence is whole (the conv and the scan run along it)."""
    return (shard(zxbcdt, "dp", None, None), shard(p["conv_w"], None, None),
            shard(p["conv_b"], None))


def _per_head(cfg, h, xh, dtr, z, Bm, Cm, p):
    """xh, dt, z and the per-head parameters split by head over `h` ("tp" or None),
    B and C by group where the groups split with the heads (a local slice of the
    whole value, no message)."""
    g = h if cfg.ssm.n_groups > 1 else None
    lead = (None,) * (xh.dim() - 3)  # the sequence dim, where there is one
    return (shard(xh, "dp", *lead, h, None), shard(dtr, "dp", *lead, h), shard(z, "dp", *lead, h),
            shard(Bm, "dp", *lead, g, None), shard(Cm, "dp", *lead, g, None),
            *(shard(p[k], h) for k in ("a_log", "d_skip", "dt_bias")), shard(p["norm"], h))


def mamba2_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, chunk: int = 256):
    """Full-sequence SSD. x: (B, S, D) -> (y (B, S, D), {"ssd" (B, H, N, P) fp32,
    "conv" (B, conv_dim, W - 1)}).

    On a mesh (JAX's shard sites: xh on ("dp", None, "tp", None), the output on
    ("dp", "sp", None)) the sequence is gathered whole (sequence parallelism
    splits it between blocks, and the conv needs the previous rank's last W - 1
    rows), the conv runs on every column, and the SSD on each rank's heads;
    the gated norm's mean over d_inner then sums across them."""
    dt_c = x.dtype
    x = shard(x, "dp", None, None)
    zxbcdt, cw, cb = _whole_cols(x @ p["w_in"].to(dt_c), p)
    outs = on_local(functools.partial(_conv, cfg), zxbcdt, cw, cb,
                    out=[getattr(zxbcdt, "placements", None)] * 6)
    z, xh, Bm, Cm, dtr, conv_state = outs
    h = _heads_split(cfg)
    xh, dtr, z, Bm, Cm, a_log, d_skip, dt_bias, norm = _per_head(cfg, h, xh, dtr, z, Bm, Cm, p)
    pl = getattr(xh, "placements", None)  # (B, S, H, P): y (B, S, H * P), the state (B, H, N, P)
    y, state = on_local(functools.partial(_ssd, chunk), xh, dtr, Bm, Cm, a_log, d_skip, dt_bias,
                        out=[pl, regrid(pl, {0: 0, 2: 1})])
    y = _gated_norm(norm, y, z)
    return shard(y @ p["w_out"].to(dt_c), "dp", "sp", None), {"ssd": state, "conv": conv_state}


def _decode_conv(cfg, zxbcdt, conv, cw, cb):
    """One token through the split and the conv, its window the conv state and the
    token: (z, xh (B, H, P), B, C (B, G, N), dt raw (B, H), the next conv state)."""
    s = cfg.ssm
    d_inner, H, _ = dims(cfg)
    B_ = zxbcdt.shape[0]
    dt_c = zxbcdt.dtype
    z, xc, Bm, Cm, dtr = _split_proj(cfg, zxbcdt)
    window = torch.cat([conv, torch.cat([xc, Bm, Cm], dim=-1)[:, :, None]], dim=-1)  # (B, conv_dim, W)
    xbc = F.silu(torch.einsum("bcw,cw->bc", window, cw.to(dt_c)) + cb.to(dt_c))
    gn = s.n_groups * s.d_state
    xh, Bm, Cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    return (z, xh.reshape(B_, H, s.head_dim), Bm.reshape(B_, s.n_groups, s.d_state),
            Cm.reshape(B_, s.n_groups, s.d_state), dtr, window[:, :, 1:])


def _ssd_step(xh, dtr, Bm, Cm, ssd, a_log, d_skip, dt_bias):
    """One recurrent step of the heads given: `ssd` (B, H, N, P) advanced in place;
    returns y (B, H * P)."""
    B_, H, P = xh.shape
    hpg = H // Bm.shape[1]
    dt_c = xh.dtype
    Bm = Bm.repeat_interleave(hpg, dim=1)  # (B, H, N)
    Cm = Cm.repeat_interleave(hpg, dim=1)
    dt = F.softplus(dtr.float() + dt_bias)  # (B, H)
    da = torch.exp(dt * -torch.exp(a_log))
    new = da[..., None, None] * ssd + torch.einsum("bhn,bh,bhp->bhnp", Bm.float(), dt, xh.float())
    ssd.copy_(new)
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), new).to(dt_c)
    return (y + xh * d_skip.to(dt_c)[:, None]).reshape(B_, H * P)


def mamba2_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict) -> torch.Tensor:
    """One-token recurrent step. x: (B, 1, D) -> y (B, 1, D); `state` updated in place.
    On a mesh the state is placed per `mamba2_state_specs`: the conv runs on every
    column (its state gathered, then written back to each rank's shard) and the
    step on each rank's heads, on its own shard of the SSD state."""
    dt_c = x.dtype
    zxbcdt, cw, cb = _whole_cols(x[:, 0] @ p["w_in"].to(dt_c), p)
    conv = shard(state["conv"], "dp", None, None)
    z, xh, Bm, Cm, dtr, new_conv = on_local(
        functools.partial(_decode_conv, cfg), zxbcdt, conv, cw, cb,
        out=[getattr(zxbcdt, "placements", None)] * 6)
    write(state["conv"], new_conv)
    h = _heads_split(cfg)
    xh, dtr, z, Bm, Cm, a_log, d_skip, dt_bias, norm = _per_head(cfg, h, xh, dtr, z, Bm, Cm, p)
    ssd = state["ssd"]
    if h is None and is_dtensor(ssd):
        # heads replicated (`_heads_split`: tp does not split the groups) while JAX's
        # spec splits the state by head: the step runs on a gathered copy, and each
        # rank writes its own heads back
        ssd = shard(ssd, "dp", None, None, None)
    y = on_local(_ssd_step, xh, dtr, Bm, Cm, ssd, a_log, d_skip, dt_bias,
                 out=[getattr(z, "placements", None)])
    if ssd is not state["ssd"]:
        write(state["ssd"], ssd)
    y = _gated_norm(norm, y, z)
    return (y @ p["w_out"].to(dt_c))[:, None, :]


def init_mamba2_state(cfg: ModelConfig, batch: int, device) -> dict:
    s = cfg.ssm
    _, H, conv_dim = dims(cfg)
    return {
        "ssd": torch.zeros(batch, H, s.d_state, s.head_dim, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, conv_dim, s.conv_width - 1, dtype=cfg.compute_dtype,
                            device=device),
    }


def mamba2_state_specs(cfg: ModelConfig) -> dict:
    """The logical axes of the decode state, JAX's `mamba2_state_specs`."""
    return {"ssd": ("dp", "tp", None, None), "conv": ("dp", "tp", None)}
