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

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


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


def mamba2_seq(cfg: ModelConfig, p: dict, x: torch.Tensor, chunk: int = 256):
    """Full-sequence SSD. x: (B, S, D) -> (y (B, S, D), {"ssd" (B, H, N, P) fp32,
    "conv" (B, conv_dim, W - 1)})."""
    s = cfg.ssm
    d_inner, H, conv_dim = dims(cfg)
    G, N, P, W = s.n_groups, s.d_state, s.head_dim, s.conv_width
    B_, S, _ = x.shape
    Q = min(chunk, S)
    pad = (Q - S % Q) % Q
    dt_c = x.dtype
    hpg = H // G

    z, xc, Bm, Cm, dtr = _split_proj(cfg, x @ p["w_in"].to(dt_c))
    # depthwise causal conv over (x, B, C): a sum of W shifts, in the compute dtype
    conv_in = F.pad(torch.cat([xc, Bm, Cm], dim=-1), (0, 0, W - 1, 0))  # (B, S + W - 1, conv_dim)
    cw = p["conv_w"].to(dt_c)
    conv = sum(conv_in[:, i:i + S] * cw[:, i] for i in range(W))
    xbc = F.silu(conv + p["conv_b"].to(dt_c))
    conv_state = conv_in[:, S:].transpose(1, 2).contiguous()  # the last W - 1 pre-conv rows

    xh, Bm, Cm = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    xh = xh.reshape(B_, S, H, P)
    Bm = Bm.reshape(B_, S, G, N)
    Cm = Cm.reshape(B_, S, G, N)
    dt = F.softplus(dtr.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["a_log"])  # (H,)
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
    state = torch.zeros(B_, H, N, P, dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = chunk_decay[:, c, :, None, None] * state + s_loc[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)

    Ch = Cr.repeat_interleave(hpg, dim=3)
    y_inter = torch.einsum("bcihn,bchnp,bcih->bcihp", Ch.float(), prev_states,
                           torch.exp(cum)).to(dt_c)
    y = y_intra + y_inter + xh * p["d_skip"].to(dt_c)[:, None]
    y = y.reshape(B_, nc * Q, d_inner)[:, :S]  # drop the padding
    y = _gated_norm(p["norm"], y, z)
    return y @ p["w_out"].to(dt_c), {"ssd": state, "conv": conv_state}


def mamba2_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict) -> torch.Tensor:
    """One-token recurrent step. x: (B, 1, D) -> y (B, 1, D); `state` updated in place."""
    s = cfg.ssm
    d_inner, H, _ = dims(cfg)
    G, N, P = s.n_groups, s.d_state, s.head_dim
    B_ = x.shape[0]
    dt_c = x.dtype
    hpg = H // G

    z, xc, Bm, Cm, dtr = _split_proj(cfg, x[:, 0] @ p["w_in"].to(dt_c))
    xbc = torch.cat([xc, Bm, Cm], dim=-1)  # (B, conv_dim)
    window = torch.cat([state["conv"], xbc[:, :, None]], dim=-1)  # (B, conv_dim, W)
    conv = torch.einsum("bcw,cw->bc", window, p["conv_w"].to(dt_c)) + p["conv_b"].to(dt_c)
    state["conv"].copy_(window[:, :, 1:])
    xbc = F.silu(conv)

    xh, Bm, Cm = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)
    xh = xh.reshape(B_, H, P)
    Bm = Bm.reshape(B_, G, N).repeat_interleave(hpg, dim=1)  # (B, H, N)
    Cm = Cm.reshape(B_, G, N).repeat_interleave(hpg, dim=1)
    dt = F.softplus(dtr.float() + p["dt_bias"])  # (B, H)
    da = torch.exp(dt * -torch.exp(p["a_log"]))

    ssd = da[..., None, None] * state["ssd"] + torch.einsum(
        "bhn,bh,bhp->bhnp", Bm.float(), dt, xh.float())
    state["ssd"].copy_(ssd)
    y = torch.einsum("bhn,bhnp->bhp", Cm.float(), ssd).to(dt_c)
    y = y + xh * p["d_skip"].to(dt_c)[:, None]
    y = _gated_norm(p["norm"], y.reshape(B_, d_inner), z)
    return (y @ p["w_out"].to(dt_c))[:, None, :]


def init_mamba2_state(cfg: ModelConfig, batch: int, device) -> dict:
    s = cfg.ssm
    _, H, conv_dim = dims(cfg)
    return {
        "ssd": torch.zeros(batch, H, s.d_state, s.head_dim, dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, conv_dim, s.conv_width - 1, dtype=cfg.compute_dtype,
                            device=device),
    }
