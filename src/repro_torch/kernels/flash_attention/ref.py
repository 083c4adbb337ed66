"""Plain PyTorch versions of flash attention: the dense forward (the serve
path's oracle), and the blockwise forward with its LSE and the backward,
block for block JAX's `repro/models/flash_vjp.py` (the training path's)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, scale: float | None = None, window: int | None = None):
    """q: (B, Hq, S, dh); k, v: (B, Hkv, S, dh) -> (B, Hq, S, dh). Causal."""
    B, Hq, S, dh = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    scale = dh**-0.5 if scale is None else scale
    qg = q.reshape(B, Hkv, G, S, dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v)
    return out.reshape(B, Hq, S, dh)


def _live(qi: int, ki: int, chunk: int, window: int | None) -> bool:
    """Whether any (query, key) pair of query block qi and key block ki is unmasked."""
    return ki <= qi and (window is None or (ki + 1) * chunk - 1 > qi * chunk - window)


def _mask(qi: int, ki: int, chunk: int, window: int | None, device) -> torch.Tensor:
    q_pos = qi * chunk + torch.arange(chunk, device=device)
    k_pos = ki * chunk + torch.arange(chunk, device=device)
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _grouped(q, k, chunk):
    B, Hq, S, dh = q.shape
    Hkv = k.shape[1]
    chunk = S if chunk is None else chunk
    if S % chunk:  # JAX's flash_vjp reshapes S into chunks and does not pad
        raise ValueError(f"sequence {S} is not a multiple of the attention chunk {chunk}")
    return q.reshape(B, Hkv, Hq // Hkv, S, dh), chunk, S // chunk


def attention_lse_ref(q, k, v, *, window: int | None = None, scale: float | None = None,
                      chunk: int | None = None):
    """Plain version of the flash forward with its LSE: (out (B, Hq, S, dh), lse
    float32 (B, Hq, S)) from q (B, Hq, S, dh), k, v (B, Hkv, S, dh).

    Block for block `repro/models/flash_vjp.py::_fwd`: `chunk`-row blocks (S
    must be a multiple; the whole sequence by default), an online softmax in
    float32 with the accumulator in v's dtype, p rounded to it before the PV
    product, lse = m + log(max(l, 1e-30)). Key blocks that the diagonal and
    the window leave dead are skipped: in JAX they add exact zeros, or their
    sums are multiplied by an exact zero at the first live block.
    """
    qg, chunk, n = _grouped(q, k, chunk)
    B, Hkv, G, S, dh = qg.shape
    scale = dh**-0.5 if scale is None else scale
    out = torch.empty_like(qg)
    lse = torch.empty((B, Hkv, G, S), dtype=torch.float32, device=q.device)
    neg = torch.tensor(NEG_INF, device=q.device)
    for qi in range(n):
        rows = slice(qi * chunk, (qi + 1) * chunk)
        qc = qg[:, :, :, rows].float()
        m = torch.full((B, Hkv, G, chunk), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, chunk, dh), dtype=v.dtype, device=q.device)
        for ki in range(n):
            if not _live(qi, ki, chunk, window):
                continue
            keys = slice(ki * chunk, (ki + 1) * chunk)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, k[:, :, keys].float()) * scale
            s = torch.where(_mask(qi, ki, chunk, window, q.device), s, neg)
            m2 = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype), v[:, :, keys])
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m2
        out[:, :, :, rows] = acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)
        lse[:, :, :, rows] = m + torch.log(l.clamp_min(1e-30))
    return out.reshape(q.shape), lse.reshape(B, Hkv * G, S)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, window: int | None = None,
                            scale: float | None = None, chunk: int | None = None):
    """Plain version of the flash backward: (dq, dk, dv) in the inputs' dtypes.

    Block for block `repro/models/flash_vjp.py::_bwd_rule`: delta =
    rowsum(dout * out) in float32, then for each query block and each live key
    block P = exp(s - lse), dv += P^T dout, dS = P * (dout V^T - delta) *
    scale, dq += dS K, dk += dS^T Q, all in float32 (dead blocks, skipped,
    add exact zeros in JAX).
    """
    qg, chunk, n = _grouped(q, k, chunk)
    B, Hkv, G, S, dh = qg.shape
    scale = dh**-0.5 if scale is None else scale
    dog = dout.reshape(qg.shape).float()
    delta = torch.einsum("bhgqd,bhgqd->bhgq", dog, out.reshape(qg.shape).float())
    lseg = lse.reshape(B, Hkv, G, S)
    dq = torch.empty(qg.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    neg = torch.tensor(NEG_INF, device=q.device)
    for qi in range(n):
        rows = slice(qi * chunk, (qi + 1) * chunk)
        qc, doc = qg[:, :, :, rows].float(), dog[:, :, :, rows]
        lsec, dc = lseg[:, :, :, rows], delta[:, :, :, rows]
        dq_c = torch.zeros((B, Hkv, G, chunk, dh), dtype=torch.float32, device=q.device)
        for ki in range(n):
            if not _live(qi, ki, chunk, window):
                continue
            keys = slice(ki * chunk, (ki + 1) * chunk)
            kc, vc = k[:, :, keys].float(), v[:, :, keys].float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kc) * scale
            s = torch.where(_mask(qi, ki, chunk, window, q.device), s, neg)
            p = torch.exp(s - lsec[..., None])
            dv[:, :, keys] += torch.einsum("bhgqk,bhgqd->bhkd", p, doc)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doc, vc)
            ds = p * (dp - dc[..., None]) * scale
            dq_c += torch.einsum("bhgqk,bhkd->bhgqd", ds, kc)
            dk[:, :, keys] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qc)
        dq[:, :, :, rows] = dq_c
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
