"""AdamW with float32 or int8-quantized moments (`repro.train.optimizer`).

The port keeps JAX's numerics: the learning rate and the bias corrections
are float32 tensors (JAX's `jnp` arithmetic), not Python floats; weight
decay applies to every leaf with ndim >= 2 in the stacked (L, ...) layout,
so the stacked norm gains are decayed too, as in JAX; `torch.round` and
`jnp.round` both round half to even, and the quantizer keeps JAX's order of
operations, x / s * 127. ZeRO-1 (`_zero1_spec`, `opt_state_specs`) comes
with distribution (ROADMAP A6).

Unlike JAX, which returns new arrays, `adamw_update` writes the new
parameters and moments into the tensors it is given (JAX's `Trainer`
donates the state to the same effect): a step then holds one copy of the
state, not two. A leaf of more than SLICE_ELEMENTS elements is updated, and
its square summed for the global norm, in slices along its leading axis
(`_slices`), so that the float32 temporaries (XLA fuses them in JAX) are
one slice's size: rwkv6-7b's (32, 4096, 14336) channel-mix leaves would
take 7.5 GB each.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.train.tree import leaves, tree_map

# the largest leaf (in elements) that `adamw_update` and `global_norm` take at
# once: 256 MB a float32 temporary
SLICE_ELEMENTS = 1 << 26


def lr_schedule(cfg: TrainConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to 10%, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    total = max(cfg.steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / total, 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac))
    return cfg.learning_rate * warm * cos


def _quantize(x: torch.Tensor) -> dict:
    """int8 + per-row absmax scale. 0/1-D tensors use a per-tensor scale."""
    xf = x.float()
    if x.dim() <= 1:
        s = xf.abs().max() + 1e-12
        return {"q": torch.round(xf / s * 127.0).to(torch.int8), "s": s.reshape(())}
    s = xf.abs().amax(-1, keepdim=True) + 1e-12
    return {"q": torch.round(xf / s * 127.0).to(torch.int8), "s": s}


def _dequantize(qs: dict) -> torch.Tensor:
    return qs["q"].float() * qs["s"] / 127.0


def _is_quant(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def leaves_q(tree) -> list:
    """Leaves of a moment tree, a quantized `{q, s}` leaf as one (`is_leaf=_is_quant`)."""
    if isinstance(tree, dict) and not _is_quant(tree):
        return [x for k in sorted(tree) for x in leaves_q(tree[k])]
    return [tree]


def adamw_init(params: dict, cfg: TrainConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if cfg.optimizer == "adamw8bit":
        m = tree_map(lambda p: _quantize(zeros(p)), params)
        v = tree_map(lambda p: _quantize(zeros(p)), params)
    else:
        m, v = tree_map(zeros, params), tree_map(zeros, params)
    step = torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)
    return {"m": m, "v": v, "step": step}


def _slices(p: torch.Tensor) -> list:
    """Ranges of the leading axis to update at a time: the whole leaf (None), or for a leaf
    of ndim >= 2 above SLICE_ELEMENTS, runs of as many leading rows as fit in it.
    The results are the same bits: every operation of the update is elementwise,
    the int8 scales are per row along the last axis, and the clip factor and the
    bias corrections are computed once before."""
    if p.dim() < 2 or p.numel() <= SLICE_ELEMENTS:
        return [None]
    n = max(1, SLICE_ELEMENTS // (p.numel() // p.shape[0]))
    return [slice(i, i + n) for i in range(0, p.shape[0], n)]


def _at(leaf, sl):
    """A leaf's rows `sl` (all of it for None), both tensors' of a quantized leaf."""
    if sl is None:
        return leaf
    return {k: v[sl] for k, v in leaf.items()} if isinstance(leaf, dict) else leaf[sl]


def global_norm(tree) -> torch.Tensor:
    """The float32 norm of every leaf together; a leaf above SLICE_ELEMENTS summed
    slice by slice (`_slices`), so that its float32 square is one slice's size."""
    return torch.sqrt(torch.stack([sum(_at(g, sl).float().square().sum() for sl in _slices(g))
                                   for g in leaves(tree)]).sum())


def _assign(dst, src) -> None:
    """Write a new value into a leaf, or into both tensors of a quantized leaf."""
    if isinstance(dst, dict):
        for k in dst:
            _assign(dst[k], src[k])
    else:
        dst.copy_(src)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: TrainConfig):
    """(params, opt_state, stats): grad clip + AdamW + decoupled weight decay, in place."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) if cfg.grad_clip > 0 else 1.0
    quant = cfg.optimizer == "adamw8bit"
    bc1 = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(p, g, m, v, decay: bool):
        g = g.float() * clip
        mf = _dequantize(m) if quant else m
        vf = _dequantize(v) if quant else v
        mf = cfg.b1 * mf + (1 - cfg.b1) * g
        vf = cfg.b2 * vf + (1 - cfg.b2) * g.square()
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only (and the stacked gains)
            update = update + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
        _assign(m, _quantize(mf) if quant else mf)
        _assign(v, _quantize(vf) if quant else vf)

    flat_m = leaves_q(opt_state["m"])
    flat_v = leaves_q(opt_state["v"])
    for p, g, m, v in zip(leaves(params), leaves(grads), flat_m, flat_v, strict=True):
        for sl in _slices(p):
            upd(*(_at(t, sl) for t in (p, g, m, v)), p.dim() >= 2)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
