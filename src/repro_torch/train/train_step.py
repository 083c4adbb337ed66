"""Training step factory (`repro.train.train_step`): loss -> grads -> (optional
compression) -> AdamW.

Microbatch gradient accumulation, JAX's three remat policies
(`none`/`selective`/`full`, `models/transformer.py::remat_wrap`) and int8
gradient compression with error feedback. On a mesh (the params DTensors,
under `use_mesh`) every gradient comes out of autograd with the placements
its backward gave it, a partial sum over the data axes for the replicated
ones; `_zero1_shard_grads` puts it in its moments' ZeRO-1 layout (the
reduce-scatter GSPMD inserts for JAX's constraint), or without `zero1` in its
parameter's own layout (the data-parallel all-reduce).

Every family trains, held to JAX's gradients: dense, vlm and audio; the MoE
configs with their load-balance and z losses; the hybrid (Mamba2 + a shared
block) and RWKV6.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.models.transformer import Model
from repro_torch.parallel.axes import (current_mesh, is_dtensor, placements, sanitize_pspec,
                                       shard)
from repro_torch.parallel.compression import compress_gradients
from repro_torch.train.optimizer import _zero1_spec, adamw_update
from repro_torch.train.tree import leaves, tree_map


def _unflatten(tree: dict, flat: list):
    """`flat` (in `leaves` order) in the structure of `tree`."""
    it = iter(flat)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return build(tree)


def _rows(v: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) of a batch tensor: a microbatch. On a mesh it is a block of
    the global batch's rows, placed over dp again; slicing a dim sharded over dp has
    no DTensor strategy, so the (integer or embedding) batch is gathered first."""
    if not is_dtensor(v):
        return v[start:stop]
    rest = (None,) * (v.dim() - 1)
    return shard(shard(v, None, *rest)[start:stop], "dp", *rest)


def loss_and_grads(model: Model, params: dict, batch: dict, remat: str | None = None):
    """(grads in the params' structure and dtypes, detached loss metrics) of `model.loss`."""
    flat = [t.detach().requires_grad_(True) for t in leaves(params)]
    loss, metrics = model.loss(_unflatten(params, flat), batch, remat=remat)
    # an unused leaf (the token table of a batch of embeds) gets zeros, as in JAX
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    return _unflatten(params, list(grads)), {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: Model, pcfg: ParallelConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params", "opt", ["grad_error"]}, updated in place (see
    `train/optimizer.py`); batch = {"tokens" or "embeds", "labels"} tensors
    on the state's device. The metrics are 0-d tensors: JAX's loss metrics
    (`loss`, `ce`, `accuracy` and the MoE aux keys), `grad_norm` and `lr`.
    """
    def _zero1_shard_grads(grads):
        mesh = current_mesh()
        if mesh is None:
            return grads

        def one(g, spec):
            if not is_dtensor(g):
                return g
            spec = _zero1_spec(spec, tuple(g.shape)) if pcfg.zero1 else spec
            spec = sanitize_pspec(spec, tuple(g.shape), g.device_mesh)
            return g.redistribute(g.device_mesh, placements(spec, g.device_mesh))

        return tree_map(one, grads, model.pspecs())

    def grads_of(params, batch):
        grads, metrics = loss_and_grads(model, params, batch, pcfg.remat)
        return _zero1_shard_grads(grads), metrics

    def accumulate(params, batch):
        n = pcfg.microbatches
        if n <= 1:
            return grads_of(params, batch)
        B = next(iter(batch.values())).shape[0]
        if B % n:
            raise ValueError(f"batch {B} is not a multiple of microbatches {n}")
        micro = [{k: _rows(v, i * (B // n), (i + 1) * (B // n)) for k, v in batch.items()}
                 for i in range(n)]
        # the first microbatch seeds the accumulators, as JAX's scan does
        g0, m0 = grads_of(params, micro[0])
        g_acc = tree_map(lambda a: a.float() / n, g0)
        m_acc = {k: v / n for k, v in m0.items()}
        del g0
        for mb in micro[1:]:
            g, m = grads_of(params, mb)
            g_acc = tree_map(lambda a, b: a + b.float() / n, g_acc, g)
            m_acc = {k: m_acc[k] + m[k] / n for k in m_acc}
        return g_acc, m_acc

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        grads, metrics = accumulate(params, batch)
        new_state = {"params": params, "opt": opt}
        if pcfg.grad_compress:
            grads, new_state["grad_error"] = compress_gradients(grads, state.get("grad_error"))
        new_state["params"], new_state["opt"], stats = adamw_update(params, grads, opt, tcfg)
        return new_state, {**metrics, **stats}

    return train_step
