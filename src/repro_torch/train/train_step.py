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
from repro_torch.parallel.axes import (activation_pspec, current_mesh, is_dtensor, placements,
                                       sanitize_pspec, take_rows)
from repro_torch.parallel.compression import compress_gradients
from repro_torch.train.optimizer import _zero1_spec, adamw_update
from repro_torch.train.tree import leaves, tree_map


def _unflatten(tree: dict, flat: list):
    """`flat` (in `leaves` order) in the structure of `tree`. No closure: a nested
    function that calls itself is a reference cycle, which would keep `flat`, and
    so a microbatch's whole gradient, alive until the cyclic collector runs."""
    return _build(tree, iter(flat))


def _build(t, it):
    return {k: _build(t[k], it) for k in sorted(t)} if isinstance(t, dict) else next(it)


def _rows(v: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) of a batch tensor: a microbatch, JAX's reshape of the global
    batch. On a mesh the rows are placed over dp as the model places its inputs
    (`activation_pspec`), each rank receiving its own from the rank that holds
    them (`take_rows`): no rank gathers the batch."""
    if not is_dtensor(v):
        return v[start:stop]
    names = ("dp",) + (None,) * (v.dim() - 1)
    spec = activation_pspec(names, (stop - start, *v.shape[1:]), v.device_mesh)
    return take_rows(v, start, stop, placements(spec, v.device_mesh))


def _pop_scaled(flat: list, j: int, n: int) -> torch.Tensor:
    """flat[j] / n in float32, a new tensor rounded as `flat[j].float() / n` is (an
    exact copy, then one division), with flat[j] taken out of the list so that the
    gradient leaf is freed as soon as it is read. Always a copy: autograd may hand
    two leaves the same gradient tensor, so none is divided in place."""
    g, flat[j] = flat[j], None
    return g.to(torch.float32, copy=True).div_(n)


def _add_scaled(acc: torch.Tensor, flat: list, j: int, n: int) -> None:
    """acc += flat[j] / n in place, as `acc + flat[j].float() / n` rounds it (never
    `add_(g, alpha=1 / n)`, which rounds otherwise), flat[j] freed as it is read. A
    DTensor gradient must lie as its accumulator does, on the same mesh with the same
    placements: then the add is each rank's own, on its local shards."""
    if is_dtensor(acc) or is_dtensor(flat[j]):
        g = flat[j]
        if not (is_dtensor(acc) and is_dtensor(g)) or (g.device_mesh, g.placements) != (
                acc.device_mesh, acc.placements):
            raise ValueError(f"a microbatch's gradient {getattr(g, 'placements', 'off the mesh')} "
                             f"is placed otherwise than its accumulator "
                             f"{getattr(acc, 'placements', 'off the mesh')}")
        acc, flat[j] = acc._local_tensor, g._local_tensor
        del g
    acc.add_(_pop_scaled(flat, j, n))


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
        mb = B // n

        def micro(i):  # made when it is used, so one microbatch is alive at a time
            return {k: _rows(v, i * mb, (i + 1) * mb) for k, v in batch.items()}

        # the first microbatch seeds the accumulators, as JAX's scan does; each later
        # one is added into them in place, a leaf at a time (JAX's scan carry is one
        # buffer), so one float32 tree is alive, and beside it one leaf's temporary
        g, m0 = grads_of(params, micro(0))
        flat = leaves(g)
        del g
        acc = [_pop_scaled(flat, j, n) for j in range(len(flat))]
        m_acc = {k: v / n for k, v in m0.items()}
        for i in range(1, n):
            g, m = grads_of(params, micro(i))
            flat = leaves(g)
            del g
            for j, a in enumerate(acc):
                _add_scaled(a, flat, j, n)
            m_acc = {k: m_acc[k] + m[k] / n for k in m_acc}
        return _unflatten(params, acc), m_acc

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        grads, metrics = accumulate(params, batch)
        new_state = {"params": params, "opt": opt}
        if pcfg.grad_compress:
            grads, new_state["grad_error"] = compress_gradients(grads, state.get("grad_error"))
        new_state["params"], new_state["opt"], stats = adamw_update(params, grads, opt, tcfg)
        return new_state, {**metrics, **stats}

    return train_step
