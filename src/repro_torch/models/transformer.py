"""Model assembly of every family of `repro.models.transformer`.

  dense / vlm / audio : [norm -> GQA attn -> norm -> MLP] x L
  moe                 : the MLP of each stacked layer is the routed MoE layer
                        (`models/moe.py`); the first `first_k_dense` layers are
                        dense and unstacked (`head_layers`, deepseek's layer 0)
  ssm (rwkv6)         : [LayerNorm -> time mix -> LayerNorm -> channel mix] x L
  hybrid (zamba2)     : a Mamba2 backbone with one shared attn + MLP block
                        applied before every `attn_every` Mamba2 layers

`forward` (with JAX's remat policies), `loss`, `prefill`, `init_cache` and
`decode_step`. Autograd differentiates `forward` and `loss` through the
kernels' autograd Functions on the kernel path; every family trains, held
to JAX's gradients. A Python loop over the blocks replaces `lax.scan`, over
views of the stacked `(L, ...)` parameters (one `unbind` a leaf). The
hybrid splits its L layers as JAX's `_hybrid_split` does: n_seg = L //
attn_every segments of [shared block, attn_every Mamba2 layers], then, if
layers are left, one more shared block and the tail of n_tail = L - n_seg
* attn_every layers. The shared
block is a dense layer with its own weights (`params["shared"]`), so it runs
through `_apply_dense_layer`, with a KV cache of its own at every application.

The cache is a dict of JAX's structure, so that caches compare leaf by leaf:
- dense and MoE: `{"head_layers": {"0": {"kv": {"k", "v"}}}, "layers":
  {"kv": {"k", "v"}}, "pos"}`, the stacked `k`/`v` `(L - first_k_dense, B, W,
  Hkv, dh)`, a head layer's `(B, W, Hkv, dh)`; `head_layers` only when the
  config has head layers;
- ssm: `{"layers": {"tm": {"wkv", "shift"}, "cm": {"shift"}}, "pos"}`, each
  leaf `(L, B, ...)`;
- hybrid: `{"seg": {"shared": {"k", "v"} (n_seg, B, ...), "mamba": {"ssd",
  "conv"} (n_seg, attn_every, B, ...)}, "tail": {"shared": {"k", "v"} (B, ...),
  "mamba": ({"ssd", "conv"} (B, ...), ...)}, "pos"}`, `seg` and `tail` only
  where there are segments and tail layers.
`pos` is a host int. `SLOT_AXES` names each part's slot axis (the serving
engine splices admitted slots on it). The cache is updated IN PLACE:
`decode_step` writes into the tensors it is given and returns the same dict
(JAX donates the cache buffers to the same effect).

On a mesh (`parallel/axes.py::use_mesh`, params placed per `pspecs`) every
family trains and serves. `prefill`, `init_cache` and `decode_step` take
JAX's `cp`: the cache is placed per `cache_pspecs(cp)` (`cache_shapes` gives
its global shapes on the meta device), filled and advanced in place on each
rank's shard, and the logits come back whole on every rank.

`Model(cfg, kernels=True)` runs the RMSNorms, the fused residual-add norm,
the qk-norms and both attentions through the port's CUDA kernels (their
plain versions on CPU tensors). LayerNorm, Mamba2 and RWKV6 have no kernel:
plain PyTorch on either path, as in JAX. `kernels=False` runs plain PyTorch
on any device: the oracle the kernel path is held to on the card.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.distributed.tensor import Replicate, distribute_tensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.layers import (VocabParallelCE, apply_norm, chunk_ce, embed_lookup,
                                      lm_logits)
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.params import (FAMILIES, count_params, init_params, layer_params,
                                       n_head_layers, param_defs, param_specs, unstacked_layers)
from repro_torch.parallel.axes import (activation_pspec, current_mesh, is_dtensor, last_row,
                                       logical_spec, on_local, on_shards, placements, shard,
                                       shard_range, whole, write, zeros)

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")
# the slot axis of every cache leaf, by the part of the cache it is in
SLOT_AXES = {"layers": 1, "head_layers": 0, "seg/shared": 1, "seg/mamba": 2, "tail": 0}


REMAT = ("none", "selective", "full")
# selective remat saves the outputs of the batch-free matrix products, as JAX's
# `dots_with_no_batch_dims_saveable` does: the projections and the MLP (`x @ W`
# reaches aten.mm); the attention products carry batch dims (bmm) and, like
# everything else, are recomputed in the backward
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


_SAVED: list | None = None  # the open `saved_record`, if any


@contextlib.contextmanager
def saved_record():
    """Yields a list that gets the op of every product selective remat saves in a
    forward (not in its recompute) while it is open."""
    global _SAVED
    prev, _SAVED = _SAVED, []
    try:
        yield _SAVED
    finally:
        _SAVED = prev


def _save_products(ctx, op, *args, **kwargs):
    if op not in _SAVED_OPS:
        return CheckpointPolicy.PREFER_RECOMPUTE
    if _SAVED is not None and not ctx.is_recompute:
        _SAVED.append(op)
    return CheckpointPolicy.MUST_SAVE


def remat_wrap(fn, remat: str | None):
    """`fn` under JAX's remat policy: "none" (or None) saves what autograd saves,
    "full" saves nothing and recomputes the block in the backward, "selective"
    saves only the matrix-product outputs (`_SAVED_OPS`)."""
    if remat in (None, "none"):
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "selective":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_products))
    raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")


def zero_aux(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def _norm(p: dict, x: torch.Tensor, kernels: bool) -> torch.Tensor:
    """RMSNorm through its kernel on the kernel path; LayerNorm (a bias) is plain.
    On a mesh, on each rank's rows (`on_shards`)."""
    if kernels and "bias" not in p:
        return on_shards(rms_ops.rmsnorm, x, params=(p["scale"],))
    keys = sorted(p)
    return on_shards(lambda t, *w: apply_norm(dict(zip(keys, w)), t), x,
                     params=tuple(p[k] for k in keys))


def _apply_dense_layer(cfg, p, x, mode, cache=None, pos=None, max_len=0, kernels=True):
    """One layer: (x, aux). `cache` is the layer's {"k", "v"}, filled (prefill) or
    extended (decode). `aux` holds an MoE layer's metrics in `forward`, else None.
    On a mesh each norm's output is gathered whole over the sequence before the
    column-parallel products (Megatron's all-gather of sequence parallelism): a
    product flattening a (B, S, D) split on B over dp and on S over sp would make
    a strided shard, which DTensor plans over a search of every mesh dim and
    cannot always unflatten."""
    h = shard(_norm(p["ln1"], x, kernels), "dp", None, None)
    if mode == "forward":
        a = attn.self_attention(cfg, p["attn"], h, kernels=kernels)
    elif mode == "prefill":
        a, _ = attn.prefill_attention(cfg, p["attn"], h, max_len, cache=cache, kernels=kernels)
    else:
        a, _ = attn.decode_attention(cfg, p["attn"], h, cache, pos, kernels=kernels)
    a = shard(a, "dp", "sp", None)  # the output projection's partial sums, as the residual
    if kernels and "bias" not in p["ln2"]:  # RMSNorm: the fused residual-add kernel
        h, x = on_shards(rms_ops.rmsnorm_residual, x, a, params=(p["ln2"]["scale"],), n_out=2)
    else:
        x = x + a
        h = _norm(p["ln2"], x, False)
    h = shard(h, "dp", None, None)
    if "moe" in p:
        m, aux = moe.apply_moe(cfg, p["moe"], h, aux=mode == "forward")
        return shard(x + m, "dp", "sp", None), aux
    return shard(x + apply_mlp(p["mlp"], h, cfg.act), "dp", "sp", None), None


def _fill(cache: dict, state: dict) -> None:
    """Copy a sequence path's final state into the cache's views of the same structure
    (on a mesh, each rank into its own shard: `write`)."""
    for k, v in state.items():
        if isinstance(v, dict):
            _fill(cache[k], v)
        else:
            write(cache[k], v)


def _apply_mamba_layer(cfg, p, x, mode, cache=None, pos=None, max_len=0, kernels=True):
    """x + Mamba2(norm(x)): (x, None). Prefill fills `cache` {"ssd", "conv"}; decode
    advances it."""
    h = _norm(p["ln1"], x, kernels)
    if mode == "decode":
        return shard(x + mamba2.mamba2_decode(cfg, p["mamba"], h, cache), "dp", "sp", None), None
    m, state = mamba2.mamba2_seq(cfg, p["mamba"], h)
    if mode == "prefill":
        _fill(cache, state)
    return shard(x + m, "dp", "sp", None), None


def _apply_rwkv_layer(cfg, p, x, mode, cache=None, pos=None, max_len=0, kernels=True):
    """Time mix, then channel mix, each after its LayerNorm: (x, None)."""
    h = _norm(p["ln1"], x, False)
    if mode == "decode":
        x = x + rwkv6.time_mix_decode(cfg, p["tm"], h, cache["tm"])
        h = _norm(p["ln2"], x, False)
        return shard(x + rwkv6.channel_mix_decode(cfg, p["cm"], h, cache["cm"]), "dp", "sp", None), None
    a, tm = rwkv6.time_mix_seq(cfg, p["tm"], h)
    x = x + a
    c, cm = rwkv6.channel_mix_seq(cfg, p["cm"], _norm(p["ln2"], x, False))
    if mode == "prefill":
        _fill(cache, {"tm": tm, "cm": cm})
    return shard(x + c, "dp", "sp", None), None


def _at(tree, *idx):
    """Views of every leaf of a cache tree at the leading index `idx`."""
    return {k: _at(v, *idx) if isinstance(v, dict) else v[idx] for k, v in tree.items()}


def _stacked(tree: dict, *lead: int) -> dict:
    """Zeros of the tree's shapes and dtypes with leading dims `lead`."""
    return {k: _stacked(v, *lead) if isinstance(v, dict)
            else torch.zeros((*lead, *v.shape), dtype=v.dtype, device=v.device)
            for k, v in tree.items()}


def cache_leaves(cache: dict):
    """(path, tensor, slot axis) of every tensor of a cache (`SLOT_AXES`)."""
    def walk(tree, path):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            p = f"{path}/{k}" if path else str(k)
            if isinstance(v, (dict, tuple)):
                yield from walk(v, p)
            elif isinstance(v, torch.Tensor):
                part = next(a for a in SLOT_AXES if p == a or p.startswith(a + "/"))
                yield p, v, SLOT_AXES[part]
    yield from walk({k: v for k, v in cache.items() if k != "pos"}, "")


class Model:
    """Functional model wrapper: params are explicit dicts of tensors."""

    def __init__(self, cfg: ModelConfig, *, kernels: bool = True):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family!r}")
        kind = cfg.ssm.kind if cfg.ssm is not None else None
        # JAX assembles a hybrid from Mamba2 layers and an ssm config from RWKV6 layers only
        if (cfg.family == "hybrid" and (kind != "mamba2" or not cfg.attn_every)) or (
                cfg.family == "ssm" and kind != "rwkv6"):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} with SSM block {kind!r} and attn_every "
                f"{cfg.attn_every!r} is not a stack JAX builds")
        self.cfg = cfg
        self.kernels = kernels
        self.is_hybrid = cfg.family == "hybrid"
        self.is_rwkv = kind == "rwkv6"
        self.n_head = n_head_layers(cfg)
        self.n_scan = cfg.num_layers - self.n_head
        if self.is_hybrid:
            self.n_seg = cfg.num_layers // cfg.attn_every
            self.n_tail = cfg.num_layers - self.n_seg * cfg.attn_every

    def init(self, seed: int, device: torch.device, *, widen_head: bool = True) -> dict:
        return init_params(self.cfg, seed, device, widen_head=widen_head)

    def param_count(self) -> int:
        return count_params(self.cfg)

    def pspecs(self) -> dict:
        """The spec of every parameter under the current rules (JAX's `Model.pspecs`)."""
        return param_specs(param_defs(self.cfg))

    def _blocks(self, params: dict, cache: dict | None = None) -> list:
        """(apply function, parameters, cache views or None) of every block in order."""
        if self.is_hybrid:
            return self._hybrid_blocks(params, cache)
        layer = _apply_rwkv_layer if self.is_rwkv else _apply_dense_layer
        stacked = cache and cache["layers"]
        if stacked and not self.is_rwkv:  # an attention layer's cache is its {"k", "v"}
            stacked = stacked["kv"]
        out = [(_apply_dense_layer, params["head_layers"][str(i)],
                cache and cache["head_layers"][str(i)]["kv"]) for i in range(self.n_head)]
        return out + [(layer, p, stacked and _at(stacked, i))
                      for i, p in enumerate(unstacked_layers(params, self.n_scan))]

    def _hybrid_blocks(self, params: dict, cache: dict | None) -> list:
        k, shared = self.cfg.attn_every, params["shared"]
        out = []
        for i in range(self.n_seg):
            out.append((_apply_dense_layer, shared, cache and _at(cache["seg"]["shared"], i)))
            out += [(_apply_mamba_layer, layer_params(params, i * k + j),
                     cache and _at(cache["seg"]["mamba"], i, j)) for j in range(k)]
        if self.n_tail:
            out.append((_apply_dense_layer, shared, cache and cache["tail"]["shared"]))
            out += [(_apply_mamba_layer, layer_params(params, self.n_seg * k + j),
                     cache and cache["tail"]["mamba"][j]) for j in range(self.n_tail)]
        return out

    def _inputs_to_hidden(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if cfg.input_mode == "embeds" and "embeds" in batch:
            x = batch["embeds"].to(cfg.compute_dtype)
        else:
            x = embed_lookup(params["embed"], batch["tokens"], cfg.compute_dtype)
        return shard(x, "dp", "sp", None)

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        p = params.get("lm_head")
        if p is None:  # tied
            p = {"w": params["embed"]["tok"].T}
        return lm_logits(p, x, torch.float32)

    def _remat_groups(self, params: dict) -> list:
        """The blocks of `forward` grouped as JAX checkpoints them: (blocks, wrapped).

        A hybrid wraps each segment, the shared block and its `attn_every`
        Mamba2 layers, in one checkpoint and leaves the tail unwrapped
        (JAX's `seg_body` under `jax.checkpoint`, then the tail outside it);
        every other stack wraps each block alone, the head layers one by one
        and each stacked layer as the body of JAX's scan.
        """
        blocks = self._blocks(params)
        if not self.is_hybrid:
            return [([b], True) for b in blocks]
        k = self.cfg.attn_every + 1
        n = self.n_seg * k
        groups = [(blocks[i:i + k], True) for i in range(0, n, k)]
        return groups + ([(blocks[n:], False)] if self.n_tail else [])

    def _run_blocks(self, blocks: list, x: torch.Tensor):
        """x through `blocks` in forward mode: (x, their MoE metrics summed, or None)."""
        total = None
        for apply, p, _ in blocks:
            x, a = apply(self.cfg, p, x, "forward", kernels=self.kernels)
            if a is not None:
                total = a if total is None else {k: total[k] + a[k] for k in AUX_KEYS}
        return x, total

    def forward(self, params: dict, batch: dict, remat: str | None = None):
        """Full-sequence forward: (final hidden (B, S, D), aux).

        `aux` holds JAX's MoE metrics, summed over the stacked layers and
        divided by their number (the head layers are dense and add nothing),
        all zero for the other families. `remat` ("none", "selective",
        "full"; `remat_wrap`) applies to each checkpointed group of blocks
        (`_remat_groups`), as JAX's applies to each layer of its scan and to
        each hybrid segment.
        """
        x = self._inputs_to_hidden(params, batch)
        aux = zero_aux(x.device)
        for blocks, wrapped in self._remat_groups(params):
            run = functools.partial(self._run_blocks, blocks)
            x, a = (remat_wrap(run, remat) if wrapped else run)(x)
            if a is not None:
                aux = {k: aux[k] + a[k] for k in AUX_KEYS}
        aux = {k: v / max(self.n_scan, 1) for k, v in aux.items()}
        return _norm(params["final_norm"], x, self.kernels), aux

    def _chunk_loss(self, params: dict, xc: torch.Tensor, y: torch.Tensor):
        """(summed nll, valid count, hits) of one chunk, from its fp32 logits. On a mesh
        whose tp splits the vocabulary, each rank keeps its block of the logits
        (B, chunk, V / tp) and the CE is vocab-parallel (`layers.VocabParallelCE`):
        no rank forms the chunk's whole-vocab logits or their gradient."""
        logits = self._head(params, xc)  # (B, chunk, V) fp32, vocab-sharded on a mesh
        valid = (y >= 0).float()
        v0, _, split = shard_range(logits, 2)
        split = tuple(d for d in split if logits.device_mesh.size(d) > 1)
        if split:
            rows = [Replicate() if d in split else p for d, p in enumerate(logits.placements)]
            y = y.redistribute(y.device_mesh, rows) if is_dtensor(y) else y
            mesh = logits.device_mesh
            nll, arg = on_local(lambda lg, t: VocabParallelCE.apply(lg, t, v0, mesh, split),
                                logits, y, out=[rows, rows])
        else:
            nll, arg = chunk_ce(shard(logits, "dp", None, None), y)
        return (nll * valid).sum(), valid.sum(), ((arg == y).float() * valid).sum()

    def loss(self, params: dict, batch: dict, remat: str | None = None):
        """Next-token CE over `loss_chunk`-token chunks of fp32 logits: (loss, metrics).

        `batch["labels"]` (B, S) holds each position's target, -1 where it is
        ignored; S must be a multiple of the chunk. A chunk's (B, chunk, V)
        logits are the only ones alive at a time: under autograd each chunk is
        checkpointed and its logits recomputed in the backward, as JAX's
        `jax.checkpoint(chunk_loss)`. An MoE config adds `aux_loss_coef` times
        the load-balance and z losses to the CE. `remat` goes to `forward`.
        On a mesh the sums are reduced over the data axes and the loss and the
        metrics are plain tensors, the same on every rank; a chunk's logits stay
        split over tp (`_chunk_loss`).
        """
        cfg = self.cfg
        x, aux = self.forward(params, batch, remat=remat)
        # the chunks cut the sequence dim: it must not be sharded (sequence parallelism)
        x = shard(x, "dp", None, None)
        labels = batch["labels"]
        B, S, _ = x.shape
        chunk = min(cfg.loss_chunk, S)
        if S % chunk:
            raise ValueError(f"sequence {S} is not a multiple of loss_chunk {chunk}")
        chunk_loss = functools.partial(self._chunk_loss, params)
        if torch.is_grad_enabled():
            chunk_loss = functools.partial(checkpoint, chunk_loss, use_reentrant=False)
        tot = n = hits = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, S, chunk):
            nll, cnt, hit = chunk_loss(x[:, c:c + chunk], labels[:, c:c + chunk].long())
            tot, n, hits = tot + nll, n + cnt, hits + hit
        tot, n, hits = whole(tot), whole(n), whole(hits)
        aux = {k: whole(v) for k, v in aux.items()}
        n = n.clamp_min(1.0)
        ce = loss = tot / n
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_coef * (aux["moe_lb_loss"] + aux["moe_z_loss"])
        return loss, {"loss": loss, "ce": ce, "accuracy": hits / n, **aux}

    def cache_pspecs(self, cp: bool = False) -> dict:
        """The spec of every cache leaf under the current rules (JAX's
        `Model.cache_pspecs`), the tree of `init_cache`: the attention caches per
        `attn.cache_axes`, the Mamba2 and RWKV6 states per their state specs, a
        stacked leaf with a leading None a stack dim. `pos` is a host int in the
        port; its spec is the empty one, as JAX's scalar `pos` leaf is replicated."""
        cfg = self.cfg

        def stacked(tree, n):
            return {k: stacked(v, n) if isinstance(v, dict) else logical_spec(*(None,) * n, *v)
                    for k, v in tree.items()}

        if self.is_hybrid:
            a, m = attn.attn_cache_specs(cfg, cp), mamba2.mamba2_state_specs(cfg)
            cache = {}
            if self.n_seg:
                cache["seg"] = {"shared": stacked(a, 1), "mamba": stacked(m, 2)}
            if self.n_tail:
                cache["tail"] = {"shared": stacked(a, 0),
                                 "mamba": tuple(stacked(m, 0) for _ in range(self.n_tail))}
        elif self.is_rwkv:
            cache = {"layers": stacked(rwkv6.rwkv6_state_specs(cfg), 1)}
        else:
            a = {"kv": attn.attn_cache_specs(cfg, cp)}
            cache = {"layers": stacked(a, 1)}
            if self.n_head:
                cache["head_layers"] = {str(i): stacked(a, 0) for i in range(self.n_head)}
        cache["pos"] = logical_spec()
        return cache

    def cache_shapes(self, batch_size: int, max_len: int, cp: bool = False) -> dict:
        """The cache's tree on the meta device (JAX's `Model.cache_shapes`): each leaf's
        global shape and dtype, nothing allocated; `pos` the host int 0. `cp` changes
        placements only, never shapes."""
        cfg, device = self.cfg, "meta"
        if self.is_hybrid:
            a1 = attn.init_attn_cache(cfg, batch_size, max_len, device)
            m1 = mamba2.init_mamba2_state(cfg, batch_size, device)
            cache = {}
            if self.n_seg:
                cache["seg"] = {"shared": _stacked(a1, self.n_seg),
                                "mamba": _stacked(m1, self.n_seg, cfg.attn_every)}
            if self.n_tail:
                cache["tail"] = {"shared": a1, "mamba": tuple(
                    mamba2.init_mamba2_state(cfg, batch_size, device) for _ in range(self.n_tail))}
        elif self.is_rwkv:
            cache = {"layers": _stacked(rwkv6.init_rwkv6_state(cfg, batch_size, device),
                                        self.n_scan)}
        else:
            one = {"kv": attn.init_attn_cache(cfg, batch_size, max_len, device)}
            cache = {"layers": _stacked(one, self.n_scan)}
            if self.n_head:
                cache["head_layers"] = {
                    str(i): {"kv": attn.init_attn_cache(cfg, batch_size, max_len, device)}
                    for i in range(self.n_head)}
        cache["pos"] = 0
        return cache

    def init_cache(self, batch_size: int, max_len: int, device, cp: bool = False) -> dict:
        """Zeroed cache for decode-from-scratch. On a mesh each leaf is a DTensor placed
        per `cache_pspecs(cp)` (sanitized against its shape), each rank allocating only
        its own shard (`parallel.axes.zeros`)."""
        def place(t, spec):
            if isinstance(t, dict):
                return {k: place(v, spec[k]) for k, v in t.items()}
            if isinstance(t, tuple):
                return tuple(place(v, sp) for v, sp in zip(t, spec))
            return zeros(t.shape, t.dtype, device, spec) if isinstance(t, torch.Tensor) else t

        return place(self.cache_shapes(batch_size, max_len), self.cache_pspecs(cp))

    def _place_input(self, t: torch.Tensor) -> torch.Tensor:
        """Token ids (B, S) or embeddings (B, S, D) on a mesh: a DTensor with its batch on
        dp, each rank keeping its rows of the same global batch (nothing is sent);
        as is off a mesh."""
        mesh = current_mesh()
        if mesh is None or is_dtensor(t):
            return t
        spec = activation_pspec(("dp",) + (None,) * (t.dim() - 1), tuple(t.shape), mesh)
        return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)

    def prefill(self, params: dict, batch: dict, max_len: int, cp: bool = False):
        """Returns (last-token logits (B, V) fp32, decode-ready cache). On a mesh (params
        placed per `pspecs`), the cache is placed per `cache_pspecs(cp)` and the
        logits are whole on every rank."""
        batch = {k: self._place_input(v) for k, v in batch.items()}
        x = self._inputs_to_hidden(params, batch)
        B, S, _ = x.shape
        cache = self.init_cache(B, max_len, x.device, cp=cp)
        for apply, p, c in self._blocks(params, cache):
            x, _ = apply(self.cfg, p, x, "prefill", c, max_len=max_len, kernels=self.kernels)
        x = last_row(x)  # on a mesh the last block's row, with no gather of the sequence
        x = _norm(params["final_norm"], x.contiguous(), self.kernels)
        cache["pos"] = S
        return whole(self._head(params, x)), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor, cp: bool = False):
        """One autoregressive step. tokens: (B, 1) -> (logits (B, V) fp32, cache). `cp`,
        as JAX's, names the cache's placement, which on a mesh the cache itself
        carries; the logits are whole on every rank."""
        pos = cache["pos"]
        x = embed_lookup(params["embed"], self._place_input(tokens), self.cfg.compute_dtype)
        for apply, p, c in self._blocks(params, cache):
            x, _ = apply(self.cfg, p, x, "decode", c, pos=pos, kernels=self.kernels)
        x = _norm(params["final_norm"], x[:, 0].contiguous(), self.kernels)
        cache["pos"] = pos + 1
        return whole(self._head(params, x)), cache
