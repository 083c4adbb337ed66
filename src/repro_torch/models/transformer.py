"""Model assembly of the decoder: [norm -> GQA attn -> norm -> MLP or MoE] x L.

Port of the dense, vlm, audio and moe families of `repro.models.transformer`
for inference (`forward`, `loss`, `prefill`, `init_cache`, `decode_step`);
hybrid and RWKV come in later slices, and the backward with training. A
Python loop over the layers replaces `lax.scan`, over views of the stacked
`(L, ...)` parameters. In an MoE config the MLP of each stacked layer is the
routed MoE layer (`models/moe.py`), and the first `first_k_dense` layers are
dense and unstacked (`head_layers`, deepseek's layer 0), run before them.

The cache is a dict of JAX's structure, `{"head_layers": {"0": {"kv": {"k",
"v"}}}, "layers": {"kv": {"k", "v"}}, "pos"}`, with the stacked `k`/`v`
`(L - first_k_dense, B, W, Hkv, dh)`, a head layer's `(B, W, Hkv, dh)`, and
`pos` a host int; `head_layers` is there only when the config has head
layers. It is updated IN PLACE: `decode_step` writes into the tensors it is
given and returns the same dict (JAX donates the cache buffers to the same
effect).

`Model(cfg, kernels=True)` runs the pre-norms, the fused residual-add norm,
the qk-norms and both attentions through the port's CUDA kernels (their
plain versions on CPU tensors). LayerNorm has no kernel: on layernorm
configs the norms are plain PyTorch on either path. `kernels=False` runs
plain PyTorch on any device: the oracle the kernel path is held to on the
card.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.layers import apply_norm, embed_lookup, lm_logits
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.params import (FAMILIES, count_params, init_params, layer_params,
                                       n_head_layers)

AUX_KEYS = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")
# where the ROADMAP queues the families the port does not run yet
NOT_PORTED = {"hybrid": "A3 (Mamba2 + hybrid)", "ssm": "A3/A4 (Mamba2, RWKV6)"}


def zero_aux(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device) for k in AUX_KEYS}


def _norm(p: dict, x: torch.Tensor, kernels: bool) -> torch.Tensor:
    """RMSNorm through its kernel on the kernel path; LayerNorm (a bias) is plain."""
    return rms_ops.rmsnorm(x, p["scale"]) if kernels and "bias" not in p else apply_norm(p, x)


def _apply_dense_layer(cfg, p, x, mode, cache=None, pos=None, max_len=0, kernels=True):
    """One layer: (x, aux). `cache` is the layer's {"k", "v"}, filled (prefill) or
    extended (decode). `aux` holds an MoE layer's metrics in `forward`, else None."""
    h = _norm(p["ln1"], x, kernels)
    if mode == "forward":
        a = attn.self_attention(cfg, p["attn"], h, kernels=kernels)
    elif mode == "prefill":
        a, _ = attn.prefill_attention(cfg, p["attn"], h, max_len, cache=cache, kernels=kernels)
    else:
        a, _ = attn.decode_attention(cfg, p["attn"], h, cache, pos, kernels=kernels)
    if kernels and "bias" not in p["ln2"]:  # RMSNorm: the fused residual-add kernel
        h, x = rms_ops.rmsnorm_residual(x, a, p["ln2"]["scale"])
    else:
        x = x + a
        h = apply_norm(p["ln2"], x)
    if "moe" in p:
        m, aux = moe.apply_moe(cfg, p["moe"], h, aux=mode == "forward")
        return x + m, aux
    return x + apply_mlp(p["mlp"], h, cfg.act), None


class Model:
    """Functional model wrapper: params are explicit dicts of tensors."""

    def __init__(self, cfg: ModelConfig, *, kernels: bool = True):
        if cfg.family not in FAMILIES:
            item = NOT_PORTED.get(cfg.family, "A")
            raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not ported yet "
                                      f"(ROADMAP {item})")
        self.cfg = cfg
        self.kernels = kernels
        self.n_head = n_head_layers(cfg)
        self.n_scan = cfg.num_layers - self.n_head

    def init(self, seed: int, device: torch.device) -> dict:
        return init_params(self.cfg, seed, device)

    def param_count(self) -> int:
        return count_params(self.cfg)

    def _layers(self, params: dict) -> list[dict]:
        """Each layer's parameters in order: the head layers, then views of the stacked."""
        return ([params["head_layers"][str(i)] for i in range(self.n_head)]
                + [layer_params(params, i) for i in range(self.n_scan)])

    def _caches(self, cache: dict) -> list[dict]:
        """Each layer's {"k", "v"} in the same order (views of the stacked leaves)."""
        kv = cache["layers"]["kv"]
        return ([cache["head_layers"][str(i)]["kv"] for i in range(self.n_head)]
                + [{"k": kv["k"][i], "v": kv["v"][i]} for i in range(self.n_scan)])

    def _inputs_to_hidden(self, params: dict, batch: dict) -> torch.Tensor:
        cfg = self.cfg
        if cfg.input_mode == "embeds" and "embeds" in batch:
            return batch["embeds"].to(cfg.compute_dtype)
        return embed_lookup(params["embed"], batch["tokens"], cfg.compute_dtype)

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        p = params.get("lm_head")
        if p is None:  # tied
            p = {"w": params["embed"]["tok"].T}
        return lm_logits(p, x, torch.float32)

    def forward(self, params: dict, batch: dict):
        """Full-sequence forward: (final hidden (B, S, D), aux).

        `aux` holds JAX's MoE metrics, summed over the stacked layers and
        divided by their number (the head layers are dense and add nothing),
        all zero for the dense families. Inference only: no remat, and the
        kernels have no backward yet.
        """
        x = self._inputs_to_hidden(params, batch)
        aux = zero_aux(x.device)
        for p in self._layers(params):
            x, a = _apply_dense_layer(self.cfg, p, x, "forward", kernels=self.kernels)
            if a is not None:
                aux = {k: aux[k] + a[k] for k in AUX_KEYS}
        aux = {k: v / max(self.n_scan, 1) for k, v in aux.items()}
        return _norm(params["final_norm"], x, self.kernels), aux

    def loss(self, params: dict, batch: dict):
        """Next-token CE over `loss_chunk`-token chunks of fp32 logits: (loss, metrics).

        `batch["labels"]` (B, S) holds each position's target, -1 where it is
        ignored; S must be a multiple of the chunk. A chunk's (B, chunk, V)
        logits are the only ones alive at a time. An MoE config adds
        `aux_loss_coef` times the load-balance and z losses to the CE.
        """
        cfg = self.cfg
        x, aux = self.forward(params, batch)
        labels = batch["labels"]
        B, S, _ = x.shape
        chunk = min(cfg.loss_chunk, S)
        if S % chunk:
            raise ValueError(f"sequence {S} is not a multiple of loss_chunk {chunk}")
        tot = n = hits = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, S, chunk):
            logits = self._head(params, x[:, c:c + chunk])  # (B, chunk, V) fp32
            y = labels[:, c:c + chunk].long()
            valid = (y >= 0).float()
            gold = logits.gather(-1, y.clamp_min(0)[..., None])[..., 0]
            tot = tot + ((torch.logsumexp(logits, -1) - gold) * valid).sum()
            n = n + valid.sum()
            hits = hits + ((logits.argmax(-1) == y).float() * valid).sum()
        n = n.clamp_min(1.0)
        ce = loss = tot / n
        if cfg.moe is not None:
            loss = loss + cfg.moe.aux_loss_coef * (aux["moe_lb_loss"] + aux["moe_z_loss"])
        return loss, {"loss": loss, "ce": ce, "accuracy": hits / n, **aux}

    def init_cache(self, batch_size: int, max_len: int, device) -> dict:
        """Zeroed cache for decode-from-scratch."""
        one = attn.init_attn_cache(self.cfg, batch_size, max_len, device)
        kv = {k: torch.zeros((self.n_scan, *t.shape), dtype=t.dtype, device=device)
              for k, t in one.items()}
        cache = {"layers": {"kv": kv}, "pos": 0}
        if self.n_head:
            cache["head_layers"] = {
                str(i): {"kv": attn.init_attn_cache(self.cfg, batch_size, max_len, device)}
                for i in range(self.n_head)}
        return cache

    def prefill(self, params: dict, batch: dict, max_len: int):
        """Returns (last-token logits (B, V) fp32, decode-ready cache)."""
        x = self._inputs_to_hidden(params, batch)
        B, S, _ = x.shape
        cache = self.init_cache(B, max_len, x.device)
        for p, c in zip(self._layers(params), self._caches(cache)):
            x, _ = _apply_dense_layer(self.cfg, p, x, "prefill", c, max_len=max_len,
                                      kernels=self.kernels)
        x = _norm(params["final_norm"], x[:, -1].contiguous(), self.kernels)
        cache["pos"] = S
        return self._head(params, x), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """One autoregressive step. tokens: (B, 1) -> (logits (B, V) fp32, cache)."""
        pos = cache["pos"]
        x = embed_lookup(params["embed"], tokens, self.cfg.compute_dtype)
        for p, c in zip(self._layers(params), self._caches(cache)):
            x, _ = _apply_dense_layer(self.cfg, p, x, "decode", c, pos=pos, kernels=self.kernels)
        x = _norm(params["final_norm"], x[:, 0].contiguous(), self.kernels)
        cache["pos"] = pos + 1
        return self._head(params, x), cache
