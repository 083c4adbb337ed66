"""Model assembly of the dense decoder: [norm -> GQA attn -> norm -> MLP] x L.

Port of the dense family of `repro.models.transformer` for inference
(`prefill`, `init_cache`, `decode_step`); `forward`, `loss`, MoE, hybrid and
RWKV come in later slices. A Python loop over the layers replaces
`lax.scan`, over views of the stacked `(L, ...)` parameters.

The cache is a dict of JAX's structure, `{"layers": {"kv": {"k", "v"}},
"pos"}`, with `k`/`v` stacked `(L, B, W, Hkv, dh)` and `pos` a host int. It
is updated IN PLACE: `decode_step` writes into the tensors it is given and
returns the same dict (JAX donates the cache buffers to the same effect).

`Model(cfg, kernels=True)` runs the pre-norms, the fused residual-add norm,
the qk-norms and both attentions through the port's CUDA kernels (their
plain versions on CPU tensors). `kernels=False` runs plain PyTorch on any
device: the oracle the kernel path is held to on the card.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_norm, embed_lookup, lm_logits
from repro_torch.models.mlp import apply_mlp
from repro_torch.models.params import count_params, init_params, layer_params


def _norm(p: dict, x: torch.Tensor, kernels: bool) -> torch.Tensor:
    return rms_ops.rmsnorm(x, p["scale"]) if kernels else apply_norm(p, x)


def _apply_dense_layer(cfg, p, x, mode, cache, pos=None, max_len=0, kernels=True):
    """One layer. `cache` is the layer's {"k", "v"}, filled (prefill) or extended (decode)."""
    h = _norm(p["ln1"], x, kernels)
    if mode == "prefill":
        a, _ = attn.prefill_attention(cfg, p["attn"], h, max_len, cache=cache, kernels=kernels)
    else:
        a, _ = attn.decode_attention(cfg, p["attn"], h, cache, pos, kernels=kernels)
    if kernels:
        h, x = rms_ops.rmsnorm_residual(x, a, p["ln2"]["scale"])
    else:
        x = x + a
        h = apply_norm(p["ln2"], x)
    return x + apply_mlp(p["mlp"], h, cfg.act)


class Model:
    """Functional model wrapper: params are explicit dicts of tensors."""

    def __init__(self, cfg: ModelConfig, *, kernels: bool = True):
        if cfg.family != "dense" or cfg.norm != "rmsnorm":
            raise NotImplementedError(f"{cfg.name}: only the dense rmsnorm family is ported")
        self.cfg = cfg
        self.kernels = kernels

    def init(self, seed: int, device: torch.device) -> dict:
        return init_params(self.cfg, seed, device)

    def param_count(self) -> int:
        return count_params(self.cfg)

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        p = params.get("lm_head")
        if p is None:  # tied
            p = {"w": params["embed"]["tok"].T}
        return lm_logits(p, x, torch.float32)

    def init_cache(self, batch_size: int, max_len: int, device) -> dict:
        """Zeroed cache for decode-from-scratch."""
        cfg = self.cfg
        one = attn.init_attn_cache(cfg, batch_size, max_len, device)
        kv = {k: torch.zeros((cfg.num_layers, *t.shape), dtype=t.dtype, device=device)
              for k, t in one.items()}
        return {"layers": {"kv": kv}, "pos": 0}

    def prefill(self, params: dict, batch: dict, max_len: int):
        """Returns (last-token logits (B, V) fp32, decode-ready cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
        B, S, _ = x.shape
        cache = self.init_cache(B, max_len, x.device)
        kv = cache["layers"]["kv"]
        for i in range(cfg.num_layers):
            x = _apply_dense_layer(cfg, layer_params(params, i), x, "prefill",
                                   {"k": kv["k"][i], "v": kv["v"][i]}, max_len=max_len,
                                   kernels=self.kernels)
        x = _norm(params["final_norm"], x[:, -1].contiguous(), self.kernels)
        cache["pos"] = S
        return self._head(params, x), cache

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """One autoregressive step. tokens: (B, 1) -> (logits (B, V) fp32, cache)."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
        kv = cache["layers"]["kv"]
        for i in range(cfg.num_layers):
            x = _apply_dense_layer(cfg, layer_params(params, i), x, "decode",
                                   {"k": kv["k"][i], "v": kv["v"][i]}, pos=pos,
                                   kernels=self.kernels)
        x = _norm(params["final_norm"], x[:, 0].contiguous(), self.kernels)
        cache["pos"] = pos + 1
        return self._head(params, x), cache
