"""KV-cache size model (§3.5).

Paper formula: 2 * batch * context * precision * layers * embedding_dim.
GQA generalization: the cached dim is num_kv_heads * head_dim (= embedding dim
for MHA, smaller for GQA); sliding-window attention caps context at the window.
SSM archs replace the KV cache with O(1) recurrent state (returned separately).

A copy of `repro.core.kvcache` (the port imports nothing of the JAX package);
`tests/test_torch_kvcache_dse.py` holds it to the original bit for bit.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def kv_cache_bytes(cfg: ModelConfig, batch: int, context: int, precision: int = 2) -> float:
    if cfg.family == "ssm":
        return 0.0
    ctx = min(context, cfg.sliding_window) if cfg.sliding_window else context
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    n_attn = len(_attn_layers(cfg))
    return 2.0 * batch * ctx * precision * n_attn * kv_dim


def recurrent_state_bytes(cfg: ModelConfig, batch: int) -> float:
    if cfg.ssm is None:
        return 0.0
    s = cfg.ssm
    if s.kind == "rwkv6":
        H = cfg.d_model // s.head_dim
        per_layer = H * s.head_dim * s.head_dim * 4 + 2 * cfg.d_model * 2
        return batch * cfg.num_layers * per_layer
    # mamba2
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    per_layer = H * s.d_state * s.head_dim * 4 + conv_dim * (s.conv_width - 1) * 2
    n_mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return batch * n_mamba * per_layer


def _attn_layers(cfg: ModelConfig) -> list[int]:
    if cfg.family == "hybrid":
        if not cfg.attn_every:
            return []
        k = cfg.attn_every
        n_seg = cfg.num_layers // k
        tail = cfg.num_layers - n_seg * k
        return list(range(n_seg + (1 if tail else 0)))
    if cfg.family == "ssm":
        return []
    return list(range(cfg.num_layers))
