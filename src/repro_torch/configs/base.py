"""Model descriptor for the port: the fields of `repro.configs.base.ModelConfig` it reads.

A copy, not an import: the port does not import the JAX package. Only the
fields that the port's model paths read are kept; `attn_impl` and
`attn_chunk` are not, because on CUDA prefill always runs the flash kernel
and on the CPU its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert ffn width
    num_shared_experts: int = 0  # deepseek: always-on shared experts (each d_ff wide)
    dense_residual: bool = False  # arctic: parallel dense MLP residual branch
    dense_d_ff: int = 0  # width of dense residual / leading dense layers
    first_k_dense: int = 0  # leading dense layers (deepseek layer 0)
    capacity_factor: float = 1.25
    norm_topk: bool = True  # renormalize top-k gate weights
    aux_loss_coef: float = 0.01
    # JAX's `shard_ff_dp` is left out: it only places experts on a mesh, and the port has none


@dataclass(frozen=True)
class SSMCfg:
    kind: str  # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    # rwkv6
    mix_dim: int = 32
    decay_lora: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int | None = None  # SWA window (h2o-danube)
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    attn_every: int | None = None  # hybrid: shared attn+mlp block period (zamba2)
    input_mode: str = "tokens"  # tokens | embeds (audio/vlm stub frontends)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation compute dtype
    param_dtype: str = "bfloat16"
    loss_chunk: int = 2048  # sequence-chunked CE to bound logits memory

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the same values as the JAX `reduced()`)."""
        small: dict[str, Any] = dict(
            num_layers=min(self.num_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            sliding_window=16 if self.sliding_window else None,
            param_dtype="float32",
            dtype="float32",
            loss_chunk=32,
        )
        if self.moe is not None:
            small["moe"] = replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_ff=64,
                dense_d_ff=128 if self.moe.dense_d_ff else 0,
                capacity_factor=2.0,
            )
        if self.ssm is not None:
            small["ssm"] = replace(self.ssm, d_state=16, head_dim=16, n_groups=1, mix_dim=8,
                                   decay_lora=8)
        if self.attn_every is not None:
            small["attn_every"] = 2
        small.update(overrides)
        return replace(self, **small)
