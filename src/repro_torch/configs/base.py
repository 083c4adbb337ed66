"""Model descriptor for the port: the fields of `repro.configs.base.ModelConfig` it reads.

A copy, not an import: the port does not import the JAX package. Only the
fields that the port's model paths read are kept. `attn_impl` and
`attn_chunk` choose `self_attention`'s path as in JAX (dense at or below one
chunk, else the flash VJP); prefill always runs the flash kernel on CUDA and
its plain version on the CPU, whatever they say.
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
    # FSDP-style extra sharding of expert ffn dims over the data axes (arctic-480b):
    # the ZeRO axes on the ff dim of the experts, gathered at use (`models/moe.py`)
    shard_ff_dp: bool = False


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
    # self_attention's path: "dense", or "chunked" (the flash VJP above attn_chunk tokens)
    attn_impl: str = "chunked"
    attn_chunk: int = 1024

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

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode is O(1)/O(window) per token."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

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
            attn_impl="dense",
            attn_chunk=16,
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


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


# the cells of the dry-run's sweep (`repro.configs.base.SHAPES`)
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Reduced shapes used by smoke tests (same kinds, tiny extents).
SMOKE_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution settings: mesh layout + policies (`repro.configs.base.ParallelConfig`).

    Kept field for field. As in JAX, the train step reads `remat`,
    `grad_compress`, `microbatches` and `zero1` (on a mesh, the gradients in
    the moments' ZeRO-1 layout); the mesh itself and its rules are the
    Trainer's (`mesh`, `rules`; `launch/mesh.py`). JAX hands `dp_axes` to its
    compression, which does not read it; `mesh_shape`, `mesh_axes`, `tp_axes`,
    `sequence_parallel`, `context_parallel_axes` and `pp_stages` are read by
    neither package.
    """

    mesh_shape: tuple[int, ...] = ()
    mesh_axes: tuple[str, ...] = ()
    dp_axes: tuple[str, ...] = ("data",)
    tp_axes: tuple[str, ...] = ("model",)
    sequence_parallel: bool = True
    context_parallel_axes: tuple[str, ...] = ()
    remat: str = "selective"  # none | selective | full
    zero1: bool = True
    grad_compress: bool = False  # int8 gradient quantization with error feedback
    microbatches: int = 1  # gradient accumulation
    pp_stages: int = 1


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    learning_rate: float = 3e-4
    warmup_steps: int = 10
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    optimizer: str = "adamw"  # adamw | adamw8bit
    seed: int = 0
    log_every: int = 10
    checkpoint_every: int = 0  # 0 = disabled
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
