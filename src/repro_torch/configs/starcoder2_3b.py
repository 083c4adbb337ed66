"""starcoder2-3b [dense]: GQA kv=2, RoPE, LayerNorm, plain-GELU MLP.

30L d_model=3072 24H (kv=2, head_dim 128) d_ff=12288 vocab=49152.
[arXiv:2402.19173; hf bigcode/starcoder2-3b]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    rope_theta=100000.0,
)
