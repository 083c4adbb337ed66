"""qwen3-14b [dense]: GQA + qk-RMSNorm.

40L d_model=5120 40H (GQA kv=8, head_dim 128) d_ff=17408 vocab=151936.
[hf Qwen/Qwen3-14B]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    qk_norm=True,
    rope_theta=1000000.0,
)
