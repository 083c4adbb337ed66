"""deepseek-moe-16b [moe]: fine-grained 64 routed top-6 + 2 shared experts.

28L d_model=2048 16H (MHA kv=16, head_dim 128) expert d_ff=1408 vocab=102400;
layer 0 is dense with d_ff=10944 (per HF config).
[arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base]
"""

from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=10000.0,
    moe=MoECfg(
        num_experts=64,
        top_k=6,
        d_ff=1408,
        num_shared_experts=2,
        first_k_dense=1,
        dense_d_ff=10944,
        capacity_factor=1.25,
    ),
)
