"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L d_model=2048, shared attn 32H (MHA, kv=32, head_dim 64) + shared MLP
d_ff=8192 applied every 6 layers, ssm_state=64, vocab 32000.
[arXiv:2411.15242; hf Zyphra/Zamba2-1.2B]
Simplification kept from the JAX package: the shared block runs at d_model
width (real Zamba2 concatenates the original embedding; per-invocation LoRAs
omitted).
"""

from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    norm="rmsnorm",
    act="gelu",
    gated_mlp=True,
    rope_theta=10000.0,
    ssm=SSMCfg(kind="mamba2", d_state=64, head_dim=64, expand=2, n_groups=2, conv_width=4),
    attn_every=6,
)
