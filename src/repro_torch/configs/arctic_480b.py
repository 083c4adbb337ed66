"""arctic-480b [moe]: 128 experts top-2 with a parallel dense residual branch.

35L d_model=7168 56H (GQA kv=8) expert d_ff=4864 vocab=32000.
[hf Snowflake/snowflake-arctic-base]
Dense-MoE hybrid: every layer computes dense MLP (residual) + routed MoE.
About 960 GB of bf16 experts: it does not fit one 80 GB card.
"""

from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=10000.0,
    moe=MoECfg(
        num_experts=128,
        top_k=2,
        d_ff=4864,
        dense_residual=True,
        dense_d_ff=4864,
        capacity_factor=1.25,
        # the expert ff dims shard over the data axes too (ZeRO-3 style)
        shard_ff_dp=True,
    ),
)
