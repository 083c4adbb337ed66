"""rwkv6-7b [ssm]: RWKV6 "Finch", attention-free, data-dependent decay.

32L d_model=4096 (64 heads x 64), channel-mix d_ff=14336, vocab 65536.
[arXiv:2404.05892; hf RWKV/rwkv-6-world-7b]
"""

from repro_torch.configs.base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,  # d_model / ssm.head_dim (informational)
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    norm="layernorm",
    act="relu2",
    gated_mlp=False,
    ssm=SSMCfg(kind="rwkv6", head_dim=64, mix_dim=32, decay_lora=64),
)
