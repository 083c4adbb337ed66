"""minitron-8b [dense]: pruned Nemotron — squared-ReLU MLP, huge vocab.

32L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=16384 vocab=256000.
[arXiv:2407.14679; hf nvidia/Minitron-8B-Base]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    norm="layernorm",
    act="relu2",
    gated_mlp=False,
    rope_theta=10000.0,
)
