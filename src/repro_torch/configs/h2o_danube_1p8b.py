"""h2o-danube-1.8b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (head_dim 80, GQA kv=8) d_ff=6912 vocab=32000, SWA 4096.
[arXiv:2401.16818; hf h2oai/h2o-danube-1.8b-base]
SWA makes decode O(window): the KV cache is a ring of 4096 slots, and head
dim 80 takes the attention kernels' padded (128-column) tensor-core tiles.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=10000.0,
    sliding_window=4096,
)
