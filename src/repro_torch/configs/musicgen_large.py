"""musicgen-large [audio]: decoder-only over EnCodec tokens (backbone only).

48L d_model=2048 32H (MHA kv=32, head_dim 64) d_ff=8192 vocab=2048.
[arXiv:2306.05284; hf facebook/musicgen-large]
Frontend stub: a caller passes precomputed frame embeddings as
batch["embeds"] (B, S, d_model); a single codebook stream.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    rope_theta=10000.0,
    input_mode="embeds",
)
