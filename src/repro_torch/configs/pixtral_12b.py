"""pixtral-12b [vlm]: pixtral-ViT frontend (stub) + Mistral-Nemo-style decoder.

40L d_model=5120 32H (GQA kv=8, head_dim 128 — attn inner dim 4096 != d_model)
d_ff=14336 vocab=131072. [hf mistralai/Pixtral-12B-2409; unverified]
Vision frontend stub: a caller passes patch embeddings as batch["embeds"].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    rope_theta=1000000000.0,
    input_mode="embeds",
)
