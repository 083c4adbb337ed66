"""A dense decoder (Llama, Mistral, Qwen3): what the benchmark knows of the
family, worked out from a configuration file's published sizes (Hugging Face
`config.json` keys), never from the program.

A family module offers what the harness asks of any model, by these names:

- `sizes(cfg)`: the sizes the formulas use; `L` (layers), `V` (vocabulary)
  and, where the family has attention, `Hq`, `Hkv`, `dh` and `W` (the window
  or None), which the flash rooflines read;
- `refuse(cfg)`: why the program cannot run the file as it states, or None;
- `port_fields(cfg)`: the program's `ModelConfig` fields the file fixes;
- `layer_leaves(cfg)`, `top_leaves(cfg)`: the parameter tree the benchmark
  draws, {path: (shape, kind)} with kind "matrix" or "gain", the layer leaves
  stacked (L, ...) under `layers/` in the program's tree;
- `product_params(cfg)`, `total_params(cfg)`, `train_step_flops(cfg, B, S)`,
  `prompt_flops(cfg, n)`, `decode_flops(cfg, context)`: the model's useful
  arithmetic, as the port's `chip_smoke.py` `MFU_NOTE`, `product_params` and
  `attention_flops` count it.
"""

from __future__ import annotations

from benchkit.yardstick import live_pairs

# the port's RMSNorm epsilons, fixed in its code (`models/layers.py::apply_norm`,
# `models/attention.py`'s qk-norm): it has no field that sets them
PORT_EPS, PORT_QK_EPS = 1e-5, 1e-6


def sizes(cfg: dict) -> dict:
    heads = cfg["num_attention_heads"]
    return {
        "L": cfg["num_hidden_layers"], "D": cfg["hidden_size"], "Hq": heads,
        "Hkv": cfg["num_key_value_heads"], "dh": cfg.get("head_dim") or cfg["hidden_size"] // heads,
        "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
        "W": cfg.get("sliding_window") if cfg.get("use_sliding_window", True) else None,
        "qk_norm": bool(cfg.get("qk_norm")), "tied": bool(cfg.get("tie_word_embeddings")),
    }


def refuse(cfg: dict) -> str | None:
    eps = (cfg["rms_norm_eps"], cfg.get("qk_norm_eps", PORT_QK_EPS))
    if eps != (PORT_EPS, PORT_QK_EPS):
        return (f"the port runs its RMSNorms at eps {PORT_EPS} and its qk-norm at {PORT_QK_EPS}, "
                f"with no option to change them; the file states {eps}")
    return None


def port_fields(cfg: dict) -> dict:
    s = sizes(cfg)
    return dict(
        num_layers=s["L"], d_model=s["D"], num_heads=s["Hq"], num_kv_heads=s["Hkv"],
        head_dim=s["dh"], d_ff=s["F"], vocab_size=s["V"], act=cfg["hidden_act"],
        rope_theta=float(cfg["rope_theta"]), qk_norm=s["qk_norm"], sliding_window=s["W"],
        tie_embeddings=s["tied"], dtype=cfg["torch_dtype"], param_dtype=cfg["torch_dtype"],
        norm="rmsnorm", gated_mlp=True, family="dense")


def layer_leaves(cfg: dict) -> dict:
    s = sizes(cfg)
    D, q, kv, F = s["D"], s["Hq"] * s["dh"], s["Hkv"] * s["dh"], s["F"]
    out = {"ln1/scale": ((D,), "gain"), "attn/wq": ((D, q), "matrix"),
           "attn/wk": ((D, kv), "matrix"), "attn/wv": ((D, kv), "matrix"),
           "attn/wo": ((q, D), "matrix"), "ln2/scale": ((D,), "gain"),
           "mlp/wi": ((D, F), "matrix"), "mlp/wg": ((D, F), "matrix"),
           "mlp/wo": ((F, D), "matrix")}
    if s["qk_norm"]:
        out["attn/q_norm"] = ((s["dh"],), "gain")
        out["attn/k_norm"] = ((s["dh"],), "gain")
    return out


def top_leaves(cfg: dict) -> dict:
    s = sizes(cfg)
    out = {"embed/tok": ((s["V"], s["D"]), "matrix"), "final_norm/scale": ((s["D"],), "gain")}
    if not s["tied"]:
        out["lm_head/w"] = ((s["D"], s["V"]), "matrix")
    return out


def layer_params(cfg: dict) -> int:
    """Parameters of one decoder layer: the four attention projections, the gated
    MLP's three, the two RMSNorm gains and, with qk-norm, its two gains."""
    s = sizes(cfg)
    D, q, kv = s["D"], s["Hq"] * s["dh"], s["Hkv"] * s["dh"]
    return D * q + 2 * D * kv + q * D + 3 * D * s["F"] + 2 * D + (2 * s["dh"] if s["qk_norm"] else 0)


def head_params(cfg: dict) -> int:
    s = sizes(cfg)
    return s["D"] * s["V"]


def product_params(cfg: dict) -> int:
    """MFU_NOTE's parameters whose products a token runs: every layer, the final
    norm and the output head; not the token table, which is a lookup (a tied
    head counts once, as the head)."""
    s = sizes(cfg)
    return s["L"] * layer_params(cfg) + s["D"] + head_params(cfg)


def total_params(cfg: dict) -> int:
    """Every parameter, the token table included (once where it is tied)."""
    s = sizes(cfg)
    return product_params(cfg) + (0 if s["tied"] else s["V"] * s["D"])


def train_step_flops(cfg: dict, batch: int, seq: int) -> int:
    """MFU_NOTE: 6 x the product parameters x the tokens, plus 14 dh flops a live
    query-key pair a head at every layer (4 dh forward, 10 dh backward). Remat's
    recompute is overhead and is not counted."""
    s = sizes(cfg)
    attn = 14 * s["dh"] * live_pairs(seq, s["W"]) * batch * s["Hq"] * s["L"]
    return 6 * product_params(cfg) * batch * seq + attn


def prompt_flops(cfg: dict, n: int) -> int:
    """Useful forward flops of prefilling one prompt of n real tokens: every
    token through the layers, causal attention over the prompt, and the head
    once, for the last token's logits."""
    s = sizes(cfg)
    body = product_params(cfg) - head_params(cfg)
    return 2 * body * n + 2 * head_params(cfg) + 4 * s["dh"] * s["Hq"] * s["L"] * live_pairs(n, s["W"])


def decode_flops(cfg: dict, context: int) -> int:
    """Useful forward flops of one decoded token that attends to `context`
    real tokens (itself included), at most a window of them."""
    s = sizes(cfg)
    ctx = context if s["W"] is None else min(context, s["W"])
    return 2 * product_params(cfg) + 4 * s["dh"] * s["Hq"] * s["L"] * ctx
