"""Plain PyTorch reference of a dense decoder (Llama / Mistral / Qwen3 layers).

[RMSNorm -> GQA attention with RoPE (and qk-norm) -> residual -> RMSNorm ->
SwiGLU MLP -> residual] x L, a final RMSNorm and an untied head, written from
the architecture and the configuration file alone. It imports torch and
nothing of the program: the weights come from a callable the benchmark hands
it (the benchmark draws them from the seed), and every product runs in
float32 with TF32 off, or, for the control, with its operands rounded to fp8.

Two entry points:

- `served_logits`: the logits at the served positions of requests that went
  through a serving engine with the port's documented semantics: a prompt
  left-padded with token 0 to its admission's longest prompt, the padding
  attended; one scalar cache position for every slot, so a request's decoded
  tokens sit at the positions the engine gave them, and the cache slots that
  no token of the request wrote hold zero keys and values, which every later
  query attends (a score of 0, a value of 0). The prompt attends causally,
  within the window where there is one; a decoded token attends what its
  cache holds: with a sliding window the cache is a ring of slots (a token at
  position t in slot t mod its length), and a token's key and value stay
  until a later token of the request writes the same slot.
- `train_steps`: the loss, the gradients and AdamW steps of the training
  path: next-token cross-entropy over float32 logits, the mean over every
  label; AdamW with a global-norm clip, bias corrections, decoupled weight
  decay on every leaf of two dims or more (the stacked norm gains too), the
  parameters held in the configuration's dtype between steps.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("fp32", "fp8")
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value
Q_BLOCK = 256  # query rows of one attention block


def exact_matmuls() -> None:
    """float32 products stay float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sizes(cfg: dict) -> dict:
    heads = cfg["num_attention_heads"]
    window = cfg.get("sliding_window") if cfg.get("use_sliding_window", True) else None
    return {"L": cfg["num_hidden_layers"], "D": cfg["hidden_size"], "Hq": heads,
            "Hkv": cfg["num_key_value_heads"],
            "dh": cfg.get("head_dim") or cfg["hidden_size"] // heads,
            "W": window, "theta": float(cfg["rope_theta"]), "eps": float(cfg["rms_norm_eps"]),
            "qk_eps": float(cfg.get("qk_norm_eps", cfg["rms_norm_eps"])),
            "qk_norm": bool(cfg.get("qk_norm"))}


# ------------------------------------------------------------------ products
def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t rounded to float8_e4m3fn with one scale a slice along `dim`, back in float32."""
    s = t.abs().amax(dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _FP8MatMul(torch.autograd.Function):
    """x @ w with both operands in fp8 (a scale a row of x, a column of w), and the
    backward's two products with theirs in fp8 too."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _fp8(x, -1) @ _fp8(w, 0)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = _fp8(g, -1) @ _fp8(w, 1).T
        gw = _fp8(x.reshape(-1, x.shape[-1]), 0).T @ _fp8(g2, 0)
        return gx, gw


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return x @ w
    if prec == "fp8":
        return _FP8MatMul.apply(x, w)
    raise ValueError(f"precision {prec!r} is not one of {PRECISIONS}")


# ------------------------------------------------------------------ layers
def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gain


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, H, dh) at positions (T,): the half-split rotation."""
    dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = (positions.double()[:, None] * freqs).float()[:, None, :]  # (T, 1, dh / 2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, mask, gaps):
    """Softmax attention of one query block. q (B, Hkv, G, n, dh); k, v (B, Hkv, m, dh);
    mask (n, m); gaps (n,) zero slots each query attends beside its keys, or None."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill(~mask, float("-inf"))
    top = s.amax(-1, keepdim=True)
    if gaps is not None:
        top = torch.maximum(top, torch.where(gaps > 0, 0.0, float("-inf"))[:, None])
    p = torch.exp(s - top)
    den = p.sum(-1, keepdim=True)
    if gaps is not None:
        den = den + gaps[:, None].float() * torch.exp(-top)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v) / den


def attention(q, k, v, window: int | None, gaps: torch.Tensor | None = None,
              save: bool = False, until: torch.Tensor | None = None,
              prompt: int = 0) -> torch.Tensor:
    """Causal attention by index: q (B, T, Hq, dh), k, v (B, T, Hkv, dh) -> (B, T, Hq, dh),
    query i over keys j <= i (and j > i - window), in blocks of Q_BLOCK queries; with
    `save`, each block is checkpointed, so that autograd keeps only its inputs.
    With `until` (T,), a query i >= `prompt` attends instead each key j <= i with
    i < until[j], the index of the token that overwrites j's cache slot."""
    B, T, Hq, dh = q.shape
    Hkv = k.shape[2]
    qh = q.reshape(B, T, Hkv, Hq // Hkv, dh).permute(0, 2, 3, 1, 4)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    outs = []
    for a in range(0, T, Q_BLOCK):
        b = min(a + Q_BLOCK, T)
        lo = 0 if window is None or until is not None else max(0, a - window + 1)
        qi = torch.arange(a, b, device=q.device)[:, None]
        kj = torch.arange(lo, b, device=q.device)[None, :]
        mask = kj <= qi
        inside = kj > qi - window if window is not None else torch.ones_like(mask)
        if until is not None:
            inside = torch.where(qi < prompt, inside, qi < until[lo:b][None, :])
        mask &= inside
        g = None if gaps is None else gaps[a:b]
        args = (qh[:, :, :, a:b], kh[:, :, lo:b], vh[:, :, lo:b], mask, g)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False) if save
                    else _attend_block(*args))
    out = torch.cat(outs, dim=3)  # (B, Hkv, G, T, dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, dh)


def layer(s: dict, w: dict, x, positions, prec: str, gaps=None, save: bool = False,
          until=None, prompt: int = 0):
    """One decoder layer on x (B, T, D) float32; `gaps`, `until` and `prompt` as
    `attention` takes them."""
    B, T, _ = x.shape
    h = rms_norm(x, w["ln1/scale"], s["eps"])
    q = mm(h, w["attn/wq"], prec).view(B, T, s["Hq"], s["dh"])
    k = mm(h, w["attn/wk"], prec).view(B, T, s["Hkv"], s["dh"])
    v = mm(h, w["attn/wv"], prec).view(B, T, s["Hkv"], s["dh"])
    if s["qk_norm"]:
        q = rms_norm(q, w["attn/q_norm"], s["qk_eps"])
        k = rms_norm(k, w["attn/k_norm"], s["qk_eps"])
    q, k = rope(q, positions, s["theta"]), rope(k, positions, s["theta"])
    a = attention(q, k, v, s["W"], gaps, save=save, until=until, prompt=prompt).reshape(B, T, -1)
    x = x + mm(a, w["attn/wo"], prec)
    h = rms_norm(x, w["ln2/scale"], s["eps"])
    g = torch.nn.functional.silu(mm(h, w["mlp/wg"], prec)) * mm(h, w["mlp/wi"], prec)
    return x + mm(g, w["mlp/wo"], prec)


# ------------------------------------------------------------------ serving
@torch.no_grad()
def served_logits(cfg: dict, weight, seqs: list[dict], prec: str = "fp32") -> list[torch.Tensor]:
    """Float32 logits (n, V) at each sequence's `rows`.

    `weight(path, layer)` gives a leaf (or one layer's slice of a stacked leaf)
    on the device. A sequence is {"tokens", "positions", "until", "gaps",
    "prompt", "rows"}: every token the engine fed for one request, in order (the
    padded prompt, then each decoded token), the cache position each was
    written at, the index of the token that overwrites its cache slot (the
    sequence's length if none does), the number of never-written cache slots
    each one attends beside them, the padded prompt's length, and the indices
    of the tokens whose logits predict a served token. Layer by layer, one
    layer's weights in float32 at a time.
    """
    s = sizes(cfg)
    table = weight("embed/tok", None)
    xs = [table[q["tokens"]].float()[None] for q in seqs]
    del table
    names = ("ln1/scale", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "ln2/scale",
             "mlp/wi", "mlp/wg", "mlp/wo") + (("attn/q_norm", "attn/k_norm") if s["qk_norm"] else ())
    for i in range(s["L"]):
        w = {n: weight(n, i).float() for n in names}
        xs = [layer(s, w, x, q["positions"], prec, gaps=q["gaps"], until=q["until"],
                    prompt=q["prompt"]) for x, q in zip(xs, seqs)]
        del w
    gain, head = weight("final_norm/scale", None).float(), weight("lm_head/w", None).float()
    return [mm(rms_norm(x[0, q["rows"]], gain, s["eps"]), head, prec) for x, q in zip(xs, seqs)]


# ------------------------------------------------------------------ training
def loss_fn(cfg: dict, p: dict, tokens: torch.Tensor, labels: torch.Tensor, prec: str,
            ce_rows: int = 4096) -> torch.Tensor:
    """Mean next-token cross-entropy of float32 parameters `p` ({path: tensor}, the
    layer leaves stacked (L, ...)); each layer and each block of CE rows is
    checkpointed, so autograd keeps their inputs alone."""
    s = sizes(cfg)
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    x = torch.nn.functional.embedding(tokens.long(), p["embed/tok"])
    for i in range(s["L"]):
        w = {n.removeprefix("layers/"): t[i] for n, t in p.items() if n.startswith("layers/")}
        x = checkpoint(lambda x_, w_: layer(s, w_, x_, pos, prec, save=True), x, w,
                       use_reentrant=False)
    h = rms_norm(x, p["final_norm/scale"], s["eps"]).reshape(B * S, -1)
    y = labels.reshape(-1).long()

    def ce(h_, y_, head):
        logits = mm(h_, head, prec)
        return (torch.logsumexp(logits, -1) - logits.gather(-1, y_[:, None])[:, 0]).sum()

    total = sum(checkpoint(ce, h[a:a + ce_rows], y[a:a + ce_rows], p["lm_head/w"],
                           use_reentrant=False) for a in range(0, B * S, ce_rows))
    return total / (B * S)


def lr_at(hp: dict, step: int) -> float:
    """Linear warm-up, then a cosine to a tenth of the peak rate."""
    warm = min(step / max(hp["warmup_steps"], 1), 1.0)
    frac = min(max((step - hp["warmup_steps"]) / max(hp["schedule_steps"] - hp["warmup_steps"], 1),
                   0.0), 1.0)
    return hp["learning_rate"] * warm * (0.1 + 0.45 * (1.0 + math.cos(math.pi * frac)))


def train_steps(cfg: dict, params: dict, batches, hp: dict, prec: str = "fp32",
                half_batch: bool = False) -> dict:
    """len(batches) AdamW steps from `params` ({path: tensor} in the stored dtypes,
    updated in place). Returns each step's loss, the norm of each leaf's first
    clipped gradient (as AdamW gets it), of each leaf's raw first gradient, and
    of each leaf's change over the steps. `half_batch` is a planted fault: the
    loss of the first half of each batch's rows alone."""
    names = sorted(params)
    start = {n: params[n].clone() for n in names}
    m = {n: torch.zeros_like(params[n], dtype=torch.float32) for n in names}
    v = {n: torch.zeros_like(params[n], dtype=torch.float32) for n in names}
    out: dict = {"loss": []}
    b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
    for step, (tokens, labels) in enumerate(batches, start=1):
        if half_batch:
            tokens, labels = tokens[:len(tokens) // 2], labels[:len(labels) // 2]
        p32 = {n: params[n].detach().float().requires_grad_(True) for n in names}
        loss = loss_fn(cfg, p32, tokens, labels, prec)
        grads = dict(zip(names, torch.autograd.grad(loss, [p32[n] for n in names])))
        del p32
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            clip = min(1.0, hp["grad_clip"] / (float(gnorm) + 1e-9))
            lr = lr_at(hp, step)
            bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for n in names:
                g = grads.pop(n) * clip
                if step == 1:
                    out.setdefault("grad_raw", {})[n] = float(g.norm()) / clip
                    out.setdefault("grad", {})[n] = float(g.norm())
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g.square())
                update = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps)
                p = params[n]
                if p.dim() >= 2:
                    update = update + hp["weight_decay"] * p.float()
                p.copy_((p.float() - lr * update).to(p.dtype))
    out["change"] = {n: float((params[n].float() - start[n].float()).norm()) for n in names}
    return out
