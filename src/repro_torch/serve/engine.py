"""Batched serving engine: prefill + autoregressive decode over slot batches.

Port of `repro.serve.engine`. A fixed decode batch of `slots`; each finished
request frees its slot, queued prompts are prefilled into free slots and
their caches spliced in. The cache is updated in place across decode steps.

An admission splices every cache leaf on its slot axis, which the cache's
structure gives (`transformer.SLOT_AXES`): axis 1 of the stacked layers and
of a hybrid's per-segment attention caches, axis 2 of its per-segment Mamba2
states, axis 0 of a head layer's and of the hybrid tail's leaves. JAX's
splice guesses the axis from the leaf's shape and cannot splice a hybrid
cache.

Known behaviour kept exactly, because token parity with the JAX engine
depends on it: the cache position is a single scalar, prompts are
left-padded with token 0 and the padding is attended (and runs through the
recurrence of the Mamba2 and RWKV6 layers), and an admission sets
the position to max(old, new), so a later-admitted prompt is misaligned.

Greedy decoding is `argmax` (first index on ties, as `jnp.argmax`). With
`temperature > 0`, `generate` samples with a `torch.Generator` seeded from
`seed`; those draws are not bit-equal to `jax.random`'s.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.transformer import Model, cache_leaves


@dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    temperature: float = 0.0
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model: Model, params: dict, *, max_len: int, slots: int = 8,
                 seed: int = 0):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.slots = slots
        self.device = params["embed"]["tok"].device
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.decode_steps = 0  # decode iterations of the last serve() call
        self.admissions = 0  # prefills of the last serve() call
        # host seconds of the last serve() call, each span ending in a device sync
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(toks).to(self.device)

    # ----------------------------------------------------------- single batch
    def generate(self, prompts: list[np.ndarray], max_new_tokens: int,
                 temperature: float = 0.0) -> list[list[int]]:
        """Generate for a batch of equal-priority prompts (left-padded to one batch)."""
        B = len(prompts)
        S = max(len(p) for p in prompts)
        toks = np.zeros((B, S), np.int32)
        for i, p in enumerate(prompts):
            toks[i, S - len(p):] = p
        logits, cache = self.model.prefill(self.params, {"tokens": self._tokens(toks)},
                                           self.max_len)
        outs: list[list[int]] = [[] for _ in range(B)]
        for _ in range(max_new_tokens):
            nxt = self._sample(logits, temperature)  # (B,)
            for i, t in enumerate(nxt.tolist()):
                outs[i].append(t)
            logits, cache = self.model.decode_step(self.params, cache, nxt[:, None])
        return outs

    def _sample(self, logits: torch.Tensor, temperature: float) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0].to(torch.int32)

    # ------------------------------------------------------ slot-based server
    def serve(self, requests: list[Request], *, eos: int | None = None) -> list[Request]:
        """Continuous-batching-lite scheduler over a fixed slot count.

        `self.decode_steps` reports the decode iterations of the last call."""
        pending = list(requests)
        active: list[Request | None] = [None] * self.slots
        cache = None
        logits_np = None
        self.decode_steps = self.admissions = 0
        self.prefill_seconds = self.decode_seconds = 0.0
        while pending or any(a is not None for a in active):
            admit = []
            for s in range(self.slots):
                if active[s] is None and pending:
                    active[s] = pending.pop(0)
                    admit.append(s)
            if admit:
                t0 = time.perf_counter()
                cache, logits_np = self._admit(admit, active, cache, logits_np)
                self.prefill_seconds += time.perf_counter() - t0
                self.admissions += 1
            live = [s for s in range(self.slots) if active[s] is not None]
            if not live:
                break
            nxt = np.zeros((self.slots,), np.int32)
            for s in live:
                r = active[s]
                tok = int(np.argmax(logits_np[s]))
                r.out_tokens.append(tok)
                nxt[s] = tok
                if (eos is not None and tok == eos) or len(r.out_tokens) >= r.max_new_tokens:
                    r.done = True
                    active[s] = None
            if not any(active[s] is not None for s in live):
                # every live slot finished this step: the decode would only
                # produce logits for freed slots (stale by the next admit)
                continue
            t0 = time.perf_counter()
            logits, cache = self.model.decode_step(self.params, cache,
                                                   self._tokens(nxt)[:, None])
            logits_np = logits.cpu().numpy()  # the copy to the host waits for the device
            self.decode_seconds += time.perf_counter() - t0
            self.decode_steps += 1
        return requests

    def _admit(self, slots_to_fill, active, cache, logits_np):
        """Prefill admitted prompts as one padded batch; splice into the slot cache."""
        B = self.slots
        S = max(len(active[s].prompt) for s in slots_to_fill)
        toks = np.zeros((B, S), np.int32)
        for s in slots_to_fill:
            toks[s, S - len(active[s].prompt):] = active[s].prompt
        logits, new_cache = self.model.prefill(self.params, {"tokens": self._tokens(toks)},
                                               self.max_len)
        new_logits = logits.cpu().numpy()
        if cache is None:
            return new_cache, new_logits
        mask = np.zeros((B,), bool)
        mask[slots_to_fill] = True
        sel = torch.as_tensor(slots_to_fill, device=self.device)
        # splice the admitted slots in place, each leaf on the slot axis that its
        # place in the cache gives it (never guessed from its shape)
        new = {path: t for path, t, _ in cache_leaves(new_cache)}
        for path, old, axis in cache_leaves(cache):
            old.index_copy_(axis, sel, new[path].index_select(axis, sel))
        cache["pos"] = max(cache["pos"], new_cache["pos"])  # slots decode in lockstep
        if logits_np is not None:
            logits_np[mask] = new_logits[mask]
        return cache, logits_np
