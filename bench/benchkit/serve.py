"""A serving cell: the port's `ServeEngine.serve`, built as `launch/serve.py::run`
builds it, driven by calls of a traffic mix one after another until the window
closes, then held to the plain reference.

The engine records no per-token times, so the harness hands the engine a thin
proxy of the model (`Recorder`). At each `prefill` and `decode_step` entry,
and when `serve` returns, the proxy reads every request's `len(out_tokens)`
and stamps the tokens added since the last look with the host time: the
engine appends them right after a copy of logits to the host, which waits
for the device, so the stamp is when the user could see them. At the first
entry past the window's end the proxy raises, which ends the call in flight.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchkit import weights as W
from benchkit.trace import Traced


class WindowClosed(Exception):
    pass


class Recorder:
    """The program's model, with token stamps and a deadline at its two entries."""

    def __init__(self, model):
        self._model = model
        self.deadline = float("inf")
        self.requests: list = []
        self.stamps: list[list[float]] = []
        self.prefills: list[tuple[int, int, int]] = []  # (call, rows, padded length)
        self.call = -1

    def __getattr__(self, name):
        return getattr(self._model, name)

    def start(self, requests: list, call: int, deadline: float) -> None:
        self.requests, self.call, self.deadline = requests, call, deadline
        self.stamps = [[] for _ in requests]

    def mark(self) -> bool:
        """Stamp the tokens added since the last look; False past the deadline."""
        now = time.perf_counter()
        if now >= self.deadline:
            return False
        for r, st in zip(self.requests, self.stamps):
            st.extend([now] * (len(r.out_tokens) - len(st)))
        return True

    def prefill(self, params, batch, max_len, *args, **kw):
        if not self.mark():
            raise WindowClosed
        self.prefills.append((self.call, *batch["tokens"].shape))
        with torch.profiler.record_function("model.prefill"):
            return self._model.prefill(params, batch, max_len, *args, **kw)

    def decode_step(self, params, cache, tokens, *args, **kw):
        if not self.mark():
            raise WindowClosed
        with torch.profiler.record_function("model.decode_step"):
            return self._model.decode_step(params, cache, tokens, *args, **kw)


def call_lengths(traffic: dict) -> tuple[np.ndarray, np.ndarray]:
    """(prompt lengths, new tokens) of a call: the same for every call and every seed,
    drawn from the traffic's own `lengths_seed`, so that a seed and a call change the
    tokens and not the work."""
    rng = np.random.default_rng(traffic["lengths_seed"])
    n = traffic["requests_per_call"]
    lo, hi = traffic["prompt_len"]
    p = rng.integers(lo, hi + 1, size=n)
    lo, hi = traffic["new_tokens"]
    return p, rng.integers(lo, hi + 1, size=n)


def call_requests(Request, traffic: dict, vocab: int, seed: int, call: int) -> list:
    """The requests of one call: the prompts' tokens drawn from the seed."""
    rng = np.random.default_rng([seed, call])
    return [Request(prompt=rng.integers(0, vocab, size=int(p)).astype(np.int32),
                    max_new_tokens=int(n)) for p, n in zip(*call_lengths(traffic))]


def schedule(prompt_lens, new_tokens, slots: int) -> tuple[list, list]:
    """The engine's documented schedule of one `serve` call, worked out again: FCFS
    into free slots; an admission prefills its prompts left-padded to the longest
    and sets the one cache position to that length (the call's first) or to the
    larger of the two; every live slot then takes a token; slots whose requests
    are done free; the others decode one step at the position, which then rises
    by one. Returns each admission's request indices, and for each request its
    padded length and the positions its fed tokens were written at."""
    pending = list(range(len(prompt_lens)))
    active: list = [None] * slots
    got = [0] * len(prompt_lens)
    padded, fed = [0] * len(prompt_lens), [[] for _ in prompt_lens]
    admitted, pos, started = [], 0, False
    while pending or any(a is not None for a in active):
        admit = []
        for s in range(slots):
            if active[s] is None and pending:
                active[s] = pending.pop(0)
                admit.append(active[s])
        if admit:
            S = max(prompt_lens[i] for i in admit)
            pos = S if not started else max(pos, S)
            started = True
            for i in admit:
                padded[i] = S
            admitted.append(admit)
        live = [s for s in range(slots) if active[s] is not None]
        if not live:
            break
        for s in live:
            got[active[s]] += 1
            if got[active[s]] >= new_tokens[active[s]]:
                active[s] = None
        still = [active[s] for s in live if active[s] is not None]
        if not still:
            continue
        for i in still:
            fed[i].append(pos)
        pos += 1
    return admitted, [(padded[i], fed[i]) for i in range(len(prompt_lens))]


def run(ctx) -> dict:
    """Set-up, the window, and the check. `ctx` carries the configuration, the
    traffic, the seed, the window's seconds, whether to trace, the device and
    the program's classes (`ctx.program`)."""
    cfg, traffic, dev, fam = ctx.cfg, ctx.traffic, ctx.device, ctx.family
    Model, ServeEngine, Request = ctx.program.Model, ctx.program.ServeEngine, ctx.program.Request
    V = fam.sizes(cfg)["V"]
    params = W.make(fam, cfg, ctx.seed, dev, head_fp32=True)
    model = Recorder(Model(ctx.port_cfg))
    engine = ServeEngine(model, params, max_len=traffic["max_len"], slots=traffic["slots"],
                         seed=ctx.seed % 2**63)
    # warm-up: the largest admission the traffic makes, twice, and a decode step
    wu = traffic["warmup"]
    warm = [Request(prompt=np.zeros(wu["prompt_len"], np.int32), max_new_tokens=wu["new_tokens"])
            for _ in range(wu["requests"])]
    model.start(warm, -1, float("inf"))
    engine.serve(warm)
    ctx.sync()
    model.prefills.clear()

    calls, counters, traced, paused = [], [], None, 0.0
    start = ctx.open_window()
    deadline = start + ctx.seconds
    k = 0
    while time.perf_counter() < deadline:
        began = time.perf_counter()
        reqs = call_requests(Request, traffic, V, ctx.seed, k)
        model.start(reqs, k, deadline)
        cut = False
        with Traced(ctx.trace and k == 0, dev) as t, torch.profiler.record_function("engine.serve"):
            launches = dict(ctx.program.LAUNCHES)
            try:
                engine.serve(reqs)
            except WindowClosed:
                cut = True
        cut = cut or not model.mark()
        if t.on:  # the profiler's stop is no part of the window
            traced, paused, deadline = t, t.pause_s, deadline + t.pause_s
            launched = {n: c - launches[n] for n, c in ctx.program.LAUNCHES.items()}
        calls.append({"requests": reqs, "stamps": model.stamps, "cut": cut,
                      "end": time.perf_counter() - paused})
        counters.append({"admissions": engine.admissions, "admitted": engine.admitted,
                         "decode_steps": engine.decode_steps,
                         "prefill_seconds": engine.prefill_seconds,
                         "decode_seconds": engine.decode_seconds})
        ctx.log(f"[bench] call {k}: {time.perf_counter() - began:.3f} s"
                f"{' (cut by the window)' if cut else ''}")
        k += 1
        if cut:
            break
    ctx.close_window()
    if traced is not None:
        ctx.trace_summary = {**traced.summary(), "launches": launched,
                             "prefills": [p[1:] for p in model.prefills if p[0] == 0]}
    del engine, model, params
    gc.collect()
    ctx.free()
    record = summarize(fam, cfg, traffic, calls, counters, start)
    record["checks"], record["compared"] = check(ctx, calls, counters)
    return record


def summarize(fam, cfg: dict, traffic: dict, calls: list, counters: list, start: float) -> dict:
    """The numbers the metric readers take, over the calls completed in the window
    (the call cut at its end is left out, as a training step in flight is): every
    call serves the same sizes, so a window's rate does not hang on where it ends."""
    done = [(c, n) for c, n in zip(calls, counters) if not c["cut"]]
    tokens, itl, flops, requests = 0, [], 0, 0
    useful = padded = 0
    for c, n in done:
        for r, st in zip(c["requests"], c["stamps"]):
            tokens += len(st)
            itl += [1e3 * (b - a) for a, b in zip(st, st[1:])]
            requests += 1
            flops += fam.prompt_flops(cfg, len(r.prompt))
            flops += sum(fam.decode_flops(cfg, len(r.prompt) + j) for j in range(1, len(st)))
        for adm in n["admitted"]:
            lens = [len(c["requests"][i].prompt) for i in adm]
            useful += sum(lens)
            padded += traffic["slots"] * max(lens)
    return {
        "kind": "serve", "calls": len(done), "calls_s": done[-1][0]["end"] - start if done else 0.0,
        "tokens": tokens, "itl_ms": itl, "attempted": requests, "useful_flops": flops,
        "prompt_tokens": useful, "prefill_rows_tokens": padded,
        "admissions": sum(n["admissions"] for _, n in done),
        "prefill_seconds": sum(n["prefill_seconds"] for _, n in done),
        "decode_steps": sum(n["decode_steps"] for _, n in done),
        "decode_seconds": sum(n["decode_seconds"] for _, n in done),
    }


def cache_view(positions: np.ndarray, prompt: int, ring: int | None) -> tuple:
    """What a request's cache holds when each of its tokens is fed: for each token
    (written at `positions`, the first `prompt` of them by the prefill), the
    index of the later token that overwrites its slot (the sequence's length if
    none does), and for each token the never-written slots it attends, zero for
    the prompt's. A cache of `ring` slots (a sliding window's) puts position t
    in slot t mod `ring`, and the decode attends its first min(t + 1, ring)
    slots; with `ring` None, slot t, and the first t + 1."""
    T = len(positions)
    slots = positions % ring if ring else positions
    until, last = np.full(T, T, np.int64), {}
    for j in range(T - 1, -1, -1):
        until[j] = last.get(int(slots[j]), T)
        last[int(slots[j])] = j
    valid = positions + 1 if ring is None else np.minimum(positions + 1, ring)
    gaps = np.zeros(T, np.int64)
    for i in range(prompt, T):
        gaps[i] = valid[i] - int((until[:i + 1] > i).sum())
    return until, gaps


def sequences(traffic: dict, calls: list, counters: list, seed: int, want: int, window,
              device) -> tuple[list, list, int]:
    """The requests the check compares, as the reference's sequences, the tokens
    served for each, and how many admissions differ from the worked-out schedule.

    A sample drawn from the seed of the requests of the calls completed in the
    window, the longest (prompt and served tokens) and the one with the most
    served tokens always in it. `window` is the model's sliding window or None;
    the engine's cache then holds min(window, `max_len`) slots."""
    ring = min(window, traffic["max_len"]) if window else None
    done, mismatches = [], 0
    for c, n in zip(calls, counters):
        lens = [len(r.prompt) for r in c["requests"]]
        news = [r.max_new_tokens for r in c["requests"]]
        admitted, plan = schedule(lens, news, traffic["slots"])
        got = n["admitted"]
        ref = admitted[:len(got)] if c["cut"] else admitted
        mismatches += sum(a != b for a, b in zip(ref, got)) + abs(len(ref) - len(got))
        if c["cut"]:
            continue
        for i, (r, st) in enumerate(zip(c["requests"], c["stamps"])):
            if r.done and len(st) == r.max_new_tokens == len(r.out_tokens):
                done.append((r, plan[i]))
    if not done:
        return [], [], mismatches
    rng = np.random.default_rng([seed, 7])
    longest = max(range(len(done)), key=lambda i: len(done[i][0].prompt) + len(done[i][0].out_tokens))
    most = max(range(len(done)), key=lambda i: len(done[i][0].out_tokens))
    picks = list(dict.fromkeys([longest, most, *rng.permutation(len(done)).tolist()]))[:want]
    seqs, served = [], []
    for i in picks:
        r, (S, fed) = done[i]
        n = len(r.out_tokens)
        toks = np.concatenate([np.zeros(S - len(r.prompt), np.int64), r.prompt,
                               np.asarray(r.out_tokens[:n - 1], np.int64)])
        pos = np.concatenate([np.arange(S), np.asarray(fed[:n - 1], np.int64)])
        until, gaps = cache_view(pos, S, ring)
        seqs.append({k: torch.as_tensor(v, device=device) for k, v in
                     (("tokens", toks), ("positions", pos), ("until", until), ("gaps", gaps),
                      ("rows", np.arange(S - 1, S + n - 1)))})
        seqs[-1]["prompt"] = S
        served.append(torch.as_tensor(r.out_tokens, device=device))
    return seqs, served, mismatches


def widest_gap(logits: list, tokens: list) -> float:
    """The widest gap by which a served token's reference logit lies below the
    reference's best at its position."""
    return max(float((lg.max(-1).values - lg.gather(-1, t[:, None].long())[:, 0]).max())
               for lg, t in zip(logits, tokens))


def check(ctx, calls: list, counters: list) -> tuple[dict, int]:
    lim = ctx.limits
    seqs, served, mismatches = sequences(ctx.traffic, calls, counters, ctx.seed,
                                         ctx.traffic["check_requests"],
                                         ctx.family.sizes(ctx.cfg).get("W"), ctx.device)
    checks = {"schedule_mismatches": {"value": mismatches, "limit": lim["schedule_mismatches"]}}
    gap = None  # no request finished in the window: nothing served to show right
    if seqs:
        ref = ctx.reference
        ref.exact_matmuls()
        logits = ref.served_logits(ctx.cfg, ctx.weight, seqs)
        gap = widest_gap(logits, served)
        if ctx.controls:  # the control: the tokens the reference in fp8 puts first
            low = ref.served_logits(ctx.cfg, ctx.weight, seqs, prec="fp8")
            ctx.control_readings["fp8"] = {
                "served_gap": widest_gap(logits, [lg.argmax(-1) for lg in low])}
    checks["served_gap"] = {"value": gap, "limit": lim["served_gap"]}
    ctx.log(f"[bench] compared {sum(len(t) for t in served)} served tokens of {len(seqs)} requests")
    return checks, len(seqs)
