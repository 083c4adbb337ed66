"""Struct-of-arrays fast core for `ReplicaSim` (engine="vectorized").

`VecReplicaSim` executes the exact same schedule as the reference
object-per-request loop in `repro_torch.sim.scheduler`, but holds request state
in flat parallel columns (row index = one request) and compresses pure-
decode stretches into a single vectorized window:

  * Columns (`_prompt/_output/_cached/_gen/...`) are plain Python int
    lists — the per-step mutations are scalar, and list indexing beats
    numpy item access for that; numpy enters where it pays: pricing and
    clock accumulation over a fast-forward window.
  * KV pricing goes through per-context lookup tables built once per cost
    model (`_kv_tables`) instead of calling `kv_bytes` per request per
    iteration. Table entries are produced by the same `kv_bytes` calls,
    so every looked-up float is bit-identical to the reference engine's.
  * Pure-decode fast-forward: when every live request is decoding
    (deficit == 1), no admission can fire, and no chaos window is
    pending, the next k iterations are fully determined. The window is
    priced per ctx-quantum bucket (one memoized `decode_step_time` call
    per bucket), the clock advances through `np.cumsum` — which
    accumulates strictly sequentially, so the resulting floats bit-match
    k repeated `now += dt` additions — and state jumps forward in O(B).

Bit-parity contract (pinned by tests/test_engine_parity.py): every
record field, counter, and peak produced here equals the reference
engine's output bit-for-bit. The fast-forward window is sized so it can
never skip a schedule-relevant event: it stops at the first completion
(k_complete), the first arrival that could admit (k_arr), the first
iteration that would trip the KV-capacity invariant (k_kv, binary search
on the monotone projected allocation), and the caller's time limit
(k_time). Paged-KV waste peaks are evaluated exactly at page-crossing
candidate steps (total waste strictly decreases between crossings, so
the max over the window lies on a candidate).

A copy of `repro.sim.engine_vec` (the port imports nothing of the JAX package);
`tests/test_torch_sim.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np

from repro_torch.sim.costmodel import ServingCostModel
from repro_torch.sim.scheduler import (
    _MAX_ITERATIONS,
    ReplicaSim,
    ReqRecord,
    SchedConfig,
)
from repro_torch.sim.workload import SimRequest

_INF = math.inf
# Windows at or below this many decode steps are priced by a scalar loop
# instead of the numpy batch path: building/cumsumming the arrays costs
# tens of microseconds per call, which dwarfs a few memoized step prices.
_FF_SCALAR_K = 48


def _kv_tables(cost: ServingCostModel, upto: int) -> tuple[list, list]:
    """Per-context KV byte tables `alloc[ctx], exact[ctx]` for ctx in
    [0, upto], cached on the cost model (shared by every replica priced
    by it). Entries come straight from `cost.kv_bytes`, so lookups are
    bit-identical to direct calls. Rebuilt geometrically on growth."""
    tab = getattr(cost, "_vec_kv", None)
    if tab is not None and len(tab[0]) > upto:
        return tab
    hi = max(upto + 1, 4096)
    if tab is not None:
        hi = max(hi, 2 * len(tab[0]))
    alloc = [cost.kv_bytes(c) for c in range(hi)]
    if getattr(cost, "kv_block_tokens", 0) > 0:
        exact = [cost.kv_bytes(c, exact=True) for c in range(hi)]
    else:
        exact = alloc
    cost._vec_kv = (alloc, exact)
    return cost._vec_kv


class VecReplicaSim(ReplicaSim):
    """Drop-in `ReplicaSim` with flat columns and decode fast-forward.

    Supports the continuous and chunked policies (static batching stays
    on the reference engine — see `make_replica_sim`). Beyond the base
    API it exposes `advance_chunk(t_limit)`, which batches many engine
    iterations per call and reports completions grouped by the start
    clock of their completing iteration — what the cluster engine needs
    to release side effects in reference merge order.
    """

    def __init__(self, cost: ServingCostModel, sc: SchedConfig | None = None,
                 *, name: str = "", tracer=None):
        super().__init__(cost, sc, name=name, tracer=tracer)
        if self.sc.policy == "static":
            raise ValueError(
                "vectorized engine does not implement static batching; "
                "use engine='reference' (make_replica_sim does this for you)")
        # row-indexed columns; rows are append-only, freed logically
        self._req_col: list[SimRequest] = []
        self._rec_col: list[ReqRecord] = []
        self._rid_col: list[int] = []
        self._prompt: list[int] = []
        self._output: list[int] = []
        self._cached: list[int] = []
        self._gen: list[int] = []
        self._aseq: list[int] = []
        self._arrv: list[float] = []
        self._dl: list[float] = []  # EDF deadline (arrival + slo)
        self._pendq: deque[int] = deque()
        self._runrows: list[int] = []
        self._kvt, self._kvx = _kv_tables(cost, 0)
        self._kv_cache_val = 0.0
        self._kv_dirty = False
        # the base-class containers are unused; drop them so any code
        # path that silently depended on them fails loudly instead
        self._pending = None  # type: ignore[assignment]
        self._running = None  # type: ignore[assignment]

    # ------------------------------------------------------------- inspection
    @property
    def has_work(self) -> bool:
        """True while any request is queued or running."""
        return bool(self._pendq or self._runrows)

    @property
    def queue_len(self) -> int:
        """Requests waiting for admission (count)."""
        return len(self._pendq)

    @property
    def live(self) -> int:
        """Admitted requests currently holding KV (count)."""
        return len(self._runrows)

    @property
    def kv_used(self) -> float:
        """KV-cache bytes held by live requests right now."""
        # recomputed lazily: the cluster reads this once per routed
        # arrival (JSQ tie-breaks on it), which without the cache costs
        # O(slots) per view per arrival across the whole fleet
        if self._kv_dirty:
            kvt, cached = self._kvt, self._cached
            self._kv_cache_val = sum(kvt[cached[i]] for i in self._runrows)
            self._kv_dirty = False
        return self._kv_cache_val

    def _sample_counters(self) -> None:
        tr, t, track = self.tracer, self.now, self.name
        tr.counter("queue", t, len(self._pendq), track)
        tr.counter("live", t, self.live, track)
        tr.counter("kv_used", t, self.kv_used, track)
        tr.counter("busy_s", t, self.res.busy_s, track)

    # ---------------------------------------------------------------- enqueue
    def push(self, req: SimRequest, *, cached: int = 0, generated: int = 0) -> ReqRecord:
        """Enqueue a request; `cached`/`generated` (tokens) pre-warm its
        context for crash re-dispatch and KV handoff. Returns its record."""
        self._check_push(req, cached, generated)
        hi = req.prompt + req.output
        if len(self._kvt) <= hi:
            self._kvt, self._kvx = _kv_tables(self.cost, hi)
        rec = ReqRecord(req.rid, req.arrival, req.prompt, req.output)
        self.res.records.append(rec)
        self._rids.add(req.rid)
        row = len(self._req_col)
        self._req_col.append(req)
        self._rec_col.append(rec)
        self._rid_col.append(req.rid)
        self._prompt.append(req.prompt)
        self._output.append(req.output)
        self._cached.append(cached)
        self._gen.append(generated)
        self._aseq.append(-1)
        self._arrv.append(req.arrival)
        slo = req.slo_ttft if req.slo_ttft is not None else self.sc.slo_ttft
        self._dl.append(req.arrival + slo)
        self._pendq.append(row)
        return rec

    def kill(self) -> list[tuple[SimRequest, int, int, bool]]:
        """Crash the replica: drop all state and return the displaced
        requests as (req, cached tokens, generated tokens, started)."""
        out: list[tuple[SimRequest, int, int, bool]] = []
        for i in [*self._runrows, *self._pendq]:
            rec = self._rec_col[i]
            started = rec.admitted >= 0 or self._gen[i] > 0
            out.append((self._req_col[i], self._cached[i], self._gen[i], started))
            self.res.records.remove(rec)
            self._rids.discard(self._rid_col[i])
        self._pendq.clear()
        self._runrows.clear()
        self._kv_dirty = True
        return out

    def evict_pending(self, *, include_staged: bool = False) -> list[SimRequest]:
        """Remove and return never-admitted queued requests (drain
        re-routing); `include_staged` also evicts KV-handoff-staged ones."""
        keep: deque[int] = deque()
        out: list[SimRequest] = []
        for i in self._pendq:
            staged = self._cached[i] > 0 or self._gen[i] > 0
            if self._rec_col[i].admitted < 0 and (include_staged or not staged):
                out.append(self._req_col[i])
                self.res.records.remove(self._rec_col[i])
                self._rids.discard(self._rid_col[i])
            else:
                keep.append(i)
        self._pendq = keep
        return out

    # ------------------------------------------------------------- event loop
    def step(self) -> list[ReqRecord]:
        """One engine iteration, reference-identical (no fast-forward) —
        the traced/lockstep path."""
        if not self.has_work:
            return []
        return self._vstep()

    def run_until(self, t: float) -> list[ReqRecord]:
        """Run iterations while `now < t` (seconds; the last iteration may
        overshoot) and return records completed along the way."""
        out: list[ReqRecord] = []
        for _, recs in self.advance_chunk(t):
            out += recs
        return out

    def run(self) -> list[ReqRecord]:
        """Run until no work remains; returns all completed records."""
        out: list[ReqRecord] = []
        for _, recs in self.advance_chunk(_INF):
            out += recs
        return out

    def advance_chunk(self, t_limit: float, *, single: bool = False,
                      stop_on_done: bool = False,
                      ) -> list[tuple[float, list[ReqRecord]]]:
        """Advance while `now < t_limit` and work remains (the reference
        `run_until` loop condition — the last iteration may overshoot the
        limit). Returns `(start_clock, records)` per iteration that
        completed requests, where `start_clock` is the clock at which the
        completing iteration began — the cluster engine's merge key.
        `single=True` executes exactly one iteration (lockstep mode);
        `stop_on_done=True` stops after the first completing iteration
        (disaggregated prefill replicas: each completion creates a KV
        handoff whose ready time re-bounds the whole fleet's advance)."""
        out: list[tuple[float, list[ReqRecord]]] = []
        while self.has_work and self.now < t_limit:
            if not single:
                ffd = self._fast_forward(t_limit)
                if ffd is not None:
                    if ffd[1]:
                        out.append(ffd)
                        if stop_on_done:
                            break
                    continue
            start = self.now
            done = self._vstep()
            if done:
                out.append((start, done))
                if stop_on_done:
                    break
            if single:
                break
        return out

    # ---------------------------------------------------------- fast-forward
    def _fast_forward(self, t_limit: float):
        """Vectorize a pure-decode window; returns `(last_start, done)`
        after applying it, or None when this iteration must go through
        the exact per-step path."""
        rr = self._runrows
        if not rr or self._tr_rep:
            return None
        if self._slow_until > self.now:
            return None  # active or upcoming straggler window: step exactly
        prompt, cached, gen, output = self._prompt, self._cached, self._gen, self._output
        kvt, cap = self._kvt, self.cap
        # one fused pass: prefill-done precondition, first-step projected
        # KV, context total, and steps-to-first-completion
        alloc_1 = 0
        C0 = 0
        k_complete = None
        for i in rr:
            g = gen[i]
            c = cached[i]
            if g < 1 or prompt[i] + g - c != 1:
                return None  # someone still prefilling (or pre-first-token)
            C0 += c
            alloc_1 += kvt[c + 1]
            rem = output[i] - g
            if k_complete is None or rem < k_complete:
                k_complete = rem
        if alloc_1 > cap:
            return None  # this very step preempts: exact path handles it
        nxt_arr = None
        if self._pendq:
            # with a free slot an arrived request would admit this step;
            # with slots full, arrivals are inert until a completion, and
            # the window already ends at the first completion
            if len(rr) < self.sc.slots:
                arrv = self._arrv
                nxt_arr = min(arrv[i] for i in self._pendq)
                if nxt_arr <= self.now:
                    return None
        B = len(rr)
        cost, res = self.cost, self.res
        lim = t_limit if nxt_arr is None else min(t_limit, nxt_arr)
        # Estimate the window's step count from the first step's price.
        # Small windows (the common case inside a cluster, where the next
        # fleet event caps the chunk) go through a scalar loop: the numpy
        # path's fixed per-call cost is larger than pricing a handful of
        # steps one at a time. Both paths perform the identical sequence
        # of float adds, so the estimate only picks the cheaper route.
        k_est = k_complete
        dt1 = None
        if lim != _INF:
            dt1 = cost.decode_step_time(B, (C0 + B) / B)
            if dt1 > 0.0:
                k_est = min(k_est, int((lim - self.now) / dt1) + 1)
        if k_est <= _FF_SCALAR_K:
            now, busy_s, k = self.now, res.busy_s, 0
            last_start = now
            alloc_k = alloc_1
            while k < k_complete:
                start = now
                if start >= lim:
                    break
                j = k + 1
                if j > 1:
                    a = sum(kvt[cached[i] + j] for i in rr)
                    if a > cap:
                        break
                    alloc_k = a
                    dt = cost.decode_step_time(B, (C0 + j * B) / B)
                else:
                    # same memo key as the k_est probe above
                    dt = dt1 if dt1 is not None else cost.decode_step_time(
                        B, (C0 + B) / B)
                now = start + dt
                busy_s += dt
                last_start = start
                k += 1
            if k < 1:
                return None  # can't happen (start_1 == now < lim) — guard
            self.now = now
            res.busy_s = busy_s
        else:
            # largest k <= k_complete with projected KV within capacity
            # (projected allocation is nondecreasing in k)
            lo, hi = 1, k_complete
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if sum(kvt[cached[i] + mid] for i in rr) <= cap:
                    lo = mid
                else:
                    hi = mid - 1
            k = lo
            # price steps 1..k: ctx_mean_j = (C0 + j*B)/B, one memoized
            # decode_step_time call per ctx-quantum bucket run
            js = np.arange(1, k + 1, dtype=np.int64)
            ctx_means = (C0 + js * B) / B  # int64/int64 -> float64
            q = max(cost.ctx_quantum, 1)
            ctx_q = np.maximum(np.rint(ctx_means / q).astype(np.int64) * q, 1)
            dts = np.empty(k, dtype=np.float64)
            run_starts = [0, *(np.flatnonzero(np.diff(ctx_q)) + 1).tolist()]
            for a_idx, a in enumerate(run_starts):
                b = run_starts[a_idx + 1] if a_idx + 1 < len(run_starts) else k
                dts[a:b] = cost.decode_step_time(B, float(ctx_means[a]))
            # np.cumsum accumulates left-to-right, so clocks[j] bit-matches
            # j sequential `now += dt` additions from the seeded value
            clocks = np.cumsum(np.concatenate(([self.now], dts)))
            busy = np.cumsum(np.concatenate(([res.busy_s], dts)))
            starts = clocks[:-1]
            if t_limit != _INF:
                k = min(k, int(np.searchsorted(starts, t_limit, side="left")))
            if nxt_arr is not None:
                k = min(k, int(np.searchsorted(starts, nxt_arr, side="left")))
            if k < 1:
                return None  # can't happen (start_1 == now < limits) — guard
            last_start = float(clocks[k - 1])
            self.now = float(clocks[k])
            res.busy_s = float(busy[k])
            alloc_k = sum(kvt[cached[i] + k] for i in rr)
        res.iterations += k
        res.decode_steps += k
        if res.iterations > _MAX_ITERATIONS:
            raise RuntimeError("simulation did not converge (check token_budget/kv)")
        # peak KV: projected allocation is monotone over the window, so
        # the reference per-step max reduces to the final step's value
        if alloc_k > res.peak_kv:
            res.peak_kv = alloc_k
        if self._paged:
            self._ff_waste(rr, k)
        done: list[ReqRecord] = []
        for i in rr:
            cached[i] += k
            gen[i] += k
        if k == k_complete:
            for i in [i for i in rr if gen[i] >= output[i]]:
                rec = self._rec_col[i]
                rec.finish = self.now
                rr.remove(i)
                self._rids.discard(self._rid_col[i])
                done.append(rec)
            self._kv_dirty = True
            return (last_start, done)
        self._kv_dirty = True
        return (self.now, done)

    def _ff_waste(self, rr: list[int], k: int) -> None:
        """Paged-KV waste peak over a fast-forwarded window, evaluated at
        page-crossing candidate steps (waste strictly decreases between
        crossings, so the max lies on a candidate — exact, not bounded)."""
        blk = self.cost.kv_block_tokens
        cached, kvt, kvx = self._cached, self._kvt, self._kvx
        cand = {1, k}
        for i in rr:
            j0 = (1 - cached[i]) % blk
            if j0 == 0:
                j0 = blk
            cand.update(range(j0, k + 1, blk))
        res = self.res
        for j in sorted(cand):
            alloc = sum(kvt[cached[i] + j] for i in rr)
            exact = sum(kvx[cached[i] + j] for i in rr)
            waste = alloc - exact
            if waste > res.peak_kv_waste:
                res.peak_kv_waste = waste

    # ------------------------------------------------------------- exact step
    def _next_candidate_row(self) -> int | None:
        if not self._pendq:
            return None
        if self.sc.admission == "fcfs":
            cand = self._pendq[0]
            return cand if self._arrv[cand] <= self.now else None
        best, bkey = None, None
        arrv, dl, rid = self._arrv, self._dl, self._rid_col
        for i in self._pendq:
            if arrv[i] > self.now:
                continue
            key = (dl[i], arrv[i], rid[i])
            if best is None or key < bkey:
                best, bkey = i, key
        return best

    def _vstep(self) -> list[ReqRecord]:
        """Exact port of the reference `_step_continuous` over columns —
        identical call sequence into the cost model, identical float
        expression order, identical container iteration order."""
        cost, sc, cap = self.cost, self.sc, self.cap
        rr, pendq, res = self._runrows, self._pendq, self.res
        prompt, output = self._prompt, self._output
        cached, gen, aseq = self._cached, self._gen, self._aseq
        kvt = self._kvt
        chunked = sc.policy == "chunked"
        if not rr and pendq:
            nxt = min(self._arrv[i] for i in pendq)
            if nxt > self.now:
                self.now = nxt
        # ---- admission into free slots (optimistic KV check) ----
        kv_now = sum(kvt[cached[i]] for i in rr)
        while len(rr) < sc.slots:
            c = self._next_candidate_row()
            if c is None:
                break
            need = kvt[prompt[c] + gen[c] + 1]
            if kv_now + need > cap:
                break  # blocking: later candidates must not jump the queue
            pendq.remove(c)
            rec = self._rec_col[c]
            if rec.admitted < 0:
                rec.admitted = self.now
                res.admit_order.append(self._rid_col[c])
            aseq[c] = self._admit_seq
            self._admit_seq += 1
            rr.append(c)
            kv_now += need

        # ---- plan this iteration's work ----
        def needs_prefill(i: int) -> bool:
            if gen[i] == 0:
                return cached[i] < prompt[i]
            return prompt[i] + gen[i] - cached[i] > 1

        decoders = [i for i in rr if not needs_prefill(i) and gen[i] >= 1]
        prefills: list[tuple[int, int]] = []
        if chunked:
            budget = sc.token_budget - len(decoders)
            for i in sorted((x for x in rr if needs_prefill(x)),
                            key=aseq.__getitem__):
                if budget <= 0:
                    break
                take = min(budget, prompt[i] + gen[i] - cached[i])
                prefills.append((i, take))
                budget -= take
        else:
            for i in rr:
                if needs_prefill(i):
                    prefills.append((i, prompt[i] + gen[i] - cached[i]))

        # ---- enforce the KV-capacity invariant by preempting youngest ----
        planned = {i: cached[i] for i in rr}
        for i in decoders:
            planned[i] += 1
        for i, take in prefills:
            planned[i] += take
        projected = sum(kvt[c] for c in planned.values())
        while projected > cap and len(rr) > 1:
            victim = max(rr, key=aseq.__getitem__)
            rr.remove(victim)
            if victim in decoders:
                decoders.remove(victim)
            prefills = [(i, n) for i, n in prefills if i != victim]
            del planned[victim]
            cached[victim] = 0
            self._rec_col[victim].preemptions += 1
            res.preemptions += 1
            if self._tr_req:
                self.tracer.instant("preempt", self.now, self.name,
                                    rid=self._rid_col[victim],
                                    generated=gen[victim])
            pendq.appendleft(victim)
            projected = sum(kvt[c] for c in planned.values())
        if projected > res.peak_kv:
            res.peak_kv = projected
        if self._paged:
            kvx = self._kvx
            exact = sum(kvx[c] for c in planned.values())
            if projected - exact > res.peak_kv_waste:
                res.peak_kv_waste = projected - exact

        # ---- price the iteration ----
        t_iter = 0.0
        if prefills and not chunked:
            s_pad = max(take for _, take in prefills)
            ctx_end = max(cached[i] + take for i, take in prefills)
            t_iter += cost.prefill_time(s_pad, ctx_end=ctx_end, batch=len(prefills))
        else:
            for i, take in prefills:
                t_iter += cost.prefill_time(
                    take, ctx_end=cached[i] + take,
                    with_head=cached[i] + take == prompt[i] + gen[i])
        if decoders:
            ctx_mean = sum(cached[i] + 1 for i in decoders) / len(decoders)
            t_iter += cost.decode_step_time(len(decoders), ctx_mean)
            res.decode_steps += 1
        # lint: disable-next=U303 -- exact sentinel: a priced iteration is
        # strictly positive; 0.0 means nothing was scheduled
        if t_iter == 0.0 and not pendq and not rr:
            return []
        t_iter = self._slowed(t_iter)
        self.now += t_iter
        res.iterations += 1
        res.busy_s += t_iter

        # ---- apply state transitions at iteration end ----
        done: list[ReqRecord] = []
        for i in decoders:
            cached[i] += 1
        for i, take in prefills:
            cached[i] += take
        for i in list(rr):
            if prompt[i] + gen[i] - cached[i] == 0 and gen[i] < output[i]:
                gen[i] += 1
                rec = self._rec_col[i]
                if rec.first_token < 0:
                    rec.first_token = self.now
                if gen[i] >= output[i]:
                    rec.finish = self.now
                    rr.remove(i)
                    self._rids.discard(self._rid_col[i])
                    done.append(rec)
        if res.iterations > _MAX_ITERATIONS:
            raise RuntimeError("simulation did not converge (check token_budget/kv)")
        self._kv_dirty = True  # before sampling: the counter reads kv_used
        if self._tr_rep:
            self._sample_counters()
        return done
