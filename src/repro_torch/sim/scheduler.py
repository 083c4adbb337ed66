"""Discrete-event serving scheduler over analytical step costs.

The simulator advances in engine iterations (the unit real continuous-
batching servers schedule at), pricing each iteration with
`ServingCostModel` instead of a wall clock. Three policies:

  * static     — classic static batching: wait for the engine to go idle,
                 admit up to `slots` queued requests, pad prompts to the
                 batch max, decode until the LONGEST request finishes.
  * continuous — slot-based continuous batching (Orca-style): free slots
                 are refilled every iteration; admitted prompts are
                 prefilled whole, finished requests free their slot (and
                 KV) immediately.
  * chunked    — continuous + chunked prefill under a per-iteration token
                 budget: each iteration spends one budget token per live
                 decoder and the remainder on head-of-line prefill chunks,
                 bounding inter-token stalls behind long prompts.

Admission order is pluggable: `fcfs` (arrival order, head-of-line blocks)
or `edf` (earliest TTFT deadline first, deadline = arrival + slo_ttft with
per-request overrides from `SimRequest.slo_ttft`) — EDF reorders admission
only, never preempts for priority.

KV accounting follows §3.5: per-sequence cache bytes at the current
processed context, checked every iteration against the model's KV budget.
When projected growth exceeds capacity the youngest-admitted request is
preempted (KV dropped, request returned to the head of the queue) and
later resumed by re-prefilling prompt + already-emitted tokens — the
recompute-style preemption vLLM uses. The capacity invariant (`peak_kv <=
kv_capacity`) is enforced, not just sampled. With a page-granular cost
model (`kv_block_tokens > 0`) the same checks run on page allocations and
the internal fragmentation is reported as `SimResult.peak_kv_waste`.

Token semantics mirror `ServeEngine`: completing a prefill yields the
first output token directly from the prefill logits; each decode step
processes the last emitted token and yields the next, so a request with
`output` tokens costs one prefill + `output - 1` decode steps.

`ReplicaSim` is the incremental (steppable) form of the event loop:
`push()` enqueues requests at any time — optionally with pre-materialized
KV (`cached`/`generated`), which is how prefix-cache hits and
disaggregated prefill->decode handoffs enter mid-stream — and `step()`
executes exactly one engine iteration, returning the records that
finished in it. `simulate()` is the run-to-completion driver over one
replica; a cluster simulator (`repro_torch.cluster`) interleaves
many replicas on a shared timeline.

A copy of `repro.sim.scheduler` (the port imports nothing of the JAX package);
`tests/test_torch_sim.py` holds it to the original bit for bit.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.sim.costmodel import ServingCostModel
from repro_torch.sim.workload import SimRequest

POLICIES = ("static", "continuous", "chunked")
ADMISSIONS = ("fcfs", "edf")
# engine implementations: "vectorized" is the struct-of-arrays fast core
# (repro_torch.sim.engine_vec), "reference" the original object-per-request loop
# kept for differential testing. Both execute the identical schedule.
ENGINES = ("vectorized", "reference")

_MAX_ITERATIONS = 5_000_000  # runaway guard


@dataclass(frozen=True)
class SchedConfig:
    policy: str = "continuous"
    slots: int = 16  # max concurrent sequences (static: batch size)
    token_budget: int = 512  # chunked: tokens processed per iteration
    kv_capacity: float | None = None  # bytes; None -> cost.kv_capacity_bytes
    admission: str = "fcfs"  # fcfs | edf (earliest TTFT deadline first)
    slo_ttft: float = 2.0  # EDF deadline offset for requests without their own


@dataclass
class ReqRecord:
    rid: int
    arrival: float
    prompt: int
    output: int
    admitted: float = -1.0
    first_token: float = -1.0
    finish: float = -1.0
    preemptions: int = 0

    @property
    def ttft(self) -> float:
        """Time to first token, seconds from arrival."""
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float:
        """Mean inter-token time after the first (0 for single-token outputs)."""
        if self.output <= 1:
            return 0.0
        return (self.finish - self.first_token) / (self.output - 1)

    @property
    def e2e(self) -> float:
        """End-to-end latency, seconds from arrival to last token."""
        return self.finish - self.arrival


@dataclass
class SimResult:
    policy: str
    records: list[ReqRecord]
    admit_order: list[int]  # rids in first-admission order (FCFS witness)
    iterations: int = 0
    decode_steps: int = 0
    preemptions: int = 0
    peak_kv: float = 0.0
    kv_capacity: float = 0.0
    busy_s: float = 0.0  # summed iteration time (utilization numerator)
    peak_kv_waste: float = 0.0  # paged-KV internal fragmentation at the peak

    @property
    def makespan(self) -> float:
        """Seconds from the first arrival to the last finish (0 if empty)."""
        if not self.records:
            return 0.0
        return max(r.finish for r in self.records) - min(r.arrival for r in self.records)


@dataclass
class _Run:
    """Live request state. `cached` = context tokens materialized in KV;
    deficit = prompt + generated - cached (1 while decoding normally)."""

    req: SimRequest
    rec: ReqRecord
    cached: int = 0
    generated: int = 0
    admit_seq: int = -1

    @property
    def prefill_target(self) -> int:
        """Context tokens the KV must hold before the next logits: the
        prompt plus every already-emitted token (re-built after preemption)."""
        return self.req.prompt + self.generated

    @property
    def deficit(self) -> int:
        return self.prefill_target - self.cached

    @property
    def needs_prefill(self) -> bool:
        return self.cached < self.req.prompt if self.generated == 0 else self.deficit > 1

    @property
    def done(self) -> bool:
        return self.generated >= self.req.output


class ReplicaSim:
    """One serving replica as a steppable discrete-event simulation."""

    def __init__(self, cost: ServingCostModel, sc: SchedConfig | None = None,
                 *, name: str = "", tracer=None):
        sc = sc or SchedConfig()
        if sc.policy not in POLICIES:
            raise ValueError(f"unknown policy {sc.policy!r}; choose from {POLICIES}")
        if sc.admission not in ADMISSIONS:
            raise ValueError(
                f"unknown admission {sc.admission!r}; choose from {ADMISSIONS}")
        if sc.slots < 1:
            raise ValueError("slots must be >= 1")
        if sc.policy == "chunked" and sc.token_budget < sc.slots:
            raise ValueError(
                "chunked prefill needs token_budget >= slots "
                "(each live slot consumes one decode token per iteration)")
        self.cost = cost
        self.sc = sc
        self.name = name
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # hoisted level gates: the untraced hot path pays one bool test
        self._tr_rep = self.tracer.wants("replica")
        self._tr_req = self.tracer.wants("request")
        self.cap = sc.kv_capacity if sc.kv_capacity is not None else cost.kv_capacity_bytes
        self.now = 0.0
        self.res = SimResult(sc.policy, [], [], kv_capacity=self.cap)
        self._pending: deque[_Run] = deque()
        self._running: list[_Run] = []
        self._admit_seq = 0
        self._rids: set[int] = set()
        self._paged = getattr(cost, "kv_block_tokens", 0) > 0
        # straggler window: iterations priced while `_slow_from <= now <
        # _slow_until` are stretched by `_slow_factor` (chaos injection)
        self._slow_factor = 1.0
        self._slow_from = 0.0
        self._slow_until = 0.0
        # static-batching state
        self._batch: list[_Run] = []
        self._spad = 0
        self._k = 0

    # ------------------------------------------------------------- inspection
    @property
    def has_work(self) -> bool:
        """True while any request is queued, admitted, or mid-batch."""
        return bool(self._pending or self._running or self._batch)

    @property
    def queue_len(self) -> int:
        """Requests waiting for admission (count)."""
        return len(self._pending)

    @property
    def live(self) -> int:
        """Admitted requests currently holding KV (count)."""
        return len(self._running) + len(self._batch)

    @property
    def kv_used(self) -> float:
        """KV-cache bytes held by live requests right now."""
        return sum(self.cost.kv_bytes(r.cached)
                   for r in self._running + self._batch)

    # ---------------------------------------------------------------- enqueue
    def _check_push(self, req: SimRequest, cached: int, generated: int) -> None:
        """Admission-time validation shared by both engine implementations
        (the error messages are part of the contract parity tests pin)."""
        if req.rid in self._rids:
            raise ValueError(f"duplicate rid {req.rid}")
        if req.prompt < 1 or req.output < 1:
            raise ValueError(
                f"request {req.rid} has prompt={req.prompt}, output={req.output}; "
                "both must be >= 1")
        need = self.cost.kv_bytes(req.prompt + req.output)
        if need > self.cap:
            raise ValueError(
                f"request {req.rid} needs {need / 1e9:.2f} GB KV at full context "
                f"but the budget is {self.cap / 1e9:.2f} GB — it can never be served")
        if generated < 0 or generated >= req.output:
            raise ValueError(f"push generated={generated} outside [0, output)")
        if cached < 0 or req.prompt + generated - cached < 1:
            raise ValueError(
                f"push cached={cached} leaves no tokens to process "
                f"(prompt={req.prompt}, generated={generated})")
        if self.sc.policy == "static" and (cached > 0 or generated > 0):
            raise ValueError(
                "static batching cannot enter mid-stream (pre-materialized "
                "cached/generated KV state); use continuous or chunked")

    def push(self, req: SimRequest, *, cached: int = 0, generated: int = 0) -> ReqRecord:
        """Enqueue a request. `cached`/`generated` pre-materialize KV state:
        a prefix-cache hit enters with `cached < prompt`, a disaggregated
        decode handoff with `cached == prompt, generated == 1`."""
        self._check_push(req, cached, generated)
        rec = ReqRecord(req.rid, req.arrival, req.prompt, req.output)
        self.res.records.append(rec)
        self._rids.add(req.rid)
        self._pending.append(_Run(req, rec, cached=cached, generated=generated))
        return rec

    def set_slowdown(self, factor: float, until: float,
                     *, start: float | None = None) -> None:
        """Stretch every iteration priced inside `[start, until)` by
        `factor` — a straggler: the replica keeps serving, just slower
        (thermal throttling, a noisy neighbour, a flaky NIC). Takes
        effect from the next priced iteration; an iteration already in
        flight is not repriced. Overlapping windows merge to the worst
        factor over their union."""
        if factor < 1.0:
            raise ValueError("slowdown factor must be >= 1.0")
        start = self.now if start is None else start
        if start < self._slow_until and until > self._slow_from:
            factor = max(factor, self._slow_factor)
            start = min(start, self._slow_from)
            until = max(until, self._slow_until)
        self._slow_factor, self._slow_from, self._slow_until = factor, start, until

    def _slowed(self, t_iter: float) -> float:
        if self._slow_from <= self.now < self._slow_until:
            return t_iter * self._slow_factor
        return t_iter

    def kill(self) -> list[tuple[SimRequest, int, int, bool]]:
        """Crash the replica: every unfinished request (queued, admitted,
        mid-decode) loses its KV and is withdrawn as if never pushed here
        — records of work in flight are removed, finished records
        survive. Returns `(req, cached, generated, started)` per
        withdrawn request, admitted work first, so the cluster can
        re-dispatch the displaced stream (re-prefilling from scratch or
        restoring from a surviving replica's prefix cache) and account
        the lost tokens. Unlike `evict_pending` this is not graceful:
        admitted work is abandoned too."""
        out: list[tuple[SimRequest, int, int, bool]] = []
        for r in self._running + self._batch + list(self._pending):
            started = r.rec.admitted >= 0 or r.generated > 0
            out.append((r.req, r.cached, r.generated, started))
            self.res.records.remove(r.rec)
            self._rids.discard(r.req.rid)
        self._pending.clear()
        self._running.clear()
        self._batch = []
        return out

    def evict_pending(self, *, include_staged: bool = False) -> list[SimRequest]:
        """Remove and return queued requests that were never admitted (no
        slot, no KV, no emitted tokens here) — the graceful-drain contract:
        a replica leaving the fleet runs out everything it has started
        (including preempted-and-requeued work, which has already emitted
        tokens) but hands untouched arrivals back for re-routing. The
        evicted requests' records are withdrawn as if never pushed here.

        `include_staged` also evicts never-admitted requests that entered
        with pre-materialized KV state (`cached`/`generated` > 0): a
        draining DECODE replica's queued-but-unstarted handoffs, which the
        cluster re-routes to the surviving pool members so the drain does
        not have to wait behind a cold queue. Admitted work is never
        evicted in either mode."""
        keep: deque[_Run] = deque()
        out: list[SimRequest] = []
        for r in self._pending:
            staged = r.cached > 0 or r.generated > 0
            if r.rec.admitted < 0 and (include_staged or not staged):
                out.append(r.req)
                self.res.records.remove(r.rec)
                self._rids.discard(r.req.rid)
            else:
                keep.append(r)
        self._pending = keep
        return out

    # ------------------------------------------------------------- event loop
    def step(self) -> list[ReqRecord]:
        """Execute one engine iteration; returns records that finished."""
        if not self.has_work:
            return []
        if self.sc.policy == "static":
            return self._step_static()
        return self._step_continuous()

    def run_until(self, t: float) -> list[ReqRecord]:
        """Advance while there is work and the clock is behind `t`."""
        out: list[ReqRecord] = []
        while self.has_work and self.now < t:
            out += self.step()
        return out

    def run(self) -> list[ReqRecord]:
        """Drain everything queued (run-to-completion)."""
        out: list[ReqRecord] = []
        while self.has_work:
            out += self.step()
        return out

    def advance_chunk(self, t_limit: float, *, single: bool = False,
                      stop_on_done: bool = False,
                      ) -> list[tuple[float, list[ReqRecord]]]:
        """`run_until` that reports each completing iteration's start
        clock — the batched cluster loop's merge key (see
        `repro_torch.sim.engine_vec.VecReplicaSim.advance_chunk` for the
        accelerated override and the flag semantics). This base version
        steps one iteration at a time, so a reference (or static-policy)
        replica can participate in a vectorized fleet unchanged."""
        out: list[tuple[float, list[ReqRecord]]] = []
        while self.has_work and self.now < t_limit:
            start = self.now
            done = self.step()
            if done:
                out.append((start, done))
                if stop_on_done:
                    break
            if single:
                break
        return out

    # ---------------------------------------------------------------- helpers
    def _deadline(self, req: SimRequest) -> float:
        slo = req.slo_ttft if req.slo_ttft is not None else self.sc.slo_ttft
        return req.arrival + slo

    def _next_candidate(self) -> _Run | None:
        """Head of the admission queue under the configured order, or None
        if nothing eligible (arrival <= now) is waiting. Blocking semantics
        are the caller's: if this candidate does not fit, admission stops."""
        if not self._pending:
            return None
        if self.sc.admission == "fcfs":
            cand = self._pending[0]
            return cand if cand.req.arrival <= self.now else None
        best, bkey = None, None
        for r in self._pending:
            if r.req.arrival > self.now:
                continue
            key = (self._deadline(r.req), r.req.arrival, r.req.rid)
            if best is None or key < bkey:
                best, bkey = r, key
        return best

    def _next_arrival(self) -> float:
        return min(r.req.arrival for r in self._pending)

    def _sample_counters(self) -> None:
        """Replica-level counter timeline, sampled once per priced
        iteration (guarded by the hoisted `_tr_rep` flag at call sites)."""
        tr, t, track = self.tracer, self.now, self.name
        tr.counter("queue", t, len(self._pending), track)
        tr.counter("live", t, self.live, track)
        tr.counter("kv_used", t, self.kv_used, track)
        tr.counter("busy_s", t, self.res.busy_s, track)

    def _note_kv(self, contexts) -> None:
        """Update peak KV (allocation) and, under paging, peak waste."""
        alloc = sum(self.cost.kv_bytes(c) for c in contexts)
        self.res.peak_kv = max(self.res.peak_kv, alloc)
        if self._paged:
            exact = sum(self.cost.kv_bytes(c, exact=True) for c in contexts)
            self.res.peak_kv_waste = max(self.res.peak_kv_waste, alloc - exact)

    # ----------------------------------------------------------- static batching
    def _step_static(self) -> list[ReqRecord]:
        if self._batch:
            return self._static_decode_step()
        if not self._pending:
            return []
        nxt = self._next_arrival()
        if nxt > self.now:
            self.now = nxt
        # form a batch: admission order up to `slots`, padded-KV projection must fit
        batch: list[_Run] = []
        while len(batch) < self.sc.slots:
            cand = self._next_candidate()
            if cand is None:
                break
            trial = [r.req for r in batch] + [cand.req]
            s_pad = max(r.prompt for r in trial)
            out_max = max(r.output for r in trial)
            if len(trial) * self.cost.kv_bytes(s_pad + out_max) > self.cap and batch:
                break  # head-of-line blocks until the current batch drains
            self._pending.remove(cand)
            batch.append(cand)
        if not batch:
            return []
        B = len(batch)
        s_pad = max(r.req.prompt for r in batch)
        t_admit = self.now
        t_iter = self._slowed(self.cost.prefill_time(s_pad, ctx_end=s_pad, batch=B))
        self.now += t_iter
        self.res.iterations += 1
        self.res.busy_s += t_iter
        self._note_kv([s_pad] * B)
        done: list[ReqRecord] = []
        for r in batch:
            r.rec.admitted = t_admit
            r.rec.first_token = self.now
            self.res.admit_order.append(r.req.rid)
            r.generated = 1
            r.cached = s_pad
            if r.req.output <= 1:
                r.rec.finish = self.now
                self._rids.discard(r.req.rid)
                done.append(r.rec)
        if all(r.generated >= r.req.output for r in batch):
            if self._tr_rep:
                self._sample_counters()
            return done  # prefill-only batch; the engine goes idle
        self._batch = batch
        self._spad = s_pad
        self._k = 0
        if self._tr_rep:
            self._sample_counters()
        return done

    def _static_decode_step(self) -> list[ReqRecord]:
        # decode with the full padded batch until the longest request is done
        batch = self._batch
        B = len(batch)
        self._k += 1
        t_iter = self._slowed(self.cost.decode_step_time(B, self._spad + self._k))
        self.now += t_iter
        self.res.iterations += 1
        self.res.decode_steps += 1
        self.res.busy_s += t_iter
        done: list[ReqRecord] = []
        for r in batch:
            if r.generated < r.req.output:
                r.cached += 1  # finished members hold KV at their final context
                r.generated += 1
                if r.generated >= r.req.output:
                    r.rec.finish = self.now
                    self._rids.discard(r.req.rid)
                    done.append(r.rec)
        self._note_kv([r.cached for r in batch])
        if all(r.generated >= r.req.output for r in batch):
            self._batch = []
        if self.res.iterations > _MAX_ITERATIONS:
            raise RuntimeError("static simulation did not converge")
        if self._tr_rep:
            self._sample_counters()
        return done

    # ------------------------------------------------- continuous / chunked-prefill
    def _step_continuous(self) -> list[ReqRecord]:
        cost, sc, cap = self.cost, self.sc, self.cap
        running, pending, res = self._running, self._pending, self.res
        chunked = sc.policy == "chunked"
        if not running and pending:
            nxt = self._next_arrival()
            if nxt > self.now:
                self.now = nxt
        # ---- admission into free slots (optimistic KV check) ----
        kv_now = sum(cost.kv_bytes(r.cached) for r in running)
        while len(running) < sc.slots:
            cand = self._next_candidate()
            if cand is None:
                break
            need = cost.kv_bytes(cand.req.prompt + cand.generated + 1)
            if kv_now + need > cap:
                break  # blocking: later candidates must not jump the queue
            pending.remove(cand)
            if cand.rec.admitted < 0:
                cand.rec.admitted = self.now
                res.admit_order.append(cand.req.rid)
            cand.admit_seq = self._admit_seq
            self._admit_seq += 1
            running.append(cand)
            kv_now += need  # reserve the projected bytes, not the current 0

        # ---- plan this iteration's work ----
        decoders = [r for r in running if not r.needs_prefill and r.generated >= 1]
        prefills: list[tuple[_Run, int]] = []  # (run, tokens this iteration)
        if chunked:
            budget = sc.token_budget - len(decoders)
            for r in sorted((x for x in running if x.needs_prefill),
                            key=lambda x: x.admit_seq):
                if budget <= 0:
                    break
                take = min(budget, r.prefill_target - r.cached)
                prefills.append((r, take))
                budget -= take
        else:
            for r in running:
                if r.needs_prefill:
                    prefills.append((r, r.prefill_target - r.cached))

        # ---- enforce the KV-capacity invariant by preempting youngest ----
        # lint: disable-next=D104 -- identity map: keys are only ever looked
        # up, iteration stays in `running` (admission) order
        planned = {id(r): r.cached for r in running}
        for r in decoders:
            planned[id(r)] += 1  # lint: disable=D104 -- identity lookup
        for r, take in prefills:
            planned[id(r)] += take  # lint: disable=D104 -- identity lookup
        projected = sum(cost.kv_bytes(c) for c in planned.values())
        while projected > cap and len(running) > 1:
            victim = max(running, key=lambda r: r.admit_seq)
            running.remove(victim)
            if victim in decoders:
                decoders.remove(victim)
            prefills = [(r, n) for r, n in prefills if r is not victim]
            del planned[id(victim)]  # lint: disable=D104 -- identity lookup
            victim.cached = 0
            victim.rec.preemptions += 1
            res.preemptions += 1
            if self._tr_req:
                self.tracer.instant("preempt", self.now, self.name,
                                    rid=victim.req.rid,
                                    generated=victim.generated)
            pending.appendleft(victim)
            projected = sum(cost.kv_bytes(c) for c in planned.values())
        self._note_kv(list(planned.values()))

        # ---- price the iteration ----
        t_iter = 0.0
        if prefills and not chunked:
            # whole-prompt prefills admitted together run as ONE padded batch
            # (what ServeEngine._admit and the static path do); the span covers
            # any prefix-cached context the batch resumes from
            s_pad = max(take for _, take in prefills)
            ctx_end = max(r.cached + take for r, take in prefills)
            t_iter += cost.prefill_time(s_pad, ctx_end=ctx_end, batch=len(prefills))
        else:
            for r, take in prefills:
                # only the chunk completing the prompt produces sampled logits
                t_iter += cost.prefill_time(
                    take, ctx_end=r.cached + take,
                    with_head=r.cached + take == r.prefill_target)
        if decoders:
            ctx_mean = sum(r.cached + 1 for r in decoders) / len(decoders)
            t_iter += cost.decode_step_time(len(decoders), ctx_mean)
            res.decode_steps += 1
        # lint: disable-next=U303 -- exact sentinel: a priced iteration is
        # strictly positive; 0.0 means nothing was scheduled
        if t_iter == 0.0 and not pending and not running:
            return []
        t_iter = self._slowed(t_iter)
        self.now += t_iter
        res.iterations += 1
        res.busy_s += t_iter

        # ---- apply state transitions at iteration end ----
        done: list[ReqRecord] = []
        for r in decoders:
            r.cached += 1
        for r, take in prefills:
            r.cached += take
        for r in list(running):
            if r.deficit == 0 and not r.done:  # logits available -> emit token
                r.generated += 1
                if r.rec.first_token < 0:
                    r.rec.first_token = self.now
                if r.done:
                    r.rec.finish = self.now
                    running.remove(r)
                    self._rids.discard(r.req.rid)
                    done.append(r.rec)
        if res.iterations > _MAX_ITERATIONS:
            raise RuntimeError("simulation did not converge (check token_budget/kv)")
        if self._tr_rep:
            self._sample_counters()
        return done


def emit_record_spans(tracer, records, track: str = "") -> None:
    """Emit single-replica lifecycle spans (queued -> prefill -> decode)
    and a `request.complete` terminal for each finished record. The
    cluster engine does NOT use this — it stitches richer disaggregated
    lifecycles (handoff, decode_wait) itself in `_ClusterEngine.result`."""
    for rec in records:
        rid = rec.rid
        if rec.admitted >= 0:
            tracer.span("queued", rec.arrival, rec.admitted, track, rid=rid)
        if rec.first_token >= 0 and rec.admitted >= 0:
            tracer.span("prefill", rec.admitted, rec.first_token, track, rid=rid)
        if rec.finish >= 0 and rec.first_token >= 0:
            tracer.span("decode", rec.first_token, rec.finish, track, rid=rid)
            tracer.instant("request.complete", rec.finish, track, rid=rid,
                           ttft=rec.ttft, tpot=rec.tpot, e2e=rec.e2e)


def make_replica_sim(cost: ServingCostModel, sc: SchedConfig | None = None,
                     *, engine: str = "vectorized", name: str = "",
                     tracer=None) -> ReplicaSim:
    """Instantiate a replica simulation under the chosen engine. The
    vectorized core covers continuous/chunked scheduling; static batching
    (a cold path — whole-batch admission, no mid-stream entry) always runs
    on the reference engine, which is exact by construction."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    policy = (sc or SchedConfig()).policy
    if engine == "vectorized" and policy != "static":
        from repro_torch.sim.engine_vec import VecReplicaSim  # local: avoid cycle
        return VecReplicaSim(cost, sc, name=name, tracer=tracer)
    return ReplicaSim(cost, sc, name=name, tracer=tracer)


def simulate(requests: list[SimRequest], cost: ServingCostModel,
             sc: SchedConfig | None = None, *, tracer=None,
             slowdown: tuple[float, float, float] | None = None,
             engine: str = "vectorized") -> SimResult:
    """Run one replica to completion over a whole request list.
    `slowdown=(factor, start, duration)` injects a straggler window —
    iterations priced inside `[start, start + duration)` are stretched by
    `factor` (see `ReplicaSim.set_slowdown`). `engine` selects the
    vectorized fast core or the reference loop (identical results; see
    docs/performance.md for the parity contract)."""
    tracer = tracer if tracer is not None else NULL_TRACER
    sim = make_replica_sim(cost, sc, engine=engine, tracer=tracer)
    if slowdown is not None:
        factor, start, duration = slowdown
        sim.set_slowdown(factor, start + duration, start=start)
    for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        sim.push(r)
    sim.run()
    if tracer.wants("request"):
        emit_record_spans(tracer, sim.res.records)
    if tracer.enabled:
        tracer.meta.setdefault("t0", 0.0)
        tracer.meta["horizon"] = max(tracer.meta.get("horizon", 0.0), sim.now)
    return sim.res
