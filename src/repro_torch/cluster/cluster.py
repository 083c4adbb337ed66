"""Multi-replica serving cluster simulator with dynamic fleet membership.

Composes N `repro_torch.sim.ReplicaSim` replicas under one shared arrival
stream. Requests are dispatched by a pluggable router at their arrival
instant (replicas are co-simulated event-by-event, so the router observes
replica state at the dispatch time); each replica then prices its own
engine iterations with its own `ServingCostModel`, so heterogeneous
hardware / parallelism / scheduler mixes are first-class.

Two cluster organizations:

  * colocated     — every replica is a `mixed` pool member serving whole
                    requests (prefill + decode), the classic data-parallel
                    deployment.
  * disaggregated — `prefill` replicas run prompt processing only (the
                    first token streams out of the prefill logits), then
                    hand the sequence's KV cache to a `decode` replica
                    over a `comm.p2p`-priced transfer (volume from §3.5's
                    `kv_cache_bytes` via `kv_handoff_bytes`); the decode
                    replica resumes mid-stream via `ReplicaSim.push(
                    cached=prompt, generated=1)`. The transfer sits
                    between the first and second token, where it belongs
                    in the TPOT accounting.

The fleet itself is dynamic when `simulate_cluster(..., autoscale=)` is
given an `AutoscaleConfig`: a control loop fires every `interval` seconds,
evaluates the policy (reactive rate/SLO-debt tracking, or the predictive
M/G/1 envelope policy — see `repro_torch.cluster.autoscale`), and replicas join
(after a weight-loading warmup priced from the cost model) or leave
(graceful drain: no new admissions, in-flight work runs out, untouched
queued arrivals are re-routed) mid-stream. Per-replica provisioning spans
are billed so diurnal fleets report replica-hours against the
static-peak-provisioned fleet that serves the same trace.

Disaggregated fleets can scale their pools INDEPENDENTLY: pass
`autoscale={"prefill": asc_p, "decode": asc_d}` and each pool runs its
own control loop on its own signal (prefill on admission-queue wait,
decode on KV pressure + TPOT debt are the natural pairings) with its own
bounds and interval, instead of growing both pools by the spec's template
ratio even when only one is the bottleneck. Handoff routing tolerates
mid-stream pool-size changes: transfers are routed among the decode
replicas accepting at the instant the KV arrives, and a draining decode
replica's queued-but-unstarted handoffs are re-routed to the survivors.

With `ClusterSpec.prefix_cache` set, prompt-prefix reuse is MODELED
rather than assumed: each prefilling replica runs a finite-byte LRU/TTL
prefix cache (`repro_torch.cluster.prefixcache`) carved out of its KV
capacity, requests' shared prefixes (explicit `prefix_group`s shared
across sessions, or per-session conversation history) become resident at
dispatch and expire/evict under pressure, and every prefill discount is
computed from the tokens ACTUALLY resident at the dispatch instant.
Draining or retiring a replica invalidates its cache, so autoscale churn
pays a measurable re-warm cost.

Optionally the cluster sheds load instead of queueing without bound:
when every eligible replica's depth is at `shed_depth`, the arrival is
retried after a seeded exponential backoff with jitter (base
`retry_after`, up to `max_retries` times) and then dropped. Every
generated request is therefore exactly once completed or shed — an
invariant the tests pin, and that survives fault injection: with
`ClusterSpec.chaos` set, seeded replica crashes, stragglers, link
degradations, and correlated node failures (`repro_torch.cluster.chaos`) are
merged into the event loop, crash-displaced requests re-enter dispatch
(re-prefilling or restoring from a surviving replica's prefix cache),
and anything parked when a pool dies is a counted loss, never a silent
disappearance. `ClusterSpec.admission` adds an overload front door
(token bucket or circuit breaker) that sheds or delays arrivals BEFORE
routing. Chaos off and no door leave the engine bit-identical to the
fault-free path.

Cluster-level records stitch the per-stage records back into one
`ReqRecord` per request (arrival at the cluster, TTFT from the prefill
stage, finish from the decode stage), so `summarize_records` reports the
same SLO vocabulary at replica, pool, and cluster level.

A copy of `repro.cluster.cluster` (the port imports nothing of the JAX package);
`tests/test_torch_cluster.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import bisect
import heapq
from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm as C
from repro_torch.core.hardware import HardwareSpec, NetLevel, get_hardware
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.sim.costmodel import ServingCostModel
from repro_torch.sim.metrics import summarize_records
from repro_torch.sim.scheduler import (
    ENGINES,
    ReplicaSim,
    ReqRecord,
    SchedConfig,
    SimResult,
    make_replica_sim,
)
from repro_torch.sim.workload import SimRequest

from repro_torch.cluster.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.cluster.chaos import (
    AdmissionConfig,
    ChaosConfig,
    make_admission,
    pick_victims,
)
from repro_torch.cluster.prefixcache import (
    FleetPrefixCache,
    PrefixCacheConfig,
    prefix_key,
)
from repro_torch.cluster.router import (
    AffinityRouter,
    JoinShortestQueueRouter,
    LeastKVLoadRouter,
    ReplicaView,
    RoundRobinRouter,
    make_router,
)

# routers whose pick is a pure (depth, kv) argmin over the eligible set:
# the vectorized engine computes it from its O(1) per-replica counters
# instead of materializing `ReplicaView` snapshots (affinity and slo_debt
# read per-request / windowed state and keep the view-based path)
_FAST_ROUTERS = (JoinShortestQueueRouter, RoundRobinRouter, LeastKVLoadRouter)

POOLS = ("mixed", "prefill", "decode")
_INF = float("inf")


@dataclass(frozen=True)
class ReplicaSpec:
    """One replica: a device group running its own serving engine."""

    hw: HardwareSpec | str = "h100"
    tp: int = 1
    prec: int = 2
    pool: str = "mixed"  # mixed | prefill | decode
    sched: SchedConfig = field(default_factory=SchedConfig)
    ctx_quantum: int = 16
    kv_block_tokens: int = 0

    def resolve_hw(self) -> HardwareSpec:
        """The concrete hardware spec (string names are looked up)."""
        return get_hardware(self.hw) if isinstance(self.hw, str) else self.hw

    def cost_key(self) -> tuple:
        """Memoization key: replicas with equal keys share one
        `ServingCostModel` (and its step-cost memo) across the fleet."""
        return (self.resolve_hw().name, self.tp, self.prec,
                self.ctx_quantum, self.kv_block_tokens)

    def build_cost(self, cfg: ModelConfig) -> ServingCostModel:
        """Price `cfg` on this replica's hardware/parallelism/precision."""
        return ServingCostModel(cfg, self.resolve_hw(), tp=self.tp, prec=self.prec,
                                ctx_quantum=self.ctx_quantum,
                                kv_block_tokens=self.kv_block_tokens)


@dataclass(frozen=True)
class ClusterSpec:
    replicas: tuple[ReplicaSpec, ...]
    router: str = "jsq"  # arrival routing (mixed / prefill pool)
    decode_router: str = "least_kv"  # KV-handoff routing (decode pool)
    hit_frac: float = 0.5  # affinity router's prefill-cache discount
    xfer_net: NetLevel | None = None  # None -> decode replica's top net level
    router_slo_ttft: float = 2.0  # slo_debt router's TTFT deadline
    debt_window: float = 30.0  # slo_debt router's rolling window (s)
    # cross-replica load shedding (None = queue without bound)
    shed_depth: int | None = None  # shed when EVERY eligible depth >= this
    retry_after: float = 0.5  # base backoff before a shed arrival is retried
    max_retries: int = 2  # retries before the request is dropped
    # exponential backoff with seeded jitter: retry k (0-based) waits
    # `retry_after * retry_backoff**k * (1 + retry_jitter * U[0,1))` —
    # jitter de-synchronizes a burst that shed together so it does not
    # retry together forever (the thundering-herd fix). The jitter stream
    # is a dedicated `SeedSequence(retry_seed)` spawn, so workload
    # streams are unperturbed; `retry_backoff=1, retry_jitter=0` recovers
    # the legacy fixed delay exactly (and draws no random numbers).
    retry_backoff: float = 2.0
    retry_jitter: float = 0.5
    retry_seed: int = 0
    # modeled prefix cache (None = the legacy unconditional hit_frac
    # discount for the affinity router, no discount for other routers)
    prefix_cache: PrefixCacheConfig | None = None
    # seeded fault injection (None / all-zero rates = chaos off: the
    # engine schedule is bit-identical to the chaos-free engine)
    chaos: ChaosConfig | None = None
    # admission front door (None = every arrival goes straight to routing)
    admission: AdmissionConfig | None = None

    @property
    def disaggregated(self) -> bool:
        """True when the spec separates prefill and decode pools."""
        return any(r.pool != "mixed" for r in self.replicas)

    def pool_indices(self, pool: str) -> list[int]:
        """Template indices of the replicas declared in `pool`."""
        return [i for i, r in enumerate(self.replicas) if r.pool == pool]

    def make_router(self, name: str):
        """Instantiate a dispatch router with this spec's routing knobs."""
        return make_router(name, hit_frac=self.hit_frac,
                           slo_ttft=self.router_slo_ttft,
                           debt_window=self.debt_window)

    def validate(self) -> None:
        """Raise ValueError on inconsistent topology/shedding settings."""
        if not self.replicas:
            raise ValueError("cluster needs at least one replica")
        for r in self.replicas:
            if r.pool not in POOLS:
                raise ValueError(f"unknown pool {r.pool!r}; choose from {POOLS}")
        if self.shed_depth is not None:
            if self.shed_depth < 1:
                raise ValueError("shed_depth must be >= 1")
            if self.retry_after <= 0 or self.max_retries < 0:
                raise ValueError("need retry_after > 0 and max_retries >= 0")
        if self.retry_backoff < 1.0:
            raise ValueError("retry_backoff must be >= 1.0")
        if self.retry_jitter < 0.0:
            raise ValueError("retry_jitter must be >= 0")
        if self.chaos is not None:
            self.chaos.validate()
        if self.admission is not None:
            self.admission.validate()
        if self.disaggregated:
            if self.pool_indices("mixed"):
                raise ValueError(
                    "mixed replicas cannot coexist with prefill/decode pools")
            if not self.pool_indices("prefill") or not self.pool_indices("decode"):
                raise ValueError(
                    "disaggregated cluster needs >= 1 prefill AND >= 1 decode replica")
        # mid-stream entry (KV handoffs, prefix-cache hits) needs a policy
        # that can resume from cached state — static batching cannot
        static = [i for i, r in enumerate(self.replicas)
                  if r.sched.policy == "static"]
        if static and self.disaggregated:
            raise ValueError(
                "static-policy replicas cannot accept disaggregated KV "
                f"handoffs (replicas {static}); use continuous or chunked")
        if static and self.router == "affinity" and self.hit_frac > 0:
            raise ValueError(
                "affinity prefix-cache discounts cannot apply to static-policy "
                f"replicas (replicas {static}); use continuous/chunked or "
                "hit_frac=0")
        if self.prefix_cache is not None:
            self.prefix_cache.validate()
            if static:
                raise ValueError(
                    "prefix-cache hits enter replicas mid-stream, which "
                    f"static-policy replicas (replicas {static}) cannot "
                    "accept; use continuous or chunked")


@dataclass
class ClusterResult:
    mode: str  # colocated | disaggregated
    records: list[ReqRecord]  # cluster-level (stitched across stages)
    replica_results: list[SimResult]
    replica_pools: list[str]
    assignments: dict  # rid -> (serving/prefill replica, decode replica | -1)
    xfer_count: int = 0
    xfer_bytes: float = 0.0
    xfer_seconds: float = 0.0
    prefix_hits: int = 0
    # dynamic-fleet accounting (static clusters: one full-span row each)
    replica_specs: list[ReplicaSpec] = field(default_factory=list)
    replica_spans: list[tuple[float, float]] = field(default_factory=list)
    scale_events: list[dict] = field(default_factory=list)
    shed: list[SimRequest] = field(default_factory=list)
    retries: int = 0
    # requests terminally lost to outages (no accepting replica could
    # ever serve them, or work parked past the horizon) — a subset of
    # `shed` attributable to availability, not overload
    requests_lost: int = 0
    # fault-injection counters (None when chaos is off; see
    # `repro_torch.cluster.chaos`)
    chaos_stats: dict | None = None
    # admission front-door counters (None when no door is configured)
    admission_stats: dict | None = None
    # modeled-prefix-cache counters (None when the cache is not modeled)
    cache_stats: dict | None = None
    # online SLO monitor result (`SLOMonitor.result()`; None unmonitored)
    slo: dict | None = None
    # the trace's time frame: simulation origin and the instant the last
    # replica went quiet — the same end that clamps `replica_spans`, so
    # billing windows and exported trace tracks share one clock
    t0: float = 0.0
    horizon: float = 0.0

    @property
    def makespan(self) -> float:
        """Seconds from the first arrival to the last finish (0 if empty)."""
        if not self.records:
            return 0.0
        return (max(r.finish for r in self.records)
                - min(r.arrival for r in self.records))

    @property
    def span(self) -> float:
        """Billable wall span: `horizon - t0`. Unlike `makespan` (first
        arrival to last finish, a records-only view) this covers the whole
        provisioned timeline, including drains that outlive the last
        completion, and matches the trace's track extents exactly."""
        if self.horizon > self.t0:
            return self.horizon - self.t0
        return self.makespan  # hand-built results without a horizon

    @property
    def replica_hours(self) -> float:
        """Provisioned replica-hours actually billed (warmup included)."""
        return sum(e - s for s, e in self.replica_spans) / 3600.0

    @property
    def replica_hours_static_peak(self) -> float:
        """The counterfactual bill: the peak-concurrency fleet held for
        the whole trace span (what static provisioning for this trace
        costs). Billed over `span`, the same origin->horizon window the
        real `replica_spans` are billed over — pricing the counterfactual
        over the shorter records-makespan used to understate it, skewing
        `savings_frac` for fleets whose drains outlive the last finish."""
        return self.peak_replicas * self.span / 3600.0

    @property
    def peak_replicas(self) -> int:
        """Max concurrently-provisioned replicas — what a static fleet
        sized for this trace's peak would have to run the whole time."""
        return int(peak_over_spans(self.replica_spans))


def peak_over_spans(spans, weights=None) -> float:
    """Sweep-line peak of `sum(weight)` over overlapping (start, end)
    spans — replica counts with unit weights, $/hr rates with prices. At
    equal times releases sort before acquires (negative deltas first), so
    back-to-back spans never count as overlapping."""
    if weights is None:
        weights = [1.0] * len(spans)
    events = sorted((t, d * w) for (s, e), w in zip(spans, weights)
                    for t, d in ((s, 1), (e, -1)))
    cur = peak = 0.0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


# --------------------------------------------------------- dynamic fleet state
@dataclass
class _Rep:
    """One replica's lifecycle inside the engine."""

    sim: ReplicaSim
    spec: ReplicaSpec
    cost: ServingCostModel
    pool: str
    started: float  # provisioning (billing) begins
    ready: float  # accepting traffic from here (started + warmup)
    drain_start: float = -1.0  # >= 0: no new admissions
    retired: float = -1.0  # drained; billing ends
    crashed: bool = False  # retired by fault injection, not a drain

    @property
    def draining(self) -> bool:
        return self.drain_start >= 0.0

    @property
    def provisioned(self) -> bool:
        return self.retired < 0.0 and not self.draining

    def accepting(self, now: float) -> bool:
        return self.provisioned and self.ready <= now


def _views(reps: list[_Rep], idxs: list[int], *,
           at: float = 0.0) -> list[ReplicaView]:
    """Router-facing snapshots. `at` is the dispatch instant: an idle
    replica's own clock stops at its last event, so the view clock must be
    clamped up to the observation time (time-windowed policies like
    slo_debt would otherwise never expire old observations across gaps)."""
    return [ReplicaView(i, max(reps[i].sim.now, at), reps[i].sim.queue_len,
                        reps[i].sim.live, reps[i].sim.kv_used, reps[i].sim.cap)
            for i in idxs]


class _ClusterEngine:
    """Shared event loop for colocated and disaggregated clusters, with
    optional autoscaling and fault injection. Events, in tie-break order
    at equal times: request arrivals, shed-retry re-arrivals, KV-handoff
    completions, autoscaler control ticks, chaos events. Between events
    every replica is advanced to the event time, harvesting completions
    (prefill handoffs, TTFT feedback to the router and autoscaler, drain
    progress)."""

    def __init__(self, spec: ClusterSpec, cfg: ModelConfig,
                 autoscale: AutoscaleConfig | dict | None, cache: dict,
                 tracer=None, monitor=None, engine: str = "vectorized"):
        self.spec = spec
        self.cfg = cfg
        self.cache = cache
        self.engine = engine
        self._vec = engine == "vectorized"
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.monitor = monitor
        if monitor is not None:
            if not self.tracer.enabled:
                # monitor without recording: a sink-only tracer feeds the
                # monitor live and discards the event list
                self.tracer = Tracer("request", keep_events=False)
            self.tracer.add_sink(monitor)
        # hoisted level gates (tracing is purely observational: a traced
        # run executes the identical schedule as an untraced one)
        self._tr_sum = self.tracer.wants("summary")
        self._tr_rep = self.tracer.wants("replica")
        self._tr_req = self.tracer.wants("request")
        self._handoff_log: dict[int, list[tuple[float, float, float]]] = {}
        self.disagg = spec.disaggregated
        self.arrival_pool = "prefill" if self.disagg else "mixed"
        self.router = spec.make_router(spec.router)
        self.d_router = spec.make_router(spec.decode_router)
        # the modeled prefix cache lives on the replicas that prefill;
        # with it bound, the affinity router places by residency and the
        # engine computes every discount from actually resident tokens
        self.pcache: FleetPrefixCache | None = None
        self._counted: dict[int, tuple[int, int]] = {}  # rid -> (replica, hit)
        if spec.prefix_cache is not None:
            self.pcache = FleetPrefixCache(spec.prefix_cache, spec.hit_frac)
            if isinstance(self.router, AffinityRouter):
                self.router.bind_cache(self.pcache)

        # vectorized-engine bookkeeping. A traced run must interleave
        # per-iteration events across replicas exactly as the reference
        # loop does, so tracing forces single-step advances (the batched
        # loop stays on, but every chunk is one iteration).
        self._lockstep = self._vec and self.tracer.enabled
        self._rheap: list[tuple[float, int]] = []  # (clock, idx), lazy
        self._pheap: list[tuple[float, int]] = []  # prefill-pool subset
        self._use_pheap = self._vec and self.disagg and not self._lockstep
        self._hbuf: list = []  # (start, idx, seq, recs) harvest buffer
        self._hseq = 0
        self._depth: list[int] = []  # queued + live, per replica
        self._members: dict[str, list[int]] = {}  # pool -> accepting idxs
        self._warming: dict[str, list[tuple[float, int]]] = {}
        self._draining: set[int] = set()  # drain started, not yet retired

        self.reps: list[_Rep] = []
        for rs in spec.replicas:
            self._add_rep(rs, rs.pool, started=0.0, ready=0.0)
        # KV handoffs price over one fixed link for the whole run: the
        # explicit override, or the first decode replica's top net level
        self.xfer_net = spec.xfer_net
        if self.disagg and self.xfer_net is None:
            d0 = spec.pool_indices("decode")[0]
            self.xfer_net = self.reps[d0].cost.hw.net[-1]
        # scale-up templates cycle over the spec's replicas of each pool
        self._templates = {p: [rs for rs in spec.replicas if rs.pool == p]
                           for p in dict.fromkeys(r.pool for r in spec.replicas)}
        self._tmpl_i = {p: 0 for p in self._templates}

        # autoscaling: one fleet-wide scaler (template-ratio split for
        # disaggregated fleets) or one independent scaler per pool. Each
        # scaler prices its predictive service time / warmup lookahead
        # from its own pool's first template replica.
        self.scaler: Autoscaler | None = None  # fleet-wide mode
        self.pool_scalers: dict[str, Autoscaler] = {}  # pool-aware mode
        if isinstance(autoscale, AutoscaleConfig):
            # the fleet-wide loop sizes the TOTAL count (split by template
            # ratio for disaggregated fleets), so its predictive server
            # model is a whole-request "mixed" replica
            self.scaler = self._make_scaler(autoscale, self.arrival_pool,
                                            service_pool="mixed")
        elif autoscale:
            self.pool_scalers = {pool: self._make_scaler(asc, pool)
                                 for pool, asc in autoscale.items()}
        self._signal_scalers = ([self.scaler] if self.scaler is not None
                                else list(self.pool_scalers.values()))

        self.orig: dict[int, SimRequest] = {}
        self.assignments: dict[int, list[int]] = {}
        self.prefill_recs: dict[int, ReqRecord] = {}
        self.decode_recs: dict[int, ReqRecord] = {}
        self.retry_heap: list[tuple[float, int, int, SimRequest]] = []
        self.xfers: list[tuple[float, int, SimRequest]] = []
        self.seq = 0
        self.shed: list[SimRequest] = []
        self.retries = 0
        self.scale_events: list[dict] = []
        self.xfer_count, self.xfer_bytes, self.xfer_seconds = 0, 0.0, 0.0
        # seeded backoff jitter: a dedicated stream, created lazily so a
        # run that never sheds (or sets retry_jitter=0) draws nothing
        self._retry_rng = None
        # fault injection: chaos off contributes an empty deque, zero RNG
        # draws, and nothing to the event merge (bit-identical runs)
        ch = spec.chaos
        self.chaos_on = ch is not None and ch.enabled
        self.chaos_events = deque(ch.schedule()) if self.chaos_on else deque()
        self._link_windows: list[tuple[float, float, float]] = []
        self.crashes = self.stragglers = self.link_degrades = 0
        self.n_displaced = self.requests_lost = self.stalls = 0
        self.lost_kv_tokens = 0
        self.re_prefill_tokens = self.restored_tokens = 0
        self._displaced: set[int] = set()  # crash-displaced, awaiting re-dispatch
        self._watches: list[dict] = []  # per-crash recovery tracking
        self._watch_by_rid: dict[int, list[dict]] = {}
        # admission front door (evaluated per arrival BEFORE routing; the
        # shed/retry path still applies after dispatch)
        self.door = (make_admission(spec.admission)
                     if spec.admission is not None else None)

    # ----------------------------------------------------------- fleet changes
    def _cost_for(self, rs: ReplicaSpec) -> ServingCostModel:
        key = rs.cost_key()
        if key not in self.cache:
            self.cache[key] = rs.build_cost(self.cfg)
        return self.cache[key]

    def _make_scaler(self, asc: AutoscaleConfig, pool: str,
                     service_pool: str | None = None) -> Autoscaler:
        """Build a control loop priced from `pool`'s first template
        replica; `service_pool` overrides which pool variant the
        predictive E[S] models (defaults to the pool itself)."""
        tmpl = self._templates[pool][0]
        return Autoscaler(asc, cost=self._cost_for(tmpl), sched=tmpl.sched,
                          pool=service_pool or pool)

    def _asc_for(self, pool: str) -> AutoscaleConfig:
        if pool in self.pool_scalers:
            return self.pool_scalers[pool].asc
        return self.scaler.asc

    def _add_rep(self, rs: ReplicaSpec, pool: str, *, started: float,
                 ready: float) -> _Rep:
        cost = self._cost_for(rs)
        sched = rs.sched
        if self.pcache is not None and pool != "decode":
            # carve the cache budget out of the replica's KV capacity:
            # cache warmth and live sequences compete for the same DRAM.
            # The infinite budget (the legacy free-cache assumption) does
            # not carve — that is the bit-for-bit parity anchor.
            full = (sched.kv_capacity if sched.kv_capacity is not None
                    else cost.kv_capacity_bytes)
            budget = self.pcache.pc.budget_for(full)
            if budget > 0 and not self.pcache.pc.infinite:
                seq_cap = full - budget
                if seq_cap <= 0:
                    raise ValueError(
                        f"prefix-cache budget ({budget / 1e9:.2f} GB) leaves "
                        f"no KV capacity for live sequences "
                        f"(replica budget {full / 1e9:.2f} GB)")
                sched = replace(sched, kv_capacity=seq_cap)
            self.pcache.register(len(self.reps), budget, cost)
        rep = _Rep(sim=make_replica_sim(cost, sched, engine=self.engine,
                                        name=f"r{len(self.reps)}:{pool}",
                                        tracer=self.tracer),
                   spec=rs, cost=cost, pool=pool, started=started, ready=ready)
        idx = len(self.reps)
        self.reps.append(rep)
        self._depth.append(0)
        if ready <= started:
            bisect.insort(self._members.setdefault(pool, []), idx)
        else:
            heapq.heappush(self._warming.setdefault(pool, []), (ready, idx))
        return rep

    def _promote(self, pool: str, t: float) -> None:
        """Move replicas whose warmup has elapsed by `t` from the warming
        heap into the pool's accepting set (cancelled/crashed ones are
        skipped lazily — they stopped being provisioned while warming)."""
        wh = self._warming.get(pool)
        if not wh:
            return
        lst = self._members.setdefault(pool, [])
        while wh and wh[0][0] <= t:
            _, i = heapq.heappop(wh)
            if self.reps[i].provisioned:
                bisect.insort(lst, i)

    def _member_remove(self, i: int) -> None:
        lst = self._members.get(self.reps[i].pool)
        if lst:
            k = bisect.bisect_left(lst, i)
            if k < len(lst) and lst[k] == i:
                del lst[k]

    def _push_req(self, i: int, staged: SimRequest, *, cached: int = 0,
                  generated: int = 0) -> ReqRecord:
        """Push one request onto replica `i`, keeping the engine's O(1)
        depth counter current and waking the replica in the vectorized
        advance heap if it was idle (a working replica already has a live
        heap entry at its current clock)."""
        sim = self.reps[i].sim
        idle = not sim.has_work
        rec = sim.push(staged, cached=cached, generated=generated)
        self._depth[i] += 1
        if self._vec and idle:
            heapq.heappush(self._rheap, (sim.now, i))
            if self._use_pheap and self.reps[i].pool == "prefill":
                heapq.heappush(self._pheap, (sim.now, i))
        return rec

    def _pick_fast(self, router, elig: list[int]) -> tuple[int, int]:
        """`router.pick` over the eligible set without building views:
        identical argmin (depth, kv, idx) semantics from the engine's own
        counters. Only called for `_FAST_ROUTERS` policies."""
        depth = self._depth
        reps = self.reps
        if type(router) is JoinShortestQueueRouter:
            # depth 0 means no outstanding work, hence kv_used == 0.0:
            # the first idle index is the exact (depth, kv, idx) argmin,
            # so a lightly loaded fleet picks in O(1) instead of O(fleet)
            best = -1
            bd = -1
            for i in elig:
                d = depth[i]
                if d == 0:
                    best, bd = i, 0
                    break
                if bd < 0 or d < bd:
                    bd = d
            if best < 0:
                bkv = 0.0  # kv_used only breaks depth ties
                for i in elig:
                    if depth[i] == bd:
                        kv = reps[i].sim.kv_used
                        if best < 0 or kv < bkv:
                            best, bkv = i, kv
            router.last_pick = {"router": router.name, "depth": bd}
            return best, 0
        if type(router) is RoundRobinRouter:
            i = elig[router._i % len(elig)]
            router._i += 1
            router.last_pick = {"router": router.name, "slot": router._i - 1}
            return i, 0
        # LeastKVLoadRouter
        best = -1
        bkey = None
        for i in elig:
            sim = reps[i].sim
            frac = sim.kv_used / sim.cap if sim.cap > 0 else 0.0
            key = (frac, depth[i])
            if bkey is None or key < bkey:
                best, bkey = i, key
        router.last_pick = {"router": router.name, "kv_frac": bkey[0],
                            "depth": bkey[1]}
        return best, 0

    def _spawn(self, pool: str, t: float) -> None:
        tmpls = self._templates[pool]
        rs = tmpls[self._tmpl_i[pool] % len(tmpls)]
        self._tmpl_i[pool] += 1
        warm = self._asc_for(pool).warmup_seconds(self._cost_for(rs))
        rep = self._add_rep(rs, pool, started=t, ready=t + warm)
        self.scale_events.append(
            {"t": t, "action": "add", "replica": self.reps.index(rep),
             "pool": pool, "ready": rep.ready})
        if self._tr_sum:
            self.tracer.instant("scale.up", t, rep.sim.name, pool=pool,
                                replica=self.reps.index(rep), ready=rep.ready)

    def _on_retired(self, i: int) -> None:
        """Replica `i` has left the fleet for good: routers prune their
        per-replica state (session pins, debt windows) and the cache model
        drops anything still marked resident there. Indices are never
        reused, so pruning is behavior-neutral — it bounds state growth
        across joins/leaves on long traces."""
        self.router.on_retire(i)
        self.d_router.on_retire(i)
        if self.pcache is not None:
            self.pcache.invalidate(i)

    def _retire(self, i: int, t: float) -> None:
        """Cancel a still-warming replica: it never took traffic; billing
        stops now (the partial warmup was still paid for)."""
        rep = self.reps[i]
        rep.retired = t
        self.scale_events.append(
            {"t": t, "action": "cancel", "replica": i, "pool": rep.pool})
        if self._tr_sum:
            self.tracer.instant("scale.cancel", t, rep.sim.name,
                                pool=rep.pool, replica=i)
        self._on_retired(i)

    def _drain(self, i: int, t: float) -> None:
        rep = self.reps[i]
        rep.drain_start = t
        self._member_remove(i)
        self._draining.add(i)
        self.scale_events.append(
            {"t": t, "action": "drain", "replica": i, "pool": rep.pool})
        if self._tr_sum:
            self.tracer.instant("scale.down", t, rep.sim.name,
                                pool=rep.pool, replica=i)
        if self.pcache is not None:
            # the cache dies with the replica: a draining replica admits
            # nothing new, so its warmth is unreachable from here on and
            # the re-warm cost lands on whichever replicas inherit the
            # traffic (autoscale churn is no longer free)
            if self._tr_sum and i in self.pcache.caches:
                self.tracer.instant(
                    "cache.invalidate", t, rep.sim.name, pool=rep.pool,
                    replica=i,
                    dropped_bytes=self.pcache.caches[i].used_bytes)
            self.pcache.invalidate(i)
        if rep.pool == "decode":
            # queued-but-unstarted KV handoffs re-route to the surviving
            # decode replicas; the cache sits on the draining replica, so
            # the re-route pays a second p2p hop and re-enters the punctual
            # transfer queue (the decode router picks the target when the
            # KV lands, so mid-stream pool changes are tolerated)
            evicted = rep.sim.evict_pending(include_staged=True)
            self._depth[i] -= len(evicted)
            for req in evicted:
                orig = self.orig[req.rid]
                nbytes = rep.cost.kv_handoff_bytes(orig.prompt)
                dt = self._xfer_dt(nbytes, t)
                heapq.heappush(self.xfers, (t + dt, self.seq, orig))
                self.seq += 1
                self.xfer_count += 1
                self.xfer_bytes += nbytes
                self.xfer_seconds += dt
                if self._tr_req:
                    self._handoff_log.setdefault(orig.rid, []).append(
                        (t, t + dt, nbytes))
            return
        evicted = rep.sim.evict_pending()
        self._depth[i] -= len(evicted)
        for req in evicted:
            # stage requests (disagg prefill pushes output=1) map back to
            # the original arrival before re-routing
            self._dispatch(self.orig[req.rid], t, attempt=0)

    def _pool_counts(self, pool: str) -> list[int]:
        return [i for i, r in enumerate(self.reps)
                if r.pool == pool and r.provisioned]

    def _scale_pool(self, pool: str, want: int, t: float) -> None:
        alive = self._pool_counts(pool)
        for _ in range(max(0, want - len(alive))):
            self._spawn(pool, t)
        excess = len(alive) - want
        if excess <= 0:
            return
        # cancel warming replicas first (newest first) — they hold no work
        warming = [i for i in alive if self.reps[i].ready > t]
        for i in sorted(warming, reverse=True)[:excess]:
            self._retire(i, t)
        excess -= min(excess, len(warming))
        if excess <= 0:
            return
        # then drain the emptiest accepting replicas (newest breaks ties),
        # always leaving at least one accepting replica in the pool
        accepting = [i for i in alive if self.reps[i].ready <= t]
        order = sorted(accepting,
                       key=lambda i: (self.reps[i].sim.queue_len
                                      + self.reps[i].sim.live,
                                      self.reps[i].sim.kv_used, -i))
        for i in order[:excess]:
            if len([j for j in accepting if not self.reps[j].draining]) <= 1:
                break
            self._drain(i, t)

    def _pool_kv_frac(self, pool: str, t: float) -> float:
        """Mean KV-occupancy fraction over the pool's accepting replicas —
        the instantaneous half of the `kv_tpot` scaling signal."""
        fracs = [rep.sim.kv_used / rep.sim.cap
                 for rep in self.reps
                 if rep.pool == pool and rep.accepting(t) and rep.sim.cap > 0]
        return sum(fracs) / len(fracs) if fracs else 0.0

    def _tick(self, t: float) -> None:
        """Fleet-wide control tick: one desired count, split across pools
        by the spec's template ratio for disaggregated fleets."""
        provisioned = [r for r in self.reps if r.provisioned]
        # KV pressure lives where the cache is resident: the decode pool
        # on disaggregated fleets (prefill holds KV only transiently)
        kv_pool = "decode" if self.disagg else self.arrival_pool
        want = self.scaler.desired(t, len(provisioned),
                                   kv_frac=self._pool_kv_frac(kv_pool, t))
        if self._tr_sum:
            self.tracer.instant("autoscale.decision", t,
                                pool=self.arrival_pool if not self.disagg
                                else "fleet",
                                **self.scaler.last_decision)
        if self.disagg:
            base_p = len(self.spec.pool_indices("prefill"))
            base_d = len(self.spec.pool_indices("decode"))
            want = max(want, 2)  # structural floor: >= 1 per pool
            want_p = max(1, min(want - 1,
                                round(want * base_p / (base_p + base_d))))
            self._scale_pool("prefill", want_p, t)
            self._scale_pool("decode", want - want_p, t)
        else:
            self._scale_pool("mixed", want, t)

    def _tick_pool(self, pool: str, t: float) -> None:
        """Pool-aware control tick: this pool's scaler alone decides this
        pool's size, on this pool's signals (the other pool is untouched)."""
        scaler = self.pool_scalers[pool]
        provisioned = len(self._pool_counts(pool))
        want = scaler.desired(t, provisioned,
                              kv_frac=self._pool_kv_frac(pool, t))
        if self._tr_sum:
            self.tracer.instant("autoscale.decision", t, pool=pool,
                                **scaler.last_decision)
        self._scale_pool(pool, want, t)

    # ------------------------------------------------------------ resilience
    def _retry_delay(self, attempt: int) -> float:
        """Exponential backoff with seeded jitter for retry `attempt`
        (0-based). Jitter spreads a burst that shed together UPWARD from
        the deterministic base, so existing lower bounds (a retry never
        lands before `retry_after`) keep holding."""
        d = self.spec.retry_after * self.spec.retry_backoff ** attempt
        if self.spec.retry_jitter > 0.0:
            if self._retry_rng is None:
                self._retry_rng = np.random.default_rng(
                    np.random.SeedSequence(self.spec.retry_seed).spawn(1)[0])
            d *= 1.0 + self.spec.retry_jitter * float(self._retry_rng.random())
        return d

    def _pool_recoverable(self, pool: str) -> bool:
        """Can `pool` ever accept traffic again? True while any member is
        provisioned (a warming replica starts accepting at `ready`) or a
        control loop exists that will respawn one (scalers always restore
        their pool to >= min_replicas while work is pending)."""
        if any(r.pool == pool and r.provisioned for r in self.reps):
            return True
        return self.scaler is not None or pool in self.pool_scalers

    def _stall(self, req: SimRequest, t: float, attempt: int) -> None:
        """No accepting replica in the arrival pool right now (all
        warming or draining mid-scale-down, or killed by chaos): park the
        request and retry once capacity can exist — or shed it when
        nothing can ever accept again. Stalls do not consume retry
        budget; an outage is not overload."""
        if self._pool_recoverable(self.arrival_pool):
            self.stalls += 1
            heapq.heappush(self.retry_heap,
                           (t + self._retry_delay(attempt), self.seq,
                            attempt, req))
            self.seq += 1
            if self._tr_sum:
                self.tracer.instant("request.stall", t, rid=req.rid,
                                    pool=self.arrival_pool)
        else:
            self._lose(req, t, reason="no_capacity", attempts=attempt)

    def _lose(self, req: SimRequest, t: float, *, reason: str,
              attempts: int = 0) -> None:
        """Terminal availability loss (dead pool, work parked past the
        horizon): counted in `shed` for the exactly-once conservation
        invariant AND in `requests_lost` for the resilience columns."""
        self.shed.append(req)
        self.requests_lost += 1
        self._note_terminal(req.rid, t, ok=False)
        if self._tr_sum:
            self.tracer.instant("request.shed", t, rid=req.rid,
                                reason=reason, attempts=attempts)

    def _note_terminal(self, rid: int, t: float, ok: bool) -> None:
        """Feed a request's terminal outcome to the admission door (the
        circuit breaker's failure signal) and close any crash-recovery
        watches it was displaced into."""
        if self.door is not None:
            self.door.observe(rid, t, ok)
        ws = self._watch_by_rid.pop(rid, None)
        if ws:
            for w in ws:
                w["open"].discard(rid)
                if not w["open"] and w["dt"] is None:
                    w["dt"] = t - w["t0"]
        if not ok:
            self._displaced.discard(rid)

    def _xfer_dt(self, nbytes: float, t: float) -> float:
        """KV-handoff transfer time at `t` — the p2p price stretched by
        any chaos link-degradation window active at the departure."""
        dt = C.p2p(nbytes, self.xfer_net)
        if self._link_windows:
            f = 1.0
            for t0, t1, factor in self._link_windows:
                if t0 <= t < t1:
                    f = max(f, factor)
            dt *= f
        return dt

    def _fire_chaos(self, ev) -> None:
        """Apply one scheduled fault against live fleet state. Victims
        are selected among the replicas alive at the fire instant via the
        event's pre-sampled uniforms; an event with no eligible victim is
        a no-op (the fleet is already dead or fully degraded)."""
        t = ev.t
        if ev.kind == "crash" or ev.kind == "node_failure":
            elig = [i for i, r in enumerate(self.reps) if r.retired < 0]
            victims = pick_victims(ev.picks, elig, ev.count)
            if ev.kind == "node_failure" and victims and self._tr_sum:
                self.tracer.instant("chaos.node_failure", t,
                                    count=len(victims),
                                    replicas=list(victims))
            for i in victims:
                self._crash(i, t)
        elif ev.kind == "straggler":
            elig = [i for i, r in enumerate(self.reps) if r.accepting(t)]
            for i in pick_victims(ev.picks, elig, 1):
                self.reps[i].sim.set_slowdown(ev.factor, t + ev.duration,
                                              start=t)
                self.stragglers += 1
                if self._tr_sum:
                    self.tracer.instant("chaos.straggler", t,
                                        self.reps[i].sim.name, replica=i,
                                        factor=ev.factor,
                                        until=t + ev.duration)
        else:  # link degradation: cluster-wide handoff-interconnect event
            self._link_windows.append((t, t + ev.duration, ev.factor))
            self.link_degrades += 1
            if self._tr_sum:
                self.tracer.instant("chaos.link_degrade", t,
                                    factor=ev.factor, until=t + ev.duration)

    def _crash(self, i: int, t: float) -> None:
        """Kill replica `i` instantly: billing stops now, in-flight KV is
        lost, and every unfinished request re-enters dispatch — where it
        re-prefills from scratch or restores its prefix from a surviving
        replica's cache (`_dispatch` consults the fleet prefix cache as
        usual; `re_prefill_tokens`/`restored_tokens` account the split)."""
        rep = self.reps[i]
        if rep.retired >= 0:
            return
        displaced = rep.sim.kill()
        rep.retired = t
        rep.crashed = True
        self._member_remove(i)
        self._draining.discard(i)
        self._depth[i] = 0
        self.crashes += 1
        self.scale_events.append(
            {"t": t, "action": "crash", "replica": i, "pool": rep.pool})
        if self._tr_sum:
            self.tracer.instant("replica.crash", t, rep.sim.name,
                                pool=rep.pool, replica=i,
                                displaced=len(displaced))
        self._on_retired(i)
        if not displaced:
            return
        watch: set[int] = set()
        for req, cached, generated, started in displaced:
            rid = req.rid
            watch.add(rid)
            if started:
                # work this replica had begun is lost; the re-dispatch
                # below accounts what must be re-processed vs restored
                self._displaced.add(rid)
                self.n_displaced += 1
                self.lost_kv_tokens += cached
            # the dead attempt's handoff spans would disorder the final
            # attempt's lifecycle in the trace: only the serving attempt
            # is kept (the crash instant records the disruption)
            self._handoff_log.pop(rid, None)
        w = {"t0": t, "open": set(watch), "dt": None}
        self._watches.append(w)
        for rid in watch:
            self._watch_by_rid.setdefault(rid, []).append(w)
        for req, _, _, _ in displaced:
            self._dispatch(self.orig[req.rid], t, attempt=0)

    # -------------------------------------------------------------- dispatch
    def _dispatch(self, req: SimRequest, t: float, attempt: int) -> None:
        if self.pcache is not None:
            # a request re-entering dispatch (drain requeue, shed retry)
            # may carry hit/miss accounting from a dispatch whose prefill
            # never ran — retract it; only the dispatch that actually
            # serves the request counts
            prev = self._counted.pop(req.rid, None)
            if prev is not None:
                self.pcache.uncount(*prev)
        if self._vec:
            self._promote(self.arrival_pool, t)
            elig = self._members.get(self.arrival_pool) or []
        else:
            elig = [i for i, r in enumerate(self.reps)
                    if r.pool == self.arrival_pool and r.accepting(t)]
        if not elig:
            # zero accepting replicas (all warming/draining during an
            # aggressive scale-down, or killed by chaos): park and retry
            # instead of crashing on the empty pool
            self._stall(req, t, attempt)
            return
        fast = self._vec and type(self.router) in _FAST_ROUTERS
        views = None if fast else _views(self.reps, elig, at=t)
        if self.spec.shed_depth is not None and (
                min(self._depth[i] for i in elig) if fast
                else min(v.depth for v in views)) >= self.spec.shed_depth:
            if attempt < self.spec.max_retries:
                self.retries += 1
                retry_at = t + self._retry_delay(attempt)
                heapq.heappush(self.retry_heap,
                               (retry_at, self.seq, attempt + 1, req))
                self.seq += 1
                if self._tr_sum:
                    self.tracer.instant("request.retry", t, rid=req.rid,
                                        attempt=attempt + 1,
                                        retry_at=retry_at)
            else:
                self.shed.append(req)
                self._note_terminal(req.rid, t, ok=False)
                if self._tr_sum:
                    # terminal: shed outright, or dropped after retries
                    self.tracer.instant(
                        "request.drop" if attempt > 0 else "request.shed",
                        t, rid=req.rid, reason="queue_full", attempts=attempt)
            return
        i, cached = (self._pick_fast(self.router, elig) if fast
                     else self.router.pick(req, views))
        if self.pcache is not None:
            # modeled residency overrides any router-side discount: the
            # lookup counts the hit, then reserves this request's own
            # prefix on the replica (the prefill that materializes it is
            # now scheduled there), evicting LRU entries to fit
            cached = self.pcache.use(i, req, t)
            if prefix_key(req) is not None:
                self._counted[req.rid] = (i, cached)
            if self._tr_rep:
                self.tracer.counter("cache_bytes", t,
                                    self.pcache.caches[i].used_bytes,
                                    self.reps[i].sim.name)
        if self._displaced and req.rid in self._displaced:
            # crash-displaced work lands again: whatever prefix survives
            # on the chosen replica's cache is restored, the rest of the
            # prompt is re-prefilled from scratch
            self._displaced.discard(req.rid)
            self.re_prefill_tokens += max(0, req.prompt - cached)
            self.restored_tokens += cached
        if self._tr_req:
            self.tracer.instant("dispatch", t, self.reps[i].sim.name,
                                rid=req.rid, replica=i, attempt=attempt,
                                cached=cached, **self.router.last_pick)
        # retried / drain-requeued requests re-enter at the dispatch time
        # (a replica's clock may lag global time when idle, and admission
        # must not predate the re-dispatch); cluster records are stitched
        # back onto the original arrival so TTFT keeps the backoff paid
        staged = replace(req, arrival=t, output=1) if self.disagg \
            else replace(req, arrival=t)
        rec = self._push_req(i, staged, cached=cached)
        if self.disagg:
            # prefill stage ends at the first token; decode happens elsewhere
            self.prefill_recs[req.rid] = rec
        self.assignments[req.rid] = [i, -1]

    def _dispatch_xfer(self, ready: float, req: SimRequest) -> None:
        if self._vec:
            self._promote("decode", ready)
            elig = self._members.get("decode") or []
        else:
            elig = [i for i, r in enumerate(self.reps)
                    if r.pool == "decode" and r.accepting(ready)]
        if not elig:
            # the KV landed but no decode replica can take it (all
            # warming, or killed by chaos): park the transfer until one
            # can — or shed when the pool can never recover
            if self._pool_recoverable("decode"):
                self.stalls += 1
                heapq.heappush(self.xfers,
                               (ready + self.spec.retry_after, self.seq, req))
                self.seq += 1
                if self._tr_sum:
                    self.tracer.instant("request.stall", ready, rid=req.rid,
                                        pool="decode")
            else:
                self._lose(req, ready, reason="no_capacity")
            return
        if self._vec and type(self.d_router) in _FAST_ROUTERS:
            j, _ = self._pick_fast(self.d_router, elig)
        else:
            j, _ = self.d_router.pick(req, _views(self.reps, elig, at=ready))
        self.decode_recs[req.rid] = self._push_req(
            j, replace(req, arrival=ready), cached=req.prompt, generated=1)
        self.assignments[req.rid][1] = j

    # --------------------------------------------------------------- advance
    def _harvest(self, i: int, done: list[ReqRecord]) -> None:
        rep = self.reps[i]
        pool_scaler = self.pool_scalers.get(rep.pool) or self.scaler
        for rec in done:
            if self._tr_sum:
                self._emit_terminal(rep, rec)
            if (self.door is not None or self._watch_by_rid) and (
                    rep.pool != "prefill"
                    or self.orig[rec.rid].output <= 1):
                # last stage of this request finished: feed the admission
                # door's breaker and close any crash-recovery watches
                self._note_terminal(rec.rid, rec.finish, ok=True)
            if rep.pool in ("mixed", "prefill") and rec.first_token >= 0:
                # end-to-end TTFT, from the ORIGINAL arrival: shed-retry
                # backoff counts as debt (the user waited through it), so
                # the signals see the same SLO breach the stitched records
                # report instead of the replica-local staged wait
                ttft = rec.first_token - self.orig[rec.rid].arrival
                self.router.observe(i, rec.finish, ttft)
                if self.pcache is not None:
                    # the prefill completed at the FIRST token (decode
                    # continues after, but the prefix KV became resident
                    # then): refresh recency at that instant so colocated
                    # and disaggregated pools age entries identically
                    self.pcache.commit(i, self.orig[rec.rid], rec.first_token)
                    if self._tr_rep and i in self.pcache.caches:
                        self.tracer.counter(
                            "cache_bytes", rec.first_token,
                            self.pcache.caches[i].used_bytes, rep.sim.name)
                for sc in self._signal_scalers:
                    sc.observe_ttft(rec.finish, ttft)
            if pool_scaler is not None and rec.admitted >= 0:
                # pool-local signals: the admission wait a prefill (or
                # mixed) pool queues prompts behind — end-to-end, so shed
                # backoff counts — and the stage-local handoff wait on a
                # decode pool; TPOT debt from any pool that decodes
                if rep.pool == "decode":
                    wait = rec.admitted - rec.arrival
                    # a FLEET-wide queue_wait signal must see only the
                    # user-facing admission wait; blending near-zero
                    # handoff waits into the same mean would halve it
                    feed_wait = rep.pool in self.pool_scalers
                    # the decode stage's TPOT debt is charged from the
                    # instant the KV landed: queueing behind a full pool
                    # stretches the stitched record's inter-token gap, so
                    # the signal must see it too, not just the post-
                    # admission decode cadence
                    if rec.output > 1:
                        pool_scaler.observe_tpot(
                            rec.finish,
                            (rec.finish - rec.arrival) / (rec.output - 1))
                else:
                    wait = rec.admitted - self.orig[rec.rid].arrival
                    feed_wait = True
                    if rec.output > 1 and rep.pool == "mixed" \
                            and rec.first_token >= 0:
                        pool_scaler.observe_tpot(rec.finish, rec.tpot)
                if feed_wait:
                    pool_scaler.observe_wait(rec.finish, wait)
            if rep.pool != "prefill":
                continue
            req = self.orig[rec.rid]
            if req.output <= 1:
                continue  # single-token request: served entirely by prefill
            nbytes = rep.cost.kv_handoff_bytes(req.prompt)
            dt = self._xfer_dt(nbytes, rec.finish)
            heapq.heappush(self.xfers, (rec.finish + dt, self.seq, req))
            self.seq += 1
            self.xfer_count += 1
            self.xfer_bytes += nbytes
            self.xfer_seconds += dt
            if self._tr_req:
                self._handoff_log.setdefault(req.rid, []).append(
                    (rec.finish, rec.finish + dt, nbytes))

    def _emit_terminal(self, rep: _Rep, rec: ReqRecord) -> None:
        """LIVE `request.complete` emission, at the moment the request's
        last stage finishes — what lets the SLO monitor see completions at
        sim time instead of after the run. Values are end-to-end, stitched
        against the ORIGINAL arrival, identical to the post-run records
        (`result()` builds the same numbers from the same fields)."""
        rid = rec.rid
        orig = self.orig[rid]
        if rep.pool == "mixed":
            ttft = rec.first_token - orig.arrival if rec.first_token >= 0 else 0.0
            tpot = ((rec.finish - rec.first_token) / (rec.output - 1)
                    if rec.output > 1 and rec.first_token >= 0 else 0.0)
        elif rep.pool == "decode":
            pre = self.prefill_recs[rid]
            ttft = pre.first_token - orig.arrival
            tpot = ((rec.finish - pre.first_token) / (rec.output - 1)
                    if rec.output > 1 else 0.0)
        else:  # prefill pool: terminal only for single-token requests
            if orig.output > 1:
                return  # hands off to decode; that stage emits the terminal
            ttft = rec.first_token - orig.arrival if rec.first_token >= 0 else 0.0
            tpot = 0.0
        self.tracer.instant("request.complete", rec.finish, rep.sim.name,
                            rid=rid, ttft=ttft, tpot=tpot,
                            e2e=rec.finish - orig.arrival)

    def _check_drained(self) -> None:
        # `_draining` holds exactly the drain-started, not-yet-retired
        # indices, so this is O(active drains) per event — not O(fleet) —
        # and visiting it in index order matches the reference full scan.
        if not self._draining:
            return
        for i in sorted(self._draining):
            rep = self.reps[i]
            if rep.draining and rep.retired < 0 and not rep.sim.has_work:
                rep.retired = max(rep.sim.now, rep.drain_start)
                self._draining.discard(i)
                self._on_retired(i)
                if self._tr_sum:
                    self.tracer.instant("replica.retired", rep.retired,
                                        rep.sim.name, pool=rep.pool,
                                        replica=i)

    def _advance_all(self, t: float) -> None:
        """Advance every replica to `t` in lockstep (least-clock first),
        dispatching KV handoffs punctually the moment they become ready.

        Each pending handoff's ready time is a sub-target: all replicas
        are stepped up to it BEFORE the handoff is routed, so the decode
        router always observes the fleet as of the dispatch instant. The
        resulting step/dispatch sequence is a global merge ordered by
        (sim clock, handoff ready) and therefore invariant to the
        advance's intermediate targets — advancing to t' then t equals
        advancing straight to t — which is what lets autoscaler control
        ticks observe the fleet without perturbing the schedule (the
        pinned-bounds parity contract).

        The vectorized engine reproduces this exact merge without the
        per-step O(replicas) candidate scan — see `_advance_all_vec`."""
        if self._vec:
            self._advance_all_vec(t)
            return
        while True:
            t_sub = min(t, self.xfers[0][0]) if self.xfers else t
            cands = [(rep.sim.now, i) for i, rep in enumerate(self.reps)
                     if rep.sim.has_work and rep.sim.now < t_sub]
            if cands:
                _, i = min(cands)
                self._harvest(i, self.reps[i].sim.step())
                continue
            if self.xfers and self.xfers[0][0] <= t:
                ready, _, req = heapq.heappop(self.xfers)
                self._dispatch_xfer(ready, req)
                continue
            break
        self._check_drained()

    def _rheap_top(self) -> tuple[float, int] | None:
        """Least (clock, idx) replica that still has work, or None. Stale
        entries (the replica stepped, finished, or was killed since the
        push) are discarded lazily; every working replica always owns one
        live entry at exactly its current clock."""
        h = self._rheap
        while h:
            c, i = h[0]
            sim = self.reps[i].sim
            if sim.has_work and sim.now == c:
                return h[0]
            heapq.heappop(h)
        return None

    def _pheap_top(self, skip: int) -> float:
        """Least clock among the prefill replicas with work, excluding
        `skip` (the replica about to advance; its entry is dropped here
        and re-pushed after the chunk). Bounds how far any replica may
        batch ahead: a new KV handoff's ready time can only be created at
        or after this clock."""
        h = self._pheap
        while h:
            c, i = h[0]
            sim = self.reps[i].sim
            if i == skip or not (sim.has_work and sim.now == c):
                heapq.heappop(h)
                continue
            return c
        return _INF

    def _flush_hbuf(self, bound: tuple[float, int] | None) -> None:
        """Harvest buffered completion batches in global (step start,
        replica idx) order — the exact order the reference loop's merge
        harvests them in — up to (not including) `bound`. `None` flushes
        everything."""
        hb = self._hbuf
        while hb and (bound is None or (hb[0][0], hb[0][1]) < bound):
            _, i, _, recs = heapq.heappop(hb)
            self._depth[i] -= len(recs)
            self._harvest(i, recs)

    def _advance_all_vec(self, t: float) -> None:
        """`_advance_all`, batched: replicas advance in multi-iteration
        chunks instead of one globally-merged step at a time, and
        completions buffer in `_hbuf` until every step that the reference
        merge orders before them has run. Chunk caps keep the merge
        exact:

          * `t_sub` (next handoff ready): same sub-target as the
            reference loop.
          * the least prefill-pool clock: a NEW handoff's ready time is
            `completion + dt`, so it can only appear at or after that
            clock — no other replica may batch past it. Prefill replicas
            additionally stop at their own completions (`stop_on_done`),
            re-evaluating caps once the handoff is on the heap.
          * equal clocks fall back to single steps, preserving the
            reference tie order (idx).

        Colocated fleets have no handoffs: every working replica advances
        straight to `t` in one chunk and the buffer is drained sorted."""
        reps = self.reps
        heap = self._rheap
        while True:
            top = self._rheap_top()
            self._flush_hbuf(top)
            # flushed harvests may have pushed new handoffs: re-read
            t_x = self.xfers[0][0] if self.xfers else _INF
            t_sub = t if t <= t_x else t_x
            if top is None or top[0] >= t_sub:
                if self.xfers and t_x <= t:
                    ready, _, req = heapq.heappop(self.xfers)
                    self._dispatch_xfer(ready, req)
                    continue
                break
            c1, i = heapq.heappop(heap)
            rep = reps[i]
            sim = rep.sim
            stop_done = False
            if self._lockstep:
                cap, single = t_sub, True
            elif not self.disagg:
                cap, single = t, False  # no handoffs: t_sub == t
            else:
                if rep.pool == "prefill":
                    stop_done = True
                c_p = self._pheap_top(i)
                cap = min(t_sub, c_p)
                single = cap <= c1
                if single:
                    cap = t_sub
            for start, recs in sim.advance_chunk(cap, single=single,
                                                 stop_on_done=stop_done):
                heapq.heappush(self._hbuf, (start, i, self._hseq, recs))
                self._hseq += 1
            if sim.has_work:
                heapq.heappush(heap, (sim.now, i))
                if self._use_pheap and rep.pool == "prefill":
                    heapq.heappush(self._pheap, (sim.now, i))
        self._check_drained()

    @property
    def _sim_work(self) -> bool:
        if self._vec:
            return self._rheap_top() is not None
        return any(r.sim.has_work for r in self.reps)

    # -------------------------------------------------------------- main loop
    def run(self, ordered: list[SimRequest]) -> None:
        self.orig = {r.rid: r for r in ordered}
        arrivals = deque(ordered)
        # one tick stream per control loop: the fleet-wide scaler (key
        # None) or each pool's scaler, on its own interval; at equal times
        # pools tick in the spec's pool order (deterministic)
        if self.scaler is not None:
            intervals: dict = {None: self.scaler.asc.interval}
        else:
            intervals = {p: self.pool_scalers[p].asc.interval
                         for p in self._templates if p in self.pool_scalers}
        next_tick = dict(intervals)
        while True:
            t_arr = arrivals[0].arrival if arrivals else _INF
            t_rty = self.retry_heap[0][0] if self.retry_heap else _INF
            t_xfr = self.xfers[0][0] if self.xfers else _INF
            # ticks stop once nothing is pending anywhere (else they'd
            # fire forever); pending work keeps the control loop honest
            pending = bool(arrivals or self.retry_heap or self.xfers
                           or self._sim_work)
            t_tck = min(next_tick.values()) if next_tick and pending else _INF
            # chaos events, like control ticks, fire only while work is
            # pending: faults against a finished fleet change nothing
            t_chs = (self.chaos_events[0].t
                     if self.chaos_events and pending else _INF)
            t_evt = min(t_arr, t_rty, t_xfr, t_tck, t_chs)
            if t_evt == _INF:
                if self._sim_work or self.xfers:
                    self._advance_all(_INF)  # final drain (punctual handoffs)
                    continue
                break
            self._advance_all(t_evt)  # handoffs ready <= t_evt dispatch inside
            if t_arr == t_evt:
                req = arrivals.popleft()
                for sc in self._signal_scalers:
                    sc.observe_arrival(req.arrival)
                if self.door is not None:
                    admit_at = self.door.offer(req.rid, req.arrival)
                    if admit_at is None:
                        # shed at the front door, before any dispatch
                        # attempt: counted in `shed` for conservation but
                        # attributed to the door, not `requests_lost`
                        self.shed.append(req)
                        self._note_terminal(req.rid, req.arrival, ok=False)
                        if self._tr_sum:
                            self.tracer.instant("request.shed", req.arrival,
                                                rid=req.rid,
                                                reason="admission")
                        continue
                    if admit_at > req.arrival:
                        # door-queued: dispatch at the exact conformance
                        # time, through the same heap retries use
                        heapq.heappush(self.retry_heap,
                                       (admit_at, self.seq, 0, req))
                        self.seq += 1
                        continue
                self._dispatch(req, req.arrival, attempt=0)
            elif t_rty == t_evt:
                t, _, attempt, req = heapq.heappop(self.retry_heap)
                self._dispatch(req, t, attempt)
            elif t_tck == t_evt:
                # the advance may have finished the last pending work this
                # tick was gated on; scaling an idle, finished fleet would
                # spawn replicas that never serve (and bill phantom spans)
                still_pending = bool(arrivals or self.retry_heap or self.xfers
                                     or self._sim_work)
                for key in list(next_tick):
                    if next_tick[key] != t_evt:
                        continue
                    if still_pending:
                        if key is None:
                            self._tick(t_evt)
                        else:
                            self._tick_pool(key, t_evt)
                    next_tick[key] += intervals[key]
            elif t_chs == t_evt:
                self._fire_chaos(self.chaos_events.popleft())
            # else: the event was a transfer, consumed by the advance
        # conservation sweep: anything still parked when the run drains
        # (a retry scheduled past the last completion on a dead pool, a
        # handoff stalled forever) is a terminal loss, never a silent
        # disappearance — completed + shed == generated must hold
        while self.retry_heap:
            t, _, attempt, req = heapq.heappop(self.retry_heap)
            self._lose(req, t, reason="horizon", attempts=attempt)
        while self.xfers:
            t, _, req = heapq.heappop(self.xfers)
            self._lose(req, t, reason="horizon")

    # ----------------------------------------------------------------- result
    def result(self) -> ClusterResult:
        shed_rids = {r.rid for r in self.shed}
        if self.disagg:
            records = []
            for req in self.orig.values():
                if req.rid in shed_rids:
                    continue
                pre = self.prefill_recs[req.rid]
                dec = self.decode_recs.get(req.rid)
                records.append(ReqRecord(
                    req.rid, req.arrival, req.prompt, req.output,
                    admitted=pre.admitted, first_token=pre.first_token,
                    finish=dec.finish if dec is not None else pre.finish,
                    preemptions=pre.preemptions
                    + (dec.preemptions if dec else 0)))
            mode = "disaggregated"
        else:
            # stitch back onto the original arrivals (retried requests were
            # re-pushed at their re-dispatch time)
            records = sorted(
                (ReqRecord(rec.rid, self.orig[rec.rid].arrival, rec.prompt,
                           rec.output, admitted=rec.admitted,
                           first_token=rec.first_token, finish=rec.finish,
                           preemptions=rec.preemptions)
                 for rep in self.reps for rec in rep.sim.res.records),
                key=lambda r: r.rid)
            mode = "colocated"
        end = max([rep.sim.now for rep in self.reps]
                  + [rep.retired for rep in self.reps] + [0.0])
        # clamp: a replica spawned near the end of the run (e.g. for a
        # retry that was ultimately shed) must never bill a negative span
        spans = [(rep.started,
                  max(rep.started, rep.retired if rep.retired >= 0 else end))
                 for rep in self.reps]
        if self.tracer.enabled:
            self._emit_trace(records, spans, end, mode)
        slo = None
        if self.monitor is not None:
            self.monitor.finish(end)
            slo = self.monitor.result()
        chaos_stats = None
        if self.chaos_on:
            rec_times = [w["dt"] for w in self._watches if w["dt"] is not None]
            chaos_stats = {
                "crashes": self.crashes,
                "stragglers": self.stragglers,
                "link_degrades": self.link_degrades,
                "displaced": self.n_displaced,
                "lost_kv_tokens": self.lost_kv_tokens,
                "re_prefill_tokens": self.re_prefill_tokens,
                "restored_tokens": self.restored_tokens,
                "stalls": self.stalls,
                "recovery_s_mean": (sum(rec_times) / len(rec_times)
                                    if rec_times else 0.0),
                "recovery_s_max": max(rec_times) if rec_times else 0.0,
            }
        return ClusterResult(
            mode=mode, records=records,
            replica_results=[rep.sim.res for rep in self.reps],
            replica_pools=[rep.pool for rep in self.reps],
            assignments={k: tuple(v) for k, v in self.assignments.items()},
            xfer_count=self.xfer_count, xfer_bytes=self.xfer_bytes,
            xfer_seconds=self.xfer_seconds,
            prefix_hits=(self.pcache.hits if self.pcache is not None
                         else self.router.hits
                         if isinstance(self.router, AffinityRouter) else 0),
            replica_specs=[rep.spec for rep in self.reps],
            replica_spans=spans, scale_events=self.scale_events,
            shed=list(self.shed), retries=self.retries,
            cache_stats=(self.pcache.stats() if self.pcache is not None
                         else None),
            slo=slo, t0=0.0, horizon=end,
            requests_lost=self.requests_lost, chaos_stats=chaos_stats,
            admission_stats=(self.door.stats() if self.door is not None
                             else None))

    def _emit_trace(self, records, spans, end: float, mode: str) -> None:
        """Post-run trace emission: replica structural spans (billing
        tracks, identical to `replica_spans`) and stitched per-request
        lifecycle spans (every rid's single terminal instant was already
        emitted live — `_emit_terminal`/`_dispatch`)."""
        tr = self.tracer
        tr.meta.update(t0=0.0, horizon=end, mode=mode)
        if self._tr_rep:
            for rep, (s, e) in zip(self.reps, spans):
                track = rep.sim.name
                tr.span("provisioned", s, e, track, pool=rep.pool)
                if rep.ready > s:
                    tr.span("warmup", s, min(rep.ready, e), track)
                if rep.draining:
                    drain0 = min(rep.drain_start, e)
                    tr.span("drain", drain0, e, track)
        if not self._tr_req:
            return
        by_rid = {rec.rid: rec for rec in records}
        for req in self.orig.values():
            rec = by_rid.get(req.rid)
            if rec is None:
                continue  # shed/dropped: terminal already emitted live
            rid = req.rid
            serve_i, dec_i = self.assignments.get(rid, (-1, -1))
            track = self.reps[serve_i].sim.name if serve_i >= 0 else ""
            if rec.admitted >= 0:
                tr.span("queued", req.arrival, rec.admitted, track, rid=rid)
            if rec.first_token >= 0 and rec.admitted >= 0:
                tr.span("prefill", rec.admitted, rec.first_token, track,
                        rid=rid)
            dec = self.decode_recs.get(rid) if self.disagg else None
            if dec is not None:
                dtrack = self.reps[dec_i].sim.name if dec_i >= 0 else ""
                for h0, h1, nbytes in self._handoff_log.get(rid, ()):
                    tr.span("handoff", h0, h1, dtrack, rid=rid, bytes=nbytes)
                if dec.admitted >= 0:
                    tr.span("decode_wait", dec.arrival, dec.admitted, dtrack,
                            rid=rid)
                    tr.span("decode", dec.admitted, dec.finish, dtrack,
                            rid=rid)
                track = dtrack
            elif not self.disagg and rec.finish >= 0 and rec.first_token >= 0:
                tr.span("decode", rec.first_token, rec.finish, track, rid=rid)
            # `request.complete` terminals are emitted LIVE in `_harvest`
            # (summary level), so the online monitor sees them at sim time


def simulate_cluster(requests: list[SimRequest], cfg: ModelConfig,
                     spec: ClusterSpec, *,
                     autoscale: AutoscaleConfig | dict | None = None,
                     tracer=None, monitor=None, engine: str = "vectorized",
                     _cost_cache: dict | None = None) -> ClusterResult:
    """Co-simulate the cluster over one shared arrival stream.

    Args:
        requests: the shared arrival stream (any order; sorted internally
            by (arrival, rid)).
        cfg: model config every replica serves.
        spec: fleet topology, routing, and shedding policy.
        autoscale: `None` for a fixed fleet; an `AutoscaleConfig` for one
            fleet-wide control loop (disaggregated fleets split the
            desired count by the spec's template pool ratio); or a
            `{pool: AutoscaleConfig}` dict to scale pools INDEPENDENTLY —
            each listed pool runs its own control loop on its own signals
            and bounds (pools not listed stay at their template size).
            With `autoscale`, `spec.replicas` is the fleet at t=0
            (already warm). A pinned control loop (`min == max == N`)
            reproduces the static cluster step-for-step — in fleet-wide
            AND pool-aware mode (regression-tested).
        tracer: a `repro_torch.obs.Tracer` to record the run (None = untraced;
            tracing is purely observational and never changes the
            schedule — also regression-tested).
        engine: `"vectorized"` (default) advances replicas in batched
            multi-iteration chunks with struct-of-arrays replica state;
            `"reference"` is the original one-globally-merged-step-at-a-
            time loop. Both produce the same schedule (differentially
            tested, see `tests/test_engine_parity.py`); the reference
            engine exists as the oracle for that harness and as a
            fallback while debugging.
        monitor: a `repro_torch.obs.SLOMonitor` to evaluate SLO compliance,
            burn-rate alerts, and anomaly detection ONLINE as the run
            executes. Attached as a tracer sink (a sink-only tracer is
            created when `tracer` is None), equally observational; the
            result lands in `ClusterResult.slo` and alert instants in
            the trace.
        _cost_cache: lets sweeps (the capacity planner) share memoized
            `ServingCostModel`s across many cluster candidates.

    Returns:
        `ClusterResult` with stitched cluster-level records, per-replica
        stage results, billing spans (seconds), and scale events.
    """
    spec.validate()
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if isinstance(autoscale, AutoscaleConfig):
        autoscale.validate()
        if spec.disaggregated and autoscale.max_replicas < 2:
            raise ValueError(
                "disaggregated autoscaling needs max_replicas >= 2 "
                "(>= 1 prefill AND >= 1 decode replica at all times)")
    elif autoscale is not None:
        pools_present = {r.pool for r in spec.replicas}
        for pool, asc in autoscale.items():
            if pool not in pools_present:
                raise ValueError(
                    f"pool-aware autoscale names pool {pool!r} but the "
                    f"spec only has {sorted(pools_present)}")
            if not isinstance(asc, AutoscaleConfig):
                raise ValueError(
                    f"pool-aware autoscale values must be AutoscaleConfig, "
                    f"got {type(asc).__name__} for pool {pool!r}")
            asc.validate()
    cache = _cost_cache if _cost_cache is not None else {}
    eng = _ClusterEngine(spec, cfg, autoscale, cache, tracer, monitor,
                         engine=engine)
    eng.run(sorted(requests, key=lambda r: (r.arrival, r.rid)))
    return eng.result()


# ------------------------------------------------------------------ metrics
def summarize_cluster(cres: ClusterResult, *, slo_ttft: float | None = None,
                      slo_tpot: float | None = None) -> dict:
    """Cluster-level SLO metric dict over the stitched records, plus
    aggregate counters, the KV-transfer overhead share, and the dynamic-
    fleet provisioning economics (replica-hours vs static peak)."""
    span = cres.makespan
    out: dict = {"mode": cres.mode, "replicas": len(cres.replica_results)}
    out.update(summarize_records(cres.records, span=span,
                                 slo_ttft=slo_ttft, slo_tpot=slo_tpot))
    out["iterations"] = sum(r.iterations for r in cres.replica_results)
    out["preemptions"] = sum(r.preemptions for r in cres.replica_results)
    out["prefix_hits"] = cres.prefix_hits
    out["xfer_count"] = cres.xfer_count
    out["xfer_gb"] = cres.xfer_bytes / 1e9
    out["xfer_s_mean"] = (cres.xfer_seconds / cres.xfer_count
                          if cres.xfer_count else 0.0)
    e2e_total = sum(r.e2e for r in cres.records)
    out["xfer_share"] = cres.xfer_seconds / e2e_total if e2e_total > 0 else 0.0
    denom = max(span, 1e-12)
    out["replica_util"] = [r.busy_s / denom for r in cres.replica_results]
    out["shed"] = len(cres.shed)
    total = len(cres.records) + len(cres.shed)
    out["shed_frac"] = len(cres.shed) / total if total else 0.0
    out["retries"] = cres.retries
    out["requests_lost"] = cres.requests_lost
    if cres.chaos_stats is not None:
        ch = cres.chaos_stats
        out["chaos_crashes"] = ch["crashes"]
        out["chaos_stragglers"] = ch["stragglers"]
        out["chaos_link_degrades"] = ch["link_degrades"]
        out["displaced"] = ch["displaced"]
        out["re_prefill_tokens"] = ch["re_prefill_tokens"]
        out["restored_tokens"] = ch["restored_tokens"]
        out["recovery_s_mean"] = ch["recovery_s_mean"]
        out["recovery_s_max"] = ch["recovery_s_max"]
    if cres.admission_stats is not None:
        ad = cres.admission_stats
        out["door_admitted"] = ad["door_admitted"]
        out["door_delayed"] = ad["door_delayed"]
        out["door_shed"] = ad["door_shed"]
        out["breaker_opens"] = ad["breaker_opens"]
    if cres.cache_stats is not None:
        cs = cres.cache_stats
        looked = cs["hits"] + cs["misses"]
        out["cache_hit_tokens"] = cs["hit_tokens"]
        out["cache_hit_rate"] = cs["hits"] / looked if looked else 0.0
        out["cache_resident_gb"] = cs["peak_resident_bytes"] / 1e9
        out["cache_evictions"] = cs["evictions_lru"] + cs["evictions_ttl"]
        out["cache_invalidations"] = cs["invalidations"]
    if cres.slo is not None:
        # online-monitor roll-up (simulated seconds / counts; see
        # `repro_torch.obs.monitor` for the burn-rate semantics)
        out["time_in_violation"] = cres.slo["time_in_violation"]
        out["alerts_fired"] = cres.slo["alerts_fired"]
        out["budget_burn"] = cres.slo["budget_burn"]
        out["anomalies"] = len(cres.slo["anomalies"])
    out["scale_events"] = len(cres.scale_events)
    out["peak_replicas"] = cres.peak_replicas
    out["replica_hours"] = cres.replica_hours
    out["replica_hours_static_peak"] = cres.replica_hours_static_peak
    # the trace frame: exported timelines, billing spans, and this summary
    # all share one clock (origin t0, last-replica-quiet horizon)
    out["t0"] = cres.t0
    out["horizon"] = cres.horizon
    return out


def pool_summaries(cres: ClusterResult, *, slo_ttft: float | None = None,
                   slo_tpot: float | None = None) -> dict:
    """Per-pool SLO metrics (over the pool replicas' own stage records)
    plus pool utilization against the cluster makespan."""
    span = max(cres.makespan, 1e-12)
    out = {}
    for pool in dict.fromkeys(cres.replica_pools):  # stable order
        idxs = [i for i, p in enumerate(cres.replica_pools) if p == pool]
        recs = [rec for i in idxs for rec in cres.replica_results[i].records]
        s = summarize_records(recs, span=cres.makespan,
                              slo_ttft=slo_ttft, slo_tpot=slo_tpot)
        s["replicas"] = len(idxs)
        s["util_mean"] = (sum(cres.replica_results[i].busy_s for i in idxs)
                          / (len(idxs) * span))
        s["preemptions"] = sum(cres.replica_results[i].preemptions for i in idxs)
        s["peak_kv_gb"] = max(cres.replica_results[i].peak_kv for i in idxs) / 1e9
        out[pool] = s
    return out
