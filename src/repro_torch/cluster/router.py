"""Pluggable request routers for the cluster simulator.

A router sees lightweight `ReplicaView` snapshots (clock, queue depth,
live sequences, KV occupancy) of the replicas in one pool and picks the
replica a request is dispatched to. All policies are deterministic
functions of the views and the router's own state, so a fixed workload
seed yields a fixed assignment.

`affinity` additionally models the prefix/session cache that affinity
routing exists to exploit: a request landing on the replica that last
served its session skips `hit_frac` of its prompt prefill (the prefix is
already resident), entering the replica with `cached` tokens. With
`ClusterSpec.prefix_cache` set, the discount is no longer unconditional:
the cluster engine binds a `FleetPrefixCache` to the router
(`bind_cache`), placement becomes residency-aware (explicit prefix
groups are steered to the warmest replica), and the cached-token count
is computed by the ENGINE from actually resident prefix bytes under a
finite budget with LRU + TTL eviction — see
`repro_torch.cluster.prefixcache`.

Routers are notified when a replica retires (`on_retire`): affinity
drops the session pins homed on it and slo_debt drops its observation
window, so long autoscaled runs don't accrete state for dead replicas.
Chaos crashes (`repro_torch.cluster.chaos`) flow through the same hook — a
crashed replica is pruned exactly like a drained one, and its displaced
requests re-enter `pick()` as fresh dispatches.

`slo_debt` closes the loop on outcomes instead of state: the cluster
engine feeds completed requests' TTFTs back via `observe()`, and the
router sends new work to the replica with the lowest rolling TTFT-SLO
violation fraction — instantaneous queue depth only breaks ties. This is
the "route on SLO debt, not queue length" feedback policy; it reacts to
what replicas actually delivered (useful under heterogeneous hardware,
where equal depths hide unequal speeds).

A copy of `repro.cluster.router` (the port imports nothing of the JAX package);
`tests/test_torch_cluster.py` holds it to the original bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.sim.workload import SimRequest

from repro_torch.cluster.autoscale import RollingFlagWindow

ROUTERS = ("round_robin", "jsq", "least_kv", "affinity", "slo_debt")


@dataclass(frozen=True)
class ReplicaView:
    """Read-only snapshot of one replica, as the router observes it at
    the dispatch instant."""

    idx: int  # global replica index
    now: float  # view clock (s): max(replica clock, dispatch time)
    queue_len: int  # requests queued, not yet admitted
    live: int  # sequences holding slots
    kv_used: float  # KV bytes currently materialized on the replica
    kv_capacity: float  # KV budget (bytes)

    @property
    def depth(self) -> int:
        """Total requests on the replica (queued + live) — the JSQ load."""
        return self.queue_len + self.live

    @property
    def kv_frac(self) -> float:
        """KV occupancy fraction in [0, 1] (0 for an empty/∞ budget)."""
        return self.kv_used / self.kv_capacity if self.kv_capacity > 0 else 0.0


class Router:
    """Dispatch policy interface.

    `pick(req, views)` chooses among the eligible replicas and returns
    `(chosen replica idx, prefix-cached prompt tokens)` — the cached
    count is nonzero only for affinity hits, and the replica resumes the
    request with that many prompt tokens already materialized.

    `observe(idx, t, ttft)` is the cluster engine's outcome feedback
    channel: replica `idx` completed a request at time `t` (s) with the
    given end-to-end TTFT (s). Stateless policies ignore it.

    `on_retire(idx)` is the lifecycle hook: replica `idx` left the fleet
    for good (drained or cancelled) and will never appear in `views`
    again, so any per-replica router state keyed on it can be pruned.
    Replica indices are never reused within a run.

    `last_pick` holds a flat dict explaining the most recent `pick()` —
    the policy's name plus whatever drove the choice (queue depth, KV
    fraction, session home, SLO debt). The cluster tracer attaches it to
    dispatch events so every placement in a trace is explainable."""

    name = "base"
    last_pick: dict = {}

    def pick(self, req: SimRequest, views: list[ReplicaView]) -> tuple[int, int]:
        """Place `req`: returns (replica idx, cached prompt tokens)."""
        raise NotImplementedError

    def observe(self, idx: int, t: float, ttft: float) -> None:
        """Completion feedback: replica `idx` served with `ttft` seconds
        at time `t` (seconds). Default: ignored."""
        pass

    def on_retire(self, idx: int) -> None:
        """Replica `idx` left the fleet: drop any per-replica state."""
        pass


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._i = 0

    def pick(self, req, views):
        """Next replica in rotation, ignoring load."""
        v = views[self._i % len(views)]
        self._i += 1
        self.last_pick = {"router": self.name, "slot": self._i - 1}
        return v.idx, 0


class JoinShortestQueueRouter(Router):
    name = "jsq"

    def pick(self, req, views):
        """Fewest outstanding requests; KV bytes then index break ties."""
        v = min(views, key=lambda v: (v.depth, v.kv_used, v.idx))
        self.last_pick = {"router": self.name, "depth": v.depth}
        return v.idx, 0


class LeastKVLoadRouter(Router):
    name = "least_kv"

    def pick(self, req, views):
        """Lowest KV occupancy (fraction of capacity); depth breaks ties."""
        v = min(views, key=lambda v: (v.kv_frac, v.depth, v.idx))
        self.last_pick = {"router": self.name, "kv_frac": v.kv_frac,
                          "depth": v.depth}
        return v.idx, 0


class AffinityRouter(Router):
    """Session/prefix affinity with a modeled prefill-cache hit discount.

    First request of a session is placed join-shortest-queue and pins the
    session to that replica; subsequent requests follow it and enter with
    `hit_frac` of their prompt already cached (capped at prompt - 1: the
    final prompt token always runs, it produces the first logits).
    Following the home replica with a 0-token discount (e.g. a 1-token
    prompt, or `int(prompt * hit_frac) == 0`) counts as a MISS — the hit
    counter reports realized discounts, not placement affinity.

    With a bound `FleetPrefixCache` (`bind_cache`, set by the cluster
    engine when `ClusterSpec.prefix_cache` is given) the router only does
    PLACEMENT — session home first, then the replica holding the most
    resident tokens of the request's explicit prefix group, then
    join-shortest-queue — and returns 0 cached tokens: the engine
    computes the discount from actual residency (and keeps the hit/miss
    stats on the cache)."""

    name = "affinity"

    def __init__(self, hit_frac: float = 0.5):
        if not 0.0 <= hit_frac < 1.0:
            raise ValueError("hit_frac must be in [0, 1)")
        self.hit_frac = float(hit_frac)
        self._home: dict[int, int] = {}
        self.cache = None  # FleetPrefixCache, bound by the cluster engine
        self.hits = 0
        self.misses = 0

    def bind_cache(self, cache) -> None:
        """Switch from the unconditional discount to modeled residency:
        `cache` informs placement; the engine computes the hit sizes."""
        self.cache = cache

    def _warmest(self, req, views):
        """The view holding the most resident tokens of `req`'s explicit
        prefix group (ties: shallowest queue, least KV, lowest idx), or
        None when the group is cold everywhere eligible OR the warm
        replica is already loaded well past the JSQ choice — popular
        prefixes must not herd the whole fleet's traffic onto one replica
        (re-prefilling the prefix elsewhere is cheaper than the queueing
        tail, and the re-prefill warms a second copy)."""
        scored = [(self.cache.resident_tokens(v.idx, req, v.now), v)
                  for v in views]
        tokens, v = max(scored,
                        key=lambda tv: (tv[0], -tv[1].depth, -tv[1].kv_used,
                                        -tv[1].idx))
        if tokens <= 0:
            return None
        jsq = min(views, key=lambda v: (v.depth, v.kv_used, v.idx))
        return v if v.depth <= jsq.depth + 1 else None

    def pick(self, req, views):
        """Session home if alive, else warmest prefix-cache replica, else
        JSQ; returns (idx, modeled cached tokens — 0 when the engine
        computes residency itself)."""
        eligible = {v.idx for v in views}
        home = self._home.get(req.session, -1) if req.session >= 0 else -1
        if home in eligible:
            if self.cache is not None:
                self.last_pick = {"router": self.name, "why": "session_home"}
                return home, 0  # discount computed by the engine
            cached = max(min(int(req.prompt * self.hit_frac), req.prompt - 1), 0)
            if cached > 0:
                self.hits += 1
            else:
                self.misses += 1
            self.last_pick = {"router": self.name, "why": "session_home",
                              "hit_tokens": cached}
            return home, cached
        v = None
        why = "jsq_fallback"
        if self.cache is not None and req.prefix_group >= 0:
            v = self._warmest(req, views)
            if v is not None:
                why = "warmest_prefix"
        if v is None:
            v = min(views, key=lambda v: (v.depth, v.kv_used, v.idx))
        if req.session >= 0:
            self._home[req.session] = v.idx
        if self.cache is None:
            self.misses += 1
        self.last_pick = {"router": self.name, "why": why, "depth": v.depth}
        return v.idx, 0

    def on_retire(self, idx):
        """Unpin every session homed on the retired replica."""
        self._home = {s: r for s, r in self._home.items() if r != idx}


class SLODebtRouter(Router):
    """Route to the replica with the lowest rolling TTFT-SLO debt.

    Debt is the violation fraction (ttft > slo_ttft) over the completions
    observed in the trailing `window` seconds; replicas with no recent
    completions carry zero debt (they are safe bets). Queue depth, then KV
    load, then index break ties, so a cold fleet degenerates to JSQ."""

    name = "slo_debt"

    def __init__(self, slo_ttft: float = 2.0, window: float = 30.0):
        if slo_ttft <= 0 or window <= 0:
            raise ValueError("slo_ttft and window must be positive")
        self.slo_ttft = float(slo_ttft)
        self.window = float(window)
        self._obs: dict[int, RollingFlagWindow] = {}  # per-replica debt

    def observe(self, idx, t, ttft):
        """Record whether `ttft` (seconds) at time `t` violated the SLO."""
        if idx not in self._obs:
            self._obs[idx] = RollingFlagWindow(self.window)
        self._obs[idx].add(t, ttft > self.slo_ttft)

    def debt(self, idx: int, now: float) -> float:
        """Rolling TTFT-violation fraction for replica `idx` at `now` (s)."""
        w = self._obs.get(idx)
        return w.frac(now) if w is not None else 0.0

    def on_retire(self, idx):
        """Drop the retired replica's debt window (unbounded otherwise)."""
        # a retired replica never reappears in views: its window would
        # otherwise sit in _obs forever (unbounded growth on long diurnal
        # traces with many joins/leaves)
        self._obs.pop(idx, None)

    def pick(self, req, views):
        """Lowest debt fraction; depth, KV bytes, then index break ties."""
        now = max(v.now for v in views)
        v = min(views, key=lambda v: (self.debt(v.idx, now), v.depth,
                                      v.kv_used, v.idx))
        self.last_pick = {"router": self.name, "debt": self.debt(v.idx, now),
                          "depth": v.depth}
        return v.idx, 0


def make_router(name: str, *, hit_frac: float = 0.5, slo_ttft: float = 2.0,
                debt_window: float = 30.0) -> Router:
    """Build a router by name (one of `ROUTERS`). `hit_frac` is the
    affinity router's prefix-cache discount in [0, 1); `slo_ttft` (s) and
    `debt_window` (s) parameterize the slo_debt router's rolling
    violation window. The extra knobs are ignored by policies that don't
    use them, so one call site serves every policy."""
    if name == "round_robin":
        return RoundRobinRouter()
    if name == "jsq":
        return JoinShortestQueueRouter()
    if name == "least_kv":
        return LeastKVLoadRouter()
    if name == "affinity":
        return AffinityRouter(hit_frac)
    if name == "slo_debt":
        return SLODebtRouter(slo_ttft, debt_window)
    raise ValueError(f"unknown router {name!r}; choose from {ROUTERS}")
