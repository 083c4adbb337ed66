"""Modeled prefix cache: finite capacity, LRU + TTL eviction, and
cross-session sharing of prompt prefixes.

The legacy affinity router granted an *unconditional* per-session
prefill discount: any request landing on its session's home replica
skipped `hit_frac` of its prompt, free of charge. Real prefix caches are
neither free nor unconditional — the cached KV occupies the same HBM the
live sequences need (§3.5 prices KV bytes as the dominant inference
memory term), entries are evicted when the budget fills or when they go
idle, and system-prompt / few-shot prefixes are shared *across* sessions,
not pinned per conversation.

This module models exactly that, per replica:

  * a finite **byte budget** — `PrefixCacheConfig.budget_frac` carves the
    budget out of the replica's KV capacity, so cache warmth and live
    sequences compete for the same DRAM (the carve-out shrinks the
    scheduler's admission budget). `budget_bytes=math.inf` reproduces the
    old "cache is free and infinite" assumption and is the parity anchor:
    an infinite-budget, no-TTL cache with per-session prefix groups is
    bit-identical to the unconditional `hit_frac` discount
    (regression-tested).
  * **token-granular prefix groups** — a request carries either an
    explicit `prefix_group` (a shared system prompt / few-shot header of
    `prefix_len` tokens, reusable by EVERY session that lands on a warm
    replica) or falls back to its `session` (conversation history, of
    which `hit_frac` of each turn's prompt is the modeled reusable part).
  * **LRU + TTL eviction** — least-recently-used entries are evicted when
    an insertion would overflow the budget; entries idle longer than
    `ttl` seconds expire. Both are counted in the stats the cluster
    reports (`cache_evictions`, `cache_hit_tokens`, ...).
  * **two-phase residency** — a prefix is *reserved* at dispatch (the
    prefill that will materialize it is now scheduled on that replica, so
    requests queued behind it already benefit) and *committed* (recency
    refresh) when the prefill completes. Draining or retiring a replica
    invalidates its whole cache — autoscale churn destroys warmth, and
    the re-warm cost is measurable instead of assumed away.

Hits are computed from *actually resident* tokens: a request's discount
is `min(resident prefix tokens, its own cacheable prefix, prompt - 1)` —
the final prompt token always runs (it produces the first logits).

A copy of `repro.cluster.prefixcache` (the port imports nothing of the JAX package);
`tests/test_torch_cluster_dynamic.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.sim.workload import SimRequest


@dataclass(frozen=True)
class PrefixCacheConfig:
    """Per-replica prefix-cache budget and eviction policy.

    Attributes:
        budget_frac: fraction of the replica's KV capacity carved out for
            the prefix cache (the scheduler's live-sequence budget shrinks
            by the same bytes). Ignored when `budget_bytes` is given.
        budget_bytes: absolute cache budget in bytes. `math.inf` models
            the legacy free-infinite cache (no carve-out, nothing ever
            evicted) — the bit-for-bit parity anchor with the
            unconditional `hit_frac` discount.
        ttl: idle seconds before an entry expires (None = never).
    """

    budget_frac: float = 0.1
    budget_bytes: float | None = None
    ttl: float | None = None

    def validate(self) -> None:
        """Range-check budget (bytes / fraction of KV) and ttl (seconds)."""
        if self.budget_bytes is not None:
            if self.budget_bytes < 0:
                raise ValueError("prefix-cache budget_bytes must be >= 0")
        elif not 0.0 <= self.budget_frac < 1.0:
            raise ValueError(
                "prefix-cache budget_frac must be in [0, 1) — the carve-out "
                "must leave KV capacity for live sequences")
        if self.ttl is not None and self.ttl <= 0:
            raise ValueError("prefix-cache ttl must be positive (or None)")

    @property
    def infinite(self) -> bool:
        """True for the legacy free-infinite cache (no carve-out)."""
        return self.budget_bytes is not None and math.isinf(self.budget_bytes)

    def budget_for(self, kv_capacity: float) -> float:
        """Cache budget (bytes) on a replica with `kv_capacity` KV bytes."""
        if self.budget_bytes is not None:
            return self.budget_bytes
        return self.budget_frac * kv_capacity


def prefix_key(req: SimRequest):
    """The cache key a request's reusable prefix lives under: its explicit
    prefix group when it has one (shared across sessions), else its
    session (conversation history), else None (nothing reusable)."""
    if req.prefix_group >= 0:
        return ("g", req.prefix_group)
    if req.session >= 0:
        return ("s", req.session)
    return None


def prefix_cap(req: SimRequest, hit_frac: float) -> int:
    """Cacheable prefix tokens of THIS request: the shared group prefix
    (explicit), or the modeled reusable share of a session turn's prompt
    (`hit_frac`), never the final prompt token (it must run to produce
    the first logits)."""
    if req.prefix_group >= 0:
        cap = min(req.prefix_len, req.prompt - 1)
    elif req.session >= 0:
        cap = min(int(req.prompt * hit_frac), req.prompt - 1)
    else:
        cap = 0
    return max(cap, 0)


@dataclass
class _Entry:
    """One resident prefix. `tokens=None` marks a session pin: the whole
    conversation context is resident, and a follow-up's hit is capped only
    by its own cacheable prefix (what makes the infinite-budget cache
    reduce exactly to the unconditional `hit_frac` discount)."""

    tokens: int | None
    bytes: float
    last_used: float
    seq: int


class ReplicaPrefixCache:
    """One replica's prefix cache: a byte-budgeted LRU/TTL map from
    prefix keys to resident token counts. All operations are deterministic
    functions of (call order, timestamps), so cluster runs stay seeded."""

    def __init__(self, budget: float, ttl: float | None, cost):
        self.budget = budget
        self.ttl = ttl
        self.cost = cost  # ServingCostModel: prices resident tokens in bytes
        self.entries: dict[tuple, _Entry] = {}
        self.used_bytes = 0.0
        self.peak_bytes = 0.0
        self._seq = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.insertions = 0
        self.evictions_lru = 0
        self.evictions_ttl = 0
        self.rejected = 0  # prefixes larger than the whole budget
        self.invalidations = 0

    # ----------------------------------------------------------------- reads
    def _expired(self, e: _Entry, now: float) -> bool:
        return self.ttl is not None and now - e.last_used > self.ttl

    def resident_tokens(self, req: SimRequest, now: float,
                        hit_frac: float) -> int:
        """Read-only hit size in tokens for `req` at `now` (seconds; 0
        when absent/expired), capped by `hit_frac` (fraction of prompt).
        Never mutates, so routers may probe freely during placement."""
        key = prefix_key(req)
        e = self.entries.get(key) if key is not None else None
        if e is None or self._expired(e, now):
            return 0
        cap = prefix_cap(req, hit_frac)
        return cap if e.tokens is None else min(e.tokens, cap)

    # ------------------------------------------------------------- mutations
    def _sweep(self, now: float) -> None:
        dead = [k for k, e in self.entries.items() if self._expired(e, now)]
        for k in dead:
            self.used_bytes -= self.entries.pop(k).bytes
            self.evictions_ttl += 1

    def _evict_until(self, need: float, keep: tuple) -> None:
        while self.used_bytes + need > self.budget and self.entries:
            victims = [(e.last_used, e.seq, k)
                       for k, e in self.entries.items() if k != keep]
            if not victims:
                break
            _, _, k = min(victims)
            self.used_bytes -= self.entries.pop(k).bytes
            self.evictions_lru += 1

    def use(self, req: SimRequest, now: float, hit_frac: float) -> int:
        """Dispatch-time lookup + reservation. Returns the hit tokens (the
        prompt prefix the replica skips), then reserves/refreshes the
        request's own prefix so work queued behind it benefits — the
        prefill that materializes it is now scheduled here. Charges bytes,
        LRU-evicting colder prefixes to fit."""
        self._sweep(now)
        key = prefix_key(req)
        if key is None:
            return 0
        cap = prefix_cap(req, hit_frac)
        e = self.entries.get(key)
        hit = 0
        if e is not None:
            hit = cap if e.tokens is None else min(e.tokens, cap)
        if hit > 0:
            self.hits += 1
            self.hit_tokens += hit
        else:
            self.misses += 1
        # reserve: sessions pin their whole (growing) context; groups pin
        # the largest prefix any member has materialized so far
        if key[0] == "s":
            tokens_new: int | None = None
            bytes_new = self.cost.kv_bytes(req.prompt + req.output)
        else:
            tokens_new = max(cap, e.tokens if e is not None else 0)
            bytes_new = self.cost.kv_bytes(tokens_new)
            if tokens_new == 0:
                return hit  # nothing cacheable (e.g. 1-token prompt)
        if bytes_new > self.budget:
            # can't fit even alone: drop any stale entry and move on
            if e is not None:
                self.used_bytes -= e.bytes
                del self.entries[key]
            self.rejected += 1
            return hit
        delta = bytes_new - (e.bytes if e is not None else 0.0)
        if delta > 0:
            self._evict_until(delta, keep=key)
        self.used_bytes += delta
        self.peak_bytes = max(self.peak_bytes, self.used_bytes)
        self._seq += 1
        if e is None:
            self.insertions += 1
        self.entries[key] = _Entry(tokens_new, bytes_new, now, self._seq)
        return hit

    def uncount(self, hit: int) -> None:
        """Retract one `use()`'s hit/miss accounting: the dispatch it was
        counted for was evicted before its prefill ever ran (the replica
        drained), so the discount was never realized. The re-dispatch
        counts fresh on whichever replica actually serves the request."""
        if hit > 0:
            self.hits -= 1
            self.hit_tokens -= hit
        else:
            self.misses -= 1

    def commit(self, req: SimRequest, now: float) -> None:
        """Prefill-completion confirmation: refresh the entry's recency at
        the instant its KV actually became resident. No-op if the entry
        was evicted/invalidated while the prefill ran."""
        key = prefix_key(req)
        e = self.entries.get(key) if key is not None else None
        if e is None:
            return
        self._seq += 1
        e.last_used = now
        e.seq = self._seq

    def invalidate(self) -> None:
        """Drop everything — the replica is draining/retiring and its HBM
        (cache included) goes away with it."""
        if self.entries:
            self.invalidations += 1
        self.entries.clear()
        self.used_bytes = 0.0


class FleetPrefixCache:
    """The cluster engine's view: one `ReplicaPrefixCache` per replica
    that prefills (mixed/prefill pools), plus fleet-level stats."""

    def __init__(self, pc: PrefixCacheConfig, hit_frac: float):
        pc.validate()
        self.pc = pc
        self.hit_frac = float(hit_frac)
        self.caches: dict[int, ReplicaPrefixCache] = {}

    def register(self, idx: int, budget: float, cost) -> None:
        """Attach a cache with `budget` bytes to replica `idx`."""
        self.caches[idx] = ReplicaPrefixCache(budget, self.pc.ttl, cost)

    def resident_tokens(self, idx: int, req: SimRequest, now: float) -> int:
        """Read-only resident-prefix tokens on replica `idx` at `now` (s)."""
        c = self.caches.get(idx)
        return c.resident_tokens(req, now, self.hit_frac) if c else 0

    def use(self, idx: int, req: SimRequest, now: float) -> int:
        """Dispatch-time reserve: count + touch the hit; returns tokens."""
        c = self.caches.get(idx)
        return c.use(req, now, self.hit_frac) if c else 0

    def uncount(self, idx: int, hit: int) -> None:
        """Roll back a reserved hit of `hit` tokens (dispatch aborted)."""
        c = self.caches.get(idx)
        if c is not None:
            c.uncount(hit)

    def commit(self, idx: int, req: SimRequest, now: float) -> None:
        """Prefill finished on `idx` at `now` (s): make the prefix resident."""
        c = self.caches.get(idx)
        if c is not None:
            c.commit(req, now)

    def invalidate(self, idx: int) -> None:
        """Drop replica `idx`'s cache contents (drain/retire/crash)."""
        c = self.caches.get(idx)
        if c is not None:
            c.invalidate()

    @property
    def hits(self) -> int:
        """Fleet-wide cache-hit count (requests with a nonzero hit)."""
        return sum(c.hits for c in self.caches.values())

    def stats(self) -> dict:
        """Fleet-aggregate cache counters for `ClusterResult.cache_stats`."""
        cs = list(self.caches.values())
        return {
            "hits": sum(c.hits for c in cs),
            "misses": sum(c.misses for c in cs),
            "hit_tokens": sum(c.hit_tokens for c in cs),
            "insertions": sum(c.insertions for c in cs),
            "evictions_lru": sum(c.evictions_lru for c in cs),
            "evictions_ttl": sum(c.evictions_ttl for c in cs),
            "rejected": sum(c.rejected for c in cs),
            "invalidations": sum(c.invalidations for c in cs),
            "resident_bytes": sum(c.used_bytes for c in cs),
            # the budget is a PER-REPLICA invariant, so the headline peak
            # is the max over replicas, not a fleet sum
            "peak_resident_bytes": max((c.peak_bytes for c in cs), default=0.0),
            "budget_bytes": sum(c.budget for c in cs),
            "per_replica": {i: {"peak_resident_bytes": c.peak_bytes,
                                "resident_bytes": c.used_bytes,
                                "budget_bytes": c.budget}
                            for i, c in sorted(self.caches.items())},
        }
