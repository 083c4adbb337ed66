"""Seeded fault injection and overload protection for the cluster engine.

The paper's serving model assumes hardware
behaves; production capacity reviews ask resilience-aware questions —
goodput under replica crashes, stragglers, and degraded links, and how a
fleet sheds load *before* the backend melts. This module supplies both
halves:

  * `ChaosConfig` — a declarative, seeded failure model. `schedule()`
    pre-samples a deterministic event timeline (Poisson arrival of each
    fault kind over `horizon`, magnitudes and victim picks drawn from
    per-kind `SeedSequence` spawns, so adding one fault kind never
    perturbs another's stream). `_ClusterEngine` merges the timeline
    into its event loop and fires each event against live fleet state:

      - `crash`        one replica dies instantly. In-flight KV is lost;
                       displaced requests re-enter dispatch, where they
                       either re-prefill from scratch or restore their
                       prefix from a *surviving* replica's prefix cache
                       (`repro_torch.cluster.prefixcache`).
      - `straggler`    one replica's engine iterations are stretched by a
                       sampled factor for a sampled duration
                       (`ReplicaSim.set_slowdown`).
      - `link`         the prefill->decode KV-handoff interconnect
                       degrades: transfer times are multiplied by a
                       sampled factor for a sampled duration.
      - `node_failure` a correlated failure: one event crashes a sampled
                       group of replicas at the same instant (the
                       shared-node / shared-rack blast radius the
                       planner's N-loss mode sizes for).

    Chaos off (`ChaosConfig` is None or all rates zero) draws zero
    random numbers and adds nothing to the engine's event merge — runs
    stay bit-identical to the chaos-free engine.

  * `AdmissionConfig` — the admission front door, evaluated per arrival
    BEFORE routing/dispatch (the existing shed -> retry -> drop path
    only reacts after a dispatch attempt):

      - `token_bucket`  GCRA (virtual-scheduling token bucket): sustained
                        `rate` admits/s with `burst` tolerance; arrivals
                        beyond the bucket wait in a bounded door queue
                        (`queue_depth` slots, each delayed to its exact
                        conformance time) and overflow is shed at the
                        door — O(1), no RNG, fully deterministic.
      - `breaker`       a circuit breaker over terminal outcomes: when
                        the rolling failure fraction (shed/drop/lost vs
                        complete) exceeds `fail_thresh`, the door OPENs
                        and sheds everything for `cooloff` seconds, then
                        HALF-OPENs `probes` trial admissions — all must
                        complete to CLOSE, one failure re-opens.

A copy of `repro.cluster.chaos` (the port imports nothing of the JAX package);
`tests/test_torch_cluster_dynamic.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.cluster.autoscale import RollingFlagWindow

CHAOS_KINDS = ("crash", "straggler", "link", "node_failure")
ADMISSION_POLICIES = ("token_bucket", "breaker")


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault. `picks` are pre-sampled uniforms in [0, 1)
    used to select victims among the replicas alive at fire time (index
    `int(u * len(eligible))`, without replacement) — pre-sampling keeps
    the schedule a pure function of the config while letting the victim
    depend on fleet state. `factor`/`duration` carry the magnitude for
    stragglers and link degradation; `count` the blast radius for
    correlated node failures."""

    t: float
    kind: str
    factor: float = 1.0
    duration: float = 0.0
    count: int = 1
    picks: tuple[float, ...] = ()

    def validate(self) -> "ChaosEvent":
        """Range-check fields (t/duration in seconds); returns self."""
        if self.kind not in CHAOS_KINDS:
            raise ValueError(
                f"unknown chaos kind {self.kind!r}; choose from {CHAOS_KINDS}")
        if self.t < 0.0:
            raise ValueError("chaos event time must be >= 0")
        if self.factor < 1.0:
            raise ValueError("chaos factor must be >= 1.0")
        if self.duration < 0.0 or self.count < 1:
            raise ValueError("chaos duration must be >= 0 and count >= 1")
        return self


@dataclass(frozen=True)
class ChaosConfig:
    """Seeded failure model. Rates are fleet-wide Poisson intensities in
    events per simulated second over `[0, horizon)`; magnitude ranges
    are uniform `(lo, hi)`. `script` appends hand-placed events (used by
    tests and demos that need a failure at an exact instant) after the
    sampled ones — both are merged in time order."""

    seed: int = 0
    horizon: float = 120.0
    crash_rate: float = 0.0  # replica crashes [events/s]
    straggler_rate: float = 0.0  # straggler onsets [events/s]
    straggler_slowdown: tuple[float, float] = (2.0, 6.0)  # step-cost factor
    straggler_duration: tuple[float, float] = (5.0, 20.0)  # [s]
    link_rate: float = 0.0  # KV-handoff degradations [events/s]
    link_slowdown: tuple[float, float] = (2.0, 8.0)  # p2p time factor
    link_duration: tuple[float, float] = (5.0, 20.0)  # [s]
    node_failure_rate: float = 0.0  # correlated failures [events/s]
    node_group: int = 2  # replicas killed per node failure
    script: tuple[ChaosEvent, ...] = ()

    @property
    def enabled(self) -> bool:
        """True when any event rate (events/s) is set or a script exists."""
        return bool(self.script) or any(
            r > 0.0 for r in (self.crash_rate, self.straggler_rate,
                              self.link_rate, self.node_failure_rate))

    def validate(self) -> "ChaosConfig":
        """Range-check rates (events/s) and horizon (s); returns self."""
        for name in ("crash_rate", "straggler_rate", "link_rate",
                     "node_failure_rate"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"{name} must be >= 0")
        if self.horizon <= 0.0 and self.enabled and not self.script:
            raise ValueError("chaos horizon must be positive")
        if self.node_group < 1:
            raise ValueError("node_group must be >= 1")
        for name in ("straggler_slowdown", "link_slowdown"):
            lo, hi = getattr(self, name)
            if not 1.0 <= lo <= hi:
                raise ValueError(f"{name} must satisfy 1 <= lo <= hi")
        for name in ("straggler_duration", "link_duration"):
            lo, hi = getattr(self, name)
            if not 0.0 < lo <= hi:
                raise ValueError(f"{name} must satisfy 0 < lo <= hi")
        for ev in self.script:
            ev.validate()
        return self

    def schedule(self) -> list[ChaosEvent]:
        """Pre-sample the deterministic event timeline. Each fault kind
        draws from its own `SeedSequence` spawn (the `Workload.substreams`
        idiom), so the schedule for one kind is invariant under changes
        to any other's rate."""
        streams = np.random.SeedSequence(self.seed).spawn(len(CHAOS_KINDS))
        events: list[ChaosEvent] = []
        for kind, ss in zip(CHAOS_KINDS, streams):
            rate = {"crash": self.crash_rate,
                    "straggler": self.straggler_rate,
                    "link": self.link_rate,
                    "node_failure": self.node_failure_rate}[kind]
            if rate <= 0.0:
                continue
            rng = np.random.default_rng(ss)
            t = 0.0
            while True:
                t += float(rng.exponential(1.0 / rate))
                if t >= self.horizon:
                    break
                if kind == "crash":
                    events.append(ChaosEvent(
                        t, kind, picks=(float(rng.random()),)))
                elif kind == "straggler":
                    lo, hi = self.straggler_slowdown
                    dlo, dhi = self.straggler_duration
                    events.append(ChaosEvent(
                        t, kind, factor=float(rng.uniform(lo, hi)),
                        duration=float(rng.uniform(dlo, dhi)),
                        picks=(float(rng.random()),)))
                elif kind == "link":
                    lo, hi = self.link_slowdown
                    dlo, dhi = self.link_duration
                    events.append(ChaosEvent(
                        t, kind, factor=float(rng.uniform(lo, hi)),
                        duration=float(rng.uniform(dlo, dhi))))
                else:  # node_failure
                    events.append(ChaosEvent(
                        t, kind, count=self.node_group,
                        picks=tuple(float(rng.random())
                                    for _ in range(self.node_group))))
        events.extend(ev.validate() for ev in self.script)
        events.sort(key=lambda e: (e.t, CHAOS_KINDS.index(e.kind)))
        return events


def pick_victims(picks: tuple[float, ...], eligible: list[int],
                 count: int) -> list[int]:
    """Select up to `count` victims from `eligible` (sorted indices)
    without replacement, one pre-sampled uniform per pick."""
    pool = list(eligible)
    out: list[int] = []
    for u in picks[:count]:
        if not pool:
            break
        out.append(pool.pop(int(u * len(pool))))
    return out


# --------------------------------------------------------------- admission
@dataclass(frozen=True)
class AdmissionConfig:
    """Front-door overload protection, evaluated per arrival before
    routing. `policy="token_bucket"` uses `rate`/`burst`/`queue_depth`;
    `policy="breaker"` uses `window`/`fail_thresh`/`min_samples`/
    `cooloff`/`probes` (see module docstring for the semantics)."""

    policy: str = "token_bucket"
    # token bucket (GCRA)
    rate: float = 0.0  # sustained admits [req/s]
    burst: int = 1  # bucket depth [requests]
    queue_depth: int = 0  # door-queue slots beyond the bucket (0 = shed)
    # circuit breaker
    window: float = 10.0  # rolling terminal-outcome window [s]
    fail_thresh: float = 0.5  # failure fraction that trips the breaker
    min_samples: int = 10  # terminals required before tripping
    cooloff: float = 5.0  # OPEN hold time before probing [s]
    probes: int = 3  # HALF-OPEN trial admissions

    def validate(self) -> "AdmissionConfig":
        """Range-check rate (req/s), burst, window/cooloff (s); returns self."""
        if self.policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {self.policy!r}; "
                             f"choose from {ADMISSION_POLICIES}")
        if self.policy == "token_bucket":
            if self.rate <= 0.0:
                raise ValueError("token_bucket needs rate > 0")
            if self.burst < 1 or self.queue_depth < 0:
                raise ValueError("token_bucket needs burst >= 1 and "
                                 "queue_depth >= 0")
        else:
            if not 0.0 < self.fail_thresh <= 1.0:
                raise ValueError("breaker fail_thresh must be in (0, 1]")
            if self.window <= 0.0 or self.cooloff <= 0.0:
                raise ValueError("breaker window and cooloff must be positive")
            if self.min_samples < 1 or self.probes < 1:
                raise ValueError("breaker min_samples and probes must be >= 1")
        return self


class TokenBucket:
    """GCRA virtual scheduling: emission interval `T = 1/rate`, burst
    tolerance `tau = (burst - 1) * T`. An arrival at `t` conforms when
    the theoretical arrival time `TAT <= t + tau` (admit now); a
    non-conforming arrival is delayed to its conformance time `TAT -
    tau` if fewer than `queue_depth` arrivals are already waiting, else
    shed. Equivalent to a token bucket of depth `burst` refilling at
    `rate`, with exact O(1) arithmetic and no sampling."""

    def __init__(self, cfg: AdmissionConfig):
        self.T = 1.0 / cfg.rate
        self.tau = (cfg.burst - 1) * self.T
        self.queue_depth = cfg.queue_depth
        self.tat = 0.0
        self.admitted = 0
        self.delayed = 0
        self.door_shed = 0

    def offer(self, rid: int, t: float) -> float | None:
        """Admit time (== t immediate, > t door-queued) or None (shed)."""
        tat = max(self.tat, t)
        lateness = tat - self.tau - t  # seconds until conformance
        if lateness <= 0.0:
            self.tat = tat + self.T
            self.admitted += 1
            return t
        if lateness > self.queue_depth * self.T:
            self.door_shed += 1
            return None
        self.tat = tat + self.T
        self.admitted += 1
        self.delayed += 1
        return t + lateness

    def observe(self, rid: int, t: float, ok: bool) -> None:
        """Terminal-outcome feedback at time `t` (seconds): ignored."""
        pass  # open-loop: the bucket does not react to outcomes

    def stats(self) -> dict:
        """Door counters (requests): admitted / delayed / shed."""
        return {"policy": "token_bucket", "door_admitted": self.admitted,
                "door_delayed": self.delayed, "door_shed": self.door_shed,
                "breaker_opens": 0}


class CircuitBreaker:
    """CLOSED -> OPEN -> HALF_OPEN state machine over terminal outcomes
    (complete = success; shed/drop/lost = failure). The door never
    delays: it either admits or sheds."""

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self.state = "closed"
        self.open_until = -math.inf
        self.fails = RollingFlagWindow(cfg.window)
        self._probe_rids: set[int] = set()
        self._probe_ok = 0
        self._probes_sent = 0
        self.admitted = 0
        self.door_shed = 0
        self.opens = 0

    def _trip(self, t: float) -> None:
        self.state = "open"
        self.open_until = t + self.cfg.cooloff
        self.opens += 1
        self._probe_rids.clear()
        self._probe_ok = 0
        self._probes_sent = 0

    def offer(self, rid: int, t: float) -> float | None:
        """Offer a request at time `t` (seconds): returns the admission
        time (always `t`; the breaker never delays) or None = shed."""
        cfg = self.cfg
        if self.state == "closed":
            if (self.fails.count(t) >= cfg.min_samples
                    and self.fails.frac(t) >= cfg.fail_thresh):
                self._trip(t)
        if self.state == "open" and t >= self.open_until:
            self.state = "half_open"
        if self.state == "open":
            self.door_shed += 1
            return None
        if self.state == "half_open":
            if self._probes_sent >= cfg.probes:
                self.door_shed += 1  # probes outstanding: hold the door
                return None
            self._probes_sent += 1
            self._probe_rids.add(rid)
        self.admitted += 1
        return t

    def observe(self, rid: int, t: float, ok: bool) -> None:
        """Terminal outcome at time `t` (seconds); failures trip the
        breaker, successful probes close it."""
        if self.state == "half_open" and rid in self._probe_rids:
            self._probe_rids.discard(rid)
            if not ok:
                self._trip(t)
                return
            self._probe_ok += 1
            if self._probe_ok >= self.cfg.probes:
                self.state = "closed"
                self.fails = RollingFlagWindow(self.cfg.window)
            return
        if self.state == "closed":
            self.fails.add(t, not ok)

    def stats(self) -> dict:
        """Door counters (requests) plus breaker opens and current state."""
        return {"policy": "breaker", "door_admitted": self.admitted,
                "door_delayed": 0, "door_shed": self.door_shed,
                "breaker_opens": self.opens, "breaker_state": self.state}


def make_admission(cfg: AdmissionConfig):
    """Build the runtime front door for a validated `AdmissionConfig`."""
    if cfg.policy == "token_bucket":
        return TokenBucket(cfg)
    return CircuitBreaker(cfg)
