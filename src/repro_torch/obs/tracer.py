"""Event tracing for the serving simulators.

A `Tracer` collects three kinds of events while a simulation runs:

  * **spans** — named intervals `[t0, t1]` on a track (a replica, a pool,
    or the cluster), optionally tied to a request id: request lifecycle
    phases (`queued`, `prefill`, `handoff`, `decode_wait`, `decode`) and
    replica structural phases (`provisioned`, `warmup`, `drain`).
  * **instants** — point events with attributes: dispatch/shed/retry
    decisions (with the router's explanation), autoscaler decisions (with
    the policy's inputs), preemptions, cache invalidations, and fault
    injection (`replica.crash`, `chaos.straggler`, `chaos.link_degrade`,
    `chaos.node_failure`, `request.stall` — see `repro.cluster.chaos`, not
    ported yet).
  * **counters** — numeric timelines sampled as the sim steps: queue
    depth, live batch slots, KV occupancy, cache-resident bytes,
    cumulative busy seconds.

Everything is observational: a traced run and an untraced run execute the
identical schedule (tested by `tests/test_obs.py`), so tracing can never
perturb the pinned-autoscaler bit-parity contract.

A `Tracer` can also stream its events to **sinks** (`add_sink`): objects
with an `on_event(ev)` method that consume each event the moment it is
emitted, at sim time — the substrate the online SLO monitor
(`repro_torch.obs.monitor`) is built on, with no second pass over the event
list. A sink may emit events of its own back into the tracer (alert
instants, window evaluations); those are appended to the stream but not
re-dispatched to sinks, so sink cascades cannot recurse. Construct with
`keep_events=False` to run sinks without retaining the event list (live
monitoring without recording), and `counter_dt=x` to downsample counter
timelines to at most one sample per `x` simulated seconds per
(track, series) — the knob that keeps replica-level traces of long
diurnal runs bounded.

Trace levels are ordered `off < summary < replica < request`; call sites
gate on `tracer.wants(level)` (usually hoisted into a local boolean) so
the disabled path costs one attribute read. The module-level `NULL_TRACER`
is the shared no-op default — engines take `tracer=None` and substitute
it, so hot loops never branch on `None`.

Event dict schema (`repro.obs/1`, stable — golden-tested):

    {"ev": "span",    "name", "t0", "t1", "track", ["rid"], ["attrs"]}
    {"ev": "instant", "name", "t",  "track", ["rid"], ["attrs"]}
    {"ev": "counter", "name", "t",  "track", "value"}

`rid` is present only on request-scoped events; `attrs` is a flat dict of
JSON scalars. Times are simulated seconds from the trace origin.

A copy of `repro.obs.tracer` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

LEVELS = ("off", "summary", "replica", "request")

# terminal instants: every traced request must end in exactly one
TERMINALS = ("request.complete", "request.shed", "request.drop")

# span names that structurally nest on a replica track (exported as
# Chrome X events); request-phase spans overlap freely and are exported
# as async events instead
STRUCTURAL_SPANS = ("provisioned", "warmup", "drain")


class NullTracer:
    """Zero-cost stand-in when tracing is off: every emit is a no-op and
    `wants()` is always False, so gated call sites skip event assembly
    entirely."""

    enabled = False
    level = "off"
    events: tuple = ()
    meta: dict = {}

    def wants(self, level: str) -> bool:
        return False

    def span(self, name, t0, t1, track="", rid=None, **attrs) -> None:
        pass

    def instant(self, name, t, track="", rid=None, **attrs) -> None:
        pass

    def counter(self, name, t, value, track="") -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """In-memory event collector for one simulation run.

    `level` sets the verbosity ceiling: `summary` keeps cluster-scope
    events (scale/autoscale decisions, terminal/shed/retry instants),
    `replica` adds per-replica structural spans and counter timelines,
    `request` adds per-request lifecycle spans and dispatch explanations.
    Emit methods do not re-check the level — call sites gate with
    `wants()`, which keeps the hot path a single hoisted boolean.

    `sinks` (or `add_sink`) registers online consumers — objects with
    `on_event(ev)` — that see each event as it is emitted. Events a sink
    emits back through the tracer are recorded but not re-dispatched.
    `keep_events=False` drops the in-memory event list (sink-only mode);
    `counter_dt > 0` keeps at most one counter sample per (track, name)
    per `counter_dt` simulated seconds."""

    enabled = True

    def __init__(self, level: str = "request", *, sinks=(), keep_events: bool = True,
                 counter_dt: float = 0.0):
        if level not in LEVELS:
            raise ValueError(f"unknown trace level {level!r}; expected one of {LEVELS}")
        if level == "off":
            raise ValueError("level 'off' means no tracer; use NULL_TRACER")
        self.level = level
        self._rank = LEVELS.index(level)
        self.events: list[dict] = []
        self.meta: dict = {"schema": "repro.obs/1"}
        self.keep_events = bool(keep_events)
        self.counter_dt = float(counter_dt)
        self._last_counter: dict[tuple[str, str], float] = {}
        self._sinks: list = []
        self._dispatching = False
        for s in sinks:
            self.add_sink(s)

    def add_sink(self, sink) -> None:
        """Register an online event consumer. If the sink has a `bind`
        method it is called with this tracer so the sink can emit events
        of its own (e.g. the SLO monitor's `alert.*` instants)."""
        self._sinks.append(sink)
        bind = getattr(sink, "bind", None)
        if bind is not None:
            bind(self)

    def _emit(self, ev: dict) -> None:
        if self.keep_events:
            self.events.append(ev)
        if self._sinks and not self._dispatching:
            # events emitted *by* a sink (alert instants) are recorded
            # above but never fed back into sinks — no recursion
            self._dispatching = True
            try:
                for s in self._sinks:
                    s.on_event(ev)
            finally:
                self._dispatching = False

    def wants(self, level: str) -> bool:
        """True when events at `level` should be emitted under this
        tracer's verbosity ceiling."""
        return LEVELS.index(level) <= self._rank

    def span(self, name, t0, t1, track="", rid=None, **attrs) -> None:
        ev = {"ev": "span", "name": name, "t0": float(t0), "t1": float(t1),
              "track": track}
        if rid is not None:
            ev["rid"] = rid
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)

    def instant(self, name, t, track="", rid=None, **attrs) -> None:
        ev = {"ev": "instant", "name": name, "t": float(t), "track": track}
        if rid is not None:
            ev["rid"] = rid
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)

    def counter(self, name, t, value, track="") -> None:
        if self.counter_dt > 0.0:
            key = (track, name)
            last = self._last_counter.get(key)
            if last is not None and t - last < self.counter_dt:
                return
            self._last_counter[key] = t
        self._emit({"ev": "counter", "name": name, "t": float(t),
                    "value": float(value), "track": track})


def make_tracer(level: str | None, *, counter_dt: float = 0.0):
    """Level string (or None/'off') -> tracer instance. The CLI-facing
    constructor: `make_tracer('off') is NULL_TRACER`."""
    if level is None or level == "off":
        return NULL_TRACER
    return Tracer(level, counter_dt=counter_dt)


def validate_trace(events) -> list[str]:
    """Structural validation of a trace event stream; returns a list of
    problem strings (empty == valid). Checks:

      * every event carries its schema-required keys and `t0 <= t1`;
      * structural spans (`provisioned`/`warmup`/`drain`) nest properly
        per track — intervals either contain one another or are disjoint;
      * per request id, phase spans are time-ordered (each phase starts no
        earlier than the previous phase's start) and every rid that
        appears terminates in exactly one of `request.complete` /
        `request.shed` / `request.drop`.
    """
    problems: list[str] = []
    by_track: dict[str, list[tuple[float, float, str]]] = {}
    rid_spans: dict[object, list[tuple[float, float, str]]] = {}
    rid_terms: dict[object, list[str]] = {}

    for i, ev in enumerate(events):
        kind = ev.get("ev")
        if kind == "meta":
            continue
        name = ev.get("name")
        if kind == "span":
            t0, t1 = ev.get("t0"), ev.get("t1")
            if t0 is None or t1 is None:
                problems.append(f"event {i}: span {name!r} missing t0/t1")
                continue
            if t1 < t0:
                problems.append(f"event {i}: span {name!r} ends before it starts "
                                f"({t0} > {t1})")
            if "rid" in ev:
                rid_spans.setdefault(ev["rid"], []).append((t0, t1, name))
            elif name in STRUCTURAL_SPANS:
                by_track.setdefault(ev.get("track", ""), []).append((t0, t1, name))
        elif kind == "instant":
            if ev.get("t") is None:
                problems.append(f"event {i}: instant {name!r} missing t")
            if name in TERMINALS:
                if "rid" not in ev:
                    problems.append(f"event {i}: terminal {name!r} missing rid")
                else:
                    rid_terms.setdefault(ev["rid"], []).append(name)
        elif kind == "counter":
            if ev.get("t") is None or ev.get("value") is None:
                problems.append(f"event {i}: counter {name!r} missing t/value")
        else:
            problems.append(f"event {i}: unknown ev kind {kind!r}")

    # structural spans must nest (contain or be disjoint) per track
    for track, spans in by_track.items():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: list[tuple[float, float, str]] = []
        for t0, t1, name in spans:
            while stack and t0 >= stack[-1][1] - 1e-12:
                stack.pop()
            if stack and t1 > stack[-1][1] + 1e-12:
                problems.append(
                    f"track {track!r}: span {name!r} [{t0:.6g},{t1:.6g}] "
                    f"overlaps {stack[-1][2]!r} [{stack[-1][0]:.6g},{stack[-1][1]:.6g}] "
                    "without nesting")
            stack.append((t0, t1, name))

    # request phases are time-ordered; every traced rid has one terminal
    for rid, spans in rid_spans.items():
        starts = [t0 for t0, _, _ in spans]
        if any(b < a - 1e-9 for a, b in zip(starts, starts[1:])):
            problems.append(f"rid {rid!r}: phase spans out of order")
    for rid in sorted(set(rid_spans) | set(rid_terms)):
        terms = rid_terms.get(rid, [])
        if len(terms) != 1:
            problems.append(
                f"rid {rid!r}: expected exactly one terminal event, got "
                f"{terms if terms else 'none'}")
    return problems
