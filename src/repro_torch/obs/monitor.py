"""Online SLO monitoring: burn-rate alerts and anomaly detection at sim time.

`SLOMonitor` is a `Tracer` sink (see `tracer.Tracer.add_sink`): it consumes
trace events the moment the engine emits them — terminal instants feed SLO
compliance, counter samples feed anomaly detectors — with no second pass
over the event list. Everything it computes is emitted back into the trace
(`slo.window`, `alert.*`, `anomaly.*` instants), so Perfetto, the report,
and the dashboard all show *when the system knew* it was in trouble.

SLO model (SRE-style, in simulated time)
----------------------------------------
An `SLO` reduces to a bad-event predicate plus an error budget:

  * latency objective `metric_p{pct} <= threshold` — a completed request
    is *bad* when its metric exceeds the threshold; the implied budget is
    `1 - pct/100` (p99 permits 1% bad).
  * `goodput >= threshold` — a request is *bad* when it is shed/dropped
    or misses any configured latency objective; budget is `1 - threshold`.

Compliance is evaluated over tumbling windows of width `SLO.window`
(`StreamingQuantiles` per window — exact percentiles at these sizes), and
the **burn rate** over rolling windows is `bad_frac / budget`: burn 1.0
spends the budget exactly at the sustainable rate, burn N spends it N×
too fast.

Each SLO carries multi-window multi-burn-rate alert rules (`BurnRateRule`;
defaults scale the classic fast/slow pair to the SLO window `W`):

  * `fast_burn` — long `W`,  short `W/6`, burn >= 14.4
  * `slow_burn` — long `4W`, short `W/2`, burn >= 6

A rule trips when *both* its windows exceed the burn threshold (the short
window makes alerts resolve quickly once the incident ends), walking the
lifecycle `pending -> firing -> resolved`, each transition emitted as an
`alert.{state}` instant carrying the rule, both window burn values, and
the budget remaining. Rolling-window bad counts ride a bucketed
`WindowedAggregator` (bucket = `W / buckets_per_window`); rules are
evaluated at bucket boundaries, so detection latency is one bucket.

Anomaly detection
-----------------
Per (replica, series) EWMA z-score detectors over the counter timelines —
queue depth, KV occupancy, and busy fraction (derived from the cumulative
`busy_s` counter) — flag straggler/overload onset as `anomaly.{series}`
instants, with hysteresis (an episode ends only when |z| falls below half
the onset threshold) so a flapping series emits one onset, not hundreds.

Determinism: the monitor is pure arithmetic over the event stream, so a
seeded run produces an identical alert timeline, and `replay()` over the
recorded trace reproduces the online result exactly (the online/offline
agreement test pins this).

A copy of `repro.obs.monitor` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .quantiles import StreamingQuantiles, WindowedAggregator
from .tracer import TERMINALS


@dataclass(frozen=True)
class SLO:
    """One objective: a latency percentile gate (`metric` in
    ttft/tpot/e2e with `pct`) or `metric="goodput"` (`pct` ignored).
    `threshold` is seconds for latency metrics, a fraction in (0, 1] for
    goodput. `window` is the tumbling compliance window in simulated
    seconds."""

    metric: str
    threshold: float
    pct: float | None = 99.0
    window: float = 30.0

    def __post_init__(self):
        if self.metric not in ("ttft", "tpot", "e2e", "goodput"):
            raise ValueError(f"unknown SLO metric {self.metric!r}")
        if self.window <= 0:
            raise ValueError("SLO window must be positive")
        if self.metric == "goodput" and not 0.0 < self.threshold <= 1.0:
            raise ValueError("goodput threshold must be a fraction in (0, 1]")

    @property
    def name(self) -> str:
        if self.metric == "goodput":
            return f"goodput>={self.threshold:g}"
        return f"{self.metric}_p{self.pct:g}<={self.threshold:g}s"

    @property
    def budget_frac(self) -> float:
        """Tolerable bad-event fraction implied by the objective."""
        if self.metric == "goodput":
            frac = 1.0 - self.threshold
        else:
            frac = 1.0 - (self.pct if self.pct is not None else 99.0) / 100.0
        return max(frac, 1e-6)


@dataclass(frozen=True)
class BurnRateRule:
    """One multi-window burn-rate alert rule: trips when the error-budget
    burn rate over BOTH the long and short rolling windows is >= `burn`;
    stays pending for `for_s` simulated seconds before firing."""

    name: str
    long_window: float
    short_window: float
    burn: float
    for_s: float = 0.0


def default_rules(window: float) -> tuple[BurnRateRule, ...]:
    """The SRE fast/slow burn pair scaled to the SLO window."""
    return (
        BurnRateRule("fast_burn", long_window=window, short_window=window / 6.0,
                     burn=14.4),
        BurnRateRule("slow_burn", long_window=4.0 * window, short_window=window / 2.0,
                     burn=6.0),
    )


@dataclass(frozen=True)
class AnomalyConfig:
    """EWMA z-score anomaly detection over counter series. `alpha` is the
    EWMA weight, `z` the onset threshold (episodes end below `z/2`),
    `warmup` the samples a series must accumulate before it may flag."""

    series: tuple[str, ...] = ("queue", "kv_used", "busy_frac")
    alpha: float = 0.08
    z: float = 4.0
    warmup: int = 24


def make_slos(*, slo_ttft: float | None = None, slo_goodput: float | None = None,
              window: float = 30.0, pct: float = 99.0) -> tuple[SLO, ...]:
    """CLI helper: the `--slo-ttft/--slo-goodput/--slo-window` flags ->
    SLO tuple (empty when neither objective is given)."""
    slos = []
    if slo_ttft is not None:
        slos.append(SLO("ttft", slo_ttft, pct=pct, window=window))
    if slo_goodput is not None:
        slos.append(SLO("goodput", slo_goodput, pct=None, window=window))
    return tuple(slos)


class _Ewma:
    """Online EWMA mean/variance with z-score hysteresis for one
    (track, series) pair."""

    __slots__ = ("mean", "var", "n", "active")

    def __init__(self):
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.active = False

    def update(self, x: float, alpha: float, z_on: float, warmup: int):
        """Feed one sample; returns the z-score if this sample *starts* an
        anomalous episode, else None."""
        onset = None
        if self.n >= warmup:
            std = math.sqrt(self.var)
            if std > 1e-9:
                z = (x - self.mean) / std
                if not self.active and abs(z) >= z_on:
                    self.active = True
                    onset = z
                elif self.active and abs(z) < z_on / 2.0:
                    self.active = False
        self.n += 1
        d = x - self.mean
        self.mean += alpha * d
        self.var = (1.0 - alpha) * (self.var + alpha * d * d)
        return onset


class _SloState:
    """Per-SLO mutable state: tumbling compliance windows, bucketed bad
    counts for the rolling burn windows, cumulative budget accounting,
    and per-rule alert state machines."""

    def __init__(self, slo: SLO, rules, buckets_per_window: int):
        self.slo = slo
        self.rules = tuple(rules)
        self.dt = slo.window / buckets_per_window  # burn-bucket width
        self.buckets = WindowedAggregator(self.dt)
        self.open: dict[int, dict] = {}  # window idx -> {"sq"/"n"/"bad"}
        self.next_close: int | None = None  # lowest unclosed window idx
        self.last_bucket: int | None = None  # last rule-eval bucket
        self.n = 0  # cumulative eligible events
        self.bad = 0
        self.windows: list[dict] = []  # closed-window rows
        self.time_in_violation = 0.0
        # rule name -> [state, pending_since]
        self.alert: dict[str, list] = {r.name: ["ok", 0.0] for r in self.rules}

    @property
    def budget_consumed(self) -> float:
        if self.n == 0:
            return 0.0
        return (self.bad / self.n) / self.slo.budget_frac


class SLOMonitor:
    """Online SLO/burn-rate/anomaly monitor; attach with
    `tracer.add_sink(monitor)` (or pass `monitor=` to the engines, which
    do the wiring). After the run, `finish(horizon)` closes open windows
    and `result()` returns the summary dict `summarize_cluster` and the
    report consume."""

    def __init__(self, slos, *, rules=None, anomaly: AnomalyConfig | None = AnomalyConfig(),
                 buckets_per_window: int = 24):
        self.slos = tuple(slos)
        self._states = [
            _SloState(s, default_rules(s.window) if rules is None else rules,
                      buckets_per_window)
            for s in self.slos]
        self._latency_gates = [s for s in self.slos if s.metric != "goodput"]
        self.anomaly_cfg = anomaly
        self._detectors: dict[tuple[str, str], _Ewma] = {}
        self._busy_prev: dict[str, tuple[float, float]] = {}  # track -> (t, busy_s)
        self.alerts: list[dict] = []  # lifecycle transitions, time-ordered
        self.anomalies: list[dict] = []
        self.alerts_fired = 0
        self._tracer = None
        self._finished = False

    # -- tracer sink protocol -------------------------------------------
    def bind(self, tracer) -> None:
        self._tracer = tracer

    def _instant(self, name, t, track="", **attrs) -> None:
        tr = self._tracer
        if tr is not None and tr.wants("summary"):
            tr.instant(name, t, track=track, **attrs)

    def on_event(self, ev: dict) -> None:
        kind = ev.get("ev")
        if kind == "instant":
            name = ev["name"]
            if name in TERMINALS:
                self._on_terminal(name, ev)
        elif kind == "counter":
            cfg = self.anomaly_cfg
            if cfg is not None:
                self._on_counter(ev, cfg)

    # -- SLO compliance --------------------------------------------------
    def _on_terminal(self, name: str, ev: dict) -> None:
        t = ev["t"]
        attrs = ev.get("attrs", {})
        completed = name == "request.complete"
        good_latency = True
        if completed:
            for s in self._latency_gates:
                v = attrs.get(s.metric)
                if v is not None and v > s.threshold:
                    good_latency = False
                    break
        for st in self._states:
            slo = st.slo
            if slo.metric == "goodput":
                bad = (not completed) or (not good_latency)
                self._feed(st, t, None, bad)
            elif completed:
                v = attrs.get(slo.metric)
                if v is not None:
                    self._feed(st, t, float(v), v > slo.threshold)

    def _feed(self, st: _SloState, t: float, value: float | None, bad: bool) -> None:
        slo = st.slo
        k = int(math.floor(t / slo.window))
        if st.next_close is not None and k < st.next_close:
            win = None  # late event for an already-closed window: count it
            # toward the cumulative budget below, but never re-open
        else:
            win = st.open.get(k)
            if win is None:
                win = st.open[k] = {"n": 0, "bad": 0,
                                    "sq": None if value is None else
                                    StreamingQuantiles(pcts=(slo.pct,))}
                if st.next_close is None:
                    st.next_close = k
        if win is not None:
            win["n"] += 1
            win["bad"] += int(bad)
            if value is not None and win["sq"] is not None:
                win["sq"].add(value)
        st.n += 1
        st.bad += int(bad)
        st.buckets.add(t, "bad", 1.0 if bad else 0.0)
        self._advance(st, t)

    def _advance(self, st: _SloState, clock: float) -> None:
        """Close every tumbling window that ended before `clock` and run
        the alert rules at each crossed burn-bucket boundary."""
        slo = st.slo
        if st.next_close is not None:
            while (st.next_close + 1) * slo.window <= clock:
                self._close_window(st, st.next_close)
                st.next_close += 1
        b = int(math.floor(clock / st.dt))
        if st.last_bucket is None:
            st.last_bucket = b - 1
        while st.last_bucket < b:
            st.last_bucket += 1
            self._eval_rules(st, st.last_bucket * st.dt)

    def _close_window(self, st: _SloState, k: int) -> None:
        slo = st.slo
        t0, t1 = k * slo.window, (k + 1) * slo.window
        win = st.open.pop(k, None)
        n = win["n"] if win else 0
        bad = win["bad"] if win else 0
        if n == 0:
            value, ok, burn = None, None, 0.0
        else:
            if slo.metric == "goodput":
                value = 1.0 - bad / n
                ok = value >= slo.threshold
            else:
                value = win["sq"].quantile(slo.pct)
                ok = value <= slo.threshold
            burn = (bad / n) / slo.budget_frac
        if ok is False:
            st.time_in_violation += slo.window
        row = {"slo": slo.name, "t0": t0, "t1": t1, "n": n, "bad": bad,
               "value": value, "ok": ok, "burn": burn,
               "budget_remaining": 1.0 - st.budget_consumed}
        st.windows.append(row)
        self._instant("slo.window", t1, slo=slo.name, t0=t0, n=n, bad=bad,
                      value=value, threshold=slo.threshold, ok=ok, burn=burn,
                      budget_remaining=row["budget_remaining"])

    def _burn(self, st: _SloState, t: float, window: float) -> float:
        r = st.buckets.range_stats("bad", t - window, t)
        if r["n"] == 0:
            return 0.0
        return (r["sum"] / r["n"]) / st.slo.budget_frac

    def _eval_rules(self, st: _SloState, t: float) -> None:
        for rule in st.rules:
            burn_long = self._burn(st, t, rule.long_window)
            burn_short = self._burn(st, t, rule.short_window)
            cond = burn_long >= rule.burn and burn_short >= rule.burn
            state = st.alert[rule.name]
            if cond:
                if state[0] == "ok":
                    state[0], state[1] = "pending", t
                    self._transition(st, rule, "pending", t, burn_long, burn_short)
                if state[0] == "pending" and t - state[1] >= rule.for_s:
                    state[0] = "firing"
                    self.alerts_fired += 1
                    self._transition(st, rule, "firing", t, burn_long, burn_short)
            else:
                if state[0] == "firing":
                    self._transition(st, rule, "resolved", t, burn_long, burn_short)
                state[0] = "ok"

    def _transition(self, st, rule, to_state, t, burn_long, burn_short) -> None:
        rec = {"t": t, "state": to_state, "rule": rule.name, "slo": st.slo.name,
               "burn_long": burn_long, "burn_short": burn_short,
               "burn_threshold": rule.burn,
               "budget_remaining": 1.0 - st.budget_consumed}
        self.alerts.append(rec)
        self._instant(f"alert.{to_state}", t, rule=rule.name, slo=st.slo.name,
                      burn_long=burn_long, burn_short=burn_short,
                      burn_threshold=rule.burn,
                      budget_remaining=rec["budget_remaining"])

    # -- anomaly detection ----------------------------------------------
    def _on_counter(self, ev: dict, cfg: AnomalyConfig) -> None:
        name, track, t = ev["name"], ev.get("track", ""), ev["t"]
        if name == "busy_s" and "busy_frac" in cfg.series:
            prev = self._busy_prev.get(track)
            self._busy_prev[track] = (t, ev["value"])
            if prev is None or t <= prev[0]:
                return
            name, value = "busy_frac", (ev["value"] - prev[1]) / (t - prev[0])
        elif name in cfg.series:
            value = ev["value"]
        else:
            return
        det = self._detectors.get((track, name))
        if det is None:
            det = self._detectors[(track, name)] = _Ewma()
        z = det.update(value, cfg.alpha, cfg.z, cfg.warmup)
        if z is not None:
            self.anomalies.append({"t": t, "track": track, "series": name,
                                   "value": value, "z": z})
            self._instant(f"anomaly.{name}", t, track=track, value=value,
                          z=z, mean=det.mean)

    # -- end of run ------------------------------------------------------
    def finish(self, horizon: float) -> None:
        """Close remaining windows and run a final rule evaluation at the
        run horizon. Idempotent."""
        if self._finished:
            return
        self._finished = True
        for st in self._states:
            if st.next_close is not None:
                while st.open and st.next_close <= max(st.open):
                    self._close_window(st, st.next_close)
                    st.next_close += 1
            self._advance(st, horizon)

    def result(self) -> dict:
        """Summary dict: per-SLO compliance, budget accounting, alert and
        anomaly timelines, and the roll-up columns `summarize_cluster`
        surfaces (`time_in_violation` is the union across SLOs)."""
        slo_rows = []
        violated: list[tuple[float, float]] = []
        for st in self._states:
            slo = st.slo
            slo_rows.append({
                "name": slo.name, "metric": slo.metric, "pct": slo.pct,
                "threshold": slo.threshold, "window": slo.window,
                "budget_frac": slo.budget_frac,
                "n": st.n, "bad": st.bad,
                "bad_frac": st.bad / st.n if st.n else 0.0,
                "budget_consumed": st.budget_consumed,
                "budget_remaining": 1.0 - st.budget_consumed,
                "time_in_violation": st.time_in_violation,
                "windows": list(st.windows),
            })
            violated.extend((w["t0"], w["t1"]) for w in st.windows
                            if w["ok"] is False)
        return {
            "slos": slo_rows,
            "alerts": list(self.alerts),
            "alerts_fired": self.alerts_fired,
            "anomalies": list(self.anomalies),
            "time_in_violation": _union_len(violated),
            "budget_burn": max((r["budget_consumed"] for r in slo_rows),
                               default=0.0),
        }


def _union_len(intervals) -> float:
    """Total length of the union of (t0, t1) intervals."""
    total, end = 0.0, -math.inf
    for t0, t1 in sorted(intervals):
        if t1 <= end:
            continue
        total += t1 - max(t0, end)
        end = t1
    return total


def replay(meta: dict, events, slos, *, rules=None,
           anomaly: AnomalyConfig | None = AnomalyConfig(),
           buckets_per_window: int = 24) -> dict:
    """Offline recompute: run an `SLOMonitor` over a recorded trace and
    return its `result()`. Events are sorted by time first (recorded
    traces may interleave post-run span emission), which is exactly the
    order the online monitor saw, so `replay` on a monitored run's own
    trace reproduces the online result bit-for-bit — the online/offline
    agreement contract."""
    mon = SLOMonitor(slos, rules=rules, anomaly=anomaly,
                     buckets_per_window=buckets_per_window)
    horizon = meta.get("horizon", 0.0)
    for ev in sorted(events, key=_ev_time):
        mon.on_event(ev)
        horizon = max(horizon, _ev_time(ev))
    mon.finish(horizon)
    return mon.result()


def _ev_time(ev: dict) -> float:
    t = ev.get("t")
    if t is None:
        t = ev.get("t1", ev.get("t0", 0.0))
    return t
