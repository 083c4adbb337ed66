"""Autoscaling policies for the dynamic cluster simulator.

An `Autoscaler` is the control loop of `simulate_cluster(..., autoscale=)`:
every `interval` seconds it observes the fleet and returns the replica
count it should converge to. Policies fall into two families:

Reactive (track what already happened through a rolling window):

  * `rate`       — track the observed arrival rate: desired replicas =
                   ceil(rate / target_qps_per_replica), the classic
                   requests-per-replica target-tracking policy.
  * `slo_debt`   — track the rolling TTFT-violation fraction of completed
                   requests: scale up while debt exceeds `debt_hi`, scale
                   down (one replica per tick) once it falls under
                   `debt_lo`. Workload-shape-agnostic, but pays the debt
                   before correcting it.
  * `queue_wait` — track the rolling mean admission-queue wait (seconds a
                   request sat queued before a slot opened): up above
                   `wait_hi`, down below `wait_lo`. The natural signal for
                   a disaggregated PREFILL pool, whose backlog is queued
                   prompts rather than resident KV.
  * `kv_tpot`    — track KV-cache pressure (mean occupancy fraction of
                   the pool's accepting replicas) plus the rolling
                   TPOT-violation fraction: up when either `kv_hi` /
                   `debt_hi` is breached, down when both are under
                   `kv_lo` / `debt_lo`. The natural signal for a DECODE
                   pool, which saturates on resident cache and inter-token
                   latency, not on arrival rate.

Predictive (provision for what is about to happen):

  * `predictive` — feed the KNOWN rate envelope (`AutoscaleConfig.
                   envelope`, e.g. `Workload.peak_rate` for the diurnal
                   closed form or a JSONL rate replay) and an M/G/1-style
                   per-replica wait estimate into `desired()`. At each
                   tick the policy provisions for the PEAK offered rate
                   over the next `lookahead` seconds (default: warmup +
                   interval), choosing the smallest replica count whose
                   Pollaczek-Khinchine queueing wait stays under
                   `target_wait`. Because the horizon covers the warmup,
                   scale-ups LEAD the ramp instead of trailing it by
                   warmup + window — the paper's analytical-foresight
                   thesis applied to fleet control. Without an envelope it
                   degrades gracefully to the observed rate (still gaining
                   the queueing-theoretic sizing). The per-request service
                   time E[S] is priced from `ServingCostModel` step costs
                   (`AutoscaleConfig.effective_service_time`).

Scale-up is not free: a replica spends `warmup` seconds loading weights
before it can accept traffic. When `warmup` is None it is priced from the
serving cost model — per-device resident weight bytes over the host
weight-load link (`host_bw`) — so bigger models genuinely take longer to
join, which is exactly the lag that makes diurnal provisioning hard.
Scale-down is graceful: the cluster engine first cancels replicas still
warming, then drains live ones (no new admissions, in-flight work runs
out) — see `repro_torch.cluster.cluster`.

Units throughout: times/waits in seconds, rates in requests/second,
bandwidths in bytes/second, token counts in tokens.

A copy of `repro.cluster.autoscale` (the port imports nothing of the JAX package);
`tests/test_torch_cluster_dynamic.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Callable

from repro_torch.sim.costmodel import ServingCostModel
from repro_torch.sim.scheduler import SchedConfig

AUTOSCALE_POLICIES = ("rate", "slo_debt", "predictive", "queue_wait",
                      "kv_tpot")

# PCIe gen5 x16 ballpark: the host-to-device link each device's weight
# shard streams over while a replica warms up
DEFAULT_HOST_BW = 64e9

_INF = float("inf")


class RollingMeanWindow:
    """(timestamp, value) observations over a trailing time window with a
    rolling mean — the admission-wait signal behind `queue_wait`, and the
    base of every rolling signal here. Entries are pruned both on `add`
    (so windows that are written but never read — a policy that ignores
    them — stay O(window x rate), not O(run length)) and on `mean` (the
    read time may be later than the last write)."""

    def __init__(self, window: float):
        if window <= 0:
            raise ValueError("window must be positive")
        self.window = float(window)
        self._q: deque[tuple[float, float]] = deque()

    def add(self, t: float, value: float) -> None:
        """Record `value` observed at time `t` (seconds); drops samples
        older than the window."""
        q = self._q
        q.append((t, float(value)))
        horizon = t - self.window
        while q and q[0][0] < horizon:
            q.popleft()

    def mean(self, now: float) -> float:
        """Mean of the values observed in [now - window, now] (0.0 when
        the window is empty)."""
        q = self._q
        horizon = now - self.window
        while q and q[0][0] < horizon:
            q.popleft()
        if not q:
            return 0.0
        return sum(v for _, v in q) / len(q)

    def count(self, now: float) -> int:
        """Number of observations still inside [now - window, now] — the
        sample-size gate the admission circuit breaker trips on."""
        q = self._q
        horizon = now - self.window
        while q and q[0][0] < horizon:
            q.popleft()
        return len(q)


class RollingFlagWindow(RollingMeanWindow):
    """Rolling violation fraction: a `RollingMeanWindow` over 0/1 flags —
    the one implementation shared by the autoscaler's SLO-debt signals
    and the `slo_debt` router (so their window semantics cannot drift
    apart)."""

    def add(self, t: float, flag: bool) -> None:
        """Record a violation flag observed at time `t` (seconds)."""
        super().add(t, 1.0 if flag else 0.0)

    def frac(self, now: float) -> float:
        """Fraction of set flags among observations in [now - window, now]
        (0 when the window is empty)."""
        return self.mean(now)


@dataclass(frozen=True)
class AutoscaleConfig:
    """Declarative autoscaling spec for one fleet (or, pool-aware, one
    pool — pass `{"prefill": asc_p, "decode": asc_d}` to
    `simulate_cluster(..., autoscale=)` to scale pools independently).

    Fields (units in brackets; only the fields of the chosen `policy`
    matter, the rest are ignored):

      policy                  one of `AUTOSCALE_POLICIES`.
      min_replicas /
      max_replicas            clamp on `desired()` [replicas].
      interval                control-loop period [s].
      window                  rolling observation window [s].
      target_qps_per_replica  `rate` policy setpoint [req/s per replica].
      slo_ttft                TTFT deadline the `slo_debt` signal scores
                              against [s].
      debt_hi / debt_lo       `slo_debt` + `kv_tpot` hysteresis band on
                              the rolling violation fraction [0..1].
      warmup                  replica activation delay [s]; None prices
                              weight loading from the cost model.
      host_bw                 weight-load link [bytes/s per device].
      envelope                `predictive`: peak offered rate over a
                              window, `envelope(t0, t1) -> req/s` — pass
                              `Workload.peak_rate` (see `repro_torch.sim`).
      lookahead               `predictive` horizon [s]; None -> warmup +
                              interval (capacity ordered now is ready
                              exactly when the horizon arrives).
      target_wait             `predictive`: admission-wait budget the
                              M/G/1 estimate must clear [s]; None ->
                              0.5 * slo_ttft.
      service_time            `predictive`: per-request effective service
                              time E[S] override [s]; None -> priced from
                              the cost model via `effective_service_time`.
      service_cv2             `predictive`: squared coefficient of
                              variation of the service time (1.0 = M/M/1;
                              lognormal token lengths push it above 1).
      mean_prompt /
      mean_output             traffic shape for pricing E[S] [tokens].
      wait_hi / wait_lo       `queue_wait` hysteresis band on the rolling
                              mean admission wait [s].
      slo_tpot                TPOT deadline the `kv_tpot` debt scores
                              against [s/token].
      kv_hi / kv_lo           `kv_tpot` hysteresis band on mean KV
                              occupancy fraction [0..1].
      spare                   N+k redundancy: replicas held above every
                              policy's ask (within the clamp), absorbing
                              a crash while the replacement warms
                              [replicas].
    """

    policy: str = "rate"
    min_replicas: int = 1
    max_replicas: int = 8
    interval: float = 5.0  # control-loop period (s)
    window: float = 15.0  # rolling observation window (s)
    target_qps_per_replica: float = 8.0  # rate policy setpoint
    slo_ttft: float = 2.0  # TTFT deadline the debt signal scores against
    debt_hi: float = 0.10  # scale up while violation fraction exceeds this
    debt_lo: float = 0.02  # scale down once it falls below this
    warmup: float | None = None  # s; None -> weight bytes over host_bw
    host_bw: float = DEFAULT_HOST_BW  # bytes/s per device for weight loading
    # predictive policy
    envelope: Callable[[float, float], float] | None = None  # peak qps fn
    lookahead: float | None = None  # s; None -> warmup + interval
    target_wait: float | None = None  # s; None -> 0.5 * slo_ttft
    service_time: float | None = None  # s; None -> priced from cost model
    service_cv2: float = 1.0  # squared CV of service time (1.0 = M/M/1)
    mean_prompt: float = 512.0  # tokens, for pricing E[S]
    mean_output: float = 128.0  # tokens, for pricing E[S]
    # queue_wait policy (prefill pools)
    wait_hi: float = 0.5  # s: scale up while mean admission wait exceeds
    wait_lo: float = 0.1  # s: scale down once it falls below
    # kv_tpot policy (decode pools)
    slo_tpot: float = 0.05  # s/token TPOT deadline for the debt signal
    kv_hi: float = 0.85  # KV occupancy fraction: scale up above
    kv_lo: float = 0.40  # KV occupancy fraction: scale down below
    # N+k redundancy: replicas held ABOVE what the policy asks for, so a
    # crash (repro_torch.cluster.chaos) leaves the policy's desired capacity
    # intact while the replacement warms (0 = size for steady state)
    spare: int = 0

    def validate(self) -> None:
        """Raise ValueError on any out-of-domain field combination."""
        if self.policy not in AUTOSCALE_POLICIES:
            raise ValueError(f"unknown autoscale policy {self.policy!r}; "
                             f"choose from {AUTOSCALE_POLICIES}")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.interval <= 0 or self.window <= 0:
            raise ValueError("interval and window must be positive")
        if self.target_qps_per_replica <= 0:
            raise ValueError("target_qps_per_replica must be positive")
        if not 0.0 <= self.debt_lo <= self.debt_hi <= 1.0:
            raise ValueError("need 0 <= debt_lo <= debt_hi <= 1")
        if self.warmup is not None and self.warmup < 0:
            raise ValueError("warmup must be >= 0")
        if self.host_bw <= 0:
            raise ValueError("host_bw must be positive")
        if self.lookahead is not None and self.lookahead <= 0:
            raise ValueError("lookahead must be positive")
        if self.target_wait is not None and self.target_wait <= 0:
            raise ValueError("target_wait must be positive")
        if self.service_time is not None and self.service_time <= 0:
            raise ValueError("service_time must be positive")
        if self.service_cv2 < 0:
            raise ValueError("service_cv2 must be >= 0")
        if self.mean_prompt < 1 or self.mean_output < 1:
            raise ValueError("mean_prompt and mean_output must be >= 1")
        if self.spare < 0:
            raise ValueError("spare must be >= 0")
        if not 0.0 <= self.wait_lo <= self.wait_hi:
            raise ValueError("need 0 <= wait_lo <= wait_hi")
        if self.slo_tpot <= 0:
            raise ValueError("slo_tpot must be positive")
        if not 0.0 <= self.kv_lo <= self.kv_hi <= 1.0:
            raise ValueError("need 0 <= kv_lo <= kv_hi <= 1")

    def warmup_seconds(self, cost: ServingCostModel) -> float:
        """Replica activation delay in seconds: the explicit override, or
        the time to stream each device's resident weight shard over the
        host link (shards load in parallel across the replica's devices)."""
        if self.warmup is not None:
            return self.warmup
        return cost.weight_bytes / self.host_bw

    def effective_service_time(self, cost: ServingCostModel,
                               sched: SchedConfig | None = None,
                               pool: str = "mixed") -> float:
        """Per-request effective service time E[S] in seconds, priced from
        the cost model's step costs for the configured traffic shape
        (`mean_prompt` / `mean_output` tokens).

        The replica is modeled at its batch-saturated throughput: a batch
        of `sched.slots` requests completes one request per
        t_request / slots, where t_request = prefill(mean_prompt) +
        (mean_output - 1) decode steps at the mean context. Pool variants:

          * "prefill" — prompts are compute-bound and process serially, so
            E[S] is the whole-prompt prefill time (no batching discount).
          * "decode"  — decode steps only, amortized over the batch.
          * "mixed"   — prefill + decode amortized over the batch.

        This is the single-number server model the `predictive` policy's
        M/G/1 estimate runs on; `service_time` on the config overrides it.
        """
        if self.service_time is not None:
            return self.service_time
        slots = max(sched.slots if sched is not None else 16, 1)
        prompt = max(int(round(self.mean_prompt)), 1)
        output = max(int(round(self.mean_output)), 1)
        ctx = prompt + output // 2  # mean resident context while decoding
        prefill = cost.prefill_time(prompt)
        decode = max(output - 1, 0) * cost.decode_step_time(slots, ctx)
        if pool == "prefill":
            return prefill
        if pool == "decode":
            return max(decode, cost.decode_step_time(slots, ctx)) / slots
        return (prefill + decode) / slots


class Autoscaler:
    """Signal tracker + desired-count policy for one fleet or pool.

    The cluster engine feeds it arrivals (`observe_arrival`), completed
    requests' TTFTs (`observe_ttft`), admission waits (`observe_wait`),
    and per-token latencies (`observe_tpot`); `desired()` is evaluated at
    each control tick and clamped to [min_replicas, max_replicas].

    `cost` / `sched` / `pool` resolve the predictive policy's derived
    quantities at construction: the effective service time E[S] (from
    `AutoscaleConfig.effective_service_time`) and the lookahead horizon
    (warmup + interval when the config leaves `lookahead` unset). Reactive
    policies need neither and may construct with `Autoscaler(asc)` alone.
    """

    def __init__(self, asc: AutoscaleConfig, *,
                 cost: ServingCostModel | None = None,
                 sched: SchedConfig | None = None, pool: str = "mixed"):
        asc.validate()
        self.asc = asc
        self._arrivals: deque[float] = deque()
        self._debt = RollingFlagWindow(asc.window)
        self._tpot_debt = RollingFlagWindow(asc.window)
        self._wait = RollingMeanWindow(asc.window)
        self.service_time = asc.service_time
        if self.service_time is None and cost is not None:
            self.service_time = asc.effective_service_time(cost, sched, pool)
        if asc.lookahead is not None:
            self.lookahead = asc.lookahead
        else:
            warm = (asc.warmup_seconds(cost) if cost is not None
                    else (asc.warmup or 0.0))
            self.lookahead = warm + asc.interval
        if asc.policy == "predictive" and self.service_time is None:
            raise ValueError(
                "predictive policy needs service_time= on the config or a "
                "cost model at Autoscaler construction")
        # the inputs behind the most recent desired() call — what the
        # tracer's autoscale.decision events record, so every scale-up/
        # down in a trace is explainable from the policy's own signals
        self.last_decision: dict = {}

    # ------------------------------------------------------------ observation
    def observe_arrival(self, t: float) -> None:
        """Record one request arrival at time `t` (s). Arrivals older
        than the window are pruned here too, so the deque stays bounded
        even under policies that never read the rate."""
        self._arrivals.append(t)
        horizon = t - self.asc.window
        while self._arrivals and self._arrivals[0] < horizon:
            self._arrivals.popleft()

    def observe_ttft(self, t: float, ttft: float) -> None:
        """Record a completed request's end-to-end TTFT (s), observed at
        completion time `t` — the `slo_debt` policy's input."""
        self._debt.add(t, ttft > self.asc.slo_ttft)

    def observe_wait(self, t: float, wait: float) -> None:
        """Record a completed request's admission-queue wait (s) — the
        `queue_wait` policy's input."""
        self._wait.add(t, wait)

    def observe_tpot(self, t: float, tpot: float) -> None:
        """Record a completed request's mean inter-token time (s/token) —
        half of the `kv_tpot` policy's input."""
        self._tpot_debt.add(t, tpot > self.asc.slo_tpot)

    def observed_rate(self, now: float) -> float:
        """Arrival rate (req/s) over the (possibly still-filling) window."""
        horizon = now - self.asc.window
        while self._arrivals and self._arrivals[0] < horizon:
            self._arrivals.popleft()
        denom = max(min(now, self.asc.window), 1e-9)
        return len(self._arrivals) / denom

    def slo_debt(self, now: float) -> float:
        """Rolling TTFT-violation fraction (0 with no completions yet)."""
        return self._debt.frac(now)

    def tpot_debt(self, now: float) -> float:
        """Rolling TPOT-violation fraction (0 with no completions yet)."""
        return self._tpot_debt.frac(now)

    def queue_wait(self, now: float) -> float:
        """Rolling mean admission wait in seconds (0 when the window is
        empty)."""
        return self._wait.mean(now)

    # ---------------------------------------------------------------- policy
    def predicted_wait(self, rate: float, n: int) -> float:
        """Pollaczek-Khinchine M/G/1 queueing-wait estimate in seconds for
        `n` replicas sharing `rate` req/s of arrivals.

        Each replica is an M/G/1 server at rate/n arrivals with service
        time E[S] = `self.service_time` and squared CV `service_cv2`:

            rho = (rate / n) * E[S]
            Wq  = rho * (1 + cv^2) / 2 * E[S] / (1 - rho)

        Returns inf at or beyond saturation (rho >= 1)."""
        if n < 1 or self.service_time is None:
            return _INF
        rho = rate * self.service_time / n
        if rho >= 1.0:
            return _INF
        return (rho * (1.0 + self.asc.service_cv2) / 2.0
                * self.service_time / (1.0 - rho))

    def desired(self, now: float, provisioned: int, *,
                kv_frac: float = 0.0) -> int:
        """Replica count to converge to, clamped to [min, max].

        `provisioned` is the number of replicas currently active or
        warming (draining ones are already gone); `kv_frac` is the mean
        KV-occupancy fraction of the pool's accepting replicas at `now`
        (only the `kv_tpot` policy reads it)."""
        asc = self.asc
        inputs: dict = {}
        if asc.policy == "rate":
            rate = self.observed_rate(now)
            want = math.ceil(rate / asc.target_qps_per_replica)
            inputs = {"rate": rate,
                      "target_qps_per_replica": asc.target_qps_per_replica}
        elif asc.policy == "predictive":
            if asc.envelope is not None:
                rate = asc.envelope(now, now + self.lookahead)
            else:
                rate = self.observed_rate(now)
            budget = (asc.target_wait if asc.target_wait is not None
                      else 0.5 * asc.slo_ttft)
            want = asc.max_replicas
            for n in range(asc.min_replicas, asc.max_replicas + 1):
                if self.predicted_wait(rate, n) <= budget:
                    want = n
                    break
            pw = self.predicted_wait(rate, want)
            inputs = {"predicted_rate": rate, "wait_budget": budget,
                      "predicted_wait": pw if pw != _INF else -1.0,
                      "lookahead": self.lookahead}
        elif asc.policy == "queue_wait":
            wait = self.queue_wait(now)
            if wait > asc.wait_hi:
                want = provisioned + 1
            elif wait < asc.wait_lo:
                want = provisioned - 1
            else:
                want = provisioned
            inputs = {"queue_wait": wait, "wait_hi": asc.wait_hi,
                      "wait_lo": asc.wait_lo}
        elif asc.policy == "kv_tpot":
            debt = self.tpot_debt(now)
            if kv_frac > asc.kv_hi or debt > asc.debt_hi:
                want = provisioned + 1
            elif kv_frac < asc.kv_lo and debt < asc.debt_lo:
                want = provisioned - 1
            else:
                want = provisioned
            inputs = {"kv_frac": kv_frac, "tpot_debt": debt,
                      "kv_hi": asc.kv_hi, "debt_hi": asc.debt_hi}
        else:  # slo_debt
            debt = self.slo_debt(now)
            if debt > asc.debt_hi:
                want = provisioned + 1
            elif debt < asc.debt_lo:
                want = provisioned - 1
            else:
                want = provisioned
            inputs = {"slo_debt": debt, "debt_hi": asc.debt_hi,
                      "debt_lo": asc.debt_lo}
        # N+k redundancy rides on top of every policy's ask (still inside
        # the [min, max] clamp: spares never exceed the fleet's ceiling)
        clamped = max(asc.min_replicas,
                      min(asc.max_replicas, want + asc.spare))
        self.last_decision = {"policy": asc.policy, "provisioned": provisioned,
                              **inputs, "want_raw": want, "want": clamped}
        return clamped
