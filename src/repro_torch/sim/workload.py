"""Seeded workload generation for the serving simulator.

A `Workload` is a declarative spec — arrival process (constant, Poisson,
bursty hyperexponential, diurnal, rate-envelope replay), prompt/output
length distributions (fixed, lognormal), or a JSONL trace replay — that
`generate()` expands into a deterministic list of `SimRequest`s. The same
spec drives both the analytical simulator (`repro_torch.sim.scheduler`) and the
real `ServeEngine` (via `to_engine_requests`), so simulated and executed
schedules are comparable request-for-request.

Time-varying arrivals are a non-homogeneous Poisson process sampled by
Lewis-Shedler thinning of a homogeneous process at the envelope peak:

  * `arrival="diurnal"`  — sinusoidal rate envelope
    `rate(t) = qps * (1 + diurnal_amp * sin(2*pi*(t/diurnal_period +
    diurnal_phase)))`, the compressed day/night cycle autoscaling studies
    are run against (mean rate stays `qps`).
  * `arrival="envelope"` — piecewise-linear rate envelope replayed from a
    JSONL file (`rate_path`) of {"t": seconds, "qps": rate} rows (aliases
    "time"/"rate"), for replaying measured production rate curves.

`rate_at(t)` exposes the envelope so autoscaling policies and plots can
reference the offered load the generator drew from; `peak_rate(t0, t1)`
is its lookahead form — the maximum offered rate over a window, which is
what a predictive autoscaler provisioning capacity that takes `warmup`
seconds to come online must target (pass `Workload.peak_rate` as
`AutoscaleConfig.envelope`).

Trace JSONL rows: {"arrival": s, "prompt": n, "output": m} — the aliases
"arrival_s", "prompt_tokens"/"input_tokens", "output_tokens" are accepted
(the inference-perf trace convention); optional "session" and "slo_ttft"
keys feed affinity routing and EDF admission, and optional
"prefix_group"/"prefix_len" keys mark a shared prompt prefix (system
prompt / few-shot header) for the modeled prefix cache. Rows without
"arrival" get arrivals from the configured arrival process. Synthetic
specs generate shared prefixes via `num_prefix_groups` (each group draws
one prefix length from the `prefix` distribution).

For multi-replica experiments that need *independent* per-replica streams
(rather than one shared stream split by a router), `substreams(n)` shards
the spec through `np.random.SeedSequence.spawn`, avoiding the correlation
artifacts of naive `seed + i` reseeding.

A copy of `repro.sim.workload` (the port imports nothing of the JAX package);
`tests/test_torch_sim.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace

import numpy as np


@dataclass(frozen=True)
class SimRequest:
    rid: int
    arrival: float  # seconds from workload start
    prompt: int  # prompt tokens
    output: int  # tokens to generate (>= 1)
    session: int = -1  # session/prefix-affinity key (-1 = none)
    slo_ttft: float | None = None  # per-request TTFT deadline offset (EDF)
    prefix_group: int = -1  # shared-prefix group id (-1 = none); the first
    prefix_len: int = 0  # `prefix_len` prompt tokens are the group's shared
    #                      prefix (system prompt / few-shot header), reusable
    #                      across sessions by the modeled prefix cache


@dataclass(frozen=True)
class LengthDist:
    kind: str = "fixed"  # fixed | lognormal
    mean: float = 512.0
    sigma: float = 0.5  # lognormal shape (log-space std)
    lo: int = 1
    hi: int = 131072

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Draw `n` lengths (tokens), clipped to [lo, hi]."""
        if self.kind == "fixed":
            vals = np.full(n, self.mean)
        elif self.kind == "lognormal":
            # parameterized so E[X] == mean
            mu = np.log(max(self.mean, 1.0)) - 0.5 * self.sigma**2
            vals = rng.lognormal(mu, self.sigma, size=n)
        else:
            raise ValueError(f"unknown length dist {self.kind!r}")
        return np.clip(np.rint(vals), self.lo, self.hi).astype(np.int64)


@dataclass(frozen=True)
class Workload:
    name: str = "synthetic"
    qps: float = 8.0
    num_requests: int = 128
    arrival: str = "poisson"  # constant | poisson | bursty | diurnal | envelope
    prompt: LengthDist = field(default_factory=lambda: LengthDist("lognormal", 512.0))
    output: LengthDist = field(default_factory=lambda: LengthDist("fixed", 128.0))
    seed: int = 0
    # bursty = hyperexponential: `burst_fraction` of gaps drawn at
    # `burst_factor`x the base rate, the rest stretched to keep mean qps
    burst_factor: float = 8.0
    burst_fraction: float = 0.2
    trace_path: str | None = None
    num_sessions: int = 0  # >0: assign each request a session id in [0, n)
    slo_ttft: float | tuple | None = None  # scalar, or tuple sampled per request
    # shared-prefix groups (multi-tenant system prompts / few-shot headers):
    # each request joins a group in [0, n); each GROUP draws one prefix
    # length from `prefix` — the shared head of every member's prompt,
    # reusable across sessions by a cluster's modeled prefix cache (repro.cluster)
    num_prefix_groups: int = 0
    prefix: LengthDist = field(default_factory=lambda: LengthDist("fixed", 256.0))
    # diurnal envelope: mean rate stays `qps`, peak is qps * (1 + amp)
    diurnal_period: float = 240.0  # seconds per (compressed) day
    diurnal_amp: float = 0.8  # relative swing, in [0, 1]
    diurnal_phase: float = 0.0  # cycle offset, fraction of a period
    rate_path: str | None = None  # JSONL rate envelope (arrival="envelope")

    # ------------------------------------------------------------- generation
    def generate(self) -> list[SimRequest]:
        """Materialize the request stream: arrival times in seconds from
        t=0, prompt/output lengths in tokens; pure function of the spec
        (seeded — same spec, same stream)."""
        if self.trace_path is not None:
            return self._replay_trace()
        rng = np.random.default_rng(self.seed)
        gaps = self._gaps(rng, self.num_requests)
        arrivals = np.cumsum(gaps)
        prompts = self.prompt.sample(rng, self.num_requests)
        outputs = self.output.sample(rng, self.num_requests)
        # optional draws come last so specs without them keep the exact
        # request streams earlier PRs generated
        sessions = (rng.integers(0, self.num_sessions, size=self.num_requests)
                    if self.num_sessions > 0 else None)
        slos = self._sample_slos(rng, self.num_requests)
        groups = plens = None
        if self.num_prefix_groups > 0:
            # one prefix length per GROUP (all members share the same
            # header), then a group per request; a request's cacheable
            # prefix is capped at prompt - 1 (the final token always runs)
            group_len = self.prefix.sample(rng, self.num_prefix_groups)
            groups = rng.integers(0, self.num_prefix_groups,
                                  size=self.num_requests)
            plens = np.minimum(group_len[groups],
                               np.maximum(prompts - 1, 0))
        return [
            SimRequest(i, float(arrivals[i]), int(prompts[i]), max(int(outputs[i]), 1),
                       session=int(sessions[i]) if sessions is not None else -1,
                       slo_ttft=slos[i],
                       prefix_group=int(groups[i]) if groups is not None else -1,
                       prefix_len=int(plens[i]) if plens is not None else 0)
            for i in range(self.num_requests)
        ]

    def _sample_slos(self, rng: np.random.Generator, n: int) -> list:
        if self.slo_ttft is None:
            return [None] * n
        if isinstance(self.slo_ttft, (int, float)):
            return [float(self.slo_ttft)] * n
        choices = [float(x) for x in self.slo_ttft]
        return [choices[i] for i in rng.integers(0, len(choices), size=n)]

    def substreams(self, n: int) -> list["Workload"]:
        """Shard into `n` decorrelated sub-workloads (1/n of the rate and
        request count each) via `SeedSequence.spawn` — the spawned child
        seeds are statistically independent, unlike `seed + i` reseeding
        which correlates the low bits of neighbouring streams."""
        if n < 1:
            raise ValueError("substreams needs n >= 1")
        if self.trace_path is not None or self.rate_path is not None:
            raise ValueError("substreams applies to synthetic specs, not "
                             "trace/envelope replays")
        children = np.random.SeedSequence(self.seed).spawn(n)
        counts = [self.num_requests // n + (1 if i < self.num_requests % n else 0)
                  for i in range(n)]
        return [
            replace(self, name=f"{self.name}[{i}/{n}]", qps=self.qps / n,
                    num_requests=counts[i],
                    seed=int(children[i].generate_state(1)[0]))
            for i in range(n)
        ]

    # -------------------------------------------------------- rate envelopes
    def _envelope(self) -> tuple[np.ndarray, np.ndarray]:
        """(times, rates) breakpoints of the piecewise-linear envelope,
        parsed once per spec (frozen dataclass; cached out-of-band)."""
        cached = getattr(self, "_env_cache", None)
        if cached is not None:
            return cached
        if self.rate_path is None:
            raise ValueError('arrival="envelope" needs rate_path=')
        ts, rs = [], []
        with open(self.rate_path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                t = row.get("t", row.get("time"))
                r = row.get("qps", row.get("rate"))
                if t is None or r is None:
                    raise ValueError(f"rate envelope row {i} needs t/qps: {row}")
                if float(r) < 0:
                    raise ValueError(f"rate envelope row {i} has negative rate")
                ts.append(float(t))
                rs.append(float(r))
        if not ts:
            raise ValueError(f"rate envelope {self.rate_path!r} is empty")
        order = np.argsort(ts, kind="stable")
        ts_a, rs_a = np.asarray(ts)[order], np.asarray(rs)[order]
        if rs_a[-1] <= 0:
            # the envelope is held constant past its last breakpoint, so a
            # zero tail means arrivals stop forever — thinning would spin
            raise ValueError(
                f"rate envelope {self.rate_path!r} ends at rate 0; the tail "
                "rate is held forever and the workload could never finish "
                "generating (end the trace on a positive rate)")
        object.__setattr__(self, "_env_cache", (ts_a, rs_a))
        return ts_a, rs_a

    def rate_at(self, t: float) -> float:
        """Offered arrival rate (requests/s) at time `t` under this spec's
        envelope; constant specs just return `qps`."""
        if self.arrival == "diurnal":
            return self.qps * (1.0 + self.diurnal_amp * np.sin(
                2.0 * np.pi * (t / self.diurnal_period + self.diurnal_phase)))
        if self.arrival == "envelope":
            ts, rs = self._envelope()
            return float(np.interp(t, ts, rs))
        return self.qps

    def peak_rate(self, t0: float, t1: float) -> float:
        """Maximum offered arrival rate (requests/s) over [t0, t1].

        The envelope-lookahead a predictive autoscaler runs on: capacity
        ordered at `t0` that takes `t1 - t0` seconds to warm up must be
        sized for the PEAK rate of the window, not the instantaneous rate
        at either end (on the downslope of a diurnal crest the endpoint
        rates understate the crest still inside the window).

          * diurnal  — closed form: the sinusoid's crest if one falls
            inside the window, else the larger endpoint (the envelope is
            monotonic between extremes).
          * envelope — the max over both endpoints and every breakpoint
            strictly inside the window (the replay is piecewise-linear).
          * constant/poisson/bursty — `qps` (flat envelope).
        """
        if t1 < t0:
            raise ValueError("peak_rate needs t1 >= t0")
        if self.arrival == "diurnal":
            # rate crests where sin(.) == 1: t* = (0.25 - phase + k) * P
            period = self.diurnal_period
            t_star = (0.25 - self.diurnal_phase) * period
            k = math.ceil((t0 - t_star) / period)
            if t_star + k * period <= t1:
                return self.qps * (1.0 + self.diurnal_amp)
            return max(self.rate_at(t0), self.rate_at(t1))
        if self.arrival == "envelope":
            ts, rs = self._envelope()
            inside = rs[(ts > t0) & (ts < t1)]
            peak = max(self.rate_at(t0), self.rate_at(t1))
            return float(max(peak, inside.max())) if inside.size else peak
        return self.qps

    def _thinned_arrivals(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Non-homogeneous Poisson arrivals by Lewis-Shedler thinning: draw a
        homogeneous process at the envelope peak, accept each candidate with
        probability rate(t)/peak. One uniform is drawn per candidate, so the
        stream is deterministic in (seed, envelope)."""
        if self.arrival == "diurnal":
            if not 0.0 <= self.diurnal_amp <= 1.0:
                raise ValueError("diurnal_amp must be in [0, 1]")
            if self.diurnal_period <= 0:
                raise ValueError("diurnal_period must be positive")
            lam_max = self.qps * (1.0 + self.diurnal_amp)
        else:
            lam_max = float(self._envelope()[1].max())
        if lam_max <= 0:
            raise ValueError("rate envelope peak must be positive")
        out = np.empty(n)
        t, i = 0.0, 0
        while i < n:
            t += rng.exponential(1.0 / lam_max)
            if rng.random() * lam_max <= self.rate_at(t):
                out[i] = t
                i += 1
        return out

    def _gaps(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.arrival == "envelope":
            return np.diff(self._thinned_arrivals(rng, n), prepend=0.0)
        if self.qps <= 0:
            raise ValueError("qps must be positive")
        if self.arrival == "diurnal":
            return np.diff(self._thinned_arrivals(rng, n), prepend=0.0)
        mean_gap = 1.0 / self.qps
        if self.arrival == "constant":
            return np.full(n, mean_gap)
        if self.arrival == "poisson":
            return rng.exponential(mean_gap, size=n)
        if self.arrival == "bursty":
            bf = min(max(self.burst_fraction, 0.0), 0.95)
            m_burst = mean_gap / self.burst_factor
            m_off = (mean_gap - bf * m_burst) / (1.0 - bf)
            in_burst = rng.random(n) < bf
            gaps = rng.exponential(m_off, size=n)
            gaps[in_burst] = rng.exponential(m_burst, size=int(in_burst.sum()))
            return gaps
        raise ValueError(f"unknown arrival process {self.arrival!r}")

    def _replay_trace(self) -> list[SimRequest]:
        rows = []
        with open(self.trace_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        rng = np.random.default_rng(self.seed)
        gaps = self._gaps(rng, len(rows))
        synth_arrivals = np.cumsum(gaps)
        reqs = []
        for i, row in enumerate(rows):
            arrival = row.get("arrival", row.get("arrival_s"))
            if arrival is None:
                arrival = float(synth_arrivals[i])
            prompt = row.get("prompt", row.get("prompt_tokens", row.get("input_tokens")))
            output = row.get("output", row.get("output_tokens"))
            if prompt is None or output is None:
                raise ValueError(f"trace row {i} missing prompt/output tokens: {row}")
            slo = row.get("slo_ttft")
            if slo is None and isinstance(self.slo_ttft, (int, float)):
                slo = float(self.slo_ttft)
            prompt_n = max(int(prompt), 1)
            group = int(row.get("prefix_group", -1))
            plen = min(max(int(row.get("prefix_len", 0)), 0), prompt_n - 1) \
                if group >= 0 else 0
            reqs.append(SimRequest(i, float(arrival), prompt_n,
                                   max(int(output), 1),
                                   session=int(row.get("session", -1)),
                                   slo_ttft=slo,
                                   prefix_group=group, prefix_len=plen))
        reqs.sort(key=lambda r: (r.arrival, r.rid))
        return reqs


def to_engine_requests(reqs: list[SimRequest], vocab_size: int, *, seed: int = 0):
    """Materialize `SimRequest`s as `repro_torch.serve.engine.Request`s (random
    token ids of the spec'd lengths) so the real engine runs the same
    schedule the simulator priced. Imports the engine (and torch) lazily."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [
        Request(
            prompt=rng.integers(0, vocab_size, size=r.prompt).astype(np.int32),
            max_new_tokens=r.output,
        )
        for r in reqs
    ]
