"""Streaming percentiles and windowed aggregation.

The fleet-scale engine (ROADMAP item 3) targets 10^6-request traces;
retaining a per-request record list just to compute p99.9 at the end is
exactly the memory pattern that caps it. This module provides the
bounded-memory alternatives, and `repro_torch.sim.metrics.summarize_records`
routes its exact percentiles through the same convention so the two can
never drift apart on key names or interpolation:

  * `percentile_summary` — the ONE exact percentile helper (numpy linear
    interpolation, the `np.percentile` default) every summary dict uses,
    with the shared `PCTS` convention (p50/p95/p99/p99.9).
  * `P2Quantile` — the classic P-squared online estimator (Jain & Chlamtac
    1985): one quantile in O(1) memory, five markers adjusted by a
    piecewise-parabolic fit.
  * `StreamingQuantiles` — the production estimator: P² for the body plus
    an EXACT top-k tail reservoir, so the tail quantiles a serving SLO
    actually gates on (p99, p99.9) are computed exactly (identical to
    `np.percentile`) whenever the tail rank falls inside the reservoir —
    for the default `tail_k=1024` that is p99 up to ~100k samples and
    p99.9 up to ~1M — and fall back to P² beyond it. Memory is O(tail_k)
    regardless of stream length.
  * `WindowedAggregator` — fixed-width time windows accumulating
    count/mean/min/max per named series: the rolling aggregate behind the
    CSV time-series exporter (`repro_torch.obs.export.write_csv`).

All estimators are deterministic functions of the insertion order, so
seeded simulations produce identical summaries run-to-run.

A copy of `repro.obs.quantiles` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

# the percentile convention every summary dict shares (keys are rendered
# with %g, so 99.9 -> "p99.9" and 50 -> "p50")
PCTS = (50, 95, 99, 99.9)


def pct_key(name: str, p: float) -> str:
    """The summary-dict key for percentile `p` of series `name`
    (`pct_key("ttft", 99.9) == "ttft_p99.9"`)."""
    return f"{name}_p{p:g}"


def percentile_summary(xs, name: str, pcts=PCTS) -> dict:
    """Exact percentile + mean dict for one series: `{name}_p{p}` for each
    `p` in `pcts` plus `{name}_mean` (all 0.0 for an empty series). This is
    the single exact-percentile code path — `summarize_records` and every
    other summary dict route through it so interpolation and key naming
    cannot drift."""
    xs = np.asarray(xs, dtype=float)
    out = {}
    for p in pcts:
        out[pct_key(name, p)] = float(np.percentile(xs, p)) if len(xs) else 0.0
    out[f"{name}_mean"] = float(xs.mean()) if len(xs) else 0.0
    return out


class P2Quantile:
    """P-squared single-quantile estimator (Jain & Chlamtac 1985).

    Five markers track (min, q/2-ish, q, (1+q)/2-ish, max); marker heights
    are adjusted toward their desired positions with a piecewise-parabolic
    (P²) fit, falling back to linear when the parabola would break
    monotonicity. O(1) memory, O(1) per observation."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        self.q = float(q)
        self.n = 0
        self._h: list[float] = []  # marker heights (first 5 obs, then fixed)
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]  # actual marker positions
        self._want = [1.0, 1.0 + 2 * q, 1.0 + 4 * q, 3.0 + 2 * q, 5.0]
        self._dwant = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]

    def add(self, x: float) -> None:
        self.n += 1
        h = self._h
        if self.n <= 5:
            h.append(float(x))
            h.sort()
            return
        # locate the cell k: h[k] <= x < h[k+1], clamping the extremes
        if x < h[0]:
            h[0] = float(x)
            k = 0
        elif x >= h[4]:
            h[4] = float(x)
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dwant[i]
        # adjust the three interior markers toward their desired positions
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            pos, prev, nxt = self._pos[i], self._pos[i - 1], self._pos[i + 1]
            if (d >= 1.0 and nxt - pos > 1.0) or (d <= -1.0 and prev - pos < -1.0):
                s = 1.0 if d >= 1.0 else -1.0
                hp = h[i] + s / (nxt - prev) * (
                    (pos - prev + s) * (h[i + 1] - h[i]) / (nxt - pos)
                    + (nxt - pos - s) * (h[i] - h[i - 1]) / (pos - prev))
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp  # parabolic
                else:  # linear fallback preserves monotonicity
                    j = i + int(s)
                    h[i] += s * (h[j] - h[i]) / (self._pos[j] - pos)
                self._pos[i] += s

    def value(self) -> float:
        """Current estimate (exact for n <= 5; 0.0 before any data)."""
        if not self._h:
            return 0.0
        if self.n <= 5:
            # exact: numpy linear interpolation over the sorted sample
            return float(np.percentile(self._h, self.q * 100.0))
        return self._h[2]


class StreamingQuantiles:
    """Multi-quantile streaming summary with exact tails.

    `add()` feeds one observation; `quantile(p)` / `summary(name)` read.
    Internally each requested percentile runs a `P2Quantile`, and a
    min-heap reservoir retains the largest `tail_k` observations. A read
    whose rank lands inside the reservoir (every quantile when
    `n <= tail_k`; otherwise the top `tail_k` ranks — p99.9 up to
    n ~= 1000 * tail_k) is answered EXACTLY with numpy's linear
    interpolation, so small-to-medium traces reproduce `np.percentile`
    bit-for-bit and only genuinely huge streams pay the P² approximation,
    and then only for body quantiles the tail can't cover."""

    def __init__(self, pcts=PCTS, tail_k: int = 1024):
        if tail_k < 2:
            raise ValueError("tail_k must be >= 2")
        self.pcts = tuple(pcts)
        self.tail_k = int(tail_k)
        self._p2 = {p: P2Quantile(p / 100.0) for p in self.pcts}
        self._tail: list[float] = []  # min-heap of the largest tail_k
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, x: float) -> None:
        x = float(x)
        self.n += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        for est in self._p2.values():
            est.add(x)
        if len(self._tail) < self.tail_k:
            heapq.heappush(self._tail, x)
        elif x > self._tail[0]:
            heapq.heapreplace(self._tail, x)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def quantile(self, p: float) -> float:
        """Percentile `p` in [0, 100]: exact when its rank falls inside
        the tail reservoir, P² estimate otherwise."""
        if self.n == 0:
            return 0.0
        pos = (p / 100.0) * (self.n - 1)  # numpy 'linear' rank
        first_tail_rank = self.n - len(self._tail)
        if pos >= first_tail_rank or self.n <= len(self._tail):
            tail = sorted(self._tail)
            i = pos - first_tail_rank
            lo = max(int(math.floor(i)), 0)
            hi = min(int(math.ceil(i)), len(tail) - 1)
            return tail[lo] + (i - lo) * (tail[hi] - tail[lo])
        est = self._p2.get(p)
        v = est.value() if est is not None else P2Quantile(p / 100.0).value()
        return min(max(v, self.min), self.max)

    def summary(self, name: str) -> dict:
        """Same key shape as `percentile_summary` (and exactly equal to it
        whenever every requested rank is tail-resident)."""
        out = {pct_key(name, p): self.quantile(p) for p in self.pcts}
        out[f"{name}_mean"] = self.mean
        return out


class WindowedAggregator:
    """Fixed-width time-window aggregation of named series.

    `add(t, name, value)` buckets the observation into window
    `floor(t / dt)`; `rows()` returns one dict per non-empty window
    (sorted by time) with `t0`/`t1` bounds and, per series seen in it,
    `{name}_n/_mean/_min/_max/_last`. This is the rolling aggregate the
    CSV time-series exporter renders, and the bounded-memory substitute
    for keeping raw counter timelines at fleet scale.

    Out-of-order timestamps are safe: observations land in the window
    their own `t` selects (buckets are dict-keyed, never "current"), and
    `_last` tracks the latest-`t` observation rather than the latest
    `add()` call. `rows(fill_gaps=True)` additionally emits a bare
    `{"t0", "t1", "gap": True}` row for every empty window between the
    first and last non-empty one, so downstream time axes (CSV export,
    the dashboard) stay contiguous."""

    def __init__(self, dt: float):
        if dt <= 0:
            raise ValueError("window width dt must be positive")
        self.dt = float(dt)
        # (window index, series) -> [n, sum, min, max, last_t, last_value]
        self._w: dict[tuple[int, str], list] = {}

    def add(self, t: float, name: str, value: float) -> None:
        key = (int(math.floor(t / self.dt)), name)
        cell = self._w.get(key)
        v = float(value)
        if cell is None:
            self._w[key] = [1, v, v, v, t, v]
            return
        cell[0] += 1
        cell[1] += v
        cell[2] = min(cell[2], v)
        cell[3] = max(cell[3], v)
        if t >= cell[4]:
            cell[4], cell[5] = t, v

    def rows(self, *, fill_gaps: bool = False) -> list[dict]:
        wins: dict[int, dict] = {}
        for (w, name), (n, s, lo, hi, _, last) in sorted(self._w.items()):
            row = wins.setdefault(w, {"t0": w * self.dt, "t1": (w + 1) * self.dt})
            row[f"{name}_n"] = n
            row[f"{name}_mean"] = s / n
            row[f"{name}_min"] = lo
            row[f"{name}_max"] = hi
            row[f"{name}_last"] = last
        if not wins:
            return []
        if fill_gaps:
            lo, hi = min(wins), max(wins)
            return [wins.get(w, {"t0": w * self.dt, "t1": (w + 1) * self.dt,
                                 "gap": True})
                    for w in range(lo, hi + 1)]
        return [wins[w] for w in sorted(wins)]

    def range_stats(self, name: str, t0: float, t1: float) -> dict:
        """Count and sum of series `name` over the buckets overlapping
        `[t0, t1)`. Bucket-granular: partial buckets at the edges are
        counted whole, so callers that align `t0`/`t1` to multiples of
        `dt` (the SLO monitor's burn-rate windows) get exact totals."""
        k0 = int(math.floor(t0 / self.dt))
        k1 = int(math.ceil(t1 / self.dt))
        n, s = 0, 0.0
        for k in range(k0, k1):
            cell = self._w.get((k, name))
            if cell is not None:
                n += cell[0]
                s += cell[1]
        return {"n": n, "sum": s}
