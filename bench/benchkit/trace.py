"""A traced part of the window: `torch.profiler` over the host's ops and the
device's activity, reduced to what the per-layer readers need.

- `busy_s`: the union of the device's activity intervals (kernels, copies,
  fills), not their sum, over `window_s`, the traced part's host wall;
- `kernels`: device seconds and launches by kernel name;
- `device_ops` and `idle_gaps`: the breakdown of the result line. A gap is
  an interval in which the device ran nothing; it is named by the innermost
  host op, annotation or runtime call that spans its middle, or "host python"
  where none does.
"""

from __future__ import annotations

import re
import time

import torch
from torch.autograd import DeviceType

TOP = 10


INTERNAL = ("Activity Buffer Request",)  # the profiler's own host events


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameter list."""
    while "<" in name:
        cut = re.sub(r"<[^<>]*>", "", name)
        if cut == name:
            break
        name = cut
    name = name.replace("(anonymous namespace)", "anon").split("(")[0]
    return name.removeprefix("void ").strip()[:96]


class Traced:
    """`with Traced(on) as t:` profiles its body when `on`. Stopping the profiler
    takes time that is no part of the work: `t.pause_s` says how long, for the
    window to leave out, and `t.summary()` reduces the trace later (None when off)."""

    def __init__(self, on: bool, device: torch.device):
        self.on, self.device, self.pause_s, self.prof = on, device, 0.0, None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        if not self.on:
            return self
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        self._sync()
        t = time.perf_counter()
        self.wall = t - self.t0
        self.prof.__exit__(*exc)
        self.pause_s = time.perf_counter() - t
        return False

    def summary(self) -> dict | None:
        if self.prof is None:
            return None
        out = summarize(self.prof.profiler.kineto_results.events(), self.wall)
        self.prof = None
        return out


def _union(spans: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events, wall_s: float) -> dict:
    dev, host, spans = [], [], set()
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if d <= 0:
            continue
        if e.device_type() == DeviceType.CPU:
            if e.name() not in INTERNAL:
                host.append((a, a + d, e.name()))
            if e.is_user_annotation():
                spans.add(e.name())
        else:
            dev.append((a, a + d, e.name(), e.is_user_annotation()))
    # a host span (`record_function`) has a mirror on the device's timeline: not work
    dev = [(a, b, n) for a, b, n, note in dev if not note and n not in spans]
    kernels: dict[str, list] = {}
    for a, b, name in dev:
        k = kernels.setdefault(_short(name), [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e9
    busy = _union([(a, b) for a, b, _ in dev])
    lo = min([a for a, _, _ in host + dev], default=0)
    hi = max([b for _, b, _ in host + dev], default=0)
    edges = [lo] + [x for span in busy for x in span] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    named = []
    for a, b in gaps:
        mid = (a + b) // 2
        over = [(e - s, n) for s, e, n in host if s <= mid < e and not n.startswith("ProfilerStep")]
        named.append([min(over)[1] if over else "host python", (b - a) / 1e9])
    return {
        "window_s": wall_s,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "kernels": {k: {"launches": n, "seconds": s} for k, (n, s) in kernels.items()},
        "device_ops": [[k, s] for k, (_, s) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]],
        "idle_gaps": named,
    }


def kernel_seconds(summary: dict, pattern: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose short name matches `pattern`."""
    rx = re.compile(pattern)
    hits = [v for k, v in summary["kernels"].items() if rx.search(k)]
    return sum(v["launches"] for v in hits), sum(v["seconds"] for v in hits)
