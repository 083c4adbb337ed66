"""Trace exporters: Chrome trace-event JSON, JSONL event log, windowed CSV.

Three renderings of the same `Tracer.events` stream:

  * `to_chrome` / `write_chrome` — Chrome trace-event format, loadable in
    Perfetto (https://ui.perfetto.dev) or `chrome://tracing`. Each track
    (cluster, one per replica) becomes a named thread; structural spans
    (`provisioned`/`warmup`/`drain`) are complete ("X") events, which
    Chrome requires to nest per thread; request lifecycle spans overlap
    freely on a replica so they are exported as async ("b"/"e") events
    keyed by request id; counters are "C" events and render as area
    charts. Timestamps are microseconds, matching the format spec.
  * `write_jsonl` / `read_jsonl` — the raw event dicts, one JSON object
    per line, preceded by a meta header line carrying the schema version
    and the run's time origin/horizon. This is the schema-stable format
    the offline analyzer (`python -m repro_torch.obs report`) consumes and the
    golden trace test pins.
  * `write_csv` — counter timelines windowed through
    `WindowedAggregator` into long-format rows
    (`t0,t1,track,series,n,mean,min,max,last`), ready for pandas or a
    spreadsheet; empty windows between data emit explicit `n=0` gap rows
    so the time axis is contiguous.

`write_trace` picks the format from the path suffix: `.jsonl` → JSONL,
`.csv` → CSV, anything else → Chrome JSON.

A copy of `repro.obs.export` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import csv
import io
import json
import math

from .quantiles import WindowedAggregator
from .tracer import STRUCTURAL_SPANS

_US = 1e6  # trace times are seconds; Chrome wants microseconds


def _track_ids(events) -> dict[str, int]:
    """Stable track -> tid map: cluster-scope track '' is tid 0, the rest
    sorted by name (replica names sort r0, r1, ... within a pool)."""
    tracks = {ev.get("track", "") for ev in events if ev.get("ev") != "meta"}
    tracks.add("")
    ordered = [""] + sorted(t for t in tracks if t)
    return {t: i for i, t in enumerate(ordered)}

def to_chrome(events, meta=None) -> dict:
    """Render an event stream as a Chrome trace-event JSON object
    (`{"traceEvents": [...], "displayTimeUnit": "ms", ...}`)."""
    tids = _track_ids(events)
    out = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "repro serving sim"}}]
    for track, tid in tids.items():
        out.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                    "args": {"name": track or "cluster"}})
        out.append({"ph": "M", "name": "thread_sort_index", "pid": 0,
                    "tid": tid, "args": {"sort_index": tid}})
    for ev in events:
        kind = ev.get("ev")
        if kind == "meta":
            continue
        track = ev.get("track", "")
        tid = tids[track]
        name = ev["name"]
        args = dict(ev.get("attrs", ()))
        if "rid" in ev:
            args["rid"] = ev["rid"]
        if kind == "span":
            ts, dur = ev["t0"] * _US, max(ev["t1"] - ev["t0"], 0.0) * _US
            if "rid" in ev and name not in STRUCTURAL_SPANS:
                # request phases overlap within a track -> async events,
                # grouped per request by id
                common = {"cat": "request", "id": str(ev["rid"]), "pid": 0,
                          "tid": tid}
                out.append({"ph": "b", "name": name, "ts": ts, "args": args,
                            **common})
                out.append({"ph": "e", "name": name, "ts": ts + dur, **common})
            else:
                out.append({"ph": "X", "name": name, "ts": ts, "dur": dur,
                            "pid": 0, "tid": tid, "args": args})
        elif kind == "instant":
            out.append({"ph": "i", "name": name, "ts": ev["t"] * _US, "s": "t",
                        "pid": 0, "tid": tid, "args": args})
        elif kind == "counter":
            # one counter chart per (track, series); Chrome keys counters
            # by (pid, name), so the track is folded into the name
            cname = f"{track or 'cluster'}/{name}"
            out.append({"ph": "C", "name": cname, "ts": ev["t"] * _US,
                        "pid": 0, "tid": tid, "args": {name: ev["value"]}})
    trace = {"traceEvents": out, "displayTimeUnit": "ms"}
    if meta:
        trace["otherData"] = dict(meta)
    return trace


def write_chrome(events, path, meta=None) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome(events, meta), f)
        f.write("\n")


def write_jsonl(events, path, meta=None) -> None:
    """Raw event log: a meta header line, then one event JSON per line."""
    with open(path, "w") as f:
        head = {"ev": "meta", "schema": "repro.obs/1"}
        if meta:
            head.update(meta)
            head["schema"] = "repro.obs/1"
        f.write(json.dumps(head) + "\n")
        for ev in events:
            if ev.get("ev") != "meta":
                f.write(json.dumps(ev) + "\n")


def read_jsonl(path) -> tuple[dict, list[dict]]:
    """Load a JSONL trace -> (meta, events). Tolerates a missing header
    (returns an empty meta dict)."""
    meta: dict = {}
    events: list[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if ev.get("ev") == "meta":
                meta = {k: v for k, v in ev.items() if k != "ev"}
            else:
                events.append(ev)
    return meta, events


def csv_rows(events, window: float = 1.0) -> list[dict]:
    """Window the counter timelines: long-format rows
    `t0,t1,track,series,n,mean,min,max,last`, sorted by (t0, track,
    series). Span/instant events are not windowed — use JSONL for those."""
    aggs: dict[str, WindowedAggregator] = {}
    for ev in events:
        if ev.get("ev") != "counter":
            continue
        track = ev.get("track", "")
        agg = aggs.get(track)
        if agg is None:
            agg = aggs[track] = WindowedAggregator(window)
        agg.add(ev["t"], ev["name"], ev["value"])
    rows: list[dict] = []
    for track, agg in aggs.items():
        wrows = agg.rows(fill_gaps=True)
        # a gap row (empty window) still emits one n=0 row per series the
        # track carries, so the exported time axis is contiguous
        all_series = sorted({k.rsplit("_", 1)[0] for wrow in wrows
                             for k in wrow if k not in ("t0", "t1", "gap")})
        for wrow in wrows:
            if wrow.get("gap"):
                for s in all_series:
                    rows.append({"t0": wrow["t0"], "t1": wrow["t1"],
                                 "track": track or "cluster", "series": s,
                                 "n": 0, "mean": "", "min": "", "max": "",
                                 "last": ""})
                continue
            series = sorted({k.rsplit("_", 1)[0] for k in wrow
                             if k not in ("t0", "t1")})
            for s in series:
                rows.append({"t0": wrow["t0"], "t1": wrow["t1"],
                             "track": track or "cluster", "series": s,
                             "n": wrow[f"{s}_n"], "mean": wrow[f"{s}_mean"],
                             "min": wrow[f"{s}_min"], "max": wrow[f"{s}_max"],
                             "last": wrow[f"{s}_last"]})
    rows.sort(key=lambda r: (r["t0"], r["track"], r["series"]))
    return rows


def write_csv(events, path, window: float = 1.0) -> None:
    rows = csv_rows(events, window)
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=["t0", "t1", "track", "series", "n",
                                        "mean", "min", "max", "last"])
    w.writeheader()
    for r in rows:
        w.writerow(r)
    with open(path, "w") as f:
        f.write(buf.getvalue())


def write_trace(events, path, meta=None, *, window: float = 1.0) -> str:
    """Export `events` to `path`, picking the format from the suffix
    (.jsonl -> JSONL log, .csv -> windowed CSV, else Chrome JSON).
    Returns the format written ('jsonl' | 'csv' | 'chrome')."""
    p = str(path)
    if p.endswith(".jsonl"):
        write_jsonl(events, p, meta)
        return "jsonl"
    if p.endswith(".csv"):
        if meta and meta.get("horizon"):
            # aim for ~100 windows across the horizon, rounded to a tidy width
            span = float(meta["horizon"]) - float(meta.get("t0", 0.0))
            if span > 0:
                window = max(10.0 ** math.floor(math.log10(max(span / 100.0, 1e-9))), 1e-9)
        write_csv(events, p, window)
        return "csv"
    write_chrome(events, p, meta)
    return "chrome"
