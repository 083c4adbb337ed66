"""Self-contained HTML dashboard for one trace: `repro_torch.obs report --html`.

Renders a single HTML page with inline SVG and zero JS/external deps —
shareable as one file, viewable offline, diffable in review:

  * stat tiles — requests/completions, TTFT p99, goodput, alerts fired,
    time in violation;
  * arrival-rate and replica-count timelines (the workload vs the fleet
    that served it);
  * TTFT percentile ribbons (p50/p95/p99 per window, ordinal blue ramp);
  * an alert ribbon aligned to the scaling timeline — pending/firing
    episodes drawn in status colors directly under the replica-count
    chart, so "when did the fleet react" and "when did the monitor know"
    sit on one shared time axis;
  * per-replica utilization strips (windowed busy fraction, sequential
    blue ramp) — present when the trace carries replica-level counters.

Charts degrade gracefully with trace level: a summary-level trace gets
tiles + whatever timelines its events can feed. Colors are defined once
as CSS custom properties (light + dark values; dark mode via
`prefers-color-scheme` and a `data-theme` override) and referenced by
role, so the page adapts without JS. A collapsible data table mirrors
the windowed values for non-visual reading.

A copy of `repro.obs.dashboard` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from __future__ import annotations

import html as _html
import math

from .quantiles import percentile_summary
from .report import analyze

# layout constants (px)
_W = 920          # drawable width incl. margins
_ML, _MR = 52, 14  # left/right margins (y tick labels live left)
_CH = 120          # timeline chart plot height
_STRIP = 16        # per-replica utilization strip height

# sequential blue ramp (light->dark) for the utilization heat strips;
# shared across modes — magnitude encoding, anchored at "near zero
# recedes toward the surface"
_SEQ = ("#cde2fb", "#9ec5f4", "#6da7ec", "#3987e5", "#256abf", "#184f95",
        "#0d366b")

_STATUS = {"pending": "var(--warning)", "firing": "var(--critical)",
           "resolved": "var(--good)"}

_CSS = """
.viz-root {
  color-scheme: light;
  --page:           #f9f9f7;
  --surface-1:      #fcfcfb;
  --text-primary:   #0b0b0b;
  --text-secondary: #52514e;
  --text-muted:     #898781;
  --gridline:       #e1e0d9;
  --baseline:       #c3c2b7;
  --border:         rgba(11,11,11,0.10);
  --series-1:       #2a78d6;
  --series-2:       #eb6834;
  --p50:            #86b6ef;
  --p95:            #2a78d6;
  --p99:            #104281;
  --good:           #0ca30c;
  --warning:        #fab219;
  --critical:       #d03b3b;
  background: var(--page);
  color: var(--text-primary);
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  margin: 0; padding: 20px;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --page:           #0d0d0d;
    --surface-1:      #1a1a19;
    --text-primary:   #ffffff;
    --text-secondary: #c3c2b7;
    --text-muted:     #898781;
    --gridline:       #2c2c2a;
    --baseline:       #383835;
    --border:         rgba(255,255,255,0.10);
    --series-1:       #3987e5;
    --series-2:       #d95926;
    --p50:            #9ec5f4;
    --p95:            #3987e5;
    --p99:            #184f95;
  }
}
:root[data-theme="dark"] .viz-root {
  color-scheme: dark;
  --page:           #0d0d0d;
  --surface-1:      #1a1a19;
  --text-primary:   #ffffff;
  --text-secondary: #c3c2b7;
  --text-muted:     #898781;
  --gridline:       #2c2c2a;
  --baseline:       #383835;
  --border:         rgba(255,255,255,0.10);
  --series-1:       #3987e5;
  --series-2:       #d95926;
  --p50:            #9ec5f4;
  --p95:            #3987e5;
  --p99:            #184f95;
}
.viz-root h1 { font-size: 18px; font-weight: 600; margin: 0 0 4px; }
.viz-root .sub { color: var(--text-muted); font-size: 12px; margin: 0 0 16px; }
.viz-root .tiles { display: flex; flex-wrap: wrap; gap: 12px; margin: 0 0 18px; }
.viz-root .tile { background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 10px 14px; min-width: 110px; }
.viz-root .tile .label { color: var(--text-secondary); font-size: 11px; }
.viz-root .tile .value { font-size: 22px; font-weight: 600; }
.viz-root .card { background: var(--surface-1); border: 1px solid var(--border);
  border-radius: 8px; padding: 12px 14px; margin: 0 0 14px; max-width: 960px; }
.viz-root .card h2 { font-size: 13px; font-weight: 600;
  color: var(--text-secondary); margin: 0 0 6px; }
.viz-root .legend { font-size: 11px; color: var(--text-secondary);
  margin: 2px 0 6px; }
.viz-root .legend span.key { display: inline-block; width: 14px; height: 3px;
  border-radius: 2px; margin: 0 4px 2px 10px; vertical-align: middle; }
.viz-root svg text { font-family: inherit; font-size: 10px;
  fill: var(--text-muted); }
.viz-root svg .tick { font-variant-numeric: tabular-nums; }
.viz-root table { border-collapse: collapse; font-size: 11px; }
.viz-root th, .viz-root td { padding: 2px 10px 2px 0; text-align: right;
  font-variant-numeric: tabular-nums; color: var(--text-secondary); }
.viz-root th { color: var(--text-muted); font-weight: 500; }
.viz-root details summary { font-size: 12px; color: var(--text-muted);
  cursor: pointer; }
"""


def _esc(s) -> str:
    return _html.escape(str(s), quote=True)


def _nice_ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    """Clean tick values spanning [lo, hi] (roughly n of them)."""
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / max(n, 1)
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next((m * mag for m in (1.0, 2.0, 2.5, 5.0, 10.0)
                 if m * mag >= raw), 10.0 * mag)
    t = math.ceil(lo / step) * step
    out = []
    while t <= hi + 1e-9 * step:
        out.append(round(t, 10))
        t += step
    return out or [lo]


def _fmt_t(v: float) -> str:
    return f"{v:g}s"


class _Scale:
    def __init__(self, lo, hi, a, b):
        self.lo, self.hi, self.a, self.b = lo, hi, a, b
        self.k = (b - a) / (hi - lo) if hi > lo else 0.0

    def __call__(self, v: float) -> float:
        return self.a + (v - self.lo) * self.k


def _svg_open(height: int) -> str:
    return (f'<svg viewBox="0 0 {_W} {height}" width="100%" '
            f'height="{height}" role="img">')


def _axes(x: _Scale, y: _Scale, h: int, *, y_fmt="{:g}") -> list[str]:
    """Hairline gridlines + tick labels + baseline for one plot area."""
    out = []
    for tv in _nice_ticks(y.lo, y.hi, 4):
        py = y(tv)
        out.append(f'<line x1="{_ML}" y1="{py:.1f}" x2="{_W - _MR}" '
                   f'y2="{py:.1f}" stroke="var(--gridline)" stroke-width="1"/>')
        out.append(f'<text class="tick" x="{_ML - 6}" y="{py + 3:.1f}" '
                   f'text-anchor="end">{y_fmt.format(tv)}</text>')
    for tv in _nice_ticks(x.lo, x.hi, 6):
        px = x(tv)
        out.append(f'<text class="tick" x="{px:.1f}" y="{h - 4}" '
                   f'text-anchor="middle">{_fmt_t(tv)}</text>')
    base = y(y.lo)
    out.append(f'<line x1="{_ML}" y1="{base:.1f}" x2="{_W - _MR}" '
               f'y2="{base:.1f}" stroke="var(--baseline)" stroke-width="1"/>')
    return out


def _path(pts) -> str:
    return "M" + " L".join(f"{x:.2f},{y:.2f}" for x, y in pts)


def _line_chart(title, series, t0, t1, *, unit="", legend=None,
                step=False) -> str:
    """One timeline card. `series` = [(label, css-color, [(t, v), ...])]."""
    pts_all = [v for _, _, pts in series for _, v in pts]
    if not pts_all:
        return ""
    h = _CH + 34
    vmax = max(pts_all)
    vmax = vmax if vmax > 0 else 1.0
    x = _Scale(t0, t1, _ML, _W - _MR)
    y = _Scale(0.0, vmax * 1.08, _CH + 8, 12)
    out = ['<div class="card">', f"<h2>{_esc(title)}</h2>"]
    if legend and len(series) > 1:
        out.append('<div class="legend">' + "".join(
            f'<span class="key" style="background:{c}"></span>{_esc(lbl)}'
            for lbl, c, _ in series) + "</div>")
    out.append(_svg_open(h))
    out.extend(_axes(x, y, h))
    for label, color, pts in series:
        if not pts:
            continue
        if step:
            spts = []
            for i, (t, v) in enumerate(pts):
                if i:
                    spts.append((x(t), y(pts[i - 1][1])))
                spts.append((x(t), y(v)))
            spts.append((x(t1), y(pts[-1][1])))
            d = _path(spts)
        else:
            d = _path([(x(t), y(v)) for t, v in pts])
        # area wash under the line (series hue at ~10% opacity)
        base = y(0.0)
        first_x = x(pts[0][0])
        out.append(f'<path d="{d} L{x(t1) if step else x(pts[-1][0]):.2f},'
                   f'{base:.2f} L{first_x:.2f},{base:.2f} Z" fill="{color}" '
                   f'opacity="0.1" stroke="none"/>')
        out.append(f'<path d="{d}" fill="none" stroke="{color}" '
                   f'stroke-width="2" stroke-linejoin="round" '
                   f'stroke-linecap="round"><title>{_esc(label)}{unit}'
                   f'</title></path>')
    out.append("</svg></div>")
    return "\n".join(out)


def _ribbon_chart(title, wins, t0, t1) -> str:
    """Percentile ribbon: p50/p95/p99 lines over the p50..p99 band.
    `wins` = [(tmid, p50, p95, p99), ...]."""
    if not wins:
        return ""
    h = _CH + 34
    vmax = max(w[3] for w in wins)
    vmax = vmax if vmax > 0 else 1.0
    x = _Scale(t0, t1, _ML, _W - _MR)
    y = _Scale(0.0, vmax * 1.08, _CH + 8, 12)
    keys = [("p50", "var(--p50)"), ("p95", "var(--p95)"), ("p99", "var(--p99)")]
    out = ['<div class="card">', f"<h2>{_esc(title)}</h2>",
           '<div class="legend">' + "".join(
               f'<span class="key" style="background:{c}"></span>{k}'
               for k, c in keys) + "</div>",
           _svg_open(h)]
    out.extend(_axes(x, y, h, y_fmt="{:.3g}"))
    band = ([(x(t), y(p99)) for t, _, _, p99 in wins]
            + [(x(t), y(p50)) for t, p50, _, _ in reversed(wins)])
    out.append(f'<path d="{_path(band)} Z" fill="var(--p95)" opacity="0.1" '
               'stroke="none"/>')
    for i, (k, c) in enumerate(keys):
        pts = [(x(w[0]), y(w[1 + i])) for w in wins]
        out.append(f'<path d="{_path(pts)}" fill="none" stroke="{c}" '
                   f'stroke-width="2" stroke-linejoin="round" '
                   f'stroke-linecap="round"><title>{k}</title></path>')
    out.append("</svg></div>")
    return "\n".join(out)


def _alert_ribbon(alerts, t0, t1, horizon) -> str:
    """Pending/firing episodes per (slo, rule) as status-colored bars on
    the shared time axis (icon+label carried by the row label + title)."""
    if not alerts:
        return ""
    lanes: dict[tuple, list] = {}
    for a in sorted(alerts, key=lambda a: a["t"]):
        lanes.setdefault((a.get("slo", "?"), a.get("rule", "?")), []).append(a)
    row_h, pad = 18, 22
    h = pad + len(lanes) * row_h + 22
    x = _Scale(t0, t1, _ML + 150, _W - _MR)
    out = ['<div class="card">', "<h2>alert ribbon (aligned to the scaling "
           "timeline above)</h2>", _svg_open(h)]
    for tv in _nice_ticks(t0, t1, 6):
        out.append(f'<text class="tick" x="{x(tv):.1f}" y="{h - 4}" '
                   f'text-anchor="middle">{_fmt_t(tv)}</text>')
    for i, ((slo, rule), trans) in enumerate(sorted(lanes.items())):
        yy = pad + i * row_h
        out.append(f'<text x="{_ML}" y="{yy + 9:.1f}">'
                   f'{_esc(rule)} · {_esc(slo)}</text>')
        state, since = None, None
        segs = []
        for a in trans:
            if a["state"] in ("pending", "firing"):
                if state is not None and a["state"] != state:
                    segs.append((since, a["t"], state))
                if state != a["state"]:
                    state, since = a["state"], a["t"]
            elif a["state"] == "resolved" and state is not None:
                segs.append((since, a["t"], state))
                state = None
        if state is not None:
            segs.append((since, horizon, state))
        for s0, s1, st in segs:
            out.append(
                f'<rect x="{x(s0):.1f}" y="{yy + 1}" '
                f'width="{max(x(s1) - x(s0), 2):.1f}" height="{row_h - 6}" '
                f'rx="3" fill="{_STATUS[st]}">'
                f'<title>{_esc(st)}: {s0:.2f}s – {s1:.2f}s</title></rect>')
    out.append("</svg></div>")
    return "\n".join(out)


def _util_strips(util_wins, t0, t1) -> str:
    """Per-replica windowed busy fraction as heat strips (sequential blue
    ramp; lightest = idle)."""
    if not util_wins:
        return ""
    tracks = sorted(util_wins)
    pad = 8
    h = pad + len(tracks) * (_STRIP + 4) + 22
    x = _Scale(t0, t1, _ML + 100, _W - _MR)
    out = ['<div class="card">', "<h2>per-replica utilization "
           "(windowed busy fraction)</h2>", _svg_open(h)]
    for tv in _nice_ticks(t0, t1, 6):
        out.append(f'<text class="tick" x="{x(tv):.1f}" y="{h - 4}" '
                   f'text-anchor="middle">{_fmt_t(tv)}</text>')
    for i, track in enumerate(tracks):
        yy = pad + i * (_STRIP + 4)
        out.append(f'<text x="{_ML}" y="{yy + _STRIP - 4}">{_esc(track)}</text>')
        for (w0, w1, frac) in util_wins[track]:
            c = _SEQ[min(int(max(frac, 0.0) * len(_SEQ)), len(_SEQ) - 1)]
            out.append(
                f'<rect x="{x(w0):.2f}" y="{yy}" '
                f'width="{max(x(w1) - x(w0) - 1, 1):.2f}" height="{_STRIP}" '
                f'fill="{c}"><title>{_esc(track)} {w0:.1f}–{w1:.1f}s: '
                f'{frac:.0%} busy</title></rect>')
    out.append("</svg></div>")
    return "\n".join(out)


def _tile(label, value) -> str:
    return (f'<div class="tile"><div class="label">{_esc(label)}</div>'
            f'<div class="value">{_esc(value)}</div></div>')


def _window_width(span: float) -> float:
    """~48 windows across the span, rounded to a tidy width."""
    if span <= 0:
        return 1.0
    raw = span / 48.0
    mag = 10.0 ** math.floor(math.log10(raw))
    return next((m * mag for m in (1.0, 2.0, 2.5, 5.0, 10.0)
                 if m * mag >= raw), raw)


def render_html(events, meta=None, *, rep=None, title="repro.obs trace") -> str:
    """Render the dashboard page for one event stream; returns the full
    HTML document as a string."""
    meta = dict(meta or {})
    if rep is None:
        rep = analyze(events, meta)
    s = rep["summary"]
    t0 = float(meta.get("t0", 0.0))
    horizon = float(meta.get("horizon", 0.0))
    if horizon <= t0:
        ts = [ev.get("t", ev.get("t1", 0.0)) for ev in events]
        horizon = max(ts) if ts else t0 + 1.0
    w = _window_width(horizon - t0)

    # ---- series extraction (one pass) --------------------------------
    arr_n: dict[int, int] = {}       # window -> arrivals
    ttft_w: dict[int, list] = {}     # window -> ttft samples
    busy: dict[str, list] = {}       # track -> [(t, busy_s)]
    prov: list[tuple[float, float]] = []
    alerts = []
    for ev in events:
        kind, name = ev.get("ev"), ev.get("name")
        if kind == "instant":
            t = ev["t"]
            if name == "request.complete":
                at = ev.get("attrs", {})
                arr_t = t - at["e2e"] if "e2e" in at else t
                arr_n[int((arr_t - t0) // w)] = arr_n.get(int((arr_t - t0) // w), 0) + 1
                if at.get("ttft") is not None:
                    ttft_w.setdefault(int((t - t0) // w), []).append(at["ttft"])
            elif name in ("request.shed", "request.drop"):
                arr_n[int((t - t0) // w)] = arr_n.get(int((t - t0) // w), 0) + 1
            elif name.startswith("alert."):
                alerts.append({"t": t, "state": name.split(".", 1)[1],
                               **dict(ev.get("attrs", ()))})
        elif kind == "span" and name == "provisioned":
            prov.append((ev["t0"], ev["t1"]))
        elif kind == "counter" and name == "busy_s":
            busy.setdefault(ev.get("track", ""), []).append((ev["t"], ev["value"]))

    arr_pts = [(t0 + (k + 0.5) * w, n / w) for k, n in sorted(arr_n.items())]

    # replica count step function from provisioned span edges
    edges = sorted([(s_, +1) for s_, _ in prov] + [(e_, -1) for _, e_ in prov])
    rep_pts, cur = [], 0
    for t, d in edges:
        cur += d
        rep_pts.append((t, cur))

    ribbon = []
    for k, vals in sorted(ttft_w.items()):
        p = percentile_summary(vals, "v", pcts=(50, 95, 99))
        ribbon.append((t0 + (k + 0.5) * w, p["v_p50"], p["v_p95"], p["v_p99"]))

    util_wins: dict[str, list] = {}
    for track, samples in busy.items():
        samples.sort()
        wins, prev_t, prev_b = [], None, None
        for t, b in samples:
            if prev_t is not None and t > prev_t:
                k0, k1 = (prev_t - t0) // w, (t - t0) // w
                frac = (b - prev_b) / (t - prev_t)
                if not wins or wins[-1][0] != k0:
                    wins.append([k0, 0.0, 0.0])
                wins[-1][1] += (b - prev_b)
                wins[-1][2] = max(wins[-1][2], frac)
            prev_t, prev_b = t, b
        util_wins[track] = [(t0 + k * w, t0 + (k + 1) * w, min(acc / w, 1.0))
                            for k, acc, _ in wins]

    # ---- page --------------------------------------------------------
    n = max(s["n_requests"], 1)
    fired = sum(1 for a in rep.get("alerts", ()) if a.get("state") == "firing")
    tiv = sum((x["t"] - x["t0"]) for x in rep.get("slo_windows", ())
              if x.get("ok") is False)
    tiles = [
        _tile("requests", s["n_requests"]),
        _tile("completed", s["n_complete"]),
        _tile("shed + dropped", s["n_shed"] + s["n_drop"]),
        _tile("TTFT p99", f"{s['ttft_p99'] * 1e3:,.0f} ms"),
        _tile("e2e p99", f"{s['e2e_p99'] * 1e3:,.0f} ms"),
        _tile("completion", f"{s['n_complete'] / n:.1%}"),
    ]
    if rep.get("slo_windows") or rep.get("alerts"):
        tiles.append(_tile("alerts fired", fired))
        tiles.append(_tile("time in violation", f"{tiv:g} s"))

    charts = [
        _line_chart("arrival rate (req/s, windowed)",
                    [("arrivals", "var(--series-1)", arr_pts)], t0, horizon),
        _ribbon_chart("TTFT percentiles per window (s)", ribbon, t0, horizon),
        _line_chart("provisioned replicas",
                    [("replicas", "var(--series-2)", rep_pts)], t0, horizon,
                    step=True),
        _alert_ribbon(alerts, t0, horizon, horizon),
        _util_strips(util_wins, t0, horizon),
    ]

    # table view: the windowed ribbon + arrival numbers, for non-visual
    # reading of the same data the charts draw
    table = ["<details><summary>data table (windowed)</summary>",
             "<table><tr><th>t0 (s)</th><th>arrivals/s</th><th>ttft p50</th>"
             "<th>ttft p95</th><th>ttft p99</th></tr>"]
    rib_by_k = {int((t - t0) / w - 0.5): (a, b, c) for t, a, b, c in ribbon}
    for k in sorted(set(arr_n) | set(rib_by_k)):
        r = rib_by_k.get(k)
        table.append(
            f"<tr><td>{t0 + k * w:g}</td>"
            f"<td>{arr_n.get(k, 0) / w:.2f}</td>"
            + ("".join(f"<td>{v:.4f}</td>" for v in r) if r
               else "<td>-</td><td>-</td><td>-</td>") + "</tr>")
    table.append("</table></details>")

    sub = (f"schema {_esc(meta.get('schema', '?'))} · "
           f"mode {_esc(meta.get('mode', '?'))} · "
           f"horizon {horizon:g}s · {len(events)} events")
    doc = ["<!DOCTYPE html>", '<html lang="en"><head>',
           '<meta charset="utf-8"/>',
           '<meta name="viewport" content="width=device-width, '
           'initial-scale=1"/>',
           f"<title>{_esc(title)}</title>",
           f"<style>{_CSS}</style>", "</head>",
           '<body class="viz-root">',
           f"<h1>{_esc(title)}</h1>", f'<p class="sub">{sub}</p>',
           '<div class="tiles">', *tiles, "</div>",
           *[c for c in charts if c],
           '<div class="card">', *table, "</div>",
           "</body></html>"]
    return "\n".join(doc)
