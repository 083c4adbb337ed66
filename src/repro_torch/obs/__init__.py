"""repro_torch.obs — observability for the serving simulators.

Event tracing (`Tracer`, spans/instants/counters with trace levels and a
sink API for online subscribers), streaming percentiles
(`StreamingQuantiles`, P² body + exact tails), windowed aggregation,
trace exporters (Chrome trace-event JSON for Perfetto, JSONL event log,
windowed CSV), a live SLO monitor (`SLOMonitor`: burn-rate alerts +
anomaly detection at sim time), an offline report analyzer
(`python -m repro_torch.obs report trace.jsonl`, `--html` dashboard), and a
trace-to-trace diff / CI gate (`python -m repro_torch.obs diff a b`).

See docs/observability.md for the event schema and workflow.

A copy of `repro.obs` (the port imports nothing of the JAX package);
`tests/test_torch_obs.py` holds it to the original bit for bit.
"""

from .quantiles import (PCTS, P2Quantile, StreamingQuantiles,
                        WindowedAggregator, pct_key, percentile_summary)
from .tracer import (LEVELS, NULL_TRACER, STRUCTURAL_SPANS, TERMINALS,
                     NullTracer, Tracer, make_tracer, validate_trace)
from .export import (csv_rows, read_jsonl, to_chrome, write_chrome,
                     write_csv, write_jsonl, write_trace)
from .report import analyze, render, report_file
from .monitor import (SLO, AnomalyConfig, BurnRateRule, SLOMonitor,
                      default_rules, make_slos, replay)
from .diff import (DEFAULT_THRESHOLDS, diff_traces, parse_fail_on,
                   regressions, render_diff)
from .dashboard import render_html

__all__ = [
    "PCTS", "P2Quantile", "StreamingQuantiles", "WindowedAggregator",
    "pct_key", "percentile_summary",
    "LEVELS", "NULL_TRACER", "STRUCTURAL_SPANS", "TERMINALS",
    "NullTracer", "Tracer", "make_tracer", "validate_trace",
    "csv_rows", "read_jsonl", "to_chrome", "write_chrome", "write_csv",
    "write_jsonl", "write_trace",
    "analyze", "render", "report_file",
    "SLO", "AnomalyConfig", "BurnRateRule", "SLOMonitor", "default_rules",
    "make_slos", "replay",
    "DEFAULT_THRESHOLDS", "diff_traces", "parse_fail_on", "regressions",
    "render_diff",
    "render_html",
]
