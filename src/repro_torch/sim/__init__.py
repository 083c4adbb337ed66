"""repro_torch.sim — analytical-cost-driven serving simulator.

The paper's inference model (§4.3, §6, Table 4) prices single-request
prefill/decode; this subsystem lifts those per-step costs into a discrete-
event simulation of a serving cluster under load, so scheduling, batching,
and KV-capacity questions can be answered without GPUs:

  * `workload`  — seeded arrival processes (constant / Poisson / bursty),
    prompt & output length distributions (fixed / lognormal), and JSONL
    trace replay. The same `Workload` spec drives the real `ServeEngine`
    via `to_engine_requests`, so simulated and executed schedules are
    comparable request-for-request.
  * `costmodel` — memoized prefill-chunk / decode-step costs built from
    `layer_ops` + `op_time` + `comm.allreduce` (the exact graphs
    `inference_latency` prices; a single-request simulation reproduces its
    TTFT/TPOT within 1%), plus §3.5 KV accounting against DRAM capacity.
  * `scheduler` — the event loop with pluggable policies: static batching,
    continuous batching, and chunked prefill under a token budget; FCFS
    admission, recompute-style preemption when KV is exhausted, and a hard
    KV-capacity invariant.
  * `metrics`   — TTFT/TPOT/e2e percentiles, goodput under SLOs, and
    throughput-latency Pareto sweeps over policies x slot counts.

CLI:

    PYTHONPATH=src python -m repro_torch.sim --config qwen3_14b --hw h100 --qps 8

prints per-policy SLO tables and the static-vs-continuous sweep in a few
seconds (the JAX package's `python -m benchmarks.run serving` emits them as CSV).

A copy of `repro.sim` (the port imports nothing of the JAX package);
`tests/test_torch_sim.py` holds it to the original bit for bit.
"""

from repro_torch.sim.costmodel import ServingCostModel
from repro_torch.sim.metrics import dominates, pareto_sweep, summarize, summarize_records
from repro_torch.sim.scheduler import (
    ADMISSIONS,
    ENGINES,
    POLICIES,
    ReplicaSim,
    ReqRecord,
    SchedConfig,
    SimResult,
    emit_record_spans,
    make_replica_sim,
    simulate,
)
from repro_torch.sim.workload import LengthDist, SimRequest, Workload, to_engine_requests

__all__ = [
    "ADMISSIONS",
    "ENGINES",
    "LengthDist",
    "POLICIES",
    "ReplicaSim",
    "ReqRecord",
    "SchedConfig",
    "ServingCostModel",
    "SimRequest",
    "SimResult",
    "Workload",
    "dominates",
    "make_replica_sim",
    "emit_record_spans",
    "pareto_sweep",
    "simulate",
    "summarize",
    "summarize_records",
    "to_engine_requests",
]
