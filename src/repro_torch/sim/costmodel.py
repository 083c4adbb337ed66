"""Analytical step costs for the serving simulator.

Every simulator "clock tick" is priced by the same roofline + collective
models that `repro_torch.core.predict.inference_latency` uses (§4.3, Table 4):

  * prefill chunk — `layer_ops(S=chunk, ctx=offset+chunk, decode=False)`
    summed over layers, plus the LM head and 2 TP all-reduces per layer on
    the latency-optimal double binary tree (eq. 4),
  * decode step   — `layer_ops(S=1, ctx, decode=True)` for the live batch,
    plus head, TP all-reduce, and the constant per-step engine overhead.

Costs are memoized on (batch, tokens, ctx-bucket); `ctx_quantum` trades
memoization hit-rate against exactness (use 1 to match `inference_latency`
bit-for-bit in regression tests, 8-32 for large sweeps).

KV admission comes from the paper's §3.5 cache formula (`kv_cache_bytes`,
GQA/sliding-window aware, + recurrent state for SSM/hybrid archs) checked
against the per-device DRAM capacity left after weights. Setting
`kv_block_tokens > 0` switches admission to page-granular (vLLM-style)
accounting: every sequence's context is rounded up to whole pages, so the
scheduler sees allocation (with internal fragmentation) rather than exact
occupancy; `kv_bytes(ctx, exact=True)` still returns the unpaged figure so
the waste is measurable.

Note: this intentionally re-prices the same op graph `inference_latency`
builds rather than refactoring that function onto this class —
`inference_latency` is calibrated against the paper's validation tables
and must not move. The contract between the two is regression-tested to
1% in tests/test_sim.py (single-request simulation vs analytical TTFT/
TPOT); edits to either side that drift the graphs will trip it.

A copy of `repro.sim.costmodel` (the port imports nothing of the JAX package);
`tests/test_torch_sim.py` holds it to the original bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm as C
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.kvcache import kv_cache_bytes, recurrent_state_bytes
from repro_torch.core.operators import embedding_head_ops, layer_ops, total_param_count
from repro_torch.core.predict import _n_ar_layers
from repro_torch.core.roofline import total_time


@dataclass
class ServingCostModel:
    cfg: ModelConfig
    hw: HardwareSpec
    tp: int = 1
    prec: int = 2
    comm_algo: str = "tree"  # inference default (§3.4): latency-optimal tree
    per_token_overhead: float = 300e-6  # per engine step (matches predict.py)
    ctx_quantum: int = 8
    kv_headroom: float = 0.9  # fraction of post-weight DRAM usable for KV
    kv_block_tokens: int = 0  # paged-KV page size in tokens (0 = contiguous)
    _memo: dict = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------ costs
    def prefill_time(self, tokens: int, *, ctx_end: int | None = None,
                     batch: int = 1, with_head: bool = True) -> float:
        """Seconds to prefill `tokens` new tokens per sequence (batched,
        padded to a common length) whose attention spans `ctx_end` keys.
        `with_head=False` prices a non-final chunk of a chunked prefill —
        only the chunk that completes the prompt produces sampled logits."""
        S = int(tokens)
        ctx = int(ctx_end) if ctx_end is not None else S
        q = max(self.ctx_quantum, 1)
        ctx = max(int(round(ctx / q)) * q, S, 1)  # bucket the span, never below S
        key = ("prefill", batch, S, ctx, with_head)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        ops = []
        for i in range(self.cfg.num_layers):
            ops += layer_ops(self.cfg, batch, S, ctx, self.tp, i,
                             decode=False, prec=self.prec)
        t, _ = total_time(self.hw, ops)
        if with_head:
            t += self._head_time(batch)
        K = batch * S * self.cfg.d_model * self.prec
        t += 2.0 * _n_ar_layers(self.cfg) * C.allreduce(
            K, self.tp, self.hw.net[0], algo=self.comm_algo)
        self._memo[key] = t
        return t

    def decode_step_time(self, batch: int, ctx: float) -> float:
        """Seconds for one decode iteration of `batch` sequences at (mean)
        context `ctx` — per-op graph + head + TP all-reduce + step overhead."""
        q = max(self.ctx_quantum, 1)
        ctx_q = max(int(round(ctx / q)) * q, 1)
        key = ("decode", batch, ctx_q)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        ops = []
        for i in range(self.cfg.num_layers):
            ops += layer_ops(self.cfg, batch, 1, ctx_q, self.tp, i,
                             decode=True, prec=self.prec)
        t, _ = total_time(self.hw, ops)
        t += self._head_time(batch)
        K = batch * self.cfg.d_model * self.prec
        t += 2.0 * _n_ar_layers(self.cfg) * C.allreduce(
            K, self.tp, self.hw.net[0], algo=self.comm_algo)
        t += self.per_token_overhead
        self._memo[key] = t
        return t

    def _head_time(self, batch: int) -> float:
        key = ("head", batch)
        hit = self._memo.get(key)
        if hit is None:
            hit, _ = total_time(
                self.hw, embedding_head_ops(self.cfg, batch, 1, self.tp, prec=self.prec))
            self._memo[key] = hit
        return hit

    # --------------------------------------------------------------- capacity
    def kv_bytes(self, ctx: int, *, exact: bool = False) -> float:
        """Per-device cache bytes for ONE sequence holding `ctx` tokens.
        With `kv_block_tokens` set, returns the page-granular *allocation*
        (ctx rounded up to whole pages); `exact=True` bypasses paging."""
        if ctx <= 0:
            return 0.0
        alloc = int(ctx)
        if self.kv_block_tokens > 0 and not exact:
            blk = self.kv_block_tokens
            alloc = -(-alloc // blk) * blk
        b = kv_cache_bytes(self.cfg, 1, alloc, self.prec)
        b += recurrent_state_bytes(self.cfg, 1)
        return b / self.tp

    def kv_handoff_bytes(self, ctx: int) -> float:
        """Total bytes (summed over all tp shards) to migrate one sequence's
        cache to another replica — the prefill->decode KV transfer volume in
        disaggregated serving, priced by `comm.p2p` at the cluster layer."""
        if ctx <= 0:
            return 0.0
        return (kv_cache_bytes(self.cfg, 1, int(ctx), self.prec)
                + recurrent_state_bytes(self.cfg, 1))

    @property
    def weight_bytes(self) -> float:
        """Per-device resident weight bytes."""
        return total_param_count(self.cfg) * self.prec / self.tp

    @property
    def kv_capacity_bytes(self) -> float:
        """Per-device DRAM left for KV after weights, derated by headroom."""
        free = self.hw.dram.capacity - self.weight_bytes
        if free <= 0:
            raise ValueError(
                f"{self.cfg.name} weights ({self.weight_bytes / 1e9:.1f} GB/dev) "
                f"exceed {self.hw.name} DRAM at tp={self.tp}")
        return free * self.kv_headroom
