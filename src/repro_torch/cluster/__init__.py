"""repro_torch.cluster — multi-replica serving cluster simulator.

The layer above `repro_torch.sim`: where one `ReplicaSim` prices a single device
group's engine iterations, this package co-simulates N of them under a
shared arrival stream and answers the questions production serving is
actually planned against:

  * `router`  — pluggable dispatch policies (round-robin, join-shortest-
    queue, least-KV-load, and session/prefix affinity with a modeled
    prefill-cache hit discount).
  * `cluster` — colocated (data-parallel `mixed` replicas) vs
    disaggregated (`prefill` pools handing KV to `decode` pools over a
    `comm.p2p`-priced transfer sized by §3.5's cache formula), with
    heterogeneous per-replica hardware and scheduler configs.
  * `prefixcache` — the modeled prefix cache behind affinity routing:
    per-replica finite byte budgets carved out of KV capacity, LRU + TTL
    eviction, token-granular prefix groups shared across sessions, and
    drain/retire invalidation. `ClusterSpec.prefix_cache` switches the
    affinity discount from unconditional `hit_frac` to actual residency
    (`PrefixCacheConfig(budget_bytes=math.inf)` reproduces the legacy
    behavior bit-for-bit).
  * `planner` — SLO-driven capacity planning: sweep replica count / pool
    split at a target QPS, price candidates in $/hr, return the cheapest
    plan whose SLO attainment clears the bar; `provisioning_summary`
    prices a dynamic fleet's replica-hours against static peak
    provisioning.
  * `autoscale` — reactive (arrival rate, SLO debt, admission wait, KV +
    TPOT pressure) and predictive (M/G/1 wait estimate over the known
    rate-envelope lookahead) replica add/remove with weight-load warmup,
    graceful drain, and min/max bounds, driving
    `simulate_cluster(..., autoscale=)` under diurnal/bursty traces —
    fleet-wide, or per-pool for disaggregated clusters
    (`autoscale={"prefill": ..., "decode": ...}`).
  * `chaos` — seeded fault injection (replica crashes with KV loss and
    prefix-cache restore, stragglers, KV-link degradation, correlated
    node failures) plus the admission front door (token bucket / circuit
    breaker) that sheds overload BEFORE dispatch; `ClusterSpec.chaos` /
    `ClusterSpec.admission` thread both through the engine, and
    `plan_capacity(..., loss_tolerance=N)` sizes fleets that survive
    N-replica loss.

CLI:

    PYTHONPATH=src python -m repro_torch.cluster --config qwen3_14b --hw h100 \\
        --replicas 4 --qps 32

prints cluster- and pool-level TTFT/TPOT/goodput for the colocated and
disaggregated organizations of the same fleet; `--plan` runs the capacity
sweep instead (the JAX package's `python -m benchmarks.run cluster` emits CSV rows).

A copy of `repro.cluster` (the port imports nothing of the JAX package);
`tests/test_torch_cluster.py` holds it to the original bit for bit.
"""

from repro_torch.cluster.autoscale import (
    AUTOSCALE_POLICIES,
    AutoscaleConfig,
    Autoscaler,
)
from repro_torch.cluster.chaos import (
    ADMISSION_POLICIES,
    CHAOS_KINDS,
    AdmissionConfig,
    ChaosConfig,
    ChaosEvent,
)
from repro_torch.cluster.cluster import (
    POOLS,
    ClusterResult,
    ClusterSpec,
    ReplicaSpec,
    pool_summaries,
    simulate_cluster,
    summarize_cluster,
)
from repro_torch.cluster.prefixcache import (
    FleetPrefixCache,
    PrefixCacheConfig,
    ReplicaPrefixCache,
)
from repro_torch.cluster.planner import (
    DEFAULT_PRICE_PER_DEV_HR,
    cluster_price_per_hr,
    plan_capacity,
    provisioning_summary,
    replica_price_per_hr,
    seed_predictive,
)
from repro_torch.cluster.router import ROUTERS, ReplicaView, Router, make_router

__all__ = [
    "ADMISSION_POLICIES",
    "AUTOSCALE_POLICIES",
    "AdmissionConfig",
    "AutoscaleConfig",
    "Autoscaler",
    "CHAOS_KINDS",
    "ChaosConfig",
    "ChaosEvent",
    "ClusterResult",
    "ClusterSpec",
    "DEFAULT_PRICE_PER_DEV_HR",
    "FleetPrefixCache",
    "POOLS",
    "PrefixCacheConfig",
    "ROUTERS",
    "ReplicaPrefixCache",
    "ReplicaSpec",
    "ReplicaView",
    "Router",
    "cluster_price_per_hr",
    "make_router",
    "plan_capacity",
    "pool_summaries",
    "provisioning_summary",
    "replica_price_per_hr",
    "seed_predictive",
    "simulate_cluster",
    "summarize_cluster",
]
