"""Collective communication models (§3.4): ring (eq. 3) and double binary
tree (eq. 4), plus derived costs for reduce-scatter / all-gather / all-to-all
and point-to-point pipeline sends.

K is the *global* data volume participating in the collective; BW is the
per-device link bandwidth; l the per-hop latency.

A copy of `repro.core.comm` (the port imports nothing of the JAX package),
over the port's `ModelConfig`; `tests/test_torch_planner.py` holds it to the
original number for number.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.hardware import NetLevel


def ring_allreduce(K: float, N: int, net: NetLevel) -> float:
    """Eq. (3): T = 2K(N-1)/(N*BW) + 2l(N-1)."""
    if N <= 1:
        return 0.0
    bw = net.bw * net.util
    return 2.0 * K * (N - 1) / (N * bw) + 2.0 * net.latency * (N - 1)


def tree_allreduce(K: float, N: int, net: NetLevel) -> float:
    """Eq. (4): double binary tree — bandwidth term of ring, log2 latency."""
    if N <= 1:
        return 0.0
    bw = net.bw * net.util
    return 2.0 * K * (N - 1) / (N * bw) + 2.0 * net.latency * math.log2(N)


def allreduce(K: float, N: int, net: NetLevel, *, algo: str = "auto") -> float:
    """Paper's policy: ring for data-intensive (training), tree when the
    latency term matters (inference's small volumes, §3.4)."""
    if algo == "ring":
        return ring_allreduce(K, N, net)
    if algo == "tree":
        return tree_allreduce(K, N, net)
    return min(ring_allreduce(K, N, net), tree_allreduce(K, N, net))


def reduce_scatter(K: float, N: int, net: NetLevel) -> float:
    if N <= 1:
        return 0.0
    bw = net.bw * net.util
    return K * (N - 1) / (N * bw) + net.latency * (N - 1)


def all_gather(K: float, N: int, net: NetLevel) -> float:
    return reduce_scatter(K, N, net)


def all_to_all(K: float, N: int, net: NetLevel) -> float:
    """Each device exchanges K/N with every peer: K(N-1)/(N*BW) + l(N-1)."""
    if N <= 1:
        return 0.0
    bw = net.bw * net.util
    return K * (N - 1) / (N * bw) + net.latency * (N - 1)


def p2p(K: float, net: NetLevel) -> float:
    """Point-to-point activation send (pipeline stage boundary)."""
    return K / (net.bw * net.util) + net.latency


@dataclass(frozen=True)
class CommEvent:
    """A collective the mapping induces, with the level it runs on."""

    name: str
    kind: str  # allreduce | reduce_scatter | all_gather | all_to_all | p2p
    bytes: float  # global volume K
    group: int  # N
    net: NetLevel
    algo: str = "auto"

    def time(self) -> float:
        if self.kind == "allreduce":
            return allreduce(self.bytes, self.group, self.net, algo=self.algo)
        if self.kind == "reduce_scatter":
            return reduce_scatter(self.bytes, self.group, self.net)
        if self.kind == "all_gather":
            return all_gather(self.bytes, self.group, self.net)
        if self.kind == "all_to_all":
            return all_to_all(self.bytes, self.group, self.net)
        if self.kind == "p2p":
            return p2p(self.bytes, self.net)
        raise ValueError(self.kind)
