"""The benchmark's frozen arithmetic that no model family owns: the card's peaks,
the least time of a piece of work, and the flash kernels' operations and bytes
counted from the shapes a run called.

A family's own arithmetic (its product parameters and flops, from a
configuration file's published sizes) lives in `families/<family>.py`. Nothing
here is read from the program, so that a change to the program cannot move
the yardstick. The formulas are those of the port's `chip_smoke.py`
(`live_pairs`, `bound`), rewritten here.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16 = 989e12  # FLOP/s on the tensor cores
HBM = 3.35e12  # bytes/s
BF16, F32 = 2, 4  # bytes an element


def live_pairs(S: int, window: int | None) -> int:
    """Query-key pairs a causal attention over S positions computes, in a window if given."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card needs: the larger of flops over the bf16 peak
    and bytes over the HBM rate."""
    return max(flops / PEAK_BF16, nbytes / HBM)


def flash_fwd_work(B: int, Hq: int, Hkv: int, S: int, dh: int, window: int | None,
                   lse: bool) -> tuple[int, int]:
    """(flops, bytes) of one causal flash forward call over bf16 q (B, Hq, S, dh)
    and k, v (B, Hkv, S, dh): 4 dh flops a live pair a query head; q, k, v read
    once, the output written once, and the float32 LSE written where training
    asks for it."""
    flops = 4 * dh * live_pairs(S, window) * B * Hq
    nbytes = BF16 * B * S * dh * (2 * Hq + 2 * Hkv) + (F32 * B * Hq * S if lse else 0)
    return flops, nbytes


def flash_bwd_work(B: int, Hq: int, Hkv: int, S: int, dh: int,
                   window: int | None) -> tuple[int, int]:
    """(flops, bytes) of one flash backward call: 10 dh flops a live pair a query
    head (the scores again, dP, dV, dK, dQ); q, k, v, out, dout and the LSE
    read once, dq, dk, dv written once."""
    flops = 10 * dh * live_pairs(S, window) * B * Hq
    nbytes = BF16 * B * S * dh * (3 * Hq + 2 * Hkv) + F32 * B * Hq * S \
        + BF16 * B * S * dh * (Hq + 2 * Hkv)
    return flops, nbytes
