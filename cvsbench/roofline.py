"""The yardstick of the per-layer rooflines: the table of peaks of one
NVIDIA H100 SXM and the least work the step and its kernels must do.

The work is counted from what the step must do for these inputs,
whatever implements it: every frame byte and every state byte read once,
the state written only where the step changes it, and the payload at the
least of the port's own emissions (the changed bytes' values and the
n/8-byte change bitmask). It does not count what an implementation
allocates (worst-case capacity blocks, zero fill, an unfused filter's
intermediate frame), so a later fusion or a smaller emission can never
read over 100%.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at its 700 W limit: HBM3 bandwidth, and
# int32 multiply-adds at 64 lanes an SM a clock over 132 SMs at the
# card's highest SM clock, 1,980 MHz.
HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9
INT32_MACS_PER_S = SMS * INT32_LANES_PER_SM * SM_CLOCK_HZ


def step_least_bytes(n: int, pos: float, aux: bool = False) -> float:
    """Bytes one camera frame's step must move: the frame and the state
    read once (2n), the state written where it changes (pos), the
    payload's values (pos) and its change bitmask (n/8); with ``aux`` (a
    visualizer) also the aux frame written (n), whose reads of the frame
    and the state are those already counted. K1 alone must move the
    count without ``aux``: it reads the overlaid (or filtered) frame and
    the state and writes the rest."""
    return 2 * n + 2 * pos + -(-n // 8) + (n if aux else 0)


def filter_least_s(n: int, k: int) -> float:
    """The least time of a K x K filter over an n-byte frame: the larger
    of its bytes (read n, write n) at the HBM rate and its K*K int32
    multiply-adds a byte at the int32 rate."""
    return max(2 * n / HBM_BYTES_PER_S, k * k * n / INT32_MACS_PER_S)


def share_pct(least_s: float, measured_s: float):
    """``least_s / measured_s`` in percent; None where nothing was
    measured."""
    if measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
