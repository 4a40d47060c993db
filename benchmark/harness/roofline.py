"""The card's peaks and the work of each kernel, frozen here so that a change
to the program cannot move them (copied from ``chip_smoke.py``'s ``bound``,
``scan_mont_products`` and ``MONT_PER``).

A kernel's work is priced from its launch shapes alone: the least time the
card could take for it is the larger of the bytes it must move (inputs read
once, outputs written once) over HBM bandwidth and its 32-bit multiply
instructions over the INT32 rate.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet and Hopper white paper: HBM3 bandwidth, and
# 32-bit integer multiplies: 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
CLOCK_HZ = 1.98e9
INT32_MULS_PER_S = 132 * 64 * CLOCK_HZ
# 32-bit multiply instructions per Montgomery product (CIOS on 8 words): 64
# a*b and 64 m*p products, each a 32 x 32 -> 64 bit multiply (lo and hi
# halves: 2 instructions), and 8 m = t0 * n0 (low half only).
MULS_PER_MONT = 2 * (64 + 64) + 8
FE_BYTES = 32  # one field element (or one scalar's 64 signed 4-bit digits)
MONT_PER = {"add": 12, "double": 8, "fq12": 54}  # Montgomery products per operation
WINDOW_DBLS = 4  # doublings per window of the small MSM (4-bit windows)


def bound_s(nbytes: int, mont_products: int) -> float:
    """Seconds the card needs at least: bytes over HBM bandwidth or 32-bit
    multiplies over the INT32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, mont_products * MULS_PER_MONT / INT32_MULS_PER_S)


def scan_mont_products(n: int, nwin: int) -> int:
    """Montgomery products one proof's small MSM (K4) needs: nwin (n - 1)
    complete adds for the window sums, then (nwin - 1) x (4 doublings + 1
    add) for Horner (its first step, onto the identity, needs none)."""
    return nwin * (n - 1) * MONT_PER["add"] + (nwin - 1) * (WINDOW_DBLS * MONT_PER["double"] + MONT_PER["add"])


def msm_scan_bound_s(batch: int, n: int, nwin: int) -> float:
    """K4 on ``batch`` proofs of ``n`` terms: the table (9 entries x 3
    coordinates per term), the digits and the output read or written once."""
    nbytes = (9 * 3 * n * batch + batch * n + 3 * batch) * FE_BYTES
    return bound_s(nbytes, batch * scan_mont_products(n, nwin))
