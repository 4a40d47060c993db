"""Limb-decomposition layout shared by all TPU field kernels.

A 254-bit field element lives on device as ``(..., NLIMB)`` ``uint32`` with
``LIMB_BITS``-bit little-endian limbs (each limb value < 2^16).  This is the
TPU replacement for the reference's 4x64-bit `halo2curves` representation —
16-bit limbs are chosen so that a limb product fits exactly in uint32 and
column sums of a 16x16 schoolbook multiply stay below 2^24, which lets the
column reduction run as an *exact* f32 matmul on the MXU.
"""

from __future__ import annotations

import numpy as np

NLIMB = 16
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = NLIMB * LIMB_BITS  # 256; Montgomery R = 2^256


def int_to_limbs(value: int, n: int = NLIMB) -> np.ndarray:
    """Host conversion int -> little-endian uint32 limb vector."""
    assert 0 <= value < (1 << (n * LIMB_BITS))
    return np.array(
        [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)], dtype=np.uint32
    )


def limbs_to_int(limbs) -> int:
    """Host conversion limb vector -> int (accepts any 1-D int array)."""
    arr = np.asarray(limbs, dtype=np.uint64)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr))


def ints_to_limbs(values, n: int = NLIMB) -> np.ndarray:
    """Vector of python ints -> (len, n) uint32 array."""
    return np.stack([int_to_limbs(v, n) for v in values])
