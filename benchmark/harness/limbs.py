"""Canonical integers and their 16 limbs of 16 bits, as the program's
tensors hold them."""

from __future__ import annotations

import numpy as np

NLIMB = 16


def limbs(values) -> np.ndarray:
    """Canonical ints -> (len, 16) int64 limbs of 16 bits."""
    raw = b"".join(int(v).to_bytes(2 * NLIMB, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").astype(np.int64).reshape(-1, NLIMB)


def ints(limb_rows: np.ndarray) -> list[int]:
    """(n, 16) limbs of 16 bits -> canonical ints."""
    raw = np.ascontiguousarray(limb_rows, dtype="<u2").reshape(len(limb_rows), -1)
    return [int.from_bytes(row.tobytes(), "little") for row in raw]
