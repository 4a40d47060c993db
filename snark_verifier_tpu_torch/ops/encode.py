"""Byte <-> limb encodings and u256 modular reduction on int64 tensors.

Counterpart of ``snark_verifier_tpu/ops/encode.py``: the proof stream is
big-endian 32-byte words, field elements are 16 little-endian 16-bit limbs.
"""

from __future__ import annotations

import torch

from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops.field import NLIMB

# byte index (big-endian, 32 bytes) of limb j's low byte and high byte
_IDX_LO = [31 - 2 * j for j in range(NLIMB)]
_IDX_HI = [30 - 2 * j for j in range(NLIMB)]


def be_bytes_to_limbs(data):
    """(..., 32) big-endian byte values -> (..., 16) canonical limbs."""
    return data[..., _IDX_LO] | (data[..., _IDX_HI] << 8)


def limbs_to_be_bytes(limbs):
    """(..., 16) canonical limbs -> (..., 32) big-endian byte values."""
    le = torch.stack([limbs & 0xFF, (limbs >> 8) & 0xFF], dim=-1).reshape(*limbs.shape[:-1], 2 * NLIMB)
    return le.flip(-1)


def reduce_u256(limbs, spec):
    """Reduce a 256-bit value into [0, p) by conditional subtraction
    (2^256 / p < 6 for both BN254 moduli)."""
    x = limbs
    for _ in range(5):
        x = F._cond_sub_mod(x, spec)
    return x


def le_bytes_to_limbs(data):
    """(..., 32) little-endian byte values -> (..., 16) canonical limbs."""
    b = data.reshape(*data.shape[:-1], NLIMB, 2)
    return b[..., 0] | (b[..., 1] << 8)


def limbs_to_le_bytes(limbs):
    return torch.stack([limbs & 0xFF, (limbs >> 8) & 0xFF], dim=-1).reshape(*limbs.shape[:-1], 2 * NLIMB)


def is_lt_modulus(limbs, spec):
    """Boolean (...,): value < modulus (canonical encoding check)."""
    _, borrow = F._sub_limbs(limbs, spec.consts(limbs.device)["mod"])
    return borrow > 0
