"""KZG accumulator = a deferred pairing pair, plus the limb instance encoding
(parity: pcs/kzg/accumulator.rs:6-128)."""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference.errors import InvalidProtocol
from benchmark.reference.pcs import AccumulatorEncoding
from benchmark.reference.util import bn254

LIMBS = 4
BITS = 68


@dataclass
class KzgAccumulator:
    """lhs/rhs G1 points such that validity <=> e(lhs, g2) e(rhs, -s_g2) == 1."""

    lhs: object  # EcPoint
    rhs: object  # EcPoint


class LimbsEncoding(AccumulatorEncoding):
    """Decode 4*LIMBS scalars (68-bit limbs of lhs.x, lhs.y, rhs.x, rhs.y)
    into two G1 points (accumulator.rs:36-83).  Dispatches on the loader:
    native scalars (python ints) decode on the host with an on-curve check;
    JAX scalars decode in-graph via `loader.decode_limbs_to_point`, with the
    on-curve check folded into the batch `ok` mask.
    """

    limbs = LIMBS
    bits = BITS

    @classmethod
    def from_repr(cls, scalars):
        assert len(scalars) == 4 * cls.limbs
        loader = scalars[0].loader

        if hasattr(loader, "ec_point_from_limbs"):
            # staged backend (JAX / EVM): decode inside the staged program;
            # the JAX path folds its on-curve check into the ok mask
            lhs = loader.ec_point_from_limbs(scalars[: 2 * cls.limbs], cls.limbs, cls.bits)
            rhs = loader.ec_point_from_limbs(scalars[2 * cls.limbs :], cls.limbs, cls.bits)
            return KzgAccumulator(lhs, rhs)

        def fe_from_limbs(limbs):
            acc = 0
            for i, limb in enumerate(limbs):
                acc += limb.value << (cls.bits * i)
            return acc % bn254.P

        coords = [
            fe_from_limbs(scalars[i * cls.limbs : (i + 1) * cls.limbs]) for i in range(4)
        ]
        lhs = (coords[0], coords[1])
        rhs = (coords[2], coords[3])
        for pt in (lhs, rhs):
            if not bn254.g1_is_on_curve(pt):
                raise InvalidProtocol("accumulator limbs decode to an off-curve point")
        from benchmark.reference.loader import EcPoint

        return KzgAccumulator(EcPoint(loader, lhs), EcPoint(loader, rhs))


def fe_to_limbs(fe: int, limbs: int = LIMBS, bits: int = BITS):
    """Fq int -> limb scalars as Fr ints (util/arithmetic.rs:286-298)."""
    mask = (1 << bits) - 1
    return [(fe >> (bits * i)) & mask for i in range(limbs)]


def accumulator_to_limbs(acc: KzgAccumulator):
    """Native accumulator -> 16 Fr ints (aggregation.rs:235-238)."""
    (lx, ly), (rx, ry) = acc.lhs.value, acc.rhs.value
    out = []
    for coord in (lx, ly, rx, ry):
        out.extend(fe_to_limbs(coord))
    return out
