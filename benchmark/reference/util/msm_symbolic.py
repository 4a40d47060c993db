"""Symbolic MSM accumulator — a lazy linear combination of EC points.

Semantics of the reference's `Msm<C, L>` (util/msm.rs:46-127): verification
math accumulates `constant + sum_i scalar_i * base_i` symbolically (merging
terms with identical bases) and only materializes one real MSM at
`evaluate()`, which dispatches to the loader.  Under the JAX loader that
single call becomes the batched windowed MSM kernel.
"""

from __future__ import annotations

from typing import Optional

from benchmark.reference.loader import EcPoint, Scalar


class Msm:
    __slots__ = ("constant", "scalars", "bases")

    def __init__(self, constant: Optional[Scalar] = None, scalars=None, bases=None):
        self.constant = constant
        self.scalars = scalars or []  # list[Scalar | None]; None => coeff 1
        self.bases = bases or []  # list[EcPoint]

    # -- constructors (msm.rs:56-72) ---------------------------------------
    @staticmethod
    def constant_term(scalar: Scalar) -> "Msm":
        return Msm(constant=scalar)

    @staticmethod
    def base(point: EcPoint) -> "Msm":
        return Msm(scalars=[None], bases=[point])

    def size(self) -> int:
        return len(self.bases)

    def try_into_constant(self) -> Optional[Scalar]:
        return self.constant if not self.bases else None

    def split(self):
        """(msm without constant, constant) (msm.rs:78-80)."""
        return Msm(None, list(self.scalars), list(self.bases)), self.constant

    # -- evaluation (msm.rs:81-98) ------------------------------------------
    def evaluate(self, gen=None) -> EcPoint:
        """Materialize.  `gen` is an affine int pair used as the base for the
        constant term (svk.g in KZG); required if a constant is present."""
        loader = self._loader()
        pairs = []
        constant = None
        if self.constant is not None:
            assert gen is not None, "constant term requires a generator base"
            pairs.append((self.constant, loader.ec_point_load_const(gen)))
        one = None
        for s, b in zip(self.scalars, self.bases):
            if s is None:
                if one is None:
                    one = loader.load_one()
                s = one
            pairs.append((s, b))
        return loader.multi_scalar_multiplication(pairs, constant)

    def _loader(self):
        if self.constant is not None:
            return self.constant.loader
        return self.bases[0].loader

    # -- term algebra (msm.rs:109-127 + operator impls) ----------------------
    def _push(self, scalar, base):
        for i, b in enumerate(self.bases):
            if b is base:  # identity-dedup, like the reference's pointer dedup
                lhs = self.scalars[i]
                if lhs is None and scalar is None:
                    self.scalars[i] = base.loader.load_const(2)
                elif lhs is None:
                    self.scalars[i] = scalar + base.loader.load_one()
                elif scalar is None:
                    self.scalars[i] = lhs + base.loader.load_one()
                else:
                    self.scalars[i] = lhs + scalar
                return
        self.scalars.append(scalar)
        self.bases.append(base)

    def __add__(self, other: "Msm") -> "Msm":
        out = Msm(self.constant, list(self.scalars), list(self.bases))
        if other.constant is not None:
            out.constant = other.constant if out.constant is None else out.constant + other.constant
        for s, b in zip(other.scalars, other.bases):
            out._push(s, b)
        return out

    def __sub__(self, other: "Msm") -> "Msm":
        return self + (-other)

    def __neg__(self) -> "Msm":
        neg_scalars = []
        loader = self._loader() if (self.constant is not None or self.bases) else None
        for s in self.scalars:
            if s is None:
                neg_scalars.append(loader.load_const(-1 % _r()))
            else:
                neg_scalars.append(-s)
        return Msm(
            None if self.constant is None else -self.constant,
            neg_scalars,
            list(self.bases),
        )

    def __mul__(self, scalar: Scalar) -> "Msm":
        out_scalars = []
        for s in self.scalars:
            out_scalars.append(scalar if s is None else s * scalar)
        return Msm(
            None if self.constant is None else self.constant * scalar,
            out_scalars,
            list(self.bases),
        )

    @staticmethod
    def sum(msms) -> "Msm":
        acc = Msm()
        for m in msms:
            acc = acc + m
        return acc


def _r():
    from benchmark.reference.util import bn254

    return bn254.R
