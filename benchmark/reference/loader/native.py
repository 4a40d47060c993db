"""NativeLoader: the identity interpreter over python ints (oracle backend).

Parity with loader/native.rs:19-93 — scalars are Fr ints, points are affine
(x, y) int pairs (None = identity), MSM is the naive sum.  This backend is
the host-side correctness oracle for the JAX backend and runs the native
pre-pass of aggregation (SDK parity).
"""

from __future__ import annotations

from typing import Optional

from benchmark.reference.errors import AssertionFailure
from benchmark.reference.loader import EcPoint, Loader, Scalar
from benchmark.reference.util import bn254


class NativeLoader(Loader):
    def __init__(self, curve=bn254):
        """`curve`: host curve oracle (the util.bn254 module)."""
        self.curve = curve

    def load_const(self, value: int) -> Scalar:
        return Scalar(self, value % self.curve.R)

    def add(self, a, b):
        return Scalar(self, (a.value + b.value) % self.curve.R)

    def sub(self, a, b):
        return Scalar(self, (a.value - b.value) % self.curve.R)

    def mul(self, a, b):
        return Scalar(self, a.value * b.value % self.curve.R)

    def invert(self, a):
        return Scalar(self, self.curve.inv_mod(a.value, self.curve.R) if a.value else 0)

    def batch_invert(self, scalars):
        values = self.curve.batch_inv_mod([s.value for s in scalars], self.curve.R)
        return [Scalar(self, v) for v in values]

    def ec_point_load_const(self, point) -> EcPoint:
        return EcPoint(self, point)

    def assert_eq(self, annotation, lhs, rhs):
        if lhs.value != rhs.value:
            raise AssertionFailure(annotation)

    def ec_point_assert_eq(self, annotation, lhs, rhs):
        if lhs.value != rhs.value:
            raise AssertionFailure(annotation)

    def multi_scalar_multiplication(self, pairs, constant: Optional[tuple] = None) -> EcPoint:
        crv = self.curve
        acc = constant if constant is not None else None
        for scalar, point in pairs:
            acc = crv.g1_add(acc, crv.g1_mul(point.value, scalar.value))
        return EcPoint(self, acc)


LOADER = NativeLoader()
