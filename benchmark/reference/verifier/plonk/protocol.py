"""PLONK protocol data model — the machine-readable description of a PLONK
instance the verifier is specialized against.

Mirrors the semantics of the reference's `PlonkProtocol` / `Expression` /
`CommonPolynomialEvaluation` (verifier/plonk/protocol.rs:20-547), redesigned
for the JAX tracing model: a protocol is *static trace-time data* (python
ints / structure), so every protocol-dependent loop unrolls at `jit` trace
time — the analogue of how the reference's EvmLoader unrolls the verifier
into straight-line Yul.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from benchmark.reference.util import bn254


# ---------------------------------------------------------------------------
# Domain / Rotation (util/arithmetic.rs:95-160)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rotation:
    value: int = 0

    @staticmethod
    def cur():
        return Rotation(0)

    @staticmethod
    def prev():
        return Rotation(-1)

    @staticmethod
    def next():
        return Rotation(1)


@dataclass(frozen=True)
class Domain:
    """2-adic multiplicative domain over a scalar field (python-int
    constants; the field modulus rides along so non-BN254 instantiations —
    pasta for the IPA stack — reuse the same machinery)."""

    k: int
    n: int
    n_inv: int
    gen: int
    gen_inv: int
    r: int = bn254.R  # scalar field modulus

    @staticmethod
    def new(k: int, gen: Optional[int] = None, curve=bn254) -> "Domain":
        gen = curve.root_of_unity(k) if gen is None else gen
        n = 1 << k
        return Domain(
            k=k,
            n=n,
            n_inv=curve.inv_mod(n, curve.R),
            gen=gen,
            gen_inv=curve.inv_mod(gen, curve.R),
            r=curve.R,
        )

    def rotate_scalar(self, scalar: int, rotation: Rotation) -> int:
        """scalar * gen^rotation (util/arithmetic.rs:153-159)."""
        rot = rotation.value
        if rot == 0:
            return scalar % self.r
        base = self.gen if rot > 0 else self.gen_inv
        return scalar * pow(base, abs(rot), self.r) % self.r


# ---------------------------------------------------------------------------
# Expression AST (protocol.rs:318-443)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Query:
    poly: int
    rotation: Rotation = Rotation(0)

    @staticmethod
    def new(poly: int, rot: int = 0) -> "Query":
        return Query(poly, Rotation(rot))


class Expression:
    """Symbolic constraint language over Fr constants (python ints)."""

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        raise NotImplementedError

    # operator sugar, mirroring protocol.rs:457-516
    def __add__(self, other):
        return Sum(self, _lift(other))

    def __radd__(self, other):
        return Sum(_lift(other), self)

    def __sub__(self, other):
        return Sum(self, Negated(_lift(other)))

    def __rsub__(self, other):
        return Sum(_lift(other), Negated(self))

    def __mul__(self, other):
        if isinstance(other, int):
            return Scaled(self, other)
        return Product(self, _lift(other))

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return Negated(self)

    def degree(self) -> int:
        raise NotImplementedError

    def used_lagrange(self) -> set:
        out = set()
        _walk(self, lambda e: out.update([e.index]) if isinstance(e, CommonLagrange) else None)
        return out

    def used_query(self) -> set:
        out = set()
        _walk(self, lambda e: out.add(e.query) if isinstance(e, Polynomial) else None)
        return out

    def used_challenge(self) -> set:
        out = set()
        _walk(self, lambda e: out.add(e.index) if isinstance(e, Challenge) else None)
        return out


def _lift(v) -> "Expression":
    return Constant(v) if isinstance(v, int) else v


def _walk(expr, fn):
    fn(expr)
    for child in getattr(expr, "_children", lambda: [])():
        _walk(child, fn)


@dataclass(frozen=True)
class Constant(Expression):
    value: int

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        return constant(self.value)

    def degree(self):
        return 0

    def _children(self):
        return []


@dataclass(frozen=True)
class CommonIdentity(Expression):
    """The identity polynomial X (evaluates to the query point z)."""

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        return common_poly(("identity", 0))

    def degree(self):
        return 1

    def _children(self):
        return []

    def __repr__(self):
        return "Identity"


@dataclass(frozen=True)
class CommonLagrange(Expression):
    """l_i(X), the i-th Lagrange basis polynomial (i may be negative)."""

    index: int

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        return common_poly(("lagrange", self.index))

    def degree(self):
        return 1

    def _children(self):
        return []


@dataclass(frozen=True)
class Polynomial(Expression):
    query: Query

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        return poly(self.query)

    def degree(self):
        return 1

    def _children(self):
        return []


@dataclass(frozen=True)
class Challenge(Expression):
    index: int

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        return challenge(self.index)

    def degree(self):
        return 0

    def _children(self):
        return []


@dataclass(frozen=True)
class Negated(Expression):
    inner: Expression

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        return negated(self.inner.evaluate(constant, common_poly, poly, challenge, negated, sum_, product, scaled))

    def degree(self):
        return self.inner.degree()

    def _children(self):
        return [self.inner]


@dataclass(frozen=True)
class Sum(Expression):
    lhs: Expression
    rhs: Expression

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        fns = (constant, common_poly, poly, challenge, negated, sum_, product, scaled)
        return sum_(self.lhs.evaluate(*fns), self.rhs.evaluate(*fns))

    def degree(self):
        return max(self.lhs.degree(), self.rhs.degree())

    def _children(self):
        return [self.lhs, self.rhs]


@dataclass(frozen=True)
class Product(Expression):
    lhs: Expression
    rhs: Expression

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        fns = (constant, common_poly, poly, challenge, negated, sum_, product, scaled)
        return product(self.lhs.evaluate(*fns), self.rhs.evaluate(*fns))

    def degree(self):
        return self.lhs.degree() + self.rhs.degree()

    def _children(self):
        return [self.lhs, self.rhs]


@dataclass(frozen=True)
class Scaled(Expression):
    inner: Expression
    scalar: int

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        fns = (constant, common_poly, poly, challenge, negated, sum_, product, scaled)
        return scaled(self.inner.evaluate(*fns), self.scalar)

    def degree(self):
        return self.inner.degree()

    def _children(self):
        return [self.inner]


@dataclass(frozen=True)
class DistributePowers(Expression):
    """sum_i exprs[i] * base^(len-1-i) — Horner-folded with `base` powers
    (protocol.rs:379-390)."""

    exprs: tuple
    base: Expression

    def evaluate(self, constant, common_poly, poly, challenge, negated, sum_, product, scaled):
        fns = (constant, common_poly, poly, challenge, negated, sum_, product, scaled)
        assert self.exprs
        if len(self.exprs) == 1:
            return self.exprs[0].evaluate(*fns)
        scalar = self.base.evaluate(*fns)
        acc = self.exprs[0].evaluate(*fns)
        for expr in self.exprs[1:]:
            acc = sum_(product(acc, scalar), expr.evaluate(*fns))
        return acc

    def degree(self):
        return max(e.degree() for e in list(self.exprs) + [self.base])

    def _children(self):
        return list(self.exprs) + [self.base]


# ---------------------------------------------------------------------------
# Protocol (protocol.rs:20-71)
# ---------------------------------------------------------------------------


@dataclass
class QuotientPolynomial:
    chunk_degree: int
    num_chunk: int
    numerator: Expression


@dataclass
class InstanceCommittingKey:
    bases: list  # [(x, y)] affine int pairs
    constant: Optional[tuple] = None


@dataclass
class PlonkProtocol:
    """Complete description of a PLONK verifier instance.

    `preprocessed` holds affine int pairs (host constants); loaders lift them
    to backend values via `loaded()`.
    """

    domain: Domain
    preprocessed: list  # [(x, y)] | None entries
    num_instance: list
    num_witness: list
    num_challenge: list
    evaluations: list  # [Query]
    queries: list  # [Query]
    quotient: QuotientPolynomial
    transcript_initial_state: Optional[int] = None
    instance_committing_key: Optional[InstanceCommittingKey] = None
    linearization: Optional[str] = None  # None | "without-constant" | "minus-vanishing"
    accumulator_indices: list = field(default_factory=list)  # [[(i, j)]]

    def langranges(self):
        """Lagrange indices needed by CommonPolynomialEvaluation
        (protocol.rs:78-106; name kept for parity)."""
        out = set(self.quotient.numerator.used_lagrange())
        if self.instance_committing_key is None:
            offset = len(self.preprocessed)
            rng = range(offset, offset + len(self.num_instance))
            queries = [q for q in self.quotient.numerator.used_query() if q.poly in rng]
            min_rot = min((q.rotation.value for q in queries), default=0)
            max_rot = max((q.rotation.value for q in queries), default=0)
            max_instance_len = max(self.num_instance, default=0)
            out.update(range(-max_rot, max_instance_len + abs(min_rot)))
        return sorted(out)

    def loaded(self, loader):
        """Lift host constants into loader values (protocol.rs:114-138)."""
        return LoadedProtocol(self, loader)

    def loaded_preprocessed_as_witness(self, loader):
        """Lift preprocessed commitments + transcript initial state as
        WITNESSES instead of constants (protocol.rs:158-188) — the recursion
        variant for verifying snarks whose verifying key is not fixed at
        circuit-definition time (the vk becomes part of the witness)."""
        return LoadedProtocol(self, loader, as_witness=True)


class LoadedProtocol:
    """Protocol with preprocessed commitments / initial state lifted into a
    loader's value domain."""

    def __init__(self, protocol: PlonkProtocol, loader, as_witness: bool = False):
        self.inner = protocol
        self.loader = loader
        if as_witness:
            self.preprocessed = [
                loader.assign_ec_point(pt) for pt in protocol.preprocessed
            ]
            self.transcript_initial_state = (
                loader.assign_scalar(protocol.transcript_initial_state)
                if protocol.transcript_initial_state is not None
                else None
            )
        else:
            self.preprocessed = [
                loader.ec_point_load_const(pt) for pt in protocol.preprocessed
            ]
            self.transcript_initial_state = (
                loader.load_const(protocol.transcript_initial_state)
                if protocol.transcript_initial_state is not None
                else None
            )

    def __getattr__(self, name):
        return getattr(self.inner, name)
