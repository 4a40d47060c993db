"""Loader abstraction: one verifier program, many interpreters.

This is the TPU-native re-design of the reference's load-bearing idea
(loader.rs:22-274): the PLONK verifier is written once against abstract
`Scalar` / `EcPoint` handles provided by a `Loader`; swapping the loader
re-targets the same verifier:

* `NativeLoader`  — python-int interpreter (host oracle; reference parity
  with loader/native.rs).
* `JaxLoader`     — values are traced jnp limb arrays; running the verifier
  under `jax.jit` stages it into ONE fused XLA computation, `vmap`-style
  batching falls out of array leading dims, and `shard_map` distributes it
  over a TPU mesh.  (The JAX tracer plays the role the reference's staged
  EvmLoader/halo2 interpreters play.)
* `EvmLoader`     — Yul code generator (loader/evm.py): the same staging
  trick with Solidity text as the target.
"""

from __future__ import annotations

from typing import Optional

from benchmark.reference.util import bn254 as _bn254


class Scalar:
    """A loaded Fr element; arithmetic delegates to the loader."""

    __slots__ = ("loader", "value")

    def __init__(self, loader, value):
        self.loader = loader
        self.value = value

    def _coerce(self, other) -> "Scalar":
        if isinstance(other, Scalar):
            return other
        if isinstance(other, int):
            return self.loader.load_const(other)
        raise TypeError(f"cannot coerce {type(other)} to Scalar")

    def __add__(self, other):
        return self.loader.add(self, self._coerce(other))

    __radd__ = __add__

    def __sub__(self, other):
        return self.loader.sub(self, self._coerce(other))

    def __rsub__(self, other):
        return self.loader.sub(self._coerce(other), self)

    def __mul__(self, other):
        return self.loader.mul(self, self._coerce(other))

    __rmul__ = __mul__

    def __neg__(self):
        return self.loader.neg(self)

    def invert(self) -> "Scalar":
        return self.loader.invert(self)

    def pow_const(self, exponent: int) -> "Scalar":
        return self.loader.pow_const(self, exponent)

    def powers(self, n: int) -> list:
        """[1, x, x^2, ..., x^(n-1)] (loader.rs:74-78)."""
        out = [self.loader.load_one()]
        for _ in range(1, n):
            out.append(out[-1] * self)
        return out

    def __repr__(self):
        return f"Scalar({self.value!r})"


class EcPoint:
    """A loaded G1 point handle."""

    __slots__ = ("loader", "value")

    def __init__(self, loader, value):
        self.loader = loader
        self.value = value

    def __repr__(self):
        return f"EcPoint({self.value!r})"


class Loader:
    """Backend interface.  Rich helpers have default implementations in terms
    of the primitive ops, mirroring the reference's default-methods design
    (loader.rs:116-263) that keeps backend surface small.

    `curve` is the host-side curve oracle (the `util.bn254` module)."""

    curve = _bn254  # class default; NativeLoader may override per instance

    # -- primitives ---------------------------------------------------------
    def load_const(self, value: int) -> Scalar:
        raise NotImplementedError

    def load_one(self) -> Scalar:
        return self.load_const(1)

    def load_zero(self) -> Scalar:
        return self.load_const(0)

    def add(self, a: Scalar, b: Scalar) -> Scalar:
        raise NotImplementedError

    def sub(self, a: Scalar, b: Scalar) -> Scalar:
        raise NotImplementedError

    def mul(self, a: Scalar, b: Scalar) -> Scalar:
        raise NotImplementedError

    def neg(self, a: Scalar) -> Scalar:
        return self.sub(self.load_zero(), a)

    def invert(self, a: Scalar) -> Scalar:
        raise NotImplementedError

    def pow_const(self, a: Scalar, exponent: int) -> Scalar:
        assert exponent >= 0
        if exponent == 0:
            return self.load_one()
        result = None
        base = a
        e = exponent
        while e:
            if e & 1:
                result = base if result is None else self.mul(result, base)
            base = self.mul(base, base)
            e >>= 1
        return result

    def batch_invert(self, scalars: list) -> list:
        """Invert many scalars with ONE field inversion via the Montgomery
        trick (3(n-1) muls + 1 invert), mirroring the generated batch-invert
        block of the reference's EvmLoader (loader/evm/loader.rs:827-899) —
        but implemented once, loader-generically, so every backend (native /
        JAX / EVM-codegen) gets it.  Backends with a cheaper vectorized
        inversion may override."""
        n = len(scalars)
        if n <= 1:
            return [self.invert(s) for s in scalars]
        prefix = [scalars[0]]
        for s in scalars[1:]:
            prefix.append(self.mul(prefix[-1], s))
        running = self.invert(prefix[-1])
        out = [None] * n
        for i in range(n - 1, 0, -1):
            out[i] = self.mul(running, prefix[i - 1])
            running = self.mul(running, scalars[i])
        out[0] = running
        return out

    def ec_point_load_const(self, point) -> EcPoint:
        """point: (x, y) int pair or None for identity."""
        raise NotImplementedError

    def ec_point_assert_eq(self, annotation: str, lhs: EcPoint, rhs: EcPoint):
        raise NotImplementedError

    def assert_eq(self, annotation: str, lhs: Scalar, rhs: Scalar):
        raise NotImplementedError

    def multi_scalar_multiplication(self, pairs, constant: Optional[tuple] = None) -> EcPoint:
        """sum_i scalar_i * point_i (+ constant base with coeff 1)."""
        raise NotImplementedError

    # -- derived helpers (loader.rs:142-263) --------------------------------
    def sum_with_coeff_and_const(self, values, constant: int) -> Scalar:
        """sum_i coeff_i * value_i + constant; values = [(int, Scalar)]."""
        acc = None
        for coeff, v in values:
            term = v if coeff == 1 else self.mul(self.load_const(coeff), v)
            acc = term if acc is None else self.add(acc, term)
        if constant:
            c = self.load_const(constant)
            acc = c if acc is None else self.add(acc, c)
        return acc if acc is not None else self.load_zero()

    def sum_with_coeff(self, values) -> Scalar:
        return self.sum_with_coeff_and_const(values, 0)

    def sum(self, values) -> Scalar:
        return self.sum_with_coeff_and_const([(1, v) for v in values], 0)

    def sum_products_with_coeff_and_const(self, values, constant: int) -> Scalar:
        """sum_i coeff_i * a_i * b_i + constant; values = [(int, Scalar, Scalar)]."""
        acc = None
        for coeff, a, b in values:
            term = self.mul(a, b)
            if coeff != 1:
                term = self.mul(self.load_const(coeff), term)
            acc = term if acc is None else self.add(acc, term)
        if constant:
            c = self.load_const(constant)
            acc = c if acc is None else self.add(acc, c)
        return acc if acc is not None else self.load_zero()

    def sum_products_with_coeff(self, values) -> Scalar:
        return self.sum_products_with_coeff_and_const(values, 0)

    def sum_products(self, values) -> Scalar:
        """sum_i a_i * b_i; values = [(Scalar, Scalar)]."""
        return self.sum_products_with_coeff_and_const([(1, a, b) for a, b in values], 0)

    def product(self, values) -> Scalar:
        acc = None
        for v in values:
            acc = v if acc is None else self.mul(acc, v)
        return acc if acc is not None else self.load_one()
