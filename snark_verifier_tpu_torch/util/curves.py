"""Generic short-Weierstrass curve oracles (python ints) + pasta instances.

The IPA stack is curve-generic in the reference (pcs/ipa.rs over
`CurveAffine`, tested on pasta/pallas — system/halo2/test/ipa/native.rs).
`WeierstrassCurve` packages the same module-level interface `util/bn254.py`
exposes (R, P, G1_GEN, g1_add, g1_mul, fast_msm, inv_mod, batch_inv_mod,
root_of_unity, ...) as an object, so a curve can be threaded through
loaders/transcripts/PCS keys; the `bn254` MODULE itself satisfies the same
interface and stays the default everywhere.

Pasta constants (zcash pasta_curves): p and q are the two Fp/Fq primes,
both curves are y^2 = x^3 + 5 with generator (-1, 2) and 2-adicity 32 with
multiplicative generator 5.  (Self-check: 2^2 = 4 = (-1)^3 + 5.)
"""

from __future__ import annotations

import random


def sqrt_mod(a: int, p: int) -> int | None:
    """Tonelli-Shanks square root mod odd prime p (None if non-residue)."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # write p-1 = q * 2^s
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


class WeierstrassCurve:
    """y^2 = x^3 + b over F_P with scalar field F_R; affine (x, y) tuples,
    None = identity (the same representation as the bn254 oracle)."""

    def __init__(self, name: str, P: int, R: int, b: int, gen, two_adicity: int, mult_gen: int):
        self.name = name
        self.P = P
        self.R = R
        self.G1_B = b
        self.G1_GEN = (gen[0] % P, gen[1] % P)
        self.FR_S = two_adicity
        self.FR_GENERATOR = mult_gen
        assert (R - 1) % (1 << two_adicity) == 0
        self.FR_ROOT_OF_UNITY = pow(mult_gen, (R - 1) >> two_adicity, R)
        assert self.g1_is_on_curve(self.G1_GEN)

    # -- scalar field --------------------------------------------------------
    @staticmethod
    def inv_mod(a: int, m: int) -> int:
        return pow(a, -1, m)

    @staticmethod
    def batch_inv_mod(values, m):
        n = len(values)
        prefix = [1] * (n + 1)
        for i, v in enumerate(values):
            prefix[i + 1] = prefix[i] * (v if v else 1) % m
        inv = pow(prefix[n], -1, m)
        out = [0] * n
        for i in range(n - 1, -1, -1):
            v = values[i]
            if v:
                out[i] = inv * prefix[i] % m
                inv = inv * v % m
        return out

    def root_of_unity(self, k: int) -> int:
        assert k <= self.FR_S
        acc = self.FR_ROOT_OF_UNITY
        for _ in range(self.FR_S - k):
            acc = acc * acc % self.R
        return acc

    # -- group ---------------------------------------------------------------
    def g1_is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - x * x * x - self.G1_B) % self.P == 0

    def g1_neg(self, pt):
        return None if pt is None else (pt[0], (-pt[1]) % self.P)

    def g1_add(self, a, b):
        P = self.P
        if a is None:
            return b
        if b is None:
            return a
        x1, y1 = a
        x2, y2 = b
        if x1 == x2:
            if (y1 + y2) % P == 0:
                return None
            lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
        else:
            lam = (y2 - y1) * pow((x2 - x1) % P, -1, P) % P
        x3 = (lam * lam - x1 - x2) % P
        y3 = (lam * (x1 - x3) - y1) % P
        return (x3, y3)

    def g1_double(self, a):
        return self.g1_add(a, a)

    def g1_mul(self, pt, k):
        k %= self.R
        if pt is None or k == 0:
            return None
        acc = None
        for bit in bin(k)[2:]:
            acc = self.g1_add(acc, acc)
            if bit == "1":
                acc = self.g1_add(acc, pt)
        return acc

    def fast_msm(self, scalars, points):
        acc = None
        for s, p in zip(scalars, points):
            acc = self.g1_add(acc, self.g1_mul(p, s))
        return acc

    def g1_sqrt_y(self, x: int) -> int | None:
        """y with y^2 = x^3 + b, or None (for compressed-point decoding)."""
        return sqrt_mod((pow(x, 3, self.P) + self.G1_B) % self.P, self.P)

    def rand_point(self, rng: random.Random):
        return self.g1_mul(self.G1_GEN, rng.randrange(1, self.R))


_PALLAS_P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
_VESTA_P = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# Pallas: points over F_{pallas_p}, scalars in F_{vesta_p} (and vice versa)
pallas = WeierstrassCurve("pallas", _PALLAS_P, _VESTA_P, 5, (-1, 2), 32, 5)
vesta = WeierstrassCurve("vesta", _VESTA_P, _PALLAS_P, 5, (-1, 2), 32, 5)
