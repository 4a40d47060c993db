"""Pure-Python BN254 (alt_bn128) arithmetic oracle.

This module is the *host-side reference implementation* of every cryptographic
primitive the TPU kernels implement: prime fields Fr/Fq, the tower
Fq2/Fq6/Fq12, curve groups G1/G2, and the optimal-ate pairing.  It plays the
role the external ``halo2curves`` crate plays for the Rust reference
(see snark-verifier src/util/arithmetic.rs:13-18) — the
verifier's NativeLoader interprets scalars/points with these types, and every
Pallas/JAX kernel is property-tested bit-exactly against this module.

Nothing here is performance-critical: proofs/benchmarks run on the JAX path.
"""

from __future__ import annotations

# BN254 parameters.  x is the BN curve parameter; p = 36x^4+36x^3+24x^2+6x+1,
# r = 36x^4+36x^3+18x^2+6x+1.
BN_X = 4965661367192848881
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

assert P == 36 * BN_X**4 + 36 * BN_X**3 + 24 * BN_X**2 + 6 * BN_X + 1
assert R == 36 * BN_X**4 + 36 * BN_X**3 + 18 * BN_X**2 + 6 * BN_X + 1


def _find_generator(modulus: int) -> int:
    """Smallest multiplicative generator of the prime field."""
    factors = []
    n = modulus - 1
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    g = 2
    while True:
        if all(pow(g, (modulus - 1) // q, modulus) != 1 for q in factors):
            return g
        g += 1


# Fr two-adicity: r - 1 = 2^28 * odd.
FR_S = 28
assert (R - 1) % (1 << FR_S) == 0 and (R - 1) % (1 << (FR_S + 1)) != 0
# halo2curves bn256::Fr uses GENERATOR = 7 (multiplicative generator of Fr).
FR_GENERATOR = 7
# 2^28-th primitive root of unity, matching halo2curves Fr::ROOT_OF_UNITY.
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (R - 1) >> FR_S, R)


def root_of_unity(k: int) -> int:
    """2^k-th root of unity of Fr, mirroring util/arithmetic.rs:83-90."""
    assert k <= FR_S
    acc = FR_ROOT_OF_UNITY
    for _ in range(FR_S - k):
        acc = acc * acc % R
    return acc


def inv_mod(a: int, m: int) -> int:
    if a % m == 0:
        raise ZeroDivisionError("inversion of zero")
    return pow(a, -1, m)


def batch_inv_mod(values, m):
    """Montgomery batch inversion (mirrors util/arithmetic.rs:47-69)."""
    prods = []
    acc = 1
    for v in values:
        if v % m != 0:
            acc = acc * v % m
            prods.append(acc)
    if not prods:
        return list(values)
    inv = inv_mod(prods[-1], m)
    out = list(values)
    idx = [i for i, v in enumerate(values) if v % m != 0]
    for j in range(len(idx) - 1, -1, -1):
        i = idx[j]
        prev = prods[j - 1] if j > 0 else 1
        out[i] = inv * prev % m
        inv = inv * values[i] % m
    return out


# ---------------------------------------------------------------------------
# Tower field arithmetic.  Elements are represented as nested tuples of ints:
#   Fq2  = (c0, c1)           with u^2 = -1
#   Fq6  = (a0, a1, a2)       each Fq2, with v^3 = xi = 9 + u
#   Fq12 = (b0, b1)           each Fq6, with w^2 = v
# ---------------------------------------------------------------------------

XI = (9, 1)  # 9 + u


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    t2 = (a[0] + a[1]) * (b[0] + b[1]) % P
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sqr(a):
    t0 = (a[0] + a[1]) * (a[0] - a[1]) % P
    t1 = 2 * a[0] * a[1] % P
    return (t0, t1)


def fq2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


def fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = inv_mod(norm, P)
    return (a[0] * ninv % P, (-a[1]) * ninv % P)


def fq2_mul_xi(a):
    """Multiply by xi = 9 + u."""
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    """Multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)."""
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    norm = fq2_add(fq2_mul(a0, c0), fq2_mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))))
    ninv = fq2_inv(norm)
    return (fq2_mul(c0, ninv), fq2_mul(c1, ninv), fq2_mul(c2, ninv))


FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_mul(a, b):
    t0 = fq6_mul(a[0], b[0])
    t1 = fq6_mul(a[1], b[1])
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1])), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    norm = fq6_sub(fq6_sqr(a[0]), fq6_mul_by_v(fq6_sqr(a[1])))
    ninv = fq6_inv(norm)
    return (fq6_mul(a[0], ninv), fq6_neg(fq6_mul(a[1], ninv)))


def fq12_pow(a, e):
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


FQ12_ONE = (FQ6_ONE, FQ6_ZERO)

# Frobenius coefficients for Fq2 within the tower: gamma values.
# FROB_FQ12_C1[i] = xi^((p^i - 1) / 6) in Fq2, used for Frobenius on Fq12/G2.
def _fq2_pow(a, e):
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sqr(base)
        e >>= 1
    return result


FROB_FQ12_C1 = [_fq2_pow(XI, ((P**i) - 1) // 6) for i in range(12)]
FROB_FQ6_C1 = [_fq2_pow(XI, ((P**i) - 1) // 3) for i in range(6)]
FROB_FQ6_C2 = [_fq2_pow(XI, (2 * (P**i) - 2) // 3) for i in range(6)]


def fq2_frob(a, power):
    """Frobenius on Fq2: conjugate if power is odd."""
    return fq2_conj(a) if power % 2 else a


def fq6_frob(a, power):
    a0 = fq2_frob(a[0], power)
    a1 = fq2_mul(fq2_frob(a[1], power), FROB_FQ6_C1[power % 6])
    a2 = fq2_mul(fq2_frob(a[2], power), FROB_FQ6_C2[power % 6])
    return (a0, a1, a2)


def fq12_frob(a, power):
    c0 = fq6_frob(a[0], power)
    c1 = fq6_frob(a[1], power)
    c1 = tuple(fq2_mul(x, FROB_FQ12_C1[power % 12]) for x in c1)
    return (c0, c1)


# ---------------------------------------------------------------------------
# G1: y^2 = x^3 + 3 over Fq.  Points are (x, y) tuples or None for infinity.
# ---------------------------------------------------------------------------

G1_B = 3
G1_GEN = (1, 2)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - G1_B) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * inv_mod(2 * y1, P) % P
    else:
        lam = (y2 - y1) * inv_mod((x2 - x1) % P, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(a):
    return g1_add(a, a)


# Jacobian helpers: used internally for speed (no per-add inversion); the
# public API stays affine ((x, y) tuples, None = identity).


def _jac_double(p):
    if p is None:
        return None
    x, y, z = p
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    f = e * e % P
    x3 = (f - 2 * d) % P
    y3 = (e * (d - x3) - 8 * c) % P
    z3 = 2 * y * z % P
    return (x3, y3, z3)


def _jac_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        if (s1 + s2) % P == 0:
            return None
        return _jac_double(p)
    h = (u2 - u1) % P
    i = 4 * h * h % P
    j = h * i % P
    r = 2 * (s2 - s1) % P
    v = u1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * s1 * j) % P
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) * h % P
    return (x3, y3, z3)


def _to_jac(pt):
    return None if pt is None else (pt[0], pt[1], 1)


def _from_jac(p):
    if p is None or p[2] == 0:
        return None
    zinv = inv_mod(p[2], P)
    z2 = zinv * zinv % P
    return (p[0] * z2 % P, p[1] * z2 * zinv % P)


def _jac_mul(p, k):
    k %= R
    result = None
    addend = p
    while k:
        if k & 1:
            result = _jac_add(result, addend)
        addend = _jac_double(addend)
        k >>= 1
    return result


def g1_mul(pt, k):
    return _from_jac(_jac_mul(_to_jac(pt), k))


def g1_msm(scalars, points):
    """Naive reference MSM (semantics of util/msm.rs:259-343)."""
    acc = None
    for s, pt in zip(scalars, points):
        acc = _jac_add(acc, _jac_mul(_to_jac(pt), s))
    return _from_jac(acc)


# ---------------------------------------------------------------------------
# G2: y^2 = x^3 + b' over Fq2 with b' = 3 / xi.  Points ((x0,x1),(y0,y1)).
# ---------------------------------------------------------------------------

G2_B = fq2_mul((3, 0), fq2_inv(XI))
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = fq2_sqr(y)
    rhs = fq2_add(fq2_mul(fq2_sqr(x), x), G2_B)
    return lhs == rhs


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], fq2_neg(pt[1]))


def g2_add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(fq2_scalar(fq2_sqr(x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sqr(lam), fq2_add(x1, x2))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(pt, k):
    k %= R
    result = None
    addend = pt
    while k:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


# ---------------------------------------------------------------------------
# Optimal ate pairing.
# Miller loop runs over 6x+2 in NAF form, followed by two Frobenius line
# evaluations; final exponentiation is (p^12-1)/r via easy + hard part.
# ---------------------------------------------------------------------------

ATE_LOOP_COUNT = 6 * BN_X + 2


def _naf(n: int):
    digits = []
    while n:
        if n & 1:
            d = 2 - (n % 4)
            n -= d
        else:
            d = 0
        digits.append(d)
        n >>= 1
    return digits  # little-endian


ATE_NAF = _naf(ATE_LOOP_COUNT)


def _line_double(q, p):
    """Double q (Jacobian-free affine doubling in Fq2), return (2q, line@p).

    Line evaluated at affine G1 point p=(px,py), embedded sparsely in Fq12 as
    l = a + b*w + c*w^3 structure; we build the full Fq12 element directly.
    """
    (xq, yq) = q
    px, py = p
    lam = fq2_mul(fq2_scalar(fq2_sqr(xq), 3), fq2_inv(fq2_scalar(yq, 2)))
    x3 = fq2_sub(fq2_sqr(lam), fq2_scalar(xq, 2))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(xq, x3)), yq)
    # line: l(P) = py - lam*px_as... construct l = (yq - lam*xq) + lam*px*w^? ;
    # use standard embedding for D-type twist (xi = 9+u):
    #   l = (py * 1) - (lam * px) * w^2-ish... We use the direct formulation:
    #   l(P) = py - lam*(px) ... in Fq12 via untwisting.
    c0 = fq2_scalar(FQ2_ONE, py)                      # coefficient of 1 (times py)
    c1 = fq2_scalar(fq2_neg(lam), px)                 # coefficient of w^2? -> see below
    c3 = fq2_sub(fq2_mul(lam, xq), yq)
    # Fq12 element: c0*py at position (0,0,0); c1 at (1,0); c3 at (1,1)... The
    # canonical sparse embedding for BN254 D-twist lines is
    #   l = c0 + c1 * w + c3 * w^3  with w^2 = v:
    #   positions: Fq12 = Fq6 + Fq6*w;  Fq6 = Fq2 + Fq2*v + Fq2*v^2
    #   c0 -> (0, coeff of 1); c1*w -> second component slot 0; w^3 = v*w -> second comp slot 1
    l = (
        (c0, FQ2_ZERO, FQ2_ZERO),
        (c1, c3, FQ2_ZERO),
    )
    return (x3, y3), l


def _line_add(q, r, p):
    """Add r + q (affine Fq2 points), return (r+q, line@p)."""
    (xq, yq) = q
    (xr, yr) = r
    px, py = p
    lam = fq2_mul(fq2_sub(yr, yq), fq2_inv(fq2_sub(xr, xq)))
    x3 = fq2_sub(fq2_sqr(lam), fq2_add(xq, xr))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(xq, x3)), yq)
    c0 = fq2_scalar(FQ2_ONE, py)
    c1 = fq2_scalar(fq2_neg(lam), px)
    c3 = fq2_sub(fq2_mul(lam, xq), yq)
    l = (
        (c0, FQ2_ZERO, FQ2_ZERO),
        (c1, c3, FQ2_ZERO),
    )
    return (x3, y3), l


def miller_loop(p, q):
    """Miller loop for a single (G1, G2) pair. p, q affine, non-infinity."""
    if p is None or q is None:
        return FQ12_ONE
    f = FQ12_ONE
    t = q
    for i in range(len(ATE_NAF) - 2, -1, -1):
        f = fq12_sqr(f)
        t, l = _line_double(t, p)
        f = fq12_mul(f, l)
        if ATE_NAF[i] == 1:
            t, l = _line_add(q, t, p)
            f = fq12_mul(f, l)
        elif ATE_NAF[i] == -1:
            t, l = _line_add(g2_neg(q), t, p)
            f = fq12_mul(f, l)
    # Frobenius steps: q1 = pi_p(q), then add q1 and -pi_p(q1).
    q1 = _g2_frobenius(q)
    q2 = g2_neg(_g2_frobenius(q1))
    t, l = _line_add(q1, t, p)
    f = fq12_mul(f, l)
    t, l = _line_add(q2, t, p)
    f = fq12_mul(f, l)
    return f


def _g2_frobenius(q):
    """Untwist-Frobenius-twist endomorphism pi on the G2 twist."""
    x, y = q
    return (
        fq2_mul(fq2_conj(x), _g2_frob_x_coeff()),
        fq2_mul(fq2_conj(y), _g2_frob_y_coeff()),
    )


def _g2_frob_x_coeff():
    # xi^((p-1)/3)
    return FROB_FQ6_C1[1]


def _g2_frob_y_coeff():
    # xi^((p-1)/2)
    return _fq2_pow(XI, (P - 1) // 2)


def final_exponentiation(f):
    return fq12_pow(f, (P**12 - 1) // R)


def final_exponentiation_chain(f):
    """Easy part + Scott-et-al. hard-part addition chain; equals the naive
    exponentiation (validated in tests) at ~300 Fq12 ops instead of ~6000.
    This is the template for the device kernel (ops/pairing.py)."""
    # easy: f^((p^6-1)(p^2+1))
    f = fq12_mul(fq12_conj(f), fq12_inv(f))
    f = fq12_mul(fq12_frob(f, 2), f)
    # hard: f^((p^4-p^2+1)/r)
    fp = fq12_frob(f, 1)
    fp2 = fq12_frob(f, 2)
    fp3 = fq12_frob(fp2, 1)
    fu = fq12_pow(f, BN_X)
    fu2 = fq12_pow(fu, BN_X)
    fu3 = fq12_pow(fu2, BN_X)
    y3 = fq12_conj(fq12_frob(fu, 1))
    fu2p = fq12_frob(fu2, 1)
    fu3p = fq12_frob(fu3, 1)
    y2 = fq12_frob(fu2, 2)
    y0 = fq12_mul(fq12_mul(fp, fp2), fp3)
    y1 = fq12_conj(f)
    y4 = fq12_conj(fq12_mul(fu, fu2p))
    y5 = fq12_conj(fu2)
    y6 = fq12_conj(fq12_mul(fu3, fu3p))
    t0 = fq12_mul(fq12_mul(fq12_sqr(y6), y4), y5)
    t1 = fq12_mul(fq12_mul(y3, y5), t0)
    t0 = fq12_mul(t0, y2)
    t1 = fq12_mul(fq12_sqr(t1), t0)
    t1 = fq12_sqr(t1)
    t0 = fq12_mul(t1, y1)
    t1 = fq12_mul(t1, y0)
    t0 = fq12_sqr(t0)
    return fq12_mul(t0, t1)


def pairing(p, q):
    """e(p in G1, q in G2) with full final exponentiation (reference oracle)."""
    return final_exponentiation(miller_loop(p, q))


def multi_miller_loop(pairs):
    """Product of Miller loops (mirrors pcs/kzg/decider.rs:70-82 semantics)."""
    f = FQ12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = fq12_mul(f, miller_loop(p, q))
    return f


def pairing_check(pairs) -> bool:
    """True iff prod e(p_i, q_i) == 1."""
    return final_exponentiation(multi_miller_loop(pairs)) == FQ12_ONE


def fast_msm(scalars, points):
    """MSM by the pure-python oracle."""
    return g1_msm(scalars, points)
