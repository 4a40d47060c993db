"""Inner-product-argument polynomial commitment scheme + accumulation.

Algorithmic parity with pcs/ipa.rs / pcs/ipa/{accumulation,decider}.rs —
the second PCS family, proving the loader abstraction holds beyond KZG.
The scheme is curve-generic: keys carry a host curve oracle (`curve`
field, util.bn254 by default) and the stack is exercised over BOTH BN254
and pasta/pallas (the reference's instantiation,
system/halo2/test/ipa/native.rs) — see tests/test_ipa.py / test_bgh19.py.

The prover (`Ipa.create_proof`, the only real prover hot loop in the
reference, pcs/ipa.rs:40-123) runs host-side; `succinct_verify` is
loader-generic and runs on any backend; `decide` recomputes the big
U == MSM(g, h_coeffs(xi)) check — on the JAX backend via the large-N
Pippenger kernel.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Optional

from snark_verifier_tpu_torch.errors import AssertionFailure
from snark_verifier_tpu_torch.loader import EcPoint, Scalar
from snark_verifier_tpu_torch.loader.native import NativeLoader
from snark_verifier_tpu_torch.util import bn254
from snark_verifier_tpu_torch.util.msm_symbolic import Msm
from snark_verifier_tpu_torch.verifier.plonk.protocol import Domain

R = bn254.R


@dataclass
class IpaProvingKey:
    domain: Domain
    g: list  # [(x, y)]
    h: tuple
    s: Optional[tuple] = None
    curve: object = bn254  # host curve oracle (bn254 module or pasta)

    def zk(self) -> bool:
        return self.s is not None

    def svk(self) -> "IpaSuccinctVerifyingKey":
        return IpaSuccinctVerifyingKey(self.domain, self.g[0], self.h, self.s, self.curve)

    def dk(self) -> "IpaDecidingKey":
        return IpaDecidingKey(self.svk(), list(self.g))

    def commit(self, coeffs, omega: Optional[int] = None):
        crv = self.curve
        c = crv.fast_msm(coeffs, self.g[: len(coeffs)])
        if self.s is not None:
            assert omega is not None
            c = crv.g1_add(c, crv.g1_mul(self.s, omega))
        else:
            assert omega is None
        return c

    @staticmethod
    def rand(k: int, zk: bool, seed: int = 0, curve=bn254) -> "IpaProvingKey":
        rng = random.Random(seed)
        n = 1 << k
        r = curve.R
        g = [curve.g1_mul(curve.G1_GEN, rng.randrange(1, r)) for _ in range(n)]
        h = curve.g1_mul(curve.G1_GEN, rng.randrange(1, r))
        s = curve.g1_mul(curve.G1_GEN, rng.randrange(1, r)) if zk else None
        return IpaProvingKey(Domain.new(k, curve=curve), g, h, s, curve)


@dataclass
class IpaSuccinctVerifyingKey:
    domain: Domain
    g: tuple
    h: tuple
    s: Optional[tuple] = None
    curve: object = bn254

    def zk(self) -> bool:
        return self.s is not None


@dataclass
class IpaDecidingKey:
    svk: IpaSuccinctVerifyingKey
    g: list


@dataclass
class IpaAccumulator:
    xi: list  # [Scalar]
    u: object  # EcPoint


@dataclass
class Round:
    l: object
    r: object
    xi: object


@dataclass
class IpaProof:
    c_bar_alpha: Optional[tuple]
    omega_prime: Optional[object]
    xi_0: object
    rounds: list
    u: object
    c: object

    @classmethod
    def read(cls, svk: IpaSuccinctVerifyingKey, transcript) -> "IpaProof":
        c_bar_alpha = None
        omega_prime = None
        if svk.zk():
            c_bar = transcript.read_ec_point()
            alpha = transcript.squeeze_challenge()
            c_bar_alpha = (c_bar, alpha)
            omega_prime = transcript.read_scalar()
        xi_0 = transcript.squeeze_challenge()
        rounds = [
            Round(
                transcript.read_ec_point(),
                transcript.read_ec_point(),
                transcript.squeeze_challenge(),
            )
            for _ in range(svk.domain.k)
        ]
        u = transcript.read_ec_point()
        c = transcript.read_scalar()
        return cls(c_bar_alpha, omega_prime, xi_0, rounds, u, c)

    def xi(self) -> list:
        return [r.xi for r in self.rounds]

    def xi_inv(self) -> list:
        loader = self.xi_0.loader
        return loader.batch_invert([r.xi for r in self.rounds])


def h_eval(xi, z):
    """prod_i (1 + xi_{k-1-i} z^(2^i)) (pcs/ipa.rs:388-399)."""
    loader = z.loader
    one = loader.load_one()
    factors = []
    acc = z
    for x in reversed(xi):
        factors.append(acc * x + one)
        acc = acc * acc
    return loader.product(factors)


def h_coeffs(xi_values, scalar: int, r: int = R) -> list:
    """Expand prod (1 + xi_{k-1-i} X^(2^i)) (pcs/ipa.rs:401-417); ints."""
    assert xi_values
    coeffs = [0] * (1 << len(xi_values))
    coeffs[0] = scalar % r
    length = 1
    for x in reversed(xi_values):
        for i in range(length):
            coeffs[length + i] = coeffs[i] * x % r
        length *= 2
    return coeffs


class Ipa:
    @staticmethod
    def create_proof(pk: IpaProvingKey, p, z: int, omega: Optional[int], transcript, rng=None):
        """Prover (pcs/ipa.rs:40-123); p = coefficient list, host ints."""
        rng = rng or random.Random(1)
        loader = transcript.loader()
        crv = pk.curve
        r = crv.R
        p_prime = [v % r for v in p] + [0] * (pk.domain.n - len(p))

        if pk.zk():
            p_bar = [rng.randrange(r) for _ in range(pk.domain.n)]
            p_bar_at_z = _eval(p_bar, z, r)
            p_bar[0] = (p_bar[0] - p_bar_at_z) % r
            omega_bar = rng.randrange(r)
            c_bar = pk.commit(p_bar, omega_bar)
            transcript.write_ec_point(EcPoint(loader, c_bar))
            alpha = transcript.squeeze_challenge().value
            omega_prime = (omega + alpha * omega_bar) % r
            transcript.write_scalar(loader.load_const(omega_prime))
            p_prime = [(a + alpha * b) % r for a, b in zip(p_prime, p_bar)]

        xi_0 = transcript.squeeze_challenge().value
        u, c, xi = Ipa._rounds(pk, p_prime, z, xi_0, transcript)
        transcript.write_ec_point(EcPoint(loader, u))
        transcript.write_scalar(loader.load_const(c))
        native = NativeLoader(crv)
        return IpaAccumulator(
            [native.load_const(x) for x in xi], EcPoint(native, u)
        )

    @staticmethod
    def _rounds(pk, p_prime, z, xi_0, transcript):
        """The k fold rounds shared by both wire layouts; returns
        (G_final, c_final, [xi])."""
        crv = pk.curve
        r = crv.R
        loader = transcript.loader()
        h_prime = crv.g1_mul(pk.h, xi_0)
        bases = list(pk.g)
        coeffs = list(p_prime)
        zs = []
        acc = 1
        for _ in range(len(coeffs)):
            zs.append(acc)
            acc = acc * z % r

        k = pk.domain.k
        xi = []
        for i in range(k):
            half = 1 << (k - i - 1)
            l_i = crv.g1_add(
                crv.fast_msm(coeffs[half:], bases[:half]),
                crv.g1_mul(h_prime, _inner(coeffs[half:], zs[:half], r)),
            )
            r_i = crv.g1_add(
                crv.fast_msm(coeffs[:half], bases[half:]),
                crv.g1_mul(h_prime, _inner(coeffs[:half], zs[half:], r)),
            )
            transcript.write_ec_point(EcPoint(loader, l_i))
            transcript.write_ec_point(EcPoint(loader, r_i))
            xi_i = transcript.squeeze_challenge().value
            xi_i_inv = crv.inv_mod(xi_i, r)

            bases = [
                crv.g1_add(bl, crv.g1_mul(br, xi_i))
                for bl, br in zip(bases[:half], bases[half:])
            ]
            coeffs = [
                (cl + xi_i_inv * cr) % r for cl, cr in zip(coeffs[:half], coeffs[half:])
            ]
            zs = [(zl + xi_i * zr) % r for zl, zr in zip(zs[:half], zs[half:])]
            xi.append(xi_i)
        return bases[0], coeffs[0], xi

    @staticmethod
    def create_proof_halo2(pk, p, z: int, transcript, rng=None):
        """Prover for halo2_proofs' IPA wire layout — the one
        Bgh19.read_proof consumes (bgh19.rs:121-158): S, xi, z-challenge,
        rounds, c, blind, G.  Requires a zk key (svk.s is the blinding base
        W); input polynomial commitments are expected unblinded (blind 0),
        so the final blind is xi * omega_bar only."""
        assert pk.zk(), "halo2 IPA layout requires a zk key (blinding base)"
        rng = rng or random.Random(1)
        loader = transcript.loader()
        crv = pk.curve
        r = crv.R
        p_prime = [v % r for v in p] + [0] * (pk.domain.n - len(p))

        # random s_poly with s(z) = 0, so folding preserves the claimed eval
        s_poly = [rng.randrange(r) for _ in range(pk.domain.n)]
        s_poly[0] = (s_poly[0] - _eval(s_poly, z, r)) % r
        omega_bar = rng.randrange(r)
        transcript.write_ec_point(EcPoint(loader, pk.commit(s_poly, omega_bar)))
        alpha = transcript.squeeze_challenge().value  # halo2's xi
        omega_prime = alpha * omega_bar % r
        p_prime = [(a + alpha * b) % r for a, b in zip(p_prime, s_poly)]

        xi_0 = transcript.squeeze_challenge().value  # halo2's z challenge
        u, c, xi = Ipa._rounds(pk, p_prime, z, xi_0, transcript)
        transcript.write_scalar(loader.load_const(c))
        transcript.write_scalar(loader.load_const(omega_prime))
        transcript.write_ec_point(EcPoint(loader, u))
        native = NativeLoader(crv)
        return IpaAccumulator(
            [native.load_const(x) for x in xi], EcPoint(native, u)
        )

    @staticmethod
    def read_proof(svk, transcript) -> IpaProof:
        return IpaProof.read(svk, transcript)

    @staticmethod
    def succinct_verify(svk, commitment: Msm, z, eval_, proof: IpaProof) -> IpaAccumulator:
        """C_k == c[U] + v'[H'] (pcs/ipa.rs:137-183), loader-generic."""
        loader = z.loader
        h = Msm.base(loader.ec_point_load_const(svk.h))
        h_prime = h * proof.xi_0

        if svk.zk():
            s = Msm.base(loader.ec_point_load_const(svk.s))
            c_bar, alpha = proof.c_bar_alpha
            c_prime = commitment + Msm.base(c_bar) * alpha - s * proof.omega_prime
        else:
            c_prime = commitment

        c_0 = c_prime + h_prime * eval_
        c_k = c_0
        for rnd, xi_inv in zip(proof.rounds, proof.xi_inv()):
            c_k = c_k + Msm.base(rnd.l) * xi_inv + Msm.base(rnd.r) * rnd.xi
        lhs = c_k.evaluate(None)

        v_prime = h_eval(proof.xi(), z) * proof.c
        rhs = (Msm.base(proof.u) * proof.c + h_prime * v_prime).evaluate(None)

        loader.ec_point_assert_eq("C_k == c[U] + v'[H']", lhs, rhs)
        return IpaAccumulator(proof.xi(), proof.u)


def _eval(coeffs, x, r: int = R):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % r
    return acc


def _inner(a, b, r: int = R):
    return sum(x * y for x, y in zip(a, b)) % r


# ---------------------------------------------------------------------------
# Accumulation scheme (pcs/ipa/accumulation.rs)
# ---------------------------------------------------------------------------


@dataclass
class IpaAsProof:
    a_b_u: Optional[tuple]
    omega: Optional[object]
    alpha: object
    z: object
    ipa: IpaProof


class IpaAs:
    @staticmethod
    def as_read_proof(vk: IpaSuccinctVerifyingKey, instances, transcript) -> IpaAsProof:
        assert len(instances) > 1
        a_b_u = None
        omega = None
        if vk.zk():
            a = transcript.read_scalar()
            b = transcript.read_scalar()
            u = transcript.read_ec_point()
            a_b_u = (a, b, u)
            omega = transcript.read_scalar()
        for acc in instances:
            for xi in acc.xi:
                transcript.common_scalar(xi)
            transcript.common_ec_point(acc.u)
        alpha = transcript.squeeze_challenge()
        z = transcript.squeeze_challenge()
        ipa = IpaProof.read(vk, transcript)
        return IpaAsProof(a_b_u, omega, alpha, z, ipa)

    @staticmethod
    def as_verify(vk, instances, proof: IpaAsProof) -> IpaAccumulator:
        loader = proof.z.loader
        us = [acc.u for acc in instances]
        hs = [h_eval(acc.xi, proof.z) for acc in instances]
        if proof.a_b_u is not None:
            a, b, u = proof.a_b_u
            us.append(u)
            hs.append(a * proof.z + b)
        powers_of_alpha = proof.alpha.powers(len(us))

        c = Msm.sum([Msm.base(u) * pa for u, pa in zip(us, powers_of_alpha)])
        if proof.omega is not None:
            s = loader.ec_point_load_const(vk.s)
            c = c + Msm.base(s) * proof.omega
        v = loader.sum_products(list(zip(powers_of_alpha, hs)))
        return Ipa.succinct_verify(vk, c, proof.z, v, proof.ipa)

    @staticmethod
    def create_proof(pk: IpaProvingKey, instances, transcript, rng=None):
        """Native fold + fresh IPA proof (accumulation.rs:156-220)."""
        assert len(instances) > 1
        rng = rng or random.Random(2)
        loader = transcript.loader()
        crv = pk.curve
        r = crv.R
        a_b_u = None
        omega = None
        if pk.zk():
            a, b = rng.randrange(r), rng.randrange(r)
            u = crv.g1_add(crv.g1_mul(pk.g[1], a), crv.g1_mul(pk.g[0], b))
            transcript.write_scalar(loader.load_const(a))
            transcript.write_scalar(loader.load_const(b))
            transcript.write_ec_point(EcPoint(loader, u))
            a_b_u = (a, b, u)
            omega = rng.randrange(r)
            transcript.write_scalar(loader.load_const(omega))
        for acc in instances:
            for xi in acc.xi:
                transcript.common_scalar(xi)
            transcript.common_ec_point(acc.u)
        alpha = transcript.squeeze_challenge().value
        z = transcript.squeeze_challenge().value

        hs = [h_coeffs([x.value for x in acc.xi], 1, r) for acc in instances]
        if a_b_u is not None:
            a, b, u = a_b_u
            hs.append([b, a] + [0] * (pk.domain.n - 2))
        h = [0] * pk.domain.n
        pa = 1
        for hc in hs:
            for i, v in enumerate(hc):
                h[i] = (h[i] + pa * v) % r
            pa = pa * alpha % r
        return Ipa.create_proof(pk, h, z, omega, transcript, rng)

    # -- decider (pcs/ipa/decider.rs) ----------------------------------------
    @staticmethod
    def decide(dk: IpaDecidingKey, accumulator: IpaAccumulator):
        loader = accumulator.u.loader
        if hasattr(loader, "decide_ipa"):
            return loader.decide_ipa(accumulator, dk)
        crv = dk.svk.curve
        h = h_coeffs([x.value for x in accumulator.xi], 1, crv.R)
        expect = crv.fast_msm(h, dk.g)
        if accumulator.u.value != expect:
            raise AssertionFailure("U == commit(G, h)")
        return True

    @staticmethod
    def decide_all(dk, accumulators):
        for acc in accumulators:
            IpaAs.decide(dk, acc)
        return True
