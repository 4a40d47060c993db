"""BDFG21 (SHPLONK) multi-open KZG verifier.

Algorithmic parity with pcs/kzg/multiopen/bdfg21.rs:51-371: polynomials are
grouped by their *shift set*; per set, barycentric eval-coefficients at z'
are formed as deferred fractions, inverted in two lazy batch-inversion
phases, and the folded claim is
  lhs = sum_i gamma^i msm_i - z_s(z') W + z' W',   rhs = W'.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from snark_verifier_tpu_torch.pcs import PolynomialCommitmentScheme
from snark_verifier_tpu_torch.pcs.kzg.accumulator import KzgAccumulator
from snark_verifier_tpu_torch.util import bn254
from snark_verifier_tpu_torch.util.fraction import Fraction, batch_invert_fractions
from snark_verifier_tpu_torch.util.msm_symbolic import Msm


@dataclass
class Bdfg21Proof:
    mu: object
    gamma: object
    w: object
    z_prime: object
    w_prime: object


class Bdfg21(PolynomialCommitmentScheme):
    @classmethod
    def read_proof(cls, svk, queries, transcript) -> Bdfg21Proof:
        mu = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()
        w = transcript.read_ec_point()
        z_prime = transcript.squeeze_challenge()
        w_prime = transcript.read_ec_point()
        return Bdfg21Proof(mu, gamma, w, z_prime, w_prime)

    @classmethod
    def verify(cls, svk, commitments, z, queries, proof: Bdfg21Proof) -> KzgAccumulator:
        sets = _query_sets(queries)
        coeffs = _query_set_coeffs(sets, z, proof.z_prime)

        powers_of_mu = proof.mu.powers(max(len(s.polys) for s in sets))
        msms = [
            s.msm(coeff, commitments, powers_of_mu) for s, coeff in zip(sets, coeffs)
        ]
        f = Msm()
        for msm, power_of_gamma in zip(msms, proof.gamma.powers(len(sets))):
            f = f + msm * power_of_gamma
        f = f - Msm.base(proof.w) * coeffs[0].z_s

        rhs = Msm.base(proof.w_prime)
        lhs = f + rhs * proof.z_prime

        return KzgAccumulator(lhs.evaluate(svk), rhs.evaluate(svk))


@dataclass
class _QuerySet:
    shifts: list  # host ints
    polys: list
    evals: list  # list of per-poly [Scalar] aligned with shifts

    def msm(self, coeff: "_QuerySetCoeff", commitments, powers_of_mu) -> Msm:
        loader = powers_of_mu[0].loader
        out = Msm()
        for poly, evals, power_of_mu in zip(self.polys, self.evals, powers_of_mu):
            if coeff.commitment_coeff is not None:
                commitment = commitments[poly] * coeff.commitment_coeff.evaluated()
            else:
                commitment = commitments[poly]
            r_eval = loader.sum_products(
                [(c.evaluated(), e) for c, e in zip(coeff.eval_coeffs, evals)]
            ) * coeff.r_eval_coeff.evaluated()
            out = out + (commitment - Msm.constant_term(r_eval)) * power_of_mu
        return out


def _query_sets(queries):
    """Group polys by their shift-set (bdfg21.rs:121-171)."""
    # per-poly (shifts, evals) in first-seen order
    poly_shifts = []
    for q in queries:
        for entry in poly_shifts:
            if entry[0] == q.poly:
                if q.shift not in entry[1]:
                    entry[1].append(q.shift)
                    entry[2].append(q.eval)
                break
        else:
            poly_shifts.append((q.poly, [q.shift], [q.eval]))

    sets = []
    for poly, shifts, evals in poly_shifts:
        for s in sets:
            if set(s.shifts) == set(shifts):
                if poly not in s.polys:
                    s.polys.append(poly)
                    # align evals with the set's canonical shift order
                    s.evals.append([evals[shifts.index(sh)] for sh in s.shifts])
                break
        else:
            sets.append(_QuerySet(shifts, [poly], [evals]))
    return sets


@dataclass
class _QuerySetCoeff:
    z_s: object
    eval_coeffs: list  # [Fraction]
    commitment_coeff: Optional[Fraction]
    r_eval_coeff: Optional[Fraction]


def _query_set_coeffs(sets, z, z_prime):
    """Barycentric coefficients with two-phase lazy batch inversion
    (bdfg21.rs:173-371)."""
    loader = z.loader

    superset = sorted({sh for s in sets for sh in s.shifts})
    size = max(max(len(s.shifts) for s in sets), 2)
    powers_of_z = z.powers(size)
    z_prime_minus_z_shift_i = {
        shift: z_prime - z * loader.load_const(shift) for shift in superset
    }

    z_s_1 = None
    coeffs = []
    for s in sets:
        coeff = _new_coeff(
            loader, s.shifts, powers_of_z, z_prime, z_prime_minus_z_shift_i, z_s_1
        )
        if z_s_1 is None:
            z_s_1 = coeff.z_s
        coeffs.append(coeff)

    # phase 1: invert barycentric-weight and commitment-coefficient denoms
    batch_invert_fractions(
        loader,
        [f for c in coeffs for f in c.eval_coeffs]
        + [c.commitment_coeff for c in coeffs if c.commitment_coeff is not None],
    )
    # phase 2: evaluate them, form r_eval denominators, invert those
    for c in coeffs:
        for f in c.eval_coeffs:
            f.evaluate()
        if c.commitment_coeff is not None:
            c.commitment_coeff.evaluate()
        weights_sum = loader.sum([f.evaluated() for f in c.eval_coeffs])
        if c.commitment_coeff is not None:
            c.r_eval_coeff = Fraction(c.commitment_coeff.evaluated(), weights_sum)
        else:
            c.r_eval_coeff = Fraction.one_over(weights_sum)
    batch_invert_fractions(loader, [c.r_eval_coeff for c in coeffs])
    for c in coeffs:
        c.r_eval_coeff.evaluate()
    return coeffs


def _new_coeff(loader, shifts, powers_of_z, z_prime, z_prime_minus_z_shift_i, z_s_1):
    """bdfg21.rs:280-333."""
    normalized_ell_primes = []
    for j, shift_j in enumerate(shifts):
        acc = 1
        for i, shift_i in enumerate(shifts):
            if i != j:
                acc = acc * (shift_j - shift_i) % bn254.R
        normalized_ell_primes.append(acc)

    z_pow_k_minus_one = powers_of_z[len(shifts) - 1]
    zv = powers_of_z[1]

    barycentric_weights = [
        Fraction.one_over(
            loader.sum_products_with_coeff(
                [
                    (ell, z_pow_k_minus_one, z_prime),
                    ((-(ell * shift)) % bn254.R, z_pow_k_minus_one, zv),
                ]
            )
        )
        for shift, ell in zip(shifts, normalized_ell_primes)
    ]

    z_s = loader.product([z_prime_minus_z_shift_i[shift] for shift in shifts])
    commitment_coeff = Fraction(z_s_1, z_s) if z_s_1 is not None else None

    return _QuerySetCoeff(z_s, barycentric_weights, commitment_coeff, None)
