"""BGH19 multi-open for IPA (halo2's IPA multiopen): verifier + prover.

Algorithmic parity with pcs/ipa/multiopen/bgh19.rs: polynomials group by
shift-set (same grouping as BDFG21), per-set claims fold with powers of x1,
sets fold with powers of x2/x4 around the f commitment, and the final check
is one IPA `succinct_verify` of the combined claim at x3 with evaluation 0.

`Bgh19.create_proof` plays the role of halo2's IPA multiopen prover
(halo2_proofs poly/ipa/multiopen — not part of the reference crate, which
consumes halo2's): per set, q_i folds the polys with x1, f sums
(q_i - r_i) / prod(X - z_j) folded with x2, and the x4-folded final claim
opens through `Ipa.create_proof` at x3 with value 0.  Exercised end-to-end
over BOTH BN254 and pallas (the reference's curve,
system/halo2/test/ipa/native.rs) in tests/test_bgh19.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from snark_verifier_tpu_torch.pcs import PolynomialCommitmentScheme
from snark_verifier_tpu_torch.pcs.ipa import Ipa, IpaAccumulator, IpaProof, Round
from snark_verifier_tpu_torch.util import bn254
from snark_verifier_tpu_torch.util.fraction import Fraction, batch_invert_fractions
from snark_verifier_tpu_torch.util.msm_symbolic import Msm


@dataclass
class Bgh19Proof:
    x_1: object
    x_2: object
    f: object
    x_3: object
    q_evals: list
    x_4: object
    ipa: IpaProof


class Bgh19(PolynomialCommitmentScheme):
    @classmethod
    def read_proof(cls, svk, queries, transcript) -> Bgh19Proof:
        """bgh19.rs:121-158 (note the halo2-IPA tail layout: c and blind
        precede the final g)."""
        x_1 = transcript.squeeze_challenge()
        x_2 = transcript.squeeze_challenge()
        f = transcript.read_ec_point()
        x_3 = transcript.squeeze_challenge()
        q_evals = transcript.read_n_scalars(len(_query_sets(queries)))
        x_4 = transcript.squeeze_challenge()

        s = transcript.read_ec_point()
        xi = transcript.squeeze_challenge()
        z = transcript.squeeze_challenge()
        rounds = [
            Round(
                transcript.read_ec_point(),
                transcript.read_ec_point(),
                transcript.squeeze_challenge(),
            )
            for _ in range(svk.domain.k)
        ]
        c = transcript.read_scalar()
        blind = transcript.read_scalar()
        g = transcript.read_ec_point()
        ipa = IpaProof(
            c_bar_alpha=(s, xi), omega_prime=blind, xi_0=z, rounds=rounds, u=g, c=c
        )
        return Bgh19Proof(x_1, x_2, f, x_3, q_evals, x_4, ipa)

    @classmethod
    def verify(cls, svk, commitments, x, queries, proof: Bgh19Proof) -> IpaAccumulator:
        loader = x.loader
        g = loader.ec_point_load_const(svk.g)

        sets = _query_sets(queries)
        coeffs = _query_set_coeffs(sets, x, proof.x_3)

        powers_of_x_1 = proof.x_1.powers(max(len(s.polys) for s in sets))
        powers_of_x_2 = proof.x_2.powers(len(sets))
        f_evals = [
            s.f_eval(coeff, q_eval, powers_of_x_1)
            for s, coeff, q_eval in zip(sets, coeffs, proof.q_evals)
        ]
        f_eval = loader.sum_products(
            list(zip(powers_of_x_2, reversed(f_evals)))
        )

        msms = [
            s.msm(commitments, q_eval, powers_of_x_1)
            for s, q_eval in zip(sets, proof.q_evals)
        ]
        terms = [Msm.base(proof.f) - Msm.constant_term(f_eval)] + msms
        powers_of_x_4 = proof.x_4.powers(len(sets) + 1)
        folded = Msm.sum(
            [m * p4 for m, p4 in zip(terms, reversed(powers_of_x_4))]
        )
        msm, constant = folded.split()
        if constant is not None:
            msm = msm + Msm.base(g) * constant

        return Ipa.succinct_verify(svk, msm, proof.x_3, loader.load_zero(), proof.ipa)

    # -- prover --------------------------------------------------------------
    @classmethod
    def create_proof(cls, pk, polys, query_specs, x: int, transcript, rng=None):
        """polys: list of coefficient lists (host ints); query_specs:
        [(poly_idx, shift_int)]; x: base opening point.  The caller must
        have absorbed commitments/evals into the transcript exactly as the
        verifier does, so the squeezed challenges agree.  zk=False opening
        (pk.s unused)."""
        from snark_verifier_tpu_torch.loader import EcPoint
        from snark_verifier_tpu_torch.pcs import Query

        crv = pk.curve
        r = crv.R
        n = pk.domain.n
        loader = transcript.loader()

        sets = _query_sets([Query(p, sh) for p, sh in query_specs])

        x_1 = transcript.squeeze_challenge().value
        x_2 = transcript.squeeze_challenge().value

        def peval(c, z):
            acc = 0
            for v in reversed(c):
                acc = (acc * z + v) % r
            return acc

        # q_i = sum_j x1^(len-1-j) * poly_{set.polys[j]}  (verifier msm order)
        q_polys = []
        for s in sets:
            q = [0] * n
            for p_idx in s.polys:
                poly = polys[p_idx]
                q = [(qc * x_1 + (poly[i] if i < len(poly) else 0)) % r
                     for i, qc in enumerate(q)]
            q_polys.append(q)

        # f = sum_i x2^(S-1-i) * (q_i - r_i) / prod_j (X - shift_j * x)
        f_poly = [0] * n
        for s, q in zip(sets, q_polys):
            pts = [sh * x % r for sh in s.shifts]
            evs = [peval(q, z) for z in pts]
            r_poly = _interp(pts, evs, r)
            num = [(qc - (r_poly[i] if i < len(r_poly) else 0)) % r
                   for i, qc in enumerate(q)]
            for z in pts:
                num = _div_linear(num, z, r)
            f_poly = [(fc * x_2 + (num[i] if i < len(num) else 0)) % r
                      for i, fc in enumerate(f_poly)]

        transcript.write_ec_point(
            EcPoint(loader, pk.commit(f_poly, 0 if pk.zk() else None))
        )
        x_3 = transcript.squeeze_challenge().value
        q_evals = [peval(q, x_3) for q in q_polys]
        for v in q_evals:
            transcript.write_scalar(loader.load_const(v))
        x_4 = transcript.squeeze_challenge().value

        # final = x4^S * (f - f(x3)) + sum_i x4^(S-1-i) * (q_i - q_i(x3))
        final = list(f_poly)
        final[0] = (final[0] - peval(f_poly, x_3)) % r
        for q, qe in zip(q_polys, q_evals):
            term = list(q)
            term[0] = (term[0] - qe) % r
            final = [(fc * x_4 + tc) % r for fc, tc in zip(final, term)]
        # halo2 wire layout tail (S, xi, z, rounds, c, blind, G) — the one
        # read_proof consumes
        return Ipa.create_proof_halo2(pk, final, x_3, transcript, rng)


def _interp(pts, vals, r):
    """Lagrange interpolation, coefficient form mod r."""
    out = [0] * len(pts)
    for j, (zj, vj) in enumerate(zip(pts, vals)):
        basis = [1]
        denom = 1
        for i, zi in enumerate(pts):
            if i == j:
                continue
            basis = [
                ((basis[k - 1] if k else 0) - zi * (basis[k] if k < len(basis) else 0))
                % r
                for k in range(len(basis) + 1)
            ]
            denom = denom * (zj - zi) % r
        scale = vj * pow(denom, -1, r) % r
        for k, b in enumerate(basis):
            out[k] = (out[k] + scale * b) % r
    return out


def _div_linear(coeffs, z, r):
    """Exact division by (X - z), highest-degree first synthetic division."""
    out = [0] * (len(coeffs) - 1)
    carry = 0
    for i in range(len(coeffs) - 1, 0, -1):
        carry = (coeffs[i] + carry * z) % r
        out[i - 1] = carry
    assert (coeffs[0] + carry * z) % r == 0, "non-exact division"
    return out


@dataclass
class _QuerySet:
    shifts: list
    polys: list
    evals: list

    def msm(self, commitments, q_eval, powers_of_x_1) -> Msm:
        out = Msm.sum(
            [
                commitments[poly] * p1
                for poly, p1 in zip(reversed(self.polys), powers_of_x_1)
            ]
        )
        return out - Msm.constant_term(q_eval)

    def f_eval(self, coeff: "_QuerySetCoeff", q_eval, powers_of_x_1):
        loader = q_eval.loader
        r_evals = [
            loader.sum_products(
                [(c.evaluated(), e) for c, e in zip(coeff.eval_coeffs, evals)]
            )
            * coeff.r_eval_coeff.evaluated()
            for evals in self.evals
        ]
        r_eval = loader.sum_products(list(zip(reversed(r_evals), powers_of_x_1)))
        return (q_eval - r_eval) * coeff.f_eval_coeff.evaluated()


def _query_sets(queries):
    """Shift-set grouping, identical shape to bdfg21 (bgh19.rs:161-215)."""
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
                    s.evals.append([evals[shifts.index(sh)] for sh in s.shifts])
                break
        else:
            sets.append(_QuerySet(shifts, [poly], [evals]))
    return sets


@dataclass
class _QuerySetCoeff:
    eval_coeffs: list
    r_eval_coeff: Optional[Fraction]
    f_eval_coeff: Fraction


def _query_set_coeffs(sets, x, x_3):
    """Two-phase lazy batch inversion (bgh19.rs:217-250)."""
    loader = x.loader
    superset = sorted({sh for s in sets for sh in s.shifts})
    size = max(max(len(s.shifts) for s in sets), 2)
    powers_of_x = x.powers(size)
    x_3_minus_x_shift_i = {
        shift: x_3 - x * loader.load_const(shift) for shift in superset
    }

    coeffs = [
        _new_coeff(loader, s.shifts, powers_of_x, x_3, x_3_minus_x_shift_i)
        for s in sets
    ]
    batch_invert_fractions(
        loader,
        [f for c in coeffs for f in c.eval_coeffs] + [c.f_eval_coeff for c in coeffs],
    )
    for c in coeffs:
        for f in c.eval_coeffs:
            f.evaluate()
        c.f_eval_coeff.evaluate()
        weights_sum = loader.sum([f.evaluated() for f in c.eval_coeffs])
        c.r_eval_coeff = Fraction.one_over(weights_sum)
    batch_invert_fractions(loader, [c.r_eval_coeff for c in coeffs])
    for c in coeffs:
        c.r_eval_coeff.evaluate()
    return coeffs


def _new_coeff(loader, shifts, powers_of_x, x_3, x_3_minus_x_shift_i):
    r = loader.curve.R
    normalized_ell_primes = []
    for j, shift_j in enumerate(shifts):
        acc = 1
        for i, shift_i in enumerate(shifts):
            if i != j:
                acc = acc * (shift_j - shift_i) % r
        normalized_ell_primes.append(acc)

    xv = powers_of_x[1]
    x_pow_k_minus_one = powers_of_x[len(shifts) - 1]
    barycentric_weights = [
        Fraction.one_over(
            loader.sum_products_with_coeff(
                [
                    (ell, x_pow_k_minus_one, x_3),
                    ((-(ell * shift)) % r, x_pow_k_minus_one, xv),
                ]
            )
        )
        for shift, ell in zip(shifts, normalized_ell_primes)
    ]
    f_eval_coeff = Fraction.one_over(
        loader.product([x_3_minus_x_shift_i[shift] for shift in shifts])
    )
    return _QuerySetCoeff(barycentric_weights, None, f_eval_coeff)
