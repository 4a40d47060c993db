"""GWC19 multi-open KZG verifier (halo2's default multiopen).

Algorithmic parity with pcs/kzg/multiopen/gwc19.rs:45-160: queries are
grouped into per-shift sets; each set's claims fold with powers of v; sets
fold with powers of u; one witness commitment W per set; the accumulator is
  lhs = f + sum_i u^i z_i W_i,   rhs = sum_i u^i W_i.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference.pcs import PolynomialCommitmentScheme
from benchmark.reference.pcs.kzg.accumulator import KzgAccumulator
from benchmark.reference.util.msm_symbolic import Msm


@dataclass
class Gwc19Proof:
    v: object
    ws: list
    u: object


class Gwc19(PolynomialCommitmentScheme):
    @classmethod
    def read_proof(cls, svk, queries, transcript) -> Gwc19Proof:
        v = transcript.squeeze_challenge()
        ws = transcript.read_n_ec_points(len(_query_sets(queries)))
        u = transcript.squeeze_challenge()
        return Gwc19Proof(v, ws, u)

    @classmethod
    def verify(cls, svk, commitments, z, queries, proof: Gwc19Proof) -> KzgAccumulator:
        loader = z.loader
        sets = _query_sets(queries)
        powers_of_u = proof.u.powers(len(sets))
        powers_of_v = proof.v.powers(max(len(s.polys) for s in sets))

        f = Msm()
        for qset, power_of_u in zip(sets, powers_of_u):
            msm = Msm()
            for (poly, eval_), power_of_v in zip(
                zip(qset.polys, qset.evals), powers_of_v
            ):
                term = commitments[poly] - Msm.constant_term(eval_)
                msm = msm + term * power_of_v
            f = f + msm * power_of_u

        rhs_msms = [
            Msm.base(w) * power_of_u for w, power_of_u in zip(proof.ws, powers_of_u)
        ]
        lhs = f
        for rhs_msm, qset in zip(rhs_msms, sets):
            z_omega = loader.load_const(qset.shift) * z
            lhs = lhs + rhs_msm * z_omega

        return KzgAccumulator(
            lhs.evaluate(svk), Msm.sum(rhs_msms).evaluate(svk)
        )


@dataclass
class _QuerySet:
    shift: int
    polys: list
    evals: list


def _query_sets(queries):
    """Group queries by shift, preserving first-seen order (gwc19.rs:142-160)."""
    sets = []
    for q in queries:
        for s in sets:
            if s.shift == q.shift:
                s.polys.append(q.poly)
                s.evals.append(q.eval)
                break
        else:
            sets.append(_QuerySet(q.shift, [q.poly], [q.eval]))
    return sets
