"""PLONK verifiers (parity: verifier/plonk.rs:32-135).

`PlonkSuccinctVerifier` runs the cheap part and outputs accumulators;
`PlonkVerifier` additionally decides them (2 pairings).  Both are generic
over the accumulation scheme (KzgGwc / KzgShplonk) and the accumulator
encoding, and over the loader via the values they operate on.
"""

from __future__ import annotations

from benchmark.reference.pcs.kzg.accumulator import LimbsEncoding
from benchmark.reference.verifier import SnarkVerifier
from benchmark.reference.verifier.plonk.proof import (
    CommonPolynomialEvaluation,
    PlonkProof,
)
from benchmark.reference.verifier.plonk.protocol import PlonkProtocol

__all__ = [
    "PlonkProof",
    "PlonkProtocol",
    "PlonkSuccinctVerifier",
    "PlonkVerifier",
]


class PlonkSuccinctVerifier(SnarkVerifier):
    def __init__(self, As, Ae=LimbsEncoding):
        self.As = As
        self.Ae = Ae

    def read_proof(self, svk, protocol, instances, transcript) -> PlonkProof:
        return PlonkProof.read(self.As, self.Ae, svk, protocol, instances, transcript)

    def verify(self, svk, protocol, instances, proof: PlonkProof):
        """plonk.rs:58-92."""
        common_poly_eval = CommonPolynomialEvaluation(
            protocol.domain, protocol.langranges(), proof.z
        )
        evaluations = proof.evaluations_map(protocol, instances, common_poly_eval)
        commitments = proof.commitments(protocol, common_poly_eval, evaluations)
        queries = proof.queries(protocol, evaluations)

        accumulator = self.As.verify(svk, commitments, proof.z, queries, proof.pcs)
        return [accumulator] + list(proof.old_accumulators)


class PlonkVerifier(PlonkSuccinctVerifier):
    def verify(self, dk, protocol, instances, proof: PlonkProof):
        """Succinct verify + decide_all (plonk.rs:125-134).

        `dk` is a KzgDecidingKey; its `svk` feeds the succinct part.
        """
        accumulators = super().verify(dk.svk, protocol, instances, proof)
        return self.As.decide_all(dk, accumulators)

    def read_proof(self, dk, protocol, instances, transcript) -> PlonkProof:
        return super().read_proof(dk.svk, protocol, instances, transcript)
