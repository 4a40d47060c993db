"""KZG accumulation scheme: fold many accumulators into one with powers of a
transcript challenge (parity: pcs/kzg/accumulation.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from benchmark.reference.pcs import PolynomialCommitmentScheme, AccumulationScheme
from benchmark.reference.pcs.kzg.accumulator import KzgAccumulator
from benchmark.reference.util.msm_symbolic import Msm


@dataclass
class KzgAsVerifyingKey:
    zk_: bool = False

    def zk(self) -> bool:
        return self.zk_


@dataclass
class KzgAsProof:
    blind: Optional[tuple]  # (EcPoint, EcPoint) | None
    r: object  # Scalar


class KzgAs(PolynomialCommitmentScheme, AccumulationScheme):
    """Both the PCS (delegating multiopen verification to `mos`) and the
    accumulation scheme over KzgAccumulators (accumulation.rs:19-64)."""

    mos = None  # subclass provides Gwc19 / Bdfg21

    # -- PCS interface ------------------------------------------------------
    @classmethod
    def read_proof(cls, svk, queries, transcript):
        return cls.mos.read_proof(svk, queries, transcript)

    @classmethod
    def verify(cls, svk, commitments, z, queries, proof):
        return cls.mos.verify(svk, commitments, z, queries, proof)

    # -- accumulation-scheme interface (accumulation.rs:30-63) --------------
    @classmethod
    def as_read_proof(cls, vk: KzgAsVerifyingKey, instances, transcript) -> KzgAsProof:
        assert instances
        for acc in instances:
            transcript.common_ec_point(acc.lhs)
            transcript.common_ec_point(acc.rhs)
        blind = None
        if vk.zk():
            blind = (transcript.read_ec_point(), transcript.read_ec_point())
        r = transcript.squeeze_challenge()
        return KzgAsProof(blind, r)

    @classmethod
    def as_verify(cls, vk, instances, proof: KzgAsProof) -> KzgAccumulator:
        pairs = [(acc.lhs, acc.rhs) for acc in instances]
        if proof.blind is not None:
            pairs.append(proof.blind)
        powers_of_r = proof.r.powers(len(pairs))
        lhs = Msm.sum(
            [Msm.base(l) * r for (l, _), r in zip(pairs, powers_of_r)]
        ).evaluate(None)
        rhs = Msm.sum(
            [Msm.base(rh) * r for (_, rh), r in zip(pairs, powers_of_r)]
        ).evaluate(None)
        return KzgAccumulator(lhs, rhs)

    # -- decider (pcs/kzg/decider.rs) ---------------------------------------
    @classmethod
    def decide(cls, dk, accumulator: KzgAccumulator):
        from benchmark.reference.pcs.kzg.decider import decide as _decide

        return _decide(dk, accumulator)

    @classmethod
    def decide_all(cls, dk, accumulators):
        from benchmark.reference.pcs.kzg.decider import decide_all as _decide_all

        return _decide_all(dk, accumulators)
