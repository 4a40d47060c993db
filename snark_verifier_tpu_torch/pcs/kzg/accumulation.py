"""KZG accumulation scheme: fold many accumulators into one with powers of a
transcript challenge (parity: pcs/kzg/accumulation.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from snark_verifier_tpu_torch.pcs import PolynomialCommitmentScheme, AccumulationScheme
from snark_verifier_tpu_torch.pcs.kzg.accumulator import KzgAccumulator
from snark_verifier_tpu_torch.util import bn254
from snark_verifier_tpu_torch.util.msm_symbolic import Msm


@dataclass
class KzgAsProvingKey:
    """Optional (g, s_g) pair enables ZK blinding (accumulation.rs:68-85)."""

    g_pair: Optional[tuple] = None  # ((x,y), (x,y)) = (g, s*g)

    def zk(self) -> bool:
        return self.g_pair is not None

    def vk(self) -> "KzgAsVerifyingKey":
        return KzgAsVerifyingKey(self.zk())


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

    # -- accumulation-scheme prover (accumulation.rs:148-197, native only) --
    @classmethod
    def create_proof(cls, pk: KzgAsProvingKey, instances, transcript, rng=None) -> KzgAccumulator:
        assert instances
        loader = instances[0].lhs.loader
        for acc in instances:
            transcript.common_ec_point(acc.lhs)
            transcript.common_ec_point(acc.rhs)
        blind = None
        if pk.zk():
            import random

            rng = rng or random.Random()
            s = rng.randrange(bn254.R)
            g, s_g = pk.g_pair
            from snark_verifier_tpu_torch.loader import EcPoint

            lhs_b = EcPoint(loader, bn254.g1_mul(s_g, s))
            rhs_b = EcPoint(loader, bn254.g1_mul(g, s))
            transcript.write_ec_point(lhs_b)
            transcript.write_ec_point(rhs_b)
            blind = (lhs_b, rhs_b)
        r = transcript.squeeze_challenge()
        pairs = [(acc.lhs, acc.rhs) for acc in instances]
        if blind is not None:
            pairs.append(blind)
        powers_of_r = r.powers(len(pairs))
        lhs = Msm.sum(
            [Msm.base(l) * rr for (l, _), rr in zip(pairs, powers_of_r)]
        ).evaluate(None)
        rhs = Msm.sum(
            [Msm.base(rh) * rr for (_, rh), rr in zip(pairs, powers_of_r)]
        ).evaluate(None)
        return KzgAccumulator(lhs, rhs)

    # -- decider (pcs/kzg/decider.rs) ---------------------------------------
    @classmethod
    def decide(cls, dk, accumulator: KzgAccumulator):
        from snark_verifier_tpu_torch.pcs.kzg.decider import decide as _decide

        return _decide(dk, accumulator)

    @classmethod
    def decide_all(cls, dk, accumulators):
        from snark_verifier_tpu_torch.pcs.kzg.decider import decide_all as _decide_all

        return _decide_all(dk, accumulators)
