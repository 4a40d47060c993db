"""Polynomial-commitment-scheme layer: scheme-agnostic interfaces
(parity: pcs.rs:21-184)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Query:
    """An opening claim: polynomial `poly` evaluated at `shift * z`.

    `shift` is a host-side Fr int (omega^rotation); `eval` is a loaded
    scalar once attached (pcs.rs:21-48).
    """

    poly: int
    shift: int
    eval: Optional[object] = None

    def with_evaluation(self, eval_) -> "Query":
        return Query(self.poly, self.shift, eval_)


class PolynomialCommitmentScheme:
    """verify(svk, commitments, z, queries, proof) -> accumulator
    (pcs.rs:51-80)."""

    @classmethod
    def read_proof(cls, svk, queries, transcript):
        raise NotImplementedError

    @classmethod
    def verify(cls, svk, commitments, z, queries, proof):
        raise NotImplementedError


class AccumulationScheme:
    """Fold many accumulators into one (pcs.rs:83-112)."""

    @classmethod
    def read_proof(cls, vk, instances, transcript):
        raise NotImplementedError

    @classmethod
    def verify(cls, vk, instances, proof):
        raise NotImplementedError


class AccumulationDecider(AccumulationScheme):
    """Expensive final check (pcs.rs:118-135)."""

    @classmethod
    def decide(cls, dk, accumulator):
        raise NotImplementedError

    @classmethod
    def decide_all(cls, dk, accumulators):
        for acc in accumulators:
            cls.decide(dk, acc)


class AccumulatorEncoding:
    """Decode an accumulator from instance scalars (pcs.rs:160-184)."""

    @classmethod
    def from_repr(cls, scalars):
        raise NotImplementedError
