"""Verifier layer (parity: verifier.rs:13-44)."""

from __future__ import annotations


class SnarkVerifier:
    """2-phase API: read_proof (transcript -> structured proof), then verify."""

    def read_proof(self, vk, protocol, instances, transcript):
        raise NotImplementedError

    def verify(self, vk, protocol, instances, proof):
        raise NotImplementedError
