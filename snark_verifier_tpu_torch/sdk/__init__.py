"""SDK layer of the port: the aggregation pre-pass (``sdk/aggregation.py``, a
copy of the JAX package's) and the ``Snark`` it takes.

The JAX package's ``sdk/__init__.py`` imports its prover (``gen_snark``,
``gen_proof``); the port verifies and proves nothing here, so it keeps only
the (protocol, instances, proof) container (snark-verifier-sdk lib.rs:49-67).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Snark:
    """(protocol, instances, proof) container (sdk lib.rs:49-67)."""

    protocol: object
    instances: list  # [[int]]
    proof: bytes


__all__ = ["Snark"]
