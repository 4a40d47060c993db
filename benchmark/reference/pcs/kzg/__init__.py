"""KZG polynomial commitment scheme with accumulation.

Scheme alias (SDK parity, snark-verifier-sdk/src/lib.rs:33-45):
  `KzgGwc` = KzgAs<Bn256, Gwc19>
"""

from benchmark.reference.pcs.kzg.accumulator import KzgAccumulator, LimbsEncoding
from benchmark.reference.pcs.kzg.accumulation import KzgAs, KzgAsVerifyingKey
from benchmark.reference.pcs.kzg.decider import KzgDecidingKey, KzgSuccinctVerifyingKey
from benchmark.reference.pcs.kzg.gwc19 import Gwc19


class KzgGwc(KzgAs):
    """KZG with the GWC19 multiopen (halo2's default)."""

    mos = Gwc19


__all__ = [
    "KzgAccumulator",
    "LimbsEncoding",
    "KzgAs",
    "KzgAsVerifyingKey",
    "KzgDecidingKey",
    "KzgSuccinctVerifyingKey",
    "Gwc19",
    "KzgGwc",
]
