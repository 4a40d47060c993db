"""KZG polynomial commitment scheme with accumulation.

Scheme aliases (SDK parity, snark-verifier-sdk/src/lib.rs:33-45):
  `KzgGwc`     = KzgAs<Bn256, Gwc19>
  `KzgShplonk` = KzgAs<Bn256, Bdfg21>
"""

from snark_verifier_tpu_torch.pcs.kzg.accumulator import KzgAccumulator, LimbsEncoding
from snark_verifier_tpu_torch.pcs.kzg.accumulation import (
    KzgAs,
    KzgAsProvingKey,
    KzgAsVerifyingKey,
)
from snark_verifier_tpu_torch.pcs.kzg.decider import KzgDecidingKey, KzgSuccinctVerifyingKey
from snark_verifier_tpu_torch.pcs.kzg.gwc19 import Gwc19
from snark_verifier_tpu_torch.pcs.kzg.bdfg21 import Bdfg21


class KzgGwc(KzgAs):
    """KZG with the GWC19 multiopen (halo2's default)."""

    mos = Gwc19


class KzgShplonk(KzgAs):
    """KZG with the BDFG21 (SHPLONK) multiopen."""

    mos = Bdfg21


__all__ = [
    "KzgAccumulator",
    "LimbsEncoding",
    "KzgAs",
    "KzgAsProvingKey",
    "KzgAsVerifyingKey",
    "KzgDecidingKey",
    "KzgSuccinctVerifyingKey",
    "Gwc19",
    "Bdfg21",
    "KzgGwc",
    "KzgShplonk",
]
