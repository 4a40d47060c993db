"""KZG deciding key and the final pairing check
(parity: pcs/kzg/decider.rs:6-93)."""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference.errors import AssertionFailure
from benchmark.reference.util import bn254

# Succinct verifying key is just the G1 generator of the SRS.
KzgSuccinctVerifyingKey = tuple  # (x, y) affine ints


@dataclass
class KzgDecidingKey:
    """svk (g) + G2 generator + s*G2 (decider.rs:6-30)."""

    svk: tuple  # g1 affine ints
    g2: tuple  # ((x0,x1),(y0,y1)) Fq2 affine
    s_g2: tuple


def decide(dk: KzgDecidingKey, accumulator):
    """e(lhs, g2) * e(rhs, -s_g2) == 1 (decider.rs:70-82).

    Dispatches on the loader backend: the native loader checks with the
    python pairing oracle; the JAX loader runs the on-device Miller loop +
    final exponentiation and returns a traced boolean.
    """
    loader = accumulator.lhs.loader
    if hasattr(loader, "decide_pairing"):
        # device backend: returns traced bool (one per batch element)
        return loader.decide_pairing(accumulator, dk)
    lhs = accumulator.lhs.value
    rhs = accumulator.rhs.value
    ok = bn254.pairing_check([(lhs, dk.g2), (rhs, bn254.g2_neg(dk.s_g2))])
    if not ok:
        raise AssertionFailure("e(lhs, g2)·e(rhs, -s_g2) == O")
    return True


def decide_all(dk: KzgDecidingKey, accumulators):
    """decide() every accumulator (decider.rs:85-93).

    Codegen backends that can fold (EvmLoader) random-linear-combine the
    accumulators with a keccak challenge first so ONE ecPairing decides
    them all (decider.rs:146-185); native/JAX decide each individually.
    """
    if len(accumulators) > 1:
        loader = accumulators[0].lhs.loader
        if hasattr(loader, "fold_accumulators"):
            return decide(dk, loader.fold_accumulators(accumulators))
    results = [decide(dk, acc) for acc in accumulators]
    if all(isinstance(r, bool) for r in results):
        return True
    return results  # traced bools (JAX backend)
