"""The plain reference of the PLONK cells: the python-int succinct verifier
(a frozen copy of the repository's host verifier, in this package) and the
host pairing, over the inputs the benchmark reads from its own data file.

Nothing here imports torch, JAX or the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference.loader.native import NativeLoader
from benchmark.reference.pcs.kzg import KzgGwc
from benchmark.reference.system.halo2.transcript import NativeEvmTranscript, NativePoseidonTranscript
from benchmark.reference.util import bn254
from benchmark.reference.verifier.plonk import PlonkSuccinctVerifier
from benchmark.reference.verifier.plonk.serialization import protocol_from_json

TRANSCRIPTS = {"evm": NativeEvmTranscript, "poseidon": NativePoseidonTranscript}


def point(obj):
    """A JSON point of hex strings (nested lists) -> a tuple of ints."""
    return tuple(point(v) for v in obj) if isinstance(obj, list) else int(obj, 16)


@dataclass(frozen=True)
class Circuit:
    protocol: object
    svk: tuple
    g2: tuple
    s_g2: tuple
    transcript: str


def load_circuit(data: dict, transcript: str) -> Circuit:
    """The circuit and its deciding key from the data file's dict."""
    return Circuit(protocol_from_json(data["protocol"]), point(data["svk"]), point(data["g2"]), point(data["s_g2"]),
                   transcript)


def succinct(circuit: Circuit, proof: bytes, instances, transcripts=TRANSCRIPTS) -> tuple[bool, tuple | None, tuple | None]:
    """(ok, lhs, rhs): the succinct verify of one proof; ``ok`` False, and no
    accumulator, when the proof cannot be read or a check fails."""
    loader = NativeLoader()
    verifier = PlonkSuccinctVerifier(KzgGwc)
    try:
        loaded = circuit.protocol.loaded(loader)
        ins = [[loader.load_const(v) for v in col] for col in instances]
        transcript = transcripts[circuit.transcript](proof, loader)
        parsed = verifier.read_proof(circuit.svk, loaded, ins, transcript)
        (acc,) = verifier.verify(circuit.svk, loaded, ins, parsed)
    except Exception:  # every failure of the python-int verifier is a rejection
        return False, None, None
    return True, acc.lhs.value, acc.rhs.value


def pairing_value(circuit: Circuit, lhs, rhs):
    """e(lhs, g2) e(rhs, -s g2) in Fq12: one when the accumulator decides
    True."""
    return bn254.final_exponentiation(bn254.multi_miller_loop([(lhs, circuit.g2), (rhs, bn254.g2_neg(circuit.s_g2))]))


def fold_verdict(values: dict, scalars: dict) -> bool:
    """The batch decide of a fold: sum_i s_i (lhs_i, rhs_i) decides True iff
    prod_i e_i^(s_i) == 1, by bilinearity, where e_i is the pairing value of
    accumulator i.  ``values`` and ``scalars`` are keyed alike; accumulators
    that repeat in a batch come once, with their scalars summed mod r."""
    acc = bn254.FQ12_ONE
    for key, s in scalars.items():
        s %= bn254.R
        if s and values[key] != bn254.FQ12_ONE:
            acc = bn254.fq12_mul(acc, bn254.fq12_pow(values[key], s))
    return acc == bn254.FQ12_ONE
