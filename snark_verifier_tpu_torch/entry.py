"""Entry point of the port's main path: BASELINE config 1.

A batched succinct PLONK+KZG verify of the standard-plonk circuit at k = 8
with the Keccak (EVM) transcript, at 1820 proofs: 4 unique proofs tiled, as
``bench.py``'s config 1 and ``__graft_entry__.entry`` build it.  GWC by
default; SHPLONK runs through the same code.

Also the host-side references the checks use: the native (python-int)
succinct verifier and the host pairing oracle, for the decide that the port
does not run on the device yet.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from snark_verifier_tpu.loader.native import NativeLoader
from snark_verifier_tpu.pcs.kzg import KzgGwc, KzgShplonk
from snark_verifier_tpu.system.halo2.circuits import build_standard_plonk
from snark_verifier_tpu.system.halo2.prover import create_proof
from snark_verifier_tpu.system.halo2.srs import gen_srs
from snark_verifier_tpu.system.halo2.transcript import NativeEvmTranscript
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu.verifier.plonk import PlonkSuccinctVerifier
from snark_verifier_tpu_torch.parallel.batch import build_verifier, pack_instances, pack_proofs

K = 8
BATCH = 1820
N_UNIQUE = 4
SCHEMES = {"gwc": KzgGwc, "shplonk": KzgShplonk}


@dataclass(frozen=True)
class Fixture:
    k: int
    scheme: str
    srs: object
    protocol: object
    pk: object
    instances: tuple  # per proof: [[instance]]
    proofs: tuple  # per proof: bytes

    @property
    def As(self):
        return SCHEMES[self.scheme]

    @property
    def svk(self):
        return self.srs.g[0]


@functools.lru_cache(maxsize=None)
def _circuit(k: int):
    srs = gen_srs(k)
    protocol, pk = build_standard_plonk(k, srs)
    return srs, protocol, pk


@functools.lru_cache(maxsize=None)
def fixture(k: int = K, scheme: str = "gwc", n_unique: int = N_UNIQUE) -> Fixture:
    """The circuit at size 2^k and ``n_unique`` proofs of it, with instances
    10000, 10001, ..."""
    srs, protocol, pk = _circuit(k)
    instances = tuple([[10_000 + i]] for i in range(n_unique))
    proofs = tuple(create_proof(pk, ins, scheme) for ins in instances)
    return Fixture(k, scheme, srs, protocol, pk, instances, proofs)


def entry(device, batch: int = BATCH, k: int = K, scheme: str = "gwc"):
    """Returns ``(fn, (proof_bytes, instances))``: the batched verifier and a
    batch of ``batch`` proofs (the unique ones tiled) on ``device``."""
    fx = fixture(k, scheme)
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device=device)
    rows = [i % len(fx.proofs) for i in range(batch)]
    proofs = pack_proofs([fx.proofs[i] for i in rows], device)
    instances = pack_instances([fx.instances[i] for i in rows], device)
    return fn, (proofs, instances)


def native_accumulator(fx: Fixture, proof: bytes, instances):
    """(lhs, rhs) affine int pairs from the python-int succinct verifier."""
    loader = NativeLoader()
    verifier = PlonkSuccinctVerifier(fx.As)
    loaded = fx.protocol.loaded(loader)
    ins = [[loader.load_const(v) for v in col] for col in instances]
    transcript = NativeEvmTranscript(proof, loader)
    proof_obj = verifier.read_proof(fx.svk, loaded, ins, transcript)
    acc = verifier.verify(fx.svk, loaded, ins, proof_obj)[0]
    return acc.lhs.value, acc.rhs.value


def host_decide(fx: Fixture, lhs, rhs) -> bool:
    """e(lhs, g2) * e(rhs, -s g2) == 1 with the host pairing oracle."""
    return bn254.pairing_check([(lhs, fx.srs.g2), (rhs, bn254.g2_neg(fx.srs.s_g2))])


def corrupt(proof: bytes) -> bytes:
    """Flip one bit of a commitment byte (as tests/test_verifier_jax.py does):
    the point goes off the curve, so the succinct verify must clear ``ok``."""
    bad = bytearray(proof)
    bad[100] ^= 0x40
    return bytes(bad)
