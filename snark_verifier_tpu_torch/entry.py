"""Entry points of the port's main path: BASELINE config 1.

A batched succinct PLONK+KZG verify of the standard-plonk circuit at k = 8
with the Keccak (EVM) transcript, at 1820 proofs: 4 unique proofs tiled, as
``bench.py``'s config 1 and ``__graft_entry__.entry`` build it.  GWC by
default; SHPLONK runs through the same code.  Then the batch decide: the
1820 accumulators folded by two MSMs and one pairing check on the device.

The circuit, its deciding key and the proofs come from a data file,
``data/standard_plonk_k8.json`` (written by ``tests/test_torch_fixture.py``,
which proves that it is what the JAX package's prover generates), so no
prover runs here.

Also the host-side references the checks use: the native (python-int)
succinct verifier and the host pairing oracle.
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass
from pathlib import Path

import torch

from snark_verifier_tpu_torch.loader.native import NativeLoader
from snark_verifier_tpu_torch.parallel.batch import (
    build_batch_decider,
    build_verifier,
    pack_instances,
    pack_proofs,
)
from snark_verifier_tpu_torch.pcs.kzg import KzgDecidingKey, KzgGwc, KzgShplonk
from snark_verifier_tpu_torch.system.halo2.transcript import NativeEvmTranscript
from snark_verifier_tpu_torch.util import bn254
from snark_verifier_tpu_torch.verifier.plonk import PlonkSuccinctVerifier
from snark_verifier_tpu_torch.verifier.plonk.serialization import protocol_from_json

K = 8
BATCH = 1820
SCHEMES = {"gwc": KzgGwc, "shplonk": KzgShplonk}
DATA_FILE = Path(__file__).resolve().parent / "data" / "standard_plonk_k8.json"


@dataclass(frozen=True)
class Fixture:
    k: int
    scheme: str
    protocol: object
    dk: KzgDecidingKey  # svk = dk.svk (the SRS's g[0]), g2, s_g2
    instances: tuple  # per proof: [[instance]]
    proofs: tuple  # per proof: bytes

    @property
    def As(self):
        return SCHEMES[self.scheme]

    @property
    def svk(self):
        return self.dk.svk


def _point(obj):
    return tuple(_point(v) for v in obj) if isinstance(obj, list) else int(obj, 16)


@functools.lru_cache(maxsize=None)
def fixture(k: int = K, scheme: str = "gwc") -> Fixture:
    """The circuit at size 2^k, its deciding key and its unique proofs, with
    instances 10000, 10001, ..., read from the data file."""
    data = json.loads(DATA_FILE.read_text())
    if data["k"] != k:
        raise ValueError(f"the data file holds the k={data['k']} circuit, not k={k}")
    dk = KzgDecidingKey(svk=_point(data["svk"]), g2=_point(data["g2"]), s_g2=_point(data["s_g2"]))
    instances = tuple([[v for v in col] for col in ins] for ins in data["instances"])
    proofs = tuple(bytes.fromhex(p) for p in data["proofs"][scheme])
    return Fixture(k, scheme, protocol_from_json(data["protocol"]), dk, instances, proofs)


def entry(device="cuda", batch: int = BATCH, k: int = K, scheme: str = "gwc"):
    """Returns ``(fn, (proof_bytes, instances))``: the batched verifier and a
    batch of ``batch`` proofs (the unique ones tiled) on ``device``."""
    fx = fixture(k, scheme)
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device=device)
    rows = [i % len(fx.proofs) for i in range(batch)]
    proofs = pack_proofs([fx.proofs[i] for i in rows], device)
    instances = pack_instances([fx.instances[i] for i in rows], device)
    return fn, (proofs, instances)


def fold_scalars(batch: int, generator: torch.Generator, device="cuda"):
    """(batch, 16) canonical limbs of random Fr fold scalars drawn from
    ``generator``: 15 uniform 16-bit limbs and a top limb below r's, so
    every value is below r."""
    low = torch.randint(0, 1 << 16, (batch, 15), generator=generator, dtype=torch.int64)
    top = torch.randint(0, bn254.R >> 240, (batch, 1), generator=generator, dtype=torch.int64)
    return torch.cat([low, top], dim=-1).to(device)


def decide_entry(device="cuda", batch: int = BATCH, seed: int = 0, k: int = K, scheme: str = "gwc"):
    """Returns ``(decider, (lhs_x, lhs_y, rhs_x, rhs_y, fold))``: the batch
    decider of the config-1 circuit, the ``batch`` accumulators that
    ``entry``'s verifier gives for its batch, and seeded fold scalars from an
    explicit ``torch.Generator``.  ``decider(*args)`` is True when every
    proof of the batch is valid."""
    fx = fixture(k, scheme)
    fn, args = entry(device, batch, k, scheme)
    out = fn(*args)
    decider = build_batch_decider(fx.dk, device=device)
    fold = fold_scalars(batch, torch.Generator().manual_seed(seed), device)
    return decider, (out["lhs_x"], out["lhs_y"], out["rhs_x"], out["rhs_y"], fold)


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
    return bn254.pairing_check([(lhs, fx.dk.g2), (rhs, bn254.g2_neg(fx.dk.s_g2))])


def corrupt(proof: bytes) -> bytes:
    """Flip one bit of a commitment byte (as tests/test_verifier_jax.py does):
    the point goes off the curve, so the succinct verify must clear ``ok``."""
    bad = bytearray(proof)
    bad[100] ^= 0x40
    return bytes(bad)
