"""Entry points of the port's main paths.

BASELINE config 1: a batched succinct PLONK+KZG verify of the
standard-plonk circuit at k = 8 with the Keccak (EVM) transcript, at 1820
proofs: 4 unique proofs tiled, as ``bench.py``'s config 1 and
``__graft_entry__.entry`` build it.  GWC by default; SHPLONK runs through the
same code; ``transcript="poseidon"`` verifies the same circuit's Poseidon
proofs (instances 20000..20003, the snarks ``bench.py``'s config 4
aggregates).  Then the batch decide: the 1820 accumulators folded by two
MSMs and one pairing check on the device.

The aggregation path: the k = 20 outer snark of the recursion example (one
inner snark aggregated; two accumulators: the fresh one and the one decoded
from its 16 instance limbs), verified with the Poseidon transcript and both
accumulators decided per proof (``aggregation_entry``), as
``tools/verify_aggregation_onchip.py`` does with the JAX package.

The circuits, deciding keys and proofs come from data files,
``data/standard_plonk_k8.json`` and ``data/aggregation_outer_1snark.json``
(written by ``tests/test_torch_fixture.py``, which proves that they are what
the JAX package's prover and the golden file give), so no prover runs here.

The IPA path: openings proved on the host by the IPA prover on the Keccak
transcript (``ipa_opening``), verified and decided on the device
(``parallel/batch.build_ipa_verifier``).  The multi-device path:
``dryrun_multichip``, the counterpart of ``__graft_entry__.dryrun_multichip``
on ``torch.distributed`` (``parallel/mesh.py``).

Also the host-side references the checks use: the native (python-int)
succinct verifiers and the host pairing oracle.
"""

from __future__ import annotations

import functools
import json
import random
from dataclasses import dataclass
from pathlib import Path

import torch

from snark_verifier_tpu_torch.loader import EcPoint
from snark_verifier_tpu_torch.loader.native import NativeLoader
from snark_verifier_tpu_torch.ops.convert import ints_to_tensor
from snark_verifier_tpu_torch.parallel.batch import (
    build_batch_decider,
    build_verifier,
    pack_instances,
    pack_proofs,
)
from snark_verifier_tpu_torch.pcs.ipa import Ipa
from snark_verifier_tpu_torch.pcs.kzg import KzgDecidingKey, KzgGwc, KzgShplonk
from snark_verifier_tpu_torch.system.halo2.transcript import NativeEvmTranscript, NativePoseidonTranscript
from snark_verifier_tpu_torch.util import bn254
from snark_verifier_tpu_torch.util.msm_symbolic import Msm
from snark_verifier_tpu_torch.verifier.plonk import PlonkSuccinctVerifier
from snark_verifier_tpu_torch.verifier.plonk.serialization import protocol_from_json

K = 8
BATCH = 1820
AGGREGATION_BATCH = 8  # the outer proof tiled, as tools/verify_aggregation_onchip.py
SCHEMES = {"gwc": KzgGwc, "shplonk": KzgShplonk}
NATIVE_TRANSCRIPTS = {"evm": NativeEvmTranscript, "poseidon": NativePoseidonTranscript}
DATA_FILE = Path(__file__).resolve().parent / "data" / "standard_plonk_k8.json"
AGGREGATION_FILE = DATA_FILE.with_name("aggregation_outer_1snark.json")


@dataclass(frozen=True)
class Fixture:
    k: int
    scheme: str
    protocol: object
    dk: KzgDecidingKey  # svk = dk.svk (the SRS's g[0]), g2, s_g2
    instances: tuple  # per proof: [[instance, ...], ...] (one list per column)
    proofs: tuple  # per proof: bytes
    transcript: str = "evm"  # the proofs' transcript: "evm" (Keccak) or "poseidon"

    @property
    def As(self):
        return SCHEMES[self.scheme]

    @property
    def svk(self):
        return self.dk.svk


def _point(obj):
    return tuple(_point(v) for v in obj) if isinstance(obj, list) else int(obj, 16)


def _dk(obj) -> KzgDecidingKey:
    return KzgDecidingKey(svk=_point(obj["svk"]), g2=_point(obj["g2"]), s_g2=_point(obj["s_g2"]))


@functools.lru_cache(maxsize=None)
def fixture(k: int = K, scheme: str = "gwc") -> Fixture:
    """The circuit at size 2^k, its deciding key and its unique proofs, with
    instances 10000, 10001, ..., read from the data file."""
    data = json.loads(DATA_FILE.read_text())
    if data["k"] != k:
        raise ValueError(f"the data file holds the k={data['k']} circuit, not k={k}")
    instances = tuple([[v for v in col] for col in ins] for ins in data["instances"])
    proofs = tuple(bytes.fromhex(p) for p in data["proofs"][scheme])
    return Fixture(k, scheme, protocol_from_json(data["protocol"]), _dk(data), instances, proofs)


@functools.lru_cache(maxsize=None)
def poseidon_fixture() -> Fixture:
    """The k = 8 circuit's four GWC proofs on the Poseidon transcript, with
    instances 20000..20003, read from the data file."""
    data = json.loads(DATA_FILE.read_text())
    pos = data["poseidon"]
    instances = tuple([[v for v in col] for col in ins] for ins in pos["instances"])
    proofs = tuple(bytes.fromhex(p) for p in pos["proofs"])
    return Fixture(data["k"], pos["scheme"], protocol_from_json(data["protocol"]), _dk(data), instances, proofs,
                   "poseidon")


@functools.lru_cache(maxsize=None)
def aggregation_fixture() -> Fixture:
    """The k = 20 outer aggregation snark: its protocol (16 accumulator limbs
    among its instances), deciding key, instances and Poseidon proof, read
    from the data file."""
    data = json.loads(AGGREGATION_FILE.read_text())
    protocol = protocol_from_json(data["protocol"])
    instances = ([[int(v, 16) for v in data["instances"]]],)
    proofs = (bytes.fromhex(data["proof"]),)
    return Fixture(protocol.domain.k, "gwc", protocol, _dk(data["dk"]), instances, proofs, "poseidon")


def tiled(fx: Fixture, batch: int, device="cuda"):
    """(proof_bytes, instances) tensors of ``batch`` proofs on ``device``:
    the fixture's unique proofs tiled."""
    rows = [i % len(fx.proofs) for i in range(batch)]
    return pack_proofs([fx.proofs[i] for i in rows], device), pack_instances([fx.instances[i] for i in rows], device)


def entry(device="cuda", batch: int = BATCH, k: int = K, scheme: str = "gwc", transcript: str = "evm"):
    """Returns ``(fn, (proof_bytes, instances))``: the batched verifier and a
    batch of ``batch`` proofs (the unique ones tiled) on ``device``; with
    ``transcript="poseidon"``, the k = 8 GWC proofs on the Poseidon
    transcript."""
    fx = fixture(k, scheme) if transcript == "evm" else poseidon_fixture()
    if (fx.k, fx.scheme) != (k, scheme):
        raise ValueError(f"the Poseidon proofs are k={fx.k} {fx.scheme}, not k={k} {scheme}")
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device=device, transcript_kind=transcript)
    return fn, tiled(fx, batch, device)


def aggregation_entry(batch: int = AGGREGATION_BATCH, device="cuda"):
    """Returns ``(fn, (proof_bytes, instances))``: the Poseidon-transcript
    verifier of the k = 20 outer snark, which also decides both of its
    accumulators per proof, and the outer proof tiled to ``batch`` on
    ``device``.  ``fn``'s coordinate outputs are (2, batch, 16): the fresh
    accumulator, then the one decoded from the instances."""
    fx = aggregation_fixture()
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device=device, decide_dk=fx.dk, transcript_kind="poseidon")
    return fn, tiled(fx, batch, device)


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


def native_accumulators(fx: Fixture, proof: bytes, instances):
    """Every accumulator, as (lhs, rhs) affine int pairs, from the
    python-int succinct verifier with the fixture's transcript."""
    loader = NativeLoader()
    verifier = PlonkSuccinctVerifier(fx.As)
    loaded = fx.protocol.loaded(loader)
    ins = [[loader.load_const(v) for v in col] for col in instances]
    transcript = NATIVE_TRANSCRIPTS[fx.transcript](proof, loader)
    proof_obj = verifier.read_proof(fx.svk, loaded, ins, transcript)
    return [(acc.lhs.value, acc.rhs.value) for acc in verifier.verify(fx.svk, loaded, ins, proof_obj)]


def native_accumulator(fx: Fixture, proof: bytes, instances):
    """(lhs, rhs) affine int pairs of the first accumulator."""
    return native_accumulators(fx, proof, instances)[0]


def host_decide(fx: Fixture, lhs, rhs) -> bool:
    """e(lhs, g2) * e(rhs, -s g2) == 1 with the host pairing oracle."""
    return bn254.pairing_check([(lhs, fx.dk.g2), (rhs, bn254.g2_neg(fx.dk.s_g2))])


def corrupt_compressed(proof: bytes, offset: int, out_of_range: bool) -> bytes:
    """Corrupt the compressed point at ``offset`` of a Poseidon proof: with
    ``out_of_range`` its x becomes >= p (the top bits set), else x moves by
    the least amount that makes x^3 + 3 a non-residue, so no y exists."""
    bad = bytearray(proof)
    if out_of_range:
        bad[offset + 31] |= 0x7F
        return bytes(bad)
    x = int.from_bytes(bytes(bad[offset : offset + 31]) + bytes([bad[offset + 31] & 0x7F]), "little")
    while True:
        x = (x + 1) % bn254.P
        c = (pow(x, 3, bn254.P) + bn254.G1_B) % bn254.P
        if pow(c, (bn254.P - 1) // 2, bn254.P) == bn254.P - 1:
            break
    bad[offset : offset + 32] = (x | ((bad[offset + 31] >> 7) << 255)).to_bytes(32, "little")
    return bytes(bad)


def corrupt(proof: bytes) -> bytes:
    """Flip one bit of a commitment byte (as tests/test_verifier_jax.py does):
    the point goes off the curve, so the succinct verify must clear ``ok``."""
    bad = bytearray(proof)
    bad[100] ^= 0x40
    return bytes(bad)


def ipa_opening(pk, rng: random.Random):
    """Host: a random polynomial of ``pk``'s size, committed (blinded when
    the key is zk), opened at a random z by the IPA prover on the Keccak
    transcript.  Returns ``(c, z, v, proof_bytes)``: the affine commitment,
    the point, the value there and the proof."""
    p = [rng.randrange(bn254.R) for _ in range(pk.domain.n)]
    omega = rng.randrange(bn254.R) if pk.zk() else None
    c = pk.commit(p, omega)
    z = rng.randrange(bn254.R)
    v = sum(coef * pow(z, i, bn254.R) for i, coef in enumerate(p)) % bn254.R
    transcript = NativeEvmTranscript()
    Ipa.create_proof(pk, p, z, omega, transcript, rng)
    return c, z, v, transcript.finalize()


def pack_ipa_openings(openings, device="cuda"):
    """Host: ``(c, z, v, proof_bytes)`` openings -> the arguments
    ``(proof_bytes, c_x, c_y, z, v)`` of ``build_ipa_verifier``'s function."""
    cols = ([o[0][0] for o in openings], [o[0][1] for o in openings], [o[1] for o in openings],
            [o[2] for o in openings])
    return (pack_proofs([o[3] for o in openings], device), *(ints_to_tensor(c, device) for c in cols))


def native_ipa_accumulator(svk, c, z, v, proof: bytes):
    """The affine U of the python-int IPA succinct verify of one opening;
    raises ``AssertionFailure`` when its check fails."""
    loader = NativeLoader()
    ipa_proof = Ipa.read_proof(svk, NativeEvmTranscript(proof, loader))
    acc = Ipa.succinct_verify(svk, Msm.base(EcPoint(loader, c)), loader.load_const(z), loader.load_const(v), ipa_proof)
    return acc.u.value


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> None:
    """An ``n_devices`` mesh run once on small shapes, the counterpart of
    ``__graft_entry__.dryrun_multichip``: config 1's proofs (one per
    device) verified data-parallel over the mesh, then a sharded large MSM
    of 4 points per device against the host oracle.  Every rank of an
    initialised process group of ``n_devices`` ranks calls it; raises on a
    mismatch."""
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.parallel.mesh import make_mesh, shard_verifier, sharded_msm

    mesh = make_mesh(n_devices, device_type=device_type)
    fn, args = entry(device_type, batch=n_devices)
    out = shard_verifier(fn, mesh)(*args)
    if not bool(out["ok"].all()):
        raise AssertionError("sharded verification failed")
    n_pts = 4 * n_devices
    pts = [bn254.g1_mul(bn254.G1_GEN, i + 1) for i in range(n_pts)]
    scalars = [7 * i + 3 for i in range(n_pts)]
    total = sharded_msm(C.g1_from_affine_ints(pts, device_type), ints_to_tensor(scalars, device_type), mesh)
    if C.g1_to_affine_ints(C.G1(*(c[None] for c in total)))[0] != bn254.g1_msm(scalars, pts):
        raise AssertionError("sharded MSM mismatch")
    print(f"dryrun_multichip({n_devices}): ok")
