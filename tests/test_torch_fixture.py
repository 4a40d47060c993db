"""The port's data-file fixtures: ``snark_verifier_tpu_torch/data/
standard_plonk_k8.json`` (the k=8 standard-plonk protocol, the deciding key,
instances 10000..10003 with four GWC and four SHPLONK proofs on the Keccak
transcript, and under ``poseidon`` instances 20000..20003 with four GWC
proofs on the Poseidon transcript) and ``data/aggregation_outer_1snark.json``
(the k=20 outer aggregation snark: protocol, instances, proof and deciding
key of ``tests/golden/aggregation_outer_1snark.json``).

The first is generated here through the JAX package's prover, which is
deterministic, the second from the golden file;
``python tests/test_torch_fixture.py --write`` rewrites both.  The tests
regenerate them and require the committed files byte for byte, and hold the
port's own native verifier on the files against the JAX package's.

Also the host references that the port's tests hold it against, all of the
JAX package (python ints, nothing compiled): its native succinct verifier
and its native KZG decide.
"""

import functools
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# The port's CPU tests run plain torch on small tensors, where intra-op
# threads buy nothing.  With torch's default of one thread per core in each
# of several pytest-xdist workers the threads oversubscribed the host and
# made the plain pairing tests ten times slower.  Every worker imports every
# test module when it collects, so one thread per worker holds for the run.
torch.set_num_threads(1)

from snark_verifier_tpu.errors import AssertionFailure  # noqa: E402
from snark_verifier_tpu.loader.native import NativeLoader  # noqa: E402
from snark_verifier_tpu.pcs.kzg import KzgAccumulator, KzgDecidingKey, KzgGwc, KzgShplonk  # noqa: E402
from snark_verifier_tpu.pcs.kzg.decider import decide  # noqa: E402
from snark_verifier_tpu.system.halo2.circuits import build_standard_plonk  # noqa: E402
from snark_verifier_tpu.system.halo2.prover import create_proof  # noqa: E402
from snark_verifier_tpu.system.halo2.srs import gen_srs  # noqa: E402
from snark_verifier_tpu.system.halo2.transcript import NativeEvmTranscript, NativePoseidonTranscript  # noqa: E402
from snark_verifier_tpu.verifier.plonk import PlonkSuccinctVerifier  # noqa: E402
from snark_verifier_tpu.verifier.plonk.serialization import protocol_from_json, protocol_to_json  # noqa: E402
from snark_verifier_tpu_torch import entry as E  # noqa: E402

K = 8
N_UNIQUE = 4
JAX_SCHEMES = {"gwc": KzgGwc, "shplonk": KzgShplonk}
JAX_TRANSCRIPTS = {"evm": NativeEvmTranscript, "poseidon": NativePoseidonTranscript}
GOLDEN = REPO / "tests" / "golden" / "aggregation_outer_1snark.json"
AGGREGATION_FIELDS = ("dk", "instances", "proof", "protocol")


@functools.lru_cache(maxsize=None)
def jax_data_protocol():
    """The data file's protocol, read by the JAX package's serialization."""
    return protocol_from_json(json.loads(E.DATA_FILE.read_text())["protocol"])


def jax_native_accumulators(protocol, scheme, svk, proof, instances, transcript="evm"):
    """Every accumulator, as (lhs, rhs) affine int pairs, from the JAX
    package's native (python-int) succinct verifier of ``protocol`` (a JAX
    package protocol) with its ``transcript`` ("evm" or "poseidon")."""
    loader = NativeLoader()
    verifier = PlonkSuccinctVerifier(JAX_SCHEMES[scheme])
    loaded = protocol.loaded(loader)
    cols = [[loader.load_const(v) for v in col] for col in instances]
    proof_obj = verifier.read_proof(svk, loaded, cols, JAX_TRANSCRIPTS[transcript](proof, loader))
    return [(acc.lhs.value, acc.rhs.value) for acc in verifier.verify(svk, loaded, cols, proof_obj)]


def jax_native_accumulator(protocol, scheme, svk, proof, instances, transcript="evm"):
    """The first accumulator of ``jax_native_accumulators``."""
    return jax_native_accumulators(protocol, scheme, svk, proof, instances, transcript)[0]


def jax_decide(dk, lhs, rhs) -> bool:
    """The JAX package's native KZG decide (pcs/kzg/decider.decide) of one
    accumulator: e(lhs, g2) e(rhs, -s g2) == 1 by its pairing oracle."""
    loader = NativeLoader()
    acc = KzgAccumulator(loader.ec_point_load_const(lhs), loader.ec_point_load_const(rhs))
    try:
        return decide(KzgDecidingKey(svk=dk.svk, g2=dk.g2, s_g2=dk.s_g2), acc)
    except AssertionFailure:
        return False


def _hex_point(pt):
    return [_hex_point(v) for v in pt] if isinstance(pt, tuple) else hex(pt)


def generate() -> str:
    """The data file's text, generated through the JAX package's prover."""
    srs = gen_srs(K, use_cache=False)
    protocol, pk = build_standard_plonk(K, srs)
    instances = [[[10_000 + i]] for i in range(N_UNIQUE)]
    poseidon_instances = [[[20_000 + i]] for i in range(N_UNIQUE)]
    dk = srs.decider_key()
    data = {
        "k": K,
        "protocol": protocol_to_json(protocol),
        "svk": _hex_point(dk.svk),
        "g2": _hex_point(dk.g2),
        "s_g2": _hex_point(dk.s_g2),
        "instances": instances,
        "proofs": {s: [create_proof(pk, ins, s).hex() for ins in instances] for s in ("gwc", "shplonk")},
        "poseidon": {
            "scheme": "gwc",
            "instances": poseidon_instances,
            "proofs": [create_proof(pk, ins, "gwc", transcript_kind="poseidon").hex() for ins in poseidon_instances],
        },
    }
    return json.dumps(data, indent=1, sort_keys=True) + "\n"


def generate_aggregation() -> str:
    """The outer-snark data file's text: the golden file's protocol,
    instances, proof and deciding key."""
    golden = json.loads(GOLDEN.read_text())
    return json.dumps({k: golden[k] for k in AGGREGATION_FIELDS}, indent=1, sort_keys=True) + "\n"


@pytest.fixture(scope="module")
def generated():
    return generate()


def test_data_file_is_what_the_jax_prover_generates(generated):
    assert E.DATA_FILE.read_text() == generated


def test_aggregation_data_file_is_the_golden_snark():
    assert E.AGGREGATION_FILE.read_text() == generate_aggregation()
    data, golden = json.loads(E.AGGREGATION_FILE.read_text()), json.loads(GOLDEN.read_text())
    assert sorted(data) == list(AGGREGATION_FIELDS)
    assert all(data[k] == golden[k] for k in AGGREGATION_FIELDS)


@pytest.mark.parametrize("scheme", ["gwc", "shplonk"])
def test_port_native_verifier_matches_jax_native(scheme):
    """The port's own copies (serialization, NativeLoader, verifier, pcs,
    transcript) on the file give the JAX package's native accumulators."""
    fx = E.fixture(K, scheme)
    wrong = [[fx.instances[0][0][0] + 1]]
    for proof, ins in list(zip(fx.proofs, fx.instances)) + [(fx.proofs[0], wrong)]:
        want = jax_native_accumulator(jax_data_protocol(), scheme, fx.svk, proof, ins)
        assert E.native_accumulator(fx, proof, ins) == want
        assert E.host_decide(fx, *want) == jax_decide(fx.dk, *want) == (ins is not wrong)


def test_fixture_fields():
    fx = E.fixture(K, "gwc")
    assert len(fx.proofs) == N_UNIQUE and all(len(p) == 992 for p in fx.proofs)
    assert fx.instances == tuple([[10_000 + i]] for i in range(N_UNIQUE))
    assert fx.svk == (1, 2)  # the SRS's g[0] is the generator
    with pytest.raises(ValueError):
        E.fixture(4, "gwc")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_fixture.py --write")
    E.DATA_FILE.parent.mkdir(parents=True, exist_ok=True)
    E.DATA_FILE.write_text(generate())
    E.AGGREGATION_FILE.write_text(generate_aggregation())
    print(f"wrote {E.DATA_FILE} and {E.AGGREGATION_FILE}")
