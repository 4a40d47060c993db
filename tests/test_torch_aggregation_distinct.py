"""The port's verifier of the k=20 outer aggregation snark on distinct outer
proofs: the benchmark's data file (benchmark/data/aggregation_k20_8.json:
eight outer proofs over the inner snarks of instances 1000..1007, and the
valid outer proof of a bad inner snark, with the python-int reference's
answers), on the CPU.

One batch through ``build_verifier(..., decide_dk=...)`` on the Poseidon
transcript holds two good proofs, one input of each bad kind (a compressed
x >= p, an instance limb flipped off the curve, the bad inner snark) and the
probe's kind (a proof with the next proof's instances): ``ok`` and both
accumulators must equal the file's answers limb for limb.  The reference
(``benchmark.reference.aggregation``) and the JAX package's native verifier
work answers out again, and the file itself is checked: proof 0 is the
port's data file's, the instances are distinct under one protocol, and the
bad inner snark's outer proof fails only its decoded accumulator's decide.
"""

import json

import pytest
from test_torch_fixture import jax_decide, jax_native_accumulators

from benchmark.harness.registry import BENCH_DIR
from benchmark.reference import aggregation as ref
from snark_verifier_tpu.verifier.plonk.serialization import protocol_from_json as jax_protocol_from_json
from snark_verifier_tpu_torch import entry as E
from snark_verifier_tpu_torch.parallel.batch import build_verifier, decode_accumulator, pack_instances, pack_proofs
from snark_verifier_tpu_torch.pcs.kzg import KzgDecidingKey, KzgGwc
from snark_verifier_tpu_torch.verifier.plonk.serialization import protocol_from_json

DATA = BENCH_DIR / "data" / "aggregation_k20_8.json"
CONFIG = BENCH_DIR / "configs" / "aggregation_k20_poseidon.json"
ROWS = ("good.0", "good.1", "out_of_range.2", "limb_flip.3", "bad_inner", "probe.4")


@pytest.fixture(scope="module")
def data():
    return json.loads(DATA.read_text())


@pytest.fixture(scope="module")
def named(data):
    return ref.inputs(data, json.loads(CONFIG.read_text()))


def answer_ints(answer):
    """A file answer's accumulators -> [((lhs), (rhs)), ...] affine ints."""
    return [((a[0], a[1]), (a[2], a[3])) for a in ([int(v, 16) for v in acc] for acc in answer["accumulators"])]


@pytest.fixture(scope="module")
def port_batch(data, named):
    """ROWS through the port's verifier with the per-proof decide of both
    accumulators (plain torch on the CPU)."""
    dk = data["dk"]
    svk, g2, s_g2 = (ref.point(dk[k]) for k in ("svk", "g2", "s_g2"))
    fn = build_verifier(protocol_from_json(data["protocol"]), KzgGwc, svk, device="cpu",
                        decide_dk=KzgDecidingKey(svk, g2, s_g2), transcript_kind="poseidon")
    return fn(pack_proofs([named[r][0] for r in ROWS], "cpu"), pack_instances([named[r][1] for r in ROWS], "cpu"))


@pytest.mark.parametrize("row", ROWS)
def test_port_matches_the_file_answers(port_batch, data, row):
    """``ok`` is the reference's, and wherever the reference's succinct
    verify passes (good rows, the bad inner snark, the probe) both
    accumulators, fresh then decoded, equal its limb for limb."""
    want = data["answers"][row]
    i = ROWS.index(row)
    assert tuple(port_batch["lhs_x"].shape) == (2, len(ROWS), 16)
    assert bool(port_batch["ok"][i]) == want["ok"]
    if want["succinct"]:
        got = [decode_accumulator({k: v[a] for k, v in port_batch.items() if k != "ok"}, i) for a in range(2)]
        assert got == answer_ints(want)


@pytest.mark.parametrize("name", ["good.6", "bad_inner"])
def test_reference_recomputes_the_file_answers(data, named, name):
    assert ref.answer(ref.load_circuit(data), *named[name]) == data["answers"][name]


def test_jax_native_verifier_agrees_with_the_file(data, named):
    """The JAX package's python-int verifier and decide on proof 7."""
    proof, instances = named["good.7"]
    accs = jax_native_accumulators(jax_protocol_from_json(data["protocol"]), "gwc", ref.point(data["dk"]["svk"]),
                                   proof, instances, "poseidon")
    assert accs == answer_ints(data["answers"]["good.7"])
    fx = E.aggregation_fixture()
    assert all(jax_decide(fx.dk, *acc) for acc in accs)


def test_file_extends_the_port_data_file(data):
    """Proof 0 and its instances are the port's outer snark, byte for byte,
    under the same protocol and deciding key."""
    port = json.loads(E.AGGREGATION_FILE.read_text())
    assert data["proofs"][0] == port["proof"] and data["instances"][0] == port["instances"]
    assert data["protocol"] == port["protocol"] and data["dk"] == port["dk"]


def test_file_holds_distinct_proofs_under_one_protocol(data):
    proofs, instances = data["proofs"], data["instances"]
    assert len(proofs) == len(instances) == 8 and all(len(bytes.fromhex(p)) == 1664 for p in proofs)
    assert len(set(proofs)) == len({tuple(v) for v in instances}) == 8
    assert data["bad_inner"]["proof"] not in proofs and tuple(data["bad_inner"]["instances"]) not in map(tuple, instances)
    assert protocol_from_json(data["protocol"]).accumulator_indices == [[(0, j) for j in range(16)]]


def test_file_answers_accept_the_good_and_reject_the_bad(data):
    """Every good proof decides both accumulators; every corrupted one is
    rejected; the bad inner snark's outer proof passes its succinct verify
    and its fresh decide, and fails only its decoded accumulator's; the
    probe's input fails its fresh accumulator's."""
    answers = data["answers"]
    assert all(answers[f"good.{i}"]["ok"] and answers[f"good.{i}"]["decides"] == [True, True] for i in range(8))
    assert not any(answers[f"{kind}.{i}"]["succinct"] for kind in ("out_of_range", "limb_flip") for i in range(8))
    assert answers["bad_inner"]["succinct"] and answers["bad_inner"]["decides"] == [True, False]
    assert all(answers[f"probe.{i}"]["succinct"] and answers[f"probe.{i}"]["decides"] == [False, True]
               for i in range(8))
    assert not any(a["ok"] for name, a in answers.items() if not name.startswith("good."))
