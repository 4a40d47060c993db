"""The data file and the frozen reference: the file's circuit and first
proofs are the port's own data file's, its answers are the reference's, and
the reference agrees with the port's own python-int verifier on the file's
proofs, their corruptions and the probe's input (a one-time check of the
copy)."""

import json

import numpy as np
import pytest

from benchmark.harness.limbs import limbs
from benchmark.harness.registry import BENCH_DIR, REPO_DIR
from benchmark.harness.rows import rng
from benchmark.reference import plonk as ref
from benchmark.reference.util import bn254
from benchmark.systems import plonk_kzg

CONFIGS = ["plonk_k8_keccak", "plonk_k8_poseidon"]


def inputs(config: str) -> plonk_kzg.Inputs:
    return plonk_kzg.Inputs(json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text()), 2**31 + 99)


def test_data_file_extends_the_port_data_file():
    ours = json.loads((BENCH_DIR / "data" / "standard_plonk_k8_1820.json").read_text())
    port = json.loads((REPO_DIR / "snark_verifier_tpu_torch" / "data" / "standard_plonk_k8.json").read_text())
    for key in ("k", "protocol", "svk", "g2", "s_g2"):
        assert ours[key] == port[key]
    assert ours["evm"]["proofs"][:4] == port["proofs"]["gwc"]
    assert [[[v]] for v in ours["evm"]["instances"][:4]] == port["instances"]
    assert ours["poseidon"]["proofs"][:4] == port["poseidon"]["proofs"]
    assert [[[v]] for v in ours["poseidon"]["instances"][:4]] == port["poseidon"]["instances"]
    for part in (ours["evm"], ours["poseidon"]):
        assert len(set(part["proofs"])) == len(set(part["instances"])) == len(part["accumulators"]) == 1820
        assert all(part["decides"])


@pytest.mark.parametrize("config", CONFIGS)
def test_answers_are_the_reference_s(config):
    """A seeded sample of the file's answers, worked out again."""
    inp = inputs(config)
    for n, i in enumerate(rng(7, 0).choice(inp.good, 6, replace=False).tolist()):
        ok, lhs, rhs = ref.succinct(inp.circuit, *inp[i])
        assert ok and np.array_equal(limbs([lhs[0], lhs[1], rhs[0], rhs[1]]), inp.table[i])
        if n < 2:
            assert ref.pairing_value(inp.circuit, lhs, rhs) == bn254.FQ12_ONE


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_equals_the_port_native_verifier(config):
    from snark_verifier_tpu_torch.entry import NATIVE_TRANSCRIPTS
    from snark_verifier_tpu_torch.loader.native import NativeLoader
    from snark_verifier_tpu_torch.pcs.kzg import KzgGwc
    from snark_verifier_tpu_torch.verifier.plonk import PlonkSuccinctVerifier
    from snark_verifier_tpu_torch.verifier.plonk.serialization import protocol_from_json

    inp = inputs(config)
    transcript = inp.circuit.transcript
    protocol = protocol_from_json(inp.data["protocol"])

    def port(proof, instances):
        loader = NativeLoader()
        verifier = PlonkSuccinctVerifier(KzgGwc)
        loaded = protocol.loaded(loader)
        ins = [[loader.load_const(v) for v in col] for col in instances]
        try:
            parsed = verifier.read_proof(inp.circuit.svk, loaded, ins, NATIVE_TRANSCRIPTS[transcript](proof, loader))
            (acc,) = verifier.verify(inp.circuit.svk, loaded, ins, parsed)
        except Exception:
            return False, None, None
        return True, acc.lhs.value, acc.rhs.value

    good = rng(8, 0).choice(inp.good, 3, replace=False).tolist()
    n = len(inp.good)
    ids = good + [i + k * n for k in range(len(inp.bad) // n) for i in good] + [inp.probe]
    for i in ids:
        got = ref.succinct(inp.circuit, *inp[i])
        assert got == port(*inp[i])
        assert got[0] == (i in inp.good or i == inp.probe)
    ok, lhs, rhs = ref.succinct(inp.circuit, *inp[good[0]])
    value = ref.pairing_value(inp.circuit, lhs, rhs)
    assert ref.fold_verdict({0: value}, {0: 12345})
    wrong = ref.succinct(inp.circuit, *inp[inp.probe])
    assert wrong[0] and not ref.fold_verdict({0: value, 1: ref.pairing_value(inp.circuit, wrong[1], wrong[2])},
                                             {0: 3, 1: 5})
