"""The port's aggregation path on the CPU: the k=20 outer aggregation snark
verified with the Poseidon transcript and both of its accumulators decided
(``entry.aggregation_entry``), its small MSMs through kernel K4's plain
version; those MSMs again through ``msm_windowed`` (K8/K9's); and config 4's
fold (the port's copy of ``sdk/aggregation.aggregate_native``) followed by a
decide, against the JAX package's native verifier, its native KZG decide and
its ``aggregate_native``.

The outer snark runs at B = 3 rows, one verify for all the cases: the
outer proof, the proof with one byte mutated (``bad[7] ^= 1``, as
tools/verify_aggregation_onchip.py probes it), and the proof with one bit of
one instance limb flipped.  Accumulators are integers and compared exactly.
"""

import json

import pytest
import torch
from test_torch_fixture import GOLDEN, jax_data_protocol, jax_decide, jax_native_accumulators

from snark_verifier_tpu import sdk as JSDK
from snark_verifier_tpu.pcs.kzg import KzgGwc as JaxKzgGwc
from snark_verifier_tpu.sdk import aggregation as JAGG
from snark_verifier_tpu.verifier.plonk.serialization import protocol_from_json as jax_protocol_from_json
from snark_verifier_tpu_torch import entry as E
from snark_verifier_tpu_torch import sdk as PSDK
from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import msm as M
from snark_verifier_tpu_torch.ops import msm_cuda as MK
from snark_verifier_tpu_torch.ops import pairing as PAIR
from snark_verifier_tpu_torch.parallel.batch import decode_accumulator
from snark_verifier_tpu_torch.pcs.kzg import KzgGwc
from snark_verifier_tpu_torch.pcs.kzg.accumulator import accumulator_to_limbs
from snark_verifier_tpu_torch.sdk import aggregation as PAGG

ROWS = ("outer proof", "byte 7 mutated", "instance limb flipped")
FLIPPED_LIMB = 3  # the top 68-bit limb of the old accumulator's lhs x


def outer_batch(fn_args):
    """The aggregation entry's 3-row batch with row 1's proof byte 7 and row
    2's instance limb FLIPPED_LIMB changed."""
    proofs, instances = (a.clone() for a in fn_args)
    proofs[1, 7] ^= 1
    instances[2, FLIPPED_LIMB, 0] ^= 1
    return proofs, instances


@pytest.fixture(scope="module")
def outer_msms():
    """(points, scalars, output) of each small MSM of the ``outer_run``."""
    return []


@pytest.fixture(scope="module")
def outer_run(outer_msms):
    """The outer batch through ``entry.aggregation_entry`` (the one-kernel
    scan) and the decide of both accumulators; its small MSMs are recorded
    in ``outer_msms``."""
    batched = M.msm_batched

    def recording(points, scalars):
        out = batched(points, scalars)
        outer_msms.append((points, scalars, out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "msm_batched", recording)
        fn, args = E.aggregation_entry(batch=len(ROWS), device="cpu")
        return fn(*outer_batch(args))


@pytest.fixture(scope="module")
def jax_outer():
    """The JAX package's native verifier on the golden outer snark: both
    accumulators of the outer proof."""
    golden = json.loads(GOLDEN.read_text())
    fx = E.aggregation_fixture()
    protocol = jax_protocol_from_json(golden["protocol"])
    return fx, jax_native_accumulators(protocol, "gwc", fx.svk, fx.proofs[0], fx.instances[0], "poseidon")


def accumulators(out, row):
    return [decode_accumulator({k: v[a] for k, v in out.items() if k != "ok"}, row) for a in range(2)]


def test_outer_snark_fixture():
    fx = E.aggregation_fixture()
    assert (fx.k, fx.transcript, len(fx.proofs), len(fx.proofs[0])) == (20, "poseidon", 1, 1664)
    assert len(fx.instances[0][0]) == 16 and len(fx.protocol.accumulator_indices[0]) == 16
    import inspect

    params = inspect.signature(E.aggregation_entry).parameters
    assert params["device"].default == "cuda" and params["batch"].default == 8


def test_outer_snark_accumulators_match_jax_native(outer_run, jax_outer):
    """The fresh accumulator and the one decoded from the instance limbs equal
    the JAX package's native verifier's; the outputs gain a leading axis of
    2; the JAX native decide accepts both."""
    fx, want = jax_outer
    assert tuple(outer_run["lhs_x"].shape) == (2, len(ROWS), 16)
    assert accumulators(outer_run, 0) == want
    assert all(jax_decide(fx.dk, *acc) for acc in want)


def test_outer_snark_decides_and_rejects_mutation_and_limb_flip(outer_run):
    """With both accumulators decided per proof, ``ok`` holds for the outer
    proof and is cleared by the mutated byte and by the flipped limb."""
    assert outer_run["ok"].tolist() == [True, False, False]


def test_outer_snark_mega_off_matches_mega_on(outer_run, outer_msms, monkeypatch):
    """The outer snark's small MSMs (36 and 3 terms per proof), on the inputs
    the verify gave them, through ``msm_windowed``: the two-kernel form,
    never the scan, gives the scan's points in affine form for every row
    whose points are on the curve (the outer proof, the flipped limb; the
    mutated byte makes a non-residue x).  So K8/K9 compute K4's MSMs at the
    outer snark's shape; chip_smoke.py holds the kernels against each other
    on the card on the same run's inputs."""
    assert [tuple(s.shape[:-1]) for _, s, _ in outer_msms] == [(len(ROWS), 36), (len(ROWS), 3)]

    def no_scan(*args, **kwargs):
        raise AssertionError("msm_windowed must not run the one-kernel scan")

    monkeypatch.setattr(MK, "msm_scan", no_scan)
    for points, scalars, want in outer_msms:
        got = C.g1_to_affine_ints(MK.msm_windowed(*M.scan_inputs(points, scalars)))
        assert [got[r] for r in (0, 2)] == [C.g1_to_affine_ints(want)[r] for r in (0, 2)]


@pytest.fixture(scope="module")
def aggregations():
    """Config 4's fold of the four Poseidon snarks: the port's copy of
    aggregate_native and the JAX package's, over the same proofs."""
    fx = E.poseidon_fixture()
    port = PAGG.aggregate_native(
        KzgGwc, fx.svk, [PSDK.Snark(fx.protocol, ins, proof) for ins, proof in zip(fx.instances, fx.proofs)]
    )
    jax = JAGG.aggregate_native(
        JaxKzgGwc, fx.svk,
        [JSDK.Snark(jax_data_protocol(), ins, proof) for ins, proof in zip(fx.instances, fx.proofs)],
    )
    return fx, port, jax


def test_aggregate_native_matches_jax(aggregations):
    """Same folded accumulator, accumulation proof (empty without zk
    blinding: the fold's challenge comes from the absorbed accumulators),
    instance limbs and per-snark accumulators; the port's verify_aggregation
    reads the fold back."""
    fx, port, jax = aggregations
    acc = (port.accumulator.lhs.value, port.accumulator.rhs.value)
    assert acc == (jax.accumulator.lhs.value, jax.accumulator.rhs.value)
    assert port.as_proof == jax.as_proof
    assert port.instances == jax.instances == accumulator_to_limbs(port.accumulator)
    assert [(a.lhs.value, a.rhs.value) for a in port.snark_accumulators] == [
        (a.lhs.value, a.rhs.value) for a in jax.snark_accumulators
    ]
    back = PAGG.verify_aggregation(KzgGwc, PAGG.KzgAsProvingKey().vk(), port.snark_accumulators, port.as_proof)
    assert (back.lhs.value, back.rhs.value) == acc
    assert jax_decide(fx.dk, *acc)


def test_aggregate_fold_decides_on_the_device_path(aggregations):
    """The folded accumulator through the port's ``kzg_pairing_check``
    (plain versions on the CPU) is True, and its 16 instance limbs decode to
    it through ``TorchLoader.ec_point_from_limbs``."""
    fx, port, _ = aggregations
    lhs, rhs = port.accumulator.lhs.value, port.accumulator.rhs.value
    ok = PAIR.kzg_pairing_check(C.g1_from_affine_ints([lhs], "cpu"), C.g1_from_affine_ints([rhs], "cpu"),
                                fx.dk.g2, fx.dk.s_g2)
    assert ok.tolist() == [True]
    loader = TorchLoader((1,), "cpu")
    limbs = [loader.load_const(v) for v in port.instances]
    points = [loader.ec_point_from_limbs(limbs[i:i + 8], 4, 68).value for i in (0, 8)]
    assert C.g1_to_affine_ints(C.G1(*torch.broadcast_tensors(*points[0].as_proj()))) == [lhs]
    assert C.g1_to_affine_ints(C.G1(*torch.broadcast_tensors(*points[1].as_proj()))) == [rhs]
    assert loader.ok.tolist() == [True]
