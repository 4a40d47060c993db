"""The port's batched succinct verifier (snark_verifier_tpu_torch/parallel/
batch.py over TorchLoader and TorchEvmTranscript) against the JAX package's
build_verifier, native (python-int) verifier and native decide on the CPU.

K = 4 and B = 2 proofs: the shapes of tests/test_verifier_jax.py, so the
persistent JAX compile cache serves the JAX side.  The circuit and proofs
come from the JAX package's prover; the port reads the protocol through its
own serialization.  Accumulators are integers and compared exactly.
"""

import functools

import jax
import numpy as np
import pytest
from test_torch_fixture import jax_decide, jax_native_accumulator

from snark_verifier_tpu.parallel import batch as JB
from snark_verifier_tpu.pcs.kzg import KzgGwc, KzgShplonk
from snark_verifier_tpu.system.halo2.circuits import build_standard_plonk
from snark_verifier_tpu.system.halo2.prover import create_proof
from snark_verifier_tpu.system.halo2.srs import gen_srs
from snark_verifier_tpu.verifier.plonk.serialization import protocol_to_json
from snark_verifier_tpu_torch import entry as E
from snark_verifier_tpu_torch.parallel.batch import build_verifier, decode_accumulator, pack_instances, pack_proofs
from snark_verifier_tpu_torch.pcs.kzg import KzgDecidingKey
from snark_verifier_tpu_torch.verifier.plonk.serialization import protocol_from_json

K = 4
INSTANCES = [[[12345]], [[999]]]
KEYS = ("lhs_x", "lhs_y", "rhs_x", "rhs_y", "ok")
JAX_SCHEMES = {"gwc": KzgGwc, "shplonk": KzgShplonk}


@functools.lru_cache(maxsize=None)
def _circuit():
    srs = gen_srs(K)
    protocol, pk = build_standard_plonk(K, srs)
    return srs, protocol, pk


@functools.lru_cache(maxsize=None)
def fixture_for(scheme):
    """The K = 4 circuit with proofs of INSTANCES, as the port's Fixture,
    and the JAX package's protocol for its verifier."""
    srs, protocol, pk = _circuit()
    proofs = tuple(create_proof(pk, ins, scheme) for ins in INSTANCES)
    dk = KzgDecidingKey(svk=srs.g[0], g2=srs.g2, s_g2=srs.s_g2)
    fx = E.Fixture(K, scheme, protocol_from_json(protocol_to_json(protocol)), dk, tuple(INSTANCES), proofs)
    return fx, protocol


def jax_verifier(fx, protocol):
    return jax.jit(JB.build_verifier(protocol, JAX_SCHEMES[fx.scheme], fx.svk))


@pytest.fixture(scope="module")
def jax_gwc():
    fx, protocol = fixture_for("gwc")
    return fx, jax_verifier(fx, protocol)


def assert_matches_jax(out, jax_out):
    for key in KEYS:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(jax_out[key]).astype(out[key].numpy().dtype))


@pytest.mark.parametrize("scheme", ["gwc", "shplonk"])
def test_port_matches_jax_and_native(jax_gwc, scheme):
    fx, protocol = fixture_for(scheme)
    jax_fn = jax_gwc[1] if scheme == "gwc" else jax_verifier(fx, protocol)
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device="cpu")
    out = fn(pack_proofs(fx.proofs, "cpu"), pack_instances(fx.instances, "cpu"))
    assert_matches_jax(out, jax_fn(JB.pack_proofs(fx.proofs), JB.pack_instances(fx.instances)))
    assert out["ok"].tolist() == [True, True]
    for i, ins in enumerate(fx.instances):
        assert decode_accumulator(out, i) == jax_native_accumulator(protocol, scheme, fx.svk, fx.proofs[i], ins)


def test_corrupted_proof_and_wrong_instance(jax_gwc):
    """A corrupted commitment clears ``ok`` in the port and in JAX alike (its
    accumulator is not a group element sum, so the two MSM algorithms may
    disagree on it); a wrong instance keeps ``ok`` (only the decide can
    reject it) and gives the native verifier's accumulator for that
    instance, which the JAX package's native decide rejects."""
    fx, jax_fn = jax_gwc
    _, protocol = fixture_for("gwc")
    wrong = [[INSTANCES[0][0][0] + 1]]
    proofs = [fx.proofs[0], E.corrupt(fx.proofs[0]), fx.proofs[0]]
    instances = [fx.instances[0], fx.instances[0], wrong]
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device="cpu")
    out = fn(pack_proofs(proofs, "cpu"), pack_instances(instances, "cpu"))
    jax_out = jax_fn(JB.pack_proofs(proofs[:2]), JB.pack_instances(instances[:2]))
    assert_matches_jax({k: v[:1] for k, v in out.items()}, {k: v[:1] for k, v in jax_out.items()})
    assert out["ok"].tolist() == [True, False, True]
    assert np.asarray(jax_out["ok"]).tolist() == [True, False]
    good, bad_instance = decode_accumulator(out, 0), decode_accumulator(out, 2)
    assert bad_instance == jax_native_accumulator(protocol, "gwc", fx.svk, fx.proofs[0], wrong)
    assert jax_decide(fx.dk, *good)
    assert not jax_decide(fx.dk, *bad_instance)


def test_decides_and_transcripts_are_ported():
    """The pairing decide (test_torch_decide.py), the Poseidon transcript
    (test_torch_poseidon.py) and the IPA decide (test_torch_ipa.py) are
    ported: an unknown transcript is refused, and an IPA opening on a small
    key verifies and decides True."""
    import random

    from snark_verifier_tpu_torch.parallel.batch import build_ipa_verifier
    from snark_verifier_tpu_torch.pcs.ipa import IpaProvingKey

    fx = E.fixture()
    build_verifier(fx.protocol, fx.As, fx.svk, device="cpu", decide_dk=fx.dk)
    build_verifier(fx.protocol, fx.As, fx.svk, device="cpu", transcript_kind="poseidon")
    with pytest.raises(ValueError, match="transcript_kind"):
        build_verifier(fx.protocol, fx.As, fx.svk, device="cpu", transcript_kind="blake2b")
    pk = IpaProvingKey.rand(2, False, seed=3)
    opening = E.ipa_opening(pk, random.Random(4))
    out = build_ipa_verifier(pk.svk(), pk.dk(), "cpu")(*E.pack_ipa_openings([opening], "cpu"))
    assert out["ok"].tolist() == [True]


def test_ec_point_from_limbs_decodes_and_checks_the_curve():
    """The accumulator-in-instances path: 4 x 68-bit Fr limbs per coordinate
    compose to the Fq point, and an off-curve point clears ``ok``."""
    from snark_verifier_tpu.util import bn254
    from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader
    from snark_verifier_tpu_torch.ops.field import FQ

    x, y = bn254.g1_mul(bn254.G1_GEN, 12345)
    for y_value, ok in ((y, True), (y + 1, False)):
        loader = TorchLoader((2,), "cpu")
        limbs = [(v >> (68 * i)) & ((1 << 68) - 1) for v in (x, y_value) for i in range(4)]
        point = loader.ec_point_from_limbs([loader.load_const(v) for v in limbs], 4, 68).value
        assert list(FQ.decode(point.x)) == [x, x]
        assert list(FQ.decode(point.y)) == [y_value, y_value]
        assert loader.ok.tolist() == [ok, ok]
