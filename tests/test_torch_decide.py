"""The port's decide (snark_verifier_tpu_torch/entry.py decide_entry,
parallel/batch.py build_batch_decider and build_verifier(decide_dk=...),
TorchLoader.decide_pairing) on accumulators of the data-file fixture, on
the CPU, against the JAX package.

The JAX package's build_batch_decider folds with its jitted msm_serial and
decides with its staged pairing, which take minutes to compile on the CPU.
Its boolean is the KZG decide of the fold, so the port's boolean is held
against that fold and decide computed by the JAX package on the host, in
python ints: the fold sum_i s_i acc_i by its oracle MSM (util/bn254.g1_msm),
then its native KZG decide (pcs/kzg/decider.decide).  The accumulators are
the JAX package's native verifier's.  The fold's MSM and the pairing are
held against the JAX package's device code part by part in
test_torch_msm_large.py and test_torch_pairing.py.
"""

import numpy as np
import pytest
import torch
from test_torch_fixture import jax_data_protocol, jax_decide, jax_native_accumulator

from snark_verifier_tpu.ops.limbs import ints_to_limbs
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch import entry as E
from snark_verifier_tpu_torch.parallel.batch import (
    build_batch_decider,
    build_verifier,
    decode_accumulator,
    pack_instances,
    pack_proofs,
)

B = 8
WRONG_ROW = 5
KEYS = ("lhs_x", "lhs_y", "rhs_x", "rhs_y")


def jax_accumulator(fx, proof, instances):
    return jax_native_accumulator(jax_data_protocol(), fx.scheme, fx.svk, proof, instances)


def jax_batch_decide(fx, accs, fold):
    """The JAX package's batch decide on the host: both sides folded with the
    same scalars, then one KZG decide."""
    scalars = [sum(v << (16 * i) for i, v in enumerate(row)) for row in fold.tolist()]
    lhs = bn254.g1_msm(scalars, [a[0] for a in accs])
    rhs = bn254.g1_msm(scalars, [a[1] for a in accs])
    return jax_decide(fx.dk, lhs, rhs)


@pytest.fixture(scope="module")
def batch():
    """``entry.decide_entry`` on the CPU at B = 8 (4 unique proofs tiled):
    the decider, the accumulators and seeded fold scalars, each row equal to
    the JAX package's native accumulator.  The "wrong" case puts the JAX
    native accumulator of a wrong-instance proof at WRONG_ROW (only the
    decide sees a wrong instance)."""
    fx = E.fixture()
    decider, args = E.decide_entry("cpu", batch=B, seed=3)
    unique = [jax_accumulator(fx, p, ins) for p, ins in zip(fx.proofs, fx.instances)]
    good = dict(zip(KEYS, args[:4]))
    accs = {"good": [unique[i % len(unique)] for i in range(B)]}
    assert [decode_accumulator(good, i) for i in range(B)] == accs["good"]
    base = WRONG_ROW % len(fx.proofs)
    wrong_acc = jax_accumulator(fx, fx.proofs[base], [[fx.instances[base][0][0] + 1]])
    accs["wrong"] = list(accs["good"])
    accs["wrong"][WRONG_ROW] = wrong_acc
    coords = ints_to_limbs([wrong_acc[0][0], wrong_acc[0][1], wrong_acc[1][0], wrong_acc[1][1]])
    outs = {"good": good, "wrong": {k: v.clone() for k, v in good.items()}}
    for k, row in zip(KEYS, coords):
        outs["wrong"][k][WRONG_ROW] = torch.as_tensor(row.astype(np.int64))
    return fx, decider, outs, accs, args[4]


@pytest.mark.parametrize("case", ["good", "wrong"])
def test_batch_decider_matches_host(batch, case):
    fx, decider, outs, accs, fold = batch
    out = outs[case]
    got = decider(*(out[k] for k in KEYS), fold)
    assert [decode_accumulator(out, i) for i in range(B)] == accs[case]
    assert got.shape == () and bool(got) == jax_batch_decide(fx, accs[case], fold) == (case == "good")


def test_decider_rejects_inputs_on_another_device(batch):
    fx, _, outs, _, fold = batch
    decider = build_batch_decider(fx.dk, device="meta")
    with pytest.raises(ValueError):
        decider(*(outs["good"][k] for k in KEYS), fold)


def test_verifier_with_decide_dk_folds_the_pairing_into_ok():
    """Rows: a good proof, a corrupted one (off-curve commitment: the
    succinct half clears ok) and a wrong instance (only the pairing clears
    ok); ``ok`` equals the JAX package's native verifier and decide."""
    fx = E.fixture()
    proofs = [fx.proofs[1], E.corrupt(fx.proofs[2]), fx.proofs[3]]
    instances = [fx.instances[1], fx.instances[2], [[fx.instances[3][0][0] + 1]]]
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device="cpu", decide_dk=fx.dk)
    out = fn(pack_proofs(proofs, "cpu"), pack_instances(instances, "cpu"))
    want = []
    for proof, ins in zip(proofs, instances):
        try:
            want.append(jax_decide(fx.dk, *jax_accumulator(fx, proof, ins)))
        except Exception:  # the native transcript rejects the off-curve point
            want.append(False)
    assert out["ok"].tolist() == want == [True, False, False]


def test_decide_entry_defaults_to_the_card():
    import inspect

    from snark_verifier_tpu_torch.parallel.batch import build_ipa_verifier

    for fn in (E.entry, E.decide_entry, build_verifier, build_batch_decider, pack_proofs, pack_instances,
               build_ipa_verifier, E.pack_ipa_openings):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    from snark_verifier_tpu_torch.loader import EcPoint
    from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader
    from snark_verifier_tpu.pcs.ipa import h_coeffs
    from snark_verifier_tpu_torch.pcs.ipa import IpaAccumulator, IpaProvingKey

    assert inspect.signature(TorchLoader).parameters["device"].default == "cuda"
    # the IPA decide on the loader's device: a valid accumulator of a small key
    dk = IpaProvingKey.rand(2, False, seed=5).dk()
    xi = [3, 1 << 200, bn254.R - 1]
    loader = TorchLoader((1,), "cpu")
    acc = IpaAccumulator([loader.load_const(x) for x in xi[:2]],
                         loader.ec_point_load_const(bn254.g1_msm(h_coeffs(xi[:2], 1), dk.g)))
    assert isinstance(acc.u, EcPoint)
    ok = loader.decide_ipa(acc, dk)
    assert ok.device == loader.device and ok.tolist() == [True] and loader.ok.tolist() == [True]
