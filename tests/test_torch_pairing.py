"""The port's pairing (snark_verifier_tpu_torch/ops/pairing.py) against the
JAX package's flat Fq12 helpers of ops/pairing.py and the python-int
oracle (util/bn254.py), both of the JAX package: the Miller loop pair, the
final exponentiation by the Scott chain, and the KZG pairing check.  The
CPU runs the plain versions of the Miller-loop and final-exponentiation
kernels; the kernels themselves are held against them on the card by
chip_smoke.py.

The JAX package's kzg_pairing_check and its final-exponentiation stage take
tens of seconds to compile on the CPU, so the whole pairing is held against
the oracle, and the JAX side only through the flat helpers.  All values
are reduced field elements: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fixture import jax_data_protocol, jax_native_accumulator

from snark_verifier_tpu.ops import pairing as JP
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch import entry as E
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import pairing as P
from snark_verifier_tpu_torch.ops import tower as T


def rand_fq12(rng):
    return tuple(
        tuple(tuple(int.from_bytes(rng.bytes(32), "little") % bn254.P for _ in range(2)) for _ in range(3))
        for _ in range(2)
    )


def flat_encode(values):
    """List of oracle Fq12 values -> flat (12, B, 16) int64 Montgomery limbs."""
    comps = [[v[l][j][c] for v in values] for l in range(2) for j in range(3) for c in range(2)]
    return torch.as_tensor(F.FQ.encode(comps).astype(np.int64))


def flat_decode(flat):
    v = F.FQ.decode(flat)  # (12, B) ints
    return [
        tuple(tuple((int(v[l * 6 + j * 2, i]), int(v[l * 6 + j * 2 + 1, i])) for j in range(3)) for l in range(2))
        for i in range(flat.shape[1])
    ]


@pytest.fixture(scope="module")
def fq12_values():
    rng = np.random.default_rng(7)
    return [rand_fq12(rng) for _ in range(2)]


def test_flat_helpers_match_jax(fq12_values):
    x = flat_encode(fq12_values)
    y = flat_encode(fq12_values[::-1])
    jx, jy = jnp.asarray(x.numpy().astype(np.uint32)), jnp.asarray(y.numpy().astype(np.uint32))
    np.testing.assert_array_equal(P._mul_flat(x, y).numpy(), np.asarray(JP._mul_flat(jx, jy)))
    np.testing.assert_array_equal(P._conj_flat(x).numpy(), np.asarray(JP._conj_flat(jx)))
    for power in (1, 2):
        got = P._frob_flat(x, power).numpy()
        np.testing.assert_array_equal(got, np.asarray(JP._frob_flat(jx, jnp.int32(power - 1))))
        assert flat_decode(torch.as_tensor(got)) == [bn254.fq12_frob(v, power) for v in fq12_values]


def test_line_constants_match_jax():
    fx = E.fixture()
    for q in (fx.dk.g2, bn254.g2_neg(fx.dk.s_g2)):
        assert P._line_constants(P._g2_key(q)) == JP._line_constants(JP._g2_key(q))


def test_miller_loop_pair_matches_oracle():
    """The Miller-loop kernel's plain version (the step loop) at B = 2."""
    fx = E.fixture()
    rng = np.random.default_rng(11)
    ps = [bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(4)]
    q1, q2 = fx.dk.g2, bn254.g2_neg(fx.dk.s_g2)
    aff = C.g1_from_affine_ints(ps, "cpu")
    f1, f2 = P.miller_loop_pair_plain(aff.x[:2], aff.y[:2], aff.x[2:], aff.y[2:], q1, q2)
    assert flat_decode(f1) == [bn254.miller_loop(p, q1) for p in ps[:2]]
    assert flat_decode(f2) == [bn254.miller_loop(p, q2) for p in ps[2:]]


def test_final_exponentiation_matches_oracle(fq12_values):
    """The final-exponentiation kernel's plain version (``_combine`` and the
    chain) on three rows: v0 * v1; v1 with an identity lhs (its value
    replaced by one); both inputs the identity (one)."""
    one = ((1, 0), (0, 0), (0, 0)), ((0, 0), (0, 0), (0, 0))
    v0, v1 = fq12_values
    got = P.final_exponentiation_plain(flat_encode([v0, v0, v0]), flat_encode([v1, v1, v1]),
                                       torch.tensor([False, True, True]), torch.tensor([False, False, True]))
    chain = bn254.final_exponentiation_chain
    assert flat_decode(got) == [chain(bn254.fq12_mul(v0, v1)), chain(v1), one]
    assert T.fq12_is_one(T.fq12_from_flat(got[:, 2:])).tolist() == [True]


def test_pairing_wrappers_route_cpu_to_plain_and_validate(monkeypatch):
    """``miller_loop_pair`` and ``final_exponentiation`` hand CPU tensors to
    their plain versions and count no launch; they refuse bad shapes and
    types."""
    calls = []
    monkeypatch.setattr(P, "miller_loop_pair_plain", lambda *a: calls.append("miller") or "m")
    monkeypatch.setattr(P, "final_exponentiation_plain", lambda *a: calls.append("final") or "f")
    launches = (P.miller_loop_pair.launches, P.final_exponentiation.launches)
    xy = torch.zeros(2, 16, dtype=torch.int64)
    f = torch.zeros(12, 2, 16, dtype=torch.int64)
    mask = torch.zeros(2, dtype=torch.bool)
    assert P.miller_loop_pair(xy, xy, xy, xy, None, None) == "m"
    assert P.final_exponentiation(f, f, mask, mask) == "f"
    assert calls == ["miller", "final"]
    assert (P.miller_loop_pair.launches, P.final_exponentiation.launches) == launches
    with pytest.raises(ValueError):
        P.miller_loop_pair(xy, xy, xy[:1], xy[:1], None, None)
    with pytest.raises(ValueError):
        P.miller_loop_pair(xy.int(), xy.int(), xy.int(), xy.int(), None, None)
    with pytest.raises(ValueError):
        P.final_exponentiation(f[:6], f[:6], mask, mask)
    with pytest.raises(ValueError):
        P.final_exponentiation(f, f, mask.long(), mask)
    with pytest.raises(ValueError):
        P.final_exponentiation(f, f, mask[:1], mask[:1])


def test_kzg_pairing_check_good_wrong_and_identity_rows():
    """Rows: a good accumulator (True), the wrong-instance one (False), both
    sides the identity (True: e = 1), and an identity lhs beside a real rhs
    (False); each as the JAX package's oracle decides it."""
    fx = E.fixture()
    good = jax_native_accumulator(jax_data_protocol(), "gwc", fx.svk, fx.proofs[0], fx.instances[0])
    wrong = jax_native_accumulator(jax_data_protocol(), "gwc", fx.svk, fx.proofs[0], [[fx.instances[0][0][0] + 1]])
    rows = [good, wrong, (None, None), (None, good[1])]
    # doubled, so the inputs are projective with z != 1; e(2L, g2) e(2R, -s g2)
    # is the square of the undoubled product, which is 1 exactly when it is
    lhs = C.g1_double(C.g1_from_affine_ints([r[0] for r in rows], "cpu"))
    rhs = C.g1_double(C.g1_from_affine_ints([r[1] for r in rows], "cpu"))
    got = P.kzg_pairing_check(lhs, rhs, fx.dk.g2, fx.dk.s_g2)
    neg_s_g2 = bn254.g2_neg(fx.dk.s_g2)
    want = [bn254.pairing_check([(bn254.g1_double(l), fx.dk.g2), (bn254.g1_double(r), neg_s_g2)]) for l, r in rows]
    assert got.tolist() == want == [True, False, True, False]
