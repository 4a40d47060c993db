"""The port's G1 ops (snark_verifier_tpu_torch/ops/curve.py)
against the JAX package's ops/curve.py (XLA path) and ops/curve_pallas.py
(the CPU branch of g1_add_t / g1_double_t runs the Pallas kernel bodies),
limb for limb, and the python-int oracle util/bn254."""

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ops import curve as JC
from snark_verifier_tpu.ops import curve_pallas as JCP
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops.convert import g1_from_numpy, g1_to_numpy

N = 12


def points(seed, n):
    rng = np.random.default_rng(seed)
    return [bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]


@pytest.fixture(scope="module")
def operands():
    """P, Q with the identity, P + P and P + (-P) among the rows, as affine
    ints; and R = P + Q from the JAX XLA add (projective, z != 1)."""
    ps, qs = points(1, N), points(2, N)
    ps[0], qs[1], qs[2], qs[3] = None, ps[1], bn254.g1_neg(ps[2]), None
    jp, jq = JC.g1_from_affine_ints(ps), JC.g1_from_affine_ints(qs)
    jr = JC._g1_add_xla(jp, jq)
    return ps, qs, jp, jq, jr


def assert_same_point(got, want):
    for g, w in zip(g1_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))


def transposed(p):
    return tuple(np.asarray(c).T for c in p)


def untransposed(p):
    return tuple(np.asarray(c).T for c in p)


@pytest.mark.parametrize("second_level", [False, True], ids=["affine_in", "projective_in"])
def test_g1_add_matches_jax_and_pallas_body(operands, second_level):
    ps, qs, jp, jq, jr = operands
    a = jr if second_level else jp
    want_xla = JC._g1_add_xla(a, jq)
    assert_same_point(C.g1_add(g1_from_numpy(a, "cpu"), g1_from_numpy(jq, "cpu")), want_xla)
    assert_same_point(C.g1_add_plain(g1_from_numpy(a, "cpu"), g1_from_numpy(jq, "cpu")), want_xla)
    want_body = untransposed(JCP.g1_add_t(transposed(a), transposed(jq)))
    assert_same_point(C.g1_add(g1_from_numpy(a, "cpu"), g1_from_numpy(jq, "cpu")), want_body)
    if not second_level:
        got = C.g1_to_affine_ints(C.g1_add(g1_from_numpy(jp, "cpu"), g1_from_numpy(jq, "cpu")))
        assert got == [bn254.g1_add(p, q) for p, q in zip(ps, qs)]


@pytest.mark.parametrize("second_level", [False, True], ids=["affine_in", "projective_in"])
def test_g1_double_matches_jax_and_pallas_body(operands, second_level):
    ps, _, jp, _, jr = operands
    a = jr if second_level else jp
    got = C.g1_double(g1_from_numpy(a, "cpu"))
    assert_same_point(got, JC._g1_double_xla(a))
    assert_same_point(got, untransposed(JCP.g1_double_t(transposed(a))))
    if not second_level:
        assert C.g1_to_affine_ints(got) == [bn254.g1_double(p) for p in ps]


def test_add_select_matches_jax_and_pallas_body(operands):
    """cond ? P + Q : P, and the plain select, against the XLA composition
    and the CPU branch of g1_add_select_t (the _add_select_kernel body)."""
    _, _, jp, jq, jr = operands
    cond = np.arange(N) % 3 != 1
    p, q, r = g1_from_numpy(jp, "cpu"), g1_from_numpy(jq, "cpu"), g1_from_numpy(jr, "cpu")
    tcond = torch.as_tensor(cond)
    got = C.g1_add_select(tcond, r, q)
    assert_same_point(got, JC.g1_add_select(cond, jr, jq))
    mask = cond.astype(np.uint32)[None]
    assert_same_point(got, untransposed(JCP.g1_add_select_t(mask, transposed(jr), transposed(jq))))
    assert_same_point(C.g1_select(tcond, p, r), JC.g1_select(cond, jp, jr))


def test_normalize_on_curve_eq_tree_sum_match_jax(operands):
    ps, qs, jp, jq, jr = operands
    r = g1_from_numpy(jr, "cpu")
    assert_same_point(C.g1_normalize(r), JC.g1_normalize(jr))
    np.testing.assert_array_equal(C.g1_is_on_curve(r).numpy(), np.asarray(JC.g1_is_on_curve(jr)))
    off = C.G1(r.x, C.F.add(r.y, r.z, C.FQ), r.z)  # y + z: off the curve unless z = 0
    joff = JC.G1(jr.x, JC.F.add(jr.y, jr.z, JC.FQ), jr.z)
    np.testing.assert_array_equal(C.g1_is_on_curve(off).numpy(), np.asarray(JC.g1_is_on_curve(joff)))
    # eq: the projective sum against its normalized form, and against P
    norm = C.g1_normalize(r)
    np.testing.assert_array_equal(C.g1_eq(r, norm).numpy(), np.asarray(JC.g1_eq(jr, JC.g1_normalize(jr))))
    np.testing.assert_array_equal(C.g1_eq(r, g1_from_numpy(jp, "cpu")).numpy(), np.asarray(JC.g1_eq(jr, jp)))
    assert_same_point(C.g1_tree_sum(r, 0), JC.g1_tree_sum(jr, 0))
    assert_same_point(C.g1_neg(r), JC.g1_neg(jr))
    assert C.g1_to_affine_ints(C.G1(*(c[None] for c in C.g1_tree_sum(r, 0)))) == [
        bn254.g1_msm([1] * N, [bn254.g1_add(p, q) for p, q in zip(ps, qs)])
    ]
