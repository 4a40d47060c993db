"""The port's Fq2/Fq6/Fq12 tower (snark_verifier_tpu_torch/ops/tower.py,
tower_cuda.py) against the JAX package's ops/tower.py and the CPU branch of
its fused Fq12 kernel (tower_pallas.fq12_mul_flat_pallas), and the oracle.

Batch 4, inputs seeded with numpy.  Tower values are reduced field
elements, so every comparison is limb for limb (tolerance 0).
"""

import jax
import numpy as np
import pytest
import torch

from snark_verifier_tpu.ops import tower as JT
from snark_verifier_tpu.ops import tower_pallas as JTP
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import tower as T

B = 4


def rand_fq(rng, shape):
    vals = np.array([int.from_bytes(rng.bytes(32), "little") % bn254.P for _ in range(int(np.prod(shape)))], object)
    return vals.reshape(shape)


def encode(ints):
    """Python ints (any nest, as a numpy object array) -> Montgomery limbs."""
    return F.FQ.encode(ints)


def tree_encode(vals, depth):
    """(..., B) object array of ints whose leading axes are the tower indices
    -> tuple tree of (B, 16) uint32 limb arrays."""
    if depth == 0:
        return encode(vals)
    return tuple(tree_encode(v, depth - 1) for v in vals)


def to_torch(tree):
    if isinstance(tree, tuple):
        return tuple(to_torch(t) for t in tree)
    return torch.as_tensor(np.asarray(tree).astype(np.int64))


def assert_same(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.fixture(scope="module")
def values():
    rng = np.random.default_rng(20261016)
    fq12 = [rand_fq(rng, (2, 3, 2, B)) for _ in range(2)]
    fq12[1][:, :, :, 0] = 0  # an all-zero row: the product and sum paths see zeros
    fq12[1][0, 0, 0, 0] = 1
    return [tree_encode(v, 3) for v in fq12]


def test_fq2_fq6_ops_match_jax(values):
    (a, b) = values
    a2, b2 = a[0][1], b[1][2]
    ta2, tb2 = to_torch(a2), to_torch(b2)
    assert_same(T.fq2_mul(ta2, tb2), JT.fq2_mul(a2, b2))
    assert_same(T.fq2_sqr(ta2), JT.fq2_sqr(a2))
    assert_same(T.fq2_inv(ta2), JT.fq2_inv(a2))
    assert_same(T.fq2_mul_xi(ta2), JT.fq2_mul_xi(a2))
    a6, b6 = a[1], b[0]
    ta6, tb6 = to_torch(a6), to_torch(b6)
    assert_same(T.fq6_mul(ta6, tb6), JT.fq6_mul(a6, b6))
    assert_same(T.fq6_sqr(ta6), JT.fq6_sqr(a6))
    assert_same(T.fq6_inv(ta6), JT.fq6_inv(a6))
    assert_same(T.fq6_mul_by_v(ta6), JT.fq6_mul_by_v(a6))


def test_fq12_ops_match_jax(values):
    a, b = values
    ta, tb = to_torch(a), to_torch(b)
    want = JT.fq12_mul(a, b)
    assert_same(T.fq12_mul(ta, tb), want)
    assert_same(T.fq12_mul_stacked(ta, tb), want)
    assert_same(T.fq12_sqr(ta), JT.fq12_sqr(a))
    assert_same(T.fq12_inv(ta), JT.fq12_inv(a))
    assert_same(T.fq12_conj(ta), JT.fq12_conj(a))
    for power in (1, 2, 3):
        assert_same(T.fq12_frob(ta, power), JT.fq12_frob(a, power, (B,)))
    assert T.fq12_is_one(T.fq12_ones((B,), "cpu")).tolist() == [True] * B
    assert T.fq12_is_one(ta).tolist() == np.asarray(JT.fq12_is_one(a, (B,))).tolist()
    assert_same(T.fq12_to_flat(ta), JT.fq12_to_flat(a))


def test_fq12_mul_matches_pallas_cpu_branch_and_oracle(values):
    """K7's plain version against the fused kernel's CPU branch (its body
    run as plain jnp) and the python-int oracle, at batch 4."""
    a, b = values
    xa, xb = JT.fq12_to_flat(a), JT.fq12_to_flat(b)
    want = JTP.fq12_mul_flat_pallas(xa, xb)
    ta, tb = to_torch(xa), to_torch(xb)
    got = T.fq12_mul_flat(ta, tb)
    assert_same(got, want)
    assert_same(T.fq12_mul_flat_plain(ta, tb), want)
    assert T.fq12_mul_flat.launches == 0  # CPU tensors never launch the kernel

    def ints(flat, i):
        v = F.FQ.decode(flat[:, i])
        return tuple(tuple((int(v[l * 6 + j * 2]), int(v[l * 6 + j * 2 + 1])) for j in range(3)) for l in range(2))

    for i in range(B):
        assert ints(got, i) == bn254.fq12_mul(ints(ta, i), ints(tb, i))


def test_fq12_mul_flat_validates():
    x = torch.zeros(12, 2, 16, dtype=torch.int64)
    with pytest.raises(ValueError):
        T.fq12_mul_flat(x[:6], x[:6])
    with pytest.raises(ValueError):
        T.fq12_mul_flat(x.int(), x.int())


@pytest.fixture(autouse=True, scope="module")
def _jax_on_cpu():
    assert jax.default_backend() == "cpu"
