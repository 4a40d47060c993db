"""The port's batched small MSM (snark_verifier_tpu_torch/ops/msm.py,
msm_cuda.py) against the JAX package's ops/msm.py and ops/msm_pallas.py on
the CPU, and the python-int oracle.

Different table ladders give different projective representatives, so MSM
outputs are compared in affine form, except where the port runs the JAX
algorithm itself (``msm_batched_windowed``), which must match limb for limb.
"""

import numpy as np
import pytest
import shared

from snark_verifier_tpu.ops import curve as JC
from snark_verifier_tpu.ops import field_pallas as FP
from snark_verifier_tpu.ops import msm as JM
from snark_verifier_tpu.ops import msm_pallas as MP
from snark_verifier_tpu.ops.limbs import ints_to_limbs, limbs_to_int
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import msm as M
from snark_verifier_tpu_torch.ops import msm_cuda as MK
from snark_verifier_tpu_torch.ops.convert import g1_from_numpy, g1_to_numpy, limbs_to_tensor


def case(seed, B, n, scalar_bits=None):
    """Points (some identities) and scalars, as affine ints and limb arrays."""
    rng = np.random.default_rng(seed)
    pts = [
        [None if (b + i) % 5 == 4 else bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62))) for i in range(n)]
        for b in range(B)
    ]
    if scalar_bits is None:
        scalars = [[int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(n)] for _ in range(B)]
    else:
        scalars = [[int(rng.integers(0, 1 << scalar_bits)) for _ in range(n)] for _ in range(B)]
    scalars[0][0] = 0
    scalars[-1][-1] = 1
    jg = JC.g1_from_affine_ints([p for row in pts for p in row])
    jg = JC.G1(*(c.reshape(B, n, 16) for c in jg))
    scal = np.stack([ints_to_limbs(row) for row in scalars])
    want = [bn254.g1_msm(s, p) for p, s in zip(pts, scalars)]
    return jg, scal, want


def test_signed_digits_match_pallas():
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(33)] + [0, 1, bn254.R - 1]
    limbs = ints_to_limbs(vals)
    got = M.signed_digits(limbs_to_tensor(limbs, "cpu")).numpy()
    np.testing.assert_array_equal(got, np.asarray(MP.signed_digits(limbs)))
    assert got.min() >= -8 and got.max() <= 8
    for s, row in zip(vals, got):
        assert sum(int(v) << (4 * w) for w, v in enumerate(row)) == s


@shared.once_per_run
def fused_case():
    """B = 3 proofs of n = 8 terms with 32-bit scalars, and the JAX fused
    MSM's output at 9 signed windows (its test hook), run at the lane tier
    tests/test_msm_fused.py runs it at: (points as numpy limbs, scalars, the
    oracle's MSMs, the JAX output in affine form, its projective (x, y, z)
    as numpy)."""
    B, n = 3, 8
    jg, scal, want = case(100 * B + n, B, n, scalar_bits=32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FP, "LANES", 128)
        mp.setattr(FP, "FIXED_TOTAL", 128)
        MP.msm_batched_fused.clear_cache()
        try:
            out = MP.msm_batched_fused(jg, scal, 9)
        finally:
            MP.msm_batched_fused.clear_cache()
    return (tuple(np.asarray(c) for c in jg), scal, want, JC.g1_to_affine_ints(out),
            tuple(np.asarray(c) for c in out))


def test_msm_fused_matches_jax_fused():
    """9 signed windows (32-bit scalars), the JAX fused MSM's test hook, at
    B = 3 proofs of n = 8 terms."""
    jg, scal, want, jax_out, _ = fused_case()
    got = M.msm_batched(g1_from_numpy(jg, "cpu"), limbs_to_tensor(scal, "cpu"), 9)
    assert C.g1_to_affine_ints(got) == jax_out == want


@pytest.fixture(scope="module")
def full_width():
    """B = 2 proofs of 5 terms, full-width scalars, and the JAX XLA MSM."""
    jg, scal, want = case(11, 2, 5)
    return jg, scal, want, JM.msm_batched(jg, scal)


def test_msm_batched_matches_jax(full_width):
    jg, scal, want, jax_out = full_width
    got = M.msm_batched(g1_from_numpy(jg, "cpu"), limbs_to_tensor(scal, "cpu"))
    assert C.g1_to_affine_ints(got) == JC.g1_to_affine_ints(jax_out) == want


def test_msm_windowed_matches_jax_limb_for_limb(full_width):
    jg, scal, want, jax_out = full_width
    got = M.msm_batched_windowed(g1_from_numpy(jg, "cpu"), limbs_to_tensor(scal, "cpu"))
    for g, w in zip(g1_to_numpy(got), jax_out):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_msm_full_windows_oracle_and_scalar_mul():
    """All 64 windows at B = 2, n = 3, and scalar_mul, against the oracle;
    the scan's plain version on tables from the ladder."""
    jg, scal, want = case(12, 2, 3)
    pts, s = g1_from_numpy(jg, "cpu"), limbs_to_tensor(scal, "cpu")
    assert C.g1_to_affine_ints(M.msm_batched(pts, s)) == want
    one = C.G1(*(c[:, 1] for c in pts))
    got = M.scalar_mul(one, s[:, 1])
    assert C.g1_to_affine_ints(got) == [
        bn254.g1_mul(p, limbs_to_int(k)) for p, k in zip(C.g1_to_affine_ints(one), scal[:, 1])
    ]
    table = M.build_tables(C.G1(*(c.transpose(0, 1) for c in pts)))
    assert tuple(table.shape) == (MK.NTAB, 3, 3, 2, 16)
    assert C.g1_to_affine_ints(MK.msm_scan(table, M.signed_digits(s))) == want
