"""The port's two-kernel small MSM (kernels K8 ``msm_window`` and K9
``msm_horner`` in snark_verifier_tpu_torch/ops/msm_cuda.py, composed by
``msm_windowed``) and the plain version of K4, their composition, against
the JAX package's ``_window_call`` and ``_horner_call`` (their CPU branch),
its ``msm_batched_fused`` and the python-int oracle, on the CPU.

The single kernels are compared limb for limb on the same table, carried
into the JAX package's slab layout (9 * 48, n * b_pad).  Whole MSMs are
compared in affine form: the JAX CPU path builds its tables by a scan of
adds, the port by the dbl/add ladder, so their projective representatives
differ.  Inputs come from numpy with a fixed seed.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_msm import case, fused_case

from snark_verifier_tpu.ops import msm_pallas as MP
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import msm as M
from snark_verifier_tpu_torch.ops import msm_cuda as MK
from snark_verifier_tpu_torch.ops.convert import g1_from_numpy, limbs_to_tensor
from snark_verifier_tpu_torch.ops.curve import g1_add_plain

B, N = 3, 3
B_PAD = 128  # the JAX package's lane tier on the CPU


@pytest.fixture(scope="module")
def tables():
    """Tables of B = 3 proofs of N = 3 points (one identity), the port's
    ladder, and seeded signed digits with 0, 8 and -8 among them."""
    rng = np.random.default_rng(21)
    pts = [[None if (b, i) == (1, 2) else bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62)))
            for i in range(N)] for b in range(B)]
    g = C.g1_from_affine_ints([p for row in pts for p in row], "cpu")
    table = M.build_tables(C.G1(*(c.reshape(B, N, 16).transpose(0, 1) for c in g)))
    digits = torch.as_tensor(rng.integers(-8, 9, (B, N)), dtype=torch.int64)
    digits[0, 0], digits[1, 1], digits[2, 2] = 0, 8, -8
    return pts, table, digits


def to_slab(table):
    """(9, 3, n, B, 16) -> the JAX slab (9 * 48, n * B_PAD) uint32; padded
    lanes hold the identity in every entry (their digits are 0)."""
    ntab, _, n, batch, _ = table.shape
    ident = C.g1_identity((), "cpu")
    full = torch.stack([torch.stack(list(ident))] * ntab)  # (9, 3, 16)
    full = full[:, :, None, None, :].expand(ntab, 3, n, B_PAD, 16).clone()
    full[:, :, :, :batch] = table
    return jax.numpy.asarray(full.permute(0, 1, 4, 2, 3).reshape(ntab * 48, n * B_PAD).numpy().astype(np.uint32))


def from_rows(rows, batch):
    """JAX (48, B_PAD) -> three (batch, 16) int64 arrays."""
    rows = np.asarray(rows).astype(np.int64)
    return [rows[c * 16:(c + 1) * 16, :batch].T for c in range(3)]


def test_window_plain_matches_jax_window_call(tables):
    """K8's plain version and the JAX CPU branch of ``_window_call`` on the
    same table: the first selection starts the sum, so the projective
    triples agree limb for limb."""
    pts, table, digits = tables
    got = MK.msm_window(table, digits)
    assert all(torch.equal(g, w) for g, w in zip(got, MK.msm_window_plain(table, digits)))
    dig = np.zeros((N, 1, B_PAD), np.int32)
    dig[:, 0, :B] = digits.numpy().T
    with jax.disable_jit():  # eager: one add body per point, no scan compile
        want = MP._window_call(N, 1, to_slab(table), jax.numpy.asarray(dig), B_PAD)
    for g, w in zip(got, from_rows(want, B)):
        np.testing.assert_array_equal(g.numpy(), w)
    want_aff = [bn254.g1_msm([int(d) % bn254.R for d in row], p) for row, p in zip(digits.tolist(), pts)]
    assert C.g1_to_affine_ints(got) == want_aff


def test_horner_plain_matches_jax_horner_call(tables):
    """K9's plain version and the JAX CPU branch of ``_horner_call``: 16 acc
    + contrib with projective inputs (z != 1), limb for limb."""
    pts, table, digits = tables
    acc = MK.msm_window(table, digits)
    contrib = MK.msm_window(table, -digits)
    got = MK.msm_horner(acc, contrib)
    assert all(torch.equal(g, w) for g, w in zip(got, MK.msm_horner_plain(acc, contrib)))

    def rows(p):  # three (B, 16) -> the JAX (48, B_PAD) accumulator rows
        return np.pad(np.concatenate([c.numpy().T for c in p]).astype(np.uint32), ((0, 0), (0, B_PAD - B)))

    with jax.disable_jit():
        want = MP._horner_call(jax.numpy.asarray(rows(acc)), jax.numpy.asarray(rows(contrib)), B_PAD)
    for g, w in zip(got, from_rows(want, B)):
        np.testing.assert_array_equal(g.numpy(), w)
    a, c = C.g1_to_affine_ints(acc), C.g1_to_affine_ints(contrib)
    assert C.g1_to_affine_ints(got) == [bn254.g1_add(bn254.g1_mul(x, 16), y) for x, y in zip(a, c)]


def test_scan_plain_matches_jax_window_horner_composition():
    """K4's plain version against the JAX package's fused MSM on the CPU,
    which composes ``_window_call`` and ``_horner_call`` over the windows
    (from the identity, most significant first), limb for limb: 9 signed
    windows, B = 3 proofs of n = 8 terms (test_torch_msm.py's case), on the
    JAX CPU path's own table T_k = T_(k-1) + P (complete adds, K2's plain
    version)."""
    jg, scal, want, jax_out, jax_proj = fused_case()
    g = g1_from_numpy(jg, "cpu")
    p = C.G1(*(c.transpose(0, 1) for c in g))  # (n, B): point-major
    entries = [C.g1_identity(p.batch_shape, "cpu"), p]
    for _ in range(MK.NTAB - 2):
        entries.append(g1_add_plain(entries[-1], p))
    table = torch.stack([torch.stack(list(t)) for t in entries])
    digits = M.signed_digits(limbs_to_tensor(scal, "cpu"))[..., :9]
    got = MK.msm_scan(table, digits)
    for c, w in zip(got, jax_proj):
        np.testing.assert_array_equal(c.numpy(), w.astype(np.int64))
    assert C.g1_to_affine_ints(got) == jax_out == want


def test_scan_validates_and_picks_its_geometry(tables):
    """K4's wrapper refuses more than 64 windows and a proofs-per-block
    outside 1..8; ``scan_geometry`` takes the fewest proofs per block that
    keep 2 blocks per SM (at most 8), or the forced count."""
    _, table, digits = tables
    with pytest.raises(ValueError):
        MK.msm_scan(table, torch.zeros(B, N, 65, dtype=torch.int64))
    for per_block in (0, MK.MAX_PROOFS_PER_BLOCK + 1):
        with pytest.raises(ValueError):
            MK.msm_scan(table, digits.unsqueeze(-1), proofs_per_block=per_block)
    assert MK.scan_geometry(8, 132) == (1, 8)
    assert MK.scan_geometry(264, 132) == (1, 264)
    assert MK.scan_geometry(400, 132) == (2, 200)
    assert MK.scan_geometry(1820, 132) == (7, 260)
    assert MK.scan_geometry(5000, 132) == (8, 625)
    assert MK.scan_geometry(1820, 132, 1) == (1, 1820)


def test_msm_fused_mega_off_matches_jax_fused():
    """``msm_windowed`` (K8/K9's plain versions) on ``msm_batched``'s
    operands at 9 signed windows, B = 3 proofs of n = 8 terms
    (test_torch_msm.py's case) against the JAX package's fused MSM, which
    runs the same two kernels on the CPU, and the oracle, in affine form."""
    jg, scal, want, jax_out, _ = fused_case()
    got = MK.msm_windowed(*M.scan_inputs(g1_from_numpy(jg, "cpu"), limbs_to_tensor(scal, "cpu"), 9))
    assert C.g1_to_affine_ints(got) == jax_out == want


@pytest.mark.parametrize("n", [1, 3])
def test_msm_windowed_all_windows_matches_scan_and_oracle(n):
    """All 64 windows at B = 2: ``msm_windowed`` and ``msm_batched`` (K4's
    plain version) give the oracle's MSM (one term: a scalar
    multiplication)."""
    jg, scal, want = case(60 + n, 2, n)
    pts, s = g1_from_numpy(jg, "cpu"), limbs_to_tensor(scal, "cpu")
    assert C.g1_to_affine_ints(MK.msm_windowed(*M.scan_inputs(pts, s))) == want
    assert C.g1_to_affine_ints(M.msm_batched(pts, s)) == want


def test_window_and_horner_validate_and_route_cpu_to_plain(tables):
    _, table, digits = tables
    launches = (MK.msm_window.launches, MK.msm_horner.launches)
    acc = MK.msm_window(table, digits)
    MK.msm_horner(acc, acc)
    assert (MK.msm_window.launches, MK.msm_horner.launches) == launches  # CPU tensors launch nothing
    with pytest.raises(ValueError):
        MK.msm_window(table, digits[:, :2])
    with pytest.raises(ValueError):
        MK.msm_window(table.int(), digits)
    with pytest.raises(ValueError):
        MK.msm_horner(acc, C.G1(*(c[:2] for c in acc)))
