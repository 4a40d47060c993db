"""The port's large MSM (snark_verifier_tpu_torch/ops/msm.py msm_serial and
its parts; kernels K5 and K6 through their plain versions) against the JAX
package's ops/msm.py and ops/curve.py on the CPU, and its python-int oracle.

The JAX package's jitted msm_serial takes minutes to compile on the CPU, so
the whole MSM is held against the oracle, and against the JAX package part
by part: the digit decompositions, one run of the bucket accumulation
(``_bucket_totals``) at a small shape, the Horner combine and the fused add
with a select, all limb for limb.  Tolerance 0 everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_verifier_tpu.ops import curve as JC
from snark_verifier_tpu.ops import msm as JM
from snark_verifier_tpu.ops.limbs import ints_to_limbs
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import msm as M
from snark_verifier_tpu_torch.ops import msm_cuda as MK
from snark_verifier_tpu_torch.ops.convert import g1_from_numpy, g1_to_numpy, ints_to_tensor


def rand_case(seed, n):
    rng = np.random.default_rng(seed)
    pts = [bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(n)]
    return pts, scalars


def assert_limbs(got, want):
    for g, w in zip(g1_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))


def port_msm(pts, scalars, window, signed=False):
    out = M.msm_serial(C.g1_from_affine_ints(pts, "cpu"), ints_to_tensor(scalars, "cpu"), window, signed)
    return C.g1_to_affine_ints(C.G1(*(c[None] for c in out)))[0]


CASES = {
    # name: (seed, n, window, signed, edit)
    "w4_n37": (1, 37, 4, False, None),  # n not a power of two (window 8: test_torch_decide.py)
    "w5_signed_straddling": (2, 9, 5, True, None),  # windows straddle 16-bit limbs
    "equal_points_collide": (3, 6, 5, False, "collide"),
    "all_equal_scalars": (4, 50, 5, True, "all_equal"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_msm_serial_matches_oracle(name):
    seed, n, window, signed, edit = CASES[name]
    pts, scalars = rand_case(seed, n)
    if edit == "collide":
        pts = [pts[0]] * n
        scalars = [7, 7, 7, 9, 9, bn254.R - 1]
    elif edit == "all_equal":
        scalars = [123456789] * n  # one giant digit run per window
    scalars[0] = 0 if edit is None else scalars[0]
    assert port_msm(pts, scalars, window, signed) == bn254.g1_msm(scalars, pts)


@pytest.mark.parametrize("window,signed", [(8, False), (5, False), (5, True), (11, True)])
def test_window_digits_match_jax(window, signed):
    _, scalars = rand_case(5, 12)
    scalars[:3] = [0, 1, bn254.R - 1]
    limbs = ints_to_limbs(scalars)
    nwin = (256 + window - 1) // window
    t = ints_to_tensor(scalars, "cpu")
    if signed:
        got, want = M.signed_digits(t, window, nwin), JM._signed_window_digits(jnp.asarray(limbs), window, nwin)
        for s, row in zip(scalars, got.tolist()):
            assert sum(d << (window * w) for w, d in enumerate(row)) == s
    else:
        got, want = M.window_digits(t, window, nwin), JM._window_digits(jnp.asarray(limbs), window, nwin, 1 << window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_bucket_totals_match_jax_limb_for_limb():
    """One whole bucket accumulation (sort, tree, flushes, suffix scan, tree
    sum) at nwin = 3 windows of n = 8 points, signed 2-bit digits (3
    buckets) with runs that straddle pair boundaries, one run over a whole
    window, zero digits and negated points."""
    pts, _ = rand_case(6, 7)
    pts.append(None)  # an identity pad point
    dig = np.array([[1, 1, 1, 0, 2, 2, 1, 0], [2, 2, 2, 2, 2, 2, 2, 2], [2, 0, 1, 2, 2, 1, 1, 2]], np.uint32)
    neg = np.array([[0, 1, 0, 0, 1, 1, 0, 0], [1, 0, 1, 0, 1, 0, 1, 0], [0, 0, 0, 1, 1, 0, 0, 0]], bool)
    jp = JC.g1_from_affine_ints(pts)
    want = JM._bucket_totals(jp, jnp.asarray(dig), 3, jnp.asarray(neg))
    got = M._bucket_totals(g1_from_numpy(jp, "cpu"), torch.as_tensor(dig.astype(np.int64)), 3, torch.as_tensor(neg))
    assert_limbs(got, want)


def test_horner_combine_plain_matches_jax_limb_for_limb():
    pts, _ = rand_case(7, 5)
    jt = JC.g1_from_affine_ints(pts)
    want = JM._horner_combine(jt, 5)
    got = M._horner_combine(g1_from_numpy(jt, "cpu"), 5)
    assert_limbs(got, want)
    batched = MK.horner_combine(C.G1(*(torch.stack([c, c.flip(0)]) for c in g1_from_numpy(jt, "cpu"))), 5)
    assert_limbs(C.G1(*(c[0] for c in batched)), want)
    assert C.g1_to_affine_ints(C.G1(*(c[1:] for c in batched))) == [
        bn254.g1_msm([1 << (5 * w) for w in range(5)], pts[::-1])
    ]
    assert MK.horner_combine.launches == 0
    with pytest.raises(ValueError):
        MK.horner_combine(C.G1(*(c[0] for c in batched)), 5)


def test_paired_horner_combine_matches_single_msms_and_jax(monkeypatch):
    """The decide's form: msm_serial_many (two point sets, one scalar set,
    their window totals stacked into one Horner combine, one K6 launch on
    the card) equals two single msm_serial results limb for limb, the JAX
    package's Horner combine (the last step of its msm_serial) on the same
    totals, and the oracle.  Small size: n = 4, window 4."""
    window, signed = 4, False
    (pts_a, scalars), (pts_b, _) = rand_case(11, 4), rand_case(12, 4)
    sets = [C.g1_from_affine_ints(pts, "cpu") for pts in (pts_a, pts_b)]
    scal = ints_to_tensor(scalars, "cpu")
    totals, real = [], M.window_totals
    monkeypatch.setattr(M, "window_totals", lambda *a: totals.append(real(*a)) or totals[-1])
    paired = M.msm_serial_many(sets, scal, window, signed)
    singles = [M.msm_serial(p, scal, window, signed) for p in sets]
    for got, want in zip(paired, singles):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    jax_totals = JC.G1(*(jnp.asarray(c) for c in g1_to_numpy(totals[0])))  # one set: each JAX scan compiles anew
    assert_limbs(paired[0], JM._horner_combine(jax_totals, window))
    assert [C.g1_to_affine_ints(C.G1(*(c[None] for c in got)))[0] for got in paired] == [
        bn254.g1_msm(scalars, pts) for pts in (pts_a, pts_b)
    ]
    assert MK.horner_combine.launches == 0


def test_g1_add_select_plain_matches_jax_limb_for_limb():
    """Random mask over identity, P + P, P + (-P) and generic rows, with a
    projective (z != 1) first operand."""
    pts, _ = rand_case(8, 6)
    ps = [None, pts[1], pts[2], pts[3], pts[4], pts[5]]
    qs = [pts[0], pts[1], bn254.g1_neg(pts[2]), None, pts[0], pts[1]]
    cond = np.array([True, True, True, True, False, True])
    jp, jq = JC.g1_from_affine_ints(ps), JC.g1_from_affine_ints(qs)
    jp = JC.g1_add(jp, jq)
    want = JC.g1_add_select(jnp.asarray(cond), jp, jq)
    p, q, c = g1_from_numpy(jp, "cpu"), g1_from_numpy(jq, "cpu"), torch.as_tensor(cond)
    assert_limbs(C.g1_add_select(c, p, q), want)
    assert_limbs(C.g1_add_select_plain(c, p, q), want)
    assert C.g1_add_select.launches == 0
    with pytest.raises(ValueError):
        C.g1_add_select(c.long(), p, q)


def test_tree_sum_matches_jax_limb_for_limb():
    pts, _ = rand_case(9, 7)
    jp = JC.g1_from_affine_ints(pts)
    assert_limbs(C.g1_tree_sum(g1_from_numpy(jp, "cpu")), JC.g1_tree_sum(jp))


def test_flush_invariant_check(monkeypatch):
    """With the check on, msm_serial runs it at every level and passes; it
    rejects unsorted runs and a run with two completion markers."""
    monkeypatch.setattr(M, "CHECK_FLUSH", True)
    calls = []
    real = M._check_flush_invariant
    monkeypatch.setattr(M, "_check_flush_invariant", lambda s, v: (calls.append(1), real(s, v)))
    pts, scalars = rand_case(10, 5)
    assert port_msm(pts, scalars, 4) == bn254.g1_msm(scalars, pts)
    assert len(calls) == 4  # 3 tree levels at n = 8, then the last runs
    seg = torch.tensor([[1, 1, 2, 3]])
    real(seg, torch.tensor([[False, True, True, True]]))
    with pytest.raises(AssertionError, match="sorted"):
        real(torch.tensor([[2, 1, 3, 3]]), torch.tensor([[True, False, False, True]]))
    with pytest.raises(AssertionError, match="more than one"):
        real(seg, torch.tensor([[True, True, False, False]]))


# -- the chunked and the row-batched large MSM -------------------------------

CHUNK_GRID = [
    (n, window, signed, chunk)
    for n in (37, 64)
    for window in (4, 8)
    for signed in (False, True)
    for chunk in range(1, 256 // window + 1)
    if (256 // window) % chunk == 0
]


def row_stand_in(pts_pad, dig, nbuckets, neg=None):
    """A cheap stand-in for ``_bucket_totals`` that is row-wise like it: each
    digit row's "total" is a limb pattern of that row's digits and signs
    alone, so any split of the rows into chunks must give the same totals
    in the same order."""
    sign = 1 - 2 * neg.long() if neg is not None else 1
    key = (dig * sign * torch.arange(1, dig.shape[1] + 1)).sum(1, keepdim=True) + nbuckets
    limbs = key * torch.arange(1, 17) % 65521
    return C.G1(limbs, limbs + 1, limbs + 2)


def horner_stand_in(totals, window):
    """A cheap stand-in for the Horner combine (K6) that weighs each
    window's "total" by its place, so the windows' order counts."""
    w = torch.arange(1, totals.x.shape[-2] + 1).unsqueeze(-1) * (window + 1)
    return C.G1(*((c * w).sum(-2) % 2147483647 for c in totals))


@pytest.mark.parametrize("n,window,signed,chunk", CHUNK_GRID)
def test_msm_serial_chunked_orders_its_chunks(monkeypatch, n, window, signed, chunk):
    """Every ``win_chunk`` that divides the window count, at n = 37 (padded)
    and 64, windows 4 and 8, signed and unsigned: the chunked MSM's limbs
    equal ``msm_serial``'s with the bucket accumulation and the Horner
    combine replaced by cheap stand-ins (row-wise and order-sensitive) in
    both, so each case holds the chunking itself: the padding, the digit
    and sign rows of each chunk, their order, ``nwin / win_chunk`` bucket
    calls and one Horner combine.  The real computation under chunking: the
    next tests."""
    pts, scalars = rand_case(20 + n, n)
    g, s = C.g1_from_affine_ints(pts, "cpu"), ints_to_tensor(scalars, "cpu")
    calls, horners = [], []
    monkeypatch.setattr(M, "_bucket_totals", lambda *a: calls.append(a[1].shape[0]) or row_stand_in(*a))
    monkeypatch.setattr(MK, "horner_combine", lambda t, w: horners.append(t.x.shape) or horner_stand_in(t, w))
    want = M.msm_serial(g, s, window, signed)
    assert calls == [256 // window] and horners == [(1, 256 // window, 16)]
    calls.clear()
    got = M.msm_serial_chunked(g, s, window, chunk, signed)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert calls == [chunk] * (256 // window // chunk) and len(horners) == 2


@pytest.mark.parametrize("n,window,signed,chunk", [(37, 4, False, 16), (64, 4, True, 4), (37, 5, True, 13)])
def test_msm_serial_chunked_matches_msm_serial_and_oracle(n, window, signed, chunk):
    """The real chunked MSM, limb for limb against ``msm_serial``, and the
    oracle in affine: windows 4 and 5 (5 straddles the 16-bit limbs; 52
    windows in 4 chunks of 13), signed and unsigned, padded and not."""
    pts, scalars = rand_case(30 + n, n)
    scalars[1] = bn254.R - 1
    g, s = C.g1_from_affine_ints(pts, "cpu"), ints_to_tensor(scalars, "cpu")
    got = M.msm_serial_chunked(g, s, window, chunk, signed)
    assert_limbs(got, g1_to_numpy(M.msm_serial(g, s, window, signed)))
    assert C.g1_to_affine_ints(C.G1(*(c[None] for c in got))) == [bn254.g1_msm(scalars, pts)]


@pytest.mark.parametrize("signed", [False, True])
def test_msm_serial_chunked_matches_jax_chunked(monkeypatch, signed):
    """The JAX package's ``msm_serial_chunked`` (its CPU branch: digits,
    padding, one digit chunk at a time, totals concatenated, one Horner
    combine) with its two jitted steps routed to the port's
    ``_bucket_totals`` and ``_horner_combine`` (their jit compiles take
    minutes on the CPU; both are held against the JAX package's own limb for
    limb above): the chunks it cuts equal the port's, and both results equal
    the oracle in affine."""
    window, chunk, n = 4, 16, 37
    pts, scalars = rand_case(40, n)
    g, s = C.g1_from_affine_ints(pts, "cpu"), ints_to_tensor(scalars, "cpu")
    jax_chunks = []

    def chunk_totals(pts_pad, dchunk, nbuckets, nchunk=None):
        jax_chunks.append((np.asarray(dchunk).astype(np.int64), None if nchunk is None else np.asarray(nchunk)))
        neg = None if nchunk is None else torch.as_tensor(np.array(nchunk))
        out = M._bucket_totals(g1_from_numpy(pts_pad, "cpu"), torch.as_tensor(jax_chunks[-1][0]), nbuckets, neg)
        return JC.G1(*(jnp.asarray(c) for c in g1_to_numpy(out)))

    monkeypatch.setattr(JM, "_use_tree_t", lambda: False)
    monkeypatch.setattr(JM, "_chunk_totals", chunk_totals)
    monkeypatch.setattr(JM, "_horner_jit", lambda t, w: JC.G1(
        *(jnp.asarray(c) for c in g1_to_numpy(M._horner_combine(g1_from_numpy(t, "cpu"), w)))))
    jax_out = JM.msm_serial_chunked(JC.g1_from_affine_ints(pts), jnp.asarray(ints_to_limbs(scalars)), window, chunk,
                                    signed)
    dig, neg, _ = M._digit_rows(s, window, signed, 64)
    assert len(jax_chunks) == 256 // window // chunk
    for i, (d, ng) in enumerate(jax_chunks):
        np.testing.assert_array_equal(d, dig[i * chunk : (i + 1) * chunk].numpy())
        if signed:
            np.testing.assert_array_equal(ng, neg[i * chunk : (i + 1) * chunk].numpy())
    port = M.msm_serial_chunked(g, s, window, chunk, signed)
    assert_limbs(port, [np.asarray(c) for c in jax_out])
    assert C.g1_to_affine_ints(C.G1(*(c[None] for c in port))) == [bn254.g1_msm(scalars, pts)]


def test_msm_serial_rows_equals_msm_serial_per_row():
    """B = 3 scalar rows over one point set (a zero row among them), in
    chunks of 7 digit rows that straddle the scalar rows' boundaries: row i
    equals ``msm_serial(points, scalars[i])`` limb for limb (the zero row
    the identity), and the oracle in affine.  The default chunk (all rows
    at once at this size) runs in every IPA decide (test_torch_ipa.py)."""
    window = 4
    pts, scalars = rand_case(50, 37)
    g = C.g1_from_affine_ints(pts, "cpu")
    rows = torch.stack([ints_to_tensor(scalars, "cpu"), ints_to_tensor(scalars[::-1], "cpu"),
                        ints_to_tensor([0] * 37, "cpu")])
    got = M.msm_serial_rows(g, rows, window, win_chunk=7)
    assert got.x.shape == (3, 16)
    for i in (0, 1):
        assert_limbs(C.G1(*(c[i] for c in got)), g1_to_numpy(M.msm_serial(g, rows[i], window)))
    assert bool(C.g1_is_identity(C.G1(*(c[2] for c in got))))
    assert C.g1_to_affine_ints(got) == [bn254.g1_msm(scalars, pts), bn254.g1_msm(scalars[::-1], pts), None]


def test_msm_serial_chunked_refuses_a_chunk_that_does_not_divide():
    g = C.g1_from_affine_ints(rand_case(60, 3)[0], "cpu")
    s = ints_to_tensor([1, 2, 3], "cpu")
    for window, chunk in ((8, 3), (4, 5), (8, 0), (8, 64)):
        with pytest.raises(ValueError, match="win_chunk"):
            M.msm_serial_chunked(g, s, window, chunk)
    with pytest.raises(ValueError, match="scalars"):
        M.msm_serial_rows(g, s, 8)
