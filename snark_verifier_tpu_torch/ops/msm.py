"""Multi-scalar multiplication: the batched small MSM of the succinct verify
and the large single MSM of the decide.

Counterpart of ``snark_verifier_tpu/ops/msm.py``: ``msm_batched``,
``_msm_batched_xla``, ``scalar_mul`` and ``_digits`` (small MSM), and
``msm_serial`` with ``_window_digits``, ``_signed_window_digits``,
``_bucket_totals``, ``_g1_suffix_scan`` and ``_horner_combine`` (large MSM,
the JAX package's CPU reference layout), and ``msm_serial_chunked``, which
runs the windows ``win_chunk`` at a time.  Two batched forms end in ONE
Horner combine (one K6 launch): ``msm_serial_many`` runs several point sets
with one scalar set (the batch decide's two MSMs), ``msm_serial_rows`` one
point set with several scalar rows (the IPA decide's rows).  The TPU layout
of the large MSM (``_bucket_runs_t``: transposed bit-reversed slabs, lane
tiers) is not ported.

``msm_batched`` is the JAX package's ``msm_pallas.msm_batched_fused``: the
tables of ``build_tables`` and the balanced digits of ``signed_digits``,
then one call of ``msm_cuda.msm_scan`` (kernel K4 on CUDA tensors).  Both
MSMs take their digits from ``window_digits`` (unsigned) and
``signed_digits`` (balanced).  Kernels are reached as attributes of their
modules at call time, where the benchmark's wrappers find them.

Scalars enter in canonical (non-Montgomery) limb form.
"""

from __future__ import annotations

import math
import os

import torch

from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import msm_cuda
from snark_verifier_tpu_torch.ops.curve import G1
from snark_verifier_tpu_torch.ops.field import LIMB_BITS, NLIMB
from snark_verifier_tpu_torch.ops.msm_cuda import NWINDOWS, WINDOW

# Check the flush invariant of ``_bucket_totals`` at every tree level (one
# device-to-host read per level; off unless SVTPU_TORCH_CHECK_FLUSH=1).
CHECK_FLUSH = os.environ.get("SVTPU_TORCH_CHECK_FLUSH") == "1"


def window_digits(scalars_canon, window: int, nwin: int):
    """(..., 16) canonical limbs -> (..., nwin) unsigned ``window``-bit
    digits, least significant first.  A window that divides 16 is one
    shift-and-mask of every limb; any other is gathered digit by digit
    across the limbs it straddles."""
    mask = (1 << window) - 1
    if LIMB_BITS % window == 0:
        shifts = torch.arange(0, LIMB_BITS, window, dtype=torch.int64, device=scalars_canon.device)
        d = ((scalars_canon.unsqueeze(-1) >> shifts) & mask).reshape(*scalars_canon.shape[:-1], -1)
        return d if d.shape[-1] == nwin else d[..., :nwin]
    cols = []
    for w in range(nwin):
        limb, shift = divmod(w * window, LIMB_BITS)
        d = scalars_canon[..., limb] >> shift
        got, k = LIMB_BITS - shift, limb + 1
        while got < window and k < NLIMB:
            d = d | (scalars_canon[..., k] << got)
            got, k = got + LIMB_BITS, k + 1
        cols.append(d & mask)
    return torch.stack(cols, dim=-1)


def signed_digits(scalars_canon, window: int = WINDOW, nwin: int = NWINDOWS):
    """(..., 16) canonical limbs -> (..., nwin) int64 digits in
    [-(2^(w-1) - 1), 2^(w-1)], least significant first (K4's [-8, 8] at the
    default 4-bit windows).  Balanced recoding: a window above 2^(w-1)
    borrows 2^w from the next one, and the top window of a 254-bit scalar
    absorbs the last borrow."""
    raw = window_digits(scalars_canon, window, nwin)
    out = []
    carry = torch.zeros_like(raw[..., 0])
    for w in range(nwin):
        t = raw[..., w] + carry
        carry = (t > (1 << (window - 1))).long()
        out.append(t - (carry << window))
    return torch.stack(out, dim=-1)


def build_tables(points: G1) -> torch.Tensor:
    """T_k = k * P for k = 0..8 -> (9, 3, *points.batch_shape, 16).

    The ladder of msm_pallas.py:398-405: doublings for even k, one add of P
    for odd k (K2/K3 on CUDA tensors)."""
    p1 = points
    p2 = C.g1_double(p1)
    p3 = C.g1_add(p2, p1)
    p4 = C.g1_double(p2)
    p5 = C.g1_add(p4, p1)
    p6 = C.g1_double(p3)
    p7 = C.g1_add(p6, p1)
    p8 = C.g1_double(p4)
    t0 = C.g1_identity(points.batch_shape, points.x.device)
    return torch.stack([torch.stack(list(t)) for t in (t0, p1, p2, p3, p4, p5, p6, p7, p8)])


def scan_inputs(points: G1, scalars_canon, nwindows: int = NWINDOWS):
    """K4's operands for points batch (..., n) and scalars (..., n, 16)
    canonical: the tables (9, 3, n, B, 16) of the points laid out
    point-major (lane (i, b) is point i of proof b) and the balanced digits
    (B, n, nwindows), B the product of the leading dims.

    ``nwindows`` < 64 is a test hook, right only when every scalar is below
    2^(4 * nwindows - 1)."""
    n = points.batch_shape[-1]
    B = math.prod(points.batch_shape[:-1])
    pts = G1(*(c.reshape(B, n, NLIMB).transpose(0, 1) for c in points))
    return build_tables(pts), signed_digits(scalars_canon.reshape(B, n, NLIMB), WINDOW, nwindows)


def msm_batched(points: G1, scalars_canon, nwindows: int = NWINDOWS) -> G1:
    """Batched small MSM: points batch (..., n), scalars (..., n, 16)
    canonical -> point batch (...,).  ``scan_inputs``, then
    ``msm_cuda.msm_scan``: kernels K2, K3 and K4 on CUDA tensors, their
    plain versions on CPU tensors."""
    acc = msm_cuda.msm_scan(*scan_inputs(points, scalars_canon, nwindows))
    return G1(*(c.reshape(*points.batch_shape[:-1], NLIMB) for c in acc))


def msm_batched_windowed(points: G1, scalars_canon) -> G1:
    """The JAX package's reference algorithm (``_msm_batched_xla``): unsigned
    4-bit windows over a 16-entry table built by repeated adds, a tree sum of
    the picked entries per window.  Same point operations in the same order,
    so its output matches the JAX function limb for limb."""
    table = [C.g1_identity(points.batch_shape, points.x.device), points]
    for _ in range((1 << WINDOW) - 2):
        table.append(C.g1_add(table[-1], points))
    table = [torch.stack([t[c] for t in table]) for c in range(3)]  # 3 x (16, ..., n, 16)
    digits = window_digits(scalars_canon, WINDOW, NWINDOWS)
    acc = C.g1_identity(points.batch_shape[:-1], points.x.device)
    for w in range(NWINDOWS - 1, -1, -1):
        for _ in range(WINDOW):
            acc = C.g1_double(acc)
        idx = digits[..., w].unsqueeze(0).unsqueeze(-1).expand(1, *digits.shape[:-1], NLIMB)
        picked = G1(*(t.gather(0, idx).squeeze(0) for t in table))
        acc = C.g1_add(acc, C.g1_tree_sum(picked, dim=picked.x.dim() - 2))
    return acc


def scalar_mul(point: G1, scalar_canon) -> G1:
    """Windowed scalar multiplication, batched over leading dims."""
    p = G1(*(c.unsqueeze(-2) for c in point))
    return msm_batched(p, scalar_canon.unsqueeze(-2))


# ---------------------------------------------------------------------------
# Large-N Pippenger (one MSM): sort + pairwise tree bucket accumulation.
# ---------------------------------------------------------------------------


def msm_serial(points: G1, scalars_canon, window: int = 8, signed: bool = False) -> G1:
    """One large MSM: sum_i s_i P_i over n points (n,) with scalars (n, 16)
    canonical.  Window-parallel Pippenger (the JAX package's ``msm_serial``):
    all ceil(256 / window) windows run as one leading axis, the bucket sums
    come from a pairwise tree over each window's sorted digit runs
    (``window_totals``), then the Horner combine across windows (kernel
    K6).  Signed windows halve the buckets; the digit's sign negates the
    point.  Working set ~ (nwin, n) points."""
    return _horner_combine(window_totals(points, scalars_canon, window, signed), window)


def msm_serial_chunked(points: G1, scalars_canon, window: int = 8, win_chunk: int = 8, signed: bool = False) -> G1:
    """``msm_serial`` with the windows' bucket totals computed ``win_chunk``
    windows at a time (the JAX package's ``msm_serial_chunked``, its CPU
    layout): the digits and the padded points once, ``_bucket_totals`` on
    each chunk of rows of the digit matrix, then one Horner combine (one K6
    launch).  Each window row is sorted and reduced on its own against the
    shared point table, so the limbs equal ``msm_serial``'s; the working
    set is ~(win_chunk, n) points instead of (nwin, n).  ``win_chunk`` must
    divide the window count."""
    nwin = _window_count(window)
    if win_chunk < 1 or nwin % win_chunk:
        raise ValueError(f"win_chunk must divide the window count {nwin}, got {win_chunk}")
    pts_pad = _pad_points(points)
    dig, neg, nbuckets = _digit_rows(scalars_canon, window, signed, pts_pad.x.shape[0])
    return _horner_combine(_chunked_totals(pts_pad, dig, neg, nbuckets, win_chunk), window)


# Default digit rows per ``_bucket_totals`` call of ``msm_serial_rows``:
# rows x padded points stays at 2^22, 4 rows of a 2^20-point MSM (~0.6 GB
# of device memory per row at 2^20, with the shared point table).
ROWS_POINTS = 1 << 22


def msm_serial_rows(points: G1, scalars_canon_rows, window: int = 8, signed: bool = False,
                    win_chunk: int | None = None) -> G1:
    """B large MSMs over ONE point set (n,) with per-row scalars (B, n, 16)
    canonical -> point batch (B,): the IPA decide's shape.  The points are
    padded once; the (row, window) pairs flatten into the digit matrix's
    row axis, (B * nwin, n), whose bucket totals run ``win_chunk`` rows at
    a time (default: ``ROWS_POINTS`` // n) against the shared point table;
    then ONE Horner combine (one K6 launch) over the (B, nwin) totals.  Row
    i equals ``msm_serial(points, scalars_canon_rows[i])`` limb for limb."""
    if scalars_canon_rows.dim() != 3 or scalars_canon_rows.shape[0] < 1:
        raise ValueError(f"scalars must be (B >= 1, n, {NLIMB}), got {tuple(scalars_canon_rows.shape)}")
    pts_pad = _pad_points(points)
    n = pts_pad.x.shape[0]
    rows = [_digit_rows(s, window, signed, n) for s in scalars_canon_rows]
    dig = torch.cat([r[0] for r in rows])
    neg = torch.cat([r[1] for r in rows]) if signed else None
    del rows
    if win_chunk is None:
        win_chunk = max(1, ROWS_POINTS // n)
    totals = _chunked_totals(pts_pad, dig, neg, _bucket_count(window, signed), win_chunk)
    batch = scalars_canon_rows.shape[0]
    return msm_cuda.horner_combine(G1(*(c.reshape(batch, -1, NLIMB) for c in totals)), window)


def msm_serial_many(point_sets, scalars_canon, window: int = 8, signed: bool = False) -> list:
    """``msm_serial`` of each point set (each (n,)) with the same scalars:
    each set's window totals, then ONE Horner combine (one K6 launch) over
    the stacked (len(point_sets), nwin) totals.  Each result equals
    ``msm_serial``'s limb for limb."""
    totals = [window_totals(p, scalars_canon, window, signed) for p in point_sets]
    out = msm_cuda.horner_combine(G1(*(torch.stack(c) for c in zip(*totals))), window)
    return [G1(*(c[i] for c in out)) for i in range(len(point_sets))]


def window_totals(points: G1, scalars_canon, window: int = 8, signed: bool = False) -> G1:
    """The per-window bucket totals (nwin,) of ``msm_serial``: digits, the
    points padded to a power of two with identities, ``_bucket_totals``."""
    pts_pad = _pad_points(points)
    dig, neg, nbuckets = _digit_rows(scalars_canon, window, signed, pts_pad.x.shape[0])
    return _bucket_totals(pts_pad, dig, nbuckets, neg)


def _window_count(window: int) -> int:
    return (NLIMB * LIMB_BITS + window - 1) // window


def _bucket_count(window: int, signed: bool) -> int:
    return (1 << (window - 1)) + 1 if signed else 1 << window


def _pad_points(points: G1) -> G1:
    """The points (n,) padded with identities to a power of two."""
    n_orig = points.x.shape[0]
    n = 1 << max(0, n_orig - 1).bit_length()
    pad = C.g1_identity((n - n_orig,), points.x.device)
    return G1(*(torch.cat([c, e]) for c, e in zip(points, pad)))


def _digit_rows(scalars_canon, window: int, signed: bool, n: int):
    """Scalars (n_orig, 16) -> the digit matrix (nwin, n), zero on the
    padding, the sign mask (nwin, n) of signed digits (None unsigned), and
    the bucket count."""
    n_orig = scalars_canon.shape[0]
    dev = scalars_canon.device
    nwin = _window_count(window)
    dig = torch.zeros(nwin, n, dtype=torch.int64, device=dev)
    neg = None
    if signed:
        sd = signed_digits(scalars_canon, window, nwin)
        dig[:, :n_orig] = sd.abs().T
        neg = torch.zeros(nwin, n, dtype=torch.bool, device=dev)
        neg[:, :n_orig] = (sd < 0).T
    else:
        dig[:, :n_orig] = window_digits(scalars_canon, window, nwin).T
    return dig, neg, _bucket_count(window, signed)


def _chunked_totals(pts_pad: G1, dig, neg, nbuckets: int, rows: int) -> G1:
    """``_bucket_totals`` over ``rows`` rows of the digit matrix at a time,
    the totals concatenated in row order."""
    parts = [
        _bucket_totals(pts_pad, dig[lo : lo + rows], nbuckets, None if neg is None else neg[lo : lo + rows])
        for lo in range(0, dig.shape[0], rows)
    ]
    return G1(*(torch.cat(c) for c in zip(*parts)))


def _check_flush_invariant(seg_e, valid) -> None:
    """The invariant ``_flush_into`` relies on: each row of ``seg_e`` is
    sorted, so a digit's run is contiguous, and holds at most one valid
    (completed-run) marker.  Raises AssertionError when it does not hold."""
    if bool((seg_e[:, 1:] < seg_e[:, :-1]).any()):
        raise AssertionError("flush invariant: digit runs are not sorted")
    counts = torch.zeros(seg_e.shape[0], int(seg_e.max()) + 1, dtype=torch.int64, device=seg_e.device)
    counts.scatter_add_(1, seg_e, valid.long())
    if bool((counts > 1).any()):
        raise AssertionError("flush invariant: a digit completes more than one run in one level")


def _flush_into(buckets: G1, flush: G1, seg_e, valid, bvals) -> G1:
    """buckets[w, b] += flush[w, j] for the unique valid j with
    seg_e[w, j] == b, if there is one.  seg_e is sorted per row, so the run
    of digit b is [lo_b, hi_b) (a batched searchsorted) and the prefix sums
    of valid * (j + 1) over that run give j + 1 or 0.  The JAX package keeps
    the prefix in u32, which may wrap for huge n while the run's difference
    stays exact; int64 holds the prefix itself, with no wrap."""
    nwin, m = seg_e.shape
    seg_e = seg_e.contiguous()
    if CHECK_FLUSH:
        _check_flush_invariant(seg_e, valid)
    marks = torch.where(valid, torch.arange(1, m + 1, device=seg_e.device), 0)
    s = torch.nn.functional.pad(torch.cumsum(marks, dim=1), (1, 0))
    lo = torch.searchsorted(seg_e, bvals, right=False)
    hi = torch.searchsorted(seg_e, bvals, right=True)
    pos1 = s.gather(1, hi) - s.gather(1, lo)
    idx = (pos1 - 1).clamp(min=0).unsqueeze(-1).expand(*pos1.shape, NLIMB)
    picked = G1(*(c.gather(1, idx) for c in flush))
    return C.g1_add_select(pos1 > 0, buckets, picked)


def _bucket_totals(pts_pad: G1, dig, nbuckets: int, neg=None) -> G1:
    """Per-window sort, pairwise tree reduction of the sorted digit runs into
    buckets, weighted suffix-scan aggregation: dig (nwin, n) -> per-window
    totals (nwin,).  Operation for operation the JAX package's
    ``_bucket_totals``.

    INVARIANT (``_flush_into`` depends on it): ``seg`` stays sorted per row
    through the whole tree, so each level holds at most one completed run
    per digit.  ``CHECK_FLUSH`` checks it at every level."""
    nwin, n = dig.shape
    dev = dig.device
    idx_bits = max(1, (n - 1).bit_length())
    # one sort of (digit << idx_bits | index) keys: the digit order and the
    # permutation at once (the keys are unique, so the order is the JAX one)
    sk, _ = torch.sort((dig << idx_bits) | torch.arange(n, device=dev), dim=1)
    order = sk & ((1 << idx_bits) - 1)
    seg = sk >> idx_bits
    # gather the sorted points from a table with an identity row (index n)
    # for digit 0 and a negated copy of y for negative signed digits
    ident = C.g1_identity((1,), dev)
    xs, ys, zs = (torch.cat([c, e]) for c, e in zip(pts_pad, ident))
    gidx = torch.where(seg == 0, n, order)
    ygidx = gidx
    if neg is not None:
        ys = torch.cat([ys, F.neg(ys, F.FQ)])
        ygidx = gidx + (n + 1) * (torch.gather(neg, 1, order) & (seg != 0))
    cur = G1(xs[gidx], ys[ygidx], zs[gidx])
    del xs, ys, zs, gidx, ygidx, order

    buckets = C.g1_identity((nwin, nbuckets), dev)
    bvals = torch.arange(nbuckets, device=dev).expand(nwin, nbuckets).contiguous()
    while cur.x.shape[1] > 1:
        even = G1(*(c[:, 0::2] for c in cur))
        odd = G1(*(c[:, 1::2] for c in cur))
        seg_e, seg_o = seg[:, 0::2], seg[:, 1::2]
        same = seg_e == seg_o
        # same ? odd + even : odd (the complete add is symmetric in p, q)
        cur = C.g1_add_select(same, odd, even)
        # a pair crossing a run boundary completes seg_e's run: flush it
        buckets = _flush_into(buckets, even, seg_e, ~same, bvals)
        seg = seg_o
    # the last surviving run per row
    buckets = _flush_into(buckets, cur, seg, torch.ones_like(seg, dtype=torch.bool), bvals)

    # pad the bucket count to a power of two with identities for the scan
    npad = 1 << max(1, (nbuckets - 1).bit_length())
    if npad != nbuckets:
        ext = C.g1_identity((nwin, npad - nbuckets), dev)
        buckets = G1(*(torch.cat([b, e], dim=1) for b, e in zip(buckets, ext)))
    # weighted bucket aggregation: sum_b b S_b = sum_{b >= 1} suffix_b
    suffix = _g1_suffix_scan(G1(*(c.transpose(0, 1) for c in buckets)))  # (npad, nwin)
    return C.g1_tree_sum(G1(*(c[1:] for c in suffix)))  # (nwin,)


def _horner_combine(totals: G1, window: int) -> G1:
    """sum_w 2^(w * window) totals_w, most significant window first (kernel
    K6 on CUDA tensors)."""
    out = msm_cuda.horner_combine(G1(*(c.unsqueeze(0) for c in totals)), window)
    return G1(*(c[0] for c in out))


def _g1_suffix_scan(buckets: G1) -> G1:
    """Suffix sums S'_b = sum_{c >= b} S_c along axis 0 (a power of two):
    the work-efficient Blelloch scan of the JAX package on the reversed
    axis, up-sweep, down-sweep, then the inclusive combine."""
    n = buckets.x.shape[0]
    assert n & (n - 1) == 0, "bucket count is a power of two"
    dev = buckets.x.device
    orig = G1(*(c.flip(0) for c in buckets))
    x = [c.clone() for c in orig]
    logn = n.bit_length() - 1
    for d in range(logn):  # up-sweep: block end += block middle
        m = 2 << d
        left = torch.arange(m // 2 - 1, n, m, device=dev)
        right = left + m // 2
        s = C.g1_add(G1(*(c[left] for c in x)), G1(*(c[right] for c in x)))
        for c, v in zip(x, s):
            c[right] = v
    ident = C.g1_identity((), dev)
    for c, v in zip(x, ident):  # root <- identity
        c[n - 1] = v
    for d in range(logn - 1, -1, -1):  # down-sweep
        m = 2 << d
        left = torch.arange(m // 2 - 1, n, m, device=dev)
        right = left + m // 2
        lv, rv = G1(*(c[left] for c in x)), G1(*(c[right] for c in x))
        s = C.g1_add(lv, rv)
        for c, r, v in zip(x, rv, s):
            c[left] = r
            c[right] = v
    incl = C.g1_add(G1(*x), orig)  # exclusive prefix of the reversed axis + itself
    return G1(*(c.flip(0) for c in incl))
