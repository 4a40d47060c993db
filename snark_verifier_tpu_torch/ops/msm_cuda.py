"""Kernel K4, the batched small MSM in one launch; kernels K8 and K9, the
two-kernel form of the same MSM; kernel K6, the Horner window combine of the
large MSM; each with its plain version.  ``msm.msm_batched`` builds K4's
operands and calls it.

K4 (``csrc/msm.cu``) replaces ``snark_verifier_tpu/ops/msm_pallas.py``
``_scan_kernel_body`` (``_scan_call``, driven by ``msm_batched_fused``):
the MSM of each proof over signed 4-bit windows and a 9-entry table T[|d|]
per point, y negated when d < 0.  The TPU kernel scans (window, point) in
order; on the H100 K4 first computes the 64 window sums of a proof in
parallel (one thread per window, K8's arithmetic), then runs the Horner
step over them in the same launch (K9's arithmetic).  Its output is
therefore ``msm_windowed``'s limb for limb, and ``msm_scan_plain`` is that
composition of the plain K8 and K9.  ``proofs_per_block`` is its one launch
parameter (``scan_geometry``).  What bounds it on the H100 and what the
design does about it is in the source's header.

The tables T_k = k * P (k = 0..8, ``msm.build_tables``) are laid out ``(9,
3, n, B, 16)``, the one layout of K4, K8 and their plain versions.

K8 ``msm_window`` and K9 ``msm_horner`` (``csrc/msm.cu``) replace
``msm_pallas.py`` ``_window_kernel_body`` (``_window_call``) and
``_horner_kernel_body`` (``_horner_call``), which the JAX package runs when
its one-kernel scan is switched off, and always on its CPU path.  Per
window, most significant first: K8 sums each proof's selected entries
T_i[|d_i|] (y negated for d_i < 0), starting from the first point's
selection; K9 computes acc = 16 acc + contrib with acc starting at the
identity.  ``msm_windowed`` runs them, 64 launches of each per MSM, and
gives K4's limbs; no main path calls it.  ``msm_window_plain`` and
``msm_horner_plain`` run the same point operations in the same order as
their kernels.

K6 (``csrc/msm.cu``) replaces ``curve_pallas.py`` ``_horner_w_kernel``
(``horner_combine_pallas``): sum_w 2^(w * window) T_w over the per-window
bucket totals of ``msm.msm_serial``, one accumulator per MSM, one warp per
MSM (the decide's two MSMs share one launch, ``msm.msm_serial_many``).
``horner_combine_plain`` is the JAX package's CPU reference scan
(``msm._horner_combine``): from the identity, ``window`` doublings and one
add per window, most significant first; the kernel runs the same operations.
"""

from __future__ import annotations

import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops.curve import G1, g1_add_plain, g1_double_plain
from snark_verifier_tpu_torch.ops.field import LIMB_BITS, NLIMB

WINDOW = 4
NWINDOWS = (NLIMB * LIMB_BITS) // WINDOW  # 64 signed 4-bit windows
NTAB = (1 << (WINDOW - 1)) + 1  # |digit| in 0..8 -> 9 table entries
WINDOW_GROUP = 8  # K8's and K9's lanes per proof: one complete add on a group (csrc/bn254.cuh g1_add_group)
WINDOW_BLOCK = 64  # K8's and K9's threads per block (8 proofs)
MAX_PROOFS_PER_BLOCK = 8  # the window sums of 8 proofs fill 48 KB of K4's shared memory
# K4 blocks per SM: a block's Horner threads share its first warp, and a
# third block on an SM slows every chain (chip_smoke.py's sweep, B = 8-1820)
BLOCKS_PER_SM = 2


def msm_scan_plain(table, digits) -> G1:
    """Plain version of K4: the plain K8/K9 composition (``msm_windowed``'s
    order).  table (9, 3, n, B, 16); digits (B, n, nwin) int64 in [-8, 8],
    least significant window first.  Returns (B, 16) coordinates of each
    proof's sum_i d_i-recoded scalar_i * P_i."""
    return _windowed(table, digits, msm_window_plain, msm_horner_plain)


def scan_geometry(batch: int, sm_count: int, proofs_per_block: int | None = None) -> tuple[int, int]:
    """K4's (proofs per block, blocks) for ``batch`` proofs on a card of
    ``sm_count`` SMs: the fewest proofs per block that keep the grid at
    ``BLOCKS_PER_SM`` blocks per SM, at most 8.  ``proofs_per_block`` (1-8)
    forces the first, as chip_smoke.py's sweep does."""
    ppb = proofs_per_block
    if ppb is None:
        ppb = min(MAX_PROOFS_PER_BLOCK, max(1, -(-batch // (BLOCKS_PER_SM * max(sm_count, 1)))))
    return ppb, -(-batch // ppb)


def msm_scan(table, digits, proofs_per_block: int | None = None) -> G1:
    """Batched small MSM.  CUDA tensors launch K4 (64 window threads per
    block, ``scan_geometry``'s proofs per block); CPU tensors take
    ``msm_scan_plain``.  Shapes as in ``msm_scan_plain``, nwin <= 64."""
    if table.dtype != torch.int64 or digits.dtype != torch.int64:
        raise ValueError("msm_scan: table and digits must be int64")
    if table.dim() != 5 or table.shape[:2] != (NTAB, 3) or table.shape[-1] != NLIMB:
        raise ValueError(f"msm_scan: table must be ({NTAB}, 3, n, B, {NLIMB}), got {tuple(table.shape)}")
    _, _, n, batch, _ = table.shape
    if digits.dim() != 3 or digits.shape[:2] != (batch, n) or not 1 <= digits.shape[-1] <= NWINDOWS or n < 1:
        raise ValueError(f"msm_scan: digits must be ({batch}, {n}, nwin <= {NWINDOWS}), got {tuple(digits.shape)}")
    if proofs_per_block is not None and not 1 <= proofs_per_block <= MAX_PROOFS_PER_BLOCK:
        raise ValueError(f"msm_scan: proofs_per_block must be in 1..{MAX_PROOFS_PER_BLOCK}, got {proofs_per_block}")
    if not use_kernel(table, digits):
        return msm_scan_plain(table, digits)
    table, digits = _build.aligned(table), digits.contiguous()
    outs = [torch.empty(batch, NLIMB, dtype=torch.int64, device=table.device) for _ in range(3)]
    ppb, _ = scan_geometry(batch, torch.cuda.get_device_properties(table.device).multi_processor_count, proofs_per_block)
    _build.launch("svtpu_msm_scan", table, table.data_ptr(), digits.data_ptr(), *(o.data_ptr() for o in outs),
                  batch, n, digits.shape[-1], ppb, _build.field_arg(F.FQ))
    if batch:
        msm_scan.launches += 1
    return G1(*outs)


msm_scan.launches = 0


def _select(table, d, i):
    """Entry T_i[|d|] of every proof with y negated where d < 0: table (9,
    3, n, B, 16), d (B,) -> G1 of (B, 16)."""
    batch = table.shape[3]
    idx = d.abs().view(1, 1, batch, 1).expand(1, 3, batch, NLIMB)
    x, y, z = table[:, :, i].gather(0, idx).squeeze(0).unbind(0)
    return G1(x, torch.where((d < 0).unsqueeze(-1), F.neg(y, F.FQ), y), z)


def msm_window_plain(table, digits) -> G1:
    """Plain version of K8.  table (9, 3, n, B, 16); digits (B, n) int64 in
    [-8, 8], one window.  Returns (B, 16) coordinates of sum_i T_i[|d_i|]
    (negated where d_i < 0), the first selection starting the sum."""
    acc = _select(table, digits[:, 0], 0)
    for i in range(1, table.shape[2]):
        acc = g1_add_plain(acc, _select(table, digits[:, i], i))
    return acc


def window_entry_offset(d, i, b, npoints: int, batch: int):
    """Element offset of the first limb of T_i[|d|]'s x in a contiguous (9,
    3, n, B, 16) table, for proof ``b``: the kernel's map (csrc/msm.cu
    load_entry).  y and z lie n * B * 16 elements further each; lane k of
    the proof's group reads limb pair k."""
    return (abs(d) * 3 * npoints + i) * batch * NLIMB + b * NLIMB


def window_grid(batch: int) -> int:
    """K8's and K9's blocks for ``batch`` proofs: ``WINDOW_GROUP`` lanes each,
    ``WINDOW_BLOCK`` threads per block; thread t of block g serves proof (g *
    WINDOW_BLOCK + t) // WINDOW_GROUP."""
    return -(-batch * WINDOW_GROUP // WINDOW_BLOCK)


def msm_window(table, digits) -> G1:
    """One window of the two-kernel MSM.  CUDA tensors launch K8 (one proof
    on a group of ``WINDOW_GROUP`` lanes, its adds in ``msm_window_plain``'s
    order); CPU tensors take ``msm_window_plain``.  Shapes as there."""
    if table.dtype != torch.int64 or digits.dtype != torch.int64:
        raise ValueError("msm_window: table and digits must be int64")
    if table.dim() != 5 or table.shape[:2] != (NTAB, 3) or table.shape[-1] != NLIMB or table.shape[2] < 1:
        raise ValueError(f"msm_window: table must be ({NTAB}, 3, n, B, {NLIMB}), got {tuple(table.shape)}")
    _, _, n, batch, _ = table.shape
    if tuple(digits.shape) != (batch, n):
        raise ValueError(f"msm_window: digits must be ({batch}, {n}), got {tuple(digits.shape)}")
    if not use_kernel(table, digits):
        return msm_window_plain(table, digits)
    table, digits = _build.aligned(table), digits.contiguous()
    outs = [torch.empty(batch, NLIMB, dtype=torch.int64, device=table.device) for _ in range(3)]
    _build.launch("svtpu_msm_window", table, table.data_ptr(), digits.data_ptr(), *(o.data_ptr() for o in outs),
                  batch, n, _build.field_arg(F.FQ), WINDOW_BLOCK)
    if batch:
        msm_window.launches += 1
    return G1(*outs)


msm_window.launches = 0


def msm_horner_plain(acc: G1, contrib: G1) -> G1:
    """Plain version of K9: 16 acc + contrib, as 4 doublings and one
    complete add, on (B, 16) coordinates."""
    for _ in range(WINDOW):
        acc = g1_double_plain(acc)
    return g1_add_plain(acc, contrib)


def msm_horner(acc: G1, contrib: G1) -> G1:
    """acc = 16 acc + contrib.  CUDA tensors launch K9 (one proof on a
    group of ``WINDOW_GROUP`` lanes, ``window_grid``'s blocks); CPU tensors
    take ``msm_horner_plain``."""
    _build.check_limbs("msm_horner", *acc, *contrib)
    if acc.x.dim() != 2 or any(c.shape != acc.x.shape for c in (*acc, *contrib)):
        raise ValueError(f"msm_horner: acc and contrib must be six (B, {NLIMB}) tensors")
    if not use_kernel(*acc, *contrib):
        return msm_horner_plain(acc, contrib)
    batch = acc.x.shape[0]
    ins = [_build.aligned(c) for c in (*acc, *contrib)]
    outs = [torch.empty(batch, NLIMB, dtype=torch.int64, device=ins[0].device) for _ in range(3)]
    _build.launch("svtpu_msm_horner", ins[0], *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs), batch,
                  _build.field_arg(F.FQ), WINDOW_BLOCK)
    if batch:
        msm_horner.launches += 1
    return G1(*outs)


msm_horner.launches = 0


def _windowed(table, digits, window_fn, horner_fn) -> G1:
    """For each window, most significant first, ``window_fn``'s sum folded
    in by ``horner_fn``, from the identity."""
    batch = table.shape[3]
    by_window = digits.permute(2, 0, 1).contiguous()  # (nwin, B, n)
    acc = C.g1_identity((batch,), table.device)
    for w in range(by_window.shape[0] - 1, -1, -1):
        acc = horner_fn(acc, window_fn(table, by_window[w]))
    return acc


def msm_windowed(table, digits) -> G1:
    """The two-kernel MSM: K8's window sums folded in by K9 (64 launches of
    each).  Shapes as ``msm_scan``."""
    return _windowed(table, digits, msm_window, msm_horner)


def horner_combine_plain(totals: G1, window: int) -> G1:
    """Plain version of K6.  totals: (B, nwin) point batch, window 0 least
    significant -> (B,) sum_w 2^(w * window) T_w."""
    batch, nwin = totals.batch_shape
    acc = C.g1_identity((batch,), totals.x.device)
    for w in range(nwin - 1, -1, -1):
        for _ in range(window):
            acc = g1_double_plain(acc)
        acc = g1_add_plain(acc, G1(*(c[:, w] for c in totals)))
    return acc


def horner_combine(totals: G1, window: int) -> G1:
    """Horner window combine of a batch of MSMs.  CUDA tensors launch K6,
    one warp per MSM; CPU tensors take ``horner_combine_plain``.  Shapes as
    in ``horner_combine_plain``; nwin at most 256."""
    _build.check_limbs("horner_combine", *totals)
    if totals.x.dim() != 3 or any(c.shape != totals.x.shape for c in totals):
        raise ValueError(f"horner_combine: totals must be three (B, nwin, {NLIMB}) tensors")
    if not 1 <= window <= 32:
        raise ValueError(f"horner_combine: window must be in 1..32, got {window}")
    if not use_kernel(*totals):
        return horner_combine_plain(totals, window)
    batch, nwin, _ = totals.x.shape
    ins = [_build.aligned(c) for c in totals]
    outs = [torch.empty(batch, NLIMB, dtype=torch.int64, device=ins[0].device) for _ in range(3)]
    _build.launch("svtpu_horner_combine", ins[0], *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs), batch,
                  nwin, window, _build.field_arg(F.FQ))
    if batch and nwin:
        horner_combine.launches += 1
    return G1(*outs)


horner_combine.launches = 0
