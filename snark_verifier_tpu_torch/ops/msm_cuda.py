"""Kernel K4, the batched small MSM by point scan, with its plain version and
the batched MSM built on it (``msm_batched_fused``); kernel K6, the Horner
window combine of the large MSM, with its plain version.

K4 (``csrc/msm.cu``) replaces ``snark_verifier_tpu/ops/msm_pallas.py``
``_scan_kernel_body`` (``_scan_call``, driven by ``msm_batched_fused``): one
accumulator per proof, signed 4-bit windows most significant first, 4
doublings per new window, a select of T[|d|] from 9 table entries, y negated
when d < 0, and a complete add.  What bounds it on the H100 and what the
design does about it is in the source's header.

The tables T_k = k * P (k = 0..8) are built with the same ladder as
``msm_pallas.py:398-405`` (doublings and adds through kernels K2/K3 on CUDA
tensors), laid out ``(9, 3, n, B, 16)``.  ``msm_scan_plain`` runs the same
point operations in the same order as the kernel, so the two agree limb for
limb on the same tables.

K6 (``csrc/msm.cu``) replaces ``curve_pallas.py`` ``_horner_w_kernel``
(``horner_combine_pallas``): sum_w 2^(w * window) T_w over the per-window
bucket totals of ``msm.msm_serial``, one accumulator per MSM.
``horner_combine_plain`` is the JAX package's CPU reference scan
(``msm._horner_combine``): from the identity, ``window`` doublings and one
add per window, most significant first; the kernel runs the same operations.
"""

from __future__ import annotations

import math

import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops.curve import G1
from snark_verifier_tpu_torch.ops.curve_cuda import g1_add_plain, g1_double_plain
from snark_verifier_tpu_torch.ops.field import LIMB_BITS, NLIMB
from snark_verifier_tpu_torch.ops.field_cuda import _aligned, check_limbs, field_arg, stream_of

WINDOW = 4
NWINDOWS = (NLIMB * LIMB_BITS) // WINDOW  # 64 signed 4-bit windows
NTAB = (1 << (WINDOW - 1)) + 1  # |digit| in 0..8 -> 9 table entries
BLOCK = 128  # threads per block (a launch parameter of msm_scan)


def signed_digits(scalars_canon):
    """(..., 16) canonical limbs -> (..., 64) int64 digits in [-8, 8], least
    significant first.  Balanced recoding: a window above 8 borrows 16 from
    the next one (the top window of an Fr scalar is <= 3, so the last carry
    is always absorbed)."""
    shifts = torch.arange(0, LIMB_BITS, WINDOW, dtype=torch.int64, device=scalars_canon.device)
    v = (scalars_canon.unsqueeze(-1) >> shifts) & ((1 << WINDOW) - 1)
    v = v.reshape(*scalars_canon.shape[:-1], NWINDOWS)
    out = []
    carry = torch.zeros_like(v[..., 0])
    for w in range(NWINDOWS):
        t = v[..., w] + carry
        carry = (t > (1 << (WINDOW - 1))).long()
        out.append(t - (carry << WINDOW))
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


def msm_scan_plain(table, digits) -> G1:
    """Plain version of K4.  table (9, 3, n, B, 16); digits (B, n, nwin)
    int64 in [-8, 8], least significant window first.  Returns (B, 16)
    coordinates of each proof's sum_i d_i-recoded scalar_i * P_i."""
    _, _, n, batch, _ = table.shape
    nwin = digits.shape[-1]
    acc = None
    for w in range(nwin - 1, -1, -1):
        if acc is not None:
            for _ in range(WINDOW):
                acc = g1_double_plain(acc)
        for i in range(n):
            d = digits[:, i, w]
            idx = d.abs().view(1, 1, batch, 1).expand(1, 3, batch, NLIMB)
            x, y, z = table[:, :, i].gather(0, idx).squeeze(0).unbind(0)
            y = torch.where((d < 0).unsqueeze(-1), F.neg(y, F.FQ), y)
            acc = G1(x, y, z) if acc is None else g1_add_plain(acc, G1(x, y, z))
    return acc


def msm_scan(table, digits, block: int = BLOCK) -> G1:
    """Batched point-scan MSM.  CUDA tensors launch K4 with ``block``
    threads per block (one thread per proof); CPU tensors take
    ``msm_scan_plain``.  Shapes as in ``msm_scan_plain``."""
    if table.dtype != torch.int64 or digits.dtype != torch.int64:
        raise ValueError("msm_scan: table and digits must be int64")
    if table.dim() != 5 or table.shape[:2] != (NTAB, 3) or table.shape[-1] != NLIMB:
        raise ValueError(f"msm_scan: table must be ({NTAB}, 3, n, B, {NLIMB}), got {tuple(table.shape)}")
    _, _, n, batch, _ = table.shape
    if digits.dim() != 3 or digits.shape[:2] != (batch, n) or digits.shape[-1] < 1 or n < 1:
        raise ValueError(f"msm_scan: digits must be ({batch}, {n}, nwin), got {tuple(digits.shape)}")
    if not use_kernel(table, digits):
        return msm_scan_plain(table, digits)
    table, digits = _aligned(table), digits.contiguous()
    outs = [torch.empty(batch, NLIMB, dtype=torch.int64, device=table.device) for _ in range(3)]
    lib = _build.library()
    with torch.cuda.device(table.device):
        code = lib.svtpu_msm_scan(
            table.data_ptr(), digits.data_ptr(), *(o.data_ptr() for o in outs),
            batch, n, digits.shape[-1], field_arg(F.FQ), block, stream_of(table),
        )
    _build.check(code, "msm_scan")
    if batch:
        msm_scan.launches += 1
    return G1(*outs)


msm_scan.launches = 0


def msm_batched_fused(points: G1, scalars_canon, nwindows: int = NWINDOWS) -> G1:
    """Batched small MSM: points batch (..., n), scalars (..., n, 16)
    canonical -> point batch (...,).

    ``nwindows`` < 64 is a test hook, right only when every scalar is below
    2^(4 * nwindows - 1)."""
    batch_shape = points.batch_shape[:-1]
    n = points.batch_shape[-1]
    B = math.prod(batch_shape)
    # point-major (n, B) layout: lane (i, b) of the tables is point i of proof b
    pts = G1(*(c.reshape(B, n, NLIMB).transpose(0, 1) for c in points))
    table = build_tables(pts)
    digits = signed_digits(scalars_canon.reshape(B, n, NLIMB))[..., :nwindows]
    acc = msm_scan(table, digits)
    return G1(*(c.reshape(*batch_shape, NLIMB) for c in acc))


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
    """Horner window combine of a batch of MSMs.  CUDA tensors launch K6
    (one thread per MSM); CPU tensors take ``horner_combine_plain``.
    Shapes as in ``horner_combine_plain``."""
    check_limbs("horner_combine", *totals)
    if totals.x.dim() != 3 or any(c.shape != totals.x.shape for c in totals):
        raise ValueError(f"horner_combine: totals must be three (B, nwin, {NLIMB}) tensors")
    if not 1 <= window <= 32:
        raise ValueError(f"horner_combine: window must be in 1..32, got {window}")
    if not use_kernel(*totals):
        return horner_combine_plain(totals, window)
    batch, nwin, _ = totals.x.shape
    ins = [_aligned(c) for c in totals]
    outs = [torch.empty(batch, NLIMB, dtype=torch.int64, device=ins[0].device) for _ in range(3)]
    with torch.cuda.device(ins[0].device):
        code = _build.library().svtpu_horner_combine(
            *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs),
            batch, nwin, window, field_arg(F.FQ), BLOCK, stream_of(ins[0]),
        )
    _build.check(code, "horner_combine")
    if batch and nwin:
        horner_combine.launches += 1
    return G1(*outs)


horner_combine.launches = 0
