"""Kernels K2 (complete G1 add), K3 (complete G1 double) and K5 (complete G1
add with a select), with their plain versions.

K2 and K3 (``csrc/curve.cu``) replace ``snark_verifier_tpu/ops/curve_pallas.py``
``_add_kernel`` and ``_dbl_kernel`` (``g1_add_pallas``/``g1_add_t`` and
``g1_double_pallas``/``g1_double_t``), which the MSM uses to build its
tables.  K5 (``csrc/curve.cu``) replaces ``_add_select_kernel``
(``g1_add_select_pallas`` and ``g1_add_select_t``), the step of the large
MSM's bucket tree, its flush and ``g1_tree_sum``.  What bounds them on the
H100 and what the design does about it is in the source's header.

The plain versions run RCB15 algorithms 7 and 9 with the same field
operations on the same operands as ``curve_pallas._add_core``/``_dbl_core``,
so each output triple matches limb for limb.  Independent field operations
of one formula step are stacked into one call (6 multiplies, then 6 more, for
an add), which changes no value and cuts the number of tensor ops.
"""

from __future__ import annotations

import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops.curve import G1, g1_select
from snark_verifier_tpu_torch.ops.field_cuda import (
    BLOCK,
    _aligned,
    check_limbs,
    field_arg,
    launch_elementwise,
    mont_mul_plain,
    stream_of,
)

FQ = F.FQ


def _mul(a, b):
    """Stacked Montgomery products: lists of tensors -> tuple of tensors."""
    return mont_mul_plain(torch.stack(a), torch.stack(b), FQ).unbind(0)


def _add(a, b):
    return F.add(torch.stack(a), torch.stack(b), FQ).unbind(0)


def _sub(a, b):
    return F.sub(torch.stack(a), torch.stack(b), FQ).unbind(0)


def g1_add_plain(p: G1, q: G1) -> G1:
    """RCB15 algorithm 7 (a = 0, b3 = 9) in plain PyTorch."""
    x1, y1, z1, x2, y2, z2 = torch.broadcast_tensors(*p, *q)
    s_xy1, s_xy2, s_yz1, s_yz2, s_xz1, s_xz2 = _add([x1, x2, y1, y2, x1, x2], [y1, y2, z1, z2, z1, z2])
    t0, t1, t2, t3, t4, x3 = _mul([x1, y1, z1, s_xy1, s_yz1, s_xz1], [x2, y2, z2, s_xy2, s_yz2, s_xz2])
    a01, a12, a02 = _add([t0, t1, t0], [t1, t2, t2])
    t3, t4, y3 = _sub([t3, t4, x3], [a01, a12, a02])
    # x3 = 2 t0; t0 = x3 + t0; t2 = 9 t2; y3 = 9 y3 (9t = 8t + t), steps interleaved
    t2_2, y3_2, x3 = _add([t2, y3, t0], [t2, y3, t0])
    t2_4, y3_4, t0 = _add([t2_2, y3_2, x3], [t2_2, y3_2, t0])
    t2_8, y3_8 = _add([t2_4, y3_4], [t2_4, y3_4])
    t2, y3 = _add([t2_8, y3_8], [t2, y3])
    (z3,) = _add([t1], [t2])
    (t1,) = _sub([t1], [t2])
    m0, m1, m2, m3, m4, m5 = _mul([t3, t4, t1, y3, z3, t0], [t1, y3, z3, t0, t4, t3])
    (x3,) = _sub([m0], [m1])
    y3, z3 = _add([m2, m4], [m3, m5])
    return G1(x3, y3, z3)


def g1_double_plain(p: G1) -> G1:
    """RCB15 algorithm 9 (a = 0, b3 = 9) in plain PyTorch."""
    x, y, z = torch.broadcast_tensors(*p)
    t0, t1, zz, xy = _mul([y, y, z, x], [y, z, z, y])
    # z3 = 8 t0; t2 = 9 zz, steps interleaved
    z3, zz2 = _add([t0, zz], [t0, zz])
    z3, zz4 = _add([z3, zz2], [z3, zz2])
    z3, zz8 = _add([z3, zz4], [z3, zz4])
    (t2,) = _add([zz8], [zz])
    x3, z3 = _mul([t2, t1], [z3, z3])
    y3, t1 = _add([t0, t2], [t2, t2])
    (t2,) = _add([t1], [t2])
    (t0,) = _sub([t0], [t2])
    m, x3b = _mul([t0, t0], [y3, xy])
    y3, x3 = _add([m, x3b], [x3, x3b])
    return G1(x3, y3, z3)


def g1_add(p: G1, q: G1) -> G1:
    """Complete add of point batches (broadcasting).  CUDA tensors launch
    K2; CPU tensors take ``g1_add_plain``."""
    check_limbs("g1_add", *p, *q)
    if not use_kernel(*p, *q):
        return g1_add_plain(p, q)
    outs, n = launch_elementwise("g1_add", (*p, *q), 3, FQ)
    if n:
        g1_add.launches += 1
    return G1(*outs)


def g1_double(p: G1) -> G1:
    """Complete doubling of a point batch.  CUDA tensors launch K3; CPU
    tensors take ``g1_double_plain``."""
    check_limbs("g1_double", *p)
    if not use_kernel(*p):
        return g1_double_plain(p)
    outs, n = launch_elementwise("g1_double", p, 3, FQ)
    if n:
        g1_double.launches += 1
    return G1(*outs)


def g1_add_select_plain(cond, p: G1, q: G1) -> G1:
    """cond ? p + q : p in plain PyTorch."""
    return g1_select(cond, g1_add_plain(p, q), p)


def g1_add_select(cond, p: G1, q: G1) -> G1:
    """cond ? p + q : p for point batches and a boolean ``cond``
    (broadcasting).  CUDA tensors launch K5; CPU tensors take
    ``g1_add_select_plain``."""
    check_limbs("g1_add_select", *p, *q)
    if cond.dtype != torch.bool:
        raise ValueError(f"g1_add_select: cond must be bool, got {cond.dtype}")
    if not use_kernel(cond, *p, *q):
        return g1_add_select_plain(cond, p, q)
    batch = torch.broadcast_shapes(cond.shape, *(c.shape[:-1] for c in (*p, *q)))
    full = tuple(batch) + (F.NLIMB,)
    ins = [_aligned(c.expand(full)) for c in (*p, *q)]
    mask = cond.expand(batch).contiguous().view(torch.uint8)
    n = mask.numel()
    outs = [torch.empty(full, dtype=torch.int64, device=mask.device) for _ in range(3)]
    with torch.cuda.device(mask.device):
        code = _build.library().svtpu_g1_add_select(
            *(t.data_ptr() for t in ins), mask.data_ptr(), *(o.data_ptr() for o in outs),
            n, field_arg(FQ), BLOCK, stream_of(mask),
        )
    _build.check(code, "g1_add_select")
    if n:
        g1_add_select.launches += 1
    return G1(*outs)


g1_add.launches = 0
g1_double.launches = 0
g1_add_select.launches = 0
