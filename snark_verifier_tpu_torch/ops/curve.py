"""Batched BN254 G1 arithmetic on int64 limb tensors: complete projective
formulas, with kernels K2 (complete add), K3 (complete doubling) and K5
(complete add with a select).

Counterpart of ``snark_verifier_tpu/ops/curve.py``.  A point batch is
``G1(x, y, z)`` of ``(..., 16)`` Montgomery limb tensors in homogeneous
projective form, identity (0 : 1 : 0); an all-zero triple is not a point and
breaks the complete formulas.  The routes ``g1_add``, ``g1_double`` and
``g1_add_select`` launch their kernel on CUDA tensors and take its plain
version on CPU tensors; the rest is plain PyTorch.

K2 and K3 (``csrc/curve.cu``) replace ``snark_verifier_tpu/ops/curve_pallas.py``
``_add_kernel`` and ``_dbl_kernel`` (``g1_add_pallas``/``g1_add_t`` and
``g1_double_pallas``/``g1_double_t``), which the MSM uses to build its
tables.  K5 (``csrc/curve.cu``) replaces ``_add_select_kernel``
(``g1_add_select_pallas`` and ``g1_add_select_t``), the step of the large
MSM's bucket tree, its flush and ``g1_tree_sum``.  What bounds them on the
H100 and what the design does about it is in the source's header: K2 and K5
run one point add on a group of ``GROUP`` lanes and read each coordinate
through two element strides (``point_operands``), so strided slices and
broadcast operands reach them without a copy; K3 runs one doubling on a
group of ``DBL_GROUP`` lanes (``double_points``) on contiguous operands.

The plain versions run RCB15 algorithms 7 and 9 with the same field
operations on the same operands as ``curve_pallas._add_core``/``_dbl_core``,
so each output triple matches limb for limb.  Independent field operations
of one formula step are stacked into one call (6 multiplies, then 6 more, for
an add), which changes no value and cuts the number of tensor ops.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.util import bn254

FQ = F.FQ
GROUP = 8  # lanes per point add of K2/K5 (csrc/curve.cu ADD_GROUP)
# K2/K5's threads per block (8 adds): 64 was the fastest of a sweep of 64,
# 128 and 256 or within 1.1 % of it at every width of the main path, 32 to
# 32768 adds, on the H100; 128 within 3 %, 256 up to 27 % slower.
ADD_BLOCK = 64
# K3's lanes per doubling (csrc/bn254.cuh DBL_GROUP): 4 lanes hold its two
# levels of four products with none idle
DBL_GROUP = 4
DBL_BLOCK = 64  # K3's threads per block
_COORDS, _STRIDES, _PAIR = ctypes.c_void_p * 6, ctypes.c_int64 * 12, ctypes.c_int64 * 2  # svtpu_g1_add_lanes' arrays


class G1(NamedTuple):
    """Projective point batch; limbs in Montgomery form."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return self.x.shape[:-1]


def g1_identity(shape, device) -> G1:
    return G1(F.zeros(shape, device), F.ones(shape, FQ, device), F.zeros(shape, device))


def g1_from_affine_ints(points, device) -> G1:
    """Host: list of (x, y) int pairs or None -> point batch on ``device``."""
    xs, ys, zs = [], [], []
    for pt in points:
        x, y, z = (0, 1, 0) if pt is None else (pt[0], pt[1], 1)
        xs.append(x)
        ys.append(y)
        zs.append(z)
    return G1(*(torch.as_tensor(FQ.encode(c).astype(np.int64), device=device) for c in (xs, ys, zs)))


def g1_to_affine_ints(p: G1):
    """Host: point batch -> list of (x, y) int pairs / None (oracle format)."""
    x, y, z = (np.atleast_1d(FQ.decode(c)).reshape(-1) for c in p)
    out = []
    for xi, yi, zi in zip(x, y, z):
        if zi == 0:
            out.append(None)
        else:
            zinv = bn254.inv_mod(int(zi), bn254.P)
            out.append((int(xi) * zinv % bn254.P, int(yi) * zinv % bn254.P))
    return out


def g1_is_identity(p: G1):
    return F.is_zero(p.z)


def g1_select(cond, a: G1, b: G1) -> G1:
    return G1(F.select(cond, a.x, b.x), F.select(cond, a.y, b.y), F.select(cond, a.z, b.z))


def g1_neg(p: G1) -> G1:
    return G1(p.x, F.neg(p.y, FQ), p.z)


def g1_tree_sum(p: G1, dim: int = 0) -> G1:
    """Sum a point batch along ``dim`` by pairwise rounds: in round r, slot i
    (a multiple of 2^(r+1)) adds slot i + 2^r, the pairing of the JAX
    ``g1_tree_sum``.  Each round keeps only the surviving slots and runs one
    ``g1_add_select`` over their pairs; an odd last slot pairs with the
    identity under a false mask."""
    cur = G1(*(c.movedim(dim, 0) for c in p))
    while cur.x.shape[0] > 1:
        m = cur.x.shape[0]
        if m % 2:
            pad = g1_identity((1,) + tuple(cur.x.shape[1:-1]), cur.x.device)
            cur = G1(*(torch.cat([c, e]) for c, e in zip(cur, pad)))
        even = G1(*(c[0::2] for c in cur))
        odd = G1(*(c[1::2] for c in cur))
        valid = torch.arange(len(even.x), device=cur.x.device) < m // 2
        valid = valid.reshape((-1,) + (1,) * (cur.x.dim() - 2)).expand(even.x.shape[:-1])
        cur = g1_add_select(valid, even, odd)
    return G1(cur.x[0], cur.y[0], cur.z[0])


def g1_normalize(p: G1) -> G1:
    """Scale to affine (z in {0, 1}) with one inversion per point."""
    zinv = F.inv(p.z, FQ)  # 0 -> 0
    x = F.mont_mul(p.x, zinv, FQ)
    y = F.mont_mul(p.y, zinv, FQ)
    is_inf = F.is_zero(p.z)
    shape, dev = p.z.shape[:-1], p.z.device
    z = F.select(is_inf, F.zeros(shape, dev), F.ones(shape, FQ, dev))
    return G1(x, F.select(is_inf, F.ones(shape, FQ, dev), y), z)


def g1_is_on_curve(p: G1):
    """y^2 z == x^3 + 3 z^3 (projective); the identity passes."""
    def mul(a, b):
        return F.mont_mul(a, b, FQ)

    y2z = mul(mul(p.y, p.y), p.z)
    x3 = mul(mul(p.x, p.x), p.x)
    z3 = mul(mul(p.z, p.z), p.z)
    b_term = mul(F.constant(bn254.G1_B, FQ, z3.shape[:-1], z3.device), z3)
    return F.eq(y2z, F.add(x3, b_term, FQ)) | g1_is_identity(p)


def g1_eq(p: G1, q: G1):
    """Projective equality: x1 z2 == x2 z1 and y1 z2 == y2 z1 (plus identity)."""
    def mul(a, b):
        return F.mont_mul(a, b, FQ)

    pi, qi = g1_is_identity(p), g1_is_identity(q)
    xe = F.eq(mul(p.x, q.z), mul(q.x, p.z))
    ye = F.eq(mul(p.y, q.z), mul(q.y, p.z))
    return (pi & qi) | (xe & ye & ~(pi ^ qi))


# ---------------------------------------------------------------------------
# Kernels K2 (add), K3 (double) and K5 (add with a select), with their plain
# versions
# ---------------------------------------------------------------------------


def _mul(a, b):
    """Stacked Montgomery products: lists of tensors -> tuple of tensors."""
    return F.mont_mul_plain(torch.stack(a), torch.stack(b), FQ).unbind(0)


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


def fold_stride(sizes, strides) -> int | None:
    """The one stride that walks dims ``sizes`` in row-major order on a view
    with ``strides`` (dims of extent 1 ignored; 0 when none is left), or
    None when they do not fold into one."""
    last = None
    for n, st in zip(sizes, strides):
        if n == 1:
            continue
        if last is not None and last != st * n:
            return None
        last = st
    return 0 if last is None else last


def _fold(strides, batch, even: bool):
    """(s0, s1) of a batch with ``strides``: the last dim is the inner index
    and the leading dims fold into the outer one.  None where the leading
    dims do not fold, or where a stride is odd and ``even`` asks for even."""
    if not batch:
        return 0, 0
    s0 = fold_stride(batch[:-1], strides[:-1])
    s1 = strides[-1] if batch[-1] > 1 else 0
    if s0 is None or (even and (s0 % 2 or s1 % 2)):
        return None
    return s0, s1


def point_operands(ins, mask, batch):
    """K2/K5's operands over ``batch``: each (..., 16) operand of ``ins``
    (already expanded to ``batch``) with its (s0, s1), and ``mask`` (bool,
    expanded, or None) as bytes with its own; the inner index is the last
    batch dim, the outer one the leading dims folded.  A limb operand folds
    only with its limbs contiguous and every point 16-byte aligned (the
    kernel loads limb pairs), so with even strides.  An operand that does
    not fold is copied (contiguous, aligned).  Operands of one layout are
    folded once (the host's time per call counts: the decide is
    host-bound).  Returns (ins, strides, mask, mask_strides, inner)."""
    out, strides, folds = [], [], {}
    for t in ins:
        st = t.stride()
        if st not in folds:
            folds[st] = _fold(st[:-1], batch, True) if st[-1] == 1 else None
        pair = folds[st]
        if pair is None or t.data_ptr() % 16:
            t = _build.aligned(t)
            pair = _fold(t.stride()[:-1], batch, True)
        out.append(t)
        strides.append(pair)
    mask_strides = (0, 0)
    if mask is not None:
        mask = mask.view(torch.uint8)
        mask_strides = _fold(mask.stride(), batch, False)
        if mask_strides is None:
            mask = mask.contiguous()
            mask_strides = _fold(mask.stride(), batch, False)
    return out, strides, mask, mask_strides, batch[-1] if batch else 1


def point_offsets(i, inner: int, s0: int, s1: int):
    """Element offset of point ``i``'s first limb (or mask byte) from the
    operand's start: the kernel's map (csrc/curve.cu AddOperands)."""
    return (i // inner) * s0 + (i % inner) * s1


def add_grid(n: int) -> int:
    """K2/K5's blocks for ``n`` adds: ``GROUP`` lanes each, ``ADD_BLOCK``
    threads per block; thread t of block b serves add (b * ADD_BLOCK + t) //
    GROUP."""
    return -(-n * GROUP // ADD_BLOCK)


def add_points(cond, p: G1, q: G1):
    """One launch of K5 (``cond`` bool) or K2 (``cond`` None) on CUDA point
    batches (broadcasting).  Counts nothing.  Returns (sum, number of
    adds)."""
    ins = [*p, *q]
    full = ins[0].shape
    batch = tuple(full[:-1])
    if any(c.shape != full for c in ins) or (cond is not None and cond.shape != full[:-1]):
        shapes = [c.shape[:-1] for c in ins] + ([cond.shape] if cond is not None else [])
        batch = tuple(torch.broadcast_shapes(*shapes))
        full = batch + (F.NLIMB,)
        ins = [c.expand(full) for c in ins]
    mask = cond if cond is None or cond.shape == batch else cond.expand(batch)
    dev = ins[0].device
    outs = [torch.empty(full, dtype=torch.int64, device=dev) for _ in range(3)]
    n = math.prod(batch)
    if n == 0:
        return G1(*outs), 0
    ins, strides, mask, mask_strides, inner = point_operands(ins, mask, batch)
    _build.launch("svtpu_g1_add_lanes", ins[0], _COORDS(*[t.data_ptr() for t in ins]),
                  _STRIDES(*[v for pair in strides for v in pair]), None if mask is None else mask.data_ptr(),
                  _PAIR(*mask_strides), *(o.data_ptr() for o in outs), n, inner, _build.field_arg(FQ), ADD_BLOCK)
    return G1(*outs), n


def g1_add(p: G1, q: G1) -> G1:
    """Complete add of point batches (broadcasting).  CUDA tensors launch
    K2; CPU tensors take ``g1_add_plain``."""
    _build.check_limbs("g1_add", *p, *q)
    if not use_kernel(*p, *q):
        return g1_add_plain(p, q)
    out, n = add_points(None, p, q)
    if n:
        g1_add.launches += 1
    return out


def double_points(p: G1) -> tuple[G1, int]:
    """One launch of K3 on a CUDA point batch.  Counts nothing.  Returns (2
    p, number of doublings)."""
    ins = [_build.aligned(t) for t in torch.broadcast_tensors(*p)]
    batch = ins[0].shape[:-1]
    n = ins[0].numel() // F.NLIMB
    outs = [torch.empty_like(ins[0]) for _ in range(3)]
    if n:
        _build.launch("svtpu_g1_double", ins[0], *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs), n,
                      _build.field_arg(FQ), DBL_BLOCK)
    return G1(*(o.reshape(*batch, F.NLIMB) for o in outs)), n


def dbl_grid(n: int) -> int:
    """K3's blocks for ``n`` doublings: ``DBL_GROUP`` lanes each,
    ``DBL_BLOCK`` threads per block; thread t of block b serves doubling (b *
    DBL_BLOCK + t) // DBL_GROUP and its limb pairs t % DBL_GROUP and t %
    DBL_GROUP + DBL_GROUP."""
    return -(-n * DBL_GROUP // DBL_BLOCK)


def g1_double(p: G1) -> G1:
    """Complete doubling of a point batch.  CUDA tensors launch K3 (one
    doubling on a group of ``DBL_GROUP`` lanes); CPU tensors take
    ``g1_double_plain``."""
    _build.check_limbs("g1_double", *p)
    if not use_kernel(*p):
        return g1_double_plain(p)
    out, n = double_points(p)
    if n:
        g1_double.launches += 1
    return out


def g1_add_select_plain(cond, p: G1, q: G1) -> G1:
    """cond ? p + q : p in plain PyTorch."""
    return g1_select(cond, g1_add_plain(p, q), p)


def g1_add_select(cond, p: G1, q: G1) -> G1:
    """cond ? p + q : p for point batches and a boolean ``cond``
    (broadcasting).  CUDA tensors launch K5; CPU tensors take
    ``g1_add_select_plain``."""
    _build.check_limbs("g1_add_select", *p, *q)
    if cond.dtype != torch.bool:
        raise ValueError(f"g1_add_select: cond must be bool, got {cond.dtype}")
    if not use_kernel(cond, *p, *q):
        return g1_add_select_plain(cond, p, q)
    out, n = add_points(cond, p, q)
    if n:
        g1_add_select.launches += 1
    return out


g1_add.launches = 0
g1_double.launches = 0
g1_add_select.launches = 0
