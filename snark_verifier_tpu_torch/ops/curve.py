"""Batched BN254 G1 arithmetic on int64 limb tensors: complete projective
formulas.

Counterpart of ``snark_verifier_tpu/ops/curve.py``.  A point batch is
``G1(x, y, z)`` of ``(..., 16)`` Montgomery limb tensors in homogeneous
projective form, identity (0 : 1 : 0); an all-zero triple is not a point and
breaks the complete formulas.  ``g1_add`` and ``g1_double`` go through
``curve_cuda`` (kernels K2 and K3 on CUDA tensors, their plain versions on
CPU tensors), and so does ``g1_add_select`` (kernel K5); the rest is plain
PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.util import bn254

FQ = F.FQ


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


def g1_add(p: G1, q: G1) -> G1:
    """Complete projective addition, RCB15 algorithm 7 (a = 0, b3 = 9)."""
    from snark_verifier_tpu_torch.ops import curve_cuda

    return curve_cuda.g1_add(p, q)


def g1_double(p: G1) -> G1:
    """Complete projective doubling, RCB15 algorithm 9 (a = 0, b3 = 9)."""
    from snark_verifier_tpu_torch.ops import curve_cuda

    return curve_cuda.g1_double(p)


def g1_add_select(cond, p: G1, q: G1) -> G1:
    """cond ? p + q : p, the conditional-accumulate step of every tree fold.
    Kernel K5 on CUDA tensors, ``g1_select(cond, g1_add(p, q), p)`` on CPU
    tensors; the complete add is symmetric in (p, q)."""
    from snark_verifier_tpu_torch.ops import curve_cuda

    return curve_cuda.g1_add_select(cond, p, q)


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
