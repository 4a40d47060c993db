"""Batched Fq2/Fq6/Fq12 tower arithmetic on int64 limb tensors, with kernel
K7's single product, the batched Fq12 product.

Counterpart of ``snark_verifier_tpu/ops/tower.py``: the oracle tower of
``util/bn254.py`` over ``(..., 16)`` Montgomery limb tensors.  Fq2 = (c0, c1),
Fq6 = (a0, a1, a2) of Fq2, Fq12 = (b0, b1) of Fq6, as plain tuples.
Karatsuba products; Frobenius maps by host constants.

K7 (``csrc/tower.cu``) replaces ``snark_verifier_tpu/ops/tower_pallas.py``
``_f12_mul_kernel`` (``fq12_mul_flat_pallas``), the product of every Miller
loop step and every final-exponentiation step of the pairing.  On the H100
the pairing runs those products inside two kernels of their own (the Miller
loop and the final exponentiation, ``ops/pairing.py``), built on the same
warp-wide product as ``fq12_mul_flat`` here, one warp per product.  What
bounds it on the H100 and what the design does about it is in the source's
header.

``fq12_mul`` goes through the route ``fq12_mul_flat``, on the flat layout
``(12, *batch, 16)`` of ``fq12_to_flat``: K7 on CUDA tensors, on CPU tensors
``fq12_mul_flat_plain``, the stacked Karatsuba below with the plain
Montgomery multiply, whose 54 products are one batched multiply.  Every
value stays reduced below p, so the kernel, the plain version and the JAX
package's products agree limb for limb.
"""

from __future__ import annotations

import math

import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.util import bn254

FQ = F.FQ


def _c(v: int, shape, device):
    return F.constant(v, FQ, shape, device)


def fq_mul(a, b):
    return F.mont_mul(a, b, FQ)


def fq_add(a, b):
    return F.add(a, b, FQ)


def fq_sub(a, b):
    return F.sub(a, b, FQ)


# -- Fq2 ---------------------------------------------------------------------


def fq2_add(a, b):
    return (fq_add(a[0], b[0]), fq_add(a[1], b[1]))


def fq2_sub(a, b):
    return (fq_sub(a[0], b[0]), fq_sub(a[1], b[1]))


def fq2_neg(a):
    return (F.neg(a[0], FQ), F.neg(a[1], FQ))


def fq2_mul(a, b):
    t0 = fq_mul(a[0], b[0])
    t1 = fq_mul(a[1], b[1])
    t2 = fq_mul(fq_add(a[0], a[1]), fq_add(b[0], b[1]))
    return (fq_sub(t0, t1), fq_sub(t2, fq_add(t0, t1)))


def fq2_sqr(a):
    t0 = fq_mul(fq_add(a[0], a[1]), fq_sub(a[0], a[1]))
    t1 = fq_mul(a[0], a[1])
    return (t0, fq_add(t1, t1))


def fq2_scalar_small(a, k: int):
    """Multiply both components by a small int via additions."""
    out0, out1 = torch.zeros_like(a[0]), torch.zeros_like(a[1])
    acc0, acc1 = a
    kk = k
    while kk:
        if kk & 1:
            out0, out1 = fq_add(out0, acc0), fq_add(out1, acc1)
        acc0, acc1 = fq_add(acc0, acc0), fq_add(acc1, acc1)
        kk >>= 1
    return (out0, out1)


def fq2_conj(a):
    return (a[0], F.neg(a[1], FQ))


def fq2_inv(a):
    norm = fq_add(fq_mul(a[0], a[0]), fq_mul(a[1], a[1]))
    ninv = F.inv(norm, FQ)
    return (fq_mul(a[0], ninv), F.neg(fq_mul(a[1], ninv), FQ))


def fq2_mul_xi(a):
    """Multiply by xi = 9 + u."""
    a9 = fq2_scalar_small(a, 9)
    return (fq_sub(a9[0], a[1]), fq_add(a9[1], a[0]))


def fq2_constant(c: tuple, shape, device):
    return (_c(c[0], shape, device), _c(c[1], shape, device))


def fq2_zeros(shape, device):
    return (F.zeros(shape, device), F.zeros(shape, device))


def fq2_ones(shape, device):
    return (F.ones(shape, FQ, device), F.zeros(shape, device))


# -- Fq6 ---------------------------------------------------------------------


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    norm = fq2_add(fq2_mul(a0, c0), fq2_mul_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))))
    ninv = fq2_inv(norm)
    return (fq2_mul(c0, ninv), fq2_mul(c1, ninv), fq2_mul(c2, ninv))


def fq6_zeros(shape, device):
    return (fq2_zeros(shape, device), fq2_zeros(shape, device), fq2_zeros(shape, device))


def fq6_ones(shape, device):
    return (fq2_ones(shape, device), fq2_zeros(shape, device), fq2_zeros(shape, device))


# -- Fq12 --------------------------------------------------------------------


def _stacked_mul(aa, bb):
    """The stacked Karatsuba's one batched Montgomery multiply (kernel K1 on
    CUDA tensors)."""
    return F.mont_mul(aa, bb, FQ)


def _mul_xi_stacked(x):
    """(..., 2, *B, 16) Fq2 values (component axis -2 - len(B)) times
    xi = 9 + u, as fq2_mul_xi: (9 x0 - x1, 9 x1 + x0), 9x = 8x + x."""
    x2 = fq_add(x, x)
    x4 = fq_add(x2, x2)
    x9 = fq_add(fq_add(x4, x4), x)
    return x9, x


def fq12_mul_stacked(a, b, mul=_stacked_mul):
    """Stacked Karatsuba: the 54 Fq products of the Fq12 tower as ONE ``mul``
    over a stacked (3, 6, 3, *B, 16) operand pair (Fq6 product, Fq2 product,
    Fq product), and every Karatsuba sum and recombination as one
    elementwise add or sub over a whole stack.  The products, sums and
    recombinations of the JAX package's XLA ``fq12_mul``; all values stay
    reduced, so the limbs are the same."""
    def operands(v):
        f = fq12_to_flat(v)
        f = f.reshape(2, 3, 2, *f.shape[1:])  # (Fq6 l, Fq2 j, component c, *B, 16)
        x = torch.stack([f[0], f[1], fq_add(f[0], f[1])])  # Fq12 level: a0, a1, a0 + a1
        x = torch.stack([  # Fq6 level: x0, x1, x2, x1 + x2, x0 + x1, x0 + x2
            x[:, 0], x[:, 1], x[:, 2], *fq_add(x[:, [1, 0, 0]], x[:, [2, 1, 2]]).unbind(1)
        ], dim=1)
        return torch.cat([x, fq_add(x[:, :, :1], x[:, :, 1:])], dim=2)  # Fq2 level: c0, c1, c0 + c1

    xa, xb = operands(a), operands(b)
    xa, xb = torch.broadcast_tensors(xa, xb)
    rr = mul(xa.reshape(54, *xa.shape[3:]), xb.reshape(54, *xb.shape[3:])).reshape(xa.shape)
    # Fq2 products: (t0 - t1, t2 - (t0 + t1)) -> (3, 6, 2, *B, 16)
    t01 = fq_add(rr[:, :, 0], rr[:, :, 1])
    p2 = torch.stack([fq_sub(rr[:, :, 0], rr[:, :, 1]), fq_sub(rr[:, :, 2], t01)], dim=2)
    # Fq6 products: c0 = t0 + xi (m12 - (t1 + t2)), c1 = (m01 - (t0 + t1)) + xi t2,
    # c2 = (m02 - (t0 + t2)) + t1 -> (3, 3, 2, *B, 16)
    t0, t1, t2 = p2[:, 0], p2[:, 1], p2[:, 2]
    sums = fq_add(p2[:, [1, 0, 0]], p2[:, [2, 1, 2]])  # t1 + t2, t0 + t1, t0 + t2
    diff = fq_sub(p2[:, 3:6], sums)  # m12 - ., m01 - ., m02 - .
    xi9, xi1 = _mul_xi_stacked(torch.stack([diff[:, 0], t2], dim=1))  # xi(m12 - (t1 + t2)), xi t2
    xi = torch.stack([fq_sub(xi9[:, :, 0], xi1[:, :, 1]), fq_add(xi9[:, :, 1], xi1[:, :, 0])], dim=2)
    p6 = fq_add(torch.stack([t0, diff[:, 1], diff[:, 2]], dim=1), torch.stack([xi[:, 0], xi[:, 1], t1], dim=1))
    # Fq12: c0 = t0 + v t1 with v (x0, x1, x2) = (xi x2, x0, x1); c1 = t2 - (t0 + t1)
    u0, u1, u2 = p6[0], p6[1], p6[2]
    xi9, xi1 = _mul_xi_stacked(u1[2])
    vt1 = torch.stack([torch.stack([fq_sub(xi9[0], xi1[1]), fq_add(xi9[1], xi1[0])]), u1[0], u1[1]])
    c = torch.stack([fq_add(u0, vt1), fq_sub(u2, fq_add(u0, u1))])  # (2, 3, 2, *B, 16)
    return fq12_from_flat(c.reshape(12, *c.shape[3:]))


def fq12_mul_flat_plain(x, y):
    """Plain version of K7: flat Fq12 x flat Fq12 -> flat Fq12."""
    def mul(a, b):
        return F.mont_mul_plain(a, b, FQ)

    return fq12_to_flat(fq12_mul_stacked(fq12_from_flat(x), fq12_from_flat(y), mul))


def fq12_mul_flat(x, y):
    """Flat Fq12 product (broadcasting over the batch).  CUDA tensors launch
    K7 (one warp per product); CPU tensors take ``fq12_mul_flat_plain``."""
    _build.check_limbs("fq12_mul_flat", x, y)
    x, y = torch.broadcast_tensors(x, y)
    if x.dim() < 2 or x.shape[0] != 12:
        raise ValueError(f"fq12_mul_flat: expected (12, ..., 16) operands, got {tuple(x.shape)}")
    if not use_kernel(x, y):
        return fq12_mul_flat_plain(x, y)
    n = math.prod(x.shape[1:-1])
    a, b = _build.aligned(x), _build.aligned(y)
    out = torch.empty_like(a)
    _build.launch("svtpu_fq12_mul", a, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _build.field_arg(FQ))
    if n:
        fq12_mul_flat.launches += 1
    return out


fq12_mul_flat.launches = 0


def fq12_mul(a, b):
    """Fq12 product: kernel K7 on CUDA tensors, ``fq12_mul_stacked`` on CPU
    tensors."""
    return fq12_from_flat(fq12_mul_flat(fq12_to_flat(a), fq12_to_flat(b)))


def fq12_sqr(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    norm = fq6_sub(fq6_sqr(a[0]), fq6_mul_by_v(fq6_sqr(a[1])))
    ninv = fq6_inv(norm)
    return (fq6_mul(a[0], ninv), fq6_neg(fq6_mul(a[1], ninv)))


def fq12_ones(shape, device):
    return (fq6_ones(shape, device), fq6_zeros(shape, device))


def fq12_to_flat(f):
    """Fq12 tuple tree -> flat (12, *batch, 16) tensor, component order
    (l, j, c) = l*6 + j*2 + c for Fq12 index l, Fq6 index j, Fq2 index c."""
    comps = [f[l][j][c] for l in (0, 1) for j in (0, 1, 2) for c in (0, 1)]
    shape = torch.broadcast_shapes(*(x.shape for x in comps))
    return torch.stack([x.expand(shape) for x in comps])


def fq12_from_flat(v):
    return tuple(tuple((v[l * 6 + j * 2], v[l * 6 + j * 2 + 1]) for j in range(3)) for l in range(2))


def fq12_select(cond, a, b):
    return tuple(tuple(tuple(F.select(cond, x, y) for x, y in zip(p, q)) for p, q in zip(a6, b6)) for a6, b6 in zip(a, b))


def fq12_is_one(a):
    """Boolean (batch...,): a == 1 in Fq12."""
    flat = fq12_to_flat(a)
    one = F.ones((), FQ, flat.device)
    return F.eq(flat[0], one) & F.is_zero(flat[1:]).all(0)


# -- Frobenius ---------------------------------------------------------------


def fq2_frob(a, power: int):
    return fq2_conj(a) if power % 2 else a


def fq6_frob(a, power: int):
    shape, dev = a[0][0].shape[:-1], a[0][0].device
    a0 = fq2_frob(a[0], power)
    a1 = fq2_mul(fq2_frob(a[1], power), fq2_constant(bn254.FROB_FQ6_C1[power % 6], shape, dev))
    a2 = fq2_mul(fq2_frob(a[2], power), fq2_constant(bn254.FROB_FQ6_C2[power % 6], shape, dev))
    return (a0, a1, a2)


def fq12_frob(a, power: int):
    shape, dev = a[0][0][0].shape[:-1], a[0][0][0].device
    c0 = fq6_frob(a[0], power)
    c1 = fq6_frob(a[1], power)
    coef = fq2_constant(bn254.FROB_FQ12_C1[power % 12], shape, dev)
    c1 = tuple(fq2_mul(x, coef) for x in c1)
    return (c0, c1)
