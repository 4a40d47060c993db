"""Kernel K7's single product, the batched Fq12 product, and its plain
version.

K7 (``csrc/tower.cu``) replaces ``snark_verifier_tpu/ops/tower_pallas.py``
``_f12_mul_kernel`` (``fq12_mul_flat_pallas``), the product of every Miller
loop step and every final-exponentiation step of the pairing.  On the H100
the pairing runs those products inside two kernels of their own (the Miller
loop and the final exponentiation, ``ops/pairing.py``), built on the same
warp-wide product as ``fq12_mul_flat`` here, one warp per product.  What
bounds it on the H100 and what the design does about it is in the source's
header.

Both take the flat layout ``(12, *batch, 16)`` of ``tower.fq12_to_flat``.
``fq12_mul_flat_plain`` runs the stacked Karatsuba of ``tower`` with the
plain Montgomery multiply; every value stays reduced below p, so the kernel,
the plain version and the JAX package's products agree limb for limb.
"""

from __future__ import annotations

import math

import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import tower as T
from snark_verifier_tpu_torch.ops.field_cuda import _aligned, check_limbs, field_arg, mont_mul_plain, stream_of


def fq12_mul_flat_plain(x, y):
    """Plain version of K7: flat Fq12 x flat Fq12 -> flat Fq12."""
    def mul(a, b):
        return mont_mul_plain(a, b, F.FQ)

    return T.fq12_to_flat(T.fq12_mul_stacked(T.fq12_from_flat(x), T.fq12_from_flat(y), mul))


def fq12_mul_flat(x, y):
    """Flat Fq12 product (broadcasting over the batch).  CUDA tensors launch
    K7 (one warp per product); CPU tensors take ``fq12_mul_flat_plain``."""
    check_limbs("fq12_mul_flat", x, y)
    x, y = torch.broadcast_tensors(x, y)
    if x.dim() < 2 or x.shape[0] != 12:
        raise ValueError(f"fq12_mul_flat: expected (12, ..., 16) operands, got {tuple(x.shape)}")
    if not use_kernel(x, y):
        return fq12_mul_flat_plain(x, y)
    n = math.prod(x.shape[1:-1])
    a, b = _aligned(x), _aligned(y)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        code = _build.library().svtpu_fq12_mul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), n, field_arg(F.FQ), stream_of(a)
        )
    _build.check(code, "fq12_mul")
    if n:
        fq12_mul_flat.launches += 1
    return out


fq12_mul_flat.launches = 0
