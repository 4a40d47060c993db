"""Batched small multi-scalar multiplication.

Counterpart of the small-MSM half of ``snark_verifier_tpu/ops/msm.py``
(``msm_batched``, ``_msm_batched_xla``, ``scalar_mul``, ``_digits``).  The
large single MSM of the decide step (``msm_serial``) is not ported yet.

Scalars enter in canonical (non-Montgomery) limb form.
"""

from __future__ import annotations

import torch

from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops.curve import G1
from snark_verifier_tpu_torch.ops.field import LIMB_BITS, NLIMB
from snark_verifier_tpu_torch.ops.msm_cuda import NWINDOWS, WINDOW, msm_batched_fused


def _digits(scalars_canon):
    """(..., 16) canonical limbs -> (..., 64) unsigned 4-bit digits, LSB first."""
    shifts = torch.arange(0, LIMB_BITS, WINDOW, dtype=torch.int64, device=scalars_canon.device)
    d = (scalars_canon.unsqueeze(-1) >> shifts) & ((1 << WINDOW) - 1)
    return d.reshape(*scalars_canon.shape[:-1], NWINDOWS)


def msm_batched(points: G1, scalars_canon) -> G1:
    """Batched small MSM: points batch (..., n), scalars (..., n, 16)
    canonical -> point batch (...,).  Runs the point-scan path
    (``msm_cuda``): kernels K2, K3 and K4 on CUDA tensors, their plain
    versions on CPU tensors."""
    return msm_batched_fused(points, scalars_canon)


def msm_batched_windowed(points: G1, scalars_canon) -> G1:
    """The JAX package's reference algorithm (``_msm_batched_xla``): unsigned
    4-bit windows over a 16-entry table built by repeated adds, a tree sum of
    the picked entries per window.  Same point operations in the same order,
    so its output matches the JAX function limb for limb."""
    table = [C.g1_identity(points.batch_shape, points.x.device), points]
    for _ in range((1 << WINDOW) - 2):
        table.append(C.g1_add(table[-1], points))
    table = [torch.stack([t[c] for t in table]) for c in range(3)]  # 3 x (16, ..., n, 16)
    digits = _digits(scalars_canon)
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
