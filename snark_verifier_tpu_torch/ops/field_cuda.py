"""Kernel K1, the batched Montgomery multiply, and its plain version.

K1 (``csrc/field.cu``) replaces ``snark_verifier_tpu/ops/field_pallas.py``
``_mont_mul_kernel`` (``mont_mul_pallas``; in-kernel helpers ``tmul``,
``tadd``, ``tsub``).  On the TPU the verifier's Fr math was ~100 XLA ops per
multiply that XLA fused; eager PyTorch cannot fuse them, so every
``field.mont_mul`` on a CUDA tensor launches K1 instead.  What bounds it on
the H100 and what the design does about it is in the source's header.

``mont_mul_plain`` is the same function in plain PyTorch: separated operand
scanning on int64 limbs, the arithmetic of the JAX package's
``ops/field.mont_mul``.  The wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops.field import NLIMB, FieldSpec, _cond_sub_mod, _resolve

BLOCK = 128


def _columns(a, b, ncols: int):
    """Schoolbook column sums of a * b: (..., 16) x (..., 16) -> (..., ncols),
    column c = sum_{i+j=c} a_i b_j (each < 2^36, exact in int64).  Row i of
    the 16 x 16 product matrix is shifted right by i by padding the rows to 33
    entries and reading the flat buffer back as rows of 32."""
    prod = a.unsqueeze(-1) * b.unsqueeze(-2)  # (..., 16, 16), each < 2^32
    lead = prod.shape[:-2]
    padded = torch.nn.functional.pad(prod, (0, NLIMB + 1))  # rows of 33
    skew = padded.reshape(*lead, NLIMB * (2 * NLIMB + 1))[..., : NLIMB * 2 * NLIMB]
    cols = skew.reshape(*lead, NLIMB, 2 * NLIMB).sum(-2)
    return cols[..., :ncols]


def mont_mul_plain(a, b, spec: FieldSpec):
    """a * b * 2^-256 mod p on (..., 16) int64 limbs, any device.

    Separated operand scanning, as the JAX package's ``ops/field.mont_mul``:
    T = a*b, m = (T mod R) * n' mod R, then S = T + m*p, which is divisible
    by R, so S / R is its high 16 limbs plus the carry out of the top; one
    conditional subtract brings it below p."""
    a, b = torch.broadcast_tensors(a, b)
    c = spec.consts(a.device)
    t_cols = _columns(a, b, 2 * NLIMB)
    t_lo, _ = _resolve(t_cols[..., :NLIMB], passes=2)
    m, _ = _resolve(_columns(t_lo, c["nprime"].expand_as(t_lo), NLIMB), passes=2)
    s, carry = _resolve(t_cols + _columns(m, c["mod"].expand_as(m), 2 * NLIMB), passes=2)
    return _cond_sub_mod(s[..., NLIMB:], spec, extra=carry)


@functools.lru_cache(maxsize=None)
def field_arg(spec: FieldSpec):
    """The modulus words and n0 as a ctypes array (the kernels' Field)."""
    return (ctypes.c_uint32 * len(spec.kernel_words))(*map(int, spec.kernel_words))


def check_limbs(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is int64 with a trailing limb axis of 16."""
    for t in tensors:
        if t.dtype != torch.int64 or t.dim() == 0 or t.shape[-1] != NLIMB:
            raise ValueError(f"{name}: expected int64 (..., {NLIMB}) limbs, got {t.dtype} {tuple(t.shape)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernels load limb pairs as longlong2)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch_elementwise(name: str, ins, n_out: int, spec: FieldSpec):
    """Launch the elementwise kernel ``svtpu_<name>`` (K1-K3): broadcast the
    (..., 16) inputs, allocate ``n_out`` outputs, run one thread per element
    on the current stream and raise on a launch error.  Returns
    (outputs reshaped to the batch, element count)."""
    ins = torch.broadcast_tensors(*ins)
    batch = ins[0].shape[:-1]
    ins = [_aligned(t) for t in ins]
    n = ins[0].numel() // NLIMB
    outs = [torch.empty_like(ins[0]) for _ in range(n_out)]
    entry = getattr(_build.library(), f"svtpu_{name}")
    with torch.cuda.device(ins[0].device):
        code = entry(
            *(t.data_ptr() for t in ins), *(o.data_ptr() for o in outs),
            n, field_arg(spec), BLOCK, stream_of(ins[0]),
        )
    _build.check(code, name)
    return [o.reshape(*batch, NLIMB) for o in outs], n


def mont_mul(a, b, spec: FieldSpec):
    """Montgomery product of (..., 16) int64 limb tensors (broadcasting).
    CUDA tensors launch K1; CPU tensors take ``mont_mul_plain``."""
    check_limbs("mont_mul", a, b)
    if not use_kernel(a, b):
        return mont_mul_plain(a, b, spec)
    (out,), n = launch_elementwise("mont_mul", (a, b), 1, spec)
    if n:
        mont_mul.launches += 1
    return out


mont_mul.launches = 0
