"""Kernel K1, the batched Montgomery multiply, its fixed-exponent chain
``mont_pow``, and their plain versions.

K1 (``csrc/field.cu``) replaces ``snark_verifier_tpu/ops/field_pallas.py``
``_mont_mul_kernel`` (``mont_mul_pallas``; in-kernel helpers ``tmul``,
``tadd``, ``tsub``).  On the TPU the verifier's Fr math was ~100 XLA ops per
multiply that XLA fused; eager PyTorch cannot fuse them, so every
``field.mont_mul`` on a CUDA tensor launches K1 instead.  ``mont_pow`` runs
the whole chain of ``field.pow_const`` (Fermat inversions, square roots,
x^n), which the JAX package runs as one ``lax.scan`` over the same kernel,
in one launch instead of one K1 launch per product.  What bounds each on the
H100 and what the design does about it is in the source's header.

``mont_mul_plain`` is the same function in plain PyTorch: separated operand
scanning on int64 limbs, the arithmetic of the JAX package's
``ops/field.mont_mul``; ``mont_pow_plain`` is the 4-bit window chain over
it.  The wrappers take them only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops.field import NLIMB, FieldSpec, _cond_sub_mod, _resolve

# K1's threads per block: 32 was the fastest of a sweep of 32, 64 and 128
# at 1, 64 and 1820 elements on the H100 (3.62 against 4.62 us per launch at
# 128 and 1820 elements; within 0.3 % at 1), so one block size serves all.
K1_BLOCK = 32
POW_WINDOW = 4  # mont_pow's window (csrc/field.cu POW_TABLE = 2^4)


# From this many rows of limbs on (after broadcasting), _columns runs as 16
# shifted multiply-adds: the sliding windows' (rows, ncols, 16) product
# outgrows the CPU's caches there, and below it the loop's 32 tensor ops
# cost more than the windows (tools/time_plain_columns.py, one CPU thread,
# two runs: the windows take a twelfth to a third of the loop's time at
# 1-64 rows, the two cross between 256 and 1024 rows, and the loop takes
# 0.55-0.8 of the windows' time at 4096 rows and a quarter to a third at
# 32768).
COLUMN_LOOP_ROWS = 1024


def _columns(a, b, ncols: int):
    """Schoolbook column sums of a * b: (..., 16) x (..., 16) -> (..., ncols),
    column c = sum_{i+j=c} a_i b_j (each < 2^36, exact in int64).  Below
    ``COLUMN_LOOP_ROWS`` rows, one product of b's sliding windows (b padded
    by 15 zeros before and 16 after, unfolded: window c holds b_{c-15..c})
    with a reversed, summed over the window; from there, 16 multiply-adds
    of a_i b into columns i..i+15, whose temporaries stay one row of limbs
    wide."""
    rows = torch.broadcast_shapes(a.shape, b.shape)[:-1]
    if math.prod(rows) < COLUMN_LOOP_ROWS:
        windows = torch.nn.functional.pad(b, (NLIMB - 1, NLIMB)).unfold(-1, NLIMB, 1)[..., :ncols, :]
        return (windows * a.flip(-1).unsqueeze(-2)).sum(-1)
    cols = a.new_zeros(*rows, ncols)
    for i in range(min(NLIMB, ncols)):
        w = min(NLIMB, ncols - i)
        cols[..., i:i + w] += a[..., i:i + 1] * b[..., :w]
    return cols


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


def mont_mul(a, b, spec: FieldSpec):
    """Montgomery product of (..., 16) int64 limb tensors (broadcasting).
    CUDA tensors launch K1 in blocks of ``K1_BLOCK`` threads; CPU tensors
    take ``mont_mul_plain``."""
    check_limbs("mont_mul", a, b)
    if not use_kernel(a, b):
        return mont_mul_plain(a, b, spec)
    a, b = (_aligned(t) for t in torch.broadcast_tensors(a, b))
    n = a.numel() // NLIMB
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        code = _build.library().svtpu_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, field_arg(spec),
                                               K1_BLOCK, stream_of(a))
    _build.check(code, "mont_mul")
    if n:
        mont_mul.launches += 1
    return out


mont_mul.launches = 0


def mont_pow_plain(a, exponent: int, spec: FieldSpec, mul=mont_mul_plain):
    """a^exponent in Montgomery form on (..., 16) int64 limbs, any device:
    a table of a^0..a^15 (14 products), then 4-bit windows most significant
    first, 4 squarings and one product by the window's entry each (a zero
    digit's entry, Montgomery one, included), every product through ``mul``
    (``mont_mul_plain``; chip_smoke.py passes ``mont_mul`` to time the chain
    as K1 launches); the JAX package's ``ops/field.pow_const``.  exponent 0
    gives one."""
    if exponent == 0:
        return spec.consts(a.device)["one"].expand_as(a)
    nwin = (exponent.bit_length() + POW_WINDOW - 1) // POW_WINDOW
    mask = (1 << POW_WINDOW) - 1
    digits = [(exponent >> (POW_WINDOW * i)) & mask for i in range(nwin)][::-1]
    table = [spec.consts(a.device)["one"].expand_as(a), a]
    for _ in range(2, 1 << POW_WINDOW):
        table.append(mul(table[-1], a, spec))
    acc = table[digits[0]]
    for d in digits[1:]:
        for _ in range(POW_WINDOW):
            acc = mul(acc, acc, spec)
        acc = mul(acc, table[d], spec)
    return acc


POW_PIECE_WINDOWS = 256 // POW_WINDOW  # windows of one mont_pow launch's exponent piece


def exponent_arg(exponent: int):
    """The exponent as 8 little-endian u32 words (a ctypes array) and its bit
    length; raises unless 0 <= exponent < 2^256."""
    if not 0 <= exponent < 1 << 256:
        raise ValueError(f"mont_pow: exponent must be in [0, 2^256), got {exponent}")
    words = [(exponent >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    return (ctypes.c_uint32 * 8)(*words), exponent.bit_length()


def exponent_pieces(exponent: int) -> list[tuple[int, int]]:
    """``mont_pow``'s launches for an exponent >= 0, as (piece, bits): one
    for an exponent below 2^256 (itself, its bit length); above, the top
    windows of the MSB-first chain as the first piece, then 256-bit pieces
    (64 windows each, bits 256), so that each launch after the first
    continues the chain from the accumulator of the one before."""
    nwin = (exponent.bit_length() + POW_WINDOW - 1) // POW_WINDOW
    later = max(0, nwin - 1) // POW_PIECE_WINDOWS
    first = exponent >> (256 * later)
    mask = (1 << 256) - 1
    return [(first, first.bit_length())] + [((exponent >> (256 * j)) & mask, 256) for j in range(later - 1, -1, -1)]


def mont_pow(a, exponent: int, spec: FieldSpec, even_odd: bool = True):
    """a^exponent for a python-int exponent >= 0 on (..., 16) int64 limbs.
    CUDA tensors launch ``mont_pow`` once for an exponent below 2^256 (the
    whole chain, one thread per element; ``even_odd`` picks its Montgomery
    product, ``fmul_eo`` or, for chip_smoke.py's comparison, ``fmul``) and
    once per piece of ``exponent_pieces`` above; CPU tensors take
    ``mont_pow_plain``.  Same limbs either way."""
    check_limbs("mont_pow", a)
    exponent = int(exponent)
    if exponent < 0:
        raise ValueError(f"mont_pow: exponent must be >= 0, got {exponent}")
    if not use_kernel(a):
        return mont_pow_plain(a, exponent, spec)
    a = _aligned(a)
    n = a.numel() // NLIMB
    acc = None
    for piece, bits in exponent_pieces(exponent):
        words, _ = exponent_arg(piece)
        out = torch.empty_like(a)
        with torch.cuda.device(a.device):
            code = _build.library().svtpu_mont_pow(
                a.data_ptr(), None if acc is None else acc.data_ptr(), out.data_ptr(), n, field_arg(spec),
                words, bits, int(even_odd), stream_of(a))
        _build.check(code, "mont_pow")
        if n:
            mont_pow.launches += 1
        acc = out
    return acc


mont_pow.launches = 0
