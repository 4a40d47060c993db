"""Batched modular arithmetic over BN254 Fq/Fr on int64 limb tensors, with
kernel K1 (the batched Montgomery multiply) and its fixed-exponent chain
``mont_pow``.

Counterpart of ``snark_verifier_tpu/ops/field.py``.  Elements are
``(..., 16)`` int64 tensors of 16-bit little-endian limbs in Montgomery form
(R = 2^256); every op broadcasts over leading batch dims and returns the
same canonical limbs as the JAX package, bit for bit.

K1 (``csrc/field.cu``) replaces ``snark_verifier_tpu/ops/field_pallas.py``
``_mont_mul_kernel`` (``mont_mul_pallas``; in-kernel helpers ``tmul``,
``tadd``, ``tsub``).  On the TPU the verifier's Fr math was ~100 XLA ops per
multiply that XLA fused; eager PyTorch cannot fuse them, so every
``mont_mul`` on a CUDA tensor launches K1 instead.  ``mont_pow`` runs the
whole chain of ``pow_const`` (Fermat inversions, square roots, x^n), which
the JAX package runs as one ``lax.scan`` over the same kernel, in one launch
instead of one K1 launch per product.  What bounds each on the H100 and what
the design does about it is in the source's header.

``mont_mul_plain`` is the same function in plain PyTorch: separated operand
scanning on int64 limbs, the arithmetic of the JAX package's
``ops/field.mont_mul``; ``mont_pow_plain`` is the 4-bit window chain over
it.  The routes ``mont_mul`` and ``mont_pow`` take them only for CPU
tensors.  The other ops are plain PyTorch on either device.  Carries are
resolved without a sequential limb loop: a column's carry-in is a bit of
``(A + B) ^ A ^ B``, where A and B pack each column's propagate-or-generate
and generate flags into one int64 (the carry-lookahead adder done by the
integer adder).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops.limbs import LIMB_BITS, LIMB_MASK, NLIMB, TOTAL_BITS, int_to_limbs, limbs_to_int
from snark_verifier_tpu_torch.util import bn254

WORD_BITS = 32  # the kernels' word size


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Per-field constants, derived on the host from ``util/bn254``."""

    name: str
    modulus: int
    mod_limbs: np.ndarray = field(repr=False, default=None)
    nprime_limbs: np.ndarray = field(repr=False, default=None)  # -p^-1 mod 2^256
    r_mod: int = 0  # R mod p (Montgomery one)
    r2: int = 0  # R^2 mod p
    r3: int = 0
    n0: int = 0  # -p^-1 mod 2^32, the kernels' word-level constant
    kernel_words: np.ndarray = field(repr=False, default=None)  # p as 8 u32 words, then n0
    _on_device: dict = field(repr=False, default_factory=dict)

    def __post_init__(self):
        p = self.modulus
        R_ = 1 << TOTAL_BITS
        n0 = (-pow(p, -1, 1 << WORD_BITS)) % (1 << WORD_BITS)
        words = [(p >> (WORD_BITS * i)) & 0xFFFFFFFF for i in range(TOTAL_BITS // WORD_BITS)]
        for name, value in (
            ("mod_limbs", int_to_limbs(p)),
            ("nprime_limbs", int_to_limbs((-pow(p, -1, R_)) % R_)),
            ("r_mod", R_ % p),
            ("r2", (R_ * R_) % p),
            ("r3", (R_ * R_ * R_) % p),
            ("n0", n0),
            ("kernel_words", np.array(words + [n0], np.uint32)),
        ):
            object.__setattr__(self, name, value)

    # -- host-side conversions (same as the JAX FieldSpec) ------------------
    def to_mont_int(self, x: int) -> int:
        return x * (1 << TOTAL_BITS) % self.modulus

    def from_mont_int(self, x: int) -> int:
        return x * pow(1 << TOTAL_BITS, -1, self.modulus) % self.modulus

    def encode(self, values) -> np.ndarray:
        """Python ints (any nest) -> Montgomery limb array (uint32, trailing 16)."""
        arr = np.asarray(values, dtype=object)
        raw = b"".join(self.to_mont_int(int(v) % self.modulus).to_bytes(2 * NLIMB, "little") for v in arr.reshape(-1))
        return np.frombuffer(raw, dtype="<u2").astype(np.uint32).reshape(arr.shape + (NLIMB,))

    def decode(self, limbs) -> np.ndarray:
        """Montgomery limb array or tensor -> numpy object array of ints."""
        arr = limbs.cpu().numpy() if isinstance(limbs, torch.Tensor) else np.asarray(limbs)
        shape = arr.shape[:-1]
        flat = arr.reshape(-1, NLIMB)
        out = np.array([self.from_mont_int(limbs_to_int(row)) for row in flat], dtype=object)
        return out.reshape(shape) if shape else out[0]

    # -- constants as tensors, cached per device ------------------------------
    def consts(self, device) -> dict:
        device = torch.device(device)
        cached = self._on_device.get(device)
        if cached is None:
            def t(v):
                return torch.as_tensor(np.asarray(v, np.int64), device=device)

            cached = {
                "mod": t(self.mod_limbs),
                "nprime": t(self.nprime_limbs),
                "one": t(int_to_limbs(self.r_mod)),
                "r2": t(int_to_limbs(self.r2)),
                "raw_one": t(int_to_limbs(1)),
            }
            self._on_device[device] = cached
        return cached


FQ = FieldSpec("Fq", bn254.P)
FR = FieldSpec("Fr", bn254.R)


# ---------------------------------------------------------------------------
# Limb-level helpers (plain PyTorch, any device)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _shifts(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n + 1, dtype=torch.int64, device=device)


def _lookahead(g: torch.Tensor, p: torch.Tensor):
    """Carry-in bits (..., n) and carry-out (...,) of a chain where column i
    generates (g) or propagates (p) a carry; g and p are exclusive 0/1 int64.
    As an adder of A = sum (g_i | p_i) 2^i and B = sum g_i 2^i, the carry into
    bit i is bit i of (A + B) ^ A ^ B, where A + B = sum (2 g_i + p_i) 2^i and
    A ^ B = sum p_i 2^i."""
    n = g.shape[-1]
    sh = _shifts(n, g.device)
    total = ((2 * g + p) << sh[:n]).sum(-1)
    prop = (p << sh[:n]).sum(-1)
    bits = ((total ^ prop).unsqueeze(-1) >> sh) & 1
    return bits[..., :n], bits[..., n]


def _resolve(cols: torch.Tensor, passes: int = 0):
    """Column sums (..., n) -> (exact 16-bit limbs (..., n), carry out (...,)).

    ``passes`` split-and-shift rounds first bring every column below
    2^16 + 2^6 (two rounds suffice for sums below 2^37); after them a column
    generates at most one carry, which the lookahead resolves exactly."""
    carry = None
    for _ in range(passes):
        hi = cols >> LIMB_BITS
        top = hi[..., -1]
        carry = top if carry is None else carry + top
        cols = (cols & LIMB_MASK) + torch.nn.functional.pad(hi[..., :-1], (1, 0))
    g = cols >> LIMB_BITS
    v = cols & LIMB_MASK
    cin, cout = _lookahead(g, (v == LIMB_MASK).long())
    out = (v + cin) & LIMB_MASK
    return out, cout if carry is None else carry + cout


def _add_limbs(a, b):
    """a + b limbwise with carries; returns (limbs, carry out 0/1)."""
    return _resolve(a + b)


def _sub_limbs(a, b):
    """a - b limbwise with borrows; returns (limbs, borrow out 0/1)."""
    d = a - b
    bin_, bout = _lookahead((d < 0).long(), (d == 0).long())
    return (d - bin_) & LIMB_MASK, bout


def _cond_sub_mod(x, spec: FieldSpec, extra=None):
    """Subtract p when x >= p or when ``extra`` (a carry out of the top limb)
    is set: reduces x < 2p into [0, p)."""
    diff, borrow = _sub_limbs(x, spec.consts(x.device)["mod"])
    take = borrow == 0
    if extra is not None:
        take = take | (extra > 0)
    return torch.where(take.unsqueeze(-1), diff, x)


# ---------------------------------------------------------------------------
# Kernel K1 (Montgomery multiply) and mont_pow, with their plain versions
# ---------------------------------------------------------------------------

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


def mont_mul(a, b, spec: FieldSpec):
    """Montgomery product of (..., 16) int64 limb tensors (broadcasting).
    CUDA tensors launch K1 in blocks of ``K1_BLOCK`` threads; CPU tensors
    take ``mont_mul_plain``."""
    _build.check_limbs("mont_mul", a, b)
    if not use_kernel(a, b):
        return mont_mul_plain(a, b, spec)
    a, b = (_build.aligned(t) for t in torch.broadcast_tensors(a, b))
    n = a.numel() // NLIMB
    out = torch.empty_like(a)
    _build.launch("svtpu_mont_mul", a, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _build.field_arg(spec),
                  K1_BLOCK)
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
    _build.check_limbs("mont_pow", a)
    exponent = int(exponent)
    if exponent < 0:
        raise ValueError(f"mont_pow: exponent must be >= 0, got {exponent}")
    if not use_kernel(a):
        return mont_pow_plain(a, exponent, spec)
    a = _build.aligned(a)
    n = a.numel() // NLIMB
    acc = None
    for piece, bits in exponent_pieces(exponent):
        words, _ = exponent_arg(piece)
        out = torch.empty_like(a)
        _build.launch("svtpu_mont_pow", a, a.data_ptr(), None if acc is None else acc.data_ptr(), out.data_ptr(), n,
                      _build.field_arg(spec), words, bits, int(even_odd))
        if n:
            mont_pow.launches += 1
        acc = out
    return acc


mont_pow.launches = 0


# ---------------------------------------------------------------------------
# Public field ops (Montgomery form unless stated otherwise)
# ---------------------------------------------------------------------------


def add(a, b, spec: FieldSpec):
    s, carry = _add_limbs(a, b)
    return _cond_sub_mod(s, spec, extra=carry)


def sub(a, b, spec: FieldSpec):
    d, borrow = _sub_limbs(a, b)
    corrected, _ = _add_limbs(d, spec.consts(d.device)["mod"])
    return torch.where((borrow > 0).unsqueeze(-1), corrected, d)


def neg(a, spec: FieldSpec):
    return sub(torch.zeros_like(a), a, spec)


def mont_sqr(a, spec: FieldSpec):
    return mont_mul(a, a, spec)


def to_mont(a_canonical, spec: FieldSpec):
    return mont_mul(a_canonical, spec.consts(a_canonical.device)["r2"], spec)


def from_mont(a, spec: FieldSpec):
    return mont_mul(a, spec.consts(a.device)["raw_one"], spec)


def ones(shape, spec: FieldSpec, device):
    return spec.consts(device)["one"].expand(*tuple(shape), NLIMB)


def zeros(shape, device):
    return torch.zeros(*tuple(shape), NLIMB, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=4096)
def _constant(value: int, spec: FieldSpec, device: torch.device) -> torch.Tensor:
    # cached: a host-to-device copy waits for the stream, so each constant
    # is copied once per device (callers never write into the result)
    enc = int_to_limbs(spec.to_mont_int(value % spec.modulus)).astype(np.int64)
    return torch.as_tensor(enc, device=device)


def constant(value: int, spec: FieldSpec, shape, device):
    """A python-int constant (canonical) as Montgomery limbs of ``shape``."""
    return _constant(value, spec, torch.device(device)).expand(*tuple(shape), NLIMB)


def is_zero(a):
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def select(cond, a, b):
    """cond boolean (...,); a, b (..., 16)."""
    return torch.where(cond.unsqueeze(-1), a, b)


def pow_const(a, exponent: int, spec: FieldSpec):
    """a^exponent for a python-int exponent >= 0, as the JAX package's
    ``pow_const``: 4-bit fixed windows, MSB first; on CUDA tensors one
    ``mont_pow`` launch below 2^256 (one per 256-bit piece above), its plain
    version on CPU tensors."""
    return mont_pow(a, exponent, spec)


def inv(a, spec: FieldSpec):
    """Fermat inversion a^(p-2); 0 maps to 0."""
    out = pow_const(a, spec.modulus - 2, spec)
    return select(is_zero(a), torch.zeros_like(out), out)


def batch_inv(a, spec: FieldSpec, axis: int = 0):
    """Montgomery-trick batch inversion along ``axis`` (zeros stay zeros):
    prefix products, one inversion, then a backward sweep."""
    a = a.movedim(axis, 0)
    zero_mask = is_zero(a)
    safe = select(zero_mask, ones(a.shape[:-1], spec, a.device), a)
    prefix = [safe[0]]
    for i in range(1, a.shape[0]):
        prefix.append(mont_mul(prefix[-1], safe[i], spec))
    running = inv(prefix[-1], spec)
    out = [None] * a.shape[0]
    for i in range(a.shape[0] - 1, 0, -1):
        out[i] = mont_mul(running, prefix[i - 1], spec)
        running = mont_mul(running, safe[i], spec)
    out[0] = running
    out = torch.stack(out)
    return select(zero_mask, torch.zeros_like(out), out).movedim(0, axis)


def sum_products(pairs, spec: FieldSpec):
    """sum_i a_i * b_i for a list of (a, b) limb tensors."""
    acc = None
    for x, y in pairs:
        t = mont_mul(x, y, spec)
        acc = t if acc is None else add(acc, t, spec)
    return acc
