"""Batched modular arithmetic over BN254 Fq/Fr on int64 limb tensors.

Counterpart of ``snark_verifier_tpu/ops/field.py``.  Elements are
``(..., 16)`` int64 tensors of 16-bit little-endian limbs in Montgomery form
(R = 2^256); every op broadcasts over leading batch dims and returns the
same canonical limbs as the JAX package, bit for bit.

``mont_mul`` goes through ``field_cuda.mont_mul``: kernel K1 for CUDA
tensors, its plain version for CPU tensors; ``pow_const`` (and ``inv``)
through ``field_cuda.mont_pow``, the whole chain in one launch.  The other
ops are plain PyTorch on either device.  Carries are resolved without a
sequential limb loop: a column's carry-in is a bit of ``(A + B) ^ A ^ B``,
where A and B pack each column's propagate-or-generate and generate flags
into one int64 (the carry-lookahead adder done by the integer adder).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

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


def mont_mul(a, b, spec: FieldSpec):
    """Montgomery product; kernel K1 on CUDA tensors, plain on CPU tensors."""
    from snark_verifier_tpu_torch.ops import field_cuda

    return field_cuda.mont_mul(a, b, spec)


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
    from snark_verifier_tpu_torch.ops import field_cuda

    return field_cuda.mont_pow(a, exponent, spec)


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
