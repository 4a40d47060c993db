"""Batched Keccak-256 on int64 byte tensors.

Counterpart of ``snark_verifier_tpu/ops/keccak.py``, which is XLA and not a
Pallas kernel.  ``keccak256`` runs kernel K11 (``csrc/keccak.cu``) on CUDA
tensors: the padding, every block's absorb and keccak-f[1600], and the
squeeze of every row in one launch.  On CPU tensors it runs
``keccak256_plain``, plain PyTorch: a 64-bit lane is one int64 (two's
complement bits), so the state is ``(..., 25)``; rotations are shifts with a
mask that undoes the sign fill of the arithmetic right shift.  Message
lengths are fixed by the protocol, so padding is a constant tail.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.util.keccak import _RHO, _ROUND_CONSTANTS

RATE = 136  # bytes
LANES_IN_RATE = RATE // 8

# pi: dst[y + 5*((2x + 3y) % 5)] = src[x + 5y], so dst[i] = src[_PI_SRC[i]]
_PI_SRC = np.zeros(25, np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_RHO_AT_DST = np.array(_RHO, np.int64)[_PI_SRC]  # rotation applied after the pi gather

# chi: a[i] = b[i] ^ (~b[chi1[i]] & b[chi2[i]])
_CHI1 = np.array([(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)], np.int64)
_CHI2 = np.array([(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)], np.int64)
# theta neighbours of column x, and lane i -> its column i % 5
_TH_M1 = np.array([(x - 1) % 5 for x in range(5)], np.int64)
_TH_P1 = np.array([(x + 1) % 5 for x in range(5)], np.int64)
_COLUMN = np.arange(25, dtype=np.int64) % 5


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    rot = _RHO_AT_DST % 64
    return {
        "pi": t(_PI_SRC),
        "rot": t(rot),
        "rot_back": t(63 - rot),  # x >> (64 - r) as (x >> (63 - r)) >> 1, defined at r = 0
        "rot_mask": t([(1 << int(r)) - 1 for r in rot]),
        "chi1": t(_CHI1),
        "chi2": t(_CHI2),
        "th_m1": t(_TH_M1),
        "th_p1": t(_TH_P1),
        "column": t(_COLUMN),
        "rc": [_signed64(rc) for rc in _ROUND_CONSTANTS],
    }


def _rotl(x, r, r_back, mask):
    return (x << r) | (((x >> r_back) >> 1) & mask)


def keccak_f(state):
    """keccak-f[1600] on (..., 25) int64 lanes."""
    c = _consts(state.device)
    for rc in c["rc"]:
        # theta: d[x] = col[x-1] ^ rotl(col[x+1], 1), xored into every lane of column x
        col = state[..., 0:5] ^ state[..., 5:10] ^ state[..., 10:15] ^ state[..., 15:20] ^ state[..., 20:25]
        p1 = col[..., c["th_p1"]]
        d = col[..., c["th_m1"]] ^ (p1 << 1) ^ ((p1 >> 63) & 1)
        state = state ^ d[..., c["column"]]
        # rho + pi
        b = _rotl(state[..., c["pi"]], c["rot"], c["rot_back"], c["rot_mask"])
        # chi
        state = b ^ (~b[..., c["chi1"]] & b[..., c["chi2"]])
        # iota
        state = torch.cat([state[..., :1] ^ rc, state[..., 1:]], dim=-1)
    return state


def _bytes_to_lanes(block):
    """(..., 136) byte values -> (..., 17) int64 lanes (little-endian)."""
    b = block.reshape(*block.shape[:-1], LANES_IN_RATE, 8)
    shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=block.device)
    return (b << shifts).sum(-1)  # disjoint bits: the sum is an OR (wraps into the sign bit)


def keccak256_plain(data, length: int):
    """Keccak-256 of (..., length) byte tensors (int64 values 0..255) in
    plain PyTorch, K11's plain version.  Returns (..., 32) digest bytes."""
    batch = data.shape[:-1]
    pad_len = RATE - (length % RATE)
    pad = np.zeros(pad_len, np.int64)
    pad[0] |= 0x01
    pad[-1] |= 0x80
    pad = torch.as_tensor(pad, device=data.device)
    padded = torch.cat([data.long(), pad.expand(*batch, pad_len)], dim=-1)
    state = torch.zeros(*batch, 25, dtype=torch.int64, device=data.device)
    for blk in range(padded.shape[-1] // RATE):
        lanes = _bytes_to_lanes(padded[..., blk * RATE : (blk + 1) * RATE])
        state = torch.cat([state[..., :LANES_IN_RATE] ^ lanes, state[..., LANES_IN_RATE:]], dim=-1)
        state = keccak_f(state)
    shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=data.device)
    out = (state[..., :4].unsqueeze(-1) >> shifts) & 0xFF  # (..., 4, 8)
    return out.reshape(*batch, 32)


def keccak256_cuda(data, length: int):
    """K11: Keccak-256 of every row in one launch, on a CUDA tensor of
    (..., length) int64 byte values (0..255; an expanded or strided tensor is
    copied to contiguous rows).  Returns (..., 32) int64 digest bytes.  A
    contiguous input costs the host one aten op, the output's allocation."""
    if data.dtype != torch.int64:
        raise ValueError(f"keccak256: expected int64 byte values, got {data.dtype}")
    batch = data.shape[:-1]
    rows = math.prod(batch)
    msg = data.contiguous()  # (batch..., length) contiguous is (rows, length) row-major
    out = torch.empty(*batch, 32, dtype=torch.int64, device=data.device)
    _build.launch("svtpu_keccak256", data, msg.data_ptr(), length, out.data_ptr(), rows)
    if rows:
        keccak256_cuda.launches += 1
    return out


keccak256_cuda.launches = 0


def keccak256(data, length: int):
    """Keccak-256 of (..., length) byte tensors (int64 values 0..255).
    Returns (..., 32) digest bytes: K11 (``keccak256_cuda``, one launch) on a
    CUDA tensor, ``keccak256_plain`` on a CPU tensor; raises for any other
    device.  Same bytes either way.  ``TorchEvmTranscript`` calls it once per
    squeeze, by this module's attribute."""
    if data.shape[-1] != length:
        raise ValueError(f"keccak256: last axis {data.shape[-1]} != length {length}")
    if use_kernel(data):
        return keccak256_cuda(data, length)
    return keccak256_plain(data, length)
