"""Pure-Python Keccak-256 oracle (the reference re-exports sha3's Keccak256,
snark-verifier src/util/hash.rs:9-10).

The permutation is validated against hashlib's SHA3-256 (same keccak-f[1600],
different padding byte), then keccak256 uses the legacy 0x01 padding.
"""

from __future__ import annotations

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets, indexed by lane x + 5*y
_RHO = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]

_MASK = (1 << 64) - 1


def _rotl(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & _MASK


def keccak_f(state: list[int]) -> list[int]:
    """keccak-f[1600] on 25 64-bit lanes (lane index = x + 5*y)."""
    a = list(state)
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi: B[y, 2x+3y] = rot(A[x, y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _RHO[x + 5 * y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)] & _MASK)
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


_RATE = 136  # bytes, for 256-bit output


def _sponge(data: bytes, pad_byte: int) -> bytes:
    padded = bytearray(data)
    pad_len = _RATE - (len(data) % _RATE)
    padded += bytes([pad_byte] + [0] * (pad_len - 2) + [0x80]) if pad_len >= 2 else b""
    if pad_len == 1:
        padded += bytes([pad_byte | 0x80])
    state = [0] * 25
    for off in range(0, len(padded), _RATE):
        block = padded[off : off + _RATE]
        for i in range(_RATE // 8):
            state[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        state = keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


def keccak256(data: bytes) -> bytes:
    """Legacy Keccak-256 (0x01 padding) as used by Ethereum / EvmTranscript."""
    return _sponge(data, 0x01)


def sha3_256(data: bytes) -> bytes:
    """NIST SHA3-256 (0x06 padding) — only used to validate keccak_f against
    hashlib in tests."""
    return _sponge(data, 0x06)
