"""Proof corruptions of the traffic, frozen from the port's ``entry.corrupt``
and ``entry.corrupt_compressed``."""

from __future__ import annotations

from benchmark.reference.util import bn254


def bit_flip(proof: bytes, offset: int = 100, mask: int = 0x40) -> bytes:
    """Flip one bit of a commitment byte of a Keccak-transcript proof: the
    point goes off the curve, so the succinct verify must reject it."""
    bad = bytearray(proof)
    bad[offset] ^= mask
    return bytes(bad)


def compressed(proof: bytes, offset: int, out_of_range: bool) -> bytes:
    """Corrupt the compressed point at ``offset`` of a Poseidon-transcript
    proof: with ``out_of_range`` its x becomes >= p (the top bits set), else
    x moves by the least amount that makes x^3 + 3 a non-residue, so no y
    exists."""
    bad = bytearray(proof)
    if out_of_range:
        bad[offset + 31] |= 0x7F
        return bytes(bad)
    x = int.from_bytes(bytes(bad[offset : offset + 31]) + bytes([bad[offset + 31] & 0x7F]), "little")
    while True:
        x = (x + 1) % bn254.P
        c = (pow(x, 3, bn254.P) + bn254.G1_B) % bn254.P
        if pow(c, (bn254.P - 1) // 2, bn254.P) == bn254.P - 1:
            break
    bad[offset : offset + 32] = (x | ((bad[offset + 31] >> 7) << 255)).to_bytes(32, "little")
    return bytes(bad)
