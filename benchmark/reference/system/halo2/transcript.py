"""EVM (Keccak-256) transcript, native interpreter.

Byte-format parity with the reference's `EvmTranscript` over NativeLoader
(system/halo2/transcript/evm.rs:159-268), read side:

* the proof stream is big-endian: scalars are 32-byte BE Fr, points are
  uncompressed `x || y`, each 32-byte BE Fq (identity is not encodable);
* absorbing appends the same BE bytes to the running buffer;
* squeezing hashes the buffer with keccak256 — prefixed by the 0x01
  domain-separation byte iff the buffer is exactly one stale 32-byte hash —
  resets the buffer to the digest, and reduces the digest (as a BE integer)
  mod r.
"""

from __future__ import annotations

import io

from benchmark.reference.errors import TranscriptError
from benchmark.reference.loader import EcPoint, Scalar
from benchmark.reference.loader.native import NativeLoader
from benchmark.reference.util import bn254
from benchmark.reference.util.keccak import keccak256
from benchmark.reference.util.transcript import TranscriptRead


class NativeEvmTranscript(TranscriptRead):
    """The read side over a proof's bytes, python-int backend."""

    def __init__(self, stream: bytes, loader: NativeLoader | None = None):
        self._loader = loader or NativeLoader()
        self.stream = io.BytesIO(stream)
        self.buf = bytearray()

    def loader(self):
        return self._loader

    # -- transcript core ----------------------------------------------------
    def squeeze_challenge(self) -> Scalar:
        data = bytes(self.buf)
        if len(self.buf) == 0x20:
            data += b"\x01"
        digest = keccak256(data)
        self.buf = bytearray(digest)
        return self._loader.load_const(int.from_bytes(digest, "big") % bn254.R)

    def common_scalar(self, scalar: Scalar):
        self.buf += scalar.value.to_bytes(32, "big")

    def common_ec_point(self, ec_point: EcPoint):
        if ec_point.value is None:
            raise TranscriptError("cannot absorb the identity point")
        x, y = ec_point.value
        self.buf += x.to_bytes(32, "big") + y.to_bytes(32, "big")

    # -- read side ----------------------------------------------------------
    def read_scalar(self) -> Scalar:
        data = self.stream.read(32)
        if len(data) != 32:
            raise TranscriptError("unexpected end of proof stream")
        value = int.from_bytes(data, "big")
        if value >= bn254.R:
            raise TranscriptError("invalid scalar encoding in proof")
        scalar = self._loader.load_const(value)
        self.common_scalar(scalar)
        return scalar

    def read_ec_point(self) -> EcPoint:
        data = self.stream.read(64)
        if len(data) != 64:
            raise TranscriptError("unexpected end of proof stream")
        x = int.from_bytes(data[:32], "big")
        y = int.from_bytes(data[32:], "big")
        if x >= bn254.P or y >= bn254.P:
            raise TranscriptError("invalid coordinate encoding in proof")
        if not bn254.g1_is_on_curve((x, y)):
            raise TranscriptError("point is not on the curve")
        pt = EcPoint(self._loader, (x, y))
        self.common_ec_point(pt)
        return pt


# ---------------------------------------------------------------------------
# Poseidon transcript (native) — parity: system/halo2/transcript/halo2.rs
# (NativeLoader impls, :175-268 read side).
# Wire format: scalars 32-byte LE; points 32-byte compressed (x LE, y-parity
# in bit 7 of byte 31; identity = all zeros).  Points absorb as
# [x mod r, y mod r] (fe_to_fe), scalars absorb directly.
# ---------------------------------------------------------------------------


def decompress_g1(data: bytes, curve=bn254):
    from benchmark.reference.util.curves import sqrt_mod

    if data == bytes(32):
        return None
    raw = bytearray(data)
    parity = raw[31] >> 7
    raw[31] &= 0x7F
    x = int.from_bytes(raw, "little")
    if x >= curve.P:
        raise TranscriptError("invalid compressed x coordinate")
    y2 = (pow(x, 3, curve.P) + curve.G1_B) % curve.P
    y = sqrt_mod(y2, curve.P)
    if y is None:
        raise TranscriptError("compressed point is not on the curve")
    if y & 1 != parity:
        y = curve.P - y
    return (x, y)


class NativePoseidonTranscript(TranscriptRead):
    def __init__(self, stream: bytes, loader: NativeLoader | None = None, spec=None):
        from benchmark.reference.util.poseidon import PoseidonSponge, default_spec

        self._loader = loader or NativeLoader()
        self.stream = io.BytesIO(stream)
        self.sponge = PoseidonSponge(spec or default_spec())

    def loader(self):
        return self._loader

    def squeeze_challenge(self) -> Scalar:
        return self._loader.load_const(self.sponge.squeeze())

    def common_scalar(self, scalar: Scalar):
        self.sponge.update([scalar.value])

    def common_ec_point(self, ec_point: EcPoint):
        if ec_point.value is None:
            raise TranscriptError("cannot absorb the identity point")
        x, y = ec_point.value
        self.sponge.update([x % bn254.R, y % bn254.R])

    def read_scalar(self) -> Scalar:
        data = self.stream.read(32)
        if len(data) != 32:
            raise TranscriptError("unexpected end of proof stream")
        value = int.from_bytes(data, "little")
        if value >= self._loader.curve.R:
            raise TranscriptError("invalid scalar encoding in proof")
        scalar = self._loader.load_const(value)
        self.common_scalar(scalar)
        return scalar

    def read_ec_point(self) -> EcPoint:
        data = self.stream.read(32)
        if len(data) != 32:
            raise TranscriptError("unexpected end of proof stream")
        pt = EcPoint(self._loader, decompress_g1(data, self._loader.curve))
        self.common_ec_point(pt)
        return pt
