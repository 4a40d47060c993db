"""EVM (Keccak-256) and Poseidon transcripts over tensors.

Counterparts of ``JaxEvmTranscript`` and ``JaxPoseidonTranscript`` in
``snark_verifier_tpu/system/halo2/transcript_jax.py``: the byte semantics of
``NativeEvmTranscript`` and ``NativePoseidonTranscript``, over a
(batch..., L) int64 byte tensor.  The cursor and buffer lengths are fixed by
the protocol; failed validity checks (non-canonical scalars and coordinates,
off-curve or non-residue points) AND into the loader's ``ok`` mask instead
of raising.
"""

from __future__ import annotations

import torch

from snark_verifier_tpu_torch.loader import EcPoint, Scalar
from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader, TorchPoint
from snark_verifier_tpu_torch.ops import curve as CRV
from snark_verifier_tpu_torch.ops import encode as ENC
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import keccak as K
from snark_verifier_tpu_torch.ops.poseidon import TorchPoseidonSponge
from snark_verifier_tpu_torch.util import bn254
from snark_verifier_tpu_torch.util.poseidon import default_spec
from snark_verifier_tpu_torch.util.transcript import TranscriptRead

FR, FQ = F.FR, F.FQ


class TorchEvmTranscript(TranscriptRead):
    def __init__(self, proof_bytes, loader: TorchLoader):
        """proof_bytes: (batch..., L) int64 tensor of byte values."""
        self._loader = loader
        self.stream = proof_bytes
        self.cursor = 0
        self.buf = []  # (batch..., k) byte tensors absorbed since the last squeeze
        self.buf_len = 0

    def loader(self):
        return self._loader

    def _append(self, data):
        self.buf.append(data)
        self.buf_len += data.shape[-1]

    # -- transcript core ----------------------------------------------------
    def squeeze_challenge(self) -> Scalar:
        batch, dev = self._loader.batch_shape, self._loader.device
        parts = [b.expand(*batch, b.shape[-1]) for b in self.buf]
        if self.buf_len == 0x20:
            parts.append(torch.ones(*batch, 1, dtype=torch.int64, device=dev))
        data = torch.cat(parts, dim=-1) if parts else torch.zeros(*batch, 0, dtype=torch.int64, device=dev)
        digest = K.keccak256(data, data.shape[-1])
        self.buf = [digest]
        self.buf_len = 32
        value = ENC.reduce_u256(ENC.be_bytes_to_limbs(digest), FR)
        return Scalar(self._loader, F.to_mont(value, FR))

    def common_scalar(self, scalar: Scalar):
        self._append(ENC.limbs_to_be_bytes(F.from_mont(scalar.value, FR)))

    def common_ec_point(self, ec_point: EcPoint):
        pt = ec_point.value.as_affine()
        x = F.from_mont(pt.x, FQ)
        y = F.from_mont(pt.y, FQ)
        if pt.is_inf is not None:  # absorbing the identity is invalid
            self._loader.require(~pt.is_inf)
        self._append(torch.cat([ENC.limbs_to_be_bytes(x), ENC.limbs_to_be_bytes(y)], dim=-1))

    # -- read side ----------------------------------------------------------
    def _take(self, nbytes):
        data = self.stream[..., self.cursor : self.cursor + nbytes]
        if data.shape[-1] != nbytes:
            raise ValueError("proof stream too short")
        self.cursor += nbytes
        return data

    def read_scalar(self) -> Scalar:
        data = self._take(32)
        self._append(data)
        limbs = ENC.be_bytes_to_limbs(data)
        self._loader.require(ENC.is_lt_modulus(limbs, FR))
        return Scalar(self._loader, F.to_mont(limbs, FR))

    def read_ec_point(self) -> EcPoint:
        data = self._take(64)
        self._append(data)
        xl = ENC.be_bytes_to_limbs(data[..., :32])
        yl = ENC.be_bytes_to_limbs(data[..., 32:])
        self._loader.require(ENC.is_lt_modulus(xl, FQ))
        self._loader.require(ENC.is_lt_modulus(yl, FQ))
        x, y = F.to_mont(xl, FQ), F.to_mont(yl, FQ)
        pt = TorchPoint(x, y, torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device))
        self._loader.require(CRV.g1_is_on_curve(pt.as_proj()))
        return EcPoint(self._loader, pt)


class TorchPoseidonTranscript(TranscriptRead):
    """Poseidon transcript: scalars are 32-byte little-endian; points are 32
    bytes compressed (x little-endian, the parity of y in the top bit of
    byte 31); an absorbed point contributes [x mod r, y mod r].  y is
    recovered on the device as c^((p+1)/4) with c = x^3 + 3 (p = 3 mod 4);
    x < p and y^2 == c fold into ``ok``, so a non-residue clears it."""

    def __init__(self, proof_bytes, loader: TorchLoader, spec=None):
        """proof_bytes: (batch..., L) int64 tensor of byte values."""
        self._loader = loader
        self.stream = proof_bytes
        self.cursor = 0
        self.sponge = TorchPoseidonSponge(spec or default_spec(), loader.batch_shape, loader.device)

    def loader(self):
        return self._loader

    def _full(self, value):
        return value.expand(*self._loader.batch_shape, value.shape[-1])

    def _take(self, nbytes):
        data = self.stream[..., self.cursor : self.cursor + nbytes]
        if data.shape[-1] != nbytes:
            raise ValueError("proof stream too short")
        self.cursor += nbytes
        return data

    def squeeze_challenge(self) -> Scalar:
        return Scalar(self._loader, self._full(self.sponge.squeeze()))

    def common_scalar(self, scalar: Scalar):
        self.sponge.update([self._full(scalar.value)])

    def common_ec_point(self, ec_point: EcPoint):
        pt = ec_point.value.as_affine()
        if pt.is_inf is not None:  # absorbing the identity is invalid
            self._loader.require(~pt.is_inf)
        for coord in (pt.x, pt.y):  # fe_to_fe: canonical Fq, reduced mod r
            fr = ENC.reduce_u256(F.from_mont(coord, FQ), FR)
            self.sponge.update([self._full(F.to_mont(fr, FR))])

    def read_scalar(self) -> Scalar:
        limbs = ENC.le_bytes_to_limbs(self._take(32))
        self._loader.require(ENC.is_lt_modulus(limbs, FR))
        s = Scalar(self._loader, F.to_mont(limbs, FR))
        self.common_scalar(s)
        return s

    def read_ec_point(self) -> EcPoint:
        data = self._take(32)
        parity = (data[..., 31] >> 7) & 1
        xl = ENC.le_bytes_to_limbs(torch.cat([data[..., :31], data[..., 31:] & 0x7F], dim=-1))
        self._loader.require(ENC.is_lt_modulus(xl, FQ))
        x = F.to_mont(xl, FQ)
        x3 = F.mont_mul(F.mont_mul(x, x, FQ), x, FQ)
        c = F.add(x3, F.constant(bn254.G1_B, FQ, x.shape[:-1], x.device), FQ)
        y = F.pow_const(c, (bn254.P + 1) // 4, FQ)
        self._loader.require(F.eq(F.mont_mul(y, y, FQ), c))
        # the root whose canonical value has the requested parity
        pick_neg = (F.from_mont(y, FQ)[..., 0] & 1) != parity
        y = F.select(pick_neg, F.neg(y, FQ), y)
        pt = TorchPoint(x, y, torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device))
        ec = EcPoint(self._loader, pt)
        self.common_ec_point(ec)
        return ec
