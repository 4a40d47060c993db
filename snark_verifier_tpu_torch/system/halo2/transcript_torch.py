"""EVM (Keccak-256) transcript over tensors.

Counterpart of ``JaxEvmTranscript`` in
``snark_verifier_tpu/system/halo2/transcript_jax.py``: the byte semantics of
``NativeEvmTranscript``, over a (batch..., L) int64 byte tensor.  The cursor
and buffer lengths are fixed by the protocol; failed validity checks
(non-canonical scalars, off-curve points) AND into the loader's ``ok`` mask.
"""

from __future__ import annotations

import torch

from snark_verifier_tpu_torch.loader import EcPoint, Scalar
from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader, TorchPoint
from snark_verifier_tpu_torch.ops import curve as CRV
from snark_verifier_tpu_torch.ops import encode as ENC
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import keccak as K
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
