"""TorchLoader: the loader-generic PLONK verifier interpreted over tensors.

Counterpart of ``snark_verifier_tpu/loader/jax_loader.py``.  Every value
carries the leading batch shape of the proofs being verified, so verifying B
proofs is one eager run over (B, ...) tensors.  Checks that fail do not
raise: they AND into a per-proof ``ok`` mask through ``require``, the role of
the EVM verifier's revert paths.  All tensors are created on the loader's
``device``, the card unless the caller asks for another.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Optional

import torch

from snark_verifier_tpu_torch.loader import EcPoint, Loader, Scalar
from snark_verifier_tpu_torch.ops import curve as CRV
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import msm as MSM
from snark_verifier_tpu_torch.ops import pairing as PAIR
from snark_verifier_tpu_torch.ops.curve import G1
from snark_verifier_tpu_torch.util import bn254

FR, FQ = F.FR, F.FQ

# An IPA deciding key's generators on a device, built once per key and
# device: (id(dk), device) -> (weak reference to dk, G1 of 2^k points).
# Converting 2^20 python-int points takes seconds on the host; an entry goes
# when its key is collected.
_DK_POINTS: dict = {}


def dk_points(dk, device) -> G1:
    """``dk.g`` (python-int affine points) as a point batch on ``device``,
    cached per key object and device; the key's ``g`` must not change."""
    key = (id(dk), torch.device(device))
    hit = _DK_POINTS.get(key)
    if hit is None or hit[0]() is not dk:
        ref = weakref.ref(dk, lambda _, key=key: _DK_POINTS.pop(key, None))
        hit = _DK_POINTS[key] = (ref, CRV.g1_from_affine_ints(dk.g, device))
    return hit[1]


@dataclass
class TorchPoint:
    """EcPoint payload: affine Montgomery coordinates and/or a projective G1."""

    x: Optional[torch.Tensor] = None  # (..., 16) Montgomery Fq
    y: Optional[torch.Tensor] = None
    is_inf: Optional[torch.Tensor] = None  # bool (...,)
    proj: Optional[G1] = None

    def as_proj(self) -> G1:
        if self.proj is not None:
            return self.proj
        shape, dev = self.x.shape[:-1], self.x.device
        inf = self.is_inf if self.is_inf is not None else torch.zeros(shape, dtype=torch.bool, device=dev)
        z = F.select(inf, F.zeros(shape, dev), F.ones(shape, FQ, dev))
        y = F.select(inf, F.ones(shape, FQ, dev), self.y)
        return G1(F.select(inf, F.zeros(shape, dev), self.x), y, z)

    def as_affine(self) -> "TorchPoint":
        if self.x is not None:
            return self
        norm = CRV.g1_normalize(self.proj)
        return TorchPoint(norm.x, norm.y, CRV.g1_is_identity(self.proj), self.proj)


class TorchLoader(Loader):
    def __init__(self, batch_shape=(), device="cuda"):
        self.batch_shape = tuple(batch_shape)
        self.device = torch.device(device)
        self.ok = torch.ones(self.batch_shape, dtype=torch.bool, device=self.device)

    # -- soft assertions -----------------------------------------------------
    def require(self, mask):
        """AND a boolean condition into the per-proof validity mask."""
        self.ok = self.ok & torch.broadcast_to(mask, self.batch_shape)

    # -- scalars -------------------------------------------------------------
    def load_const(self, value: int) -> Scalar:
        return Scalar(self, F.constant(value, FR, (), self.device))

    def scalar_from_mont(self, limbs) -> Scalar:
        return Scalar(self, limbs)

    def add(self, a, b):
        return Scalar(self, F.add(a.value, b.value, FR))

    def sub(self, a, b):
        return Scalar(self, F.sub(a.value, b.value, FR))

    def mul(self, a, b):
        return Scalar(self, F.mont_mul(a.value, b.value, FR))

    def invert(self, a):
        return Scalar(self, F.inv(a.value, FR))

    def pow_const(self, a, exponent: int):
        if exponent == 1:
            return a
        return Scalar(self, F.pow_const(a.value, exponent, FR))

    def batch_invert(self, scalars):
        full = self.batch_shape + (F.NLIMB,)
        stacked = torch.stack([s.value.expand(full) for s in scalars])
        inverted = F.batch_inv(stacked, FR, axis=0)
        return [Scalar(self, inverted[i]) for i in range(len(scalars))]

    def assert_eq(self, annotation, lhs, rhs):
        self.require(F.eq(lhs.value, rhs.value))

    # -- points --------------------------------------------------------------
    def ec_point_load_const(self, point) -> EcPoint:
        dev = self.device
        if point is None:
            inf = torch.ones((), dtype=torch.bool, device=dev)
            return EcPoint(self, TorchPoint(F.zeros((), dev), F.ones((), FQ, dev), inf))
        x, y = point
        inf = torch.zeros((), dtype=torch.bool, device=dev)
        return EcPoint(self, TorchPoint(F.constant(x, FQ, (), dev), F.constant(y, FQ, (), dev), inf))

    def ec_point_assert_eq(self, annotation, lhs, rhs):
        self.require(CRV.g1_eq(lhs.value.as_proj(), rhs.value.as_proj()))

    def multi_scalar_multiplication(self, pairs, constant=None) -> EcPoint:
        assert constant is None, "constant base folded by Msm.evaluate"
        full = self.batch_shape + (F.NLIMB,)
        scalars = torch.stack([F.from_mont(s.value, FR).expand(full) for s, _ in pairs], dim=-2)
        projs = [p.value.as_proj() for _, p in pairs]
        points = G1(*(torch.stack([g[c].expand(full) for g in projs], dim=-2) for c in range(3)))
        return EcPoint(self, TorchPoint(proj=MSM.msm_batched(points, scalars)))

    # -- accumulator limb decoding (pcs/kzg/accumulator.rs:36-83) ------------
    def fq_from_limb_scalars(self, limb_scalars, bits: int = 68):
        """Compose Fr limb scalars into one Fq value: sum_i limb_i * 2^(bits*i)
        mod p, each limb taken mod p like the reference's ``fe_from_limbs``."""
        acc = None
        for i, s in enumerate(limb_scalars):
            fq = F.to_mont(F.from_mont(s.value, FR), FQ)  # canonical < r < p
            term = F.mont_mul(fq, F.constant(pow(2, bits * i, bn254.P), FQ, (), self.device), FQ)
            acc = term if acc is None else F.add(acc, term, FQ)
        return acc

    def ec_point_from_limbs(self, scalars, limbs: int = 4, bits: int = 68):
        """2 * limbs Fr limb scalars -> one affine G1 point; folds the
        on-curve check into ``ok``."""
        assert len(scalars) == 2 * limbs
        full = self.batch_shape + (F.NLIMB,)
        x = self.fq_from_limb_scalars(scalars[:limbs], bits).expand(full)
        y = self.fq_from_limb_scalars(scalars[limbs:], bits).expand(full)
        pt = TorchPoint(x, y, torch.zeros(self.batch_shape, dtype=torch.bool, device=self.device))
        self.require(CRV.g1_is_on_curve(pt.as_proj()))
        return EcPoint(self, pt)

    # -- decider hooks --------------------------------------------------------
    def decide_ipa(self, accumulator, dk):
        """U == MSM(g, h_coeffs(xi)) per proof on the device, folded into
        ``ok``; returns the (batch,) mask (pcs/ipa/decider.rs:47-55).  The
        coefficients of h(X) = prod (1 + xi X^(2^i)) grow by one Fr product
        per xi (k K1 launches); the batch's rows share ``dk.g`` and run as
        one ``msm_serial_rows`` (window 8, unsigned: one K6 launch)."""
        batch = self.batch_shape
        coeffs = F.ones(batch + (1,), FR, self.device)
        for x in reversed([x.value for x in accumulator.xi]):
            coeffs = torch.cat([coeffs, F.mont_mul(coeffs, x[..., None, :], FR)], dim=-2)
        scal = F.from_mont(coeffs, FR)  # (..., 2^k, 16)
        expect = MSM.msm_serial_rows(dk_points(dk, self.device), scal.reshape((-1,) + scal.shape[-2:]))
        expect = G1(*(c.reshape(batch + (F.NLIMB,)) for c in expect))
        ok = CRV.g1_eq(expect, accumulator.u.value.as_proj())
        self.require(ok)
        return ok

    def decide_pairing(self, accumulator, dk):
        """e(lhs, g2) * e(rhs, -s_g2) == 1 per proof on the device, folded
        into ``ok``; returns the (batch,) mask."""
        full = self.batch_shape + (F.NLIMB,)
        lhs, rhs = (G1(*(c.expand(full) for c in p.value.as_proj())) for p in (accumulator.lhs, accumulator.rhs))
        ok = PAIR.kzg_pairing_check(lhs, rhs, dk.g2, dk.s_g2)
        self.require(ok)
        return ok
