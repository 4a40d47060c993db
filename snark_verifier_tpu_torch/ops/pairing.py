"""Optimal-ate pairing on int64 limb tensors: Miller loop and final
exponentiation, for the KZG decider's e(lhs, g2) * e(rhs, -s_g2) == 1.

Counterpart of ``snark_verifier_tpu/ops/pairing.py``.  The G2 points are
host constants (the deciding key), so each Miller line's slope and offset
over Fq2 are host constants too (``_line_constants``) and the loop
evaluates them at the batched G1 points: 2 Fq products per line and one
Fq12 product.  Both Miller loops of the check run as one loop at doubled
batch.  The final exponentiation is the straight Scott addition chain of
``util/bn254.final_exponentiation_chain`` on the flat Fq12 layout.

On CUDA tensors each half is one launch of a K7 kernel (``csrc/tower.cu``,
replacing ``snark_verifier_tpu/ops/tower_pallas.py`` ``_f12_mul_kernel``,
which the JAX package launches once per Fq12 product): ``miller_loop_pair``
runs all steps of both loops from the line tape of ``_line_tensors``, and
``final_exponentiation`` runs ``_combine``, the Fq12 inverse (one Fermat
chain in Fq), the easy part and the hard-part chain, with ``_frob_tables``
as an argument.  A check is two launches.  ``miller_loop_pair_plain`` and
``final_exponentiation_plain`` keep the step loop and the chain with
``tower.fq12_mul_flat_plain``; the wrappers take them for CPU tensors.  On CUDA
tensors the plain versions' other Fq products (the line products, the
Frobenius maps, the tower inverse) go through K1.  Every value stays
reduced below p, so the kernels and the plain versions agree limb for limb.

Left out, as TPU workarounds: the tape VM of the final exponentiation and
the staged jits (they dodge XLA compile time) and the padding of small
batches to 8.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import curve as CRV
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import tower as T
from snark_verifier_tpu_torch.ops.limbs import int_to_limbs
from snark_verifier_tpu_torch.util import bn254

FQ = F.FQ


def _key_to_g2(q_key):
    (x0, x1), (y0, y1) = q_key
    return ((x0, x1), (y0, y1))


def _g2_key(q):
    return ((q[0][0], q[0][1]), (q[1][0], q[1][1]))


@functools.lru_cache(maxsize=8)
def _line_constants(q_key):
    """Host: run the oracle Miller loop on constant Q, recording each line's
    (lambda, c3 = lambda x_q - y_q) in Fq2 and the step kind.  Returns a
    list of ("dbl" | "add", lam, c3)."""
    q = _key_to_g2(q_key)
    lines = []
    t = q
    for i in range(len(bn254.ATE_NAF) - 2, -1, -1):
        lam = bn254.fq2_mul(
            bn254.fq2_scalar(bn254.fq2_sqr(t[0]), 3),
            bn254.fq2_inv(bn254.fq2_scalar(t[1], 2)),
        )
        c3 = bn254.fq2_sub(bn254.fq2_mul(lam, t[0]), t[1])
        lines.append(("dbl", lam, c3))
        x3 = bn254.fq2_sub(bn254.fq2_sqr(lam), bn254.fq2_scalar(t[0], 2))
        y3 = bn254.fq2_sub(bn254.fq2_mul(lam, bn254.fq2_sub(t[0], x3)), t[1])
        t = (x3, y3)
        naf = bn254.ATE_NAF[i]
        if naf:
            qq = q if naf == 1 else bn254.g2_neg(q)
            lam = bn254.fq2_mul(bn254.fq2_sub(t[1], qq[1]), bn254.fq2_inv(bn254.fq2_sub(t[0], qq[0])))
            c3 = bn254.fq2_sub(bn254.fq2_mul(lam, qq[0]), qq[1])
            lines.append(("add", lam, c3))
            x3 = bn254.fq2_sub(bn254.fq2_sqr(lam), bn254.fq2_add(qq[0], t[0]))
            y3 = bn254.fq2_sub(bn254.fq2_mul(lam, bn254.fq2_sub(qq[0], x3)), qq[1])
            t = (x3, y3)
    for qq in (bn254._g2_frobenius(q), bn254.g2_neg(bn254._g2_frobenius(bn254._g2_frobenius(q)))):
        lam = bn254.fq2_mul(bn254.fq2_sub(t[1], qq[1]), bn254.fq2_inv(bn254.fq2_sub(t[0], qq[0])))
        c3 = bn254.fq2_sub(bn254.fq2_mul(lam, qq[0]), qq[1])
        lines.append(("add", lam, c3))
        x3 = bn254.fq2_sub(bn254.fq2_sqr(lam), bn254.fq2_add(qq[0], t[0]))
        y3 = bn254.fq2_sub(bn254.fq2_mul(lam, bn254.fq2_sub(qq[0], x3)), qq[1])
        t = (x3, y3)
    return lines


def _enc(v: int) -> np.ndarray:
    return int_to_limbs(FQ.to_mont_int(v)).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _line_tensors(q1_key, q2_key, device: torch.device):
    """The two keys' line constants side by side: per step, (2, 2, 16)
    Montgomery limbs of lam (key, Fq2 component) and of c3, and whether the
    step doubles (a list, and an int64 tensor for the kernel).  The dbl/add
    sequence follows ATE_NAF alone, so the two tapes align step for step."""
    lines1, lines2 = _line_constants(q1_key), _line_constants(q2_key)
    assert [k for k, _, _ in lines1] == [k for k, _, _ in lines2]
    lam = np.array([[[_enc(l[1][0]), _enc(l[1][1])] for l in pair] for pair in zip(lines1, lines2)])
    c3 = np.array([[[_enc(l[2][0]), _enc(l[2][1])] for l in pair] for pair in zip(lines1, lines2)])
    is_dbl = [k == "dbl" for k, _, _ in lines1]
    dbl = torch.as_tensor(is_dbl, dtype=torch.int64, device=device)
    return is_dbl, torch.as_tensor(lam, device=device), torch.as_tensor(c3, device=device), dbl


def _mul_flat(x, y):
    """Flat Fq12 product of the plain versions."""
    return T.fq12_mul_flat_plain(x, y)


def _conj_flat(x):
    return torch.cat([x[:6], F.neg(x[6:], FQ)], dim=0)


@functools.lru_cache(maxsize=None)
def _frob_tables(device: torch.device):
    """Per-power Frobenius data for the flat layout: coefficient limbs
    (2 powers, 6 Fq2 slots, 2 components, 16 limbs).  Slot (l, j) covers
    flat components 2(3l + j) and 2(3l + j) + 1; its coefficient is
    FROB_FQ6_C{j}[k] * (FROB_FQ12_C1[k] if l else 1).  Power 1 conjugates,
    power 2 does not."""
    tab = np.zeros((2, 6, 2, 16), np.int64)
    for k in (1, 2):
        c6 = [(1, 0), bn254.FROB_FQ6_C1[k], bn254.FROB_FQ6_C2[k]]
        for l in range(2):
            for j in range(3):
                coef = c6[j]
                if l:
                    coef = bn254.fq2_mul(coef, bn254.FROB_FQ12_C1[k])
                tab[k - 1, 3 * l + j, 0] = _enc(coef[0])
                tab[k - 1, 3 * l + j, 1] = _enc(coef[1])
    return torch.as_tensor(tab, device=device)


def _frob_flat(x, power: int):
    """Frobenius^power (1 or 2) on a flat Fq12 (12, *B, 16): each Fq2 slot
    (conjugated for power 1) times its coefficient, the 18 products as one
    batched multiply."""
    coeff = _frob_tables(x.device)[power - 1]  # (6, 2, 16)
    a0, a1 = x[0::2], x[1::2]  # (6, *B, 16)
    if power % 2:
        a1 = F.neg(a1, FQ)
    view = (6,) + (1,) * (a0.dim() - 2) + (16,)
    c0, c1 = coeff[:, 0].reshape(view).expand_as(a0), coeff[:, 1].reshape(view).expand_as(a0)
    lhs = torch.cat([a0, a1, F.add(a0, a1, FQ)])
    rhs = torch.cat([c0, c1, F.add(c0, c1, FQ)])
    rr = F.mont_mul(lhs, rhs, FQ)
    t0, t1, t2 = rr[:6], rr[6:12], rr[12:]
    r0 = F.sub(t0, t1, FQ)
    r1 = F.sub(t2, F.add(t0, t1, FQ), FQ)
    return torch.stack([r0, r1], dim=1).reshape(x.shape)


def _ones_flat(shape, device):
    return T.fq12_to_flat(T.fq12_ones(shape, device))


def miller_loop_pair_plain(px1, py1, px2, py2, q1, q2):
    """Plain version of the Miller-loop kernel: both Miller loops of the
    KZG check in one loop at doubled batch: lanes [0, B) evaluate q1's
    lines at (px1, py1), lanes [B, 2B) q2's at (px2, py2).  Affine
    Montgomery G1 coordinates (B, 16); returns the flat Fq12 values (f1,
    f2), each (12, B, 16).

    Line at P: l = py - lam px w + (lam x_t - y_t) w^3, embedded sparsely as
    ((py, 0, 0), (-lam px, c3, 0)), the oracle's embedding."""
    B = px1.shape[0]
    dev = px1.device
    is_dbl, lam, c3, _ = _line_tensors(_g2_key(q1), _g2_key(q2), dev)
    px = torch.cat([px1, px2])
    py = torch.cat([py1, py2])
    neg_px = F.neg(px, FQ)
    halves = torch.arange(2 * B, device=dev) >= B  # lane -> key 0 or 1
    zero = F.zeros((2 * B,), dev)
    f = _ones_flat((2 * B,), dev)
    for step, dbl in enumerate(is_dbl):
        if dbl:
            f = _mul_flat(f, f)
        lam_s = lam[step][halves.long()]  # (2B, 2, 16)
        c3_s = c3[step][halves.long()]
        lam_px = F.mont_mul(lam_s.transpose(0, 1), neg_px.unsqueeze(0), FQ)  # (2, 2B, 16)
        line = torch.stack([py, zero, zero, zero, zero, zero, lam_px[0], lam_px[1], c3_s[:, 0], c3_s[:, 1], zero, zero])
        f = _mul_flat(f, line)
    return f[:, :B], f[:, B:]


def miller_loop_pair(px1, py1, px2, py2, q1, q2):
    """Both Miller loops of the KZG check, shapes as
    ``miller_loop_pair_plain``.  CUDA tensors launch the Miller-loop kernel
    (every step, one warp per lane of the doubled batch); CPU tensors take
    ``miller_loop_pair_plain``."""
    _build.check_limbs("miller_loop_pair", px1, py1, px2, py2)
    if px1.dim() != 2 or any(t.shape != px1.shape for t in (py1, px2, py2)):
        raise ValueError(f"miller_loop_pair: expected four (B, {F.NLIMB}) coordinates")
    if not use_kernel(px1, py1, px2, py2):
        return miller_loop_pair_plain(px1, py1, px2, py2, q1, q2)
    B = px1.shape[0]
    _, lam, c3, dbl = _line_tensors(_g2_key(q1), _g2_key(q2), px1.device)
    px, py = _build.aligned(torch.cat([px1, px2])), _build.aligned(torch.cat([py1, py2]))
    out = torch.empty(12, 2 * B, F.NLIMB, dtype=torch.int64, device=px.device)
    _build.launch("svtpu_miller_loop", px, px.data_ptr(), py.data_ptr(), lam.data_ptr(), c3.data_ptr(), dbl.data_ptr(),
                  out.data_ptr(), 2 * B, B, dbl.shape[0], _build.field_arg(FQ))
    if B:
        miller_loop_pair.launches += 1
    return out[:, :B], out[:, B:]


miller_loop_pair.launches = 0


def _combine(f1, f2, lhs_inf, rhs_inf):
    """f1 * f2 with the loop value of an identity input replaced by one."""
    one = _ones_flat(lhs_inf.shape, lhs_inf.device)
    return _mul_flat(torch.where(lhs_inf.view(1, -1, 1), one, f1), torch.where(rhs_inf.view(1, -1, 1), one, f2))


def _pow_x(x):
    """x^BN_X, left to right over BN_X's bits."""
    acc = x
    for bit in bin(bn254.BN_X)[3:]:
        acc = _mul_flat(acc, acc)
        if bit == "1":
            acc = _mul_flat(acc, x)
    return acc


def final_exponentiation_plain(f1, f2, lhs_inf, rhs_inf):
    """Plain version of the final-exponentiation kernel: ``_combine`` of the
    two Miller-loop values (12, B, 16) and the identity masks (B,), then
    f^((p^12 - 1) / r): the easy part and the Scott et al. hard-part chain
    of ``util/bn254.final_exponentiation_chain``, run straight."""
    f = _combine(f1, f2, lhs_inf, rhs_inf)
    inv = T.fq12_to_flat(T.fq12_inv(T.fq12_from_flat(f)))
    # easy: f^((p^6 - 1)(p^2 + 1))
    f = _mul_flat(_conj_flat(f), inv)
    f = _mul_flat(_frob_flat(f, 2), f)
    # hard: f^((p^4 - p^2 + 1) / r)
    fp = _frob_flat(f, 1)
    fp2 = _frob_flat(f, 2)
    fp3 = _frob_flat(fp2, 1)
    fu = _pow_x(f)
    fu2 = _pow_x(fu)
    fu3 = _pow_x(fu2)
    y3 = _conj_flat(_frob_flat(fu, 1))
    fu2p = _frob_flat(fu2, 1)
    fu3p = _frob_flat(fu3, 1)
    y2 = _frob_flat(fu2, 2)
    y0 = _mul_flat(_mul_flat(fp, fp2), fp3)
    y1 = _conj_flat(f)
    y4 = _conj_flat(_mul_flat(fu, fu2p))
    y5 = _conj_flat(fu2)
    y6 = _conj_flat(_mul_flat(fu3, fu3p))
    t0 = _mul_flat(_mul_flat(_mul_flat(y6, y6), y4), y5)
    t1 = _mul_flat(_mul_flat(y3, y5), t0)
    t0 = _mul_flat(t0, y2)
    t1 = _mul_flat(_mul_flat(t1, t1), t0)
    t1 = _mul_flat(t1, t1)
    t0 = _mul_flat(t1, y1)
    t1 = _mul_flat(t1, y0)
    t0 = _mul_flat(t0, t0)
    return _mul_flat(t0, t1)


def final_exponentiation(f1, f2, lhs_inf, rhs_inf):
    """(f1 f2)^((p^12 - 1) / r) with an identity input's value replaced by
    one, shapes as ``final_exponentiation_plain``.  CUDA tensors launch the
    final-exponentiation kernel (one warp per batch element); CPU tensors
    take ``final_exponentiation_plain``."""
    _build.check_limbs("final_exponentiation", f1, f2)
    if f1.dim() != 3 or f1.shape[0] != 12 or f2.shape != f1.shape:
        raise ValueError(f"final_exponentiation: expected two (12, B, {F.NLIMB}) values, got {tuple(f1.shape)}")
    B = f1.shape[1]
    for m in (lhs_inf, rhs_inf):
        if m.dtype != torch.bool or tuple(m.shape) != (B,):
            raise ValueError(f"final_exponentiation: masks must be bool ({B},), got {m.dtype} {tuple(m.shape)}")
    if not use_kernel(f1, f2, lhs_inf, rhs_inf):
        return final_exponentiation_plain(f1, f2, lhs_inf, rhs_inf)
    a, b = _build.aligned(f1), _build.aligned(f2)
    m1, m2 = lhs_inf.to(torch.uint8).contiguous(), rhs_inf.to(torch.uint8).contiguous()
    frob = _frob_tables(a.device)
    out = torch.empty_like(a)
    _build.launch("svtpu_final_exp", a, a.data_ptr(), b.data_ptr(), m1.data_ptr(), m2.data_ptr(), frob.data_ptr(),
                  out.data_ptr(), B, bn254.BN_X, _build.field_arg(FQ))
    if B:
        final_exponentiation.launches += 1
    return out


final_exponentiation.launches = 0


def kzg_pairing_check(lhs: CRV.G1, rhs: CRV.G1, g2, s_g2):
    """e(lhs, g2) * e(rhs, -s_g2) == 1 for batched projective G1 lhs/rhs of
    any batch shape; g2 and s_g2 are host G2 int tuples (the deciding key).
    Returns a boolean mask over the batch.  An identity input contributes
    one to the product."""
    shape = lhs.x.shape[:-1]
    lhs, rhs = (CRV.G1(*(c.reshape(-1, F.NLIMB) for c in p)) for p in (lhs, rhs))
    lhs_n, rhs_n = CRV.g1_normalize(lhs), CRV.g1_normalize(rhs)
    f1, f2 = miller_loop_pair(lhs_n.x, lhs_n.y, rhs_n.x, rhs_n.y, g2, bn254.g2_neg(s_g2))
    f = final_exponentiation(f1, f2, CRV.g1_is_identity(lhs), CRV.g1_is_identity(rhs))
    return T.fq12_is_one(T.fq12_from_flat(f)).reshape(shape)
