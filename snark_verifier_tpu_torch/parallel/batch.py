"""Batched device verification: the loader-generic succinct PLONK verifier,
specialised to one protocol and run over a batch of proofs, the batch
decider that folds the batch's accumulators into one pairing check, and the
IPA opening verifier with its decide.

Counterpart of ``snark_verifier_tpu/parallel/batch.py``.  Where the JAX
package traces ``build_verifier``'s function into one XLA computation, the
port runs it eagerly: one pass of the verifier over (B, ...) tensors, with
the hand-written kernels underneath.  Every entry point runs on the card
unless the caller asks for another device.
"""

from __future__ import annotations

import numpy as np
import torch

from snark_verifier_tpu_torch.loader import EcPoint, Scalar
from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader, TorchPoint
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import msm as MSM
from snark_verifier_tpu_torch.ops import pairing as PAIR
from snark_verifier_tpu_torch.ops.curve import G1
from snark_verifier_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
from snark_verifier_tpu_torch.pcs.ipa import Ipa, IpaAs
from snark_verifier_tpu_torch.system.halo2.transcript_torch import TorchEvmTranscript, TorchPoseidonTranscript
from snark_verifier_tpu_torch.util.msm_symbolic import Msm
from snark_verifier_tpu_torch.verifier.plonk import PlonkSuccinctVerifier

FR = F.FR


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """True when ``t`` lies on ``device``; a device without an index (plain
    "cuda", the entry points' default) matches any index of its type."""
    return t.device.type == device.type and device.index in (None, t.device.index)


TRANSCRIPTS = {"evm": TorchEvmTranscript, "poseidon": TorchPoseidonTranscript}


def build_verifier(protocol, As, svk, device="cuda", decide_dk=None, transcript_kind: str = "evm"):
    """Returns ``fn(proof_bytes, instances) -> result dict``.

    proof_bytes: (B, L) int64 byte values; instances: (B, total, 16)
    canonical Fr limbs (columns flattened in order); both on ``device``.
    Output: ``lhs_x, lhs_y, rhs_x, rhs_y`` (B, 16) canonical Fq limbs of the
    accumulator pair (a leading axis per accumulator when there are several),
    and ``ok`` (B,), the per-proof validity mask.  With ``decide_dk`` (a
    ``KzgDecidingKey``), every accumulator's pairing check runs per proof
    and folds into ``ok``.  ``transcript_kind`` "evm" reads the proofs with
    the Keccak transcript, "poseidon" with the Poseidon transcript (the
    aggregation snarks')."""
    if transcript_kind not in TRANSCRIPTS:
        raise ValueError(f"transcript_kind must be one of {sorted(TRANSCRIPTS)}, got {transcript_kind!r}")
    transcript_cls = TRANSCRIPTS[transcript_kind]
    verifier = PlonkSuccinctVerifier(As)
    num_instance = protocol.num_instance
    device = torch.device(device)

    def verify_fn(proof_bytes, instances):
        if not (on_device(proof_bytes, device) and on_device(instances, device)):
            raise ValueError(f"inputs must be on {device}")
        batch_shape = proof_bytes.shape[:-1]
        loader = TorchLoader(batch_shape, device)
        loaded = protocol.loaded(loader)

        cols, off = [], 0
        for n in num_instance:
            cols.append([loader.scalar_from_mont(F.to_mont(instances[..., off + i, :], FR)) for i in range(n)])
            off += n

        transcript = transcript_cls(proof_bytes, loader)
        proof = verifier.read_proof(svk, loaded, cols, transcript)
        accumulators = verifier.verify(svk, loaded, cols, proof)
        if decide_dk is not None:
            for acc in accumulators:
                loader.decide_pairing(acc, decide_dk)

        def coords(acc):
            lhs = acc.lhs.value.as_affine()
            rhs = acc.rhs.value.as_affine()
            return {
                "lhs_x": F.from_mont(lhs.x, F.FQ),
                "lhs_y": F.from_mont(lhs.y, F.FQ),
                "rhs_x": F.from_mont(rhs.x, F.FQ),
                "rhs_y": F.from_mont(rhs.y, F.FQ),
            }

        if len(accumulators) == 1:
            out = coords(accumulators[0])
        else:
            per_acc = [coords(a) for a in accumulators]
            full = tuple(batch_shape) + (F.NLIMB,)
            out = {k: torch.stack([c[k].expand(full) for c in per_acc]) for k in per_acc[0]}
        out["ok"] = loader.ok
        return out

    return verify_fn


def ipa_accumulate(svk, loader: TorchLoader, proof_bytes, c_x, c_y, z, v):
    """The IPA succinct verify (``Ipa.read_proof`` + ``succinct_verify`` on
    the Keccak transcript) of a batch of openings on ``loader``, each the
    claim that the polynomial committed to as C opens to v at z; failed
    checks AND into ``loader.ok``.  proof_bytes: (B, L) int64 byte values;
    c_x, c_y: (B, 16) canonical Fq limbs of each affine commitment; z, v:
    (B, 16) canonical Fr limbs.  Returns the ``IpaAccumulator`` (xi, U)."""
    proof = Ipa.read_proof(svk, TorchEvmTranscript(proof_bytes, loader))
    commitment = Msm.base(EcPoint(loader, TorchPoint(proj=to_g1(c_x, c_y))))
    z_s, v_s = (Scalar(loader, F.to_mont(t, FR)) for t in (z, v))
    return Ipa.succinct_verify(svk, commitment, z_s, v_s, proof)


def build_ipa_verifier(svk, dk=None, device="cuda"):
    """Returns ``fn(proof_bytes, c_x, c_y, z, v) -> result dict``: the IPA
    opening verify of a batch (``ipa_accumulate``, all inputs on
    ``device``).  Output: ``u_x, u_y`` (B, 16) canonical Fq limbs of the
    accumulator's U (affine) and ``ok`` (B,).  With ``dk`` (an
    ``IpaDecidingKey``), ``IpaAs.decide`` runs through the loader's
    ``decide_ipa`` hook and folds U == MSM(g, h(xi)) into ``ok``."""
    device = torch.device(device)

    def verify_fn(proof_bytes, c_x, c_y, z, v):
        if not all(on_device(t, device) for t in (proof_bytes, c_x, c_y, z, v)):
            raise ValueError(f"inputs must be on {device}")
        loader = TorchLoader(proof_bytes.shape[:-1], device)
        acc = ipa_accumulate(svk, loader, proof_bytes, c_x, c_y, z, v)
        if dk is not None:
            IpaAs.decide(dk, acc)
        u = acc.u.value.as_affine()
        return {"u_x": F.from_mont(u.x, F.FQ), "u_y": F.from_mont(u.y, F.FQ), "ok": loader.ok}

    return verify_fn


def pack_proofs(proof_bytes_list, device="cuda"):
    """Host: list of equal-length proof byte strings -> (B, L) int64 tensor."""
    L = len(proof_bytes_list[0])
    if any(len(p) != L for p in proof_bytes_list):
        raise ValueError("proofs must have equal length")
    arr = np.frombuffer(b"".join(proof_bytes_list), np.uint8).reshape(len(proof_bytes_list), L)
    return torch.as_tensor(arr.astype(np.int64), device=device)


def pack_instances(instances_list, device="cuda"):
    """Host: list (per proof) of per-column int lists -> (B, total, 16) int64."""
    flat = [[v for col in ins for v in col] for ins in instances_list]
    arr = np.stack([ints_to_limbs(row) for row in flat]).astype(np.int64)
    return torch.as_tensor(arr, device=device)


def to_g1(cx, cy):
    """Canonical affine (B, 16) coordinates -> projective Montgomery G1; the
    all-zero pair (0, 0) is the identity."""
    inf = F.is_zero(cx) & F.is_zero(cy)
    shape, dev = inf.shape, inf.device
    y = F.select(inf, F.ones(shape, F.FQ, dev), F.to_mont(cy, F.FQ))
    z = F.select(inf, F.zeros(shape, dev), F.ones(shape, F.FQ, dev))
    return G1(F.to_mont(cx, F.FQ), y, z)


def build_batch_decider(dk, device="cuda"):
    """Returns ``fn(lhs_x, lhs_y, rhs_x, rhs_y, fold_scalars) -> ok``, a
    0-dim bool tensor: the batch decide of the JAX package's
    ``build_batch_decider``.  The B accumulators (canonical affine
    coordinates from ``build_verifier``) fold by a random linear
    combination, two B-term MSMs with ``fold_scalars`` (B, 16) canonical Fr
    (their Horner combines in one K6 launch), then ONE pairing check decides
    them all.  All inputs on ``device``."""
    device = torch.device(device)

    def decide_fn(lhs_x, lhs_y, rhs_x, rhs_y, fold_scalars):
        if not all(on_device(t, device) for t in (lhs_x, lhs_y, rhs_x, rhs_y, fold_scalars)):
            raise ValueError(f"inputs must be on {device}")
        lhs, rhs = MSM.msm_serial_many([to_g1(lhs_x, lhs_y), to_g1(rhs_x, rhs_y)], fold_scalars)
        return PAIR.kzg_pairing_check(lhs, rhs, dk.g2, dk.s_g2)

    return decide_fn


def decode_accumulator(result, index=0):
    """Host: result dict -> ((lhs_x, lhs_y), (rhs_x, rhs_y)) affine ints of
    one batch element."""
    def coord(key):
        return limbs_to_int(result[key][index].cpu().numpy())

    return (coord("lhs_x"), coord("lhs_y")), (coord("rhs_x"), coord("rhs_y"))
