"""The port's IPA opening verify and decide (snark_verifier_tpu_torch/
parallel/batch.py ``ipa_accumulate``/``build_ipa_verifier``,
``TorchLoader.decide_ipa``, its copy of pcs/ipa) on the CPU, against the
JAX package's IPA on the same proof bytes.

The openings are proved by the JAX package's IPA prover on the Keccak
transcript at K = 4 (as tests/test_ipa.py).  The reference is the JAX
package's python-int path: its native succinct verify (the accumulator's U)
and ``IpaAs.decide`` over its native loader (h(X)'s coefficients by
``h_coeffs``, U == MSM(g, h) by the oracle MSM), which is the boolean that
``JaxLoader.decide_ipa`` computes (tests/test_ipa.py holds the two equal).
``JaxLoader``'s own succinct verify and decide take minutes to compile on
the CPU (tests/test_ipa.py::test_ipa_jax_succinct_and_decide), so these
tests do not run them.  Tolerance 0: affine points as integers, boolean
masks.
"""

import random

import pytest
import torch
from test_torch_fixture import AssertionFailure, NativeEvmTranscript, NativeLoader  # one torch thread per worker

from snark_verifier_tpu.loader import EcPoint as JaxEcPoint
from snark_verifier_tpu.pcs.ipa import Ipa as JaxIpa
from snark_verifier_tpu.pcs.ipa import IpaAccumulator as JaxIpaAccumulator
from snark_verifier_tpu.pcs.ipa import IpaAs as JaxIpaAs
from snark_verifier_tpu.pcs.ipa import IpaProvingKey as JaxIpaProvingKey
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu.util.msm_symbolic import Msm as JaxMsm
from snark_verifier_tpu_torch import entry as E
from snark_verifier_tpu_torch.loader import EcPoint
from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader, TorchPoint
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops.limbs import limbs_to_int
from snark_verifier_tpu_torch.parallel.batch import build_ipa_verifier, ipa_accumulate
from snark_verifier_tpu_torch.pcs.ipa import IpaAs, IpaProvingKey

K = 4


def keys(k, zk, seed):
    """The JAX package's proving key and the port's, from one seed (equal
    points: the port's copy of ``IpaProvingKey.rand``)."""
    jax_pk, pk = JaxIpaProvingKey.rand(k, zk, seed=seed), IpaProvingKey.rand(k, zk, seed=seed)
    assert (pk.g, pk.h, pk.s) == (jax_pk.g, jax_pk.h, jax_pk.s)
    return jax_pk, pk


def jax_opening(jax_pk, rng):
    """The JAX package's prover: (c, z, v, proof_bytes), as tests/test_ipa.py."""
    p = [rng.randrange(bn254.R) for _ in range(jax_pk.domain.n)]
    omega = rng.randrange(bn254.R) if jax_pk.zk() else None
    c = jax_pk.commit(p, omega)
    z = rng.randrange(bn254.R)
    v = sum(coef * pow(z, i, bn254.R) for i, coef in enumerate(p)) % bn254.R
    transcript = NativeEvmTranscript()
    JaxIpa.create_proof(jax_pk, p, z, omega, transcript, rng)
    return c, z, v, transcript.finalize()


def jax_accumulator(jax_pk, c, z, v, proof):
    """The JAX package's native succinct verify of one opening."""
    loader = NativeLoader()
    ipa_proof = JaxIpa.read_proof(jax_pk.svk(), NativeEvmTranscript(proof, loader))
    return JaxIpa.succinct_verify(jax_pk.svk(), JaxMsm.base(JaxEcPoint(loader, c)), loader.load_const(z),
                                  loader.load_const(v), ipa_proof)


def jax_decides(jax_pk, acc) -> bool:
    try:
        return JaxIpaAs.decide(jax_pk.dk(), acc)
    except AssertionFailure:
        return False


def affine_rows(x, y):
    return [(limbs_to_int(a.numpy()), limbs_to_int(b.numpy())) for a, b in zip(x, y)]


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_ipa_verify_and_decide_match_the_jax_package(zk):
    """One opening: the port's U equals the JAX package's native accumulator,
    and its decide mask (``IpaAs.decide`` through ``decide_ipa``) is the
    JAX package's decide, True."""
    jax_pk, pk = keys(K, zk, seed=9)
    opening = jax_opening(jax_pk, random.Random(5 + zk))
    out = build_ipa_verifier(pk.svk(), pk.dk(), "cpu")(*E.pack_ipa_openings([opening], "cpu"))
    acc = jax_accumulator(jax_pk, *opening)
    assert affine_rows(out["u_x"], out["u_y"]) == [acc.u.value]
    assert E.native_ipa_accumulator(pk.svk(), *opening) == acc.u.value
    assert out["ok"].tolist() == [jax_decides(jax_pk, acc)] == [True]


def test_ipa_decide_rows_of_different_proofs_and_a_wrong_u():
    """Three openings of three polynomials (different xi per row) in one
    batch: the port's accumulators equal the JAX package's row for row;
    the decide, with row 2's U moved to U + G, is the JAX package's decide
    of each row: True, True, False."""
    jax_pk, pk = keys(K, False, seed=10)
    rng = random.Random(6)
    openings = [jax_opening(jax_pk, rng) for _ in range(3)]
    loader = TorchLoader((3,), "cpu")
    acc = ipa_accumulate(pk.svk(), loader, *E.pack_ipa_openings(openings, "cpu"))
    assert loader.ok.tolist() == [True] * 3
    jax_accs = [jax_accumulator(jax_pk, *o) for o in openings]
    u = acc.u.value.as_affine()
    assert affine_rows(F.from_mont(u.x, F.FQ), F.from_mont(u.y, F.FQ)) == [a.u.value for a in jax_accs]
    assert len({tuple(F.FR.decode(x.value[i]) for x in acc.xi) for i in range(3)}) == 3

    wrong = bn254.g1_add(jax_accs[2].u.value, bn254.G1_GEN)
    us = [a.u.value for a in jax_accs[:2]] + [wrong]
    x, y = (torch.as_tensor(F.FQ.encode([p[i] for p in us]).astype("int64")) for i in (0, 1))
    acc.u = EcPoint(loader, TorchPoint(x, y, torch.zeros(3, dtype=torch.bool)))
    mask = IpaAs.decide(pk.dk(), acc)
    jax_accs[2] = JaxIpaAccumulator(jax_accs[2].xi, JaxEcPoint(jax_accs[2].u.loader, wrong))
    assert mask.tolist() == [jax_decides(jax_pk, a) for a in jax_accs] == [True, True, False]
    assert loader.ok.tolist() == [True, True, False]


def test_ipa_decide_goes_through_the_loader_hook(monkeypatch):
    """``IpaAs.decide`` hands an accumulator whose U lives on a
    ``TorchLoader`` to the loader's ``decide_ipa``, and never computes the
    host MSM of the native path."""
    from snark_verifier_tpu_torch.util import bn254 as port_bn254

    seen = []
    monkeypatch.setattr(TorchLoader, "decide_ipa", lambda self, acc, dk: seen.append((self, acc, dk)) or "mask")
    monkeypatch.setattr(port_bn254, "fast_msm", lambda *a: pytest.fail("the native decide ran"))
    loader = TorchLoader((2,), "cpu")
    acc = type("Acc", (), {"xi": [], "u": EcPoint(loader, TorchPoint())})()
    dk = object()
    assert IpaAs.decide(dk, acc) == "mask"
    assert seen == [(loader, acc, dk)]
