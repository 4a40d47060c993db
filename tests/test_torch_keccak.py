"""The port's Keccak-256 and byte encodings (snark_verifier_tpu_torch/ops/
keccak.py, encode.py) against the JAX package's ops/keccak.py, ops/encode.py
and hashlib-compatible util/keccak.py, exactly."""

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ops import encode as JE
from snark_verifier_tpu.ops import field as JF
from snark_verifier_tpu.ops import keccak as JK
from snark_verifier_tpu.util.keccak import keccak256 as keccak_ref
from snark_verifier_tpu_torch.ops import encode as E
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import keccak as K
from snark_verifier_tpu_torch.ops.convert import limbs_to_tensor, tensor_to_limbs


@pytest.mark.parametrize("length", [0, 32, 135, 136, 137, 300])
def test_keccak256_matches_jax_and_reference(length):
    rng = np.random.default_rng(100 + length)
    data = rng.integers(0, 256, (3, length)).astype(np.uint32)
    got = K.keccak256(torch.as_tensor(data.astype(np.int64)), length).numpy()
    np.testing.assert_array_equal(got, np.asarray(JK.keccak256(data, length)))
    for row, digest in zip(data, got):
        assert bytes(digest.astype(np.uint8)) == keccak_ref(bytes(row.astype(np.uint8)))


def test_encode_helpers_match_jax():
    rng = np.random.default_rng(7)
    be = rng.integers(0, 256, (5, 32)).astype(np.uint32)
    be[0] = 0xFF  # 2^256 - 1: above both moduli
    be[1] = 0
    t = torch.as_tensor(be.astype(np.int64))
    limbs = E.be_bytes_to_limbs(t)
    np.testing.assert_array_equal(tensor_to_limbs(limbs), np.asarray(JE.be_bytes_to_limbs(be)))
    np.testing.assert_array_equal(E.limbs_to_be_bytes(limbs).numpy(), be)
    np.testing.assert_array_equal(tensor_to_limbs(E.le_bytes_to_limbs(t)), np.asarray(JE.le_bytes_to_limbs(be)))
    np.testing.assert_array_equal(E.limbs_to_le_bytes(E.le_bytes_to_limbs(t)).numpy(), be)
    jl = np.asarray(JE.be_bytes_to_limbs(be))
    for spec, jspec in ((F.FQ, JF.FQ), (F.FR, JF.FR)):
        np.testing.assert_array_equal(
            tensor_to_limbs(E.reduce_u256(limbs, spec)), np.asarray(JE.reduce_u256(jl, jspec))
        )
        np.testing.assert_array_equal(E.is_lt_modulus(limbs, spec).numpy(), np.asarray(JE.is_lt_modulus(jl, jspec)))
    mod = limbs_to_tensor(F.FR.mod_limbs[None], "cpu")
    assert not bool(E.is_lt_modulus(mod, F.FR)[0])
