"""The port's Keccak-256 and byte encodings (snark_verifier_tpu_torch/ops/
keccak.py, encode.py) against the JAX package's ops/keccak.py, ops/encode.py
and hashlib-compatible util/keccak.py, exactly; K11's source (csrc/
keccak.cu): its tables, and its kernel body compiled for the host."""

import ctypes
import re

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ops import encode as JE
from snark_verifier_tpu.ops import field as JF
from snark_verifier_tpu.ops import keccak as JK
from snark_verifier_tpu.util import keccak as JUK
from snark_verifier_tpu.util.keccak import keccak256 as keccak_ref
from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch import entry as EN
from snark_verifier_tpu_torch.ops import encode as E
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import keccak as K
from snark_verifier_tpu_torch.ops.convert import limbs_to_tensor, tensor_to_limbs

from host_cuda import compile_body

# the lengths of the 7 hashes of a Keccak-transcript verify of the k=8 proof, in order
VERIFY_LENGTHS = [256, 33, 33, 96, 224, 448, 160]
K11_SOURCE = _build.CSRC_DIR / "keccak.cu"


@pytest.mark.parametrize("length", [0, 32, 135, 136, 137, 300, 33, 96, 160, 224, 256, 448])
def test_keccak256_matches_jax_and_reference(length):
    rng = np.random.default_rng(100 + length)
    data = rng.integers(0, 256, (3, length)).astype(np.uint32)
    got = K.keccak256(torch.as_tensor(data.astype(np.int64)), length).numpy()
    np.testing.assert_array_equal(got, np.asarray(JK.keccak256(data, length)))
    for row, digest in zip(data, got):
        assert bytes(digest.astype(np.uint8)) == keccak_ref(bytes(row.astype(np.uint8)))


def test_keccak256_routes_cpu_to_plain_and_validates():
    """CPU tensors take ``keccak256_plain`` (no K11 launch), with a batch of
    any rank and an expanded tensor; a tensor on neither a CUDA device nor the
    CPU raises as ``config.use_kernel`` does, and a length that is not the
    last axis raises before any route."""
    rng = np.random.default_rng(11)
    data = torch.as_tensor(rng.integers(0, 256, (2, 3, 33)))
    launches = K.keccak256_cuda.launches
    got = K.keccak256(data, 33)
    assert got.shape == (2, 3, 32) and torch.equal(got, K.keccak256_plain(data, 33))
    wide = data[0, 0].expand(4, 33)
    assert torch.equal(K.keccak256(wide, 33), got[0, 0].expand(4, 32))
    assert K.keccak256_cuda.launches == launches
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        K.keccak256(data.to("meta"), 33)
    with pytest.raises(ValueError, match="last axis 33 != length 32"):
        K.keccak256(data, 32)
    assert K.keccak256_cuda.launches == launches


def k11_table(name: str) -> list[int]:
    """The integers of K11's constexpr table ``name`` in csrc/keccak.cu."""
    body = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", K11_SOURCE.read_text()).group(1)
    return [int(v.rstrip("ul"), 0) for v in re.findall(r"0x[0-9A-Fa-f]+ull|\d+", body)]


def test_k11_tables_match_oracle_and_plain():
    """K11's rho offsets, pi order and round constants, read from its
    source, equal the oracle's (the JAX package's util/keccak.py) and the
    plain version's pi gather."""
    assert k11_table("RHO") == list(JUK._RHO)
    assert k11_table("ROUND_CONSTANTS") == list(JUK._ROUND_CONSTANTS)
    assert k11_table("PI_SRC") == K._PI_SRC.tolist()
    assert sorted(k11_table("PI_SRC")) == list(range(25))


HOST_DRIVER = """
extern "C" void run_rows(const int64_t* data, int64_t length, int64_t* out, int64_t rows) {
  blockDim.x = KECCAK_BLOCK;
  for (int64_t r = 0; r < rows; ++r) {
    blockIdx.x = r / KECCAK_BLOCK;
    threadIdx.x = r % KECCAK_BLOCK;
    keccak256_kernel(data, length, out, rows);
  }
}
"""


def test_k11_kernel_body_compiled_for_the_host_matches_oracle(tmp_path):
    """K11's kernel and keccak-f, the source up to its C entry point
    compiled as host C++ (one call a thread), give the oracle's digests and
    the plain version's at the verify's lengths and at the padding's edges:
    empty, one byte short of a block, a block, one over, two blocks."""
    run = compile_body(K11_SOURCE, HOST_DRIVER, tmp_path).run_rows
    run.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    rng = np.random.default_rng(13)
    for length in sorted({0, 1, 135, 136, 137, 272, *VERIFY_LENGTHS}):
        data = rng.integers(0, 256, (5, length)).astype(np.int64)
        out = np.zeros((5, 32), np.int64)
        run(data.ctypes.data, length, out.ctypes.data, 5)
        np.testing.assert_array_equal(out, K.keccak256_plain(torch.as_tensor(data), length).numpy())
        for row, digest in zip(data, out):
            assert bytes(digest.astype(np.uint8)) == keccak_ref(bytes(row.astype(np.uint8))), length


def test_keccak_verify_calls_the_module_hash_once_per_squeeze(monkeypatch):
    """A Keccak-transcript verify of the k=8 proof reaches the hash through
    ``ops.keccak.keccak256`` (the attribute K11's route hangs on): 7 calls
    of lengths 256, 33, 33, 96, 224, 448 and 160 bytes, one per challenge
    squeeze, whatever the batch; the verify still accepts the proofs."""
    fn, args = EN.entry("cpu", batch=2)
    lengths = []
    plain = K.keccak256

    def counted(data, length):
        lengths.append((length, tuple(data.shape)))
        return plain(data, length)

    monkeypatch.setattr(K, "keccak256", counted)
    out = fn(*args)
    assert [n for n, _ in lengths] == VERIFY_LENGTHS
    assert all(shape == (2, n) for n, shape in lengths)
    assert out["ok"].tolist() == [True, True]


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
