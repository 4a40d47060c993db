"""The port's field ops (snark_verifier_tpu_torch/ops/field.py)
against the JAX package's ops/field.py and field_pallas.py on the CPU.

Integer arithmetic: every comparison is exact (tolerance zero).  Inputs are
made from a numpy seed and handed to both sides as numpy arrays.
"""

import ctypes

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ops import field as JF
from snark_verifier_tpu.ops import field_pallas as FP
from snark_verifier_tpu.ops.limbs import NLIMB, int_to_limbs, limbs_to_int
from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops.convert import limbs_to_tensor, tensor_to_limbs

from host_cuda import compile_body

SPECS = [(F.FQ, JF.FQ), (F.FR, JF.FR)]
IDS = ["Fq", "Fr"]


def rand_ints(seed, modulus, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % modulus for _ in range(n)]


def edge_ints(modulus):
    return [0, 1, 2, modulus - 1, modulus - 2, 2**16 - 1, 2**16, (1 << 255) % modulus]


def both(spec, values):
    """Montgomery limbs of ``values`` as (numpy for JAX, tensor for the port)."""
    arr = spec.encode(values)
    return arr, limbs_to_tensor(arr, "cpu")


def assert_same(got_tensor, want_jax):
    np.testing.assert_array_equal(tensor_to_limbs(got_tensor), np.asarray(want_jax))


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_spec_constants_match_jax(specs):
    spec, jspec = specs
    np.testing.assert_array_equal(spec.mod_limbs, jspec.mod_limbs)
    np.testing.assert_array_equal(spec.nprime_limbs, jspec.nprime_limbs)
    assert (spec.r_mod, spec.r2, spec.r3) == (jspec.r_mod, jspec.r2, jspec.r3)
    # the kernels' word-level constants: p as 8 words and n0 = -p^-1 mod 2^32
    words = [int(w) for w in spec.kernel_words]
    assert sum(w << (32 * i) for i, w in enumerate(words[:8])) == spec.modulus
    assert (spec.modulus * words[8]) % (1 << 32) == (1 << 32) - 1


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_add_sub_neg_match_jax(specs):
    spec, jspec = specs
    a_vals = rand_ints(1, spec.modulus, 8) + edge_ints(spec.modulus)
    b_vals = (rand_ints(2, spec.modulus, 8) + edge_ints(spec.modulus))[::-1]
    (ja, ta), (jb, tb) = both(spec, a_vals), both(spec, b_vals)
    assert_same(F.add(ta, tb, spec), JF.add(ja, jb, jspec))
    assert_same(F.sub(ta, tb, spec), JF.sub(ja, jb, jspec))
    assert_same(F.neg(ta, spec), JF.neg(ja, jspec))
    assert list(spec.decode(F.add(ta, tb, spec))) == [(x + y) % spec.modulus for x, y in zip(a_vals, b_vals)]


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_mont_mul_matches_jax(specs):
    spec, jspec = specs
    edge = edge_ints(spec.modulus)
    a_vals = [x for x in edge for _ in range(4)]
    b_vals = [y for _ in range(8) for y in edge[:4]]
    (ja, ta), (jb, tb) = both(spec, a_vals), both(spec, b_vals)
    assert_same(F.mont_mul(ta, tb, spec), JF.mont_mul(ja, jb, jspec))
    assert list(spec.decode(F.mont_mul(ta, tb, spec))) == [x * y % spec.modulus for x, y in zip(a_vals, b_vals)]
    # operands above p (any 256-bit value): the same integer arithmetic, so
    # still the same limbs
    rng = np.random.default_rng(3)
    wild_a = rng.integers(0, 1 << 16, (32, NLIMB)).astype(np.uint32)
    wild_b = rng.integers(0, 1 << 16, (32, NLIMB)).astype(np.uint32)
    wild_a[0] = 0xFFFF
    assert_same(F.mont_mul(limbs_to_tensor(wild_a, "cpu"), limbs_to_tensor(wild_b, "cpu"), spec), JF.mont_mul(wild_a, wild_b, jspec))
    # leading batch dims and broadcasting
    assert_same(F.mont_mul(ta.reshape(4, 8, NLIMB), tb[:8], spec), JF.mont_mul(ja.reshape(4, 8, NLIMB), jb[:8], jspec))


@pytest.mark.parametrize("rows", [(1, 1023), (1023, 1), (1, 1024), (1024, 1024)], ids=str)
def test_mont_mul_plain_column_paths_match_jax_and_ints(rows):
    """Both ways _columns forms the column sums (sliding windows below
    COLUMN_LOOP_ROWS broadcast rows, multiply-adds from there), with a small
    operand broadcast against a large one either way round: K1's plain
    version against the JAX package and python ints."""
    assert F.COLUMN_LOOP_ROWS == 1024
    na, nb = rows
    a_vals = (edge_ints(F.FQ.modulus) + rand_ints(11, F.FQ.modulus, na))[:na]
    b_vals = (edge_ints(F.FQ.modulus)[::-1] + rand_ints(12, F.FQ.modulus, nb))[:nb]
    (ja, ta), (jb, tb) = both(F.FQ, a_vals), both(F.FQ, b_vals)
    got = F.mont_mul_plain(ta, tb, F.FQ)
    assert_same(got, JF.mont_mul(ja, jb, JF.FQ))
    n = max(na, nb)
    a_full, b_full = a_vals * (n // na), b_vals * (n // nb)
    assert list(F.FQ.decode(got)) == [x * y % F.FQ.modulus for x, y in zip(a_full, b_full)]


def test_mont_mul_plain_matches_pallas_kernel(monkeypatch):
    """The plain version of K1 against the Pallas kernel body it replaces,
    run by the Pallas interpreter on a small lane tier."""
    monkeypatch.setattr(FP, "LANES", 128)
    monkeypatch.setattr(FP, "FIXED_TOTAL", 256)
    FP.mont_mul_pallas.clear_cache()
    try:
        vals = edge_ints(F.FQ.modulus)
        a_vals = [x for x in vals for _ in vals] + rand_ints(4, F.FQ.modulus, 36)
        b_vals = [y for _ in vals for y in vals] + rand_ints(5, F.FQ.modulus, 36)
        (ja, ta), (jb, tb) = both(F.FQ, a_vals), both(F.FQ, b_vals)
        want = FP.mont_mul_pallas(ja, jb, JF.FQ)
        assert_same(F.mont_mul_plain(ta, tb, F.FQ), want)
    finally:
        FP.mont_mul_pallas.clear_cache()


def test_to_from_mont_match_jax():
    spec = F.FR
    vals = rand_ints(6, spec.modulus, 8)
    canon = np.stack([int_to_limbs(v) for v in vals])
    mont = F.to_mont(limbs_to_tensor(canon, "cpu"), spec)
    assert_same(mont, JF.to_mont(canon, JF.FR))
    assert_same(F.from_mont(mont, spec), JF.from_mont(np.asarray(JF.to_mont(canon, JF.FR)), JF.FR))
    np.testing.assert_array_equal(tensor_to_limbs(F.from_mont(mont, spec)), canon)


@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_pow_inv_match_jax(specs):
    spec, jspec = specs
    vals = rand_ints(7, spec.modulus, 4)
    ja, ta = both(spec, vals)
    assert_same(F.pow_const(ta, 65537, spec), JF.pow_const(ja, 65537, jspec))
    assert_same(F.inv(ta, spec), JF.inv(ja, jspec))
    zero_j, zero_t = both(spec, [0])
    assert_same(F.inv(zero_t, spec), JF.inv(zero_j, jspec))


POW_EXPONENTS = {"0": lambda m: 0, "1": lambda m: 1, "256": lambda m: 256, "p-2": lambda m: m - 2,
                 "(p+1)/4": lambda m: (m + 1) // 4, "2^256+7": lambda m: (1 << 256) + 7,
                 "2^300+5": lambda m: (1 << 300) + 5}


@pytest.mark.parametrize("name", list(POW_EXPONENTS))
@pytest.mark.parametrize("specs", SPECS, ids=IDS)
def test_pow_const_and_inv_match_jax_and_ints(specs, name):
    """field.pow_const and field.inv on the CPU route (mont_pow_plain, the
    plain version of the mont_pow kernel) against the JAX package's
    pow_const/inv and python ints: 0, 1, p - 1 and random values under
    leading batch dims (2, 4), and an expanded (non-contiguous) input."""
    spec, jspec = specs
    e = POW_EXPONENTS[name](spec.modulus)
    vals = [0, 1, spec.modulus - 1] + rand_ints(11, spec.modulus, 5)
    ja, ta = both(spec, vals)
    ja, ta = ja.reshape(2, 4, NLIMB), ta.reshape(2, 4, NLIMB)
    got = F.pow_const(ta, e, spec)
    assert_same(got, JF.pow_const(ja, e, jspec))
    assert list(spec.decode(got).reshape(-1)) == [pow(v, e, spec.modulus) for v in vals]
    wide = ta[1, 3].expand(3, NLIMB)  # stride 0: not contiguous
    assert not wide.is_contiguous()
    assert torch.equal(F.pow_const(wide, e, spec), got[1, 3].expand(3, NLIMB))
    if name == "p-2":
        inv = F.inv(ta, spec)
        assert_same(inv, JF.inv(ja, jspec))
        assert list(spec.decode(inv).reshape(-1)) == [pow(v, spec.modulus - 2, spec.modulus) for v in vals]
    assert F.mont_pow.launches == 0


def test_mont_pow_validates_its_exponent():
    """Only a negative exponent (or a bad limb shape) raises; an exponent of
    2^256 and above takes the plain chain on the CPU, as the JAX package's
    pow_const takes any exponent, and its kernel route splits it into
    256-bit pieces of the same chain."""
    a = limbs_to_tensor(F.FR.encode([3]), "cpu")
    with pytest.raises(ValueError):
        F.mont_pow(a, -1, F.FR)
    with pytest.raises(ValueError):
        F.mont_pow(a[..., :8], 3, F.FR)
    assert torch.equal(F.mont_pow(a, (1 << 256) - 1, F.FR), F.mont_pow_plain(a, (1 << 256) - 1, F.FR))
    e = 1 << 256
    got = F.mont_pow(a, e, F.FR)
    assert torch.equal(got, F.mont_pow_plain(a, e, F.FR))
    assert list(F.FR.decode(got)) == [pow(3, e, F.FR.modulus)]
    assert F.exponent_pieces((1 << 256) - 1) == [((1 << 256) - 1, 256)]  # one launch below 2^256
    assert F.exponent_pieces(e) == [(1, 1), (0, 256)]
    assert F.exponent_pieces((1 << 300) + 5) == [(1 << 44, 45), (5, 256)]


def _fmul_eo_words(a, b, p, n0):
    """The schedule of csrc/bn254.cuh fmul_eo, word for word: each row's
    products go to two accumulators (even words of a and p into E, odd into
    F) as carry chains of 32-bit multiply-adds; between rows the sum is
    E + e8 2^256 + F; the division by 2^32 swaps the accumulators.  Returns
    the 257-bit integer before the final conditional subtract, and raises
    if any word would overflow (a dropped carry)."""
    mask = (1 << 32) - 1
    A = [(a >> (32 * i)) & mask for i in range(8)]
    Bw = [(b >> (32 * i)) & mask for i in range(8)]
    Pw = [(p >> (32 * i)) & mask for i in range(8)]

    def chain(acc, top, xs, y, cin=0):  # acc[0..7] += x_k y at word pairs (2k, 2k+1); carry into top
        c = cin
        for k, x in enumerate(xs):
            for j, part in ((2 * k, (x * y) & mask), (2 * k + 1, (x * y) >> 32)):
                acc[j], c = (acc[j] + part + c) & mask, (acc[j] + part + c) >> 32
        assert top + c <= mask
        return top + c

    E = [0] * 8
    F_ = [0] * 9  # F_[0] at word 0, F_[1..8] at words 1..8
    for k in range(0, 8, 2):
        E[k], E[k + 1] = (A[k] * Bw[0]) & mask, (A[k] * Bw[0]) >> 32
        F_[k + 1], F_[k + 2] = (A[k + 1] * Bw[0]) & mask, (A[k + 1] * Bw[0]) >> 32
    e8 = f9 = 0
    for i in range(8):
        if i:
            F_[8] = 0
            s = E[0] + F_[0]
            E[0] = s & mask
            odd = F_[1:9]
            f9 = chain(odd, 0, A[1::2], Bw[i], cin=s >> 32)
            F_[1:9] = odd
            e8 = chain(E, e8, A[0::2], Bw[i])
        m = (E[0] * n0) & mask
        e8 = chain(E, e8, Pw[0::2], m)
        assert E[0] == 0
        odd = F_[1:9]
        f9 = chain(odd, f9, Pw[1::2], m)
        E, F_, e8 = odd, E[1:] + [e8, 0], f9
    r = sum((E[k] + F_[k]) << (32 * k) for k in range(8)) + (e8 << 256)
    return r


@pytest.mark.parametrize("spec", [F.FQ, F.FR], ids=IDS)
def test_fmul_eo_schedule_gives_the_montgomery_integer(spec):
    """The two-chain schedule of mont_pow's and K6's Montgomery product gives
    fmul's integer (a b + m p) / 2^256 for any a, b < 2^256 (not only values
    below p), so the kernels keep the plain versions' limbs.  A check of the
    schedule on python ints; the kernels themselves are held against the
    plain versions on the card by chip_smoke.py."""
    p, R = spec.modulus, 1 << 256
    n0 = int(spec.kernel_words[8])
    rng = np.random.default_rng(12)
    top = [R - 1, R - 2, p, p - 1, 0, 1]
    cases = [(x, y) for x in top for y in top]
    cases += [(int.from_bytes(rng.bytes(32), "little") % p, int.from_bytes(rng.bytes(32), "little") % p) for _ in range(300)]
    cases += [(int.from_bytes(rng.bytes(32), "little"), int.from_bytes(rng.bytes(32), "little")) for _ in range(300)]
    for a, b in cases:
        m = (-a * b * pow(p, -1, R)) % R
        assert _fmul_eo_words(a, b, p, n0) == (a * b + m * p) // R


def test_batch_inv_matches_jax():
    spec = F.FR
    vals = rand_ints(8, spec.modulus, 9) + [0, 1, spec.modulus - 1]
    ja, ta = both(spec, vals)
    assert_same(F.batch_inv(ta, spec), JF.batch_inv(ja, JF.FR))
    ja2, ta2 = np.stack([ja, ja], axis=1), torch.stack([ta, ta], dim=1)  # (12, 2, 16)
    assert_same(F.batch_inv(ta2, spec, axis=0), JF.batch_inv(ja2, JF.FR, 0))


def test_constants_selects_and_sums_match_jax():
    spec, jspec = F.FR, JF.FR
    vals = rand_ints(9, spec.modulus, 6) + [0, 0]
    other = vals[:4] + rand_ints(10, spec.modulus, 4)
    (ja, ta), (jb, tb) = both(spec, vals), both(spec, other)
    assert_same(F.ones((3,), spec, "cpu"), JF.ones((3,), jspec))
    assert_same(F.zeros((3,), "cpu"), JF.zeros((3,)))
    assert_same(F.constant(12345, spec, (2,), "cpu"), JF.constant(12345, jspec, (2,)))
    assert_same(F.constant(-1, spec, (), "cpu"), JF.constant(-1, jspec))
    np.testing.assert_array_equal(F.is_zero(ta).numpy(), np.asarray(JF.is_zero(ja)))
    np.testing.assert_array_equal(F.eq(ta, tb).numpy(), np.asarray(JF.eq(ja, jb)))
    cond = np.arange(8) % 3 == 0
    assert_same(F.select(torch.as_tensor(cond), ta, tb), JF.select(cond, ja, jb))
    assert_same(F.mont_sqr(ta, spec), JF.mont_sqr(ja, jspec))
    pairs_t = [(ta, tb), (tb, tb), (ta, ta)]
    pairs_j = [(ja, jb), (jb, jb), (ja, ja)]
    assert_same(F.sum_products(pairs_t, spec), JF.sum_products(pairs_j, jspec))


# ---------------------------------------------------------------------------
# K12 (csrc/field_add.cu): its kernel body, compiled for the host, behind the
# wrappers' own CUDA route
# ---------------------------------------------------------------------------

K12_SOURCE = _build.CSRC_DIR / "field_add.cu"
K12_ENTRIES = ("svtpu_field_add", "svtpu_field_sub", "svtpu_field_neg", "svtpu_reduce_u256", "svtpu_lt_modulus")
# K12's C entry points as host functions of the same arguments (the stream
# left out): every thread of the launch's grid, one call each, in turn.
K12_HOST_DRIVER = """
template <typename Kernel, typename... Args>
int each_thread(int64_t n, Kernel kernel, Args... args) {
  blockDim.x = K12_BLOCK;
  for (int64_t t = 0; t < int64_t(grid_for(n)) * K12_BLOCK; ++t) {
    blockIdx.x = unsigned(t / K12_BLOCK);
    threadIdx.x = unsigned(t % K12_BLOCK);
    kernel(args...);
  }
  return 0;
}
using I = const int64_t*;
extern "C" int svtpu_field_add(const void* a, int64_t sa, const void* b, int64_t sb, void* out, int64_t n,
                               const void* f) {
  return each_thread(n, field_add_kernel, I(a), sa, I(b), sb, (int64_t*)out, n, modulus_from_host(f));
}
extern "C" int svtpu_field_sub(const void* a, int64_t sa, const void* b, int64_t sb, void* out, int64_t n,
                               const void* f) {
  return each_thread(n, field_sub_kernel, I(a), sa, I(b), sb, (int64_t*)out, n, modulus_from_host(f));
}
extern "C" int svtpu_field_neg(const void* a, int64_t sa, void* out, int64_t n, const void* f) {
  return each_thread(n, field_neg_kernel, I(a), sa, (int64_t*)out, n, modulus_from_host(f));
}
extern "C" int svtpu_reduce_u256(const void* a, int64_t sa, void* out, int64_t n, const void* f) {
  return each_thread(n, reduce_u256_kernel, I(a), sa, (int64_t*)out, n, modulus_from_host(f));
}
extern "C" int svtpu_lt_modulus(const void* a, int64_t sa, void* out, int64_t n, const void* f) {
  return each_thread(n, lt_modulus_kernel, I(a), sa, (uint8_t*)out, n, modulus_from_host(f));
}
"""


@pytest.fixture(scope="module")
def k12_host(tmp_path_factory):
    """K12's kernel body built for the host, its entries typed as the
    library's (less the stream)."""
    lib = compile_body(K12_SOURCE, K12_HOST_DRIVER, tmp_path_factory.mktemp("k12"))
    for name in K12_ENTRIES:
        getattr(lib, name).argtypes = _build.SIGNATURES[name][:-1]
        getattr(lib, name).restype = ctypes.c_int
    return lib


@pytest.fixture
def k12_route(k12_host, monkeypatch):
    """The five wrappers' CUDA route on CPU tensors: ``use_kernel`` says
    yes, and ``_build.launch`` runs the host-built body with the wrapper's
    pointers, strides and sizes; the launch counters start at 0."""
    monkeypatch.setattr(F, "use_kernel", lambda *tensors: True)
    def host_launch(entry, like, *args):
        _build.check(getattr(k12_host, entry)(*args), entry)

    monkeypatch.setattr(_build, "launch", host_launch)
    for op in (F.add, F.sub, F.neg, F.reduce_u256, F.lt_modulus):
        monkeypatch.setattr(op, "launches", 0)


def k12_values(spec, seed, n_random=24):
    """The edges (0, 1, p - 1, p, p + 1, 2p - 1, 2p, 5p, 2^255, 2^256 - 1,
    the 0xFFFF limbs of the top half alone and of the bottom half alone),
    then random 256-bit values: any 256-bit input, values >= p included."""
    p, top = spec.modulus, (1 << 256) - 1
    edges = [0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p, 5 * p, 1 << 255, top, top ^ ((1 << 128) - 1), (1 << 128) - 1]
    rng = np.random.default_rng(seed)
    return edges + [int.from_bytes(rng.bytes(32), "little") for _ in range(n_random)]


def raw(values):
    """Python ints below 2^256 -> (n, 16) int64 limbs, as they are (no Montgomery form)."""
    return torch.as_tensor(np.stack([int_to_limbs(v) for v in values]).astype(np.int64))


def k12_cases(spec):
    """(a, b) rows of raw limbs: every pair of edges, then random pairs."""
    vals = k12_values(spec, 21)
    edges = vals[:12]
    a = [x for x in edges for _ in edges] + vals[12:]
    b = [y for _ in edges for y in edges] + k12_values(spec, 22)[12:]
    return raw(a), raw(b)


@pytest.mark.parametrize("spec", [F.FQ, F.FR], ids=IDS)
def test_k12_kernel_body_compiled_for_the_host_matches_plain(spec, k12_route):
    """K12's five entries, through the wrappers' CUDA route with the kernel
    body built for the host, equal the plain versions limb for limb on every
    pair of edge values (0, 1, p - 1, p, p + 1, ..., 2^256 - 1) and on random
    256-bit rows; and the plain versions equal the rules of python ints:
    add subtracts p on a carry or a sum >= p, sub adds p back when a < b,
    reduce_u256 is five conditional subtractions, lt_modulus is x < p."""
    a, b = k12_cases(spec)
    got = {"add": F.add(a, b, spec), "sub": F.sub(a, b, spec), "neg": F.neg(a, spec),
           "reduce": F.reduce_u256(a, spec), "lt": F.lt_modulus(a, spec)}
    want = {"add": F.add_plain(a, b, spec), "sub": F.sub_plain(a, b, spec), "neg": F.neg_plain(a, spec),
            "reduce": F.reduce_u256_plain(a, spec), "lt": F.lt_modulus_plain(a, spec)}
    for name in got:
        assert got[name].shape == want[name].shape and got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    assert [op.launches for op in (F.add, F.sub, F.neg, F.reduce_u256, F.lt_modulus)] == [1] * 5
    p, top = spec.modulus, 1 << 256
    for x, y, s, d, r, lt in zip(*(map(limbs_to_int, t.numpy()) for t in (a, b, want["add"], want["sub"],
                                                                        want["reduce"])), want["lt"].tolist()):
        total = x + y
        assert s == ((total % top - p) % top if total >= top or total % top >= p else total)
        assert d == ((x - y + p) % top if x < y else x - y)
        assert lt == (x < p)
        for _ in range(F.REDUCE_ROUNDS):
            x = x - p if x >= p else x
        assert r == x


@pytest.mark.parametrize("spec", [F.FQ, F.FR], ids=IDS)
def test_k12_reads_broadcast_and_strided_operands_in_place(spec, k12_route, monkeypatch):
    """The operand forms of the verifies, each through the host-built body:
    a batch against one broadcast row both ways (a ``()``-shaped constant and
    an expanded one, stride 0), a column sliced out of (B, 5, 16) (stride 80),
    leading dims (3, 5) against a row, a single row (output batch ()), an
    empty batch (no launch), and operands whose rows do not fold into one
    stride (five rows repeated three times; a column against a row) or are
    not 16-byte aligned: every result equals the plain version's, and only
    those last operands are copied, each time they are read."""
    copies = []
    aligned = _build.aligned
    monkeypatch.setattr(_build, "aligned", lambda t: copies.append(tuple(t.shape)) or aligned(t))
    vals = k12_values(spec, 23, n_random=3)  # 15 rows
    x = raw(vals)
    row = raw([spec.modulus + 5])[0]
    wide = torch.stack([x, x.flip(0), x.roll(1, 0), x.roll(2, 0), x.roll(3, 0)], dim=1)  # (15, 5, 16)
    shifted = torch.cat([torch.zeros(1, dtype=torch.int64), x.reshape(-1)])[1:].view(x.shape)  # 8-byte offset
    assert shifted.data_ptr() % 16 == 8 and torch.equal(shifted, x)
    pairs = [(x, row), (row, x), (x, row.expand(15, NLIMB)), (row.expand(15, NLIMB), x), (wide[:, 2], row),
             (x, wide[:, 4]), (x.reshape(3, 5, NLIMB), row), (x.reshape(3, 5, NLIMB), x[:5]), (row, row),
             (x[:0], row),
             (x[:, None], x[None, :4]), (shifted, x)]
    for a, b in pairs:
        for op, plain in ((F.add, F.add_plain), (F.sub, F.sub_plain)):
            got, want = op(a, b, spec), plain(a, b, spec)
            assert got.shape == want.shape and torch.equal(got, want), (op.__name__, a.shape, b.stride(), b.shape)
        for op, plain in ((F.neg, F.neg_plain), (F.reduce_u256, F.reduce_u256_plain),
                          (F.lt_modulus, F.lt_modulus_plain)):
            got, want = op(a, spec), plain(a, spec)
            assert got.shape == want.shape and torch.equal(got, want), (op.__name__, a.shape, a.stride())
    # the empty batch launched nothing; every other pair launched once a call
    assert F.add.launches == F.sub.launches == len(pairs) - 1
    assert F.neg.launches == F.reduce_u256.launches == F.lt_modulus.launches == len(pairs) - 1
    # copied: x[:5] over (3, 5) by add and sub; x[:, None] and x[None, :4] over (15, 4) by each; the
    # misaligned rows by all five
    assert copies == [(3, 5, NLIMB)] * 2 + [(15, 4, NLIMB)] * 4 + [(15, NLIMB)] * 5


@pytest.mark.parametrize("shape, rows, stride", [
    ((NLIMB,), (1820,), 0),  # a ()-shaped constant against a batch
    ((1820, NLIMB), (1820,), 16),  # a batch
    ((1, NLIMB), (1820,), 0),  # a one-row batch
    ((8, 5, NLIMB), (8, 5), 16),  # leading dims, contiguous
    ((1, 5, NLIMB), (8, 5), None),  # five rows repeated eight times: no single stride
    ((8, 1, NLIMB), (8, 5), None),  # each row repeated five times
], ids=str)
def test_row_stride_of_contiguous_and_broadcast_operands(shape, rows, stride):
    assert F.row_stride(torch.zeros(shape, dtype=torch.int64), rows) == stride


def test_row_stride_of_views():
    """An expanded constant reads stride 0, a column of (B, 5, 16) stride
    80, also against rows (1, B), every other row of it 160; the column
    repeated twice, and limbs that are not contiguous, None."""
    row = torch.zeros(NLIMB, dtype=torch.int64)
    wide = torch.zeros(1820, 5, NLIMB, dtype=torch.int64)
    assert F.row_stride(row.expand(1820, NLIMB), (1820,)) == 0
    assert F.row_stride(row.expand(2, 3, NLIMB), (2, 3)) == 0
    assert F.row_stride(wide[:, 3], (1820,)) == 80
    assert F.row_stride(wide[:, 3], (1, 1820)) == 80
    assert F.row_stride(wide[:, 3].expand(2, 1820, NLIMB), (2, 1820)) is None
    assert F.row_stride(wide[::2, 1], (910,)) == 160
    assert F.row_stride(torch.zeros(1820, NLIMB, 5, dtype=torch.int64).transpose(-1, -2), (1820, 5)) is None


@pytest.mark.parametrize("shapes", [((1820, 16), (16,)), ((16,), (1820, 16)), ((3, 1, 16), (1, 4, 16)),
                                    ((2, 3, 16), (3, 16)), ((5, 16),), ((16,), (16,)), ((0, 16), (1, 16))], ids=str)
def test_broadcast_rows_matches_torch(shapes):
    """K12's broadcast of the operands' leading shapes is torch's."""
    operands = [torch.zeros(s, dtype=torch.int64) for s in shapes]
    assert F.broadcast_rows(*operands) == tuple(torch.broadcast_shapes(*shapes)[:-1])


def test_broadcast_rows_refuses_what_torch_refuses():
    with pytest.raises(ValueError, match="do not broadcast"):
        F.broadcast_rows(torch.zeros(3, 16, dtype=torch.int64), torch.zeros(4, 16, dtype=torch.int64))
