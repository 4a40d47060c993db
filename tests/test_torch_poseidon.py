"""The port's Poseidon path (snark_verifier_tpu_torch/ops/poseidon.py, the
Poseidon transcript and build_verifier(transcript_kind="poseidon")) against
the JAX package's ops/poseidon.py, JaxPoseidonTranscript, its python-int
oracle util/poseidon.py and its native verifier, on the CPU.

Inputs come from numpy with a fixed seed; every comparison is exact (limbs
equal).  The JAX side runs eagerly, as tests/test_poseidon.py runs it.
"""

import numpy as np
import pytest
import torch
from test_torch_fixture import jax_data_protocol, jax_native_accumulator

from snark_verifier_tpu.loader.jax_loader import JaxLoader
from snark_verifier_tpu.ops import field as JF
from snark_verifier_tpu.ops import poseidon as JP
from snark_verifier_tpu.system.halo2 import transcript as JT
from snark_verifier_tpu.system.halo2.transcript_jax import JaxPoseidonTranscript
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu.util import poseidon as JPO
from snark_verifier_tpu_torch import entry as E
from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import poseidon as P
from snark_verifier_tpu_torch.parallel.batch import build_verifier, decode_accumulator, pack_instances, pack_proofs
from snark_verifier_tpu_torch.system.halo2 import transcript as PT
from snark_verifier_tpu_torch.system.halo2.transcript_torch import TorchPoseidonTranscript
from snark_verifier_tpu_torch.util import poseidon as PPO

BATCH = 3


def rand_fr(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % bn254.R for _ in range(count)]


def port_fr(values):
    """Python ints -> (len, 16) Montgomery limbs of the port (CPU)."""
    return torch.as_tensor(F.FR.encode(values).astype(np.int64))


def jax_fr(values):
    return np.asarray(JF.FR.encode(values))


@pytest.mark.parametrize("n_inputs", [0, 2, 4])
def test_permutation_matches_jax_and_oracle(n_inputs):
    """The port's permutation, the JAX package's and the oracle agree at
    batch 3, with no inputs, some, and a full rate."""
    import jax.numpy as jnp

    rng = np.random.default_rng(40 + n_inputs)
    t = PPO.default_spec().t
    states = [rand_fr(rng, t) for _ in range(BATCH)]
    inputs = [rand_fr(rng, BATCH) for _ in range(n_inputs)]
    pstate = torch.stack([port_fr(row) for row in states])
    pins = [port_fr(col) for col in inputs]
    port = P.permutation(PPO.default_spec(), pstate, pins)
    jax_out = JP.permutation(
        JPO.default_spec(), jnp.asarray(np.stack([jax_fr(row) for row in states])), [jnp.asarray(jax_fr(c)) for c in inputs]
    )
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_out).astype(np.int64))
    for b in range(BATCH):
        want = JPO.permutation(JPO.default_spec(), states[b], [col[b] for col in inputs])
        assert [int(v) for v in F.FR.decode(port[b])] == want


def test_constant_tensors_match_jax():
    """The port's constant tables (built from its copies of util/poseidon and
    util/poseidon_opt) equal the JAX package's ``_opt_tensors``."""
    jspec, pspec = JPO.default_spec(), PPO.default_spec()
    c_start, c_partial, c_end, mds, pre_sparse, sp_row, sp_col, half = JP._opt_tensors(jspec)
    opt = P.spec_arrays(pspec)
    want = {"c_start": c_start, "c_partial": c_partial, "c_end": c_end, "mds": mds, "pre_sparse": pre_sparse,
            "sp_row": sp_row, "sp_col": sp_col}
    assert sorted(opt) == sorted(want) and half == pspec.r_f // 2
    for key, value in want.items():
        np.testing.assert_array_equal(opt[key], np.asarray(value).astype(np.int64), err_msg=key)


K10_GROUP = 8  # csrc/poseidon.cu PERM_GROUP: lanes per row


def k10_model(table, t, r_f, r_p, state, inputs):
    """K10's schedule (csrc/poseidon.cu) on python ints: the flat table read
    by the kernel's own index arithmetic, one row on a group of 8 lanes,
    lane j < t holding word j and lanes t.. repeating word 0; a shuffle is a
    read of another lane's value."""
    r = bn254.R
    half = r_f // 2
    mds = (half + 1) * t
    pre = mds + t * t
    partial = pre + t * t
    end = partial + 2 * t * r_p
    assert len(table) == end + half * t
    words = [lane if lane < t else 0 for lane in range(K10_GROUP)]
    w = []
    for j in words:  # absorb: round-0 constant, input j - 1, the padding one after the last input
        v = (state[j] + table[j]) % r
        if 1 <= j <= len(inputs):
            v = (v + inputs[j - 1]) % r
        if j == len(inputs) + 1:
            v = (v + 1) % r
        w.append(v)
    for rnd in range(r_f + r_p):
        full = rnd < half or rnd >= half + r_p
        c = (rnd + 1) * t if rnd < half else end + (rnd - half - r_p) * t
        q = partial + 2 * t * (rnd - half)
        s = [(pow(w[lane] if full else w[0], 5, r) + table[c + j if full else q]) % r for lane, j in enumerate(words)]
        if full:
            row = pre if rnd == half - 1 else mds
            w = [sum(s[k] * table[row + j * t + k] for k in range(t)) % r for j in words]
        else:
            prod = [(s[lane] if j == 0 else w[lane]) * table[q + 1 + j] % r for lane, j in enumerate(words)]
            nxt = [(table[q + t + j] * s[lane] + w[lane]) % r for lane, j in enumerate(words)]
            w0 = sum(prod[:t]) % r
            w = [w0 if j == 0 else nxt[lane] for lane, j in enumerate(words)]
    assert w[t:] == [w[0]] * (K10_GROUP - t)  # the spare lanes kept word 0
    return w[:t]


@pytest.mark.parametrize("n_inputs", [0, 1, 2, 3, 4])
def test_k10_table_and_round_order_match_oracle_and_plain(n_inputs):
    """K10's flat constant table walked in the kernel's order and lane roles
    (absorb with the padding one, start and boundary rounds, each partial
    round's constant, row and column at 2 t elements a round, the zero last
    row) equals the JAX package's oracle and the plain permutation, limb for
    limb, for 0-4 inputs."""
    spec = PPO.default_spec()
    flat = P.flat_table(spec)
    assert flat.shape == (695, 16) and flat.dtype == np.int64
    assert not flat[-spec.t:].any()  # the last end row: the constant-free final round
    table = [int(v) for v in F.FR.decode(flat)]
    rng = np.random.default_rng(90 + n_inputs)
    states = [rand_fr(rng, spec.t) for _ in range(2)]
    inputs = [rand_fr(rng, n_inputs) for _ in range(2)]
    plain = P.permutation_plain(spec, torch.stack([port_fr(row) for row in states]),
                                [port_fr([ins[k] for ins in inputs]) for k in range(n_inputs)])
    for b in range(2):
        got = k10_model(table, spec.t, spec.r_f, spec.r_p, states[b], inputs[b])
        assert got == JPO.permutation(JPO.default_spec(), states[b], inputs[b])
        np.testing.assert_array_equal(plain[b].numpy(), F.FR.encode(got).astype(np.int64))


def test_sponge_calls_the_module_permutation_once_per_permutation(monkeypatch):
    """The sponge reaches the permutation through ``ops.poseidon.permutation``
    (the attribute the benchmark's ``poseidon.host_share`` wraps), once per
    permutation: two calls for a squeeze after exactly one rate (the extra
    empty one), one below it; the outputs are unchanged by the wrapper."""
    spec = PPO.default_spec()
    rng = np.random.default_rng(5)
    words = [port_fr(rand_fr(rng, 2)) for _ in range(spec.rate + spec.rate - 1)]
    want = []
    for chunk in (words[:spec.rate], words[spec.rate:]):
        sponge = P.TorchPoseidonSponge(spec, (2,), "cpu")
        sponge.update(chunk)
        want.append(sponge.squeeze())
    calls = []
    plain = P.permutation

    def counted(*args):
        calls.append(len(args[2]))
        return plain(*args)

    monkeypatch.setattr(P, "permutation", counted)
    for chunk, w, counts in ((words[:spec.rate], want[0], [spec.rate, 0]), (words[spec.rate:], want[1], [spec.rate - 1])):
        calls.clear()
        sponge = P.TorchPoseidonSponge(spec, (2,), "cpu")
        sponge.update(chunk)
        assert torch.equal(sponge.squeeze(), w)
        assert calls == counts


def test_permutation_routes_cpu_to_plain_and_validates():
    """CPU tensors take ``permutation_plain`` (no K10 launch); mixed devices
    raise as ``config.use_kernel`` does; K10 refuses a width it is not built
    for and a full-width absorb before touching the card."""
    spec = PPO.default_spec()
    rng = np.random.default_rng(3)
    state = port_fr(rand_fr(rng, spec.t))
    inputs = [port_fr(rand_fr(rng, 1))[0]]
    launches = P.poseidon_perm.launches
    assert torch.equal(P.permutation(spec, state, inputs), P.permutation_plain(spec, state, inputs))
    assert P.poseidon_perm.launches == launches
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        P.permutation(spec, state.to("meta"), inputs)
    narrow = PPO.PoseidonSpec(3, 2, spec.r_f, spec.r_p, [], [])
    with pytest.raises(ValueError, match="built for t"):
        P.poseidon_perm(narrow, state[:3], [])
    with pytest.raises(ValueError, match="at most t - 1"):
        P.poseidon_perm(spec, state, [inputs[0]] * spec.t)
    assert P.poseidon_perm.launches == launches


def test_sponge_matches_jax_and_oracle_across_the_exact_rate():
    """Squeezes after exactly one rate of input (one extra empty
    permutation), after nothing (one empty permutation), and after 5 and 9
    words; the state is broadcast over the batch."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    spec = PPO.default_spec()
    first, later = rand_fr(rng, spec.rate), [rand_fr(rng, 5), rand_fr(rng, 9)]
    port = P.TorchPoseidonSponge(spec, (2,), "cpu")
    jaxs = JP.JaxPoseidonSponge(JPO.default_spec(), (2,))
    oracle = JPO.PoseidonSponge(JPO.default_spec())
    for chunk in (first, []):
        port.update([port_fr([v])[0] for v in chunk])
        jaxs.update([jnp.asarray(jax_fr([v])[0]) for v in chunk])
        oracle.update(chunk)
        got = port.squeeze()
        assert tuple(got.shape) == (2, 16)
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.asarray(jaxs.squeeze()), (2, 16)))
        assert [int(v) for v in F.FR.decode(got)] == [oracle.squeeze()] * 2
    for chunk in later:
        port.update([port_fr([v])[0] for v in chunk])
        oracle.update(chunk)
        assert [int(v) for v in F.FR.decode(port.squeeze())] == [oracle.squeeze()] * 2


def _stream_rows():
    """Four 64-byte Poseidon streams (a compressed point, then a scalar): a
    valid point; the all-zero encoding (the native identity: x = 0 and 3 is
    a non-residue); a non-residue x; x >= p with a scalar >= r."""
    rng = np.random.default_rng(11)
    pt = bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62)))
    scalar = rand_fr(rng, 1)[0].to_bytes(32, "little")
    valid = JT.compress_g1(pt)
    nonres = E.corrupt_compressed(valid, 0, out_of_range=False)
    big = E.corrupt_compressed(valid, 0, out_of_range=True)
    return [valid + scalar, bytes(32) + scalar, nonres + scalar, big + (bn254.R + 5).to_bytes(32, "little")]


def test_transcript_matches_jax_poseidon_transcript():
    """Point and scalar reads, the validity mask and the next challenge equal
    JaxPoseidonTranscript's, row for row; the identity, non-residue and
    out-of-range rows clear ``ok`` without raising."""
    import jax.numpy as jnp

    rows = _stream_rows()
    data = np.frombuffer(b"".join(rows), np.uint8).reshape(len(rows), 64).astype(np.int64)
    loader = TorchLoader((len(rows),), "cpu")
    tr = TorchPoseidonTranscript(torch.as_tensor(data), loader)
    jloader = JaxLoader((len(rows),))
    jtr = JaxPoseidonTranscript(jnp.asarray(data.astype(np.uint32)), jloader)
    pt, jpt = tr.read_ec_point().value, jtr.read_ec_point().value
    s, js = tr.read_scalar(), jtr.read_scalar()
    c, jc = tr.squeeze_challenge(), jtr.squeeze_challenge()
    for got, want in ((pt.x, jpt.x), (pt.y, jpt.y), (s.value, js.value), (c.value, jc.value)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert loader.ok.tolist() == np.asarray(jloader.ok).tolist() == [True, False, False, False]


def test_port_native_poseidon_transcript_matches_jax_native():
    """The port's copies (compress_g1, decompress_g1,
    NativePoseidonTranscript) verify the four data-file Poseidon proofs to
    the JAX package's native accumulators, and round-trip points."""
    fx = E.poseidon_fixture()
    assert fx.transcript == "poseidon" and len(fx.proofs) == 4
    assert fx.instances == tuple([[20_000 + i]] for i in range(4))
    for proof, ins in zip(fx.proofs, fx.instances):
        want = jax_native_accumulator(jax_data_protocol(), "gwc", fx.svk, proof, ins, "poseidon")
        assert E.native_accumulator(fx, proof, ins) == want
        head = proof[:32]
        assert PT.decompress_g1(head) == JT.decompress_g1(head)
        assert PT.compress_g1(PT.decompress_g1(head)) == head
    assert PT.decompress_g1(bytes(32)) is None and PT.compress_g1(None) == bytes(32)


def test_poseidon_verify_matches_jax_native():
    """build_verifier(transcript_kind="poseidon") at B = 4 on the CPU: a good
    proof and a wrong instance give the JAX native verifier's accumulators;
    a compressed point with x >= p and one with a non-residue x clear ``ok``
    exactly on their rows."""
    fx = E.poseidon_fixture()
    proofs = [fx.proofs[0], fx.proofs[1], E.corrupt_compressed(fx.proofs[2], 0, True),
              E.corrupt_compressed(fx.proofs[3], 32, False)]
    instances = [fx.instances[0], [[fx.instances[1][0][0] + 1]], fx.instances[2], fx.instances[3]]
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device="cpu", transcript_kind="poseidon")
    out = fn(pack_proofs(proofs, "cpu"), pack_instances(instances, "cpu"))
    assert out["ok"].tolist() == [True, True, False, False]
    for row in (0, 1):
        want = jax_native_accumulator(jax_data_protocol(), "gwc", fx.svk, proofs[row], instances[row], "poseidon")
        assert decode_accumulator(out, row) == want
    with pytest.raises(ValueError):
        build_verifier(fx.protocol, fx.As, fx.svk, device="cpu", transcript_kind="blake2b")
