"""Python-int models of the lane schedules of kernels K3 (``g1_double_group``
in snark_verifier_tpu_torch/csrc/bn254.cuh, one doubling on a group of 4
lanes) and K8 (``msm_window_kernel`` in csrc/msm.cu, one proof's window
sum on a group of 8 lanes), held on the CPU against the port's plain
versions and the JAX package, tolerance 0.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there).  These models follow each schedule lane by lane:
which lane multiplies which slots in each level, the adds each role runs
between the levels, which slot each lane writes before each __syncwarp
(no slot written by two lanes, none read in the phase that writes it), and
which words each lane stores; for K8 the order of its adds, the loads of
step i + 1 started before step i's add, the negation of y from the group's
ballots, and the index maps of the table and the grid."""

import itertools

import numpy as np
import pytest
import torch

from snark_verifier_tpu.ops import curve as JC
from snark_verifier_tpu.ops import curve_pallas as JCP
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import curve_cuda as CK
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import msm_cuda as MK
from snark_verifier_tpu_torch.ops.convert import g1_from_numpy, ints_to_tensor

P = bn254.P
R = 1 << 256
P_INV = pow(P, -1, R)
MASK32 = (1 << 32) - 1
NW = 8  # 32-bit words per field element


# ---- the field operations of bn254.cuh on python ints ----------------------

def fadd(a, b):
    t = a + b  # minus p when it carried out of 2^256 or is >= p
    return (t - P) % R if t >= P else t


def fsub(a, b):
    return a - b if a >= b else (a - b + P) % R


def fmul(a, b):  # fmul and fmul_eo: (a b + m p) / 2^256, one conditional subtract
    m = (-a * b * P_INV) % R
    t = (a * b + m * P) // R
    return (t - P) % R if t >= P else t


def words(v):
    return [(v >> (32 * j)) & MASK32 for j in range(NW)]


def to_ints(t: torch.Tensor):
    """(..., 16) limbs -> the integers they hold (Montgomery representatives)."""
    return [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in t.reshape(-1, 16).tolist()]


class Slots:
    """One group's shared-memory slots between two __syncwarp()s: a lane's
    write lands at the next sync; a slot may be written by one lane only and
    not read in the phase that writes it."""

    def __init__(self, n, init):
        self.v = list(init) + [None] * (n - len(init))
        self.pending = {}

    def read(self, i):
        assert i not in self.pending and self.v[i] is not None, f"slot {i} read before it is written and synced"
        return self.v[i]

    def write(self, lane, i, value):
        assert i not in self.pending, f"slot {i} written by lanes {self.pending[i][0]} and {lane} in one phase"
        self.pending[i] = (lane, value)

    def sync(self):
        for i, (_, value) in self.pending.items():
            self.v[i] = value
        self.pending = {}


# ---- K3: g1_double_group ----------------------------------------------------

def double_group_model(p):
    """2 p as the DBL_GROUP lanes of g1_double_group compute it, and the
    words each lane stores (lane k: words k and k + DBL_GROUP).  Returns
    the stored (x, y, z)."""
    group = CK.DBL_GROUP
    s = Slots(15, p)  # p 0-2, level 1's products 3-6, level 2's operands 7-10, its products 11-14
    roles = range(group)  # lane k multiplies and adds as role k
    # level 1: {y y, y z, z z, x y} on lanes 0-3
    ia, ib = (1, 1, 2, 0), (1, 2, 2, 1)
    prods = [fmul(s.read(ia[r]), s.read(ib[r])) for r in roles]
    for k in range(group):
        s.write(k, 3 + k, prods[k])
    s.sync()
    # between the levels, every lane in lockstep on its role's operands
    for k, r in enumerate(roles):
        a, c = s.read(3), s.read(5)
        w = a if r == 0 else c
        w = fadd(w, w)
        w = fadd(w, w)
        w = fadd(w, w)  # 8 a = z3 (role 0), 8 c
        if k == 0:
            s.write(k, 8, w)
        t2 = fadd(w, c)  # 9 c = t2
        if k == 1:
            s.write(k, 7, t2)
        v = fadd(t2, t2 if r == 3 else a)  # y3 = a + t2 (role 2), 2 t2
        if k == 2:
            s.write(k, 9, v)
        e = fsub(a, fadd(v, t2))  # a - 3 t2
        if k == 3:
            s.write(k, 10, e)
    s.sync()
    # level 2: {t2 z3, b z3, e y3, e d}
    ra, rb = (7, 4, 10, 10), (8, 8, 9, 6)
    prods = [fmul(s.read(ra[r]), s.read(rb[r])) for r in roles]
    for k in range(group):
        s.write(k, 11 + k, prods[k])
    s.sync()
    out = [[None] * NW for _ in range(3)]
    for k in range(group):
        ed = s.read(14)
        coords = (fadd(ed, ed), fadd(s.read(13), s.read(11)), s.read(12))
        for h in range(NW // group):
            j = k + h * group
            for c, v in enumerate(coords):
                assert out[c][j] is None, f"word {j} stored twice"
                out[c][j] = words(v)[j]
    return tuple(sum(w << (32 * j) for j, w in enumerate(ws)) for ws in out)


@pytest.fixture(scope="module")
def doubling_inputs():
    """Seeded affine points, projective ones (P + Q from the JAX XLA add, z
    != 1), the identity (z = 0) in both batches, seeded triples of field
    elements off the curve, the projective points doubled once more (the
    table ladder's chained doublings), every triple of the edge values 0,
    1, 2, p - 2, p - 1, and identities (z = 0) with seeded and edge x and
    y, as JAX (x, y, z) limb arrays."""
    rng = np.random.default_rng(71)
    ps = [bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(10)]
    qs = [bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(10)]
    ps[0], qs[4], qs[5] = None, None, ps[5]  # the identity, P + O, P + P
    jp = JC.g1_from_affine_ints(ps)
    jr = JC._g1_add_xla(jp, JC.g1_from_affine_ints(qs))
    off = [[int.from_bytes(rng.bytes(32), "little") % P for _ in range(6)] for _ in range(3)]
    off[2][0] = 0  # z = 0 off the curve too
    jo = tuple(F.FQ.encode(c) for c in off)
    jd = JC._g1_double_xla(jr)
    edge = [0, 1, 2, P - 2, P - 1]
    je = tuple(F.FQ.encode([t[c] for t in itertools.product(edge, repeat=3)]) for c in range(3))
    xy = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(8)] + edge
    ji = tuple(F.FQ.encode(c) for c in (xy, xy[::-1], [0] * len(xy)))
    return {"affine": jp, "projective": jr, "off_curve": jo, "doubled": jd, "edge_values": je, "identities": ji}


@pytest.mark.parametrize("kind", ["affine", "projective", "off_curve", "doubled", "edge_values", "identities"])
def test_double_group_schedule_matches_plain_and_jax(doubling_inputs, kind):
    """g1_double_group's lanes, slots and stores give g1_double_plain's and
    the JAX package's g1_double_t's (its CPU path runs the Pallas kernel
    body) limbs for every input, the identity among them; with no slot
    written twice or read before its __syncwarp."""
    jp = doubling_inputs[kind]
    pt = g1_from_numpy(jp, "cpu")
    plain = CK.g1_double_plain(pt)
    want_jax = JCP.g1_double_t(tuple(np.asarray(c).T for c in jp))
    for c, w in zip(plain, want_jax):
        np.testing.assert_array_equal(c.numpy(), np.asarray(w).T.astype(np.int64))
    xs, ys, zs = (to_ints(c) for c in pt)
    got = [double_group_model(p) for p in zip(xs, ys, zs)]
    for c in range(3):
        assert [g[c] for g in got] == to_ints(plain[c])
    if kind == "identities":
        assert all(z == 0 for z in to_ints(plain[2]))
    if kind == "affine":
        assert any(z == 0 for z in zs)
        assert C.g1_to_affine_ints(plain) == [None if p is None else bn254.g1_double(p) for p in
                                              C.g1_to_affine_ints(pt)]


def test_double_grid_serves_each_point_once_and_validates():
    """K3's map: thread t of block b serves doubling (b * block + t) // 4
    and its limb pairs t % 4 and t % 4 + 4; every word of every live
    doubling once, no block wholly past the end."""
    group = CK.DBL_GROUP
    for n in (1, 31, 32, 288, 8192, 32760):
        grid = CK.dbl_grid(n)
        thread = torch.arange(grid * CK.DBL_BLOCK)
        point, lane = thread // group, thread % group
        live = point < n
        pairs = torch.stack([lane + h * group for h in range(NW // group)], -1)[live]  # (live threads, 2)
        served = point[live].unsqueeze(-1) * NW + pairs
        assert torch.equal(served.reshape(-1).sort().values, torch.arange(n * NW))
        assert (grid - 1) * CK.DBL_BLOCK < n * group and CK.DBL_BLOCK % 32 == 0
    g = C.g1_from_affine_ints([None, (1, 2)], "cpu")
    with pytest.raises(ValueError):
        CK.double_points(g, schedule="warp")


# ---- K8: msm_window_kernel --------------------------------------------------

def neg_word_model(y):
    """fsub(0, y) as the 8 lanes of a group compute it (csrc/msm.cu
    neg_word): lane k holds word k of y; the borrows come from the group's
    ballots of p_j < y_j and p_j == y_j, as the carries of one add."""
    pw, yw = words(P), words(y)
    gen = sum(1 << j for j in range(NW) if pw[j] < yw[j])
    prop = sum(1 << j for j in range(NW) if pw[j] == yw[j])
    nonzero = any(yw)
    either = gen | prop
    borrows = (either + gen) ^ either ^ gen
    out = [(pw[k] - yw[k] - ((borrows >> k) & 1)) & MASK32 if nonzero else 0 for k in range(NW)]
    return sum(w << (32 * k) for k, w in enumerate(out))


def test_negation_from_ballots_is_fsub_of_zero():
    """The ballot negation equals fsub(0, y) for any y < 2^256 (and the
    plain version's F.neg below p): zero, p and its neighbours, words equal
    to p's in long runs (the borrow travels), the top, seeded values."""
    rng = np.random.default_rng(5)
    pw = words(P)
    runs = [sum(w << (32 * j) for j, w in enumerate(pw[:k] + [pw[k] + d] + pw[k + 1:]))
            for k in range(NW) for d in (-1, 1) if 0 <= pw[k] + d <= MASK32]
    ys = [0, 1, 2, P - 1, P, P + 1, R - 1, R - P, MASK32, 1 << 255] + runs
    ys += [int.from_bytes(rng.bytes(32), "little") % P for _ in range(200)]
    ys += [int.from_bytes(rng.bytes(32), "little") for _ in range(200)]
    for y in ys:
        assert neg_word_model(y) == fsub(0, y), hex(y)
    below = [y for y in ys if y < P]
    assert to_ints(F.neg(ints_to_tensor(below, "cpu"), F.FQ)) == [fsub(0, y) for y in below]


def mul_b3(t):  # 9 t as 2 t, 4 t, 8 t, 8 t + t
    t8 = fadd(t, t)
    t8 = fadd(t8, t8)
    t8 = fadd(t8, t8)
    return fadd(t8, t)


def add_model(p, q):
    """RCB15 alg. 7 with g1_add's (and g1_add_group's) operations on python
    ints: its level-1 products, the adds between, level 2."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    t0, t1, t2 = fmul(x1, x2), fmul(y1, y2), fmul(z1, z2)
    t3 = fsub(fmul(fadd(x1, y1), fadd(x2, y2)), fadd(t0, t1))
    t4 = fsub(fmul(fadd(y1, z1), fadd(y2, z2)), fadd(t1, t2))
    y3 = fsub(fmul(fadd(x1, z1), fadd(x2, z2)), fadd(t0, t2))
    t0 = fadd(fadd(t0, t0), t0)
    t2 = mul_b3(t2)
    z3 = fadd(t1, t2)
    t1 = fsub(t1, t2)
    y3 = mul_b3(y3)
    return (fsub(fmul(t3, t1), fmul(t4, y3)), fadd(fmul(t1, z3), fmul(y3, t0)), fadd(fmul(z3, t4), fmul(t0, t3)))


def window_model(table_ints, digits, b):
    """Proof b's window sum as msm_window_kernel's group runs it: the
    variables d, d_next and the loaded words w move as in the kernel (step i
    + 1's entry loaded before step i's add, negated and put in the q slots
    after it); the adds in msm_window_plain's order."""
    n = len(digits[b])
    dig = digits[b]

    def load(d, i):  # load_entry: the entry's words, through window_entry_offset's map
        return list(table_ints(d, i, b))

    def negated(w, d):
        return [w[0], neg_word_model(w[1]) if d < 0 else w[1], w[2]]

    d = dig[0]
    acc = negated(load(d, 0), d)
    q = None
    d_next = dig[2] if n > 2 else 0
    if n > 1:
        d = dig[1]
        q = negated(load(d, 1), d)
    for i in range(1, n):
        more = i + 1 < n
        d = d_next
        if more:
            w = load(d, i + 1)
            d_next = dig[i + 2] if i + 2 < n else 0
        acc = list(add_model(acc, q))
        if more:
            q = negated(w, d)
    return acc


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_window_group_schedule_matches_plain(n):
    """K8's loop on its index map against msm_window_plain at B = 3 proofs
    of n points: zero digits, +-8, and a negative first digit."""
    rng = np.random.default_rng(40 + n)
    batch = 3
    pts = [[bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)] for _ in range(batch)]
    g = C.g1_from_affine_ints([p for row in pts for p in row], "cpu")
    table = MK.build_tables(C.G1(*(c.reshape(batch, n, 16).transpose(0, 1) for c in g))).contiguous()
    digits = torch.as_tensor(rng.integers(-8, 9, (batch, n)), dtype=torch.int64)
    digits[0, 0], digits[1, 0], digits[2, -1] = -3, 0, 8
    if n > 1:
        digits[0, 1], digits[2, 0] = -8, -1
    flat = table.reshape(-1)
    coord = n * batch * 16

    def entry(d, i, b):  # the three coordinates, read through the kernel's offsets
        off = MK.window_entry_offset(d, i, b, n, batch)
        return [sum(int(v) << (16 * j) for j, v in enumerate(flat[off + c * coord:off + c * coord + 16].tolist()))
                for c in range(3)]

    want = MK.msm_window_plain(table, digits)
    wx, wy, wz = (to_ints(c) for c in want)
    dl = digits.tolist()
    for b in range(batch):
        assert window_model(entry, dl, b) == [wx[b], wy[b], wz[b]]


def test_window_offsets_and_grid():
    """window_entry_offset addresses T_i[|d|] of proof b in the (9, 3, n, B,
    16) table (x, then y and z n * B * 16 further), and the grid serves each
    proof once with 8 lanes (lane k: limb pair k)."""
    n, batch = 4, 5
    table = torch.arange(9 * 3 * n * batch * 16).reshape(9, 3, n, batch, 16)
    flat = table.reshape(-1)
    for d in range(-8, 9):
        for i in range(n):
            for b in range(batch):
                off = MK.window_entry_offset(d, i, b, n, batch)
                for c in range(3):
                    assert torch.equal(flat[off + c * n * batch * 16:][:16], table[abs(d), c, i, b])
    for batch in (1, 3, 8, 9, 1820):
        grid = MK.window_grid(batch)
        thread = torch.arange(grid * MK.WINDOW_BLOCK)
        proof = thread // MK.WINDOW_GROUP
        assert torch.equal(proof[(thread % MK.WINDOW_GROUP == 0) & (proof < batch)], torch.arange(batch))
        assert (grid - 1) * MK.WINDOW_BLOCK < batch * MK.WINDOW_GROUP and MK.WINDOW_BLOCK % 32 == 0
        assert MK.WINDOW_GROUP == NW  # lane k holds word k: the ballots cover one element
