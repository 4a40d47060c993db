"""Python-int models of the lane schedules of kernels K3 (``g1_double_group``
in snark_verifier_tpu_torch/csrc/bn254.cuh, one doubling on a group of 4
lanes), K8 (``msm_window_kernel`` in csrc/msm.cu, one proof's window sum
on a group of 8 lanes) and K9 (``msm_horner_kernel`` in csrc/msm.cu, one
proof's Horner step on a group of 8 lanes: 4 ``g1_double_group`` and one
``g1_add_group``), held on the CPU against the port's plain versions and
the JAX package, tolerance 0.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there).  These models follow each schedule lane by lane:
which lane multiplies which slots in each level, the adds each role runs
between the levels, which slot word each lane writes before each
__syncwarp (no word written by two lanes, no slot read in the phase that
writes it or written in the phase that reads it), and which words each lane
stores; for K8 the order of its adds, the loads of step i + 1 started
before step i's add, the negation of y from the group's ballots, and the
index maps of the table and the grid; for K9 the two halves' slot sets,
when contrib reaches the add's slots, and the trailing group that stores
nothing."""

import itertools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from snark_verifier_tpu.ops import curve as JC
from snark_verifier_tpu.ops import curve_pallas as JCP
from snark_verifier_tpu.ops import msm_pallas as MP
from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops import msm as M
from snark_verifier_tpu_torch.ops import msm_cuda as MK
from snark_verifier_tpu_torch.ops.convert import g1_from_numpy, ints_to_tensor

P = bn254.P
R = 1 << 256
P_INV = pow(P, -1, R)
MASK32 = (1 << 32) - 1
NW = 8  # 32-bit words per field element
_HEADER = (Path(MK.__file__).resolve().parents[1] / "csrc" / "bn254.cuh").read_text()
# slots of one add group (p, q, level 1's products, level 2's operands) and
# of one doubling group (p, level 1's products, level 2's operands and products)
ADD_SLOTS, DBL_SLOTS = (int(re.search(rf"constexpr int {name} = (\d+);", _HEADER).group(1))
                        for name in ("ADD_SLOTS", "DBL_SLOTS"))


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
    """A group's shared-memory slots (one field element each, 8 words) between
    two __syncwarp()s: a lane's write lands at the next sync; a word may be
    written by one lane only, a slot not read in the phase that writes it,
    nor written in the phase that reads it."""

    def __init__(self, n, init=()):
        self.v = [[None] * NW for _ in range(n)]
        for i, value in enumerate(init):
            self.v[i] = words(value)
        self.pending, self.reads = {}, set()

    def read(self, i):
        assert not any(j == i for j, _ in self.pending), f"slot {i} read in the phase that writes it"
        assert None not in self.v[i], f"slot {i} read before it is written and synced"
        self.reads.add(i)
        return sum(w << (32 * j) for j, w in enumerate(self.v[i]))

    def write_word(self, lane, i, j, w):
        assert i not in self.reads, f"slot {i} written by lane {lane} in the phase that reads it"
        assert (i, j) not in self.pending, f"slot {i} word {j} written by lanes {self.pending[i, j][0]} and {lane}"
        self.pending[i, j] = (lane, w)

    def write(self, lane, i, value):
        for j, w in enumerate(words(value)):
            self.write_word(lane, i, j, w)

    def sync(self):
        for (i, j), (_, w) in self.pending.items():
            self.v[i][j] = w
        self.pending, self.reads = {}, set()


# ---- K3: g1_double_group ----------------------------------------------------

def double_groups(s, sets):
    """g1_double_group run by groups of DBL_GROUP lanes at once, in the same
    __syncwarp()s, each group on its own slot set: ``sets`` holds (base slot,
    the group's lane ids, role k = position).  Returns each lane's 2 p."""
    group = C.DBL_GROUP
    assert all(len(lanes) == group for _, lanes in sets)
    # level 1: {y y, y z, z z, x y} on lanes 0-3 (p in slots 0-2 of the set)
    ia, ib = (1, 1, 2, 0), (1, 2, 2, 1)
    for base, lanes in sets:
        for k, lane in enumerate(lanes):
            s.write(lane, base + 3 + k, fmul(s.read(base + ia[k]), s.read(base + ib[k])))
    s.sync()
    # between the levels, every lane in lockstep on its role's operands
    for base, lanes in sets:
        for k, lane in enumerate(lanes):
            a, c = s.read(base + 3), s.read(base + 5)
            w = a if k == 0 else c
            w = fadd(w, w)
            w = fadd(w, w)
            w = fadd(w, w)  # 8 a = z3 (role 0), 8 c
            if k == 0:
                s.write(lane, base + 8, w)
            t2 = fadd(w, c)  # 9 c = t2
            if k == 1:
                s.write(lane, base + 7, t2)
            v = fadd(t2, t2 if k == 3 else a)  # y3 = a + t2 (role 2), 2 t2
            if k == 2:
                s.write(lane, base + 9, v)
            e = fsub(a, fadd(v, t2))  # a - 3 t2
            if k == 3:
                s.write(lane, base + 10, e)
    s.sync()
    # level 2: {t2 z3, b z3, e y3, e d}
    ra, rb = (7, 4, 10, 10), (8, 8, 9, 6)
    for base, lanes in sets:
        for k, lane in enumerate(lanes):
            s.write(lane, base + 11 + k, fmul(s.read(base + ra[k]), s.read(base + rb[k])))
    s.sync()
    out = {}
    for base, lanes in sets:
        for lane in lanes:
            ed = s.read(base + 14)
            out[lane] = (fadd(ed, ed), fadd(s.read(base + 13), s.read(base + 11)), s.read(base + 12))
    return out


def double_group_model(p):
    """2 p as the DBL_GROUP lanes of g1_double_group compute it, and the
    words each lane stores (lane k: words k and k + DBL_GROUP).  Returns
    the stored (x, y, z)."""
    group = C.DBL_GROUP
    s = Slots(DBL_SLOTS, p)  # p 0-2, level 1's products 3-6, level 2's operands 7-10, its products 11-14
    results = double_groups(s, [(0, range(group))])
    out = [[None] * NW for _ in range(3)]
    for k in range(group):
        for h in range(NW // group):
            j = k + h * group
            for c, v in enumerate(results[k]):
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
    plain = C.g1_double_plain(pt)
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
    group = C.DBL_GROUP
    for n in (1, 31, 32, 288, 8192, 32760):
        grid = C.dbl_grid(n)
        thread = torch.arange(grid * C.DBL_BLOCK)
        point, lane = thread // group, thread % group
        live = point < n
        pairs = torch.stack([lane + h * group for h in range(NW // group)], -1)[live]  # (live threads, 2)
        served = point[live].unsqueeze(-1) * NW + pairs
        assert torch.equal(served.reshape(-1).sort().values, torch.arange(n * NW))
        assert (grid - 1) * C.DBL_BLOCK < n * group and C.DBL_BLOCK % 32 == 0
    g = C.g1_from_affine_ints([None, (1, 2)], "cpu")
    with pytest.raises(ValueError):
        C.g1_double(C.G1(g.x, g.y.int(), g.z))
    with pytest.raises(ValueError):
        C.g1_double(C.G1(*(c[..., :8] for c in g)))


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
    table = M.build_tables(C.G1(*(c.reshape(batch, n, 16).transpose(0, 1) for c in g))).contiguous()
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


# ---- K9: msm_horner_kernel --------------------------------------------------

def add_group_model(s, group):
    """g1_add_group<8> on slots 0-17 of ``s`` (p in 0-2, q in 3-5): every
    lane of the group in its role (lanes 6 and 7 repeat role 0 and write
    nothing), the products and the second level's operands through the
    slots.  Returns each lane's p + q."""
    roles = {k: k if k < 6 else 0 for k in group}
    for k, role in roles.items():  # level 1: roles 0-2 the coordinates, 3-5 the sums of (0, 1), (1, 2), (0, 2)
        ia = role if role < 3 else (1 if role == 4 else 0)
        ib = role if role < 3 else (1 if role == 3 else 2)
        pa, pb, qa, qb = s.read(ia), s.read(ib), s.read(3 + ia), s.read(3 + ib)
        prod = fmul(pa, qa) if role < 3 else fmul(fadd(pa, pb), fadd(qa, qb))
        if k < 6:
            s.write(k, 6 + k, prod)
    s.sync()
    for k, role in roles.items():  # the six chains of the adds between the levels, one a role
        t0, t1, t2 = s.read(6), s.read(7), s.read(8)
        rr = s.read(9 + (role if role < 3 else 0))
        w = fadd(t1 if role == 1 else (t2 if role >= 4 else t0), t1 if role == 0 else (t0 if role == 3 else t2))
        d = fsub(rr, w)
        w = d if role < 3 else fadd(w, t0 if role == 3 else w)
        y = w
        if k < 2 or k == 3:
            s.write(k, 12 + k, w)  # t3, t4, t0
        w = fadd(w, w)
        w = fadd(w, w if role == 2 else t2)
        z = fadd(w if role == 2 else t1, w)
        w = fsub(t1, w) if role == 5 else z
        if k in (4, 5):
            s.write(k, 12 + k, w)  # z3, t1
        w = fadd(w, y)
        if k == 2:
            s.write(k, 12 + k, w)  # y3
    s.sync()
    for k, role in roles.items():  # level 2: {t3 t1, t4 y3, t1 z3, y3 t0, z3 t4, t0 t3}
        ra = (0, 1, 5, 2, 4, 3)[role]
        rb = (5, 2, 4, 3, 1, 0)[role]
        prod = fmul(s.read(12 + ra), s.read(12 + rb))
        if k < 6:
            s.write(k, 6 + k, prod)
    s.sync()
    return {k: (fsub(s.read(6), s.read(7)), fadd(s.read(8), s.read(9)), fadd(s.read(10), s.read(11)))
            for k in group}


def horner_group_model(acc, contrib, live=True):
    """16 acc + contrib as msm_horner_kernel's group of 8 lanes computes it:
    lane k loads word k of acc's coordinates into both halves' p slots
    (half 0's doubling set is slots 0-14 of the add's, half 1's starts at
    ADD_SLOTS) and word k of contrib's into its registers; 4 doublings, each
    half on its own set, lanes 0-2 of each half writing the result's x, y, z
    back to its p slots; after the fourth, every lane writes its contrib
    words to the add's q slots (3-5), then one add.  Returns {(coordinate,
    word): value} as the lanes store it (nothing where the group is past the
    batch's end)."""
    group = range(MK.WINDOW_GROUP)
    half = C.DBL_GROUP
    sets = [(0, range(half)), (ADD_SLOTS, range(half, 2 * half))]
    s = Slots(ADD_SLOTS + DBL_SLOTS)
    q = {k: [words(c)[k] for c in contrib] for k in group}  # registers, off the chain
    for k in group:
        for c in range(3):
            w = words(acc[c])[k]
            s.write_word(k, c, k, w)
            s.write_word(k, ADD_SLOTS + c, k, w)
    s.sync()
    for i in range(4):
        results = double_groups(s, sets)
        assert len(set(results.values())) == 1  # both halves double the same point
        for base, lanes in sets:
            for role, lane in enumerate(lanes):
                if role < 3:
                    s.write(lane, base + role, results[lane][role])
        if i == 3:
            for k in group:
                for c in range(3):
                    s.write_word(k, 3 + c, k, q[k][c])
        s.sync()
    sums = add_group_model(s, group)
    assert len(set(sums.values())) == 1
    if not live:
        return {}
    stored = {}
    for k in group:
        for c in range(3):
            stored[c, k] = words(sums[k][c])[k]
    return stored


def horner_rows():
    """Seeded (acc, contrib) rows for K9, as python-int affine points or
    projective triples, by case: affine and projective accumulators with
    affine and projective contributions, acc the identity, contrib the
    identity, contrib = 16 acc (the add's doubling case, the same triple
    as the 4 doublings give) and contrib = -16 acc."""
    rng = np.random.default_rng(97)

    def pts(n):
        return [bn254.g1_mul(bn254.G1_GEN, int(rng.integers(1, 1 << 62))) for _ in range(n)]

    def proj(points):  # P + Q (z != 1) through the JAX XLA add
        return JC._g1_add_xla(JC.g1_from_affine_ints(points), JC.g1_from_affine_ints(pts(len(points))))

    def rows(j):  # JAX (x, y, z) limb arrays -> triples of Montgomery ints
        return list(zip(*(to_ints(torch.as_tensor(np.asarray(c).astype(np.int64))) for c in j)))

    aff = lambda points: rows(JC.g1_from_affine_ints(points))  # noqa: E731
    ident = rows(JC.g1_from_affine_ints([None] * 3))
    cases = {
        "affine": (aff(pts(3)), aff(pts(3))),
        "projective": (rows(proj(pts(3))), rows(proj(pts(3)))),
        "acc_identity": (ident, rows(proj(pts(3)))),
        "contrib_identity": (rows(proj(pts(3))), ident),
    }
    acc = rows(proj(pts(3)))
    t = C.G1(*(ints_to_tensor([a[c] for a in acc], "cpu") for c in range(3)))
    for _ in range(4):
        t = C.g1_double_plain(t)
    sixteen = list(zip(*(to_ints(c) for c in t)))
    cases["contrib_16_acc"] = (acc, sixteen)
    cases["contrib_minus_16_acc"] = (acc, [(x, fsub(0, y), z) for x, y, z in sixteen])
    return cases


@pytest.fixture(scope="module")
def horner_cases():
    """Every case's rows in one batch, and what msm_horner_plain and the JAX
    package's _horner_call (its CPU branch, eager) give for them."""
    cases = horner_rows()
    accs = [a for acc, _ in cases.values() for a in acc]
    contribs = [c for _, contrib in cases.values() for c in contrib]

    def g1(rows):
        return C.G1(*(ints_to_tensor([r[c] for r in rows], "cpu") for c in range(3)))

    plain = MK.msm_horner_plain(g1(accs), g1(contribs))
    lanes = 128  # the JAX package's lane tier on the CPU

    def slab(rows):  # (48, lanes) uint32: limb i of coordinate c in row 16 c + i, proof b in lane b
        pad = rows + [(0, 0, 0)] * (lanes - len(rows))
        return jax.numpy.asarray(np.array([[(r[c] >> (16 * i)) & 0xFFFF for r in pad] for c in range(3)
                                           for i in range(16)], np.uint32))

    with jax.disable_jit():
        jax_out = np.asarray(MP._horner_call(slab(accs), slab(contribs), lanes))
    jax_rows = [tuple(sum(int(jax_out[c * 16 + i, b]) << (16 * i) for i in range(16)) for c in range(3))
                for b in range(len(accs))]
    plain_rows = list(zip(*(to_ints(c) for c in plain)))
    offsets, at = {}, 0
    for name, (acc, _) in cases.items():
        offsets[name] = range(at, at + len(acc))
        at += len(acc)
    return cases, offsets, plain_rows, jax_rows


@pytest.mark.parametrize("kind", ["affine", "projective", "acc_identity", "contrib_identity", "contrib_16_acc",
                                  "contrib_minus_16_acc"])
def test_horner_group_schedule_matches_plain_and_jax(horner_cases, kind):
    """msm_horner_kernel's lanes, slots and stores give msm_horner_plain's
    and the JAX package's _horner_call's limbs for every row of the case,
    with no slot word written twice in a phase, none read in the phase that
    writes it; a group past the batch's end computes the same and stores
    nothing."""
    cases, offsets, plain_rows, jax_rows = horner_cases
    acc, contrib = cases[kind]
    for row, a, c in zip(offsets[kind], acc, contrib):
        assert plain_rows[row] == jax_rows[row]
        stored = horner_group_model(a, c)
        assert sorted(stored) == [(c_, k) for c_ in range(3) for k in range(NW)]  # each word once
        got = tuple(sum(stored[c_, k] << (32 * k) for k in range(NW)) for c_ in range(3))
        assert got == plain_rows[row]
    assert horner_group_model(acc[0], contrib[0], live=False) == {}
    if kind == "acc_identity":
        want = C.g1_to_affine_ints(C.G1(*(ints_to_tensor([r[i] for r in contrib], "cpu") for i in range(3))))
    else:
        a = C.g1_to_affine_ints(C.G1(*(ints_to_tensor([r[i] for r in acc], "cpu") for i in range(3))))
        c = C.g1_to_affine_ints(C.G1(*(ints_to_tensor([r[i] for r in contrib], "cpu") for i in range(3))))
        want = [bn254.g1_add(bn254.g1_mul(x, 16) if x is not None else None, y) for x, y in zip(a, c)]
    got = C.g1_to_affine_ints(C.G1(*(ints_to_tensor([plain_rows[r][i] for r in offsets[kind]], "cpu")
                                     for i in range(3))))
    assert got == want
    if kind == "contrib_minus_16_acc":
        assert all(p is None for p in got)


def test_horner_grid_stores_each_proof_once():
    """K9's map (K8's): proof (block * WINDOW_BLOCK + t) // 8, lane t % 8
    storing limb pair t % 8 of each coordinate; a group past the end loads
    the last proof (a row that exists) and stores nothing; every word of
    every proof stored once."""
    for batch in (1, 3, 8, 9, 1820):
        grid = MK.window_grid(batch)
        thread = torch.arange(grid * MK.WINDOW_BLOCK)
        group, lane = thread // MK.WINDOW_GROUP, thread % MK.WINDOW_GROUP
        live = group < batch
        loaded = torch.where(live, group, batch - 1)
        assert bool((loaded < batch).all()) and bool((loaded >= 0).all())
        served = (group[live] * NW + lane[live]).sort().values
        assert torch.equal(served, torch.arange(batch * NW))
        assert MK.WINDOW_BLOCK % 32 == 0 and MK.WINDOW_GROUP == 2 * C.DBL_GROUP == NW
