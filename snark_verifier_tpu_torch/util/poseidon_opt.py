"""Optimized Poseidon: pre-sparse MDS + per-partial-round sparse matrices.

The evaluation form the reference uses (util/hash/poseidon.rs:35-110 via
the PSE `poseidon` crate's Spec): partial rounds apply a SPARSE matrix
(t + (t-1) muls instead of t^2) and carry a single post-sbox scalar
constant, with one dense "pre-sparse" MDS at the full/partial boundary.
This is the row-cost-relevant form for the in-circuit transcript.

Derivation (Poseidon paper, appendix B "optimized implementation"):

* Matrix factorization: a dense M factors as M = S @ B with
  S = [[m00, row], [col, I]] (sparse) and B = [[1, 0], [0, Bhat]].  B
  commutes with the partial sbox (first row/col are unit vectors), so the
  dense tails migrate leftward through the partial rounds:
      (M sbox_p)^rp (M .) == (S_{rp-1} sbox_p) ... (S_0 sbox_p) (P .)
  built by the recursion  acc<-M;  S_i, B <- factor(acc);  acc <- B @ M.

* Constants: rather than hand-deriving the backward constant propagation
  through the factorized matrices, the equivalent constants are SOLVED
  for: both schedules are evaluated symbolically in lockstep (each sbox
  output becomes a fresh variable; everything between sboxes is affine),
  equating full states at full-round sboxes and element 0 at partial
  sboxes.  The optimized schedule's constants appear linearly; the
  resulting system is solved by Gaussian elimination mod r.  The x/y
  variable coefficients must match identically (asserted) — that check is
  exactly the matrix-factorization correctness proof.

Bit-equality with the raw permutation is pinned by tests/test_poseidon.py.
"""

from __future__ import annotations

from dataclasses import dataclass

from snark_verifier_tpu_torch.util import bn254
from snark_verifier_tpu_torch.util.poseidon import PoseidonSpec

R = bn254.R


# ---------------------------------------------------------------------------
# matrix helpers (small t x t, python ints mod R)
# ---------------------------------------------------------------------------


def _mat_mul(a, b):
    n, m, k = len(a), len(b[0]), len(b)
    return [
        [sum(a[i][l] * b[l][j] for l in range(k)) % R for j in range(m)]
        for i in range(n)
    ]


def _mat_vec(a, v):
    return [sum(a[i][j] * v[j] for j in range(len(v))) % R for i in range(len(a))]


def _mat_inv(a):
    n = len(a)
    aug = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(a)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % R)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = bn254.inv_mod(aug[col][col], R)
        aug[col] = [x * inv % R for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(x - f * y) % R for x, y in zip(aug[r], aug[col])]
    return [row[n:] for row in aug]


def _factor(a):
    """a = S @ B; S = [[a00, arow @ ahat^-1], [acol, I]], B = [[1,0],[0,ahat]]."""
    t = len(a)
    ahat = [row[1:] for row in a[1:]]
    ahat_inv = _mat_inv(ahat)
    arow = a[0][1:]
    srow = [
        sum(arow[l] * ahat_inv[l][j] for l in range(t - 1)) % R for j in range(t - 1)
    ]
    s = [[a[0][0]] + srow]
    for i in range(1, t):
        s.append([a[i][0]] + [int(i - 1 == j) for j in range(t - 1)])
    b = [[1] + [0] * (t - 1)]
    for i in range(1, t):
        b.append([0] + ahat[i - 1])
    return s, b


# ---------------------------------------------------------------------------
# the optimized spec
# ---------------------------------------------------------------------------


@dataclass
class OptimizedPoseidonSpec:
    t: int
    rate: int
    r_f: int
    r_p: int
    mds: list  # dense t x t
    pre_sparse_mds: list  # dense t x t, applied at the full->partial boundary
    sparse: list  # r_p of (row: t ints, col_hat: t-1 ints)
    constants_start: list  # r_f/2 + 1 rows of t (row 0 = absorb constants)
    constants_partial: list  # r_p scalars (post-sbox on element 0)
    constants_end: list  # r_f/2 - 1 rows of t

    def apply_sparse(self, idx, state):
        """state' = Sigma_idx @ state (poseidon.rs:89-110 apply_sparse_mds)."""
        row, col_hat = self.sparse[idx]
        s0 = sum(r * s for r, s in zip(row, state)) % R
        return [s0] + [(c * state[0] + s) % R for c, s in zip(col_hat, state[1:])]


_OPT_CACHE: dict = {}


def optimize_spec(spec: PoseidonSpec) -> OptimizedPoseidonSpec:
    key = id(spec)
    if key in _OPT_CACHE:
        return _OPT_CACHE[key]

    t, r_f, r_p = spec.t, spec.r_f, spec.r_p
    half = r_f // 2
    M = spec.mds
    C = spec.round_constants

    # ---- matrix recursion ----------------------------------------------------
    sigmas = [None] * r_p
    acc = M
    for j in range(r_p):
        s, b = _factor(acc)
        sigmas[r_p - 1 - j] = s
        acc = _mat_mul(b, M)
    P = acc

    # ---- symbolic lockstep constant solve -------------------------------------
    # state component = dict {key: coeff}; keys ("x",i) input, ("y",k) sbox
    # output, ("u",j) unknown constant, "1" known constant
    unknowns: list = []

    def new_unknowns(n):
        base = len(unknowns)
        unknowns.extend(range(base, base + n))
        return list(range(base, base + n))

    u_start = [new_unknowns(t) for _ in range(half)]  # S_1..S_half
    u_partial = [new_unknowns(1)[0] for _ in range(r_p)]
    u_end = [new_unknowns(t) for _ in range(half - 1)]

    equations: list = []  # (coeff dict over unknowns, rhs)
    fresh_counter = [0]

    def d_add(a, b, scale=1):
        out = dict(a)
        for k, v in b.items():
            out[k] = (out.get(k, 0) + scale * v) % R
        return {k: v for k, v in out.items() if v}

    def d_scale(a, c):
        return {k: v * c % R for k, v in a.items() if v * c % R}

    def _row_apply(row, comps):
        out: dict = {}
        for c, comp in enumerate(comps):
            if row[c] == 0:
                continue
            for k, v in comp.items():
                out[k] = (out.get(k, 0) + row[c] * v) % R
        return {k: v for k, v in out.items() if v}

    def equate(vc, wc):
        diff = d_add(vc, wc, scale=-1)
        coeffs = {}
        const = 0
        for k, v in diff.items():
            if isinstance(k, tuple) and k[0] == "u":
                coeffs[k[1]] = (-v) % R  # move unknowns to the LHS
            elif k == "1":
                const = v
            else:
                raise AssertionError(f"schedule mismatch on variable {k}: {v}")
        equations.append((coeffs, const))

    def fresh():
        fresh_counter[0] += 1
        return {("y", fresh_counter[0]): 1}

    def equate_full(v, w):
        ys = []
        for c in range(t):
            equate(v[c], w[c])
            y = fresh()
            ys.append(y)
        return ys

    # initial states (post-absorb): identical, C_0 known in both
    v = [{("x", i): 1, "1": C[0][i] % R} for i in range(t)]
    w = [dict(comp) for comp in v]

    # full rounds 1..half-1
    for k in range(1, half):
        ys = equate_full(v, w)
        v = [d_add(_row_apply(M[i], ys), {"1": C[k][i] % R}) for i in range(t)]
        su = [{("u", u): 1} for u in u_start[k - 1]]
        w = [d_add(_row_apply(M[i], ys), _row_apply(M[i], su)) for i in range(t)]

    # round `half`: raw M + C_half; optimized pre-sparse P + P@S_half
    ys = equate_full(v, w)
    v = [d_add(_row_apply(M[i], ys), {"1": C[half][i] % R}) for i in range(t)]
    su = [{("u", u): 1} for u in u_start[half - 1]]
    w = [d_add(_row_apply(P[i], ys), _row_apply(P[i], su)) for i in range(t)]

    # partial rounds
    for i in range(r_p):
        equate(v[0], w[0])
        y = fresh()
        v_sb = [y] + v[1:]
        w_sb = [d_add(y, {("u", u_partial[i]): 1})] + w[1:]
        nxt = half + i + 1  # raw constant row added after this round's MDS
        v = [
            d_add(_row_apply(M[r], v_sb), {"1": C[nxt][r] % R} if nxt < r_f + r_p else {})
            for r in range(t)
        ]
        w = [_row_apply(sigmas[i][r], w_sb) for r in range(t)]

    # end full rounds
    for j in range(half):
        ys = equate_full(v, w)
        nxt = half + r_p + j + 1
        v = [
            d_add(_row_apply(M[i], ys), {"1": C[nxt][i] % R} if nxt < r_f + r_p else {})
            for i in range(t)
        ]
        if j < half - 1:
            su = [{("u", u): 1} for u in u_end[j]]
            w = [d_add(_row_apply(M[i], ys), _row_apply(M[i], su)) for i in range(t)]
        else:
            w = [_row_apply(M[i], ys) for i in range(t)]

    # outputs must match exactly
    for c in range(t):
        equate(v[c], w[c])

    # ---- solve the linear system mod R ----------------------------------------
    n_u = len(unknowns)
    rows = [[eq[0].get(j, 0) for j in range(n_u)] + [eq[1]] for eq in equations]
    sol = [None] * n_u
    r_idx = 0
    for col in range(n_u):
        piv = next((r for r in range(r_idx, len(rows)) if rows[r][col] % R), None)
        assert piv is not None, f"unconstrained optimized constant u{col}"
        rows[r_idx], rows[piv] = rows[piv], rows[r_idx]
        inv = bn254.inv_mod(rows[r_idx][col], R)
        rows[r_idx] = [x * inv % R for x in rows[r_idx]]
        for r in range(len(rows)):
            if r != r_idx and rows[r][col]:
                f = rows[r][col]
                rows[r] = [(x - f * y) % R for x, y in zip(rows[r], rows[r_idx])]
        r_idx += 1
    for r in range(r_idx, len(rows)):
        assert all(x % R == 0 for x in rows[r]), "inconsistent constant system"
    for r in range(r_idx):
        col = next(c for c in range(n_u) if rows[r][c])
        sol[col] = rows[r][n_u]

    def take(us):
        return [sol[u] for u in us]

    opt = OptimizedPoseidonSpec(
        t=t,
        rate=spec.rate,
        r_f=r_f,
        r_p=r_p,
        mds=M,
        pre_sparse_mds=P,
        sparse=[(sigmas[i][0], [sigmas[i][r][0] for r in range(1, t)]) for i in range(r_p)],
        constants_start=[list(C[0])] + [take(u) for u in u_start],
        constants_partial=[sol[u] for u in u_partial],
        constants_end=[take(u) for u in u_end],
    )
    _OPT_CACHE[key] = opt
    return opt


# ---------------------------------------------------------------------------
# optimized permutation (reference poseidon.rs:171-202 schedule)
# ---------------------------------------------------------------------------


def permutation_optimized(opt: OptimizedPoseidonSpec, state, inputs):
    """Bit-identical to util/poseidon.permutation, via the sparse form."""
    t, half = opt.t, opt.r_f // 2
    assert len(inputs) < t
    state = list(state)

    # absorb with start[0] + padding (absorb_with_pre_constants)
    c0 = opt.constants_start[0]
    state[0] = (state[0] + c0[0]) % R
    for i, inp in enumerate(inputs):
        state[1 + i] = (state[1 + i] + inp + c0[1 + i]) % R
    for idx, j in enumerate(range(1 + len(inputs), t)):
        state[j] = (state[j] + c0[j] + (1 if idx == 0 else 0)) % R

    def sbox_full_add(st, consts):
        return [(pow(s, 5, R) + c) % R for s, c in zip(st, consts)]

    def mds(mat, st):
        return [sum(mat[i][j] * st[j] for j in range(t)) % R for i in range(t)]

    for k in range(1, half):
        state = mds(opt.mds, sbox_full_add(state, opt.constants_start[k]))
    state = mds(opt.pre_sparse_mds, sbox_full_add(state, opt.constants_start[half]))

    for i in range(opt.r_p):
        state[0] = (pow(state[0], 5, R) + opt.constants_partial[i]) % R
        state = opt.apply_sparse(i, state)

    for j in range(half - 1):
        state = mds(opt.mds, sbox_full_add(state, opt.constants_end[j]))
    state = mds(opt.mds, [pow(s, 5, R) for s in state])
    return state


def permutation_loader_optimized(opt: OptimizedPoseidonSpec, state, inputs, loader):
    """Loader-generic optimized permutation: the in-circuit Fiat-Shamir form
    (partial rounds cost t + (t-1) small sums instead of t dot-products)."""
    t, half = opt.t, opt.r_f // 2
    assert len(inputs) < t
    state = list(state)

    c0 = opt.constants_start[0]
    state[0] = loader.sum_with_coeff_and_const([(1, state[0])], c0[0])
    for i, inp in enumerate(inputs):
        state[1 + i] = loader.sum_with_coeff_and_const(
            [(1, state[1 + i]), (1, inp)], c0[1 + i]
        )
    for idx, j in enumerate(range(1 + len(inputs), t)):
        state[j] = loader.sum_with_coeff_and_const(
            [(1, state[j])], c0[j] + (1 if idx == 0 else 0)
        )

    def pow5(s):
        s2 = s * s
        return s2 * s2 * s

    def sbox_full_add(st, consts):
        # power5_with_constant (poseidon.rs:29-33)
        return [
            loader.sum_with_coeff_and_const([(1, pow5(s))], c)
            for s, c in zip(st, consts)
        ]

    def mds(mat, st):
        return [
            loader.sum_with_coeff_and_const([(mat[i][j], st[j]) for j in range(t)], 0)
            for i in range(t)
        ]

    for k in range(1, half):
        state = mds(opt.mds, sbox_full_add(state, opt.constants_start[k]))
    state = mds(opt.pre_sparse_mds, sbox_full_add(state, opt.constants_start[half]))

    for i in range(opt.r_p):
        s0 = loader.sum_with_coeff_and_const(
            [(1, pow5(state[0]))], opt.constants_partial[i]
        )
        row, col_hat = opt.sparse[i]
        state = [
            loader.sum_with_coeff_and_const(
                [(row[0], s0)] + [(row[j], state[j]) for j in range(1, t)], 0
            )
        ] + [
            loader.sum_with_coeff_and_const([(c, s0), (1, s)], 0)
            for c, s in zip(col_hat, state[1:])
        ]

    for j in range(half - 1):
        state = mds(opt.mds, sbox_full_add(state, opt.constants_end[j]))
    state = mds(opt.mds, [pow5(s) for s in state])
    return state
