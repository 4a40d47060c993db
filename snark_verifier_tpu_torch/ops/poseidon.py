"""Batched Poseidon permutation and sponge over int64 limb tensors.

Counterpart of ``snark_verifier_tpu/ops/poseidon.py``: the state is
``(..., t, 16)`` Montgomery Fr limbs, and ``permutation`` gives the same
limbs as the JAX package and the python-int oracle (``util/poseidon.py``).
It is the sparse form of ``util/poseidon_opt.py`` (start full rounds, the
pre-sparse boundary round, partial rounds with a sparse row/column matrix,
end full rounds with a zero-padded last row of constants), about 2.6x fewer
Montgomery products than the raw rounds.

Where the JAX package runs the rounds as ``lax.scan``, ``permutation`` runs
kernel K10 (``csrc/poseidon.cu``) on CUDA tensors: the absorb and all the
rounds in one launch, from one flat table of the constants (``flat_table``).
On CPU tensors it runs ``permutation_plain``, a Python loop over the rounds
whose Montgomery products go through ``field.mont_mul`` and the rest is
plain PyTorch.  The constants are built from the port's copies of
``util/poseidon.py`` and ``util/poseidon_opt.py``, cached as numpy arrays per
spec and copied once to each device that asks for them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from snark_verifier_tpu_torch import _build
from snark_verifier_tpu_torch.config import use_kernel
from snark_verifier_tpu_torch.ops import field as F
from snark_verifier_tpu_torch.ops.field_cuda import _aligned, check_limbs, field_arg, stream_of
from snark_verifier_tpu_torch.ops.limbs import NLIMB, int_to_limbs
from snark_verifier_tpu_torch.util.poseidon_opt import optimize_spec

FR = F.FR
KERNEL_T = 5  # the one state width t that K10 is instantiated for (csrc/poseidon.cu)

_NUMPY_CACHE: dict = {}  # id(spec) -> (spec, numpy arrays)
_DEVICE_CACHE: dict = {}  # (id(spec), device) -> tensors


def _enc(v: int) -> np.ndarray:
    return int_to_limbs(FR.to_mont_int(v))


def _enc_rows(rows) -> np.ndarray:
    return np.array([[_enc(c) for c in row] for row in rows], np.int64)


def _opt_arrays(spec):
    """Sparse-form constants, laid out as the JAX package's ``_opt_tensors``:
    ``c_end`` gains a zero row for the final, constant-free full round."""
    opt = optimize_spec(spec)
    return {
        "c_start": _enc_rows(opt.constants_start),
        "c_partial": np.array([_enc(c) for c in opt.constants_partial], np.int64),
        "c_end": _enc_rows(list(opt.constants_end) + [[0] * opt.t]),
        "mds": _enc_rows(opt.mds),
        "pre_sparse": _enc_rows(opt.pre_sparse_mds),
        "sp_row": _enc_rows(row for row, _ in opt.sparse),
        "sp_col": _enc_rows(col for _, col in opt.sparse),
    }


def spec_arrays(spec) -> dict:
    """The spec's sparse-form constants as numpy int64 limb arrays, built
    once per spec."""
    key = id(spec)
    if key not in _NUMPY_CACHE:
        _NUMPY_CACHE[key] = (spec, _opt_arrays(spec))  # spec kept alive for id()
    return _NUMPY_CACHE[key][1]


def flat_table(spec) -> np.ndarray:
    """K10's constants as one (size, 16) int64 limb array, in the order the
    rounds read them (csrc/poseidon.cu ``table_offsets``): the round-0 and
    r_f / 2 start rows, the dense MDS, the pre-sparse MDS, 2 t elements per
    partial round (its post-S-box constant, its row, its column), the r_f /
    2 end rows."""
    a = spec_arrays(spec)
    partial = np.concatenate([a["c_partial"][:, None], a["sp_row"], a["sp_col"]], axis=1)
    parts = (a["c_start"], a["mds"], a["pre_sparse"], partial, a["c_end"])
    return np.concatenate([x.reshape(-1, NLIMB) for x in parts])


def _tensors(spec, device) -> dict:
    """The spec's constants on ``device``: ``spec_arrays``' arrays and K10's
    ``table``, copied once per spec and device."""
    device = torch.device(device)
    key = (id(spec), device)
    if key not in _DEVICE_CACHE:
        arrays = {**spec_arrays(spec), "table": flat_table(spec)}
        _DEVICE_CACHE[key] = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    return _DEVICE_CACHE[key]


def _absorb(state, inputs, consts):
    """Add the round-0 constants, the inputs to words 1.., and the padding
    one to the word after the last input (absorb_with_pre_constants)."""
    t = state.shape[-2]
    one = F.ones(state.shape[:-2], FR, state.device)
    parts = []
    for i in range(t):
        word = F.add(state[..., i, :], consts[i], FR)
        if 1 <= i < 1 + len(inputs):
            word = F.add(word, inputs[i - 1], FR)
        if i == 1 + len(inputs):
            word = F.add(word, one, FR)
        parts.append(word)
    return torch.stack(torch.broadcast_tensors(*parts), dim=-2)


def _sbox(st):
    s2 = F.mont_mul(st, st, FR)
    s4 = F.mont_mul(s2, s2, FR)
    return F.mont_mul(s4, st, FR)


def _mds_apply(mat, st):
    """out_i = sum_j mat[i][j] * st_j; mat (rows, t, 16), st (..., t, 16)."""
    prod = F.mont_mul(st.unsqueeze(-3), mat, FR)  # (..., rows, t, 16)
    acc = prod[..., 0, :]
    for j in range(1, st.shape[-2]):
        acc = F.add(acc, prod[..., j, :], FR)
    return acc


def permutation_plain(spec, state, inputs):
    """The sparse-form permutation in plain PyTorch, K10's plain version.

    state: (..., t, 16) Montgomery; inputs: list of (..., 16) Montgomery
    scalars (fewer than t).  A partial round is 5 Montgomery products (t =
    5) instead of the raw form's 8."""
    c = _tensors(spec, state.device)
    half = spec.r_f // 2
    st = _absorb(state, inputs, c["c_start"][0])

    def full_round(st, consts, mat):
        return _mds_apply(mat, F.add(_sbox(st), consts, FR))

    # start full rounds (dense MDS), then the boundary round (pre-sparse MDS)
    for k in range(1, half):
        st = full_round(st, c["c_start"][k], c["mds"])
    st = full_round(st, c["c_start"][half], c["pre_sparse"])

    # partial rounds: sbox word 0, add the post-sbox constant, sparse matrix
    for i in range(spec.r_p):
        s0 = F.add(_sbox(st[..., 0, :]), c["c_partial"][i], FR)
        full = torch.cat([s0.unsqueeze(-2), st[..., 1:, :]], dim=-2)
        w0 = _mds_apply(c["sp_row"][i].unsqueeze(0), full)[..., 0, :]  # row . (s0, st_1..)
        rest = F.add(F.mont_mul(c["sp_col"][i], s0.unsqueeze(-2), FR), st[..., 1:, :], FR)  # col_hat_j s0 + st_j
        st = torch.cat([w0.unsqueeze(-2), rest], dim=-2)

    # end full rounds: half - 1 with constants, then one with the zero row
    for k in range(half):
        st = full_round(st, c["c_end"][k], c["mds"])
    return st


def poseidon_perm(spec, state, inputs):
    """K10: the permutation of every row in one launch, on CUDA tensors (a
    row on a group of 8 lanes, lane j holding state word j).

    The batch is the broadcast of the state's and the inputs' batch shapes,
    flattened to rows; the state and the inputs (expanded ones included) are
    copied into contiguous (rows, t, 16) and (rows, n, 16) operands.  Raises
    for a t the kernel is not built for and for n >= t."""
    t, n = spec.t, len(inputs)
    if t != KERNEL_T:
        raise ValueError(f"poseidon_perm: K10 is built for t = {KERNEL_T}, not t = {t}")
    if n >= t:
        raise ValueError(f"poseidon_perm: {n} inputs, at most t - 1 = {t - 1} a permutation")
    check_limbs("poseidon_perm", state, *inputs)
    if state.dim() < 2 or state.shape[-2] != t:
        raise ValueError(f"poseidon_perm: expected a (..., {t}, {NLIMB}) state, got {tuple(state.shape)}")
    batch = torch.broadcast_shapes(state.shape[:-2], *(x.shape[:-1] for x in inputs))
    rows = math.prod(batch)
    st = _aligned(state.expand(*batch, t, NLIMB).reshape(rows, t, NLIMB))
    ins = _aligned(torch.stack([x.expand(*batch, NLIMB) for x in inputs], -2).reshape(rows, n, NLIMB)) if n else None
    table = _tensors(spec, state.device)["table"]
    out = torch.empty(rows, t, NLIMB, dtype=torch.int64, device=state.device)
    with torch.cuda.device(state.device):
        code = _build.library().svtpu_poseidon_perm(
            st.data_ptr(), None if ins is None else ins.data_ptr(), n, table.data_ptr(), table.shape[0],
            out.data_ptr(), rows, t, spec.r_f, spec.r_p, field_arg(FR), stream_of(state))
    _build.check(code, "poseidon_perm")
    if rows:
        poseidon_perm.launches += 1
    return out.reshape(*batch, t, NLIMB)


poseidon_perm.launches = 0


def permutation(spec, state, inputs):
    """The sparse-form permutation: K10 (``poseidon_perm``, one launch) when
    the state and the inputs lie on one CUDA device, ``permutation_plain``
    when they lie on the CPU; raises for mixed devices.  Same limbs either
    way.  ``TorchPoseidonSponge.squeeze`` calls it once per permutation, by
    this module's attribute."""
    if use_kernel(state, *inputs):
        return poseidon_perm(spec, state, inputs)
    return permutation_plain(spec, state, inputs)


class TorchPoseidonSponge:
    """Buffered sponge over (batch..., 16) Montgomery scalars, the semantics
    of the oracle's ``PoseidonSponge`` and the JAX package's
    ``JaxPoseidonSponge``: a squeeze permutes the buffer ``rate`` words at a
    time, one more (empty) permutation when the buffer is a multiple of the
    rate (an empty buffer included), and returns word 1."""

    def __init__(self, spec, batch_shape=(), device="cuda"):
        self.spec = spec
        self.batch_shape = tuple(batch_shape)
        self.state = F.zeros(self.batch_shape + (spec.t,), torch.device(device))
        self.buf = []  # (batch..., 16) Montgomery tensors absorbed since the last squeeze

    def update(self, elements):
        self.buf.extend(elements)

    def squeeze(self):
        buf, self.buf = self.buf, []
        rate = self.spec.rate
        for off in range(0, len(buf), rate):
            self.state = permutation(self.spec, self.state, buf[off : off + rate])
        if len(buf) % rate == 0:
            self.state = permutation(self.spec, self.state, [])
        return self.state[..., 1, :]

