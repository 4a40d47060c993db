"""Poseidon permutation & sponge over BN254 Fr (host oracle).

Role of the external `poseidon` crate + util/hash/poseidon.rs in the
reference: the Fiat–Shamir hash for recursion/aggregation, written once and
interpreted by every loader.  The sponge semantics replicate
util/hash/poseidon.rs:151-202 exactly:

* `update` buffers elements; `squeeze` absorbs the buffer in RATE-chunks via
  `permutation(chunk)`, runs one extra empty permutation when the buffer
  length is a multiple of RATE (including zero), and returns state word 1;
* absorption adds inputs into state words 1.. during the first round's
  constant addition, with a +1 padding added to the first unused word
  (absorb_with_pre_constants, poseidon.rs:45-74).

Round constants and the MDS matrix are generated by a Grain LFSR following
the published halo2_gadgets/poseidon-crate construction.  CAVEAT: the PSE
`poseidon` crate's exact constants cannot be cross-validated in this
environment (no Rust toolchain); `PoseidonSpec.from_constants` imports an
externally dumped (round_constants, mds) pair for bit-exact interop with
reference-produced proofs.  All in-repo tests are self-consistent across the
native/JAX backends.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference.util import bn254

R = bn254.R


class _Grain:
    """Grain LFSR bit stream (Poseidon paper appendix / halo2_gadgets)."""

    def __init__(self, t: int, r_f: int, r_p: int, n_bits: int = 254):
        bits = []

        def add(value, width):
            bits.extend([(value >> (width - 1 - i)) & 1 for i in range(width)])

        add(1, 2)  # field type: GF(p)
        add(0, 4)  # sbox: x^alpha
        add(n_bits, 12)
        add(t, 12)
        add(r_f, 10)
        add(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        self.n_bits = n_bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_bit(self) -> int:
        # von-Neumann-style filtering: emit the bit following a 1
        while True:
            if self._next_raw() == 1:
                return self._next_raw()

    def next_field_element(self) -> int:
        """Rejection-sampled canonical element (round constants)."""
        while True:
            v = 0
            for _ in range(self.n_bits):
                v = (v << 1) | self.next_bit()
            if v < R:
                return v

    def next_field_element_without_rejection(self) -> int:
        """Uniform-ish element by modular reduction (MDS generation)."""
        v = 0
        for _ in range(self.n_bits):
            v = (v << 1) | self.next_bit()
        return v % R


@dataclass
class PoseidonSpec:
    t: int
    rate: int
    r_f: int
    r_p: int
    round_constants: list  # (r_f + r_p) rows of t ints
    mds: list  # t x t ints

    @staticmethod
    def generate(t: int = 5, rate: int = 4, r_f: int = 8, r_p: int = 60) -> "PoseidonSpec":
        grain = _Grain(t, r_f, r_p)
        rounds = r_f + r_p
        constants = [
            [grain.next_field_element() for _ in range(t)] for _ in range(rounds)
        ]
        while True:
            xs = [grain.next_field_element_without_rejection() for _ in range(t)]
            ys = [grain.next_field_element_without_rejection() for _ in range(t)]
            try:
                mds = [
                    [bn254.inv_mod((xs[i] + ys[j]) % R, R) for j in range(t)]
                    for i in range(t)
                ]
                break
            except ZeroDivisionError:
                continue
        return PoseidonSpec(t, rate, r_f, r_p, constants, mds)

    @staticmethod
    def from_constants(t, rate, r_f, r_p, round_constants, mds) -> "PoseidonSpec":
        """Import externally generated constants (e.g. dumped from the PSE
        poseidon crate) for bit-exact reference interop."""
        return PoseidonSpec(t, rate, r_f, r_p, round_constants, mds)


_SPEC_CACHE: dict = {}


def default_spec() -> PoseidonSpec:
    """The SDK's singleton spec: T=5, RATE=4, R_F=8, R_P=60
    (snark-verifier-sdk/src/halo2.rs:53-73)."""
    key = (5, 4, 8, 60)
    if key not in _SPEC_CACHE:
        _SPEC_CACHE[key] = PoseidonSpec.generate(*key)
    return _SPEC_CACHE[key]


def permutation(spec: PoseidonSpec, state: list, inputs: list) -> list:
    """One sponge step: absorb `inputs` (len < t) and permute.

    Standard (unoptimized) Poseidon round sequence with raw constants —
    mathematically the permutation the reference evaluates through its
    optimized sparse-matrix form (util/hash/poseidon.rs:171-202).
    """
    t, r_f, r_p = spec.t, spec.r_f, spec.r_p
    assert len(inputs) < t
    state = list(state)

    # absorb with round-0 pre-constants + padding (poseidon.rs:45-74)
    c0 = spec.round_constants[0]
    state[0] = (state[0] + c0[0]) % R
    for i, inp in enumerate(inputs):
        state[1 + i] = (state[1 + i] + inp + c0[1 + i]) % R
    for idx, j in enumerate(range(1 + len(inputs), t)):
        pad = 1 if idx == 0 else 0
        state[j] = (state[j] + c0[j] + pad) % R

    half = r_f // 2
    for rnd in range(1, r_f + r_p + 1):
        # sbox of the (rnd-1)-th round
        prev_full = (rnd - 1) < half or (rnd - 1) >= half + r_p
        if prev_full:
            state = [pow(s, 5, R) for s in state]
        else:
            state[0] = pow(state[0], 5, R)
        # mds
        state = [
            sum(spec.mds[i][j] * state[j] for j in range(t)) % R for i in range(t)
        ]
        # next round's ARK (full t-vector every round in the raw form;
        # none after the final round)
        if rnd < r_f + r_p:
            c = spec.round_constants[rnd]
            state = [(s + cc) % R for s, cc in zip(state, c)]
    return state


class PoseidonSponge:
    """Buffered sponge (util/hash/poseidon.rs:115-169 semantics)."""

    def __init__(self, spec: PoseidonSpec | None = None):
        self.spec = spec or default_spec()
        self.state = [0] * self.spec.t
        self.buf: list = []

    def update(self, elements):
        self.buf.extend(elements)

    def squeeze(self) -> int:
        buf, self.buf = self.buf, []
        exact = len(buf) % self.spec.rate == 0
        for off in range(0, len(buf), self.spec.rate):
            self.state = permutation(self.spec, self.state, buf[off : off + self.spec.rate])
        if exact:
            self.state = permutation(self.spec, self.state, [])
        return self.state[1]
