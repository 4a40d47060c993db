"""A Halo2 PLONK circuit on KZG (GWC19 multi-open) over BN254, its proofs on
the Keccak (EVM) or the Poseidon transcript.

The program under test: ``parallel.batch.pack_proofs``/``pack_instances``,
the function from ``build_verifier`` (the succinct verify of a batch) and
the one from ``build_batch_decider`` (the fold of the batch's accumulators
by two MSMs and one pairing check).  Each batch's fold scalars are drawn on
the device from the seed, and the harness zeroes those of the rows whose
``ok`` is False, so a rejected row does not sink its batch.  A proof's
verdict is its ``ok`` AND its batch's decide.

The data file holds as many distinct proofs as a batch (each with its own
instance) and the reference's answers for them: each proof's accumulator,
and that it decides True, worked out once by ``benchmark/data/answers.py``.
After the window the reference (``benchmark.reference.plonk``) works out
again, in python ints, a sample of those answers drawn from the seed, every
corrupted input the window saw, and the probe's input (a proof with another
proof's instance: it passes the succinct verify and must fail the decide).
It judges every row of every batch: ``ok`` and the accumulator limb for
limb; and every batch's decide, the probe's included.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np

from benchmark.data import corrupt
from benchmark.harness.limbs import NLIMB, ints, limbs
from benchmark.harness.registry import BENCH_DIR
from benchmark.harness.rows import rng
from benchmark.reference import plonk as ref
from benchmark.reference.errors import TranscriptError
from benchmark.reference.loader import EcPoint
from benchmark.reference.system.halo2.transcript import NativeEvmTranscript, NativePoseidonTranscript
from benchmark.reference.util import bn254

COORDS = ("lhs_x", "lhs_y", "rhs_x", "rhs_y")
LIVE_ROWS = 8  # table rows the reference works out again in each run
LIVE_PAIRINGS = 2  # of which the pairing too


def _no_span(name):
    return contextlib.nullcontext()


class Inputs:
    """The circuit, the distinct inputs of the traffic and the reference's
    answers for the good ones.  Inputs are (proof bytes, instances) by id:
    the data file's proofs (good), each corrupted as the configuration says
    (bad), and the probe's input last (the proof of a seeded good id with
    the next proof's instance)."""

    def __init__(self, config: dict, seed: int):
        data = json.loads((BENCH_DIR / config["data"]).read_text())
        part = data[config["transcript"]]
        proofs = [bytes.fromhex(p) for p in part["proofs"]]
        instances = [[[v]] for v in part["instances"]]
        if not all(part["decides"]):
            raise ValueError(f"{config['data']}: a proof of the file does not decide True")
        self.data = data
        self.circuit = ref.load_circuit(data, config["transcript"])
        self.items = list(zip(proofs, instances))
        self.good = list(range(len(proofs)))
        for c in config["corruptions"]:
            for p, ins in zip(proofs, instances):
                bad = corrupt.bit_flip(p, c["offset"], c["mask"]) if c["kind"] == "bit_flip" else \
                    corrupt.compressed(p, c["offset"], c["out_of_range"])
                self.items.append((bad, ins))
        self.bad = list(range(len(proofs), len(self.items)))
        j = int(rng(seed, 4).integers(len(proofs)))
        self.probe = len(self.items)
        self.items.append((proofs[j], instances[(j + 1) % len(proofs)]))
        self.table = limbs([int(v, 16) for acc in part["accumulators"] for v in acc]).reshape(-1, 4, NLIMB)

    def __getitem__(self, i: int):
        return self.items[i]

    def __len__(self) -> int:
        return len(self.items)


class Session:
    """The program built for one configuration, the distinct inputs, and
    the outputs of the window's batches (kept on the device until the window
    has closed)."""

    def __init__(self, config: dict, mix: dict, seed: int, device, torch_mod):
        self.torch, self.device = torch_mod, device
        self.config, self.seed = config, seed
        self.inputs = Inputs(config, seed)
        self.good, self.bad = self.inputs.good, self.inputs.bad
        from snark_verifier_tpu_torch.parallel.batch import build_batch_decider, build_verifier, pack_instances, pack_proofs
        from snark_verifier_tpu_torch.pcs.kzg import KzgDecidingKey, KzgGwc
        from snark_verifier_tpu_torch.verifier.plonk.serialization import protocol_from_json

        data = self.inputs.data
        svk, g2, s_g2 = (ref.point(data[k]) for k in ("svk", "g2", "s_g2"))
        protocol = protocol_from_json(data["protocol"])
        self.pack_proofs, self.pack_instances = pack_proofs, pack_instances
        self.verify = build_verifier(protocol, KzgGwc, svk, device=device, transcript_kind=config["transcript"])
        self.decide = build_batch_decider(KzgDecidingKey(svk, g2, s_g2), device=device)
        self.gen = torch_mod.Generator(device=device)
        self.gen.manual_seed(seed % (1 << 63))
        self.top = bn254.R >> 240  # the fold scalars' top limb stays below r's
        self.kept = []
        self.probe_at = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def fold_scalars(self, batch: int):
        """(batch, 16) canonical Fr limbs drawn on the device: 15 uniform
        16-bit limbs and a top limb below r's."""
        t = self.torch
        low = t.randint(0, 1 << 16, (batch, NLIMB - 1), generator=self.gen, device=self.device, dtype=t.int64)
        top = t.randint(0, self.top, (batch, 1), generator=self.gen, device=self.device, dtype=t.int64)
        return t.cat([low, top], dim=-1)

    def batch(self, rows: np.ndarray, span) -> dict:
        """Pack, verify and decide one batch; the verdicts reach the host.
        Returns each phase's end (host clock)."""
        now = time.perf_counter
        marks = {}
        with span("pack"):
            proof_bytes = self.pack_proofs([self.inputs[i][0] for i in rows], self.device)
            instances = self.pack_instances([self.inputs[i][1] for i in rows], self.device)
        marks["pack"] = now()
        with span("verify"):
            out = self.verify(proof_bytes, instances)
            self.sync()
        marks["verify"] = now()
        with span("decide"):
            fold = self.fold_scalars(len(rows))
            ok = out["ok"]
            decided = self.decide(*(out[k] for k in COORDS), fold * ok.unsqueeze(-1))
            (ok & decided).cpu()  # the verdicts on the host
        marks["decide"] = now()
        self.kept.append((rows, *(out[k] for k in COORDS), ok, fold, decided))
        return marks

    def probe(self, rows: np.ndarray) -> None:
        """After the window: one batch of the cell's shape through the same
        verify and decide, one of its rows the probe's input, whose fold
        scalar is kept, so the batch must decide False."""
        rows = np.array(rows, dtype=np.int64)
        rows[int(rng(self.seed, 5).integers(len(rows)))] = self.inputs.probe
        self.probe_at = len(self.kept)
        self.batch(rows, _no_span)

    def forget(self) -> None:
        self.kept = []

    def release(self) -> dict:
        """Move the outputs to the host and free the program's state."""
        cols = list(zip(*self.kept))
        self.kept = []
        host = {
            "rows": [np.asarray(r) for r in cols[0]],
            "acc": np.concatenate([np.stack([c.cpu().numpy() for c in batch], axis=1) for batch in zip(*cols[1:5])]),
            "ok": np.concatenate([o.cpu().numpy() for o in cols[5]]),
            "fold": np.concatenate([f.cpu().numpy() for f in cols[6]]),
            "decided": np.array([bool(d) for d in cols[7]]),
        }
        self.verify = self.decide = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
        self.host = host
        return host

    def reference(self, ids) -> tuple[np.ndarray, np.ndarray, dict]:
        """The reference's ``ok``, accumulator limbs and pairing values (one
        for a good proof) over all ids: the table's for good ids, a sample of
        which is worked out again (a difference stops the run), and worked
        out here for the other ``ids``."""
        inp, circuit = self.inputs, self.inputs.circuit
        want_ok = np.zeros(len(inp), dtype=bool)
        want_ok[inp.good] = True
        want_acc = np.zeros((len(inp), 4, NLIMB), dtype=np.int64)
        want_acc[inp.good] = inp.table
        values = {i: bn254.FQ12_ONE for i in inp.good}
        gen = rng(self.seed, 6)
        seen_good = sorted(set(ids) & set(inp.good))
        live = gen.permutation(seen_good)[:LIVE_ROWS].tolist()
        for n, i in enumerate(live):
            ok, lhs, rhs = ref.succinct(circuit, *inp[i])
            if not ok or (limbs([lhs[0], lhs[1], rhs[0], rhs[1]]) != inp.table[i]).any():
                raise RuntimeError(f"the data file's answer for proof {i} is not the reference's")
            if n < LIVE_PAIRINGS and ref.pairing_value(circuit, lhs, rhs) != bn254.FQ12_ONE:
                raise RuntimeError(f"proof {i} of the data file does not decide True")
        for i in sorted(set(ids) - set(inp.good)):
            ok, lhs, rhs = ref.succinct(circuit, *inp[i])
            want_ok[i] = ok
            if ok:
                want_acc[i] = limbs([lhs[0], lhs[1], rhs[0], rhs[1]])
                values[i] = ref.pairing_value(circuit, lhs, rhs)
        return want_ok, want_acc, values

    def check(self) -> dict:
        """The numbers compared, each with its limit: rows whose ``ok`` or
        accumulator differs from the reference's, and batches whose decide
        differs from the reference's verdict of the same fold."""
        h = self.host
        rows = np.concatenate(h["rows"])
        want_ok, want_acc, values = self.reference({int(i) for i in rows})
        wrong = (h["ok"] != want_ok[rows]) | (want_ok[rows] & (h["acc"] != want_acc[rows]).any(axis=(1, 2)))
        fold = ints(h["fold"])
        verdicts_wrong, at = 0, 0
        for b, (batch_rows, decided) in enumerate(zip(h["rows"], h["decided"])):
            scalars = {}
            for i, s in zip(batch_rows.tolist(), fold[at : at + len(batch_rows)]):
                if want_ok[i]:
                    scalars[i] = scalars.get(i, 0) + s
            at += len(batch_rows)
            verdict = ref.fold_verdict(values, scalars)
            if b == self.probe_at and verdict:
                raise RuntimeError("the probe's batch decides True in the reference")
            verdicts_wrong += int(bool(decided) != verdict)
        return {"rows_wrong": (int(wrong.sum()), 0), "verdicts_wrong": (verdicts_wrong, 0)}


class UncheckedEvmTranscript(NativeEvmTranscript):
    """The control's Keccak transcript: a point is taken as read, on the
    curve or not."""

    def read_ec_point(self):
        data = self.stream.read(64)
        if len(data) != 64:
            raise TranscriptError("unexpected end of proof stream")
        pt = EcPoint(self._loader, (int.from_bytes(data[:32], "big") % bn254.P,
                                        int.from_bytes(data[32:], "big") % bn254.P))
        self.common_ec_point(pt)
        return pt


class UncheckedPoseidonTranscript(NativePoseidonTranscript):
    """The control's Poseidon transcript: x is taken mod p and y as the
    (p + 1) / 4 power of x^3 + 3, whether or not that is a square root."""

    def read_ec_point(self):
        data = self.stream.read(32)
        if len(data) != 32:
            raise TranscriptError("unexpected end of proof stream")
        raw = bytearray(data)
        parity = raw[31] >> 7
        raw[31] &= 0x7F
        x = int.from_bytes(raw, "little") % bn254.P
        y = pow((pow(x, 3, bn254.P) + bn254.G1_B) % bn254.P, (bn254.P + 1) // 4, bn254.P)
        pt = EcPoint(self._loader, (x, y if y & 1 == parity else bn254.P - y) if any(data) else None)
        self.common_ec_point(pt)
        return pt


UNCHECKED = {"evm": UncheckedEvmTranscript, "poseidon": UncheckedPoseidonTranscript}


class Control(Session):
    """The control: the reference in the program's place with one guarantee
    broken, the proof's points not validated (a point off the curve, or a
    compressed x >= p or without a square root, is taken as read), so every
    row is ``ok`` and a corrupted proof's accumulator enters its batch's
    fold, which the reference decides by two MSMs and one pairing check."""

    def __init__(self, config: dict, mix: dict, seed: int, device, torch_mod):
        self.torch, self.device = torch_mod, device
        self.config, self.seed = config, seed
        self.inputs = Inputs(config, seed)
        self.good, self.bad = self.inputs.good, self.inputs.bad
        self.rng = np.random.default_rng(seed % (1 << 63))
        self.memo = {}
        self.kept = []
        self.probe_at = None

    def _row(self, i: int):
        if i not in self.memo:
            ok, lhs, rhs = ref.succinct(self.inputs.circuit, *self.inputs[i], transcripts=UNCHECKED)
            if not ok:
                raise RuntimeError(f"the control could not verify input {i}")
            self.memo[i] = (lhs, rhs)
        return self.memo[i]

    def batch(self, rows: np.ndarray, span) -> dict:
        accs = [self._row(int(i)) for i in rows]
        fold = self.rng.integers(0, 1 << 16, (len(rows), NLIMB), dtype=np.int64)
        fold[:, -1] %= bn254.R >> 240
        scalars = ints(fold)
        circuit = self.inputs.circuit
        lhs = bn254.g1_msm(scalars, [a[0] for a in accs])
        rhs = bn254.g1_msm(scalars, [a[1] for a in accs])
        decided = bn254.pairing_check([(lhs, circuit.g2), (rhs, bn254.g2_neg(circuit.s_g2))])
        limbed = limbs([v for lhs_i, rhs_i in accs for v in (*lhs_i, *rhs_i)]).reshape(-1, 4, NLIMB)
        self.kept.append((rows, limbed, np.ones(len(rows), dtype=bool), fold, decided))
        t = time.perf_counter()
        return {"pack": t, "verify": t, "decide": t}

    def release(self) -> dict:
        cols = list(zip(*self.kept))
        self.kept = []
        self.host = {"rows": [np.asarray(r) for r in cols[0]], "acc": np.concatenate(cols[1]),
                     "ok": np.concatenate(cols[2]), "fold": np.concatenate(cols[3]), "decided": np.array(cols[4])}
        return self.host
