"""An aggregation snark: a Halo2 PLONK circuit on KZG (GWC19) over BN254,
proved on the Poseidon transcript, whose instances carry the folded KZG
accumulator of the snarks it aggregated as 16 limbs (``LimbsEncoding<4,
68>``).  Its verifier decodes that accumulator (on the curve, or the proof
is rejected), runs the succinct verify of the outer proof, and decides both
accumulators per proof: a proof is accepted only if both pairings hold.

The program under test: ``parallel.batch.pack_proofs``/``pack_instances``
and the function from ``build_verifier(..., decide_dk=...)`` on the Poseidon
transcript, with ``MEGA`` at its default; its ``ok`` is the verdict, and it
gives both accumulators as (2, B, 16) limbs, the fresh one first.

The data file holds the outer proofs (distinct, each with its own 16
instances), the valid outer proof of a bad inner snark, and the reference's
answer for every input the configuration's corruptions make of them
(``benchmark.reference.aggregation.inputs``).  After the window the
reference works out again a sample of the answers drawn from the seed, and
judges every row: its ``ok``, and both accumulators limb for limb wherever
the reference's succinct verify passes.
"""

from __future__ import annotations

import json
import time

import numpy as np

from benchmark.harness.limbs import NLIMB, limbs
from benchmark.harness.registry import BENCH_DIR
from benchmark.harness.rows import rng
from benchmark.reference import aggregation as ref
from benchmark.reference.plonk import point
from benchmark.systems import plonk_kzg
from benchmark.systems.plonk_kzg import COORDS

KINDS = ("out_of_range", "limb_flip", "bad_inner")  # the bad rows, one input of each kind
LIVE_INPUTS = 8  # inputs the reference works out again in each run
LIVE_PAIRINGS = 2  # of which both pairings too


def _acc_limbs(answer) -> np.ndarray:
    """An answer's two accumulators -> (2, 4, 16) limbs."""
    return limbs([int(v, 16) for acc in answer["accumulators"] for v in acc]).reshape(2, 4, NLIMB)


class Inputs:
    """The circuit, the distinct inputs of the traffic and the reference's
    answers.  Inputs are (proof bytes, instances) by id: the data file's
    proofs (good), one input of each bad kind, each of its own proof drawn
    from the seed (bad), and the probe's input last (a seeded proof with the
    next proof's instances: it passes the succinct verify and its fresh
    accumulator does not decide)."""

    def __init__(self, config: dict, seed: int):
        data = json.loads((BENCH_DIR / config["data"]).read_text())
        self.data = data
        self.circuit = ref.load_circuit(data)
        named = ref.inputs(data, config)
        n = len(data["proofs"])
        j_a, j_b, j_p = (int(v) for v in rng(seed, 4).integers(n, size=3))
        self.names = [f"good.{i}" for i in range(n)] + [f"out_of_range.{j_a}", f"limb_flip.{j_b}", "bad_inner",
                                                         f"probe.{j_p}"]
        self.items = [named[name] for name in self.names]
        self.good = list(range(n))
        self.bad = list(range(n, n + len(KINDS)))
        self.probe = n + len(KINDS)
        self.answers = [data["answers"][name] for name in self.names]
        if not all(self.answers[i]["ok"] for i in self.good):
            raise ValueError(f"{config['data']}: a proof of the file is not accepted")
        bad_inner = self.bad[KINDS.index("bad_inner")]
        if any(self.answers[i]["ok"] for i in self.bad) or self.answers[bad_inner]["decides"] != [True, False]:
            raise ValueError(f"{config['data']}: a bad input is accepted, or the bad-inner proof's decides are not "
                             "[True, False]")
        if self.answers[self.probe]["decides"][0]:
            raise ValueError(f"{config['data']}: the probe's fresh accumulator decides True")

    def __getitem__(self, i: int):
        return self.items[i]

    def __len__(self) -> int:
        return len(self.items)

    def table(self):
        """The answers as arrays over ids: ``ok``, whether the succinct
        verify passes, and both accumulators' limbs where it does."""
        ok = np.array([a["ok"] for a in self.answers])
        succ = np.array([a["succinct"] for a in self.answers])
        acc = np.zeros((len(self), 2, 4, NLIMB), dtype=np.int64)
        for i, a in enumerate(self.answers):
            if a["succinct"]:
                acc[i] = _acc_limbs(a)
        return ok, succ, acc

    def relive(self, ids, seed: int) -> None:
        """Works out again, in python ints, the answers of a seeded sample of
        ``ids`` (both pairings for the first that pass the succinct verify);
        a difference from the data file stops the run."""
        sample = rng(seed, 6).permutation(sorted(ids))[:LIVE_INPUTS].tolist()
        pairings = 0
        for i in sample:
            want = self.answers[i]
            ok, accs = ref.succinct(self.circuit, *self[i])
            got = [[hex(v) for v in (*lhs, *rhs)] for lhs, rhs in accs] if ok else None
            if ok != want["succinct"] or got != want["accumulators"]:
                raise RuntimeError(f"the data file's answer for {self.names[i]} is not the reference's")
            if ok and pairings < LIVE_PAIRINGS:
                pairings += 1
                if [ref.decides(self.circuit, acc) for acc in accs] != want["decides"]:
                    raise RuntimeError(f"the data file's decides for {self.names[i]} are not the reference's")


class Session(plonk_kzg.Session):
    """The program built for the configuration, the distinct inputs, and the
    outputs of the window's batches (kept on the device until the window
    has closed).  ``sync``, ``forget`` and ``probe`` (one batch of the
    cell's shape after the window, one row the probe's input) are the PLONK
    system's."""

    def __init__(self, config: dict, mix: dict, seed: int, device, torch_mod):
        self.torch, self.device = torch_mod, device
        self.config, self.seed = config, seed
        self.inputs = Inputs(config, seed)
        self.good, self.bad = self.inputs.good, self.inputs.bad
        from snark_verifier_tpu_torch.parallel.batch import build_verifier, pack_instances, pack_proofs
        from snark_verifier_tpu_torch.pcs.kzg import KzgDecidingKey, KzgGwc
        from snark_verifier_tpu_torch.verifier.plonk.serialization import protocol_from_json

        dk = self.inputs.data["dk"]
        svk, g2, s_g2 = (point(dk[k]) for k in ("svk", "g2", "s_g2"))
        protocol = protocol_from_json(self.inputs.data["protocol"])
        self.pack_proofs, self.pack_instances = pack_proofs, pack_instances
        self.verify = build_verifier(protocol, KzgGwc, svk, device=device, decide_dk=KzgDecidingKey(svk, g2, s_g2),
                                     transcript_kind="poseidon")
        self.kept = []
        self.probe_at = None

    def batch(self, rows: np.ndarray, span) -> dict:
        """Pack, verify with the per-proof decide of both accumulators; the
        verdicts reach the host.  Returns each phase's end (host clock)."""
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
        with span("verdicts"):
            out["ok"].cpu()
        marks["verdicts"] = now()
        self.kept.append((rows, *(out[k] for k in COORDS), out["ok"]))
        return marks

    def release(self) -> dict:
        """Move the outputs to the host and free the program's state."""
        cols = list(zip(*self.kept))
        self.kept = []
        # each batch's coordinates (2, B, 16) -> (B, 2, 4, 16)
        acc = [np.stack([c.cpu().numpy() for c in batch], axis=2).transpose(1, 0, 2, 3) for batch in zip(*cols[1:5])]
        self.host = {"rows": [np.asarray(r) for r in cols[0]], "acc": np.concatenate(acc),
                     "ok": np.concatenate([o.cpu().numpy() for o in cols[5]])}
        self.verify = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
        return self.host

    def check(self) -> dict:
        """The numbers compared, each with its limit: rows whose ``ok``
        differs from the reference's, or whose fresh or decoded accumulator
        differs where the reference's succinct verify passes; and whether
        the probe's row was accepted."""
        h, inp = self.host, self.inputs
        rows = np.concatenate(h["rows"])
        inp.relive({int(i) for i in rows}, self.seed)
        want_ok, want_succ, want_acc = inp.table()
        wrong = (h["ok"] != want_ok[rows]) | (want_succ[rows] & (h["acc"] != want_acc[rows]).any(axis=(1, 2, 3)))
        probe_accepted = 0
        if self.probe_at is not None:
            at = sum(len(r) for r in h["rows"][: self.probe_at])
            batch_rows = h["rows"][self.probe_at]
            probe_accepted = int(h["ok"][at + int(np.flatnonzero(batch_rows == inp.probe)[0])])
        return {"rows_wrong": (int(wrong.sum()), 0), "probe_accepted": (probe_accepted, 0)}


class Control(Session):
    """The control: the reference in the program's place with one guarantee
    broken, the accumulator decoded from the instances neither checked on
    the curve nor decided, so a row is ``ok`` when its succinct verify
    passes and its fresh accumulator decides."""

    def __init__(self, config: dict, mix: dict, seed: int, device, torch_mod):
        self.torch, self.device = torch_mod, device
        self.config, self.seed = config, seed
        self.inputs = Inputs(config, seed)
        self.good, self.bad = self.inputs.good, self.inputs.bad
        self.memo = {}
        self.kept = []
        self.probe_at = None

    def _row(self, i: int):
        if i not in self.memo:
            circuit = self.inputs.circuit
            ok, accs = ref.succinct(circuit, *self.inputs[i], checked=False)
            acc = np.zeros((2, 4, NLIMB), dtype=np.int64)
            if ok:
                ok = ref.decides(circuit, accs[0])
                acc = limbs([v for lhs, rhs in accs for v in (*lhs, *rhs)]).reshape(2, 4, NLIMB)
            self.memo[i] = (ok, acc)
        return self.memo[i]

    def batch(self, rows: np.ndarray, span) -> dict:
        out = [self._row(int(i)) for i in rows]
        self.kept.append((rows, np.stack([a for _, a in out]), np.array([ok for ok, _ in out])))
        t = time.perf_counter()
        return {"pack": t, "verify": t, "verdicts": t}

    def release(self) -> dict:
        cols = list(zip(*self.kept))
        self.kept = []
        self.host = {"rows": [np.asarray(r) for r in cols[0]], "acc": np.concatenate(cols[1]),
                     "ok": np.concatenate(cols[2])}
        return self.host
