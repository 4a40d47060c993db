"""The plain reference of the aggregation cells: the python-int succinct
verifier of an aggregation snark (a frozen copy of the repository's host
verifier, in this package), which returns two KZG accumulators, the fresh
one of the outer proof and the one decoded from its instance limbs, and the
host pairing of each.  A proof is accepted when its succinct verify passes
and both accumulators decide True.

    python3 -m benchmark.reference.aggregation --answers benchmark/data/aggregation_k20_8.json --procs 4

works out the answers of every input of a data file and writes them into it
(offline, on a CPU, once when the file is made).

Nothing here imports torch, JAX or the program under test.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from benchmark.data import corrupt
from benchmark.reference.loader import EcPoint
from benchmark.reference.loader.native import NativeLoader
from benchmark.reference.pcs.kzg import KzgGwc
from benchmark.reference.pcs.kzg.accumulator import KzgAccumulator, LimbsEncoding
from benchmark.reference.plonk import TRANSCRIPTS, Circuit, pairing_value, point
from benchmark.reference.util import bn254
from benchmark.reference.verifier.plonk import PlonkSuccinctVerifier
from benchmark.reference.verifier.plonk.serialization import protocol_from_json

class UncheckedLimbsEncoding(LimbsEncoding):
    """The control's decode: the 16 limbs taken as two points, on the curve
    or not."""

    @classmethod
    def from_repr(cls, scalars):
        def fe(limbs):
            return sum(limb.value << (cls.bits * i) for i, limb in enumerate(limbs)) % bn254.P

        loader = scalars[0].loader
        coords = [fe(scalars[i * cls.limbs : (i + 1) * cls.limbs]) for i in range(4)]
        return KzgAccumulator(EcPoint(loader, tuple(coords[:2])), EcPoint(loader, tuple(coords[2:])))


def load_circuit(data: dict) -> Circuit:
    """The outer circuit and its deciding key from the data file's dict."""
    dk = data["dk"]
    return Circuit(protocol_from_json(data["protocol"]), point(dk["svk"]), point(dk["g2"]), point(dk["s_g2"]),
                   "poseidon")


def instances_of(limbs_hex) -> list:
    """The data file's 16 hex instance limbs -> the verifier's one column."""
    return [[int(v, 16) for v in limbs_hex]]


def inputs(data: dict, config: dict) -> dict:
    """Every input of the data file by name, as (proof bytes, instances):
    ``good.<i>`` the file's proofs; ``out_of_range.<i>`` and
    ``limb_flip.<i>`` proof i with the configuration's corruption of that
    kind; ``bad_inner`` the valid outer proof of a bad inner snark;
    ``probe.<i>`` proof i with proof i + 1's instances."""
    proofs = [bytes.fromhex(p) for p in data["proofs"]]
    ins = [instances_of(v) for v in data["instances"]]
    n = len(proofs)
    out = {f"good.{i}": (proofs[i], ins[i]) for i in range(n)}
    for c in config["corruptions"]:
        if c["kind"] == "compressed":
            for i in range(n):
                out[f"out_of_range.{i}"] = (corrupt.compressed(proofs[i], c["offset"], c["out_of_range"]), ins[i])
        elif c["kind"] == "instance_limb_flip":
            for i in range(n):
                bad = [list(ins[i][0])]
                bad[0][c["limb"]] ^= c["mask"]
                out[f"limb_flip.{i}"] = (proofs[i], bad)
        elif c["kind"] == "bad_inner":
            out["bad_inner"] = (bytes.fromhex(data["bad_inner"]["proof"]), instances_of(data["bad_inner"]["instances"]))
        else:
            raise ValueError(f"unknown corruption kind {c['kind']!r}")
    for i in range(n):
        out[f"probe.{i}"] = (proofs[i], ins[(i + 1) % n])
    return out


def succinct(circuit: Circuit, proof: bytes, instances, checked: bool = True):
    """(ok, accumulators): the succinct verify of one outer proof, and its
    two accumulators as ((lhs), (rhs)) affine int pairs, the fresh one
    first, then the one decoded from the instance limbs; ``ok`` False, and
    no accumulator, when the proof cannot be read, a check fails or the
    limbs decode off the curve.  ``checked`` False decodes the limbs
    without the on-curve check (the control)."""
    loader = NativeLoader()
    verifier = PlonkSuccinctVerifier(KzgGwc, LimbsEncoding if checked else UncheckedLimbsEncoding)
    try:
        loaded = circuit.protocol.loaded(loader)
        ins = [[loader.load_const(v) for v in col] for col in instances]
        transcript = TRANSCRIPTS[circuit.transcript](proof, loader)
        parsed = verifier.read_proof(circuit.svk, loaded, ins, transcript)
        fresh, old = verifier.verify(circuit.svk, loaded, ins, parsed)
    except Exception:  # every failure of the python-int verifier is a rejection
        return False, None
    return True, [(acc.lhs.value, acc.rhs.value) for acc in (fresh, old)]


def decides(circuit: Circuit, acc) -> bool:
    """e(lhs, g2) e(rhs, -s g2) == 1."""
    return pairing_value(circuit, *acc) == bn254.FQ12_ONE


def answer(circuit: Circuit, proof: bytes, instances) -> dict:
    """The reference's answer for one input: ``ok`` (succinct verify and
    both decides), the succinct verify's ``succinct``, both accumulators as
    hex (lhs x, lhs y, rhs x, rhs y) and each one's decide."""
    ok, accs = succinct(circuit, proof, instances)
    if not ok:
        return {"ok": False, "succinct": False, "accumulators": None, "decides": None}
    dec = [decides(circuit, acc) for acc in accs]
    return {"ok": all(dec), "succinct": True, "accumulators": [[hex(v) for v in (*lhs, *rhs)] for lhs, rhs in accs],
            "decides": dec}


_STATE = {}


def _answer(args):
    path, config, name = args
    if "circuit" not in _STATE:
        data = json.loads(Path(path).read_text())
        _STATE["circuit"], _STATE["inputs"] = load_circuit(data), inputs(data, config)
    return name, answer(_STATE["circuit"], *_STATE["inputs"][name])


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--answers", required=True, help="the data file to complete")
    ap.add_argument("--config", default=str(Path(__file__).resolve().parents[1] / "configs" / "aggregation_k20_poseidon.json"))
    ap.add_argument("--procs", type=int, default=4)
    args = ap.parse_args(argv)
    config = json.loads(Path(args.config).read_text())
    data = json.loads(Path(args.answers).read_text())
    names = list(inputs(data, config))
    with ProcessPoolExecutor(args.procs, mp_context=multiprocessing.get_context("spawn")) as pool:
        data["answers"] = dict(pool.map(_answer, [(args.answers, config, n) for n in names]))
    Path(args.answers).write_text(json.dumps(data))
    for name, a in data["answers"].items():
        print(f"{name}: ok {a['ok']}, decides {a['decides']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
