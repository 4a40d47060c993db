#!/usr/bin/env python3
"""Works out the reference's answers for every proof of a data file and
writes them into it: each proof's KZG accumulator (lhs, rhs, as hex) and
whether it decides True.  Offline, on a CPU, once when a data file is made;
a run of the benchmark works out again a sample of them drawn from its seed.

    python3 benchmark/data/answers.py benchmark/data/standard_plonk_k8_1820.json --procs 6
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.reference import plonk as ref  # noqa: E402
from benchmark.reference.util import bn254  # noqa: E402

_CIRCUIT = {}


def _answer(args):
    path, transcript, proof_hex, instance = args
    if transcript not in _CIRCUIT:
        _CIRCUIT[transcript] = ref.load_circuit(json.loads(Path(path).read_text()), transcript)
    circuit = _CIRCUIT[transcript]
    ok, lhs, rhs = ref.succinct(circuit, bytes.fromhex(proof_hex), [[instance]])
    if not ok:
        return None, False
    return [hex(v) for v in (*lhs, *rhs)], ref.pairing_value(circuit, lhs, rhs) == bn254.FQ12_ONE


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--procs", type=int, default=4)
    args = ap.parse_args(argv)
    data = json.loads(Path(args.path).read_text())
    with ProcessPoolExecutor(args.procs) as pool:
        for transcript in ("evm", "poseidon"):
            part = data[transcript]
            jobs = [(args.path, transcript, p, v) for p, v in zip(part["proofs"], part["instances"])]
            answers = list(pool.map(_answer, jobs, chunksize=16))
            part["accumulators"] = [acc for acc, _ in answers]
            part["decides"] = [decides for _, decides in answers]
            print(f"{transcript}: {sum(part['decides'])} of {len(answers)} decide True", file=sys.stderr)
    Path(args.path).write_text(json.dumps(data))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
