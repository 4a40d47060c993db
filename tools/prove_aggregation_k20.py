#!/usr/bin/env python3
"""Proves the outer proofs of the benchmark's aggregation data file on the
CPU with the repository's host prover, the way examples/aggregation_e2e.py
proves its one outer snark: k=8 inner snarks (GWC, Poseidon transcript) at
instances 1000..1007, each aggregated by the in-circuit verifier into the
k=20 outer circuit, whose 16 instances are the folded accumulator's limbs
(accumulator_indices (0, 0..15)), proved with GWC on the Poseidon transcript.

A ninth input is a valid outer proof of a bad inner snark: the inner proof of
instance 1000 presented with instance 1008.  The outer circuit verifies it
succinctly (the in-circuit verifier runs no pairing), so its outer proof is
sound and its fresh accumulator decides True, while the accumulator it
carries in its instances does not decide.

The script asserts that every synthesized outer protocol equals the first,
so one key proves them all, and that proof 0 is byte-equal to the port's data
file.  It writes the protocol, the deciding key, the proofs and their
instances; `python3 -m benchmark.reference.aggregation --answers <file>`
then adds the reference's answers.  About 40 minutes of CPU at 8 cores:

    python3 tools/prove_aggregation_k20.py benchmark/data/aggregation_k20_8.json --procs 3 --parts <dir>
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

INNER_K = 8
OUTER_SRS_K = 21
GOOD = [1000 + i for i in range(8)]
BAD_INNER = (1000, 1008)  # (instance the inner proof was made for, instance presented)
PORT_DATA = ROOT / "snark_verifier_tpu_torch" / "data" / "aggregation_outer_1snark.json"


def _outer(job):
    """Synthesize, compile and prove one outer snark; returns its protocol
    (JSON), its 16 instances and its proof, kept under ``parts`` so that a
    rerun proves only what is missing."""
    (proved_for, presented), parts = job
    part = Path(parts) / f"outer_{proved_for}_{presented}.json"
    if part.exists():
        return json.loads(part.read_text())
    from snark_verifier_tpu.loader.halo2.builder import CircuitBuilder
    from snark_verifier_tpu.pcs.kzg import KzgGwc
    from snark_verifier_tpu.sdk import gen_proof, gen_snark
    from snark_verifier_tpu.sdk.aggregation import aggregate_in_circuit, aggregate_native
    from snark_verifier_tpu.sdk.halo2 import Snark
    from snark_verifier_tpu.system.halo2.circuits import build_standard_plonk
    from snark_verifier_tpu.system.halo2.srs import gen_srs
    from snark_verifier_tpu.verifier.plonk.serialization import protocol_to_json

    t0 = time.time()
    srs_inner = gen_srs(INNER_K)
    _, pk_inner = build_standard_plonk(INNER_K, srs_inner)
    inner = gen_snark(pk_inner, [[proved_for]], "gwc", cache_name=None, transcript_kind="poseidon")
    snark = Snark(inner.protocol, [[presented]], inner.proof)
    native = aggregate_native(KzgGwc, srs_inner.g[0], [snark])
    builder = CircuitBuilder(range_bits=17)
    builder, exposed = aggregate_in_circuit(KzgGwc, srs_inner.g[0], [snark], as_proof=native.as_proof, builder=builder)
    assert exposed == native.instances, "in-circuit limbs != native pre-pass"
    rows = len(builder.rows)
    srs_outer = gen_srs(max(OUTER_SRS_K, builder.k()))
    protocol, pk = builder.build(srs_outer, name="aggregation-1snark", accumulator_indices=[[(0, i) for i in range(16)]])
    del builder
    t1 = time.time()
    proof = gen_proof(pk, [exposed], "gwc", cache_name=None, transcript_kind="poseidon")
    prove_s = time.time() - t1
    dk = srs_outer.decider_key()
    print(f"inner {proved_for} as {presented}: {rows} rows, k={protocol.domain.k}, "
          f"synth+build {t1 - t0:.1f} s, prove {prove_s:.1f} s", file=sys.stderr, flush=True)
    out = {
        "protocol": protocol_to_json(protocol),
        "instances": [hex(v) for v in exposed],
        "proof": proof.hex(),
        "dk": {
            "svk": [hex(c) for c in dk.svk],
            "g2": [[hex(c) for c in pair] for pair in dk.g2],
            "s_g2": [[hex(c) for c in pair] for pair in dk.s_g2],
        },
        "prove_s": round(prove_s, 1),
        "rows": rows,
    }
    part.write_text(json.dumps(out))
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--procs", type=int, default=1)
    ap.add_argument("--parts", default=None, help="directory for each proof as it is made (default: beside path)")
    args = ap.parse_args(argv)
    parts = Path(args.parts or Path(args.path).parent / "aggregation_parts")
    parts.mkdir(parents=True, exist_ok=True)
    jobs = [(v, v) for v in GOOD] + [BAD_INNER]
    t0 = time.time()
    from snark_verifier_tpu.system.halo2.srs import gen_srs

    gen_srs(OUTER_SRS_K)  # into the cache once, before the workers read it
    with ProcessPoolExecutor(args.procs, mp_context=multiprocessing.get_context("spawn")) as pool:
        outs = list(pool.map(_outer, [(job, str(parts)) for job in jobs]))
    first = outs[0]
    for job, out in zip(jobs, outs):
        assert out["protocol"] == first["protocol"], f"outer protocol of {job} differs: the circuit depends on the witness"
        assert out["dk"] == first["dk"]
    port = json.loads(PORT_DATA.read_text())
    assert first["protocol"] == port["protocol"], "outer protocol differs from the port's data file"
    assert first["proof"] == port["proof"], "proof 0 differs from the port's data file"
    assert first["instances"] == port["instances"]
    good = outs[: len(GOOD)]
    assert len({tuple(o["instances"]) for o in good}) == len(good), "instance vectors repeat"
    data = {
        "inner_k": INNER_K,
        "outer_k": first["protocol"]["domain"]["k"],
        "rows": first["rows"],
        "protocol": first["protocol"],
        "dk": first["dk"],
        "inner_instances": GOOD,
        "proofs": [o["proof"] for o in good],
        "instances": [o["instances"] for o in good],
        "bad_inner": {
            "proved_for": BAD_INNER[0],
            "presented": BAD_INNER[1],
            "proof": outs[-1]["proof"],
            "instances": outs[-1]["instances"],
        },
        "prove_s": [o["prove_s"] for o in outs],
    }
    Path(args.path).write_text(json.dumps(data))
    print(f"wrote {args.path}: {len(good)} proofs + 1 bad-inner proof in {time.time() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
