"""The harness's loop on tiny CPU batches: a sound run is correct; the
control, and the program broken underneath, are not; without a card the
command measures nothing; no run loads JAX or the JAX package."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import guard, registry
from benchmark.harness.cell import main, run_cell

SPEC = registry.benchmark_spec()
SEED = 2**31 + 12345


def tiny(name: str, **mix) -> dict:
    """The cell at a size the CPU runs in seconds: batches of 4 rows, half
    of them bad."""
    c = registry.cell(SPEC, name)
    c["mix"] = {**c["mix"], **mix}
    c["mix"]["batch" if "batch" in c["mix"] else "max_batch"] = 4
    c["mix"]["bad_share"] = 0.5
    return c


def run(c, program="Session", seconds=0.0, seed=SEED):
    torch.set_num_threads(2)
    e2e, _ = registry.cell_metrics(SPEC, c["name"])
    return run_cell(c, seed, seconds, False, torch.device("cpu"), time.perf_counter(), e2e, program=program,
                    log=lambda msg: None)


def plonk_fault(kind: str):
    """A Session of the PLONK system whose verify or decide is broken."""
    from benchmark.systems import plonk_kzg

    class Faulty(plonk_kzg.Session):
        def __init__(self, *a):
            super().__init__(*a)
            verify, decide, last = self.verify, self.decide, {}

            def broken_verify(proof_bytes, instances):
                out = verify(proof_bytes, instances)
                if kind == "unchanged":  # returns the previous batch's state
                    prev, last["out"] = last.get("out"), out
                    return prev if prev is not None else out
                if kind == "half":  # the second half of the batch left out, the first half's answers in its place
                    half = len(out["ok"]) // 2
                    return {k: torch.cat([v[:half], v[:half], v[: len(v) - 2 * half]]) for k, v in out.items()}
                if kind == "altered":  # an accepted row's accumulator altered where it is produced
                    out = dict(out)
                    out["lhs_x"] = out["lhs_x"].clone()
                    out["lhs_x"][int(out["ok"].nonzero()[0, 0]), 0] ^= 1
                return out

            def broken_decide(*args):
                ok = decide(*args)
                if kind == "decide_always_true":  # no fold, no pairing
                    return torch.ones_like(ok)
                return ~ok if kind == "decide_altered" else ok

            self.verify, self.decide = broken_verify, broken_decide

    return Faulty


def test_sound_run_is_correct():
    r = run(tiny("keccak_b1820"), seconds=1.0)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {"verified_proofs_per_s", "setup_s"}


def test_poseidon_run_is_correct():
    r = run(tiny("poseidon_b1820"))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["keccak_b1820", "poseidon_b1820"])
def test_control_is_not_correct(name):
    r = run(tiny(name), program="Control", seconds=0.5)
    assert not r["correct"] and r["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "decide_altered", "decide_always_true"])
def test_broken_verify_or_decide_is_not_correct(kind, monkeypatch):
    from benchmark.systems import plonk_kzg

    monkeypatch.setattr(plonk_kzg, "Faulty", plonk_fault(kind), raising=False)
    r = run(tiny("keccak_b1820"), program="Faulty")
    assert not r["correct"], (kind, r["checks"])
    if kind == "decide_always_true":  # only the probe's batch, after the window, must decide False
        assert r["checks"] == {"rows_wrong": {"value": 0, "limit": 0}, "verdicts_wrong": {"value": 1, "limit": 0}}


def test_probe_holds_a_proof_that_fails_only_the_decide():
    from benchmark.reference import plonk as ref
    from benchmark.systems import plonk_kzg

    c = registry.cell(SPEC, "keccak_b1820")["config_data"]
    inputs = plonk_kzg.Inputs(c, SEED)
    ok, lhs, rhs = ref.succinct(inputs.circuit, *inputs[inputs.probe])
    assert ok and ref.pairing_value(inputs.circuit, lhs, rhs) != ref.bn254.FQ12_ONE
    proof, instances = inputs[inputs.probe]
    assert proof in [p for p, _ in inputs.items[: len(inputs.good)]] and (proof, instances) not in inputs.items[:-1]


def test_open_loop_counts_latency_from_due_times():
    c = tiny("keccak_poisson", rate_per_s=2.0)
    r = run(c, seconds=1.0)
    assert r["correct"] and r["metrics"]["verdict_p95_ms"]["value"] > 0


def test_without_a_card_nothing_is_measured(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--workload", "keccak_b1820", "--seed", "1", "--seconds", "1"], time.perf_counter()) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_modules_compare_whole_top_level_names():
    assert guard.forbidden_modules({"snark_verifier_tpu_torch.ops", "jaxtyping", "numpy"}) == []
    assert guard.forbidden_modules({"snark_verifier_tpu.ops.field", "jax.numpy", "flax"}) == [
        "flax", "jax.numpy", "snark_verifier_tpu.ops.field"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch; sys.path.insert(0, '.');"
        "from benchmark.tests.test_bench_harness import run, tiny;"
        "from benchmark.harness import guard;"
        "r = run(tiny('keccak_b1820'));"
        "print(r['correct'], guard.forbidden_modules())"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=registry.REPO_DIR,
                         timeout=600)
    assert out.stdout.split() == ["True", "[]"], out.stderr[-2000:]


@pytest.mark.chip
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_the_card(card, name):
    """One short run of the real cell through the command: correct, with its
    end-to-end metrics."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=registry.REPO_DIR,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_control_on_the_card(card, name):
    """The control through the cell's traffic and check, in batches of 200
    rows (one of them bad) so that a test run holds it; its readings at the
    cell's own size come from ``benchmark/control.py``."""
    c = registry.cell(SPEC, name)
    c["mix"]["batch" if "batch" in c["mix"] else "max_batch"] = 200
    r = run_cell(c, SEED, 0.0, False, card, time.perf_counter(), [], program="Control", log=lambda msg: None)
    assert not r["correct"] and r["checks"]["rows_wrong"]["value"] > 0


def test_traced_run_reads_its_per_layer_metrics():
    """A traced run on the CPU: the traced slice follows the window, the
    metrics' recorders see the program's calls, host-clock and host-counter
    metrics are read, and device metrics (no device here) are left out."""
    c = tiny("keccak_b1820")
    c["trace_batches"] = 1
    _, layer = registry.cell_metrics(SPEC, c["name"])
    r = run_cell(c, SEED, 0.0, True, torch.device("cpu"), time.perf_counter(), layer, log=lambda msg: None)
    assert r["correct"] and r["attempted"] == 4  # the traced slice is not in the window
    assert {"verify.ms_per_batch", "decide.ms_per_batch", "dispatch.aten_ops_per_batch"} == set(r["metrics"])
    assert r["device"]["busy_s"] == 0.0 and r["breakdown"] == {"device_ops": [], "idle_gaps": []}


def test_recorder_ranges_and_wraps_undo():
    import types

    from benchmark.harness.trace import Tracer

    mod = types.SimpleNamespace(f=lambda x: x + 1)
    calls = []

    class Metric:
        @staticmethod
        def install(rec):
            rec.range(mod, "f", "inner")
            rec.wrap(mod, "f", before=lambda x: calls.append(x))

    orig = mod.f
    tracer = Tracer(True, 1, torch, torch.device("cpu"), [Metric])
    tracer.start()
    with tracer.span("batch"):
        assert [mod.f(i) for i in range(3)] == [1, 2, 3]
    tracer.stop()
    assert mod.f is orig and calls == [0, 1, 2]
    t = tracer.summary()
    assert t["batches"] == 1 and t["range_s"]["inner"] > 0 and t["range_s"]["batch"] >= t["range_s"]["inner"]
