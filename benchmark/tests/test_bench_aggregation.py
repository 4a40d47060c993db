"""The aggregation cell's system on tiny CPU batches: a sound run is correct;
the control and the planted faults are not.

The program's outputs are kept per batch of input rows and reused (each run
here has one seed, so the same rows), and each planted fault acts on them:
a per-proof decide that always says True, the decoded accumulator's decide
skipped, and a batch's second half given the first half's answers.  The
outer snark's verify with both pairings takes ~40 s a batch in plain torch
on the CPU, so the program runs once per distinct batch."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import registry
from benchmark.harness.cell import run_cell
from benchmark.reference import aggregation as ref
from benchmark.systems import plonk_kzg_aggregation as agg

SPEC = registry.benchmark_spec()
SEED = 2**31 + 12345
KEPT = {}  # rows -> the program's outputs, with each decide's mask and the succinct ok


def tiny(**mix) -> dict:
    """The cell with batches of 4 rows, half of them bad."""
    c = registry.cell(SPEC, "aggregation_b8")
    c["mix"] = {**c["mix"], "batch": 4, "bad_share": 0.5, **mix}
    return c


def run(c, program="Session", seed=SEED):
    torch.set_num_threads(2)
    e2e, _ = registry.cell_metrics(SPEC, c["name"])
    return run_cell(c, seed, 0.0, False, torch.device("cpu"), time.perf_counter(), e2e, program=program,
                    log=lambda msg: None)


def recorded(verify):
    """``verify`` with its per-proof decides recorded: the outputs gain
    ``succinct`` (``ok`` before the first decide) and ``decides`` (each
    accumulator's mask, fresh first)."""
    from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader

    def fn(proof_bytes, instances):
        key = (proof_bytes.numpy().tobytes(), instances.numpy().tobytes())
        if key not in KEPT:
            masks, orig = [], TorchLoader.decide_pairing

            def decide(self, accumulator, dk):
                if not masks:
                    masks.append(self.ok.clone())
                mask = orig(self, accumulator, dk)
                masks.append(mask.clone())
                return mask

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(TorchLoader, "decide_pairing", decide)
                out = verify(proof_bytes, instances)
            assert torch.equal(out["ok"], masks[0] & masks[1] & masks[2])
            KEPT[key] = {**out, "succinct": masks[0], "decides": masks[1:]}
        return dict(KEPT[key])

    return fn


def session(kind: str):
    """A Session of the aggregation system, sound or with a planted fault,
    acting on the kept outputs."""

    class Planted(agg.Session):
        def __init__(self, *a):
            super().__init__(*a)
            verify = recorded(self.verify)

            def planted(proof_bytes, instances):
                out = verify(proof_bytes, instances)
                fresh, old = out["decides"]
                ok = {"decide_always_true": out["succinct"],
                      "old_decide_skipped": out["succinct"] & fresh}.get(kind, out["ok"])
                out["ok"] = ok
                if kind == "half":  # the second half of the batch given the first half's answers
                    half = len(ok) // 2

                    def halved(v, axis):
                        v = v.movedim(axis, 0)
                        return torch.cat([v[:half], v[:half], v[2 * half:]]).movedim(0, axis)

                    out = {k: halved(v, 1 if v.dim() == 3 else 0) for k, v in out.items()
                           if k not in ("succinct", "decides")}
                return out

            self.verify = planted

    return Planted


def program(kind: str) -> str:
    return kind.title().replace("_", "")


@pytest.fixture(scope="module", autouse=True)
def planted():
    """The sound and planted sessions, as classes of the system's module."""
    with pytest.MonkeyPatch.context() as mp:
        for kind in ("sound", "decide_always_true", "old_decide_skipped", "half"):
            mp.setattr(agg, program(kind), session(kind), raising=False)
        yield


@pytest.fixture(scope="module")
def sound(planted):
    return run(tiny(), program=program("sound"))


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["checks"] == {"rows_wrong": {"value": 0, "limit": 0}, "probe_accepted": {"value": 0, "limit": 0}}
    assert set(sound["metrics"]) == {"verified_proofs_per_s", "setup_s"}


@pytest.mark.parametrize("kind", ["decide_always_true", "old_decide_skipped", "half"])
def test_planted_fault_is_not_correct(sound, kind):
    r = run(tiny(), program=program(kind))
    assert not r["correct"], (kind, r["checks"])
    assert r["checks"]["rows_wrong"]["value"] > 0


def test_every_bad_kind_and_the_probe_are_rows_of_a_run(sound):
    """The bad rows take the kinds in turn: three batches of the cell hold
    one of each; the probe's input is a proof of the file with the next
    proof's instances."""
    c = registry.cell(SPEC, "aggregation_b8")
    inputs = agg.Inputs(c["config_data"], SEED)
    assert [inputs.names[i].split(".")[0] for i in inputs.bad] == list(agg.KINDS)
    from benchmark.harness.rows import RowStream, rng

    stream = RowStream(rng(SEED, 2), inputs.good, inputs.bad, c["mix"]["bad_share"])
    for _ in range(4):
        seen = [stream.take(c["mix"]["batch"]) for _ in range(3)]
        assert all(len(set(b.tolist())) == len(b) == 8 and len(set(b.tolist()) & set(inputs.bad)) == 1 for b in seen)
        assert set(np.concatenate(seen).tolist()) & set(inputs.bad) == set(inputs.bad)
    proof, instances = inputs[inputs.probe]
    j = int(inputs.names[inputs.probe].split(".")[1])
    assert proof == inputs[j][0] and instances == inputs[(j + 1) % len(inputs.good)][1]


@pytest.mark.parametrize("seed", [SEED, 7, 2**40 + 3])
def test_control_accepts_the_bad_inner_proof(seed):
    """The control (the decoded accumulator neither checked on the curve nor
    decided) reads above the limit: it accepts the bad inner snark's outer
    proof, kind (c).  It still rejects kind (b), the flipped instance limb,
    because the instances enter the outer transcript, so the flip moves the
    fresh accumulator too and its decide fails."""
    c = tiny(batch=8, bad_share=0.125)
    e2e, _ = registry.cell_metrics(SPEC, c["name"])
    r = run_cell(c, seed, 2.0, False, torch.device("cpu"), time.perf_counter(), e2e, program="Control",
                 log=lambda msg: None)
    assert not r["correct"] and r["checks"]["rows_wrong"]["value"] > 0
    inputs = agg.Inputs(c["config_data"], seed)
    control = agg.Control(c["config_data"], c["mix"], seed, torch.device("cpu"), torch)
    assert [control._row(i)[0] for i in inputs.bad] == [False, False, True]
    assert [inputs.names[i].split(".")[0] for i in inputs.bad] == list(agg.KINDS)


def test_reference_control_decode_differs_only_by_the_curve_check():
    c = registry.cell(SPEC, "aggregation_b8")["config_data"]
    inputs = agg.Inputs(c, SEED)
    flip = inputs.bad[agg.KINDS.index("limb_flip")]
    assert ref.succinct(inputs.circuit, *inputs[flip]) == (False, None)
    ok, accs = ref.succinct(inputs.circuit, *inputs[flip], checked=False)
    assert ok and not ref.bn254.g1_is_on_curve(accs[1][0])
