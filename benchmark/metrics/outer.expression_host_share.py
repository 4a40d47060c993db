"""Host time inside the port's ``PlonkProof.commitments`` (the quotient's
numerator with its lookup and permutation terms, assembled into the MSM of
the quotient's commitment) as a share of the verify call's host time, from
a profiler range the harness wraps around the method while the profiler
runs.

The same install counts the launches of the kernels the outer verify runs
per proof batch, K10 (``poseidon_perm``), K4 (``msm_scan``) and K7
(``miller_loop_pair``, ``final_exponentiation``), and the read prints them
per traced batch to the run's log."""

import sys

KEY = "outer.launches"
KERNELS = (("poseidon", "poseidon_perm", "K10"), ("msm_cuda", "msm_scan", "K4"),
           ("pairing", "miller_loop_pair", "K7 miller_loop"), ("pairing", "final_exponentiation", "K7 final_exp"))


def install(rec):
    import importlib

    from snark_verifier_tpu_torch.verifier.plonk.proof import PlonkProof

    rec.range(PlonkProof, "commitments", "expression")
    counts = rec.data.setdefault(KEY, {})
    for module, name, label in KERNELS:
        counts[label] = 0

        def count(*args, label=label, **kwargs):
            counts[label] += 1

        rec.wrap(importlib.import_module(f"snark_verifier_tpu_torch.ops.{module}"), name, before=count)


def read(run):
    t = run.trace
    if not t:
        return None
    counts = t["records"].get(KEY)
    if counts and t["batches"]:
        per = ", ".join(f"{label} {n / t['batches']:g}" for label, n in counts.items())
        print(f"outer launches per traced batch: {per}", file=sys.stderr, flush=True)
    if not t["range_s"].get("verify") or not t["range_s"].get("expression"):
        return None
    return 100.0 * t["range_s"]["expression"] / t["range_s"]["verify"]
