"""Host time inside ``ops.poseidon.permutation`` as a share of the verify
call's host time, from a profiler range the harness wraps around the module
attribute while the profiler runs."""


def install(rec):
    from snark_verifier_tpu_torch.ops import poseidon

    rec.range(poseidon, "permutation", "poseidon")


def read(run):
    t = run.trace
    if not t or not t["range_s"].get("verify") or not t["range_s"].get("poseidon"):
        return None
    return 100.0 * t["range_s"]["poseidon"] / t["range_s"]["verify"]
