"""K4 (``msm_cuda.msm_scan``, the small MSM) as a share of its roofline:
the frozen bound of its launches' shapes over its device time in the
traced slice."""

from benchmark.harness import phases, roofline

KEY = "msm_scan_roofline"


def install(rec):
    """Record each launch's (batch, terms, windows) from its arguments."""
    from snark_verifier_tpu_torch.ops import msm_cuda

    shapes = rec.data.setdefault(KEY, [])
    rec.wrap(msm_cuda, "msm_scan",
             before=lambda table, digits, *a, **k: shapes.append((table.shape[3], table.shape[2], digits.shape[-1])))


def read(run):
    t = run.trace
    device_s = phases.kernel_s(t, "msm_scan") if t else 0.0
    if not device_s or not t["records"].get(KEY):
        return None
    return 100.0 * sum(roofline.msm_scan_bound_s(*shape) for shape in t["records"][KEY]) / device_s
