#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU (no JAX).

Drives the port's main path, BASELINE config 1 (a batched succinct
PLONK+KZG GWC verify of the k=8 standard-plonk proof with the Keccak
transcript, 1820 proofs), through ``snark_verifier_tpu_torch.entry``:

1. probe: torch, CUDA, and the card's name and power limit;
2. build: compile the four kernels (csrc/*.cu) for sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes, with both times (CUDA events, median
   of 5 runs after a warm-up), and K4 at 32 to 256 threads per block;
4. slice: 1820 proofs (4 unique ones tiled, 2 rows with a corrupted
   commitment, 1 row with a wrong instance); accumulators equal the native
   verifier's, ``ok`` False exactly on the corrupted rows, every kernel
   launched by the run, and the host pairing oracle decides a good and the
   wrong-instance accumulator; warm time, proofs/s, peak memory, and a
   torch.profiler breakdown of one warm verify;
5. SHPLONK through the same code at 64 proofs.

Every failure raises, so the exit code is non-zero.  The last stdout line
is ``{"ok": true, "device": {...}}``; before it, a JSON line with the
per-kernel results and the ``nvidia-smi`` name and power limit line.
Usage: ``python3 chip_smoke.py`` (needs one CUDA card; exits non-zero
without one).
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

SEED = 20261016
B = 1820  # proofs in the main path's batch
N_TERMS = 18  # MSM terms per proof at k = 8
SHPLONK_BATCH = 64
KERNELS = {  # name -> (source, TPU kernel replaced)
    "mont_mul": ("snark_verifier_tpu_torch/csrc/field.cu", "snark_verifier_tpu/ops/field_pallas.py:270"),
    "g1_add": ("snark_verifier_tpu_torch/csrc/curve.cu", "snark_verifier_tpu/ops/curve_pallas.py:97"),
    "g1_double": ("snark_verifier_tpu_torch/csrc/curve.cu", "snark_verifier_tpu/ops/curve_pallas.py:106"),
    "msm_scan": ("snark_verifier_tpu_torch/csrc/msm.cu", "snark_verifier_tpu/ops/msm_pallas.py:139"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` on the current stream (one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def max_abs_err(torch, got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def phase_kernels(torch, dev, rng):
    """Each kernel against its plain version on the card, same inputs."""
    from snark_verifier_tpu_torch.entry import bn254  # the python-int oracle
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import curve_cuda as CK
    from snark_verifier_tpu_torch.ops import field as F
    from snark_verifier_tpu_torch.ops import field_cuda as FK
    from snark_verifier_tpu_torch.ops import msm_cuda as MK
    from snark_verifier_tpu_torch.ops.convert import ints_to_tensor

    results = {}
    log("kernels vs plain versions: tolerance 0 (integer limbs, every output must be equal)")

    # K1 mont_mul on (1820, 16), Fq and Fr, edge values in the first 25 rows
    errs, times = [], {}
    for spec in (F.FQ, F.FR):
        edge = [0, 1, 2, spec.modulus - 1, spec.modulus - 2]
        a = [x for x in edge for _ in edge] + [rng.randrange(spec.modulus) for _ in range(B - 25)]
        b = [y for _ in edge for y in edge] + [rng.randrange(spec.modulus) for _ in range(B - 25)]
        ta = torch.as_tensor(spec.encode(a).astype("int64"), device=dev)
        tb = torch.as_tensor(spec.encode(b).astype("int64"), device=dev)
        got, want = FK.mont_mul(ta, tb, spec), FK.mont_mul_plain(ta, tb, spec)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"mont_mul {spec.name}: kernel != plain")
        require(list(spec.decode(got)) == [x * y % spec.modulus for x, y in zip(a, b)],
                f"mont_mul {spec.name}: kernel != python ints")
        errs.append(max_abs_err(torch, [got], [want]))
        times[spec.name] = (cuda_ms(torch, lambda: FK.mont_mul(ta, tb, spec)),
                            cuda_ms(torch, lambda: FK.mont_mul_plain(ta, tb, spec)))
        log(f"kernel mont_mul {spec.name} ({B},16): equal to plain; kernel {times[spec.name][0]:.4f} ms, "
            f"plain {times[spec.name][1]:.4f} ms")
    results["mont_mul"] = {"max_abs_err": max(errs), "ms": times["Fr"][0], "plain_ms": times["Fr"][1]}

    # K2/K3 on 1820 * 18 points from a pool of random multiples of G, with
    # the identity, P + P and P + (-P) in the first rows
    n_pts = B * N_TERMS
    pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(64)]
    ps = [pool[rng.randrange(64)] for _ in range(n_pts)]
    qs = [pool[rng.randrange(64)] for _ in range(n_pts)]
    ps[0], qs[1], qs[2], qs[3] = None, ps[1], bn254.g1_neg(ps[2]), None
    p = C.g1_from_affine_ints(ps, dev)
    q = C.g1_from_affine_ints(qs, dev)
    r = CK.g1_add(p, q)  # projective sums (z != 1) as second-level inputs
    torch.cuda.synchronize()
    checks = [
        ("g1_add", CK.g1_add, CK.g1_add_plain, (p, q)),
        ("g1_add", CK.g1_add, CK.g1_add_plain, (r, q)),
        ("g1_double", CK.g1_double, CK.g1_double_plain, (p,)),
        ("g1_double", CK.g1_double, CK.g1_double_plain, (r,)),
    ]
    errs = {"g1_add": [], "g1_double": []}
    for name, kern, plain, args in checks:
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name}: kernel != plain")
        errs[name].append(max_abs_err(torch, got, want))
    sums = C.g1_to_affine_ints(C.G1(*(c[:64] for c in r)))
    require(sums == [bn254.g1_add(x, y) for x, y in zip(ps[:64], qs[:64])], "g1_add: kernel != oracle")
    dbl = C.g1_to_affine_ints(C.G1(*(c[:64] for c in CK.g1_double(p))))
    require(dbl == [bn254.g1_double(x) for x in ps[:64]], "g1_double: kernel != oracle")
    for name, kern, plain, args in (checks[0], checks[2]):
        ms, plain_ms = cuda_ms(torch, lambda: kern(*args)), cuda_ms(torch, lambda: plain(*args))
        results[name] = {"max_abs_err": max(errs[name]), "ms": ms, "plain_ms": plain_ms}
        log(f"kernel {name} ({n_pts} points): equal to plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # K4 msm_scan at B = 1820, n = 18, all 64 windows, with zero and one scalars
    scal = [rng.randrange(bn254.R) for _ in range(n_pts)]
    scal[0], scal[N_TERMS + 1], scal[2 * N_TERMS] = 0, 1, bn254.R - 1
    pts = C.G1(*(c.reshape(B, N_TERMS, 16).transpose(0, 1) for c in p))
    table = MK.build_tables(pts)
    digits = MK.signed_digits(ints_to_tensor(scal, dev).reshape(B, N_TERMS, 16))
    got, want = MK.msm_scan(table, digits), MK.msm_scan_plain(table, digits)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)), "msm_scan: kernel != plain")
    for row in range(3):
        want_aff = bn254.g1_msm(scal[row * N_TERMS:(row + 1) * N_TERMS], ps[row * N_TERMS:(row + 1) * N_TERMS])
        require(C.g1_to_affine_ints(C.G1(*(c[row:row + 1] for c in got))) == [want_aff], "msm_scan: kernel != oracle")
    ms = cuda_ms(torch, lambda: MK.msm_scan(table, digits))
    plain_ms = cuda_ms(torch, lambda: MK.msm_scan_plain(table, digits))
    results["msm_scan"] = {"max_abs_err": max_abs_err(torch, got, want), "ms": ms, "plain_ms": plain_ms}
    log(f"kernel msm_scan (B={B}, n={N_TERMS}, 64 windows): equal to plain; kernel {ms:.4f} ms "
        f"(block {MK.BLOCK}), plain {plain_ms:.4f} ms")
    sweep = {}
    for block in (32, 64, 128, 256):
        out = MK.msm_scan(table, digits, block=block)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(out, want)), f"msm_scan block {block}: kernel != plain")
        sweep[block] = round(cuda_ms(torch, lambda: MK.msm_scan(table, digits, block=block)), 4)
    log(f"kernel msm_scan threads-per-block sweep, ms: {sweep}")
    return results


def wrappers():
    from snark_verifier_tpu_torch.ops import curve_cuda as CK
    from snark_verifier_tpu_torch.ops import field_cuda as FK
    from snark_verifier_tpu_torch.ops import msm_cuda as MK

    return {"mont_mul": FK.mont_mul, "g1_add": CK.g1_add, "g1_double": CK.g1_double, "msm_scan": MK.msm_scan}


def check_against_native(out, fx, rows, proofs, instances):
    from snark_verifier_tpu_torch.entry import native_accumulator
    from snark_verifier_tpu_torch.parallel.batch import decode_accumulator

    accs = {}
    for row in rows:
        acc = decode_accumulator(out, row)
        require(acc == native_accumulator(fx, proofs[row], instances[row]), f"row {row}: accumulator != native")
        accs[row] = acc
    return accs


def phase_slice(torch, dev, card):
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.parallel.batch import pack_instances, pack_proofs

    t0 = time.perf_counter()
    fx = E.fixture(E.K, "gwc")
    fn, _ = E.entry(dev, batch=B)
    log(f"slice fixture: k={fx.k} {len(fx.proofs)} unique proofs of {len(fx.proofs[0])} bytes, "
        f"{time.perf_counter() - t0:.1f} s on the host")
    proofs = [fx.proofs[i % len(fx.proofs)] for i in range(B)]
    instances = [fx.instances[i % len(fx.proofs)] for i in range(B)]
    bad_rows = [B - 3, B - 2]
    wrong_row = B - 1
    for row in bad_rows:
        proofs[row] = E.corrupt(proofs[row])
    instances[wrong_row] = [[instances[wrong_row][0][0] + 1]]
    args = (pack_proofs(proofs, dev), pack_instances(instances, dev))

    kernels = wrappers()
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"slice first run: {first_s:.3f} s; launches {launches}")
    for name, count in launches.items():
        require(count > 0, f"{name} was not launched by the main path")

    for key in ("lhs_x", "lhs_y", "rhs_x", "rhs_y"):
        v = out[key]
        require(tuple(v.shape) == (B, 16) and bool(((v >= 0) & (v < 1 << 16)).all()), f"{key}: bad limbs")
    ok = out["ok"].cpu().tolist()
    require(ok == [row not in bad_rows for row in range(B)], "ok must be False exactly on the corrupted rows")
    good = [r for r in range(B) if r not in bad_rows and r != wrong_row]
    base = torch.as_tensor([r % len(fx.proofs) for r in good], device=dev)
    idx = torch.as_tensor(good, device=dev)
    for key in ("lhs_x", "lhs_y", "rhs_x", "rhs_y"):
        require(torch.equal(out[key][idx], out[key][base]), f"{key}: tiled rows disagree")
    accs = check_against_native(out, fx, list(range(len(fx.proofs))) + [wrong_row], proofs, instances)
    log(f"slice accumulators equal native for the {len(fx.proofs)} unique proofs and the wrong-instance row; "
        f"ok False exactly on rows {bad_rows}")
    require(E.host_decide(fx, *accs[0]) is True, "host oracle: good accumulator must decide True")
    require(E.host_decide(fx, *accs[wrong_row]) is False, "host oracle: wrong instance must decide False")
    log("host oracle check (util/bn254.pairing_check): good accumulator True, wrong-instance accumulator False")

    times = []
    fn(*args)
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    warm = statistics.median(times)
    log(f"slice warm verify (k=8, B={B}, GWC, EVM transcript): median {warm:.4f} s of {[round(t, 4) for t in times]}, "
        f"{B / warm:.1f} proofs/s, peak memory {peak / 2**20:.1f} MiB, on {card}")
    profile_verify(torch, fn, args, warm)
    return launches


def profile_verify(torch, fn, args, warm_s: float) -> None:
    """One warm verify under torch.profiler: device time by kernel, launch
    and host-op counts, and the device's busy share of the unprofiled warm
    wall time (one stream, so kernel times do not overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host_ops = sum(1 for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("aten::"))
    by = {}
    for e in device:
        key = next((k for k in KERNELS if f"{k}_kernel" in e.name), "plain torch")
        count, us = by.get(key, (0, 0.0))
        by[key] = (count + 1, us + e.device_time_total)
    if "msm_scan" not in by:  # the launch counters, not the profiler, prove the path
        log("slice profile: the profiler recorded no msm_scan kernel; device busy share not measured")
        return
    busy_ms = sum(us for _, us in by.values()) / 1e3
    ranked = sorted(by.items(), key=lambda kv: -kv[1][1])
    parts = ", ".join(f"{k} {c} launches {us / 1e3:.3f} ms" for k, (c, us) in ranked)
    log(f"slice profile (one warm verify): device busy {busy_ms:.3f} ms over {len(device)} device ops "
        f"= {100 * busy_ms / 1e3 / warm_s:.1f} % of the {warm_s:.4f} s warm wall; {host_ops} host aten ops; {parts}")


def phase_shplonk(torch, dev):
    from snark_verifier_tpu_torch import entry as E

    fx = E.fixture(E.K, "shplonk")
    fn, args = E.entry(dev, batch=SHPLONK_BATCH, scheme="shplonk")
    out = fn(*args)
    torch.cuda.synchronize()
    require(bool(out["ok"].all()), "shplonk: every proof must pass")
    proofs = [fx.proofs[i % len(fx.proofs)] for i in range(SHPLONK_BATCH)]
    instances = [fx.instances[i % len(fx.proofs)] for i in range(SHPLONK_BATCH)]
    check_against_native(out, fx, range(len(fx.proofs)), proofs, instances)
    log(f"shplonk B={SHPLONK_BATCH}: accumulators equal native, all ok")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card", file=sys.stderr)
        return 1
    from snark_verifier_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"probe: python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, nvidia-smi: {smi}")

    path, build_s = _build.build()
    _build.library()
    log(f"build: {path.name} in {build_s:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    rng = random.Random(SEED)
    results = phase_kernels(torch, dev, rng)
    launches = phase_slice(torch, dev, smi)
    phase_shplonk(torch, dev)
    require("jax" not in sys.modules, "the port must not import jax")

    report = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": report}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
