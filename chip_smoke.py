#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU (no JAX).

Drives the port's main paths through ``snark_verifier_tpu_torch.entry`` and
``parallel.batch``: BASELINE config 1 (a batched succinct PLONK+KZG GWC
verify of the k=8 standard-plonk proof with the Keccak transcript, 1820
proofs, then the batch decide of those proofs), the same circuit's proofs on
the Poseidon transcript, the k=20 outer aggregation snark (verify and decide
of both its accumulators) and config 4's aggregation fold:

1. probe: torch, CUDA, and the card's name and power limit;
2. build: compile the kernels (csrc/*.cu) for sm_90a, one nvcc per
   source in parallel, and print ptxas's registers and spills;
3. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit, at the main path's shapes, with both times (CUDA events, median
   of 5 runs after a warm-up) and the least time the card could take
   (bound); ``mont_pow`` at
   (1820, 16) and (1, 16), Fq and Fr, exponents 0, 1, 256, p - 2 and
   (p + 1) / 4, with both Montgomery products (``fmul_eo``, ``fmul``), also
   against python ints, and its device time per product at batch 1 with
   each, beside the same chain as 329 K1 launches; K6 at the decide's shape
   (nwin 32, window 8) and the 2^20 MSM's (nwin 24, window 11) at batch 1
   and 2 (device time per launch, queued back to back); K4 also against the two-kernel MSM
   (K8/K9, whose composition it computes) and at 1 to 8 proofs per block at
   batches of 8 to 1820 proofs (the geometry its wrapper picks against the
   best); K8 and K9 also at K4's shape (reported beside their path's numbers
   as ``at_config1_shape``); K7's Miller-loop and final-exponentiation
   kernels at the decide's batch (1, doubled to 2 in the Miller loop) and at
   8; ``mont_pow`` also at exponents above 2^256 (two launches each); K2 and
   K5 (a point add on 8 lanes, strided operands) at every width of their
   launches on the main path (32 to 32768 adds) with affine, projective,
   strided and broadcast operands and K5 masks all true, all false, random
   and broadcast, against the oracle on 64 points, and their device time
   per launch, and the chain of one add (one add's launch less an empty
   one); K3 (a doubling on a group of 4 lanes) at 32760, 8192, 288 and 32
   doublings on affine and projective points with identities among them,
   bit for bit, its device time per launch and one doubling's chain; K8
   (a proof's window sum on a group of 8 lanes) at config 1's shape (B =
   1820, n = 18) and the outer snark's (below), also with forced first
   digits (negative, zero, +-8), its device time per launch and one
   proof's chain; K9 (a proof's Horner step on a group of 8 lanes) at both
   shapes with a projective accumulator, the step onto the identity, an
   identity contribution and contrib = +-16 acc (the add's doubling case,
   and a sum that is the identity), its device time per launch and one
   proof's chain; K10 (the Poseidon permutation, one launch) at (1820, 5)
   and (1, 5) rows and batch shape () with 0-4 inputs, expanded (stride-0)
   and broadcast operands, against the python-int oracle on three rows, its
   device time per launch and one row's launch less an empty one; K11 (the
   Keccak-256 sponge, one launch) at 1820 rows of each of the Keccak verify's
   7 hash lengths and at 0, 135, 136 and 137 bytes, on expanded and rank-2
   inputs, against the python-int oracle on three rows a length, its device
   time per launch at each verify length and one row's launch less an empty
   one;
4. slice: 1820 proofs (4 unique ones tiled, 2 rows with a corrupted
   commitment, 1 row with a wrong instance) from the data-file fixture;
   accumulators equal the native verifier's, ``ok`` False exactly on the
   corrupted rows, K1-K4 and ``mont_pow`` launched by the run (at most 230
   K1 launches, 6 K2 and 8 K3 launches, 7 K11 launches (one per hash), no
   K10), and the host pairing oracle decides a good and the
   wrong-instance accumulator; warm time, proofs/s, peak memory, and a
   torch.profiler breakdown of one warm verify;
5. SHPLONK through the same code at 64 proofs;
6. decide: ``entry.decide_entry`` verifies the 1820-proof batch and gives
   its decider (``build_batch_decider``), accumulators and seeded fold
   scalars; the fold by two MSMs and one pairing check is True on them and
   False with the slice's wrong-instance accumulator in one row; K1,
   ``mont_pow``, K2, K5, K6 and K7's two pairing kernels launched by it (one
   launch of each per pairing check, no single Fq12 product, one K6 launch
   for both MSMs, at most 16 K1 and 2 ``mont_pow`` launches, 62 K5 and 34
   K2 launches); warm time, verified proofs/s (verify + decide), peak
   memory, and its profile;
   ``build_verifier(decide_dk=...)`` on 8 proofs equal to the host oracle;
7. large MSM: ``msm_serial`` at 2^16 (window 8) and 2^20 (window 11,
   signed) points, exact against the oracle; points/s and peak memory;
8. Poseidon slice: 1820 Poseidon-transcript proofs (4 unique ones tiled, a
   compressed point with x >= p in one row, a non-residue x in another, a
   wrong instance in a third); accumulators equal the native verifier's,
   ``ok`` False exactly on the two corrupted rows, K1-K4 launched, one K10
   launch per permutation (14), fewer than 400 K1 launches and no K11; warm time,
   proofs/s, peak memory, K1 launches, and a profile with the share of the
   Poseidon permutations and point reads in device time and host ops;
9. aggregation: ``entry.aggregation_entry`` (the k=20 outer snark at B=8,
   both accumulators decided per proof): both accumulators equal the native
   verifier's, ``ok`` all True, a mutated proof byte and a flipped instance
   limb clear it, 8 K3 launches, one K4 launch per small MSM and none of K8
   or K9, K10 launched; warm times and a profile; then K8 and K9 against
   their plain versions, and K4 against its plain version and K8/K9
   (``msm_windowed``), bit for bit, on K4's operands of that run's first
   small MSM (the kernels line reports K8/K9's times and bounds at this
   shape);
10. config 4: the port's ``aggregate_native`` folds the four Poseidon
   snarks on the host, the card decides the fold (True) and decodes its 16
   instance limbs back to it;
11. IPA verify: an opening at K=10 proved on the host (zk off and on),
   tiled to 64 rows with a wrong v in one and a corrupted round point in
   another, through ``parallel.batch.build_ipa_verifier`` (the opening
   verify on ``TorchLoader`` and ``TorchEvmTranscript``, then ``IpaAs.decide``
   through ``decide_ipa``): ``ok`` False exactly on those rows, U equal to
   the native verifier's, one K6 launch; times, peak memory, a profile;
12. IPA decide at k=20: 2^20 generators (64 random points tiled), 4
   accumulators with random xi and U from a host oracle, the last moved to
   U + G: True, True, True, False with one K6 launch; the generators'
   conversion, first and warm times, peak memory, launches, a profile;
13. chunked MSM: ``msm_serial_chunked`` (window 8, ``win_chunk`` 8) at 2^20
   limb for limb equal to ``msm_serial`` and at 2^22 equal to the oracle
   with its peak under 80 GB; ``msm_serial_rows`` with two scalar rows at
   2^20, each row limb for limb equal to ``msm_serial``; one K6 launch
   each; times and peaks;
14. mesh: a world-1 NCCL group (``file://`` store): ``shard_verifier`` on
   config 1 at B=1820 row for row equal to the unsharded verifier,
   ``sharded_msm`` and ``sharded_msm_2d`` (a (1, 1) mesh) at 2^20 equal to
   ``msm_serial``, ``entry.dryrun_multichip(1)``; then two ranks of a gloo
   group on the one card (spawned; NCCL refuses two ranks on one device):
   ``shard_verifier`` at B=64 and ``sharded_msm`` at 2^16 equal on both
   ranks to the unsharded results, within 300 s.

On every path, each ``field.pow_const``/``inv`` must be one ``mont_pow``
launch (``count_launches``).

Every failure raises, so the exit code is non-zero.  The last stdout line
is ``{"ok": true, "device": {...}}``; before it, a JSON line with phases
11-14's numbers (``paths``), a JSON line with the per-kernel results (``path_device_ms``: the kernel's mean device time per
launch in the profiled warm run of the path that counts its launches;
``bound_with_floor_ms``: ``bound_ms`` raised to the least device time of
any one kernel launch in those profiles) and the ``nvidia-smi`` name and
power limit line.
Usage: ``python3 chip_smoke.py`` (needs one CUDA card; exits non-zero
without one).
"""

from __future__ import annotations

import json
import random
import re
import statistics
import subprocess
import sys
import time

from benchmark.harness.roofline import (CLOCK_HZ, FE_BYTES, HBM_BYTES_PER_S, INT32_MULS_PER_S, MONT_PER, WINDOW_DBLS,
                                        bound_s, scan_mont_products)

SEED = 20261016
B = 1820  # proofs in the main path's batch
N_TERMS = 18  # MSM terms per proof at k = 8
SHPLONK_BATCH = 64
DECIDE_PROOFS = 8  # build_verifier(decide_dk=...) batch
MSM_POOL = 64  # distinct points of the large MSM, tiled
MSM_CASES = ((16, 8, False), (20, 11, True))  # large MSM: (log2 points, window, signed)
KERNELS = {  # name -> (source, TPU kernel replaced)
    "mont_mul": ("snark_verifier_tpu_torch/csrc/field.cu", "snark_verifier_tpu/ops/field_pallas.py:270"),
    "mont_pow": ("snark_verifier_tpu_torch/csrc/field.cu", "snark_verifier_tpu/ops/field_pallas.py:270"),
    "g1_add": ("snark_verifier_tpu_torch/csrc/curve.cu", "snark_verifier_tpu/ops/curve_pallas.py:97"),
    "g1_double": ("snark_verifier_tpu_torch/csrc/curve.cu", "snark_verifier_tpu/ops/curve_pallas.py:106"),
    "msm_scan": ("snark_verifier_tpu_torch/csrc/msm.cu", "snark_verifier_tpu/ops/msm_pallas.py:139"),
    "g1_add_select": ("snark_verifier_tpu_torch/csrc/curve.cu", "snark_verifier_tpu/ops/curve_pallas.py:113"),
    "horner_combine": ("snark_verifier_tpu_torch/csrc/msm.cu", "snark_verifier_tpu/ops/curve_pallas.py:348"),
    "fq12_mul": ("snark_verifier_tpu_torch/csrc/tower.cu", "snark_verifier_tpu/ops/tower_pallas.py:97"),
    "msm_window": ("snark_verifier_tpu_torch/csrc/msm.cu", "snark_verifier_tpu/ops/msm_pallas.py:90"),
    "msm_horner": ("snark_verifier_tpu_torch/csrc/msm.cu", "snark_verifier_tpu/ops/msm_pallas.py:232"),
    "miller_loop": ("snark_verifier_tpu_torch/csrc/tower.cu", "snark_verifier_tpu/ops/tower_pallas.py:97"),
    "final_exp": ("snark_verifier_tpu_torch/csrc/tower.cu", "snark_verifier_tpu/ops/tower_pallas.py:97"),
    "poseidon_perm": ("snark_verifier_tpu_torch/csrc/poseidon.cu", "none (XLA: snark_verifier_tpu/ops/poseidon.py:168)"),
    "keccak256": ("snark_verifier_tpu_torch/csrc/keccak.cu", "none (XLA: snark_verifier_tpu/ops/keccak.py:118)"),
}
PAIRING_KERNELS = ("miller_loop", "final_exp")  # K7's kernels on the pairing path
SLICE_KERNELS = ("mont_mul", "mont_pow", "g1_add", "g1_double", "msm_scan", "keccak256")  # the Keccak-transcript verify
DECIDE_KERNELS = ("mont_mul", "mont_pow", "g1_add", "g1_add_select", "horner_combine", *PAIRING_KERNELS)
POSEIDON_KERNELS = ("mont_mul", "mont_pow", "g1_add", "g1_double", "msm_scan", "poseidon_perm")  # the Poseidon-transcript verify
AGG_KERNELS = ("mont_mul", "mont_pow", "g1_add", "g1_double", "msm_scan", "poseidon_perm",
               *PAIRING_KERNELS)  # the outer snark
PAIRING_BATCHES = (1, 8)  # K7's pairing kernels: the decide's batch and the outer snark's
SCAN_SWEEP_BATCHES = (8, 66, 132, 264, 400, 528, 800, 1056, 1320, 1820)  # K4's geometry sweep
HORNER_SHAPES = ((32, 8), (24, 11))  # K6: (nwin, window) of the decide's MSM and of the 2^20 MSM (signed)
IPA_K, IPA_BATCH = 10, 64  # the IPA verify phase: key size, openings (one tiled)
IPA_WRONG_V, IPA_BAD_BYTE = 5, 9  # its rows with a wrong v and with a corrupted round point
IPA_KERNELS = ("mont_mul", "mont_pow", "g1_add", "g1_double", "msm_scan", "g1_add_select", "horner_combine")
IPA_DECIDE_K, IPA_DECIDE_BATCH = 20, 4  # the IPA decide at full width: 2^20 generators, 4 accumulators
CHUNK = 8  # msm_serial_chunked's win_chunk (the JAX default) at 2^20 and 2^22
DECIDE_MAX_K1, DECIDE_MAX_POW, VERIFY_MAX_K1 = 16, 2, 230  # launch ceilings on the decide and the Keccak verify
# K10 on the Poseidon verify: one launch per permutation of the transcript,
# 14 a batch, and a ceiling on its K1 launches (4856 before K10)
POSEIDON_PERMS, POSEIDON_MAX_K1 = 14, 400
POSEIDON_LEVELS = 4  # dependent products a round on K10's chain: the S-box's 3, then the matrix
# K11 on the Keccak verify: one launch per hash of the transcript, of these
# lengths in order; the padding's edges besides; the 32-bit integer ops of
# one keccak-f round on 64-bit lanes (theta 110, rho 48, chi 150, iota 2)
KECCAK_VERIFY_LENGTHS = (256, 33, 33, 96, 224, 448, 160)
KECCAK_EDGE_LENGTHS = (0, 135, 136, 137)
KECCAK_OPS_PER_ROUND = 310
# K2/K5: the widths of their launches on the main path (the decide's bucket
# tree 32768 ... 32 pairs, flushes 8192, tree sums 4096 ... 32, suffix scans
# 8192 ... 32; the verify's table build 32760), and their launch counts
ADD_WIDTHS = (32768, 32760, 16384, 8192, 4096, 1024, 32)
DECIDE_ADD_LAUNCHES = {"g1_add_select": 62, "g1_add": 34}
VERIFY_ADD_LAUNCHES = {"g1_add": 6}
# K3: the widths of its launches (the verify's table build 32760 = 1820 x 18,
# the outer snark's 288 = 8 x 36) and two between; its launches per verify
# and per outer snark (4 per small MSM's table)
DBL_WIDTHS = (32760, 8192, 288, 32)
VERIFY_DBL_LAUNCHES = AGG_DBL_LAUNCHES = 8
WINDOW_FIRST_DIGITS = (-1, -8, 0, 8, -3, 5, -5, 1)  # K8's forced first digits, proof b takes entry b % 8
BIG_EXPONENTS = ((1 << 256) + 7, (1 << 300) + 5)  # mont_pow above 2^256: a few launches over 256-bit pieces
AGG_BATCH = 8  # the outer snark tiled, as tools/verify_aggregation_onchip.py
FLIPPED_LIMB = 3  # instance limb flipped in the aggregation phase (old accumulator's lhs x, top limb)

# The card's peak rates, the work per operation and the bound are the
# benchmark's (benchmark/harness/roofline.py).
# Fq products of the pairing's tower operations at the least count of a
# known schedule (the kernels run the dense 54-product Fq12 Karatsuba for all
# of them; every value is reduced below p, so any correct schedule gives the
# same limbs): Fq2 product 3, squaring 2; Fq6 product 18, squaring 12
# (Chung-Hasan SQR2); Fq12 product 54, squaring 36 (complex); squaring in
# the cyclotomic subgroup 18 (Granger-Scott), which holds every value of the
# hard part; the product by a Miller line ((py, 0, 0), (a, c3, 0)), py in
# Fq, 36 (f0 py 6, f1 (a, c3, 0) 15, (f0 + f1)(py + a, c3, 0) 15); a
# Frobenius map 15 (p: five Fq2 coefficients) or 10 (p^2: in Fq).
TOWER = {"fq2_mul": 3, "fq2_sqr": 2, "fq6_mul": 18, "fq6_sqr": 12, "fq12_mul": 54, "fq12_sqr": 36,
         "cyclotomic_sqr": 18, "line_mul": 36, "frob1": 15, "frob2": 10}
ADD_PATH_WIDTHS = {}  # path -> the widths of its K2 and K5 launches, in order
PROFILES = {}  # profile_run's label -> device busy ms, host aten ops and device time by kernel
# utility ops torch.profiler leaves out of its event list
UNLISTED_OPS = {"[memory]", "[OutOfMemory]", "profiler::_record_function_enter", "profiler::_record_function_enter_new",
                "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr", "aten::_version"}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(torch, fn, reps: int = 5, warmup: bool = True) -> float:
    """Median milliseconds of ``fn`` on the current stream (after one
    warm-up call unless the caller has just made one)."""
    if warmup:
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


def device_ms(torch, fn, reps: int, sleep_ms: float = 40.0) -> float:
    """Mean device milliseconds per call of ``fn``: after a warm-up call, the
    ``reps`` calls are queued behind a sleep kernel, so they run back to back
    on the card and the host's enqueue time between them is not counted
    (CUDA events around the calls).  Raises if the host took longer to
    enqueue them than the card slept."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * 1e-3 * CLOCK_HZ))
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    require(enqueue_ms < sleep_ms, f"device_ms: enqueueing {reps} calls took {enqueue_ms:.1f} ms, more than the "
            f"{sleep_ms} ms sleep in front of them")
    return start.elapsed_time(stop) / reps


def pow_products(exponent: int) -> int:
    """Montgomery products of ``field.pow_const``'s chain: 14 for the table,
    then 4 squarings and one product per window after the first."""
    nwin = (exponent.bit_length() + 3) // 4
    return 0 if nwin == 0 else 14 + 5 * (nwin - 1)


def max_abs_err(torch, got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def bound(nbytes: int, mont_products: int) -> dict:
    """``roofline.bound_s`` in milliseconds, and whether the bytes or the
    multiplies set it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms = bound_s(nbytes, mont_products) * 1e3
    return {"bound_ms": ms, "bound_by": "bytes" if t_bytes >= ms else "operations", "library_ms": None}


def timed_once(torch, fn):
    """One call of ``fn``: its result and its milliseconds (CUDA events)."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def pairing_mont_products() -> tuple[int, int]:
    """Montgomery products K7's Miller-loop kernel needs per lane of the
    doubled batch, and its final-exponentiation kernel per batch element,
    each tower operation priced at ``TOWER`` (the least count of a known
    schedule, not the dense products the kernels run)."""
    from snark_verifier_tpu_torch.ops import pairing as PAIR
    from snark_verifier_tpu_torch.util import bn254

    is_dbl = [k == "dbl" for k, _, _ in PAIR._line_constants(PAIR._g2_key(bn254.G2_GEN))]
    steps = len(is_dbl)
    # f starts at one: the first step's squaring and line product need nothing
    miller = (sum(is_dbl) - is_dbl[0]) * TOWER["fq12_sqr"] + (steps - 1) * TOWER["line_mul"] + 2 * steps  # + lam px
    x_sqr, x_mul = bn254.BN_X.bit_length() - 1, bin(bn254.BN_X).count("1") - 1  # one _pow_x
    e = bn254.P - 2  # Fermat inversion in Fq, 4-bit windows from the top one
    top = (e.bit_length() - 1) // 4
    fermat = 14 + 4 * top + sum(1 for w in range(top) if (e >> (4 * w)) & 15)
    # f^-1 = conj(f) (f conj f)^-1: the norm a^2 - v b^2, an Fq6 inverse
    # (3 squarings + 6 products, an Fq2 inverse of 2 squarings + 2 products,
    # 3 products) and conj(f) times it
    inverse = 2 * TOWER["fq6_sqr"] + 3 * TOWER["fq2_sqr"] + 9 * TOWER["fq2_mul"] + 4 + fermat + 2 * TOWER["fq6_mul"]
    final = (
        TOWER["fq12_mul"]  # _combine
        + inverse + 2 * TOWER["fq12_mul"]  # the easy part
        + 5 * TOWER["frob1"] + 3 * TOWER["frob2"]  # the Frobenius maps
        + 3 * (x_sqr * TOWER["cyclotomic_sqr"] + x_mul * TOWER["fq12_mul"])  # fu, fu2, fu3
        + 4 * TOWER["fq12_mul"]  # y0, y4, y6
        + 9 * TOWER["fq12_mul"] + 4 * TOWER["cyclotomic_sqr"]  # the chain
    )
    return miller, final


def phase_kernels(torch, dev, rng):
    """Each kernel against its plain version on the card, same inputs."""
    from snark_verifier_tpu_torch.entry import bn254  # the python-int oracle
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import msm as M
    from snark_verifier_tpu_torch.ops import msm_cuda as MK
    from snark_verifier_tpu_torch.ops.convert import ints_to_tensor

    log("kernels vs plain versions: tolerance 0 (integer limbs, every output must be equal)")
    results = phase_kernels_field(torch, dev, rng)

    # K2/K3 on 1820 * 18 points from a pool of random multiples of G, with
    # the identity, P + P and P + (-P) in the first rows
    n_pts = B * N_TERMS
    pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(64)]
    ps = [pool[rng.randrange(64)] for _ in range(n_pts)]
    qs = [pool[rng.randrange(64)] for _ in range(n_pts)]
    ps[0], qs[1], qs[2], qs[3] = None, ps[1], bn254.g1_neg(ps[2]), None
    p = C.g1_from_affine_ints(ps, dev)
    q = C.g1_from_affine_ints(qs, dev)
    r = C.g1_add(p, q)  # projective sums (z != 1) as second-level inputs
    torch.cuda.synchronize()
    checks = [
        ("g1_add", C.g1_add, C.g1_add_plain, (p, q)),
        ("g1_add", C.g1_add, C.g1_add_plain, (r, q)),
        ("g1_double", C.g1_double, C.g1_double_plain, (p,)),
        ("g1_double", C.g1_double, C.g1_double_plain, (r,)),
    ]
    errs = {"g1_add": [], "g1_double": []}
    for name, kern, plain, args in checks:
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name}: kernel != plain")
        errs[name].append(max_abs_err(torch, got, want))
    sums = C.g1_to_affine_ints(C.G1(*(c[:64] for c in r)))
    require(sums == [bn254.g1_add(x, y) for x, y in zip(ps[:64], qs[:64])], "g1_add: kernel != oracle")
    dbl = C.g1_to_affine_ints(C.G1(*(c[:64] for c in C.g1_double(p))))
    require(dbl == [bn254.g1_double(x) for x in ps[:64]], "g1_double: kernel != oracle")
    for name, kern, plain, args in (checks[0], checks[2]):
        ms, plain_ms = cuda_ms(torch, lambda: kern(*args)), cuda_ms(torch, lambda: plain(*args))
        ops = MONT_PER["add" if name == "g1_add" else "double"]
        results[name] = {"max_abs_err": max(errs[name]), "ms": ms, "plain_ms": plain_ms,
                         **bound((3 * len(args) + 3) * n_pts * FE_BYTES, ops * n_pts)}
        log(f"kernel {name} ({n_pts} points): equal to plain; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    results["g1_double"]["lanes"] = phase_kernels_double(torch, p, r, results)

    # K4 msm_scan at B = 1820, n = 18, all 64 windows, with zero and one scalars
    scal = [rng.randrange(bn254.R) for _ in range(n_pts)]
    scal[0], scal[N_TERMS + 1], scal[2 * N_TERMS] = 0, 1, bn254.R - 1
    table, digits = M.scan_inputs(C.G1(*(c.reshape(B, N_TERMS, 16) for c in p)),
                                  ints_to_tensor(scal, dev).reshape(B, N_TERMS, 16))
    got = MK.msm_scan(table, digits)
    want, plain_ms = timed_once(torch, lambda: MK.msm_scan_plain(table, digits))  # ~17 s a call
    two = MK.msm_windowed(table, digits)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)), "msm_scan: kernel != plain")
    require(all(torch.equal(g, w) for g, w in zip(got, two)), "msm_scan: kernel != msm_windowed (K8/K9)")
    for row in range(3):
        want_aff = bn254.g1_msm(scal[row * N_TERMS:(row + 1) * N_TERMS], ps[row * N_TERMS:(row + 1) * N_TERMS])
        require(C.g1_to_affine_ints(C.G1(*(c[row:row + 1] for c in got))) == [want_aff], "msm_scan: kernel != oracle")
    ms = cuda_ms(torch, lambda: MK.msm_scan(table, digits))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ppb, grid = MK.scan_geometry(B, sms)
    require(grid > sms, f"msm_scan: a grid of {grid} blocks at B={B} does not cover the {sms} SMs")
    results["msm_scan"] = {"max_abs_err": max_abs_err(torch, got, want), "ms": ms, "plain_ms": plain_ms,
                           **bound((table.numel() // 16 + B * N_TERMS + 3 * B) * FE_BYTES,
                                   B * scan_mont_products(N_TERMS, digits.shape[-1])),
                           "proofs_per_block": ppb, "grid": grid, **scan_chain(torch, table, digits)}
    log(f"kernel msm_scan (B={B}, n={N_TERMS}, 64 windows): equal to plain, to msm_windowed (K8/K9) and to the "
        f"oracle; kernel {ms:.4f} ms ({ppb} proofs per block, {grid} blocks on {sms} SMs), plain {plain_ms:.4f} ms, "
        f"bound {results['msm_scan']['bound_ms']:.6f} ms ({results['msm_scan']['bound_by']}), one proof's chain "
        f"{results['msm_scan']['chain_ms']:.6f} ms")
    results["msm_scan"]["sweep_ms"], results["msm_scan"]["geometry"] = scan_sweep(torch, table, digits, want)
    return results, (table, digits, got, scal, ps)


def one_item_chain(torch, fn, reps: int = 50) -> dict:
    """The chain of one item of a kernel's work: ``fn``'s launch on one item
    less an empty launch, both by ``device_ms``, in turns (empty, one, one,
    empty).  Returns both means and their difference, ``chain_ms``."""
    turns = [(kind, device_ms(torch, (lambda: torch.cuda._sleep(0)) if kind == "empty" else fn, reps=reps))
             for kind in ("empty", "one", "one", "empty")]
    one = {k: statistics.mean(t for j, t in turns if j == k) for k in ("empty", "one")}
    return {"one_item_ms": one["one"], "empty_ms": one["empty"], "chain_ms": one["one"] - one["empty"]}


def phase_kernels_double(torch, p, r, results_field):
    """K3, one doubling on a group of 4 lanes, against its plain version bit
    for bit at every width of ``DBL_WIDTHS``, on affine points (the identity
    in row 0) and projective ones (P + Q, P + P, and P + (-P) and P + O
    among the first rows); then device ms per launch at each width, and the
    chain of one doubling (``one_item_chain``)."""
    from snark_verifier_tpu_torch.ops import curve as C

    for n in DBL_WIDTHS:
        for kind, pt in (("affine", p), ("projective", r)):
            cut = C.G1(*(c[:n] for c in pt))
            require(bool((cut.z == 0).all(-1).any()), f"g1_double n={n} {kind}: no identity (z = 0) among the inputs")
            require(all(torch.equal(g, w) for g, w in zip(C.g1_double(cut), C.g1_double_plain(cut))),
                    f"g1_double n={n} {kind}: != plain")
    torch.cuda.synchronize()
    log(f"kernel g1_double (lanes): equal to plain at widths {DBL_WIDTHS} on affine and projective points with "
        f"identities among them, on {C.DBL_GROUP} lanes")

    latency = results_field["mont_pow"]["product_latency_ms"]
    out = {}
    for n in DBL_WIDTHS:
        cut = C.G1(*(c[:n] for c in r))
        ms = device_ms(torch, lambda: C.double_points(cut), reps=50)
        b = bound(6 * n * FE_BYTES, MONT_PER["double"] * n)
        out[n] = {"device_ms": ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        log(f"kernel g1_double n={n}: device ms per launch {ms:.6f}; bound {b['bound_ms']:.6f} ms ({b['bound_by']})")
    one_p = C.G1(*(c[:1] for c in r))
    chain = one_item_chain(torch, lambda: C.double_points(one_p))
    log(f"kernel g1_double: one doubling's launch less an empty launch {chain} ms (device_ms, in turns); products "
        f"alone 2 x fmul_eo {2 * latency['fmul_eo']:.6f} ms")
    return {"by_width": out, "group_lanes": C.DBL_GROUP, "block": C.DBL_BLOCK, "one_double": chain,
            "critical_path_ms": chain["chain_ms"], "products_on_chain_ms": 2 * latency["fmul_eo"]}


def window_cases(torch, table, dig_w, where: str) -> float:
    """K8 against ``msm_window_plain``, bit for bit, on one window's digits
    and on a copy whose first digits are ``WINDOW_FIRST_DIGITS`` (negative,
    zero and +-8 first digits); returns the largest |kernel - plain|."""
    from snark_verifier_tpu_torch.ops import msm_cuda as MK

    batch = dig_w.shape[0]
    forced = dig_w.clone()
    firsts = torch.tensor(WINDOW_FIRST_DIGITS, device=dig_w.device)
    forced[:, 0] = firsts[torch.arange(batch, device=dig_w.device) % len(WINDOW_FIRST_DIGITS)]
    require(bool((forced == 0).any() and (forced < 0).any() and (forced[:, 0] < 0).any()),
            f"msm_window ({where}): the digits need zero, negative and negative first entries")
    err = 0.0
    for case, dig in (("window", dig_w), ("forced first digits", forced)):
        want = MK.msm_window_plain(table, dig)
        got = MK.msm_window(table, dig)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"msm_window ({where}, {case}): kernel != plain")
        err = max(err, max_abs_err(torch, got, want))
    return err


def window_turns(torch, table, dig_w) -> dict:
    """K8's device ms per launch (``device_ms``), and its chain: one proof's
    launch less an empty launch (``one_item_chain``)."""
    from snark_verifier_tpu_torch.ops import msm_cuda as MK

    one_table, one_dig = table[:, :, :, :1].contiguous(), dig_w[:1].contiguous()
    return {"device_ms": device_ms(torch, lambda: MK.msm_window(table, dig_w), reps=50),
            **one_item_chain(torch, lambda: MK.msm_window(one_table, one_dig))}


def horner_cases(torch, acc, contrib, where: str) -> float:
    """K9 against ``msm_horner_plain``, bit for bit: a projective accumulator
    and contribution, the step onto the identity (the MSM's first window),
    an identity contribution, contrib = 16 acc (the add's doubling case: the
    triple the 4 doublings give) and contrib = -16 acc (the sum is the
    identity).  Returns the largest |kernel - plain|."""
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import field as F
    from snark_verifier_tpu_torch.ops import msm_cuda as MK

    batch = acc.x.shape[0]
    ident = C.g1_identity((batch,), acc.x.device)
    sixteen = acc
    for _ in range(WINDOW_DBLS):
        sixteen = C.g1_double_plain(sixteen)
    minus = C.G1(sixteen.x, F.neg(sixteen.y, F.FQ), sixteen.z)
    err = 0.0
    for case, a, c in (("projective", acc, contrib), ("from the identity", ident, contrib),
                       ("identity contrib", acc, ident), ("contrib = 16 acc", acc, sixteen),
                       ("contrib = -16 acc", acc, minus)):
        got, want = MK.msm_horner(a, c), MK.msm_horner_plain(a, c)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"msm_horner ({where}, {case}): kernel != plain")
        err = max(err, max_abs_err(torch, got, want))
        if case == "contrib = -16 acc":
            require(bool((want.z == 0).all()), f"msm_horner ({where}): 16 acc - 16 acc must be the identity")
    return err


def horner_result(torch, acc, contrib, err: float) -> dict:
    """K9's row of the kernels line at this batch: call and plain ms (CUDA
    events), its bound, its device ms per launch (``device_ms``) and its
    chain, one proof's launch less an empty launch (``one_item_chain``)."""
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import msm_cuda as MK

    batch = acc.x.shape[0]
    one_acc, one_c = (C.G1(*(t[:1].contiguous() for t in g)) for g in (acc, contrib))
    ms = cuda_ms(torch, lambda: MK.msm_horner(acc, contrib))
    plain_ms = cuda_ms(torch, lambda: MK.msm_horner_plain(acc, contrib))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound(9 * batch * FE_BYTES, (WINDOW_DBLS * MONT_PER["double"] + MONT_PER["add"]) * batch),
            "device_ms": device_ms(torch, lambda: MK.msm_horner(acc, contrib), reps=50),
            **one_item_chain(torch, lambda: MK.msm_horner(one_acc, one_c))}


def horner_summary(row: dict) -> str:
    return (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms; device ms per launch {row['device_ms']:.6f}, "
            f"one proof's chain {row['chain_ms']:.6f} ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']})")


def scan_chain(torch, table, digits) -> dict:
    """K4's chain: one proof's whole MSM (its n - 1 adds per window, then
    64 Horner steps) less an empty launch (``one_item_chain``)."""
    from snark_verifier_tpu_torch.ops import msm_cuda as MK

    one_table, one_dig = table[:, :, :, :1].contiguous(), digits[:1].contiguous()
    return one_item_chain(torch, lambda: MK.msm_scan(one_table, one_dig), reps=10)


def phase_kernels_field(torch, dev, rng):
    """K1 ``mont_mul`` and ``mont_pow`` against their plain versions and
    python ints, bit for bit: K1 at (1820, 16) with edge values;
    ``mont_pow`` at (1820, 16) and (1, 16) with the exponents 0, 1, 256,
    p - 2 and (p + 1) / 4, with both Montgomery products, and the device time
    per product of each at batch 1 (the chain's latency)."""
    from snark_verifier_tpu_torch.ops import field as F

    results = {}
    errs, times, operands = [], {}, {}
    for spec in (F.FQ, F.FR):
        edge = [0, 1, 2, spec.modulus - 1, spec.modulus - 2]
        a = [x for x in edge for _ in edge] + [rng.randrange(spec.modulus) for _ in range(B - 25)]
        b = [y for _ in edge for y in edge] + [rng.randrange(spec.modulus) for _ in range(B - 25)]
        ta = torch.as_tensor(spec.encode(a).astype("int64"), device=dev)
        tb = torch.as_tensor(spec.encode(b).astype("int64"), device=dev)
        got, want = F.mont_mul(ta, tb, spec), F.mont_mul_plain(ta, tb, spec)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"mont_mul {spec.name}: kernel != plain")
        require(list(spec.decode(got)) == [x * y % spec.modulus for x, y in zip(a, b)],
                f"mont_mul {spec.name}: kernel != python ints")
        errs.append(max_abs_err(torch, [got], [want]))
        times[spec.name] = (cuda_ms(torch, lambda: F.mont_mul(ta, tb, spec)),
                            cuda_ms(torch, lambda: F.mont_mul_plain(ta, tb, spec)))
        operands[spec.name] = (a, ta, tb)
        log(f"kernel mont_mul {spec.name} ({B},16): equal to plain; kernel {times[spec.name][0]:.4f} ms, "
            f"plain {times[spec.name][1]:.4f} ms")
    results["mont_mul"] = {"max_abs_err": max(errs), "ms": times["Fr"][0], "plain_ms": times["Fr"][1],
                           **bound(3 * B * FE_BYTES, B)}

    # mont_pow: every exponent at both widths, both products, against the
    # plain chain and python ints
    exps = lambda m: (0, 1, 256, m - 2, (m + 1) // 4)  # noqa: E731
    errs, per = [], {}
    for spec in (F.FQ, F.FR):
        a, ta, _ = operands[spec.name]
        for n in (B, 1):
            x, vals = ta[-n:].contiguous(), a[-n:]  # batch 1: a random value
            for e in exps(spec.modulus):
                want = F.mont_pow_plain(x, e, spec)
                for even_odd in (True, False):
                    got = F.mont_pow(x, e, spec, even_odd=even_odd)
                    torch.cuda.synchronize()
                    require(torch.equal(got, want), f"mont_pow {spec.name} n={n} e={e} even_odd={even_odd}: != plain")
                errs.append(max_abs_err(torch, [got], [want]))
                require(list(spec.decode(got.reshape(-1, 16))) == [pow(v, e, spec.modulus) for v in vals],
                        f"mont_pow {spec.name} n={n} e={e}: != python ints")
        log(f"kernel mont_pow {spec.name}: equal to plain (fmul_eo and fmul) and python ints at ({B},16) and "
            f"(1,16), exponents 0, 1, 256, p - 2, (p + 1) / 4")
        # an exponent of 2^256 and above: one launch per 256-bit piece of the same chain
        a, ta, _ = operands[spec.name]
        for e in BIG_EXPONENTS:
            before = F.mont_pow.launches
            got = F.mont_pow(ta, e, spec)
            launched = F.mont_pow.launches - before
            torch.cuda.synchronize()
            require(torch.equal(got, F.mont_pow_plain(ta, e, spec)),
                    f"mont_pow {spec.name} e=2^{e.bit_length() - 1}+: != plain")
            require(list(spec.decode(got)) == [pow(v, e, spec.modulus) for v in a], f"mont_pow {spec.name}: != python ints")
            require(launched == len(F.exponent_pieces(e)) == 2, f"mont_pow above 2^256: {launched} launches, not 2")
        before = F.mont_pow.launches
        F.mont_pow(ta, (1 << 256) - 1, spec)
        require(F.mont_pow.launches - before == 1, "mont_pow below 2^256 must be one launch")
        log(f"kernel mont_pow {spec.name} ({B},16): exponents 2^256 + 7 and 2^300 + 5 equal to plain and python ints, "
            f"two launches each (256-bit pieces); 2^256 - 1 one launch")
    _, ta, _ = operands["Fr"]
    e = F.FR.modulus - 2
    products = pow_products(e)
    x1 = ta[-1:].contiguous()
    for even_odd in (True, False):
        per[even_odd] = {
            "batch_1": device_ms(torch, lambda: F.mont_pow(x1, e, F.FR, even_odd=even_odd), reps=20),
            f"batch_{B}": device_ms(torch, lambda: F.mont_pow(ta, e, F.FR, even_odd=even_odd), reps=20),
        }
    latency = {"fmul_eo": per[True]["batch_1"] / products, "fmul": per[False]["batch_1"] / products}
    def by_k1(x):  # the same chain as one K1 launch per product: field.pow_const before mont_pow
        return F.mont_pow_plain(x, e, F.FR, mul=F.mont_mul)

    k1_chain = {"batch_1": device_ms(torch, lambda: by_k1(x1), reps=2, sleep_ms=80.0),
                f"batch_{B}": device_ms(torch, lambda: by_k1(ta), reps=2, sleep_ms=80.0)}
    k1_chain_call = cuda_ms(torch, lambda: by_k1(ta), reps=3)
    ms = cuda_ms(torch, lambda: F.mont_pow(ta, e, F.FR))
    _, plain_ms = timed_once(torch, lambda: F.mont_pow_plain(ta, e, F.FR))
    results["mont_pow"] = {
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "shape": {"n": B, "exponent": "r - 2"},
        **bound(2 * B * FE_BYTES, products * B),
        "critical_path_ms": products * latency["fmul_eo"], "products": products,
        "device_ms": {"fmul_eo": per[True], "fmul": per[False]},
        "product_latency_ms": latency,
        "k1_chain": {"device_ms": k1_chain, "call_ms": k1_chain_call, "launches": products},
    }
    log(f"kernel mont_pow Fr ({B},16), e = r - 2 ({products} products): call {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {results['mont_pow']['bound_ms']:.6f} ms ({results['mont_pow']['bound_by']}); device ms per launch "
        f"fmul_eo {per[True]}, fmul {per[False]}; per product at batch 1: fmul_eo {latency['fmul_eo'] * 1e3:.4f} us, "
        f"fmul {latency['fmul'] * 1e3:.4f} us; the same chain as {products} K1 launches: device {k1_chain} ms, "
        f"call {k1_chain_call:.4f} ms")
    return results


def poseidon_products(spec) -> int:
    """Montgomery products of one sparse-form permutation: a full round t
    S-boxes of 3 and the t x t matrix, a partial round one S-box, the row's
    t products and the column's t - 1."""
    return spec.r_f * spec.t * (3 + spec.t) + spec.r_p * (3 + 2 * spec.t - 1)


def phase_kernels_poseidon(torch, dev, rng, results_field):
    """K10 ``poseidon_perm`` against ``permutation_plain``, bit for bit: at
    (1820, 5) and (1, 5) rows and batch shape (), with 0-4 inputs, with
    expanded (stride-0) inputs and state and with inputs broadcast over the
    rows; against the python-int oracle on three rows; its device ms per
    launch at 1820 rows and one row's launch less an empty launch, beside
    its bound and its critical path (``POSEIDON_LEVELS`` x rounds product
    latencies)."""
    from snark_verifier_tpu_torch.ops import field as F
    from snark_verifier_tpu_torch.ops import poseidon as P
    from snark_verifier_tpu_torch.util import poseidon as PO

    spec = PO.default_spec()
    t = spec.t

    def fr(n):
        vals = [rng.randrange(F.FR.modulus) for _ in range(n)]
        return vals, torch.as_tensor(F.FR.encode(vals).astype("int64"), device=dev)

    sv, state = fr(B * t)
    iv, ins = fr(B * (t - 1))
    state, ins = state.reshape(B, t, 16), ins.reshape(t - 1, B, 16)
    cases = []
    for n in range(t):
        cases += [(f"({rows}, {t}) n={n}", state[:rows], [ins[k, :rows] for k in range(n)]) for rows in (B, 1)]
        cases.append((f"() n={n}", state[0], [ins[k, 0] for k in range(n)]))
        cases.append((f"({B}, {t}) expanded n={n}", state[0].expand(B, t, 16), [ins[k, 0].expand(B, 16) for k in range(n)]))
        cases.append((f"({B}, {t}) broadcast inputs n={n}", state, [ins[k, 0] for k in range(n)]))
    for what, st, inputs in cases:
        got, want = P.poseidon_perm(spec, st, inputs), P.permutation_plain(spec, st, inputs)
        torch.cuda.synchronize()
        require(got.shape == want.shape and torch.equal(got, want), f"poseidon_perm {what}: != plain")
    full = [ins[k] for k in range(t - 1)]
    got = P.poseidon_perm(spec, state[:3], [x[:3] for x in full])
    for b in range(3):
        want = PO.permutation(spec, sv[b * t:(b + 1) * t], [iv[k * B + b] for k in range(t - 1)])
        require([int(v) for v in F.FR.decode(got[b])] == want, f"poseidon_perm row {b}: != python-int oracle")
    log(f"kernel poseidon_perm: equal to plain at {len(cases)} cases ((B, 5) and (1, 5) rows, batch (), 0-4 inputs, "
        f"expanded and broadcast operands) and to the python-int oracle")

    products = poseidon_products(spec)
    latency = results_field["mont_pow"]["product_latency_ms"]["fmul_eo"]
    b = bound(B * (2 * t + t - 1) * FE_BYTES, products * B)
    ms = cuda_ms(torch, lambda: P.poseidon_perm(spec, state, full))
    per_launch = device_ms(torch, lambda: P.poseidon_perm(spec, state, full), reps=20)
    one = one_item_chain(torch, lambda: P.poseidon_perm(spec, state[:1], [x[:1] for x in full]), reps=20)
    _, plain_ms = timed_once(torch, lambda: P.permutation_plain(spec, state, full))
    levels = POSEIDON_LEVELS * (spec.r_f + spec.r_p)
    res = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "shape": {"rows": B, "t": t, "inputs": t - 1},
           **b, "device_ms": per_launch, "one_row": one, "products": products,
           "critical_path_ms": levels * latency, "products_ms": products * latency}
    log(f"kernel poseidon_perm ({B} rows, t={t}, {t - 1} inputs, {products} products a row): call {ms:.4f} ms, "
        f"device ms per launch {per_launch:.6f}, one row's launch less an empty one {one['chain_ms']:.6f} ms; plain "
        f"{plain_ms:.4f} ms; bound {b['bound_ms']:.6f} ms ({b['bound_by']}); critical path {levels} x "
        f"{latency * 1e3:.4f} us = {levels * latency:.6f} ms; all {products} products on one chain "
        f"{products * latency:.6f} ms")
    return res


def host_aten_ops(torch, fn) -> int:
    """Host aten ops of one call of ``fn``, by torch.profiler's CPU events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events() if e.name().startswith("aten::"))


def keccak_bound(rows: int, length: int) -> dict:
    """The least time the card could take for K11 on (rows, length): the
    larger of the bytes (8 per input byte, 256 per output row) over HBM
    bandwidth and the 32-bit integer ops of its rounds over the INT32 rate."""
    t_bytes = (rows * length * 8 + rows * 32 * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = rows * (length // 136 + 1) * 24 * KECCAK_OPS_PER_ROUND / INT32_MULS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_kernels_keccak(torch, dev, rng):
    """K11 ``keccak256_cuda`` against ``keccak256_plain``, bit for bit, at
    1820 rows of each of the Keccak verify's lengths and the padding's edges
    (0, 135, 136, 137 bytes), on an expanded (stride-0) input, a batch of
    rank 2 and batch shape (); three rows of each length against the
    python-int oracle (util/keccak.py); its call and device ms per launch at
    each verify length and their sum over the verify's 7 hashes, one row's
    launch less an empty launch (its critical path: one thread's chain),
    beside its bound; the plain version's time at the longest hash; the host
    aten ops of the verify's 7 hashes, plain and K11 (torch.profiler)."""
    from snark_verifier_tpu_torch.ops import keccak as K
    from snark_verifier_tpu_torch.util.keccak import keccak256 as oracle

    gen = torch.Generator().manual_seed(rng.randrange(1 << 31))
    inputs = {}
    for length in sorted(set(KECCAK_VERIFY_LENGTHS + KECCAK_EDGE_LENGTHS)):
        data = torch.randint(0, 256, (B, length), generator=gen).to(dev)
        got, want = K.keccak256_cuda(data, length), K.keccak256_plain(data, length)
        torch.cuda.synchronize()
        require(got.shape == (B, 32) and torch.equal(got, want), f"keccak256 length {length}: != plain")
        for r in (0, B // 2, B - 1):
            require(bytes(got[r].tolist()) == oracle(bytes(data[r].tolist())),
                    f"keccak256 length {length} row {r}: != python-int oracle")
        inputs[length] = data
    longest = max(KECCAK_VERIFY_LENGTHS)
    data = inputs[longest]
    want = K.keccak256_plain(data, longest)
    require(torch.equal(K.keccak256_cuda(data[0].expand(B, longest), longest), want[0].expand(B, 32)),
            "keccak256 expanded input: != plain")
    require(torch.equal(K.keccak256_cuda(data.reshape(2, B // 2, longest), longest), want.reshape(2, B // 2, 32)),
            "keccak256 rank-2 batch: != plain")
    require(torch.equal(K.keccak256_cuda(data[0], longest), want[0]), "keccak256 batch (): != plain")
    log(f"kernel keccak256: equal to plain at {B} rows of {len(inputs)} lengths {sorted(inputs)}, on an expanded "
        f"input, a rank-2 batch and batch (), and to the python-int oracle on 3 rows of each length")

    by_length = {}
    for length in sorted(set(KECCAK_VERIFY_LENGTHS)):
        d = inputs[length]
        by_length[length] = {"ms": cuda_ms(torch, lambda: K.keccak256_cuda(d, length)),
                             "device_ms": device_ms(torch, lambda: K.keccak256_cuda(d, length), reps=20),
                             **keccak_bound(B, length)}
    verify_ms = sum(by_length[n]["device_ms"] for n in KECCAK_VERIFY_LENGTHS)
    one = one_item_chain(torch, lambda: K.keccak256_cuda(data[:1], longest), reps=20)
    _, plain_ms = timed_once(torch, lambda: K.keccak256_plain(data, longest))
    host_ops = {name: host_aten_ops(torch, lambda: [fn(inputs[n], n) for n in KECCAK_VERIFY_LENGTHS])
                for name, fn in (("plain", K.keccak256_plain), ("k11", K.keccak256_cuda))}
    top = by_length[longest]
    res = {"max_abs_err": 0.0, "ms": top["ms"], "plain_ms": plain_ms, "shape": {"rows": B, "length": longest},
           **keccak_bound(B, longest), "device_ms": top["device_ms"], "one_row": one,
           "critical_path_ms": one["chain_ms"], "by_length": by_length, "verify_device_ms": verify_ms,
           "verify_host_aten_ops": host_ops}
    lengths = ", ".join(f"{n} B: call {r['ms']:.4f}, device {r['device_ms']:.6f}, bound {r['bound_ms']:.6f} "
                        f"({r['bound_by']})" for n, r in by_length.items())
    log(f"kernel keccak256 ({B} rows; ms): {lengths}; the verify's 7 hashes {verify_ms:.6f} ms of device time; one "
        f"row's launch less an empty one {one['chain_ms']:.6f} ms at {longest} B; plain {plain_ms:.4f} ms at "
        f"{longest} B; host aten ops of the 7 hashes: plain {host_ops['plain']}, K11 {host_ops['k11']}")
    return res


def scan_sweep(torch, table, digits, want):
    """K4's one launch parameter, proofs per block (1-8), at each batch of
    ``SCAN_SWEEP_BATCHES`` (the first b proofs of config 1's MSM): every
    geometry bit-equal to the checked output, its ms, and the geometry
    ``scan_geometry`` picks against the sweep's best."""
    from snark_verifier_tpu_torch.ops import msm_cuda as MK

    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    sweep, picks = {}, {}
    for b in SCAN_SWEEP_BATCHES:
        tb, db = table[:, :, :, :b].contiguous(), digits[:b].contiguous()
        row = {}
        for per_block in range(1, MK.MAX_PROOFS_PER_BLOCK + 1):
            out = MK.msm_scan(tb, db, proofs_per_block=per_block)
            torch.cuda.synchronize()
            require(all(torch.equal(g, w[:b]) for g, w in zip(out, want)),
                    f"msm_scan B={b}, {per_block} proofs per block: kernel != plain")
            row[per_block] = round(cuda_ms(torch, lambda: MK.msm_scan(tb, db, proofs_per_block=per_block)), 4)
        ppb, grid = MK.scan_geometry(b, sms)
        best = min(row, key=row.get)
        sweep[b] = row
        picks[b] = {"rule": ppb, "best": best, "rule_over_best": row[ppb] / row[best]}
        log(f"kernel msm_scan sweep at B={b}: ms by proofs per block {row}; best {best}; the rule's {ppb} "
            f"({grid} blocks) {row[ppb] / row[best]:.3f}x the best")
    return sweep, picks


def phase_kernels_windowed(torch, dev, msm_case):
    """K8 and K9 against their plain versions on the card at K4's shape (B =
    1820 proofs, n = 18, tables from the K2/K3 ladder, seeded digits), and
    the 64-window MSM they make against K4 and the oracle."""
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import msm_cuda as MK
    from snark_verifier_tpu_torch.util import bn254

    table, digits, k4_out, scal, ps = msm_case
    results = {}
    w = 31  # a middle window: digits spread over [-8, 8]
    dig_w, dig_next = digits[..., w].contiguous(), digits[..., w + 1].contiguous()
    err = window_cases(torch, table, dig_w, f"B={B}, n={N_TERMS}")
    got = MK.msm_window(table, dig_w)
    dl = dig_w.tolist()
    for row in range(3):
        want_aff = bn254.g1_msm([d % bn254.R for d in dl[row]], ps[row * N_TERMS:(row + 1) * N_TERMS])
        require(C.g1_to_affine_ints(C.G1(*(c[row:row + 1] for c in got))) == [want_aff], "msm_window: kernel != oracle")
    ms, plain_ms = cuda_ms(torch, lambda: MK.msm_window(table, dig_w)), cuda_ms(torch, lambda: MK.msm_window_plain(table, dig_w))
    # the entries the digits select (3 coordinates each), the digits (half a byte), the outputs
    results["msm_window"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             **bound((3 * B * N_TERMS + 3 * B) * FE_BYTES + B * N_TERMS // 2,
                                     (N_TERMS - 1) * MONT_PER["add"] * B), **window_turns(torch, table, dig_w)}
    log(f"kernel msm_window (B={B}, n={N_TERMS}, window {w}): equal to plain with forced first digits too, and to "
        f"the oracle; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, device ms per launch "
        f"{results['msm_window']['device_ms']:.6f}, one proof's chain {results['msm_window']['chain_ms']:.6f}, "
        f"bound {results['msm_window']['bound_ms']:.6f} ms ({results['msm_window']['bound_by']})")

    acc = MK.msm_window(table, dig_next)  # a projective accumulator (z != 1)
    contrib = MK.msm_window(table, dig_w)
    err = horner_cases(torch, acc, contrib, f"B={B}")
    got = MK.msm_horner(acc, contrib)
    a, c = C.g1_to_affine_ints(C.G1(*(t[:3] for t in acc))), C.g1_to_affine_ints(C.G1(*(t[:3] for t in contrib)))
    require(C.g1_to_affine_ints(C.G1(*(t[:3] for t in got))) == [bn254.g1_add(bn254.g1_mul(x, 16), y) for x, y in zip(a, c)],
            "msm_horner: kernel != oracle")
    results["msm_horner"] = horner_result(torch, acc, contrib, err)
    log(f"kernel msm_horner (B={B}): equal to plain (projective, identity acc and contrib, contrib = +-16 acc) and "
        f"the oracle; {horner_summary(results['msm_horner'])}")

    # the whole two-kernel MSM (64 windows: 64 launches of each) against K4 and the oracle
    two = MK.msm_windowed(table, digits)
    torch.cuda.synchronize()
    require(all(torch.equal(t, k) for t, k in zip(two, k4_out)), "two-kernel MSM != K4")
    for row in range(3):
        want_aff = bn254.g1_msm(scal[row * N_TERMS:(row + 1) * N_TERMS], ps[row * N_TERMS:(row + 1) * N_TERMS])
        require(C.g1_to_affine_ints(C.G1(*(t[row:row + 1] for t in two))) == [want_aff], "two-kernel MSM != oracle")
    two_ms = cuda_ms(torch, lambda: MK.msm_windowed(table, digits))
    k4_ms = cuda_ms(torch, lambda: MK.msm_scan(table, digits))
    log(f"two-kernel MSM (B={B}, n={N_TERMS}, 64 windows, 128 launches): equal to K4 limb for limb and the oracle; "
        f"{two_ms:.4f} ms against K4's {k4_ms:.4f} ms in this call ({two_ms / k4_ms:.2f}x)")
    results["msm_window"]["two_kernel_msm_ms"] = two_ms
    results["msm_window"]["k4_msm_ms"] = k4_ms
    return results


def fq12_ints(flat, i):
    """Element i of a flat (12, B, 16) Fq12 tensor as the oracle's tuple tree."""
    from snark_verifier_tpu_torch.ops import field as F

    v = F.FQ.decode(flat[:, i:i + 1])
    return tuple(tuple((int(v[l * 6 + j * 2][0]), int(v[l * 6 + j * 2 + 1][0])) for j in range(3)) for l in range(2))


def phase_kernels_decide(torch, dev, rng, results_field):
    """K5, K6 and K7 against their plain versions on the card, same inputs,
    at the decide's shapes (and K7's single product also at a width that
    fills the card, its pairing kernels also at the outer snark's batch).
    ``results_field`` holds the product latency K6's critical path uses."""
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import pairing as PAIR
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import field as F
    from snark_verifier_tpu_torch.ops import msm_cuda as MK
    from snark_verifier_tpu_torch.ops import tower as T
    from snark_verifier_tpu_torch.util import bn254

    results = {}
    pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(64)]

    # K5 at the fold's first tree level: 32 windows x 1024 pairs, random mask;
    # rows 0-3: identity + Q, P + P, P + (-P), P + identity
    n = 32 * 1024
    ps = [pool[rng.randrange(64)] for _ in range(n)]
    qs = [pool[rng.randrange(64)] for _ in range(n)]
    ps[0], qs[1], qs[2], qs[3] = None, ps[1], bn254.g1_neg(ps[2]), None
    p = C.g1_from_affine_ints(ps, dev)
    q = C.g1_from_affine_ints(qs, dev)
    r = C.g1_add(p, q)  # projective (z != 1) first operands
    r, q = (C.G1(*(c.reshape(32, 1024, 16) for c in t)) for t in (r, q))
    mask = torch.as_tensor([i < 4 or rng.random() < 0.5 for i in range(n)], device=dev).reshape(32, 1024)
    got, want = C.g1_add_select(mask, r, q), C.g1_add_select_plain(mask, r, q)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)), "g1_add_select: kernel != plain")
    sums = [bn254.g1_add(x, y) for x, y in zip(ps[:64], qs[:64])]
    m = mask.reshape(-1)[:64].tolist()
    want_aff = [bn254.g1_add(s, y) if k else s for s, y, k in zip(sums, qs[:64], m)]
    require(C.g1_to_affine_ints(C.G1(*(c.reshape(-1, 16)[:64] for c in got))) == want_aff,
            "g1_add_select: kernel != oracle")
    ms = cuda_ms(torch, lambda: C.g1_add_select(mask, r, q))
    plain_ms = cuda_ms(torch, lambda: C.g1_add_select_plain(mask, r, q))
    results["g1_add_select"] = {"max_abs_err": max_abs_err(torch, got, want), "ms": ms, "plain_ms": plain_ms,
                                **bound(9 * n * FE_BYTES + n, MONT_PER["add"] * n)}
    log(f"kernel g1_add_select (32 x 1024 pairs): equal to plain and oracle; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")

    # K6 at nwin = 32 (window 8, the decide's: batch 2, its two MSMs in one
    # launch) and 24 (window 11, the signed 2^20 MSM's), batch 1 and 2
    latency = results_field["mont_pow"]["product_latency_ms"]["fmul_eo"]
    by_batch = {}
    for nwin, window in HORNER_SHAPES:
        pts = [pool[rng.randrange(64)] for _ in range(2 * nwin)]
        tot = C.G1(*(c.reshape(2, nwin, 16) for c in C.g1_double(C.g1_from_affine_ints(pts, dev))))
        want, plain_ms = timed_once(torch, lambda: MK.horner_combine_plain(tot, window))  # ~4 s
        want_aff = [bn254.g1_msm([2 << (window * w) for w in range(nwin)], pts[i * nwin:(i + 1) * nwin]) for i in range(2)]
        require(C.g1_to_affine_ints(want) == want_aff, f"horner_combine_plain nwin={nwin}: != oracle")
        for batch in (1, 2):
            tb = C.G1(*(c[:batch].contiguous() for c in tot))
            got = MK.horner_combine(tb, window)
            torch.cuda.synchronize()
            require(all(torch.equal(g, w[:batch]) for g, w in zip(got, want)),
                    f"horner_combine nwin={nwin} batch {batch}: kernel != plain")
            by_batch[f"nwin_{nwin}_batch_{batch}"] = device_ms(torch, lambda: MK.horner_combine(tb, window), reps=5,
                                                               sleep_ms=5.0)
        log(f"kernel horner_combine (nwin={nwin}, window={window}): equal to plain and the oracle at batch 1 and 2; "
            f"device ms per launch {by_batch}; plain {plain_ms:.4f} ms (batch 2)")
        if window == 8:  # the decide's shape: one launch for both MSMs
            got = MK.horner_combine(tot, window)
            torch.cuda.synchronize()
            ms = cuda_ms(torch, lambda: MK.horner_combine(tot, window))
            ops = 2 * (nwin - 1) * (window * MONT_PER["double"] + MONT_PER["add"])  # the first step is onto the identity
            results["horner_combine"] = {
                "max_abs_err": max_abs_err(torch, got, want), "ms": ms, "plain_ms": plain_ms,
                "shape": {"batch": 2, "nwin": nwin, "window": window}, **bound(2 * 3 * (nwin + 1) * FE_BYTES, ops),
                # product levels on one warp's chain: 2 per doubling, 2 per add
                "critical_path_ms": nwin * (2 * window + 2) * latency, "product_levels": nwin * (2 * window + 2),
            }
    results["horner_combine"]["device_ms"] = by_batch

    # K7 at B = 2 (the Miller loop's doubled batch) and 4096 (a full card)
    def rand_fq12(batch):
        vals = [[rng.randrange(bn254.P) for _ in range(batch)] for _ in range(12)]
        return vals, torch.as_tensor(F.FQ.encode(vals).astype("int64"), device=dev)

    for batch in (2, 4096):
        (va, a), (vb, b) = rand_fq12(batch), rand_fq12(batch)
        got, want = T.fq12_mul_flat(a, b), T.fq12_mul_flat_plain(a, b)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"fq12_mul B={batch}: kernel != plain")
        dec = F.FQ.decode(got[:, :2])

        def tree(v, i):
            return tuple(tuple((v[l * 6 + j * 2][i], v[l * 6 + j * 2 + 1][i]) for j in range(3)) for l in range(2))

        for i in range(2):
            require(tree(dec, i) == bn254.fq12_mul(tree(va, i), tree(vb, i)), f"fq12_mul B={batch}: kernel != oracle")
        ms = cuda_ms(torch, lambda: T.fq12_mul_flat(a, b))
        plain_ms = cuda_ms(torch, lambda: T.fq12_mul_flat_plain(a, b))
        res = {"max_abs_err": max_abs_err(torch, [got], [want]), "ms": ms, "plain_ms": plain_ms,
               **bound(3 * 12 * batch * FE_BYTES, MONT_PER["fq12"] * batch)}
        log(f"kernel fq12_mul (B={batch}): equal to plain and oracle; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {res['bound_ms']:.6f} ms ({res['bound_by']})")
        if batch == 2:
            results["fq12_mul"] = res
        else:
            results["fq12_mul"]["wide"] = {"batch": batch, **{k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}

    # K7's Miller-loop kernel on random points, then its final-exponentiation
    # kernel on the loop's values (at B = 8 with an identity lhs, an identity
    # rhs and both in rows 1-3), at the decide's batch and the outer snark's
    fx = E.fixture(E.K, "gwc")
    q1, q2 = fx.dk.g2, bn254.g2_neg(fx.dk.s_g2)
    miller_products, final_products = pairing_mont_products()
    steps = len(PAIR._line_constants(PAIR._g2_key(q1)))
    for batch in PAIRING_BATCHES:
        pts = [pool[rng.randrange(64)] for _ in range(2 * batch)]
        aff = C.g1_from_affine_ints(pts, dev)
        args = (aff.x[:batch], aff.y[:batch], aff.x[batch:], aff.y[batch:], q1, q2)
        got = PAIR.miller_loop_pair(*args)
        want, plain_ms = timed_once(torch, lambda: PAIR.miller_loop_pair_plain(*args))
        require(all(torch.equal(g, w) for g, w in zip(got, want)), f"miller_loop B={batch}: kernel != plain")
        require(fq12_ints(got[0], 0) == bn254.miller_loop(pts[0], q1)
                and fq12_ints(got[1], batch - 1) == bn254.miller_loop(pts[-1], q2), f"miller_loop B={batch}: kernel != oracle")
        ms = cuda_ms(torch, lambda: PAIR.miller_loop_pair(*args))
        nbytes = (2 * 2 * batch + 2 * steps * 2 * 2 + 12 * 2 * batch) * FE_BYTES + steps  # points, tape, output
        res = {"max_abs_err": max_abs_err(torch, got, want), "ms": ms, "plain_ms": plain_ms,
               **bound(nbytes, 2 * batch * miller_products)}
        log(f"kernel miller_loop (B={batch}, doubled to {2 * batch}, {steps} steps): equal to plain and oracle; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {res['bound_ms']:.6f} ms ({res['bound_by']})")
        if batch == PAIRING_BATCHES[0]:
            results["miller_loop"] = res
        else:
            results["miller_loop"][f"at_batch_{batch}"] = {k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

        f1, f2 = got
        lhs_inf = torch.tensor([i in (1, 3) for i in range(batch)], device=dev)
        rhs_inf = torch.tensor([i in (2, 3) for i in range(batch)], device=dev)
        out = PAIR.final_exponentiation(f1, f2, lhs_inf, rhs_inf)
        want, plain_ms = timed_once(torch, lambda: PAIR.final_exponentiation_plain(f1, f2, lhs_inf, rhs_inf))
        require(torch.equal(out, want), f"final_exp B={batch}: kernel != plain")
        chain = bn254.final_exponentiation_chain(bn254.fq12_mul(fq12_ints(f1, 0), fq12_ints(f2, 0)))
        require(fq12_ints(out, 0) == chain, f"final_exp B={batch}: kernel != oracle")
        if batch > 3:
            require(fq12_ints(out, 3) == bn254.FQ12_ONE, f"final_exp B={batch}: two identity inputs must give one")
        ms = cuda_ms(torch, lambda: PAIR.final_exponentiation(f1, f2, lhs_inf, rhs_inf))
        nbytes = (3 * 12 * batch + 2 * 6 * 2) * FE_BYTES + 2 * batch  # f1, f2, output, Frobenius table, masks
        res = {"max_abs_err": max_abs_err(torch, [out], [want]), "ms": ms, "plain_ms": plain_ms,
               **bound(nbytes, batch * final_products)}
        log(f"kernel final_exp (B={batch}): equal to plain and oracle; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {res['bound_ms']:.6f} ms ({res['bound_by']})")
        if batch == PAIRING_BATCHES[0]:
            results["final_exp"] = res
        else:
            results["final_exp"][f"at_batch_{batch}"] = {k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    return results


def add_operands(C, P2, R2, Q2, n):
    """K2/K5's operand kinds at ``n`` adds, from (2 * top, 16) point tensors:
    affine and projective first operands, the bucket tree's strided slices
    ((rows, 2m)[:, 1::2] against [:, 0::2]; 1-D [1::2] where n is no multiple
    of 32), g1_tree_sum's ((2m, 32)[1::2] against [0::2]), and one point
    broadcast (stride 0) as the second operand."""
    def cut(pt, sl):
        return C.G1(*(c[sl] for c in pt))

    q = cut(Q2, slice(0, n))
    kinds = {"affine": (cut(P2, slice(0, n)), q), "projective": (cut(R2, slice(0, n)), q),
             "broadcast": (cut(R2, slice(0, n)), cut(Q2, slice(5, 6)))}
    if n % 32 == 0:
        def tree(pt, start):
            return C.G1(*(c[:2 * n].reshape(32, 2 * n // 32, 16)[:, start::2] for c in pt))

        def rows(pt, start):
            return C.G1(*(c[:2 * n].reshape(2 * n // 32, 32, 16)[start::2] for c in pt))

        kinds["strided_tree"] = (tree(R2, 1), tree(Q2, 0))
        kinds["strided_rows"] = (rows(R2, 1), rows(Q2, 0))
    else:
        kinds["strided_tree"] = (cut(R2, slice(1, 2 * n, 2)), cut(Q2, slice(0, 2 * n, 2)))
    return kinds


def phase_kernels_add(torch, dev, rng, results_field):
    """K2 and K5, one point add on a group of 8 lanes reading two element
    strides, against their plain versions bit for bit at every width of
    ``ADD_WIDTHS``, with each operand kind of ``add_operands`` (K5 with masks
    all true, all false and random, and one broadcast along a batch dim),
    none of the strided or broadcast operands copied; against the oracle on
    64 points.  Then device ms per launch at each width, and the chain of
    one add (``one_item_chain``)."""
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.util import bn254

    top = max(ADD_WIDTHS)
    pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(64)]
    ps = [pool[rng.randrange(64)] for _ in range(2 * top)]
    qs = [pool[rng.randrange(64)] for _ in range(2 * top)]
    ps[0], qs[1], qs[2], qs[3] = None, ps[1], bn254.g1_neg(ps[2]), None
    P2, Q2 = C.g1_from_affine_ints(ps, dev), C.g1_from_affine_ints(qs, dev)
    R2 = C.g1_add_plain(P2, Q2)  # projective first operands (z != 1)

    # the oracle on 64 points: P + Q, (P + Q) + Q, and K5's select
    def first(pt):
        return C.G1(*(c[:64] for c in pt))

    m64 = torch.tensor([i % 3 != 1 for i in range(64)], device=dev)
    sums = [bn254.g1_add(x, y) for x, y in zip(ps[:64], qs[:64])]
    require(C.g1_to_affine_ints(C.g1_add(first(P2), first(Q2))) == sums, "g1_add (lanes): != oracle")
    require(C.g1_to_affine_ints(C.g1_add(first(R2), first(Q2))) == [bn254.g1_add(s, y) for s, y in zip(sums, qs)],
            "g1_add (lanes), projective first operand: != oracle")
    require(C.g1_to_affine_ints(C.g1_add_select(m64, first(P2), first(Q2))) ==
            [s if k else x for s, x, k in zip(sums, ps, m64.tolist())], "g1_add_select (lanes): != oracle")

    checked = 0
    for n in ADD_WIDTHS:
        for kind, (p, q) in add_operands(C, P2, R2, Q2, n).items():
            batch = tuple(torch.broadcast_shapes(p.x.shape[:-1], q.x.shape[:-1]))
            full = batch + (16,)
            masks = {"all_true": torch.ones(batch, dtype=torch.bool, device=dev),
                     "all_false": torch.zeros(batch, dtype=torch.bool, device=dev),
                     "random": torch.rand(batch, device=dev) < 0.5,
                     "broadcast": (torch.arange(batch[0], device=dev) % 3 != 1).reshape(-1, *([1] * (len(batch) - 1)))}
            ins = [c.expand(full) for c in (*p, *q)]
            kept, _, _, _, _ = C.point_operands(ins, masks["broadcast"].expand(batch), batch)
            require(all(a is b for a, b in zip(kept, ins)), f"K2/K5 n={n} {kind}: an operand was copied")
            want = C.g1_add_plain(p, q)
            require(all(torch.equal(g, w) for g, w in zip(C.g1_add(p, q), want)), f"g1_add n={n} {kind}: != plain")
            for mname, m in masks.items():
                want = C.g1_add_select_plain(m, p, q)
                got = C.g1_add_select(m, p, q)
                require(all(torch.equal(g, w) for g, w in zip(got, want)),
                        f"g1_add_select n={n} {kind} mask {mname}: != plain")
                checked += 1
            torch.cuda.synchronize()
    log(f"kernels g1_add / g1_add_select (lanes): equal to plain at widths {ADD_WIDTHS} with affine, projective, "
        f"strided and broadcast operands (none copied), {checked} K5 cases with masks all true, all false, random and "
        f"broadcast; both equal to the oracle on 64 points")

    latency = results_field["mont_pow"]["product_latency_ms"]
    out = {"g1_add": {}, "g1_add_select": {}}
    for n in ADD_WIDTHS:
        p, q = C.G1(*(c[:n] for c in R2)), C.G1(*(c[:n] for c in Q2))
        m = torch.rand(n, device=dev) < 0.5
        for name, cond in (("g1_add", None), ("g1_add_select", m)):
            ms = device_ms(torch, lambda: C.add_points(cond, p, q), reps=50)
            b = bound(9 * n * FE_BYTES + (n if cond is not None else 0), MONT_PER["add"] * n)
            out[name][n] = {"device_ms": ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
            log(f"kernel {name} n={n}: device ms per launch {ms:.6f}; bound {b['bound_ms']:.6f} ms ({b['bound_by']})")
    # the chain of one add: a launch of one group less an empty launch, in turns
    one_p, one_q, one_m = C.G1(*(c[:1] for c in R2)), C.G1(*(c[:1] for c in Q2)), torch.ones(1, dtype=torch.bool, device=dev)
    for name, cond in (("g1_add", None), ("g1_add_select", one_m)):
        chain = one_item_chain(torch, lambda: C.add_points(cond, one_p, one_q))  # noqa: B023
        log(f"kernel {name}: one add's launch less an empty launch {chain} ms (device_ms, in turns); products alone "
            f"2 x fmul_eo {2 * latency['fmul_eo']:.6f} ms")
        out[name] = {"by_width": out[name], "block": C.ADD_BLOCK, "group_lanes": C.GROUP, "one_add": chain,
                     "critical_path_ms": chain["chain_ms"], "products_on_chain_ms": 2 * latency["fmul_eo"]}
    return out


def add_launch_recorder(C):
    """Wrap ``curve.add_points`` to record the width of every K2/K5
    launch (it launches nothing of its own), and ``point_operands`` to record
    how each call's operands fold at the last batch dim: how many reach the
    kernel as they are, and the layout of each one copied.  Returns (record,
    restore)."""
    rec = {"g1_add": [], "g1_add_select": [], "folds": {"calls": 0, "folded": 0, "copied": []}}
    launch, fold = C.add_points, C.point_operands

    def recording(cond, p, q, *a, **k):
        out, n = launch(cond, p, q, *a, **k)
        rec["g1_add" if cond is None else "g1_add_select"].append(n)
        return out, n

    def folding(ins, mask, batch):
        got = fold(ins, mask, batch)
        rec["folds"]["calls"] += 1
        for t, g in zip([*ins, mask], [*got[0], got[2]]):
            if t is None:
                continue
            if g.data_ptr() == t.data_ptr() and g.stride() == t.stride():
                rec["folds"]["folded"] += 1
            else:
                rec["folds"]["copied"].append({"batch": list(batch), "strides": list(t.stride())})
        return got

    C.add_points, C.point_operands = recording, folding

    def restore():
        C.add_points, C.point_operands = launch, fold

    return rec, restore


def fold_summary(folds: dict) -> str:
    copied = folds["copied"]
    return (f"of {folds['calls']} K2/K5 calls: {folds['folded']} folded at the last batch dim as they are, "
            f"{len(copied)} copied{(' ' + str(copied[:4])) if copied else ''}")


def wrappers():
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import field as F
    from snark_verifier_tpu_torch.ops import keccak as K
    from snark_verifier_tpu_torch.ops import msm_cuda as MK
    from snark_verifier_tpu_torch.ops import pairing as PAIR
    from snark_verifier_tpu_torch.ops import poseidon as P
    from snark_verifier_tpu_torch.ops import tower as T

    return {"mont_mul": F.mont_mul, "mont_pow": F.mont_pow, "g1_add": C.g1_add, "g1_double": C.g1_double,
            "msm_scan": MK.msm_scan, "g1_add_select": C.g1_add_select, "horner_combine": MK.horner_combine,
            "fq12_mul": T.fq12_mul_flat,
            "msm_window": MK.msm_window, "msm_horner": MK.msm_horner, "miller_loop": PAIR.miller_loop_pair,
            "final_exp": PAIR.final_exponentiation, "poseidon_perm": P.poseidon_perm, "keccak256": K.keccak256_cuda}


def count_launches(torch, run, required, absent=()):
    """Zero every kernel's count, run the path, read the counts; fail if a
    kernel in ``required`` was not launched or one in ``absent`` was.  Also
    counts the path's pairing checks, small MSMs and fixed-exponent chains
    (by wrapping ``kzg_pairing_check``, ``build_tables`` and
    ``field.pow_const``, through which ``field.inv`` goes; none launches
    anything of its own) and fails unless each pairing check made one launch
    of each of K7's pairing kernels and no single Fq12 product, each small MSM
    one K4 launch and none of K8 or K9, and each ``pow_const``/``inv`` one
    ``mont_pow`` launch."""
    from snark_verifier_tpu_torch.ops import field as F
    from snark_verifier_tpu_torch.ops import msm as M
    from snark_verifier_tpu_torch.ops import pairing as PAIR

    kernels = wrappers()
    for k in kernels.values():
        k.launches = 0
    calls = {"pairing_checks": 0, "small_msms": 0, "pow_chains": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    check, tables, pow_const = PAIR.kzg_pairing_check, M.build_tables, F.pow_const
    PAIR.kzg_pairing_check, M.build_tables = counted("pairing_checks", check), counted("small_msms", tables)
    F.pow_const = counted("pow_chains", pow_const)
    try:
        result = run()
        torch.cuda.synchronize()
    finally:
        PAIR.kzg_pairing_check, M.build_tables, F.pow_const = check, tables, pow_const
    launches = {name: k.launches for name, k in kernels.items()}
    for name in required:
        require(launches[name] > 0, f"{name} was not launched by the main path")
    for name in absent:
        require(launches[name] == 0, f"{name} was launched where it must not be")
    checks, msms, chains = calls["pairing_checks"], calls["small_msms"], calls["pow_chains"]
    require(launches["fq12_mul"] == 0 and all(launches[k] == checks for k in PAIRING_KERNELS)
            and sum(launches[k] for k in PAIRING_KERNELS) <= 3 * checks,
            f"K7 launches {[launches[k] for k in ('fq12_mul', *PAIRING_KERNELS)]} for {checks} pairing checks")
    require(launches["msm_scan"] == msms and launches["msm_window"] == launches["msm_horner"] == 0,
            f"K4/K8/K9 launches {[launches[k] for k in ('msm_scan', 'msm_window', 'msm_horner')]} "
            f"for {msms} small MSMs")
    require(launches["mont_pow"] == chains, f"{launches['mont_pow']} mont_pow launches for {chains} pow_const/inv calls")
    log(f"path: {checks} pairing checks ({launches['miller_loop']} + {launches['final_exp']} K7 launches, "
        f"{launches['fq12_mul']} single Fq12 products), {msms} small MSMs ({launches['msm_scan']} K4 launches), "
        f"{chains} pow_const/inv chains ({launches['mont_pow']} mont_pow launches), {launches['mont_mul']} K1 launches")
    return result, {**launches, **calls}


def check_against_native(out, fx, rows, proofs, instances):
    from snark_verifier_tpu_torch.entry import native_accumulator
    from snark_verifier_tpu_torch.parallel.batch import decode_accumulator

    accs = {}
    for row in rows:
        acc = decode_accumulator(out, row)
        require(acc == native_accumulator(fx, proofs[row], instances[row]), f"row {row}: accumulator != native")
        accs[row] = acc
    return accs


def warm_times(torch, fn, args, reps: int = 5):
    """Host-clock seconds of ``reps`` synchronised calls (the caller has made
    the first call): their median and the list."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def phase_poseidon(torch, dev, card):
    """1820 Poseidon-transcript proofs of the k=8 circuit: accumulators equal
    the native verifier's, ``ok`` False exactly on the corrupted rows;
    timed, and profiled with the Poseidon permutations and point reads as
    named ranges."""
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.ops import poseidon as P
    from snark_verifier_tpu_torch.parallel.batch import pack_instances, pack_proofs
    from snark_verifier_tpu_torch.system.halo2 import transcript_torch as TT

    fx = E.poseidon_fixture()
    fn, _ = E.entry(dev, batch=B, transcript="poseidon")
    proofs = [fx.proofs[i % len(fx.proofs)] for i in range(B)]
    instances = [fx.instances[i % len(fx.proofs)] for i in range(B)]
    bad_rows, wrong_row = [B - 3, B - 2], B - 1
    proofs[bad_rows[0]] = E.corrupt_compressed(proofs[bad_rows[0]], 0, out_of_range=True)
    proofs[bad_rows[1]] = E.corrupt_compressed(proofs[bad_rows[1]], 32, out_of_range=False)
    instances[wrong_row] = [[instances[wrong_row][0][0] + 1]]
    args = (pack_proofs(proofs, dev), pack_instances(instances, dev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out, launches = count_launches(torch, lambda: fn(*args), POSEIDON_KERNELS, absent=("keccak256",))
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"poseidon first run: {first_s:.3f} s; launches {launches}")
    require(launches["poseidon_perm"] == POSEIDON_PERMS,
            f"poseidon: {launches['poseidon_perm']} K10 launches, not one per permutation ({POSEIDON_PERMS})")
    require(launches["mont_mul"] < POSEIDON_MAX_K1,
            f"poseidon: {launches['mont_mul']} K1 launches, not under {POSEIDON_MAX_K1}")
    ok = out["ok"].cpu().tolist()
    require(ok == [row not in bad_rows for row in range(B)],
            "poseidon: ok must be False exactly on the corrupted rows (x >= p, non-residue x)")
    good = [r for r in range(B) if r not in bad_rows and r != wrong_row]
    base = torch.as_tensor([r % len(fx.proofs) for r in good], device=dev)
    idx = torch.as_tensor(good, device=dev)
    for key in ("lhs_x", "lhs_y", "rhs_x", "rhs_y"):
        require(torch.equal(out[key][idx], out[key][base]), f"poseidon {key}: tiled rows disagree")
    accs = check_against_native(out, fx, list(range(len(fx.proofs))) + [wrong_row], proofs, instances)
    require(E.host_decide(fx, *accs[0]) is True and E.host_decide(fx, *accs[wrong_row]) is False,
            "poseidon: host oracle must decide the good row True and the wrong instance False")
    log(f"poseidon accumulators equal native for the {len(fx.proofs)} unique proofs and the wrong-instance row; "
        f"ok False exactly on rows {bad_rows} (x >= p, non-residue x); host oracle True / False")
    warm, times = warm_times(torch, fn, args, reps=3)
    log(f"poseidon warm verify (k=8, B={B}, GWC, Poseidon transcript): median {warm:.4f} s of "
        f"{[round(t, 4) for t in times]}, {B / warm:.1f} proofs/s, peak memory {peak / 2**20:.1f} MiB, "
        f"K1 launches {launches['mont_mul']}, K10 launches {launches['poseidon_perm']}, on {card}")

    from torch.profiler import record_function

    def ranged(name, f):
        def wrapper(*a, **k):
            with record_function(name):
                return f(*a, **k)
        return wrapper

    perm, read = P.permutation, TT.TorchPoseidonTranscript.read_ec_point
    P.permutation = ranged("poseidon_permutation", perm)
    TT.TorchPoseidonTranscript.read_ec_point = ranged("poseidon_point_read", read)
    try:
        per_launch, least = profile_run(torch, "poseidon", "poseidon_perm", fn, args, warm,
                                        ranges=("poseidon_permutation", "poseidon_point_read"))
    finally:
        P.permutation, TT.TorchPoseidonTranscript.read_ec_point = perm, read
    return launches, per_launch, least


def phase_aggregation(torch, dev, card):
    """The k=20 outer snark at B=8 through ``entry.aggregation_entry`` (both
    accumulators decided per proof).  Returns its launches, its profile and
    K4's operands of its first small MSM."""
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.ops import msm as M
    from snark_verifier_tpu_torch.parallel.batch import decode_accumulator

    fx = E.aggregation_fixture()
    t0 = time.perf_counter()
    want = E.native_accumulators(fx, fx.proofs[0], fx.instances[0])
    log(f"aggregation: k={fx.k} outer snark, {len(fx.proofs[0])}-byte Poseidon proof, "
        f"{len(fx.instances[0][0])} instances; native verify {time.perf_counter() - t0:.2f} s on the host")
    fn, args = E.aggregation_entry(AGG_BATCH)  # as a user calls it: device "cuda"
    bad = tuple(a.clone() for a in args)
    bad[0][1, 7] ^= 1  # one byte of the proof (row 1)
    bad[1][2, FLIPPED_LIMB, 0] ^= 1  # one bit of one instance limb (row 2)
    captured, scan_inputs = [], M.scan_inputs

    def capturing(*a, **k):  # keeps K4's operands of the path's small MSMs; launches nothing
        captured.append(scan_inputs(*a, **k))
        return captured[-1]

    M.scan_inputs = capturing
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches = count_launches(torch, lambda: fn(*args), AGG_KERNELS, ("msm_window", "msm_horner"))
        first_s = time.perf_counter() - t0
    finally:
        M.scan_inputs = scan_inputs
    require(launches["g1_double"] == AGG_DBL_LAUNCHES,
            f"aggregation: {launches['g1_double']} K3 launches, not {AGG_DBL_LAUNCHES}")
    require(len(captured) == launches["msm_scan"] > 0, "aggregation: every small MSM of the run must be captured")
    require(tuple(out["lhs_x"].shape) == (2, AGG_BATCH, 16), "aggregation: outputs must be (2, B, 16)")
    for row in range(AGG_BATCH):
        got = [decode_accumulator({k: v[a] for k, v in out.items() if k != "ok"}, row) for a in range(2)]
        require(got == want, f"aggregation row {row}: accumulators != native")
    require(out["ok"].all().item(), "aggregation: every proof must decide True")
    bad_ok = fn(*bad)["ok"].cpu().tolist()
    require(bad_ok == [r not in (1, 2) for r in range(AGG_BATCH)],
            f"aggregation: the mutated byte and the flipped limb must clear ok, got {bad_ok}")
    warm, times = warm_times(torch, fn, args, reps=2)
    log(f"aggregation: both accumulators equal native, decide True on all {AGG_BATCH} rows, mutated byte and "
        f"flipped limb rejected; first {first_s:.3f} s, warm median {warm:.4f} s of {[round(t, 4) for t in times]}; "
        f"launches {launches}, on {card}")
    per_launch, least = profile_run(torch, "aggregation", "msm_scan", fn, args, warm)
    return launches, per_launch, least, captured[0]


def phase_kernels_on_path(torch, table, digits):
    """K8 and K9 against their plain versions on the card, bit for bit, on
    K4's operands of the outer snark's first small MSM (captured in its
    run): one middle window, its Horner step (``horner_cases``:
    onto the identity, as the MSM's first window runs, onto a projective
    accumulator, and the add's edge cases); and K4 on the whole MSM against
    its plain version and K8/K9."""
    from snark_verifier_tpu_torch.ops import msm_cuda as MK

    _, _, n, batch, _ = table.shape
    got = MK.msm_scan(table, digits)
    want, plain_ms = timed_once(torch, lambda: MK.msm_scan_plain(table, digits))
    two = MK.msm_windowed(table, digits)
    torch.cuda.synchronize()
    require(all(torch.equal(g, w) for g, w in zip(got, want)), "msm_scan (outer snark's shape): kernel != plain")
    require(all(torch.equal(g, w) for g, w in zip(got, two)), "msm_scan (outer snark's shape): kernel != msm_windowed")
    ms = cuda_ms(torch, lambda: MK.msm_scan(table, digits))
    two_ms = cuda_ms(torch, lambda: MK.msm_windowed(table, digits))
    scan = {"max_abs_err": max_abs_err(torch, got, want), "ms": ms, "plain_ms": plain_ms, "shape": {"B": batch, "n": n},
            "two_kernel_msm_ms": two_ms, **bound((table.numel() // 16 + batch * n + 3 * batch) * FE_BYTES,
                                                 batch * scan_mont_products(n, digits.shape[-1])),
            **scan_chain(torch, table, digits)}
    log(f"kernel msm_scan (outer snark's MSM: B={batch}, n={n}): equal to plain and to msm_windowed (K8/K9); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {scan['bound_ms']:.6f} ms ({scan['bound_by']}); "
        f"the two-kernel MSM {two_ms:.4f} ms ({two_ms / ms:.2f}x)")
    w = MK.NWINDOWS // 2 - 1
    dig_w, dig_next = digits[..., w].contiguous(), digits[..., w + 1].contiguous()
    err = window_cases(torch, table, dig_w, f"outer snark's MSM: B={batch}, n={n}")
    contrib = MK.msm_window(table, dig_w)
    ms, plain_ms = cuda_ms(torch, lambda: MK.msm_window(table, dig_w)), cuda_ms(torch, lambda: MK.msm_window_plain(table, dig_w))
    results = {"msm_window": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": {"B": batch, "n": n},
                              **bound((3 * batch * n + 3 * batch) * FE_BYTES + batch * n // 2,
                                      (n - 1) * MONT_PER["add"] * batch), **window_turns(torch, table, dig_w)}}
    log(f"kernel msm_window (outer snark's MSM: B={batch}, n={n}, window {w}): equal to plain with forced first "
        f"digits too; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, device ms per launch "
        f"{results['msm_window']['device_ms']:.6f}, one proof's chain {results['msm_window']['chain_ms']:.6f}, "
        f"bound {results['msm_window']['bound_ms']:.6f} ms ({results['msm_window']['bound_by']})")

    acc = MK.msm_window(table, dig_next)  # a projective accumulator (z != 1)
    err = horner_cases(torch, acc, contrib, f"outer snark's MSM: B={batch}")
    results["msm_horner"] = {**horner_result(torch, acc, contrib, err), "shape": {"B": batch}}
    log(f"kernel msm_horner (outer snark's MSM: B={batch}): equal to plain (projective, from the identity, identity "
        f"contrib, contrib = +-16 acc); {horner_summary(results['msm_horner'])}")
    return results, scan


def phase_config4(torch, dev, card):
    """BASELINE config 4: the port's aggregate_native folds the four
    Poseidon snarks on the host; the card decides the fold and decodes the
    fold's 16 instance limbs back to its two points."""
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import pairing as PAIR
    from snark_verifier_tpu_torch.pcs.kzg.accumulator import accumulator_to_limbs
    from snark_verifier_tpu_torch.sdk import Snark
    from snark_verifier_tpu_torch.sdk.aggregation import aggregate_native

    fx = E.poseidon_fixture()
    t0 = time.perf_counter()
    agg = aggregate_native(fx.As, fx.svk, [Snark(fx.protocol, ins, p) for ins, p in zip(fx.instances, fx.proofs)])
    fold_s = time.perf_counter() - t0
    lhs, rhs = agg.accumulator.lhs.value, agg.accumulator.rhs.value
    require(agg.instances == accumulator_to_limbs(agg.accumulator) and len(agg.instances) == 16,
            "config 4: the fold's instances must be its accumulator's limbs")
    loader = TorchLoader((1,), dev)
    limbs = [loader.load_const(v) for v in agg.instances]
    decoded = [loader.ec_point_from_limbs(limbs[i:i + 8], 4, 68).value for i in (0, 8)]
    got = [C.g1_to_affine_ints(C.G1(*torch.broadcast_tensors(*p.as_proj())))[0] for p in decoded]
    require(got == [lhs, rhs] and loader.ok.tolist() == [True], "config 4: the limbs must decode to the fold on the card")
    gl, gr = C.g1_from_affine_ints([lhs], dev), C.g1_from_affine_ints([rhs], dev)

    def decide():
        return PAIR.kzg_pairing_check(gl, gr, fx.dk.g2, fx.dk.s_g2)

    ok, launches = count_launches(torch, decide, ("mont_mul", *PAIRING_KERNELS))
    require(ok.tolist() == [True], "config 4: the folded accumulator must decide True on the card")
    require(E.host_decide(fx, lhs, rhs) is True, "config 4: host oracle must decide the fold True")
    warm, times = warm_times(torch, decide, ())
    log(f"config 4: aggregate_native of 4 Poseidon snarks {fold_s:.3f} s on the host; 16 instance limbs decode to "
        f"the fold on the card; device decide True, warm median {warm:.4f} s of {[round(t, 4) for t in times]}; "
        f"launches {launches}, on {card}")


def phase_slice(torch, dev, card):
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.ops import curve as C
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    widths, restore = add_launch_recorder(C)
    try:
        out, launches = count_launches(torch, lambda: fn(*args), SLICE_KERNELS, absent=("poseidon_perm",))
    finally:
        restore()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"slice first run: {first_s:.3f} s; launches {launches}; K2 widths {widths['g1_add']}; operands "
        f"{fold_summary(widths['folds'])}")
    require(launches["mont_mul"] <= VERIFY_MAX_K1, f"slice: {launches['mont_mul']} K1 launches, above {VERIFY_MAX_K1}")
    require(all(launches[k] == v for k, v in VERIFY_ADD_LAUNCHES.items()),
            f"slice: K2 launches {launches['g1_add']}, not {VERIFY_ADD_LAUNCHES['g1_add']}")
    require(launches["g1_double"] == VERIFY_DBL_LAUNCHES,
            f"slice: K3 launches {launches['g1_double']}, not {VERIFY_DBL_LAUNCHES}")
    require(launches["keccak256"] == len(KECCAK_VERIFY_LENGTHS),
            f"slice: K11 launches {launches['keccak256']}, not one per hash ({len(KECCAK_VERIFY_LENGTHS)})")
    ADD_PATH_WIDTHS["verify"] = widths

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
    per_launch, least = profile_run(torch, "slice", "msm_scan", fn, args, warm)
    return launches, per_launch, least, out, wrong_row, warm


def _descendants(event):
    for child in event.cpu_children:
        yield child
        yield from _descendants(child)


def log_ranges(torch, label, events, ranges, busy_ms, host_ops) -> None:
    """Device time and host aten ops under each named record_function range,
    as shares of the profiled run's device busy time and host aten ops."""
    for name in ranges:
        hits = [e for e in events if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]
        dev_ms = sum(e.device_time_total for e in hits) / 1e3
        ops = sum(1 for e in hits for d in _descendants(e) if d.name.startswith("aten::"))
        host_ms = sum(e.cpu_time_total for e in hits) / 1e3
        log(f"{label} profile: {name}: {len(hits)} calls, device {dev_ms:.3f} ms = "
            f"{100 * dev_ms / busy_ms:.1f} % of the device busy time, {ops} host aten ops = "
            f"{100 * ops / max(host_ops, 1):.1f} % of them, {host_ms:.1f} ms of host time under the profiler")


def profile_run(torch, label, anchor, fn, args, warm_s: float, ranges=()) -> dict:
    """One warm run of ``fn`` under torch.profiler: device time by kernel,
    launch and host-op counts, and the device's busy share of the
    unprofiled warm wall time (one stream, so kernel times do not overlap).
    ``anchor`` is a kernel the run must show for the profile to count;
    ``ranges`` names record_function ranges whose shares are logged.
    Returns each hand-written kernel's mean device ms per launch in the run
    and the least device ms of any one launch of them (empty and None when
    the profiler recorded no ``anchor``)."""
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    if ranges:  # the ranges need the profiler's event tree, which takes minutes to build for a million ops
        events = prof.events()
        # a record_function range also appears on the device timeline, spanning
        # its kernels and the idle gaps between them: not a kernel, so left out
        device = [(e.name, e.device_time_total) for e in events if e.device_type == cuda and e.name not in ranges]
        host_ops = sum(1 for e in events if e.device_type == cpu and e.name.startswith("aten::"))
    else:  # the same events read raw, as the tree is built from them (and with the same names left out)
        raw = [e for e in prof.profiler.kineto_results.events() if e.name() not in UNLISTED_OPS]
        device = [(e.name(), e.duration_ns() / 1e3) for e in raw if e.device_type() == cuda]
        host_ops = sum(1 for e in raw if e.device_type() == cpu and e.name().startswith("aten::"))
    by = {}
    for name, us in device:
        key = next((k for k in KERNELS if f"{k}_kernel" in name), "plain torch")
        count, total = by.get(key, (0, 0.0))
        by[key] = (count + 1, total + us)
    if anchor not in by:  # the launch counters, not the profiler, prove the path
        log(f"{label} profile: the profiler recorded no {anchor} kernel; device busy share not measured")
        return {}, None
    busy_ms = sum(us for _, us in by.values()) / 1e3
    PROFILES[label] = {"busy_ms": busy_ms, "host_aten_ops": host_ops, "device_ops": len(device),
                       "by_kernel": {k: {"launches": c, "device_ms": us / 1e3} for k, (c, us) in by.items()}}
    ranked = sorted(by.items(), key=lambda kv: -kv[1][1])
    parts = ", ".join(f"{k} {c} launches {us / 1e3:.3f} ms" for k, (c, us) in ranked)
    log(f"{label} profile (one warm run): device busy {busy_ms:.3f} ms over {len(device)} device ops "
        f"= {100 * busy_ms / 1e3 / warm_s:.1f} % of the {warm_s:.4f} s warm wall; {host_ops} host aten ops; {parts}")
    if ranges:
        log_ranges(torch, label, events, ranges, busy_ms, host_ops)
    least = min(us for name, us in device if any(f"{k}_kernel" in name for k in KERNELS)) / 1e3
    return {k: us / c / 1e3 for k, (c, us) in by.items() if k in KERNELS}, least


def log_ptxas(path) -> dict:
    """Registers, stack and spills per kernel from the build log; returns
    them by kernel name (a template instance under its template argument)."""
    found = {}
    if not path.exists():  # the library existed: nothing was compiled in this run
        return found
    name = None
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in KERNELS if f"{k}_kernel" in line), None)
            variant = name and re.search(rf"{name}_kernel(I[^E]*E)?", line).group(1)
            if variant:  # a template argument (ILb1E: true)
                name = f"{name} ({variant})"
        elif name and ("spill" in line or "registers" in line):
            log(f"ptxas {name}: {line.strip()}")
            found.setdefault(name, []).append(line.strip())
            if "registers" in line:
                name = None
    return found


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


def phase_decide(torch, dev, card, out, wrong_row, verify_s):
    """The batch decide through ``entry.decide_entry``: the decider, the
    1820 accumulators of the config-1 batch and seeded fold scalars.  True
    on them, False with the slice's wrong-instance accumulator in place of
    one row; then build_verifier(decide_dk) on 8 proofs against the host
    oracle."""
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.parallel.batch import build_verifier, pack_instances, pack_proofs

    fx = E.fixture(E.K, "gwc")
    decider, good_args = E.decide_entry(dev, batch=B, seed=SEED)
    wrong_args = tuple(a.clone() for a in good_args)
    for a, key in zip(wrong_args, ("lhs_x", "lhs_y", "rhs_x", "rhs_y")):
        a[B // 2] = out[key][wrong_row]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    widths, restore = add_launch_recorder(C)
    try:
        ok, launches = count_launches(torch, lambda: decider(*good_args), DECIDE_KERNELS)
    finally:
        restore()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    require(ok.shape == () and bool(ok) is True, "decide: the good batch must decide True")
    require(all(launches[k] == v for k, v in DECIDE_ADD_LAUNCHES.items()),
            f"decide: K5 and K2 launches {launches['g1_add_select']} and {launches['g1_add']}, not "
            f"{DECIDE_ADD_LAUNCHES['g1_add_select']} and {DECIDE_ADD_LAUNCHES['g1_add']}")
    ADD_PATH_WIDTHS["decide"] = widths
    log(f"decide: K5 widths {widths['g1_add_select']}; K2 widths {widths['g1_add']}; operands "
        f"{fold_summary(widths['folds'])}")
    require(launches["horner_combine"] == 1, f"decide: {launches['horner_combine']} K6 launches, not one for both MSMs")
    require(launches["mont_mul"] <= DECIDE_MAX_K1 and launches["mont_pow"] <= DECIDE_MAX_POW,
            f"decide: {launches['mont_mul']} K1 and {launches['mont_pow']} mont_pow launches, above "
            f"{DECIDE_MAX_K1} and {DECIDE_MAX_POW}")
    require(bool(decider(*wrong_args)) is False, "decide: the wrong-instance row must make it False")
    log(f"decide (B={B}): good rows True, wrong-instance row folded in False; first run {first_s:.3f} s; "
        f"launches {launches}")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decider(*good_args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    warm = statistics.median(times)
    log(f"decide warm (fold of {B} accumulators + one pairing): median {warm:.4f} s of "
        f"{[round(t, 4) for t in times]}; verify + decide {B / (verify_s + warm):.1f} verified proofs/s "
        f"(verify {verify_s:.4f} s + decide {warm:.4f} s); peak memory {peak / 2**20:.1f} MiB, on {card}")
    per_launch, least = profile_run(torch, "decide", "final_exp", decider, good_args, warm)

    proofs = [fx.proofs[i % len(fx.proofs)] for i in range(DECIDE_PROOFS)]
    instances = [fx.instances[i % len(fx.proofs)] for i in range(DECIDE_PROOFS)]
    proofs[2] = E.corrupt(proofs[2])
    instances[5] = [[instances[5][0][0] + 1]]
    fn = build_verifier(fx.protocol, fx.As, fx.svk, device=dev, decide_dk=fx.dk)
    got = fn(pack_proofs(proofs, dev), pack_instances(instances, dev))["ok"].cpu().tolist()
    want = []
    for proof, ins in zip(proofs, instances):
        try:
            want.append(E.host_decide(fx, *E.native_accumulator(fx, proof, ins)))
        except Exception:  # the native transcript rejects the off-curve point
            want.append(False)
    require(got == want == [i not in (2, 5) for i in range(DECIDE_PROOFS)],
            f"build_verifier(decide_dk): ok {got} != host oracle {want}")
    log(f"build_verifier(decide_dk) on {DECIDE_PROOFS} proofs: ok {got} equals the host oracle")
    return launches, per_launch, least


def phase_msm(torch, dev, card, rng):
    """msm_serial at 2^16 (window 8) and 2^20 (window 11, signed): points a
    pool of 64 random multiples of G tiled, random Fr scalars; exact against
    the oracle via the per-pool-point scalar sums."""
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import msm as M
    from snark_verifier_tpu_torch.util import bn254

    pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(MSM_POOL)]
    pool_t = C.g1_from_affine_ints(pool, dev)
    for logn, window, signed in MSM_CASES:
        n = 1 << logn
        pts, scal, reduced = tiled_msm_input(torch, dev, pool_t, logn, SEED + logn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = M.msm_serial(pts, scal, window, signed)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        require(C.g1_to_affine_ints(C.G1(*(c[None] for c in out))) == [bn254.g1_msm(reduced, pool)],
                f"msm_serial 2^{logn}: != oracle")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.msm_serial(pts, scal, window, signed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        warm = statistics.median(times)
        log(f"msm_serial 2^{logn} (window {window}, {'signed' if signed else 'unsigned'}): equal to the oracle; "
            f"first {first_s:.4f} s, warm median {warm:.4f} s of {[round(t, 4) for t in times]} = "
            f"{n / warm:.1f} points/s; peak memory {peak / 2**20:.1f} MiB, on {card}")
        del pts, scal, out
        torch.cuda.empty_cache()


def ipa_openings(pk, rng, batch: int):
    """The IPA openings of the ipa_verify phase: one opening proved on the
    host, tiled to ``batch`` rows, with a wrong v in row ``IPA_WRONG_V`` and
    a corrupted byte of the first round's L point in row ``IPA_BAD_BYTE``;
    and each row's expected result from the native verifier (U, or None
    where it rejects the opening)."""
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.errors import AssertionFailure, TranscriptError
    from snark_verifier_tpu_torch.util import bn254

    c, z, v, proof = E.ipa_opening(pk, rng)
    bad = bytearray(proof)
    bad[(96 if pk.zk() else 0) + 10] ^= 0x40  # the first round's L, x coordinate
    kinds = {"good": (c, z, v, proof), "wrong_v": (c, z, (v + 1) % bn254.R, proof), "bad_byte": (c, z, v, bytes(bad))}
    expect = {}
    for kind, opening in kinds.items():
        try:
            expect[kind] = E.native_ipa_accumulator(pk.svk(), *opening)
        except (AssertionFailure, TranscriptError):
            expect[kind] = None
    rows = ["wrong_v" if i == IPA_WRONG_V else "bad_byte" if i == IPA_BAD_BYTE else "good" for i in range(batch)]
    return [kinds[k] for k in rows], [expect[k] for k in rows]


def phase_ipa_verify(torch, dev, card, rng):
    """The IPA opening verify and decide at K=10, B=64, zk off and on: a
    real opening proved on the host (``IpaProvingKey.rand``,
    ``Ipa.create_proof``) tiled, a wrong v in one row and a corrupted round
    point in another; ``build_ipa_verifier`` (``Ipa.read_proof`` +
    ``succinct_verify`` through ``TorchLoader`` and ``TorchEvmTranscript``,
    then ``IpaAs.decide`` through ``decide_ipa``): ``ok`` False exactly on
    those rows, U equal to the native verifier's on the good rows, one K6
    launch per decide."""
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.ops.limbs import limbs_to_int
    from snark_verifier_tpu_torch.parallel.batch import build_ipa_verifier
    from snark_verifier_tpu_torch.pcs.ipa import IpaProvingKey

    results = {}
    for zk in (False, True):
        label = "zk" if zk else "plain"
        t0 = time.perf_counter()
        pk = IpaProvingKey.rand(IPA_K, zk, seed=SEED + zk)
        openings, expect = ipa_openings(pk, rng, IPA_BATCH)
        host_s = time.perf_counter() - t0
        require(expect[IPA_WRONG_V] is None and expect[IPA_BAD_BYTE] is None and expect[0] is not None,
                f"ipa {label}: the native verifier must reject exactly the corrupted openings")
        fn = build_ipa_verifier(pk.svk(), pk.dk(), dev)
        args = E.pack_ipa_openings(openings, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out, launches = count_launches(torch, lambda: fn(*args), IPA_KERNELS)
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        ok = out["ok"].cpu().tolist()
        require(ok == [e is not None for e in expect], f"ipa {label}: ok {ok} must be False exactly on the corrupted rows")
        ux, uy = out["u_x"].cpu().numpy(), out["u_y"].cpu().numpy()
        for row in {0, IPA_BATCH - 1}:
            require((limbs_to_int(ux[row]), limbs_to_int(uy[row])) == expect[row],
                    f"ipa {label}: row {row}'s U != the native verifier's")
        require(launches["horner_combine"] == 1, f"ipa {label}: {launches['horner_combine']} K6 launches, not one")
        warm, times = warm_times(torch, fn, args)
        profile_run(torch, f"ipa_verify_{label}", "horner_combine", fn, args, warm)
        results[label] = {"first_s": first_s, "warm_s": warm, "peak_mib": peak / 2**20, "launches": launches,
                          "host_proof_s": host_s}
        log(f"ipa verify + decide (K={IPA_K}, B={IPA_BATCH}, {label}): ok False exactly on rows "
            f"{[IPA_WRONG_V, IPA_BAD_BYTE]} (wrong v, corrupted round point), U equal to native; keygen + proof on "
            f"the host {host_s:.1f} s; first run {first_s:.3f} s, warm median {warm:.4f} s of "
            f"{[round(t, 4) for t in times]}; peak memory {peak / 2**20:.1f} MiB; launches {launches}, on {card}")
    return results


def ipa_decide_oracle(pool, xi_rows, k: int):
    """Host: U = MSM(g, h(xi)) for generators ``pool`` tiled to 2^k.  The
    coefficient of index i is the product of xi[k - 1 - t] over the set bits
    t of i, so the coefficients of the indices = j mod 64 sum to
    h_low(j) * prod_{t >= 6} (1 + xi[k - 1 - t]): a 64-point MSM per row."""
    from snark_verifier_tpu_torch.util import bn254

    lb = len(pool).bit_length() - 1
    out = []
    for xi in xi_rows:
        high = 1
        for t in range(lb, k):
            high = high * (1 + xi[k - 1 - t]) % bn254.R
        coeffs = []
        for j in range(len(pool)):
            c = high
            for t in range(lb):
                if j >> t & 1:
                    c = c * xi[k - 1 - t] % bn254.R
            coeffs.append(c)
        out.append(bn254.g1_msm(coeffs, pool))
    return out


def phase_ipa_decide(torch, dev, card, rng):
    """The IPA decide at k=20 (2^20 generators: 64 random points tiled, as
    the large MSM's input), B=4 accumulators with random xi and U from the
    host oracle, row 3's U moved to U + G: ``decide_ipa`` True, True, True,
    False with one K6 launch; the generators' conversion, first call and
    warm times, peak memory."""
    from snark_verifier_tpu_torch.loader import EcPoint, Scalar
    from snark_verifier_tpu_torch.loader.torch_loader import TorchLoader, TorchPoint, dk_points
    from snark_verifier_tpu_torch.ops import field as F
    from snark_verifier_tpu_torch.ops.convert import ints_to_tensor
    from snark_verifier_tpu_torch.pcs.ipa import IpaAccumulator, IpaDecidingKey
    from snark_verifier_tpu_torch.util import bn254

    k, batch = IPA_DECIDE_K, IPA_DECIDE_BATCH
    pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(MSM_POOL)]
    dk = IpaDecidingKey(svk=None, g=pool * ((1 << k) // MSM_POOL))
    xi_rows = [[rng.randrange(1, bn254.R) for _ in range(k)] for _ in range(batch)]
    t0 = time.perf_counter()
    us = ipa_decide_oracle(pool, xi_rows, k)
    oracle_s = time.perf_counter() - t0
    us[-1] = bn254.g1_add(us[-1], bn254.G1_GEN)
    t0 = time.perf_counter()
    dk_points(dk, dev)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0

    def decide():
        loader = TorchLoader((batch,), dev)
        xi = [Scalar(loader, F.to_mont(ints_to_tensor([row[t] for row in xi_rows], dev), F.FR)) for t in range(k)]
        x, y = (torch.as_tensor(F.FQ.encode([u[i] for u in us]).astype("int64"), device=dev) for i in (0, 1))
        u = EcPoint(loader, TorchPoint(x, y, torch.zeros(batch, dtype=torch.bool, device=dev)))
        return loader.decide_ipa(IpaAccumulator(xi, u), dk)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mask, launches = count_launches(torch, decide, ("mont_mul", "g1_add", "g1_add_select", "horner_combine"))
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    require(mask.cpu().tolist() == [True] * (batch - 1) + [False],
            f"ipa decide k={k}: mask {mask.cpu().tolist()} != the host oracle's (last row U + G)")
    require(launches["horner_combine"] == 1, f"ipa decide k={k}: {launches['horner_combine']} K6 launches, not one")
    warm, times = warm_times(torch, decide, ())
    profile_run(torch, "ipa_decide_k20", "horner_combine", decide, (), warm)
    row = {"first_s": first_s, "warm_s": warm, "warm_runs_s": times, "convert_s": convert_s, "peak_mib": peak / 2**20,
           "launches": {n: launches[n] for n in ("mont_mul", "mont_pow", "g1_add", "g1_add_select", "horner_combine")}}
    log(f"ipa decide k={k} (B={batch}, 2^{k} generators, window 8): True on the 3 rows with U from the host oracle "
        f"({oracle_s:.2f} s), False with U + G; generators to the card {convert_s:.2f} s (once per key); first "
        f"decide {first_s:.3f} s, warm median {warm:.4f} s of {[round(t, 4) for t in times]}; peak memory "
        f"{peak / 2**20:.1f} MiB; launches K1 {launches['mont_mul']}, mont_pow {launches['mont_pow']}, K2 "
        f"{launches['g1_add']}, K5 {launches['g1_add_select']}, K6 {launches['horner_combine']}, on {card}")
    return row


def tiled_msm_input(torch, dev, pool_t, logn: int, seed: int):
    """2^logn points (the pool tiled) and random Fr scalars, and the oracle's
    per-pool-point scalar sums."""
    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.util import bn254

    n = 1 << logn
    idx = torch.arange(n, device=dev) % MSM_POOL
    pts = type(pool_t)(*(c[idx] for c in pool_t))
    scal = E.fold_scalars(n, torch.Generator().manual_seed(seed), "cpu")
    sums = scal.reshape(n // MSM_POOL, MSM_POOL, 16).sum(0).tolist()  # per pool point, per limb
    reduced = [sum(v << (16 * i) for i, v in enumerate(row)) % bn254.R for row in sums]
    return pts, scal.to(dev), reduced


LARGE_MSM_KERNELS = ("g1_add", "g1_add_select", "horner_combine")  # a large MSM's kernels: K2, K5, K6


def timed_peak(torch, dev, fn, reps: int = 3):
    """A large MSM's first call (seconds, peak memory, launches of its
    kernels: one K6 launch) and the warm median of ``reps``."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out, launches = count_launches(torch, fn, LARGE_MSM_KERNELS)
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    require(launches["horner_combine"] == 1, f"a large MSM made {launches['horner_combine']} K6 launches, not one")
    warm, times = warm_times(torch, fn, (), reps)
    return out, {"first_s": first_s, "warm_s": warm, "warm_runs_s": times, "peak_mib": peak / 2**20,
                 "launches": {k: launches[k] for k in ("mont_mul", *LARGE_MSM_KERNELS)}}


def phase_msm_chunked(torch, dev, card, rng):
    """``msm_serial_chunked`` (window 8, ``win_chunk`` 8) at 2^20 limb for
    limb against ``msm_serial``, and at 2^22 against the oracle with its
    peak under 80 GB; each with its peak memory and warm time."""
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import msm as M
    from snark_verifier_tpu_torch.util import bn254

    pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(MSM_POOL)]
    pool_t = C.g1_from_affine_ints(pool, dev)
    rows = {}
    pts, scal, reduced = tiled_msm_input(torch, dev, pool_t, 20, SEED + 120)
    whole, rows["serial_2e20"] = timed_peak(torch, dev, lambda: M.msm_serial(pts, scal, 8))
    chunked, rows["chunked_2e20"] = timed_peak(torch, dev, lambda: M.msm_serial_chunked(pts, scal, 8, CHUNK))
    require(all(torch.equal(a, b) for a, b in zip(whole, chunked)), "msm_serial_chunked 2^20 != msm_serial")
    require(C.g1_to_affine_ints(C.G1(*(c[None] for c in chunked))) == [bn254.g1_msm(reduced, pool)],
            "msm_serial_chunked 2^20: != oracle")
    # the IPA decide's form: two scalar rows over the one point set, one K6 launch
    flipped = M.msm_serial(pts, scal.flip(0), 8)
    two, rows["rows_2x2e20"] = timed_peak(torch, dev, lambda: M.msm_serial_rows(pts, torch.stack([scal, scal.flip(0)])))
    require(all(torch.equal(t[0], a) and torch.equal(t[1], b) for t, a, b in zip(two, whole, flipped)),
            "msm_serial_rows 2 x 2^20: a row != msm_serial of its scalars")
    del pts, scal, whole, chunked, flipped, two
    pts, scal, reduced = tiled_msm_input(torch, dev, pool_t, 22, SEED + 122)
    big, rows["chunked_2e22"] = timed_peak(torch, dev, lambda: M.msm_serial_chunked(pts, scal, 8, CHUNK), reps=2)
    require(C.g1_to_affine_ints(C.G1(*(c[None] for c in big))) == [bn254.g1_msm(reduced, pool)],
            "msm_serial_chunked 2^22: != oracle")
    require(rows["chunked_2e22"]["peak_mib"] < 80e9 / 2**20, "msm_serial_chunked 2^22: peak above 80 GB")
    del pts, scal, big
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log(f"{name} (window 8{', win_chunk ' + str(CHUNK) if name.startswith('chunked') else ''}): first {row['first_s']:.4f} s, "
            f"warm median {row['warm_s']:.4f} s of {[round(t, 4) for t in row['warm_runs_s']]}, peak memory "
            f"{row['peak_mib']:.1f} MiB, launches {row['launches']}, on {card}")
    log("msm_serial_chunked equals msm_serial limb for limb at 2^20 and the oracle at 2^20 and 2^22; "
        "msm_serial_rows' two rows equal msm_serial of each row's scalars limb for limb at 2^20")
    return rows


def mirrored_turns(torch, fns: dict, rounds: int = 3) -> dict:
    """Warm host-clock seconds of each synchronised call in mirrored turns
    (a, b, ..., b, a per round), so host drift falls on every one alike:
    each one's median and runs."""
    runs = {k: [] for k in fns}
    for _ in range(rounds):
        for name in [*fns, *reversed(fns)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            runs[name].append(time.perf_counter() - t0)
    return {k: {"warm_s": statistics.median(v), "runs_s": v} for k, v in runs.items()}


def mesh_group(torch, store: str):
    """A world-1 NCCL process group through a ``file://`` store."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)


def phase_mesh(torch, dev, card, rng):
    """The mesh on one card: a world-1 NCCL group; ``shard_verifier`` on
    config 1 at B=1820 row for row equal to the unsharded verifier;
    ``sharded_msm`` at 2^20 and ``sharded_msm_2d`` on a (1, 1) mesh equal to
    ``msm_serial`` in affine; ``entry.dryrun_multichip(1)``."""
    import tempfile

    import torch.distributed as dist

    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.ops import msm as M
    from snark_verifier_tpu_torch.parallel import mesh as MESH
    from snark_verifier_tpu_torch.util import bn254

    row = {}
    with tempfile.TemporaryDirectory() as tmp:
        mesh_group(torch, f"{tmp}/store")
        try:
            mesh = MESH.make_mesh(1)
            fn, args = E.entry(dev, batch=B)
            want = fn(*args)
            sharded = MESH.shard_verifier(fn, mesh)
            got, launches = count_launches(torch, lambda: sharded(*args), SLICE_KERNELS)
            require(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
                    f"mesh: shard_verifier at B={B} != the unsharded verifier")
            turns = mirrored_turns(torch, {"build_verifier": lambda: fn(*args), "shard_verifier": lambda: sharded(*args)})
            row["shard_verifier"] = {**turns, "launches": launches}
            log(f"mesh (world 1, NCCL): shard_verifier on config 1 at B={B} row for row equal to build_verifier; warm "
                f"medians in mirrored turns: shard_verifier {turns['shard_verifier']['warm_s']:.4f} s of "
                f"{[round(t, 4) for t in turns['shard_verifier']['runs_s']]}, build_verifier "
                f"{turns['build_verifier']['warm_s']:.4f} s of {[round(t, 4) for t in turns['build_verifier']['runs_s']]}, "
                f"on {card}")
            pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(MSM_POOL)]
            pts, scal, reduced = tiled_msm_input(torch, dev, C.g1_from_affine_ints(pool, dev), 20, SEED + 220)
            want_pt = C.g1_to_affine_ints(C.G1(*(c[None] for c in M.msm_serial(pts, scal, 8))))
            require(want_pt == [bn254.g1_msm(reduced, pool)], "mesh: msm_serial 2^20 != oracle")
            runs = {"sharded_msm": lambda: MESH.sharded_msm(pts, scal, mesh),
                    "sharded_msm_2d": lambda: MESH.sharded_msm_2d(pts, scal, MESH.make_mesh_2d(1, 1))}
            for name, run in runs.items():
                out, t = timed_peak(torch, dev, run)
                require(C.g1_to_affine_ints(C.G1(*(c[None] for c in out))) == want_pt, f"mesh: {name} 2^20 != msm_serial")
                row[name] = t
                log(f"mesh: {name} at 2^20 equal to msm_serial in affine; peak {t['peak_mib']:.1f} MiB, launches "
                    f"{t['launches']}, on {card}")
            turns = mirrored_turns(torch, {"msm_serial": lambda: M.msm_serial(pts, scal, 8), **runs})
            row["msm_turns"] = turns
            log("mesh: 2^20 MSM warm medians in mirrored turns: " + ", ".join(
                f"{k} {v['warm_s']:.4f} s of {[round(t, 4) for t in v['runs_s']]}" for k, v in turns.items())
                + f", on {card}")
            del pts, scal
            E.dryrun_multichip(1)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return row


TWO_RANK_BATCH = 64  # config 1's proofs in the two-rank run
TWO_RANK_LIMIT_S = 300.0  # the two ranks must have ended by then


def two_rank_msm_input(torch, dev):
    """The two-rank run's MSM, the same on both ranks: 2^16 points (a pool
    of 64 tiled) and scalars from the seed; and the oracle's sum."""
    from snark_verifier_tpu_torch.ops import curve as C
    from snark_verifier_tpu_torch.util import bn254

    rng = random.Random(SEED + 300)
    pool = [bn254.g1_mul(bn254.G1_GEN, rng.randrange(1, bn254.R)) for _ in range(MSM_POOL)]
    pts, scal, reduced = tiled_msm_input(torch, dev, C.g1_from_affine_ints(pool, dev), 16, SEED + 316)
    return pts, scal, bn254.g1_msm(reduced, pool)


def two_rank_main(rank, store, out_dir):
    """One of two ranks of a gloo group on the one card: ``shard_verifier``
    on config 1 at ``TWO_RANK_BATCH`` proofs and ``sharded_msm`` at 2^16;
    saves both results as ``<out_dir>/<rank>.pt``."""
    import torch
    import torch.distributed as dist

    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.parallel import mesh as MESH

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        mesh = MESH.make_mesh(2)
        fn, args = E.entry(dev, batch=TWO_RANK_BATCH)
        out = MESH.shard_verifier(fn, mesh)(*args)
        pts, scal, _ = two_rank_msm_input(torch, dev)
        total = MESH.sharded_msm(pts, scal, mesh)
        jax_modules = [m for m in sys.modules if m.split(".")[0] in ("jax", "snark_verifier_tpu")]
        torch.save({"verify": {k: v.cpu() for k, v in out.items()}, "msm": [c.cpu() for c in total],
                    "jax_modules": jax_modules}, f"{out_dir}/{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_two_ranks(torch, dev, card):
    """Two ranks of a gloo group on the one card (spawned processes, CUDA
    tensors, a ``file://`` store): ``shard_verifier`` row for row equal to
    the unsharded verifier and ``sharded_msm`` equal to the oracle, on each
    rank; both ranks must end within ``TWO_RANK_LIMIT_S``."""
    import tempfile

    import torch.multiprocessing as mp

    from snark_verifier_tpu_torch import entry as E
    from snark_verifier_tpu_torch.ops import curve as C

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(two_rank_main, args=(f"{tmp}/store", tmp), nprocs=2, start_method="spawn",
                                 join=False)
        try:
            while not ctx.join(timeout=max(0.0, TWO_RANK_LIMIT_S - (time.perf_counter() - t0))):
                require(time.perf_counter() - t0 < TWO_RANK_LIMIT_S,
                        f"two ranks: not ended within {TWO_RANK_LIMIT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        results = [torch.load(f"{tmp}/{rank}.pt") for rank in range(2)]
    wall = time.perf_counter() - t0
    fn, args = E.entry(dev, batch=TWO_RANK_BATCH)
    want = {k: v.cpu() for k, v in fn(*args).items()}
    _, _, oracle = two_rank_msm_input(torch, "cpu")
    for rank, got in enumerate(results):
        require(set(got["verify"]) == set(want) and all(torch.equal(got["verify"][k], want[k]) for k in want),
                f"two ranks: rank {rank}'s shard_verifier != the unsharded verifier")
        require(C.g1_to_affine_ints(C.G1(*(c[None] for c in got["msm"]))) == [oracle],
                f"two ranks: rank {rank}'s sharded_msm != the oracle")
        require(not got["jax_modules"], f"two ranks: rank {rank} imported {got['jax_modules'][:3]}")
    log(f"two ranks (gloo, CUDA tensors, one card): shard_verifier on config 1 at B={TWO_RANK_BATCH} row for row "
        f"equal to build_verifier and sharded_msm at 2^16 equal to the oracle on both ranks; {wall:.1f} s with the "
        f"ranks' start-up, on {card}")
    return {"wall_s": wall}


def add_path_totals(name: str, floor) -> dict:
    """K2's or K5's launches, device ms (torch.profiler) and bound on the
    verify and the decide: the bound as the sum over the path's launches of
    max(that launch's bound, the per-launch floor)."""
    totals = {}
    for path, widths in ADD_PATH_WIDTHS.items():
        ns = widths[name]
        if not ns:
            continue
        per = [bound(9 * n * FE_BYTES + (n if name == "g1_add_select" else 0), MONT_PER["add"] * n)["bound_ms"] for n in ns]
        prof = PROFILES.get("slice" if path == "verify" else "decide", {}).get("by_kernel", {}).get(name)
        totals[path] = {"launches": len(ns), "widths": ns, "bound_sum_ms": sum(per),
                        "bound_with_floor_sum_ms": None if floor is None else sum(max(b, floor) for b in per),
                        "profile": prof, "operand_folds": widths["folds"]}
        log(f"{name} on the {path}: {len(ns)} launches, bound summed {sum(per):.6f} ms "
            f"(with the floor {totals[path]['bound_with_floor_sum_ms']}); device time {prof}")
    return totals


def critical_paths(results) -> None:
    """Each kernel's critical path, as this run measured it: one item's
    launch less an empty launch (``one_item_chain``): one doubling for K3
    (on lanes), one proof for K8, K9 and K4 at each shape.  K8's products
    alone (2 (n - 1) levels of fmul_eo) stand beside it."""
    lat = results["mont_pow"]["product_latency_ms"]
    window, horner, scan = results["msm_window"], results["msm_horner"], results["msm_scan"]
    for row, n in ((window, window["shape"]["n"]), (window["at_config1_shape"], window["at_config1_shape"]["n"])):
        row["products_on_chain_ms"] = 2 * (n - 1) * lat["fmul_eo"]
    for row in (window, window["at_config1_shape"], horner, horner["at_config1_shape"], scan,
                scan["at_outer_snark_shape"]):
        row["critical_path_ms"] = row["chain_ms"]
    results["g1_double"]["critical_path_ms"] = results["g1_double"]["lanes"]["critical_path_ms"]
    log(f"critical paths (one item's launch less an empty launch): K8 {window['chain_ms']:.6f} ms at "
        f"n={window['shape']['n']} (products alone {window['products_on_chain_ms']:.6f}), "
        f"{window['at_config1_shape']['chain_ms']:.6f} at n={N_TERMS}; K9 {horner['chain_ms']:.6f} ms "
        f"({horner['at_config1_shape']['chain_ms']:.6f} in the config-1 phase); K4 {scan['chain_ms']:.6f} ms at "
        f"n={N_TERMS} ({scan['at_outer_snark_shape']['chain_ms']:.6f} at "
        f"n={scan['at_outer_snark_shape']['shape']['n']}); K3 {results['g1_double']['critical_path_ms']:.6f} ms")


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

    ptxas = log_ptxas(path.with_suffix(".log"))

    rng = random.Random(SEED)
    t_start = time.perf_counter()

    def done(phase):
        log(f"[{time.perf_counter() - t_start:.1f} s] {phase} done")

    results, msm_case = phase_kernels(torch, dev, rng)
    config1_windowed = phase_kernels_windowed(torch, dev, msm_case)
    del msm_case
    results.update(phase_kernels_decide(torch, dev, rng, results))
    for name, res in phase_kernels_add(torch, dev, rng, results).items():
        results[name]["lanes"] = res
    results["poseidon_perm"] = phase_kernels_poseidon(torch, dev, rng, results)
    results["keccak256"] = phase_kernels_keccak(torch, dev, rng)
    done("kernels")
    slice_launches, slice_per_launch, slice_least, out, wrong_row, verify_s = phase_slice(torch, dev, smi)
    phase_shplonk(torch, dev)
    done("slice, shplonk")
    decide_launches, decide_per_launch, decide_least = phase_decide(torch, dev, smi, out, wrong_row, verify_s)
    del out
    done("decide")
    phase_msm(torch, dev, smi, rng)
    done("large MSM")
    poseidon_launches, poseidon_per_launch, poseidon_least = phase_poseidon(torch, dev, smi)
    done("poseidon")
    agg_launches, agg_per_launch, agg_least, agg_msm = phase_aggregation(torch, dev, smi)
    on_path, scan_on_path = phase_kernels_on_path(torch, *agg_msm)
    del agg_msm
    for name, res in on_path.items():  # the path's shape first, config 1's shape beside it
        results[name] = {**res, "at_config1_shape": {"B": B, "n": N_TERMS, **config1_windowed[name]}}
    results["msm_scan"]["at_outer_snark_shape"] = {
        k: scan_on_path[k] for k in ("shape", "ms", "plain_ms", "two_kernel_msm_ms", "bound_ms", "bound_by",
                                     "one_item_ms", "empty_ms", "chain_ms")}
    done("aggregation")
    critical_paths(results)
    phase_config4(torch, dev, smi)
    done("config 4")
    new_paths = {"ipa_verify": phase_ipa_verify(torch, dev, smi, rng)}
    done("ipa verify")
    new_paths["ipa_decide_k20"] = phase_ipa_decide(torch, dev, smi, rng)
    done("ipa decide")
    new_paths["msm_chunked"] = phase_msm_chunked(torch, dev, smi, rng)
    done("chunked MSM")
    new_paths["mesh"] = phase_mesh(torch, dev, smi, rng)
    new_paths["mesh"]["two_ranks"] = phase_two_ranks(torch, dev, smi)
    done("mesh")
    require("jax" not in sys.modules, "the port must not import jax")
    require(not any(m == "snark_verifier_tpu" or m.startswith("snark_verifier_tpu.") for m in sys.modules),
            "the port must not import the JAX package")

    # each kernel's launches, and its mean device ms per launch (torch.profiler),
    # on the path that counts it: the slice for K1-K4 and mont_pow, the decide for K5-K7
    # (K7's single product launches on no path: the pairing runs its own two
    # kernels; nor do K8-K9: the outer snark's count of them is 0)
    windowed = ("msm_window", "msm_horner")
    launches = {**{k: decide_launches[k] for k in (*DECIDE_KERNELS, "fq12_mul")},
                **{k: slice_launches[k] for k in SLICE_KERNELS}, **{k: agg_launches[k] for k in windowed},
                "poseidon_perm": poseidon_launches["poseidon_perm"]}
    path_ms = {**{k: decide_per_launch.get(k) for k in (*DECIDE_KERNELS, "fq12_mul")},
               **{k: slice_per_launch.get(k) for k in SLICE_KERNELS}, **{k: agg_per_launch.get(k) for k in windowed},
               "poseidon_perm": poseidon_per_launch.get("poseidon_perm")}
    # the per-launch floor: the least device time any one kernel launch took
    # in the path profiles; no launch, however little its work, takes less
    floors = [t for t in (slice_least, decide_least, poseidon_least, agg_least) if t is not None]
    floor = min(floors) if floors else None
    log(f"per-launch floor (least device time of one kernel launch in the path profiles): {floor} ms")
    report = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "path_device_ms": path_ms[name], **results[name],
         "bound_with_floor_ms": None if floor is None else max(results[name]["bound_ms"], floor)}
        for name, (src, rep) in KERNELS.items()
    ]
    paths = {"verify": slice_launches, "decide": decide_launches, "poseidon_verify": poseidon_launches,
             "outer_snark": agg_launches}
    for row in report:
        if row["name"] in ("mont_mul", "mont_pow", "poseidon_perm", "keccak256"):
            row["launches_by_path"] = {k: v[row["name"]] for k, v in paths.items()}
        row["ptxas"] = {k: v for k, v in ptxas.items() if k.split(" ")[0] == row["name"]}
        if row["name"] in ("g1_add", "g1_add_select"):
            row["lanes"]["paths"] = add_path_totals(row["name"], floor)
    print(json.dumps({"paths": new_paths}))
    print(json.dumps({"kernels": report}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
