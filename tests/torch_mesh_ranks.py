"""Rank-side cases of tests/test_torch_mesh.py: each runs in a process of a
gloo group on the CPU (spawned, so this module imports neither JAX nor the
JAX package) and returns what the test compares."""

import torch
import torch.distributed as dist

from snark_verifier_tpu_torch import entry as E
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops.convert import ints_to_tensor
from snark_verifier_tpu_torch.parallel import mesh as MESH
from snark_verifier_tpu_torch.util import bn254

MSM_N = 37  # does not divide 2 or 4: identity padding
MSM_WINDOW = 4
VERIFY_BATCH = 4
CORRUPT_ROW = 1


def msm_case():
    """37 points and scalars, the same on every rank."""
    pts = [bn254.g1_mul(bn254.G1_GEN, 2 * i + 5) for i in range(MSM_N)]
    scalars = [bn254.R - 7 * i - 3 for i in range(MSM_N)]
    return pts, scalars


def verify_case():
    """Config 1's verifier on the CPU and a batch of 4 proofs with a
    corrupted commitment in row 1."""
    fx = E.fixture()
    fn, (proofs, instances) = E.entry("cpu", batch=VERIFY_BATCH)
    rows = [i % len(fx.proofs) for i in range(VERIFY_BATCH)]
    proof_list = [fx.proofs[i] for i in rows]
    proof_list[CORRUPT_ROW] = E.corrupt(proof_list[CORRUPT_ROW])
    from snark_verifier_tpu_torch.parallel.batch import pack_proofs

    return fn, (pack_proofs(proof_list, "cpu"), instances)


def _affine(point):
    return C.g1_to_affine_ints(C.G1(*(c[None] for c in point)))[0]


def run_msm(world):
    pts, scalars = msm_case()
    mesh = MESH.make_mesh(world, device_type="cpu")
    total = MESH.sharded_msm(C.g1_from_affine_ints(pts, "cpu"), ints_to_tensor(scalars, "cpu"), mesh,
                             window=MSM_WINDOW)
    return {"affine": _affine(total), "limbs": torch.stack(list(total))}


def run_msm_2d(world):
    pts, scalars = msm_case()
    mesh = MESH.make_mesh_2d(2, world // 2, device_type="cpu")
    total = MESH.sharded_msm_2d(C.g1_from_affine_ints(pts, "cpu"), ints_to_tensor(scalars, "cpu"), mesh,
                                window=MSM_WINDOW)
    return {"affine": _affine(total), "limbs": torch.stack(list(total))}


def run_verify(world):
    fn, args = verify_case()
    sharded = MESH.shard_verifier(fn, MESH.make_mesh(world, device_type="cpu"))
    try:
        sharded(*(a[:VERIFY_BATCH - 1] for a in args))
        refused = False
    except ValueError:
        refused = True
    return {"out": sharded(*args), "refused_odd_batch": refused}


def run_verify_2d(world):
    fn, args = verify_case()
    return {"out": MESH.shard_verifier_2d(fn, MESH.make_mesh_2d(2, world // 2, device_type="cpu"))(*args)}


def run_dryrun(world):
    E.dryrun_multichip(world, device_type="cpu")
    return {"done": True}


CASES = {"msm": run_msm, "msm_2d": run_msm_2d, "verify": run_verify, "verify_2d": run_verify_2d,
         "dryrun": run_dryrun}


def rank_main(rank, world, store, case, out_dir):
    """One rank: join the gloo group through the ``file://`` store, run the
    case, save its result as ``<out_dir>/<rank>.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        torch.save(CASES[case](world), f"{out_dir}/{rank}.pt")
    finally:
        dist.destroy_process_group()
