"""The port's multi-device layer (snark_verifier_tpu_torch/parallel/mesh.py
and ``entry.dryrun_multichip``) on the CPU: groups of 2 and 4 gloo ranks,
each rank a spawned process (tests/torch_mesh_ranks.py), joined through a
``file://`` store under the test's temporary directory, so parallel test
workers never compete for a port.  Each group must end within
``JOIN_S`` seconds; the test fails, never hangs, when it does not.

Every rank's result is held against the unsharded port (``msm_serial``, the
batched verifier) and the python-int oracle.  The JAX package's own
``sharded_msm`` is not run: its jitted MSM inside ``shard_map`` takes minutes
to compile on the CPU (tests/test_sharding.py); its meaning, the sum over
all points whatever the mesh, is what the oracle checks.  Tolerance 0:
affine points as integers, limbs, boolean masks.
"""

import functools
import time

import pytest
import torch
import torch.multiprocessing as mp
import test_torch_fixture  # noqa: F401  (one torch thread per worker)
import torch_mesh_ranks as R

from snark_verifier_tpu.util import bn254
from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import msm as M
from snark_verifier_tpu_torch.ops.convert import ints_to_tensor

JOIN_S = 120.0


def run_group(tmp_path, world: int, case: str, nprocs: int | None = None, limit: float = JOIN_S) -> list:
    """Spawn ``nprocs`` (default ``world``) ranks of a group of ``world``
    running ``case``; fail if they have not all ended within ``limit``
    seconds, and stop any still running; return each rank's result in rank
    order."""
    nprocs = nprocs or world
    ctx = mp.start_processes(R.rank_main, args=(world, str(tmp_path / "store"), case, str(tmp_path)),
                             nprocs=nprocs, start_method="spawn", join=False)
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{nprocs} ranks of {case!r} did not end within {limit} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [torch.load(tmp_path / f"{rank}.pt") for rank in range(world)]


@functools.lru_cache(maxsize=None)
def unsharded_msm():
    pts, scalars = R.msm_case()
    total = M.msm_serial(C.g1_from_affine_ints(pts, "cpu"), ints_to_tensor(scalars, "cpu"), R.MSM_WINDOW)
    return C.g1_to_affine_ints(C.G1(*(c[None] for c in total)))[0], bn254.g1_msm(scalars, pts)


@functools.lru_cache(maxsize=None)
def unsharded_verify():
    fn, args = R.verify_case()
    return fn(*args)


@pytest.mark.parametrize("case,world", [("msm", 2), ("msm_2d", 4)])
def test_sharded_msm_equals_unsharded_and_oracle(tmp_path, case, world):
    """37 points (padded with identities to a multiple of the mesh) over 2
    ranks, and over a (2, 2) (dcn, ici) mesh: every rank holds the same
    limbs, equal in affine to the unsharded ``msm_serial`` and the oracle."""
    results = run_group(tmp_path, world, case)
    assert all(torch.equal(r["limbs"], results[0]["limbs"]) for r in results)
    single, oracle = unsharded_msm()
    assert [r["affine"] for r in results] == [single] * world
    assert single == oracle


@pytest.mark.parametrize("case,world", [("verify", 2), ("verify_2d", 4)])
def test_shard_verifier_equals_unsharded(tmp_path, case, world):
    """Config 1's verifier at B = 4 (row 1 corrupted) over 2 ranks and over
    a (2, 2) mesh: every rank returns the whole batch, row for row equal to
    the unsharded port verify; a batch that the mesh does not divide is
    refused."""
    results = run_group(tmp_path, world, case)
    want = unsharded_verify()
    assert want["ok"].tolist() == [i != R.CORRUPT_ROW for i in range(R.VERIFY_BATCH)]
    for r in results:
        assert set(r["out"]) == set(want)
        for key, value in want.items():
            assert torch.equal(r["out"][key], value), key
        assert r.get("refused_odd_batch", True)


def test_dryrun_multichip_on_two_ranks(tmp_path):
    """``entry.dryrun_multichip(2)``: sharded verify of config 1's proofs
    and a sharded MSM against the oracle, on 2 ranks."""
    assert [r["done"] for r in run_group(tmp_path, 2, "dryrun")] == [True, True]


def test_a_group_that_does_not_end_fails(tmp_path):
    """The join limit: two ranks of a group of three wait in
    ``init_process_group`` for a rank that never comes; the test fails
    within the limit instead of hanging, and the ranks are stopped."""
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="did not end within 5.0 s"):
        run_group(tmp_path, 3, "msm", nprocs=2, limit=5.0)
    assert time.monotonic() - start < 60
