"""Multi-device parallelism on ``torch.distributed``: device meshes, sharded
verification, sharded large MSM.

Counterpart of ``snark_verifier_tpu/parallel/mesh.py``.  A mesh is a
``DeviceMesh`` over an initialised process group (torchrun's environment, or
``init_process_group`` with a ``file://`` store): each rank is one process
on one device.  Proof batches are data-parallel: each rank verifies its
contiguous slice of the rows and every output is all-gathered, so each rank
returns the whole batch, row for row what the unsharded verifier gives.
Large MSMs shard their points: each rank runs ``msm_serial`` on its slice,
the partial sums (3 x 16 limbs each) are all-gathered and tree-summed in
rank order, so every rank holds the same point.  Point addition is not a
reduction op of the collectives, so the partials travel as limbs and fold
on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from snark_verifier_tpu_torch.ops import curve as C
from snark_verifier_tpu_torch.ops import msm as M
from snark_verifier_tpu_torch.ops.curve import G1

FLAT_2D = ("dcn", "ici")  # the two-level mesh's axes: hosts (slow), a host's devices (fast)


def make_mesh(n_devices: int | None = None, axis: str = "dp", device_type: str = "cuda") -> DeviceMesh:
    """A one-axis mesh over the first ``n_devices`` ranks (all by default)
    of the initialised default process group."""
    return init_device_mesh(device_type, (n_devices or dist.get_world_size(),), mesh_dim_names=(axis,))


def make_mesh_2d(n_hosts: int, chips_per_host: int, device_type: str = "cuda") -> DeviceMesh:
    """Two-level mesh for multi-host deployments: the slow "dcn" axis spans
    hosts, the fast "ici" axis a host's devices.  Heavy collectives stay on
    "ici"; "dcn" carries one point per host (``sharded_msm_2d``)."""
    return init_device_mesh(device_type, (n_hosts, chips_per_host), mesh_dim_names=FLAT_2D)


def _position(mesh: DeviceMesh, axes) -> tuple[int, int]:
    """This rank's index in the flattened ``axes`` of the mesh (the first
    axis outermost) and their total size."""
    index, size = 0, 1
    for axis in axes:
        n = mesh.size(mesh.mesh_dim_names.index(axis))
        index, size = index * n + mesh.get_local_rank(axis), size * n
    return index, size


def _all_gather(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim``, in the rank order of
    ``axis``; booleans travel as bytes."""
    group = mesh.get_group(axis)
    send = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()
    parts = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=dim).to(t.dtype)


def _sharded_rows(verify_fn, mesh: DeviceMesh, axes):
    def fn(*args):
        batch = args[0].shape[0]
        index, size = _position(mesh, axes)
        if batch % size:
            raise ValueError(f"a batch of {batch} proofs does not split over {size} devices")
        rows = slice(index * (batch // size), (index + 1) * (batch // size))
        out = verify_fn(*(a[rows] for a in args))
        # each output ends in the batch axis, then the limb axis for a field
        # element; "ok" has no limb axis
        for axis in reversed(axes):  # innermost first, so the flat order holds
            out = {k: _all_gather(v, mesh, axis, v.dim() - (1 if k == "ok" else 2)) for k, v in out.items()}
        return out

    return fn


def shard_verifier(verify_fn, mesh: DeviceMesh, axis: str = "dp"):
    """``verify_fn`` (a batched verifier of ``build_verifier``'s form, every
    argument with the batch axis first) over the whole batch, data-parallel
    on the mesh: each rank verifies its contiguous slice of rows, and every
    output is all-gathered, so each rank returns the whole batch.  A batch
    that the mesh's size does not divide is refused."""
    return _sharded_rows(verify_fn, mesh, (axis,))


def shard_verifier_2d(verify_fn, mesh: DeviceMesh):
    """``shard_verifier`` over the flattened (dcn, ici) grid: each proof's
    verify is local to its device; the outputs gather over "ici", then
    "dcn"."""
    return _sharded_rows(verify_fn, mesh, FLAT_2D)


def pad_msm_inputs(points: G1, scalars_canon, multiple: int):
    """Pad an MSM's points with the identity and its scalars with 0 so the
    point count divides ``multiple`` (the identity contributes nothing)."""
    pad = (-points.x.shape[0]) % multiple
    if pad == 0:
        return points, scalars_canon
    ident = C.g1_identity((pad,), points.x.device)
    pts = G1(*(torch.cat([c, e]) for c, e in zip(points, ident)))
    return pts, torch.cat([scalars_canon, scalars_canon.new_zeros((pad,) + scalars_canon.shape[1:])])


def _gather_sum(point: G1, mesh: DeviceMesh, axis: str) -> G1:
    """Every rank's point along ``axis``, tree-summed in rank order."""
    gathered = _all_gather(torch.stack(list(point))[None], mesh, axis, 0)  # (ranks, 3, 16)
    return C.g1_tree_sum(G1(*gathered.unbind(1)))


def _local_shard(points: G1, scalars_canon, mesh: DeviceMesh, axes):
    index, size = _position(mesh, axes)
    points, scalars_canon = pad_msm_inputs(points, scalars_canon, size)
    per = points.x.shape[0] // size
    rows = slice(index * per, (index + 1) * per)
    return G1(*(c[rows] for c in points)), scalars_canon[rows]


def sharded_msm(points: G1, scalars_canon, mesh: DeviceMesh, axis: str = "dp", window: int = 8) -> G1:
    """One large MSM with its points sharded over the mesh: each rank runs
    ``msm_serial`` on its contiguous slice (the points padded with
    identities to a multiple of the mesh's size), the partial sums are
    all-gathered and tree-summed in rank order on every rank (the
    reference's partial-result fold, util/msm.rs:311-336).  Every rank
    passes the whole input and gets the whole sum."""
    pts, scal = _local_shard(points, scalars_canon, mesh, (axis,))
    return _gather_sum(M.msm_serial(pts, scal, window), mesh, axis)


def sharded_msm_2d(points: G1, scalars_canon, mesh: DeviceMesh, window: int = 8) -> G1:
    """Hierarchical large MSM over a (dcn, ici) mesh: the points shard over
    the flattened grid; the partials fold over "ici" first (a host's
    devices), then one point per host crosses "dcn", whatever the MSM's
    size."""
    pts, scal = _local_shard(points, scalars_canon, mesh, FLAT_2D)
    host_total = _gather_sum(M.msm_serial(pts, scal, window), mesh, "ici")
    return _gather_sum(host_total, mesh, "dcn")
