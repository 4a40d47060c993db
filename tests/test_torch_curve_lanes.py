"""The Python side of kernels K2 and K5 (snark_verifier_tpu_torch/ops/curve.py):
how a point batch folds into the two element strides the kernels read, or is
copied, and that the grid serves every point exactly once.  The kernels run
only on the card (chip_smoke.py holds them against their plain versions
there); this checks, on the CPU, the map ``point_offsets`` the wrapper and
csrc/curve.cu share, at the widths of the main path."""

import pytest
import torch

from snark_verifier_tpu_torch.ops import curve as C

WIDTHS = (1, 31, 32, 33, 8192, 32760)
KINDS = ("contiguous", "sliced", "expanded")


def operand(kind: str, width: int) -> torch.Tensor:
    """A (2, width, 16) limb operand whose every element holds its own index
    in the storage, so an element's value says where it lies."""
    if kind == "contiguous":
        return torch.arange(2 * width * 16).reshape(2, width, 16)
    if kind == "sliced":  # the bucket tree's odd slots: [:, 1::2]
        return torch.arange(2 * 2 * width * 16).reshape(2, 2 * width, 16)[:, 1::2]
    return torch.arange(width * 16).reshape(1, width, 16).expand(2, width, 16)  # stride 0


def row_offsets(t: torch.Tensor) -> torch.Tensor:
    """Each point's first-limb offset from the tensor's start, row-major."""
    return t[..., 0].reshape(-1) - t.storage_offset()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_points_fold_into_two_strides_and_the_grid_covers_each_once(kind, width):
    t = operand(kind, width)
    others = [torch.arange(2 * width * 16).reshape(2, width, 16) for _ in range(5)]
    mask = torch.tensor([True, False]).reshape(2, 1).expand(2, width)  # broadcast along the row
    batch = (2, width)
    ins, strides, m, mask_strides, inner = C.point_operands([t, *others], mask, batch)
    assert ins[0] is t  # reaches the kernel as it is: no copy
    assert m.data_ptr() == mask.data_ptr() and m.dtype == torch.uint8
    n = 2 * width
    i = torch.arange(n)
    for got_t, (s0, s1) in zip(ins, strides):
        assert torch.equal(C.point_offsets(i, inner, s0, s1), row_offsets(got_t))
    want_mask = mask.reshape(-1).to(torch.uint8)
    assert torch.equal(m.reshape(-1), want_mask)
    flat_mask = torch.as_strided(m, (m.untyped_storage().nbytes(),), (1,), 0)
    assert torch.equal(flat_mask[C.point_offsets(i, inner, *mask_strides)], want_mask)
    block = C.ADD_BLOCK
    grid = C.add_grid(n)
    thread = torch.arange(grid * block)
    point = thread // C.GROUP  # csrc/curve.cu add_lanes: (block * blockDim + t) / ADD_GROUP
    served = point[(thread % C.GROUP == 0) & (point < n)]
    assert torch.equal(served, i)  # every point once, in order
    assert (grid - 1) * block < n * C.GROUP  # no block lies wholly past the end
    assert block % 32 == 0  # whole warps: the kernel's __syncwarp()s span every lane


def test_batches_that_do_not_fold_are_copied():
    w = 33
    # dims (2, 3, w) permuted from (3, 2, w): the leading dims do not fold into one stride
    tangled = torch.arange(3 * 2 * w * 16).reshape(3, 2, w, 16).permute(1, 0, 2, 3)
    misaligned = torch.arange(2 * 3 * w * 17 + 1)[1:].as_strided((2, 3, w, 16), (3 * w * 17, w * 17, 17, 1))
    cont = torch.arange(2 * 3 * w * 16).reshape(2, 3, w, 16)
    batch = (2, 3, w)
    for bad in (tangled, misaligned):  # misaligned: an odd row stride
        ins, _, _, _, _ = C.point_operands([bad] * 6, None, batch)
        assert all(t is not bad for t in ins)
    ins, strides, m, _, inner = C.point_operands([tangled, misaligned, cont, cont, cont, cont], None, batch)
    assert m is None
    assert ins[2] is cont and ins[0] is not tangled and ins[1] is not misaligned
    i = torch.arange(2 * 3 * w)
    for src, got_t, (s0, s1) in zip((tangled, misaligned), ins, strides):
        assert got_t.is_contiguous() and torch.equal(got_t, src)
        assert torch.equal(got_t.reshape(-1, 16)[:, 0], got_t.reshape(-1)[C.point_offsets(i, inner, s0, s1)])
    # a slice along the last dim folds too: it is the inner index
    odd = cont[:, :, 1::2]
    ins, strides, _, _, inner = C.point_operands([odd] * 6, None, odd.shape[:-1])
    assert ins[0] is odd and strides[0] == (w * 16, 32) and inner == odd.shape[2]
    # the tree sum's shape: even slots of (m, nwin) against a mask broadcast along nwin
    cur = torch.arange(10 * 3 * 16).reshape(10, 3, 16)
    even = cur[0::2]
    valid = (torch.arange(5) < 4).reshape(5, 1).expand(5, 3)
    ins, strides, m, mask_strides, inner = C.point_operands([even] * 6, valid, (5, 3))
    assert ins[0] is even and strides[0] == (2 * 3 * 16, 16) and mask_strides == (1, 0) and inner == 3


def test_add_points_validates_its_schedule_and_block():
    """The K2/K5 wrappers refuse limbs that are not int64 (..., 16) and a
    mask that is not bool, before any launch; operand batches that do not
    broadcast fail in ``add_points`` itself."""
    g = C.g1_from_affine_ints([None, (1, 2)], "cpu")
    with pytest.raises(ValueError):
        C.g1_add(C.G1(g.x.int(), g.y, g.z), g)
    with pytest.raises(ValueError):
        C.g1_add(g, C.G1(*(c[..., :8] for c in g)))
    with pytest.raises(ValueError):
        C.g1_add_select(torch.tensor([1, 0]), g, g)
    three = C.G1(*(torch.cat([c, c[:1]]) for c in g))
    with pytest.raises(RuntimeError):
        C.add_points(None, g, three)
