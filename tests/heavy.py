"""The heaviest tests of the Tier-1 run, and how they are dealt to the
pytest-xdist workers: a pytest plugin, which tests/conftest.py registers.

pytest-xdist's load scheduler (``--dist load``) first gives each of its N
workers a chunk of ``max(len(items) // N // 4, 2)`` consecutive tests, and
then hands out the rest a few at a time as workers free up.  A worker that
draws two heavy tests in its first chunk sets the end of the run, so the
heavy entries open the chunks, one or two to each worker.
tests/test_heavy.py checks that every id below is collected and that the
installed pytest-xdist still deals the chunks so.
"""

import pytest

# Heaviest first, by their time on a cold host (a fresh compile cache) under
# the Tier-1 command (CHANGES.md).  The tests of one entry share a JAX
# program or a result, so they run on one worker, one after the other: the
# first pays the compile, the rest reuse its program (the same module, so
# JAX's in-memory cache) or read its result (tests/shared.py).
HEAVY = (
    ("tests/test_msm.py::test_msm_serial",),
    ("tests/test_zk.py::test_zk_jax_matches_native",),
    ("tests/test_sharding.py::test_sharded_msm_2d_and_padding",),
    ("tests/test_verifier_jax.py::test_jax_matches_native_bitexact[gwc]",
     "tests/test_verifier_jax.py::test_jax_flags_bad_proof"),
    ("tests/test_torch_msm.py::test_msm_fused_matches_jax_fused",
     "tests/test_msm_fused.py::test_msm_batched_fused_bit_exact[3-8]",
     "tests/test_torch_msm_windowed.py::test_scan_plain_matches_jax_window_horner_composition",
     "tests/test_torch_msm_windowed.py::test_msm_fused_mega_off_matches_jax_fused"),
    ("tests/test_recursion_instance.py::test_jax_decodes_limbs_in_graph",
     "tests/test_recursion_instance.py::test_jax_flags_off_curve_limbs"),
    ("tests/test_msm.py::test_msm_equal_points_collide",
     "tests/test_msm.py::test_msm_all_equal_scalars_small"),
    ("tests/test_pairing_jax.py::test_kzg_pairing_check_batched",),
    ("tests/test_msm.py::test_msm_serial_straddling_window",),
    ("tests/test_pairing_jax.py::test_final_exp_tape_vm_vs_oracle",),
    ("tests/test_fibonacci_circuit.py::test_fibonacci_jax",),
    tuple(f"tests/test_torch_aggregation_distinct.py::test_port_matches_the_file_answers[{row}]"
          for row in ("good.0", "good.1", "out_of_range.2", "limb_flip.3", "bad_inner", "probe.4")),
    ("tests/test_msm_fused.py::test_msm_batched_fused_bit_exact[2-3]",),
    ("tests/test_msm.py::test_bucket_totals_transposed_matches",),
)


def spread(items: list, heavy, workers: int) -> None:
    """Reorder ``items`` (pytest's collected tests, in place) so that the
    entries of ``heavy`` (tuples of node ids, heaviest first) open the first
    chunks of the ``workers`` workers: dealt out and back (0, 1, ..., N-1,
    N-1, ..., 0, 0, ...), each chunk filled up with the other tests in their
    order.  Ids not among ``items`` (deselected) are passed over."""
    if len(items) < 2 * workers:
        return  # the scheduler then deals the tests one by one
    by_id = {item.nodeid: item for item in items}
    chunk = max(len(items) // workers // 4, 2)
    chunks, spill = [[] for _ in range(workers)], []
    for k, ids in enumerate(heavy):
        tests = [by_id[i] for i in ids if i in by_id]
        lap, pos = divmod(k, workers)
        c = chunks[pos if lap % 2 == 0 else workers - 1 - pos]
        if len(c) + len(tests) <= chunk:
            c += tests
        else:
            spill += tests
    placed = {id(t) for c in chunks for t in c} | {id(t) for t in spill}
    rest = iter([item for item in items if id(item) not in placed])
    for c in chunks:
        c += [t for _, t in zip(range(chunk - len(c)), rest)]
    items[:] = [t for c in chunks for t in c] + spill + list(rest)


@pytest.hookimpl(optionalhook=True)
def pytest_configure_node(node):
    """pytest-xdist's controller: tell each worker the ``--dist`` mode (a
    worker's own option reads "no")."""
    node.workerinput["dist"] = node.config.getoption("dist")


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    """Under ``-n N --dist load``, open each worker's first chunk with the
    ``HEAVY`` tests.  Runs after ``-m`` has deselected, and every worker
    orders its collection alike, as the scheduler requires."""
    workerinput = getattr(config, "workerinput", {})
    if workerinput.get("dist") == "load":
        spread(items, HEAVY, workerinput["workercount"])
