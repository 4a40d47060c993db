"""The traffic generators repeat for a seed, and every seed gets the same
mix."""

import numpy as np

from benchmark.harness.rows import RowStream, rng
from benchmark.traffic import poisson_stream


def stream(seed, share=0.005, n=4000):
    return RowStream(rng(seed, 2), [0, 1, 2, 3], [4, 5, 6, 7], share).take(n)


def test_rows_repeat_for_a_seed():
    assert np.array_equal(stream(2**31 + 7), stream(2**31 + 7))
    assert not np.array_equal(stream(2**31 + 7), stream(2**31 + 8))


def test_every_block_holds_one_bad_row():
    for seed in (1, 2**33 + 5):
        rows = stream(seed)
        blocks = rows.reshape(-1, 200)
        assert ((blocks >= 4).sum(axis=1) == 1).all()
        assert np.bincount(rows, minlength=8)[:4].min() >= 4000 * 199 // 200 // 4


def test_arrivals_repeat_and_share_their_gaps():
    a = poisson_stream.arrivals(5000.0, 20000, rng(11, 3))
    b = poisson_stream.arrivals(5000.0, 20000, rng(11, 3))
    c = poisson_stream.arrivals(5000.0, 20000, rng(12, 3))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.allclose(np.sort(np.diff(a, prepend=0)), np.sort(np.diff(c, prepend=0)))
    assert abs(a[-1] - 4.0) < 0.05  # 20000 proofs at 5000/s
