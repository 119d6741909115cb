"""The count functions against the port's kernel table (PERF.md §6): its
recounted bounds at its shapes, in milliseconds."""

import pytest

from portbench import counts

N, D, NB, S = 11_000_000, 28, 32, 2


def ms(work):
    return counts.bound_s(*work) * 1e3


def test_histogram_one_slice():
    # One slice, 16 node slots, 90% of the rows active: 0.1228 ms.
    act = 0.9 * N
    assert ms(counts.hist_work(1, N, D, NB, S, 16, act, act)) == \
        pytest.approx(0.1228, abs=5e-5)


def test_histogram_slice_form_codes_once_per_matrix():
    # 24 slices over 2 matrices, each slice 90% active: 1.146 ms; codes
    # counted once a slice would give 2.948 ms.
    act = 24 * 0.9 * N
    assert ms(counts.hist_work(24, N, D, NB, S, 16, act, 2 * N)) == \
        pytest.approx(1.146, abs=1e-3)
    assert ms(counts.hist_work(24, N, D, NB, S, 16, act, act)) > 2.9


def test_leaf_form_feature_major_and_repulsion():
    assert ms(counts.leaf_work(1, N, S, 63)) == pytest.approx(0.0394,
                                                              abs=5e-5)
    assert ms(counts.feature_major_work(1, N, D)) == pytest.approx(
        0.1839, abs=5e-5)
    assert ms(counts.repulsion_work(60416, 60000)) == pytest.approx(
        0.4567, abs=5e-5)


def test_route_and_descent():
    # K2 moves between nothing and every row: the table's 0.0447 ms lies
    # between.
    lo = ms(counts.route_work(1, N, 16, 0))
    hi = ms(counts.route_work(1, N, 16, N))
    assert lo < 0.0447 < hi
    # K3 counts the least any walk reads, below the table's path count
    # (0.0296 ms one tree, 0.4807 ms twenty trees over 11M rows).
    assert ms(counts.descend_work(1, 1, N, 1, 63)) < 0.0296
    assert ms(counts.descend_work(1, 20, N, 1, 63)) < 0.4807


def test_step_bounds():
    fams = ["lr", "dt", "rf", "gb", "nb"]
    b = counts.build_bound_s(fams, N, 100_000, D, 2)
    assert 0.05 < b < 0.5
    # 750 steps of 17 operations a pair over 60,000 rows: 0.34 s at least.
    assert counts.tsne_bound_s(60000, 2 * 60000 * 90, 750) > 0.34
