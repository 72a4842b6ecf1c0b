"""``kkt/sparse.py:gram_pattern``: the K = P·Pᵀ pattern that the
sparse-first plan hands RCM, formed from the distinct column patterns of P.
Its ``indptr`` and ``indices`` are scipy's product's, index for index, the
unsorted order within each row included, so RCM breaks its ties the same
way. CPU tests."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from golden_large import staircase_lp
from tulip_tpu_torch import trace
from tulip_tpu_torch.kkt import sparse
from tulip_tpu_torch.kkt.sparse import _column_classes, gram_pattern


def ones(A):
    """The 0/1 int32 CSR pattern of ``A``."""
    P = sp.csr_matrix(A, copy=True)
    P.eliminate_zeros()
    P.data = np.ones_like(P.data, dtype=np.int32)
    return P


def unsorted_rows(P, seed=0):
    """``P`` with each row's entries stored in a random order."""
    rng = np.random.default_rng(seed)
    P = P.copy()
    for i in range(P.shape[0]):
        s, e = P.indptr[i], P.indptr[i + 1]
        P.indices[s:e] = rng.permutation(P.indices[s:e])
    P.has_sorted_indices = False
    return P


def no_repeats():
    """A random 300 × 600 pattern whose columns all differ."""
    rng = np.random.default_rng(1)
    dense = rng.random((300, 600)) < 0.03
    dense[rng.integers(0, 300, 600), np.arange(600)] = True
    dense[np.arange(600) % 300, np.arange(600)] = True
    assert np.unique(dense.T, axis=0).shape[0] == 600
    return sp.csr_matrix(dense.astype(np.int32))


def empty_rows_and_columns():
    """Repeated columns with every fourth row and every fifth column
    empty."""
    rng = np.random.default_rng(2)
    base = rng.random((120, 6)) < 0.3
    dense = base[:, rng.integers(0, 6, 200)]
    dense[::4] = False
    dense[:, ::5] = False
    return sp.csr_matrix(dense.astype(np.int32))


def one_class():
    """Every column the same rows."""
    dense = np.zeros((64, 40), np.int32)
    dense[[3, 7, 8, 30, 63]] = 1
    return sp.csr_matrix(dense)


def interleaved():
    """Four column patterns of one length, repeated in turn, so that equal
    columns never stand next to each other in column order."""
    rng = np.random.default_rng(3)
    base = np.zeros((80, 4), bool)
    for k in range(4):
        base[rng.choice(80, 6, replace=False), k] = True
    return sp.csr_matrix(base[:, np.arange(200) % 4].astype(np.int32))


CASES = {
    "staircase": lambda: ones(staircase_lp(1024)[0]),
    "cyclic": lambda: ones(staircase_lp(1024, cyclic=True)[0]),
    "dense-cols": lambda: ones(staircase_lp(1024, dense_cols=3)[0]),
    "no-repeats": no_repeats,
    "unsorted": lambda: unsorted_rows(ones(staircase_lp(1024)[0])),
    "unsorted-cyclic": lambda: unsorted_rows(
        ones(staircase_lp(1024, cyclic=True)[0]), 1),
    "empty-rows-cols": empty_rows_and_columns,
    "one-class": one_class,
    "interleaved": interleaved,
}


def distinct_columns(P):
    """Each column's class under ``np.unique`` and the number of classes."""
    _, inv = np.unique(P.toarray().T, axis=0, return_inverse=True)
    return inv.ravel(), inv.max() + 1


def assert_product(P, got):
    want = (P @ P.T).tocsr()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(
        reverse_cuthill_mckee(got, symmetric_mode=True),
        reverse_cuthill_mckee(want, symmetric_mode=True))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gram_pattern_is_the_product_index_for_index(case):
    P = CASES[case]()
    with trace.call("test") as rec:
        got = gram_pattern(P)
    assert_product(P, got)
    assert rec.record["counters"]["level_plan/col_patterns"] == \
        distinct_columns(P)[1]


def singletons(rows, ptr, weights):
    """Every column a class of its own."""
    n = ptr.size - 1
    return np.arange(n), np.arange(n)


def constant_weights(rows, ptr, weights):
    """Classes under one weight for every row: columns of one length
    collide, and equal columns that are not neighbours in the sort get
    classes of their own."""
    return _column_classes(rows, ptr, np.ones_like(weights))


@pytest.mark.parametrize("split", [singletons, constant_weights],
                         ids=["singletons", "constant-weights"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gram_pattern_is_exact_when_a_class_is_split(case, split,
                                                     monkeypatch):
    """The product from a partition finer than the distinct columns (a
    hash collision splits a class) is still scipy's, index for index."""
    P = CASES[case]()
    monkeypatch.setattr(sparse, "_column_classes", split)
    assert_product(P, gram_pattern(P))


@pytest.mark.parametrize("case", ["staircase", "no-repeats",
                                  "empty-rows-cols", "interleaved"])
def test_column_classes_refine_the_distinct_columns(case):
    """No class holds two different column patterns, whatever the weights;
    under random weights there is one class a pattern. Constant weights
    make every column of one length collide, and on ``interleaved`` split
    its classes."""
    P = CASES[case]().tocsc()
    want, count = distinct_columns(P)
    for weights in (np.ones(P.shape[0], np.uint64),
                    np.random.default_rng(0).integers(
                        1, 2**63, P.shape[0], dtype=np.uint64)):
        ids, reps = _column_classes(P.indices, P.indptr, weights)
        np.testing.assert_array_equal(ids[reps], np.arange(reps.size))
        # Each class's columns share one pattern.
        np.testing.assert_array_equal(want, want[reps][ids])
        assert reps.size >= count
    assert reps.size == count
    if case == "interleaved":
        ids, reps = _column_classes(P.indices, P.indptr,
                                    np.ones(P.shape[0], np.uint64))
        assert reps.size > count
