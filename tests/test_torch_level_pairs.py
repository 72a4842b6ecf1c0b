"""The level plans' host functions ``nd_block_order`` and ``tile_fill``
(``kkt/levels.py``) take each distinct block pair once: the plans come out
integer for integer as the JAX package's verbatim plans, which see every
scalar entry of the K pattern. CPU tests."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tulip_tpu  # noqa: F401
from golden_large import multiperiod_lp, scattered_coupling_lp, staircase_lp
from test_torch_fuzz import CONFIGS, config_lps
from tulip_tpu.kkt import levels as jlevels
from tulip_tpu.kkt import sparse as jsparse
from tulip_tpu.kkt import sparse_ldl as jk2
from tulip_tpu_torch.kkt import levels as tlevels
from tulip_tpu_torch.kkt import sparse as tsparse
from tulip_tpu_torch.kkt import sparse_ldl as tk2
from tulip_tpu_torch.kkt.sparse_ldl import dense_threshold

torch.set_num_threads(1)

# The LP's constraint matrix and the block size of its plan.
K1_LPS = {
    "staircase": (lambda: staircase_lp(2048)[0], 128),
    "dense-cols": (lambda: staircase_lp(2048, dense_cols=2)[0], 128),
    "cyclic": (lambda: staircase_lp(2048, cyclic=True)[0], 128),
    # m % 128 = 64: the partial last block is forced last.
    "partial-block": (lambda: staircase_lp(2112)[0], 128),
    "multiperiod": (lambda: multiperiod_lp(2048)[0], 128),
    # At 128 the gate refuses its tiles.
    "scattered": (lambda: scattered_coupling_lp(2048)[0], 64),
}


def plan_pattern(A):
    """The 0/1 CSR pattern that the sparse-first plan hands
    ``k1_level_plan_pattern``: A without its dense columns."""
    A = sp.csr_matrix(A)
    dense = np.diff(A.tocsc().indptr) >= dense_threshold(A.shape[0])
    A = (A @ sp.diags((~dense).astype(np.float64))).tocsr()
    A.eliminate_zeros()
    pattern = A.copy()
    pattern.data = np.ones_like(pattern.data, dtype=np.int32)
    return pattern


def assert_same_level_plan(got, want):
    assert got.ntiles == want.ntiles
    np.testing.assert_array_equal(got.tile_brow, want.tile_brow)
    np.testing.assert_array_equal(got.tile_bcol, want.tile_bcol)
    assert len(got.segs) == len(want.segs)
    for g, w in zip(got.segs, want.segs):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def assert_same_k1_plan(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got["perm"], want["perm"])
        np.testing.assert_array_equal(got["sup_idx"], want["sup_idx"])
        assert_same_level_plan(got["plan"], want["plan"])


@pytest.mark.parametrize("lp", sorted(K1_LPS))
def test_pattern_plan_is_the_verbatim_plan(lp):
    """``k1_level_plan_pattern`` on the sparse-first plan's pattern."""
    make, block = K1_LPS[lp]
    pattern = plan_pattern(make())
    want = jsparse.k1_level_plan_pattern(pattern, pattern.shape, block)
    got = tsparse.k1_level_plan_pattern(pattern, pattern.shape, block)
    assert want is not None
    assert_same_k1_plan(got, want)


@pytest.mark.parametrize("lp", sorted(K1_LPS))
def test_dense_plan_is_the_verbatim_plan(lp):
    """``k1_level_plan`` on the dense A (dense columns kept: their plan
    is refused by the gate on both sides)."""
    make, block = K1_LPS[lp]
    A = make().toarray()
    want = jsparse.k1_level_plan(A, block)
    got = tsparse.k1_level_plan(A, block)
    assert (want is None) == (lp == "dense-cols")
    assert_same_k1_plan(got, want)


@pytest.mark.parametrize("config", range(len(CONFIGS)))
def test_fuzz_patterns_give_the_verbatim_plan(config):
    """The fuzz battery's LPs (the first 20 of a configuration), at block
    sizes 1 and 2: the port's order and fill on the K pattern's block
    coordinates, and the whole plan with its gates open (the gates refuse
    LPs this small and dense)."""
    for jm in config_lps(config)[:20]:
        pb = jm.pbdata
        I, J, _ = pb.to_coo()
        pattern = sp.csr_matrix(
            (np.ones(len(I), np.int32), (I, J)), shape=(pb.ncon, pb.nvar))
        K = (pattern @ pattern.T).tocoo()
        for block in (1, 2):
            nbr = -(-pb.ncon // block)
            bi, bj = K.row // block, K.col // block
            last = [nbr - 1] if nbr > 1 else []
            np.testing.assert_array_equal(
                tlevels.nd_block_order(bi, bj, nbr, last=last),
                jlevels.nd_block_order(bi, bj, nbr, last=last))
            assert tlevels.tile_fill(bi, bj, nbr) == \
                jlevels.tile_fill(bi, bj, nbr)
            if nbr <= 2:
                continue
            want = jsparse.k1_level_plan_pattern(
                pattern, pattern.shape, block, gate=2.0, sup_cap=1.0)
            assert want is not None
            assert_same_k1_plan(tsparse.k1_level_plan_pattern(
                pattern, pattern.shape, block, gate=2.0, sup_cap=1.0), want)


@pytest.mark.parametrize("lp,block", [
    ("dense-cols", 64),
    ("probe-link24", 128),
])
def test_k2_level_plan_is_the_verbatim_plan(lp, block):
    """``"sparse-ldl"``'s ``k2_level_plan``: its node lanes and level
    plan."""
    if lp == "dense-cols":
        A = staircase_lp(1024, dense_cols=2)[0].toarray()
    else:
        A = staircase_lp(2048, dense_cols=24, dense_scale=1.0)[0].toarray()
    want = jk2.k2_level_plan(A, block)
    got = tk2.k2_level_plan(A, block)
    assert want is not None and got is not None
    (wn, wp, wN), (gn, gp, gN) = want, got
    assert gN == wN
    np.testing.assert_array_equal(gn, wn)
    assert_same_level_plan(gp, wp)


# On seeds 2, 7 and 8 the distinct pairs in sorted order would give
# another order: blocks up to 8 apart share a slot of a small set's table,
# so the adjacency sets' iteration order follows their insertion order.
@pytest.mark.parametrize("seed", [0, 2, 7, 8])
def test_scrambled_pairs_with_repeats(seed):
    """Block coordinates in a scrambled order, each pair repeated a
    random number of times, with a non-empty ``last``: the port gives
    the verbatim order and fill, and pass on each pair once, in the order
    of its first occurrence."""
    rng = np.random.default_rng(seed)
    nbr = int(rng.integers(12, 40))
    npairs = 3 * nbr
    i = rng.integers(0, nbr, npairs)
    j = np.clip(i + rng.integers(-8, 9, npairs), 0, nbr - 1)
    i = np.concatenate([i, np.arange(nbr)])
    j = np.concatenate([j, np.arange(nbr)])
    sym_i, sym_j = np.concatenate([i, j]), np.concatenate([j, i])
    reps = rng.integers(1, 6, sym_i.size)
    scramble = rng.permutation(int(reps.sum()))
    bi = np.repeat(sym_i, reps)[scramble].astype(np.int32)
    bj = np.repeat(sym_j, reps)[scramble].astype(np.int32)
    last = sorted(rng.choice(nbr, 3, replace=False).tolist())

    di, dj = tlevels.distinct_pairs(bi, bj, nbr)
    keys = bi.astype(np.int64) * nbr + bj
    assert di.size == np.unique(keys).size < bi.size
    seen = {}
    for k, pair in enumerate(zip(bi.tolist(), bj.tolist())):
        seen.setdefault(pair, k)
    assert list(zip(di.tolist(), dj.tolist())) == \
        sorted(seen, key=seen.get)

    np.testing.assert_array_equal(
        tlevels.nd_block_order(bi, bj, nbr, last=last),
        jlevels.nd_block_order(bi, bj, nbr, last=last))
    assert tlevels.tile_fill(bi, bj, nbr) == \
        jlevels.tile_fill(bi, bj, nbr)


def test_front_counts_entries_and_pairs():
    """``nd_block_order`` counts the coordinates handed in and the
    distinct pairs it works on in the open call record; ``tile_fill``
    counts nothing."""
    from tulip_tpu_torch import trace

    bi = np.array([0, 1, 0, 2, 1, 0, 2, 2])
    bj = np.array([1, 0, 1, 2, 0, 0, 1, 2])
    with trace.call("plan") as rec:
        tlevels.nd_block_order(bi, bj, 3)
        tlevels.tile_fill(bi, bj, 3)
    assert rec.record["counters"] == {"level_plan/entries": 8,
                                      "level_plan/block_pairs": 5}
