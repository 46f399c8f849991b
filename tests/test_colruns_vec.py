"""Vectorized find_col_runs (uniform + mixed heights) vs the heapq oracle."""

import numpy as np
import pytest

from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops.colruns_vec import find_col_runs_mixed, find_col_runs_uniform
from tests.conftest import random_docs


def _compare(p, ids, N, heads, n):
    h = np.full(p.size, N, dtype=np.int64)
    b1, i1 = O.find_col_runs_oracle(p, ids, h, heads, n)
    b2, i2 = find_col_runs_uniform(p, ids, N, heads, n)
    np.testing.assert_array_equal(b2, b1)
    np.testing.assert_array_equal(i2, i1)


def test_uniform_sweep_random(rng):
    for trial in range(30):
        n = int(rng.integers(50, 400))
        N = int(rng.integers(2, 9))
        m = int(rng.integers(1, 40))
        p = np.sort(rng.choice(n, size=min(m, n), replace=False)).astype(np.int64)
        ids = rng.integers(0, 5, p.size).astype(np.int64)  # include id 0
        r = int(rng.integers(2, 30))
        heads = np.sort(rng.choice(n, size=min(r, n), replace=False)).astype(np.int64)
        if heads[0] != 0:
            heads[0] = 0
            heads = np.unique(heads)
        _compare(p, ids, N, heads, n)


def test_uniform_sweep_edges(rng):
    n = 100
    heads = np.array([0, 10, 50, 90], dtype=np.int64)
    # overlapping chains, ends beyond n, adjacent/touching intervals,
    # start == end of previous, zero ids
    cases = [
        (np.array([0, 3, 6]), np.array([1, 2, 3]), 4),       # chained overlap
        (np.array([95, 97]), np.array([1, 2]), 8),           # ends beyond n
        (np.array([5, 9]), np.array([1, 2]), 4),             # touching e==p
        (np.array([5, 9]), np.array([0, 0]), 4),             # all-zero ids
        (np.array([0]), np.array([7]), 100),                 # covers everything
        (np.array([42]), np.array([3]), 1),                  # unit interval
        (np.array([10, 12, 14, 40]), np.array([1, 0, 2, 3]), 6),
    ]
    for p, ids, N in cases:
        _compare(p.astype(np.int64), ids.astype(np.int64), N, heads, n)


def _compare_mixed(p, ids, h, heads, n):
    b1, i1 = O.find_col_runs_oracle(p, ids, h, heads, n)
    b2, i2 = find_col_runs_mixed(p, ids, h, heads, n)
    np.testing.assert_array_equal(b2, b1)
    np.testing.assert_array_equal(i2, i1)


def test_mixed_sweep_random(rng):
    for trial in range(40):
        n = int(rng.integers(50, 400))
        m = int(rng.integers(1, 50))
        p = np.sort(rng.choice(n, size=min(m, n), replace=False)).astype(np.int64)
        ids = rng.integers(0, 5, p.size).astype(np.int64)  # include id 0
        h = rng.integers(1, 12, p.size).astype(np.int64)   # mixed heights
        r = int(rng.integers(2, 30))
        heads = np.sort(rng.choice(n, size=min(r, n), replace=False)).astype(np.int64)
        if heads[0] != 0:
            heads[0] = 0
            heads = np.unique(heads)
        _compare_mixed(p, ids, h, heads, n)


def test_mixed_sweep_edges():
    n = 100
    heads = np.array([0, 10, 50, 90], dtype=np.int64)
    cases = [
        # nested: outer interval survives inner's end (transfer)
        (np.array([5, 8]), np.array([1, 2]), np.array([20, 4])),
        # identical intervals (duplicate heap tuples)
        (np.array([5, 5]), np.array([1, 2]), np.array([6, 6])),
        # equal ends from different starts (heap tie order)
        (np.array([5, 8]), np.array([1, 2]), np.array([7, 4])),
        # end of one == start of next (no close strictly-before)
        (np.array([5, 11]), np.array([1, 2]), np.array([6, 3])),
        # tall short + shallow long overlapping
        (np.array([0, 2, 4]), np.array([3, 1, 2]), np.array([3, 30, 3])),
        # ends beyond n stay open forever
        (np.array([95, 96]), np.array([1, 2]), np.array([50, 2])),
        # zero-id marks open/close coverage without claiming
        (np.array([5, 30]), np.array([0, 4]), np.array([10, 10])),
        # end exactly at n
        (np.array([90]), np.array([3]), np.array([10])),
    ]
    for p, ids, h in cases:
        _compare_mixed(p.astype(np.int64), ids.astype(np.int64),
                       h.astype(np.int64), heads, n)


def test_mixed_sweep_real_all_mode(rng):
    base = bytes(rng.choice(list(b"ACGT"), 400).astype("uint8"))
    docs = random_docs(rng, 4, mutate_from=base)
    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, 4, 5)
    mpos, mids, mhts = O.col_split_oracle(fl, ml, mp, 4, 1, "all")
    assert np.unique(mhts).size > 1  # genuinely mixed heights
    _compare_mixed(mpos, mids, mhts, fl.l_heads, fl.n)


def test_uniform_sweep_real_pipeline(rng):
    base = bytes(rng.choice(list(b"ACGT"), 400).astype("uint8"))
    docs = random_docs(rng, 4, mutate_from=base)
    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, 4, 5)
    mpos, mids, mhts = O.col_split_oracle(fl, ml, mp, 4, 2, "tunnels")
    assert (mhts == 4).all()
    _compare(mpos, mids, 4, fl.l_heads, fl.n)


def test_mixed_sweep_fuzz_large(rng):
    """Heavier fuzz for the All-mode sweep as fragment walks scale up:
    clustered marks, heights up to n,
    dense run heads, thousands of marks per trial."""
    for trial in range(12):
        n = int(rng.integers(2_000, 20_000))
        m = int(rng.integers(200, 2_000))
        # clustered positions: half uniform, half packed into a hot region
        hot = int(rng.integers(0, n // 2))
        p = np.concatenate([
            rng.choice(n, size=m // 2, replace=False),
            hot + rng.choice(min(n - hot, m * 2), size=m // 2, replace=False),
        ])
        p = np.unique(p).astype(np.int64)
        ids = rng.integers(0, 7, p.size).astype(np.int64)
        # mixed heights: mostly small (fragment-like), some huge
        h = np.where(rng.random(p.size) < 0.9,
                     rng.integers(1, 40, p.size),
                     rng.integers(n // 4, n, p.size)).astype(np.int64)
        r = int(rng.integers(50, 800))
        heads = np.unique(np.r_[0, rng.choice(n, size=r, replace=False)]
                          ).astype(np.int64)
        _compare_mixed(p, ids, h, heads, n)
