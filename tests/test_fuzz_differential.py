"""Randomized differential fuzz of the query boundary.

Thousands of generated (index, read set) pairs — mixed alphabets, dense
and sparse run structures, non-index bytes, empty/1-char/huge reads,
col-id edge values (0, 255, modular binning) — checked for exact PML+CID
agreement across the three implementations that anchor every validation
in this repo:

  native C++ engine  <->  NumPy oracle  <->  batched device engines

The C++ engine (native/colbwt_native.cpp) is the reference's algorithmic
shape (linear pred/succ scans + LF walk, include/col_bwt.hpp:498-574) and
the bench baseline; the oracle is the cited executable spec; the device
engines are the product.  Equality through the oracle hub implies the
engine<->C++ equality the validations rely on.  C++<->oracle runs
~1,500 cases (no compilation cost); the device engines run a bounded set
of cases per engine (each distinct table shape is a fresh XLA compile).
"""

from __future__ import annotations

import numpy as np
import pytest

from colbwt_tpu.io import native
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")

ALPHABETS = [b"ACGT", b"AC", b"ACGTN", bytes(range(60, 80)), b"Z"]


def _random_case(rng):
    """A random (table, reads) pair through the real construction ops."""
    alph = ALPHABETS[int(rng.integers(0, len(ALPHABETS)))]
    nd = int(rng.integers(1, 5))
    if rng.random() < 0.5 and nd >= 2:  # SNP-style near-identical docs
        L = int(rng.integers(30, 900))
        base = rng.choice(np.frombuffer(alph, np.uint8), L)
        docs = []
        for _ in range(nd):
            a = base.copy()
            k = int(rng.integers(0, max(1, L // 20)))
            a[rng.integers(0, L, k)] = rng.choice(
                np.frombuffer(alph, np.uint8), k)
            docs.append(a.tobytes())
    else:  # independent random docs, varied lengths
        docs = [rng.choice(np.frombuffer(alph, np.uint8),
                           int(rng.integers(2, 600))).tobytes()
                for _ in range(nd)]

    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    thr = O.compute_thresholds(heads, lens, lcp)

    n = int(lens.sum())
    if rng.random() < 0.5 and len(docs) >= 2:
        # real col ids through the split pipeline
        fl = O.build_fl_table(heads, lens)
        ml, mp = O.find_multi_mums(ranks, sa, lcp, doc_ids, nd,
                                   int(rng.integers(5, 20)))
        mpos, mids, mhts = O.col_split_oracle(
            fl, ml, mp, nd, int(rng.integers(1, 8)),
            "tunnels" if rng.random() < 0.5 else "all")
        bits, ids = O.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads,
                                           fl.n)
    else:
        # synthetic ids hitting the 8-bit edges (0, 1, 255) on random
        # boundaries — the id_bits budget of include/common/common.hpp:47
        k = int(rng.integers(0, 6))
        bits = np.unique(rng.integers(0, n, k)) if k else np.empty(0,
                                                                   np.int64)
        ids = rng.choice(np.array([0, 1, 2, 254, 255], np.int64),
                         bits.size)
    tbl = O.build_col_pml(heads, lens, np.asarray(bits, np.int64),
                          np.asarray(ids, np.int64), thr)

    reads = []
    n_reads = int(rng.integers(1, 9))
    for _ in range(n_reads):
        style = rng.random()
        if style < 0.12:
            reads.append(b"")
        elif style < 0.24:
            reads.append(bytes([int(rng.choice(list(alph)))]))
        elif style < 0.36:  # non-index bytes mixed in
            m = int(rng.integers(1, 80))
            a = rng.choice(np.frombuffer(alph + b"XY#~", np.uint8), m)
            reads.append(a.tobytes())
        elif style < 0.48:  # huge read
            m = int(rng.integers(1000, 4000))
            reads.append(rng.choice(np.frombuffer(alph, np.uint8),
                                    m).tobytes())
        else:  # substring of a document with a few errors
            d = docs[int(rng.integers(0, nd))]
            m = min(len(d), int(rng.integers(1, 150)))
            s = int(rng.integers(0, len(d) - m + 1))
            a = bytearray(d[s:s + m])
            for _ in range(int(rng.integers(0, 3))):
                a[int(rng.integers(0, m))] = int(rng.choice(list(alph)))
            reads.append(bytes(a))
    return tbl, reads


def test_fuzz_cpp_vs_oracle_thousands():
    """~1,500 random cases: the native C++ engine and the NumPy oracle
    agree exactly on PML and CID for every read."""
    rng = np.random.default_rng(0xF022)
    cases = 0
    reads_total = 0
    while cases < 1500:
        tbl, reads = _random_case(rng)
        p_cpp, c_cpp = native.query_pml_serial(tbl, reads)
        for j, rd in enumerate(reads):
            p_or, c_or = O.query_pml_oracle(tbl, rd)
            np.testing.assert_array_equal(
                p_cpp[j], p_or, err_msg=f"case {cases} read {j} PML")
            np.testing.assert_array_equal(
                c_cpp[j], c_or, err_msg=f"case {cases} read {j} CID")
        reads_total += len(reads)
        cases += 1
    assert reads_total > 4000


@pytest.mark.parametrize("engine", ["xla", "mega", "pos"])
def test_fuzz_device_engines_vs_cpp(engine):
    """A bounded set of random cases per device engine (each table shape
    is a fresh compile): batched device results equal the C++ engine."""
    from colbwt_tpu.pipeline.engines import QueryEngines
    from colbwt_tpu.utils.config import ColBwtConfig

    rng = np.random.default_rng(0xE0F2 + hash(engine) % 1000)
    done = 0
    attempts = 0
    while done < 4 and attempts < 40:
        attempts += 1
        tbl, reads = _random_case(rng)
        if tbl.r < 4:
            continue
        index = ColPmlIndex.build(tbl, ff_bound=2)
        cfg = ColBwtConfig(engine=engine, batch_size=64)
        try:
            eng = QueryEngines(index, cfg, total_chars=None, table_dir=None)
        except Exception:
            continue  # engine not viable for this table (e.g. pos budget)
        short = [rd for rd in reads if len(rd) <= cfg.long_read_len]
        if not short:
            continue
        padded = 1 << (max(max(len(r) for r in short), 1) - 1).bit_length()
        res = eng.dispatch(short, padded)
        p, c, lens = QueryEngines.materialize(res)
        W = p.shape[1]
        p_cpp, c_cpp = native.query_pml_serial(tbl, short)
        for j, rd in enumerate(short):
            m = int(lens[j])
            np.testing.assert_array_equal(
                p[j, W - m:], p_cpp[j],
                err_msg=f"{engine} case {done} read {j} PML")
            np.testing.assert_array_equal(
                c[j, W - m:], c_cpp[j],
                err_msg=f"{engine} case {done} read {j} CID")
        done += 1
    assert done == 4, f"only {done} viable cases for {engine}"
