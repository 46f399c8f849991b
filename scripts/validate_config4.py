#!/usr/bin/env python3
"""BASELINE config #4 validation: 8 human-chr21-scale haplotypes (~370 Mbp
concatenated), single-host device-resident index.

Builds the index, queries it through the positional-automaton engine
(QueryEngines, with the persisted table cache) and checks exact PML+CID
equality vs the single-core C++ engine on a read subset.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(msg):
    print(f"[cfg4] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=8)
    ap.add_argument("--doc-len", type=int, default=46_000_000)
    ap.add_argument("--muts", type=int, default=25_000)
    ap.add_argument("--reads", type=int, default=65_536)
    ap.add_argument("--check", type=int, default=256)
    ap.add_argument("--min-mum", type=int, default=100)
    args = ap.parse_args()

    from colbwt_tpu.io import native
    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.ops import construct_jax as CJ
    from colbwt_tpu.ops import oracle as O
    from colbwt_tpu.ops import query_xla
    from colbwt_tpu.ops.colsplit_jax import col_split_jax
    from colbwt_tpu.ops.colruns_vec import (find_col_runs_mixed,
                                            find_col_runs_uniform)
    from colbwt_tpu.utils.log import enable_compilation_cache

    enable_compilation_cache()
    assert native.available(), "native helpers required at this scale"

    rng = np.random.default_rng(0xC4)
    base = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), args.doc_len)
    docs = []
    for _ in range(args.docs):
        a = base.copy()
        pos = rng.integers(0, args.doc_len, args.muts)
        a[pos] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), args.muts)
        docs.append(a.tobytes())
    del base

    t0 = time.perf_counter()
    text, ranks, doc_ids = O.concat_collection(docs)
    n = text.size
    log(f"n = {n:,} over {args.docs} docs")

    cache = REPO / ".bench_cache" / "cfg4_sa_cache.npz"
    cache.parent.mkdir(parents=True, exist_ok=True)
    if cache.exists():
        z = np.load(cache)
        sa, lcp = z["sa"], z["lcp"]
        log(f"SA+LCP loaded from {cache}")
    else:
        t = time.perf_counter()
        sa = native.suffix_array_sais(ranks)
        log(f"SA-IS: {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        lcp = native.lcp_kasai(ranks, sa)
        log(f"Kasai: {time.perf_counter() - t:.1f}s")
        np.savez(cache, sa=sa, lcp=lcp.astype(np.int32))
    t = time.perf_counter()
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    log(f"RLE+FL: {time.perf_counter() - t:.1f}s  r = {heads.size:,}")

    t = time.perf_counter()
    ml, mp = CJ.find_multi_mums_jax(ranks, sa, lcp, doc_ids, args.docs,
                                    args.min_mum)
    log(f"multi-MUM scan: {time.perf_counter() - t:.1f}s  mums = {ml.size:,}")
    t = time.perf_counter()
    mpos, mids, mhts = col_split_jax(fl, ml, mp, args.docs, 10, "tunnels")
    log(f"col-split (tunneled): {time.perf_counter() - t:.1f}s  "
        f"marks = {mpos.size:,}")
    t = time.perf_counter()
    if mhts.size and (mhts == mhts[0]).all():
        bits, ids = find_col_runs_uniform(mpos, mids, int(mhts[0]),
                                          fl.l_heads, fl.n)
    else:
        bits, ids = find_col_runs_mixed(mpos, mids, mhts, fl.l_heads, fl.n)
    log(f"find_col_runs: {time.perf_counter() - t:.1f}s  bits = {bits.size:,}")
    t = time.perf_counter()
    thr = O.compute_thresholds_fast(heads, lens, lcp)
    tbl = O.build_col_pml(heads, lens, bits, ids, thr)
    index = ColPmlIndex.from_table(tbl)  # unsplit; xla engine handles it
    log(f"col_pml+index: {time.perf_counter() - t:.1f}s  r = {index.r:,}  "
        f"index bytes = {index.nbytes() / 1e9:.1f} GB  "
        f"build total = {time.perf_counter() - t0:.1f}s")

    reads = []
    for _ in range(args.reads):
        d = docs[int(rng.integers(0, args.docs))]
        s = int(rng.integers(0, args.doc_len - 150))
        arr = bytearray(d[s:s + 150])
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, 150))] = int(rng.choice(list(b"ACGT")))
        reads.append(bytes(arr))

    import jax.numpy as jnp

    from colbwt_tpu.ops import query_pos
    from colbwt_tpu.utils.xfer import device_put_chunked

    from colbwt_tpu.utils.hbm import resolve_pos_budget

    k = query_pos.choose_k(index, resolve_pos_budget(0), alphabet=b"ACGT")
    if k >= 1:
        # build through QueryEngines so the persisted-table-cache policy
        # (pipeline/tables.py bandwidth-vs-build decision) runs and is
        # recorded at this table size
        from colbwt_tpu.pipeline.engines import QueryEngines
        from colbwt_tpu.utils.config import ColBwtConfig

        cfg = ColBwtConfig(engine="pos")
        t = time.perf_counter()
        eng = QueryEngines(index, cfg, total_chars=len(reads) * 150,
                           table_dir=str(REPO / ".bench_cache" / "cfg4_tables"))
        assert eng.use_pos and eng.pos_k == k, (eng.name, k)
        pt = eng.pt
        pt["table"].block_until_ready()
        log(f"pos tables k={k} (ACGT keys): {time.perf_counter() - t:.1f}s "
            f"({pt['table'].nbytes / 1e9:.1f} GB)")
        for ev in eng.cache_events:
            log(f"table cache: {ev}")
        M = -(-150 // k) * k
        dig, lens_, bad = query_pos._encode_digits(index, pt, reads, M)
        assert not bad.any()
        ej = device_put_chunked(dig)
        lj = jnp.asarray(lens_)
        run = lambda: query_pos.query_batch_pos(  # noqa: E731
            pt["table"], pt["n"], ej, lj, k=k, A=pt["A"])
        engine = f"pos k={k} ACGT"
    else:
        M = 150
        tb = query_xla.index_device_arrays(index)
        enc, lens_ = index.encode_patterns(reads, max_len=M)
        ej = device_put_chunked(enc)
        lj = jnp.asarray(lens_)
        run = lambda: query_xla.query_batch_device(  # noqa: E731
            tb, ej, lj, ff_bound=0)
        engine = "xla compact"
    t = time.perf_counter()
    p, c = run()
    p.block_until_ready()
    log(f"{engine} first call: {time.perf_counter() - t:.1f}s")
    best = 1e18
    for _ in range(2):
        t = time.perf_counter()
        p, c = run()
        p.block_until_ready()
        best = min(best, time.perf_counter() - t)
    log(f"query: {best:.3f}s -> {len(reads) / best:,.0f} reads/s ({engine})")
    p = np.asarray(p)
    c = np.asarray(c)

    t = time.perf_counter()
    pml_cpp, cid_cpp = native.query_pml_serial(tbl, reads[:args.check])
    dt = time.perf_counter() - t
    log(f"C++ check ({args.check} reads): {dt:.2f}s "
        f"({args.check / dt:,.0f} reads/s 1-core)")
    for b in range(args.check):
        m = int(lens_[b])
        np.testing.assert_array_equal(p[b, M - m:], pml_cpp[b])
        np.testing.assert_array_equal(c[b, M - m:], cid_cpp[b])
    log(f"EXACT MATCH on {args.check} reads (device vs C++)")
    log("config #4 validation done")


if __name__ == "__main__":
    main()
