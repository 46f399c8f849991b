#!/usr/bin/env python3
"""BASELINE config #3 validation: SARS-CoV-2-shaped collection — many
documents, tiny n/d, high-d tunneling.

Synthetic stand-in (zero-egress environment): N_DOCS low-divergence 30 kb
genomes, tunneled col-split at rate 10, 150 bp reads.  Checks exact
PML+CID equality engine-vs-single-core-C++ on a read subset and reports
stage timings + throughput.  Scale with --docs.
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
    print(f"[cfg3] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=2_000)
    ap.add_argument("--doc-len", type=int, default=30_000)
    ap.add_argument("--muts", type=int, default=12)
    ap.add_argument("--hotspots", type=int, default=600,
                    help="mutations concentrate on this many recurrent sites "
                         "(low-divergence collections share conserved "
                         "segments between hotspots; fully random mutation "
                         "sites would leave no window conserved across ALL "
                         "documents)")
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--check", type=int, default=512)
    ap.add_argument("--mode", choices=("tunnels", "all"), default="tunnels",
                    help="col-split mode; 'all' exercises the fragment-event "
                         "walk (col_split_all_numpy) at full document count")
    args = ap.parse_args()

    from colbwt_tpu.io import native
    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.ops import construct_jax as CJ
    from colbwt_tpu.ops import oracle as O
    from colbwt_tpu.ops.colsplit_jax import col_split_jax
    from colbwt_tpu.ops.colruns_vec import (find_col_runs_mixed,
                                            find_col_runs_uniform)
    from colbwt_tpu.utils.log import enable_compilation_cache

    enable_compilation_cache()
    assert native.available(), "native helpers required at this scale"

    rng = np.random.default_rng(0xC0F3)
    base = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), args.doc_len)
    sites = rng.choice(args.doc_len, args.hotspots, replace=False)
    docs = []
    for _ in range(args.docs):
        a = base.copy()
        pos = rng.choice(sites, args.muts, replace=False)
        a[pos] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), args.muts)
        docs.append(a.tobytes())

    t0 = time.perf_counter()
    text, ranks, doc_ids = O.concat_collection(docs)
    n = text.size
    log(f"n = {n:,} over {args.docs} docs (n/d = {n / args.docs:.0f})")

    t = time.perf_counter()
    sa = native.suffix_array_sais(ranks)
    log(f"SA-IS: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    lcp = native.lcp_kasai(ranks, sa)
    log(f"Kasai: {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    log(f"RLE+FL: {time.perf_counter() - t:.1f}s  r = {heads.size:,}")

    t = time.perf_counter()
    ml, mp = CJ.find_multi_mums_jax(ranks, sa, lcp, doc_ids, args.docs, 20)
    log(f"multi-MUM scan: {time.perf_counter() - t:.1f}s  mums = {ml.size}")
    t = time.perf_counter()
    if args.mode == "all":
        from colbwt_tpu.ops.colsplit_jax import col_split_all_numpy

        mpos, mids, mhts = col_split_all_numpy(fl, ml, mp, args.docs, 10)
    else:
        mpos, mids, mhts = col_split_jax(fl, ml, mp, args.docs, 10, "tunnels")
    log(f"col-split ({args.mode}): {time.perf_counter() - t:.1f}s  "
        f"marks = {mpos.size:,}")
    t = time.perf_counter()
    if mhts.size and (mhts == mhts[0]).all():
        bits, ids = find_col_runs_uniform(mpos, mids, int(mhts[0]),
                                          fl.l_heads, fl.n)
    else:
        bits, ids = find_col_runs_mixed(mpos, mids, mhts, fl.l_heads, fl.n)
    log(f"find_col_runs: {time.perf_counter() - t:.1f}s  bits = {bits.size:,}")
    t = time.perf_counter()
    thr = CJ.compute_thresholds_jax(heads, lens, lcp)
    tbl = O.build_col_pml(heads, lens, bits, ids, thr)
    index = ColPmlIndex.from_table(tbl)  # pos/xla path: no run splitting
    log(f"col_pml+index: {time.perf_counter() - t:.1f}s  "
        f"r = {index.r:,}  build total = {time.perf_counter() - t0:.1f}s")

    # ---- query: best engine that fits -----------------------------------
    import jax.numpy as jnp

    from colbwt_tpu.ops import query_pos
    from colbwt_tpu.utils.xfer import device_put_chunked

    reads = []
    for _ in range(args.reads):
        d = docs[int(rng.integers(0, args.docs))]
        s = int(rng.integers(0, args.doc_len - 150))
        arr = bytearray(d[s:s + 150])
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, 150))] = int(rng.choice(list(b"ACGT")))
        reads.append(bytes(arr))

    # mirror the engine ladder: ACGT-restricted keys reach higher k / larger
    # n than general keys (pipeline/engines.py does the same)
    alpha = b"ACGT"
    k = query_pos.choose_k(index, 12 << 30, alphabet=alpha)
    if k < 1:
        alpha = None
        k = query_pos.choose_k(index, 12 << 30)
    log(f"pos engine k = {k}"
        + (" (ACGT keys)" if alpha and k >= 1 else ""))
    if k >= 1:
        t = time.perf_counter()
        pt = query_pos.build_pos_tables(index, k, alphabet=alpha)
        pt["table"].block_until_ready()
        log(f"pos tables: {time.perf_counter() - t:.1f}s "
            f"({pt['table'].nbytes / 1e9:.1f} GB)")
        M = -(-150 // k) * k
        enc, lens_, bad = query_pos._encode_digits(index, pt, reads, M)
        assert not bad.any()  # reads are pure ACGT here
        ej = device_put_chunked(enc)
        lj = jnp.asarray(lens_)
        p, c = query_pos.query_batch_pos(pt["table"], pt["n"], ej, lj,
                                         k=k, A=pt["A"])
        p.block_until_ready()
        best = 1e18
        for _ in range(3):
            t = time.perf_counter()
            p, c = query_pos.query_batch_pos(pt["table"], pt["n"], ej, lj,
                                             k=k, A=pt["A"])
            p.block_until_ready()
            best = min(best, time.perf_counter() - t)
        log(f"query: {best:.3f}s -> {len(reads) / best:,.0f} reads/s")
        p = np.asarray(p)
        c = np.asarray(c)
        pml_dev = [p[b, M - int(lens_[b]):] for b in range(args.check)]
        cid_dev = [c[b, M - int(lens_[b]):] for b in range(args.check)]
    else:
        log("pos tables do not fit; skipping device throughput")
        pml_dev = cid_dev = None

    # ---- exactness vs single-core C++ ------------------------------------
    t = time.perf_counter()
    pml_cpp, cid_cpp = native.query_pml_serial(tbl, reads[:args.check])
    dt = time.perf_counter() - t
    log(f"C++ check ({args.check} reads): {dt:.2f}s "
        f"({args.check / dt:,.0f} reads/s 1-core)")
    if pml_dev is not None:
        for b in range(args.check):
            np.testing.assert_array_equal(pml_dev[b], pml_cpp[b])
            np.testing.assert_array_equal(cid_dev[b], cid_cpp[b])
        log(f"EXACT MATCH on {args.check} reads (device vs C++)")
    log("config #3 validation done")


if __name__ == "__main__":
    main()
