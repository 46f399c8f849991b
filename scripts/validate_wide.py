#!/usr/bin/env python3
"""Wide-index validation: build + query an index at n >= 2**31 end-to-end
(BASELINE config #5 capability; the reference's integer budget is n < 2**40,
include/ds/LF_table.hpp:36-39).

Default shape: 128 haplotype-like documents x 18 Mbp = n ~ 2.304e9 > 2**31.
Construction is host-side (SA-IS, Kasai, packed-reduceat thresholds, int64
tunneled col-split) with the multi-MUM scan streamed through the device in
fixed chunks; querying runs on the two-limb mega-wide engine with exactness
checked against the single-core C++ engine.

Stage artifacts cache under --workdir so a crashed run resumes.
RAM budget: peak ~90 GB during SA-IS at the default n (33 bytes/char + text
+ doc ids); use --docs/--doc-len to scale down.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(msg):
    print(f"[wide] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=128)
    ap.add_argument("--doc-len", type=int, default=18_000_000)
    ap.add_argument("--muts", type=int, default=300)
    ap.add_argument("--reads", type=int, default=65_536)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--check", type=int, default=256)
    ap.add_argument("--min-mum", type=int, default=100)
    ap.add_argument("--split-rate", type=int, default=10)
    ap.add_argument("--workdir", type=str, default=str(REPO / ".bench_cache" / "wide"))
    args = ap.parse_args()

    from colbwt_tpu.io import native
    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.ops import construct_jax as CJ
    from colbwt_tpu.ops import oracle as O
    from colbwt_tpu.ops.colruns_vec import find_col_runs_uniform
    from colbwt_tpu.ops.colsplit_jax import col_split_tunneled_numpy
    from colbwt_tpu.utils.log import enable_compilation_cache

    enable_compilation_cache()
    assert native.available(), "native helpers required at this scale"
    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)

    t_all = time.perf_counter()
    rng = np.random.default_rng(0x51DE)
    ACGT = np.frombuffer(b"ACGT", np.uint8)

    # --- collection (documents materialized straight into the concat) -----
    N = args.docs
    L = args.doc_len
    n = (L + 1) * N
    wide_real = n > 2**31
    log(f"n = {n:,} over {N} docs "
        f"({'WIDE' if wide_real else 'narrow (forced-wide smoke)'})")

    base = rng.choice(ACGT, L)
    text = np.empty(n, dtype=np.uint8)
    mut_pos = []
    for d in range(N):
        seg = text[d * (L + 1):d * (L + 1) + L]
        seg[:] = base
        pos = rng.integers(0, L, args.muts)
        seg[pos] = ACGT[rng.integers(0, 4, args.muts)]
        mut_pos.append(pos)
        text[d * (L + 1) + L] = 1  # TERMINATOR byte
    del base
    # distinct ascending separator ranks (concat_collection semantics,
    # oracle.concat_collection:41-67) without doubling memory:
    # rank = byte + N for real bytes, 1 + d for the separator of document d
    ranks = text.astype(np.int64)
    ranks += N
    sep_idx = (np.arange(N, dtype=np.int64) * (L + 1)) + L
    ranks[sep_idx] = 1 + np.arange(N, dtype=np.int64)
    log(f"collection built ({time.perf_counter() - t_all:.0f}s)")

    # --- SA + LCP (cached) -------------------------------------------------
    sa_f, lcp_f = wd / "sa.npy", wd / "lcp32.npy"
    if sa_f.exists() and lcp_f.exists():
        sa = np.load(sa_f, mmap_mode=None)
        log("SA loaded from cache")
    else:
        t = time.perf_counter()
        sa = native.suffix_array_sais(ranks)
        log(f"SA-IS: {time.perf_counter() - t:.0f}s")
        np.save(sa_f, sa)
    if lcp_f.exists():
        lcp32 = np.load(lcp_f)
        log("LCP loaded from cache")
    else:
        t = time.perf_counter()
        lcp = native.lcp_kasai(ranks, sa)
        log(f"Kasai: {time.perf_counter() - t:.0f}s")
        lcp32 = lcp.astype(np.int32)  # max LCP < doc_len << 2**31
        del lcp
        gc.collect()
        np.save(lcp_f, lcp32)

    # --- RLBWT (cached) -----------------------------------------------------
    rle_f = wd / "rle.npz"
    if rle_f.exists():
        z = np.load(rle_f)
        heads, lens = z["heads"], z["lens"]
        log("RLE loaded from cache")
    else:
        t = time.perf_counter()
        bwt = text[sa - 1]
        heads, lens = native.rle_encode(bwt)
        del bwt
        gc.collect()
        np.savez(rle_f, heads=heads, lens=lens)
        log(f"RLE: {time.perf_counter() - t:.0f}s")
    r = heads.size
    log(f"r = {r:,}  n/r = {n / r:.1f}")

    # --- multi-MUMs (device, chunked) + thresholds (host), cached ----------
    mums_f = wd / "mums.npz"
    if mums_f.exists():
        z = np.load(mums_f)
        ml, mp = z["ml"], z["mp"]
        del ranks, sa
        gc.collect()
        log("multi-MUMs loaded from cache")
    else:
        t = time.perf_counter()
        doc_of = (sa // (L + 1)).astype(np.int32)  # uniform doc layout
        run_change = np.ones(n, dtype=np.uint8)
        prev = ranks[sa - 1]
        np.not_equal(prev[1:], prev[:-1], out=run_change[1:].view(bool))
        del prev
        gc.collect()
        ml, mp = CJ.find_multi_mums_chunked(lcp32, doc_of, run_change, N,
                                            args.min_mum, log=log)
        del doc_of, run_change, ranks, sa
        gc.collect()
        np.savez(mums_f, ml=ml, mp=mp)
        log(f"multi-MUM scan: {time.perf_counter() - t:.0f}s  "
            f"mums = {ml.size:,}")

    thr_f = wd / "thr.npy"
    if thr_f.exists():
        thr = np.load(thr_f)
        log("thresholds loaded from cache")
    else:
        t = time.perf_counter()
        # thresholds consume int64 LCP values; positions exceed 2**31 (wide)
        thr = O.compute_thresholds_fast(heads, lens, lcp32)
        np.save(thr_f, thr)
        log(f"thresholds: {time.perf_counter() - t:.0f}s")
    del lcp32
    gc.collect()

    # --- col-split (host int64 tunneled walk), cached ------------------------
    colruns_f = wd / "colruns.npz"
    if colruns_f.exists():
        z = np.load(colruns_f)
        bits, ids = z["bits"], z["ids"]
        log("col-runs loaded from cache")
    else:
        t = time.perf_counter()
        fl = O.build_fl_table(heads, lens)
        mpos, mids, mhts = col_split_tunneled_numpy(fl, ml, mp, N,
                                                    args.split_rate)
        log(f"col-split: {time.perf_counter() - t:.0f}s  "
            f"marks = {mpos.size:,}")
        t = time.perf_counter()
        if mpos.size:
            bits, ids = find_col_runs_uniform(mpos, mids, N, fl.l_heads, fl.n)
        else:
            bits = np.empty(0, np.int64)
            ids = np.empty(0, np.int64)
        del fl
        gc.collect()
        np.savez(colruns_f, bits=bits, ids=ids)
        log(f"find_col_runs: {time.perf_counter() - t:.0f}s  "
            f"bits = {bits.size:,}")

    # --- index (run-split, wide layout); tbl always rebuilt (C++ check) ----
    t = time.perf_counter()
    tbl = O.build_col_pml(heads, lens, bits, ids, thr)
    index_f = wd / "index.npz"
    if index_f.exists():
        index = ColPmlIndex.load(index_f)
        log(f"index loaded from cache (col_pml rebuild "
            f"{time.perf_counter() - t:.0f}s)")
    else:
        index = ColPmlIndex.build(tbl, ff_bound=2, wide=True)
        index.save(index_f)
    log(f"col_pml+split: {time.perf_counter() - t:.0f}s  r' = {index.r:,}  "
        f"index bytes = {index.nbytes() / 1e9:.1f} GB  "
        f"build total = {time.perf_counter() - t_all:.0f}s")
    assert index.wide and index.idx.dtype == np.int64

    # --- reads (sampled from the concatenation, separator-free) ------------
    reads = []
    for _ in range(args.reads):
        d = int(rng.integers(0, N))
        s = d * (L + 1) + int(rng.integers(0, L - args.read_len))
        arr = bytearray(text[s:s + args.read_len].tobytes())
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, args.read_len))] = int(ACGT[int(rng.integers(0, 4))])
        reads.append(bytes(arr))
    del text
    gc.collect()

    # --- query (two-limb mega-wide engine) ---------------------------------
    import jax.numpy as jnp

    from colbwt_tpu.ops import query_mega_wide
    from colbwt_tpu.utils.xfer import device_put_chunked

    t = time.perf_counter()
    mt = query_mega_wide.build_mega_table_wide(index)
    tab = mt["mega"] if "mega" in mt else mt["percha"]
    tab.block_until_ready()
    tab_bytes = sum(v.nbytes for k, v in mt.items()
                    if k in ("mega", "shared", "percha"))
    log(f"mega-wide table ({'full' if 'mega' in mt else 'compact'}, "
        f"built on device): {time.perf_counter() - t:.0f}s "
        f"({tab_bytes / 1e9:.1f} GB on device)")

    M = args.read_len
    enc, lens_ = index.encode_patterns(reads, max_len=M)
    ej = device_put_chunked(enc)
    lj = jnp.asarray(lens_)
    t = time.perf_counter()
    p, c = query_mega_wide.query_batch_mega_wide(mt, ej, lj,
                                                 ff_bound=index.ff_bound)
    p.block_until_ready()
    log(f"first call (compile): {time.perf_counter() - t:.1f}s")
    best = 1e18
    for _ in range(2):
        t = time.perf_counter()
        p, c = query_mega_wide.query_batch_mega_wide(mt, ej, lj,
                                                     ff_bound=index.ff_bound)
        p.block_until_ready()
        best = min(best, time.perf_counter() - t)
    log(f"query: {best:.3f}s -> {len(reads) / best:,.0f} reads/s "
        f"(mega-wide, n = {n:,})")
    p = np.asarray(p)
    c = np.asarray(c)

    # --- exactness vs the single-core C++ engine ---------------------------
    t = time.perf_counter()
    pml_cpp, cid_cpp = native.query_pml_serial(tbl, reads[:args.check])
    dt = time.perf_counter() - t
    log(f"C++ check ({args.check} reads): {dt:.2f}s "
        f"({args.check / dt:,.0f} reads/s 1-core)")
    for b in range(args.check):
        m = int(lens_[b])
        np.testing.assert_array_equal(p[b, M - m:], pml_cpp[b])
        np.testing.assert_array_equal(c[b, M - m:], cid_cpp[b])
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    log(f"EXACT MATCH on {args.check} reads (wide device vs C++) at "
        f"n = {n:,}{' > 2**31' if wide_real else ' (forced-wide smoke)'}")
    log(f"peak host RSS: {rss:.1f} GB")
    log("wide validation done")


if __name__ == "__main__":
    main()
