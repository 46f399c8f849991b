#!/usr/bin/env python3
"""Beyond-one-host-RAM build validation: construct the full col-bwt index
with CHUNKED construction (ops/construct_chunked: per-chunk SA-IS, rank-based
BWT merge, LCP straight from the merged RLBWT) and query it, with exactness
checked against the single-core C++ engine.

The monolithic lane needs ~40 B/char for SA-IS + Kasai (~90 GB at n = 2.3e9,
scripts/validate_wide.py); this lane's peak is the CHUNK working set plus
~14 B/char of persistent arrays, so 2x the monolithic record fits the same
host.  Reference capability: PFP inside mumemto
(the reference's thirdparty/CMakeLists.txt:89-108, SURVEY hard part #3).

Default shape: 256 documents x 18 Mbp = n ~ 4.608e9 (2x the round-2 record)
in 1.16e9-char chunks.  Stage artifacts cache under --workdir so a crashed
run resumes.
"""

from __future__ import annotations

import argparse
import gc
import resource
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(msg):
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"[chunked] {msg}  [peak RSS {rss:.1f} GB]", file=sys.stderr,
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--doc-len", type=int, default=18_000_000)
    ap.add_argument("--muts", type=int, default=300)
    ap.add_argument("--chunk-chars", type=int, default=1_160_000_000)
    ap.add_argument("--reads", type=int, default=65_536)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--check", type=int, default=256)
    ap.add_argument("--min-mum", type=int, default=100)
    ap.add_argument("--split-rate", type=int, default=10)
    ap.add_argument("--workdir", type=str,
                    default=str(REPO / ".bench_cache" / "chunked"))
    ap.add_argument("--phase", choices=["all", "build", "query"],
                    default="all",
                    help="'build' or 'query' alone, or both in turn; a "
                         "query-only run builds from the stage caches")
    args = ap.parse_args()

    from colbwt_tpu.io import native
    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.ops import construct_chunked as CC
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
    rng = np.random.default_rng(0xC4C4)
    ACGT = np.frombuffer(b"ACGT", np.uint8)

    # --- collection --------------------------------------------------------
    N, L = args.docs, args.doc_len
    n = (L + 1) * N
    log(f"n = {n:,} over {N} docs, chunk = {args.chunk_chars:,} chars")
    base = rng.choice(ACGT, L)
    text = np.empty(n, dtype=np.uint8)
    for d in range(N):
        seg = text[d * (L + 1):d * (L + 1) + L]
        seg[:] = base
        pos = rng.integers(0, L, args.muts)
        seg[pos] = ACGT[rng.integers(0, 4, args.muts)]
        text[d * (L + 1) + L] = CC.TERMINATOR
    del base
    doc_starts = (np.arange(N + 1, dtype=np.int64) * (L + 1))
    log(f"collection built ({time.perf_counter() - t_all:.0f}s)")

    # --- chunked RLBWT + doc array (cached) ---------------------------------
    # Post-RLBWT, every n-sized input lives on disk and is memmap-sliced,
    # so the scan phase starts from a near-zero plateau and runs in
    # RSS-bounded worker subprocesses (mum_scan_stream module docstring).
    rle_f = wd / "rlbwt.npz"
    if rle_f.exists():
        z = np.load(rle_f)
        heads, lens = z["heads"], z["lens"]  # doc_of stays on disk
        log("chunked RLBWT loaded from cache")
    else:
        t = time.perf_counter()
        heads, lens, doc_of = CC.build_rlbwt_chunked(
            text, doc_starts, args.chunk_chars, log=log, cache_dir=wd)
        np.savez(rle_f, heads=heads, lens=lens, doc_of=doc_of)
        del doc_of
        log(f"chunked RLBWT total: {time.perf_counter() - t:.0f}s")
    if args.phase != "query":
        # build phases never touch text again (the query phase samples
        # reads from it); drop 1 B/char of plateau before the scan
        del text
        gc.collect()
    r = heads.size
    log(f"r = {r:,}  n/r = {n / r:.1f}")

    # --- LCP from the RLBWT (no SA), cached ---------------------------------
    lcp_f = wd / "lcp32.npy"
    if lcp_f.exists():
        log("LCP on disk (memmap)")
    else:
        t = time.perf_counter()
        lcp32 = CC.lcp_chunked(heads, lens, N)
        assert int(lcp32.min()) >= 0, "unset LCP entries"
        np.save(lcp_f, lcp32)
        del lcp32
        gc.collect()
        log(f"LCP from RLBWT (Beller BFS): {time.perf_counter() - t:.0f}s")
    lcp32 = np.load(lcp_f, mmap_mode="r")

    # --- thresholds + multi-MUMs, cached ------------------------------------
    thr_f = wd / "thr.npy"
    if thr_f.exists():
        thr = np.load(thr_f)
        log("thresholds loaded from cache")
    else:
        t = time.perf_counter()
        thr = O.compute_thresholds_fast(heads, lens, lcp32)
        np.save(thr_f, thr)
        log(f"thresholds: {time.perf_counter() - t:.0f}s")

    mums_f = wd / "mums.npz"
    if mums_f.exists():
        z = np.load(mums_f)
        ml, mp = z["ml"], z["mp"]
        log("multi-MUMs loaded from cache")
    else:
        from colbwt_tpu.ops import mum_scan_stream as MS

        t = time.perf_counter()
        doc_f = wd / "doc_of.u16.npy"
        rc_f = wd / "rc_bits.npy"
        if not rc_f.exists():
            MS.write_run_change_bits(heads, lens, rc_f)
            log("run-change bits written (packed)")
        if not doc_f.exists():
            MS.extract_npz_member(rle_f, "doc_of.npy", doc_f)
            log("doc array streamed out of the RLBWT cache")
        ml, mp = MS.find_multi_mums_streamed(
            lcp_f, doc_f, rc_f, N, args.min_mum, log=log)
        np.savez(mums_f, ml=ml, mp=mp)
        log(f"multi-MUM scan: {time.perf_counter() - t:.0f}s  "
            f"mums = {ml.size:,}")
    del lcp32
    gc.collect()

    # --- col-split + index ---------------------------------------------------
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

    t = time.perf_counter()
    tbl = O.build_col_pml(heads, lens, bits, ids, thr)
    index_f = wd / "index.npz"
    if index_f.exists():
        index = ColPmlIndex.load(index_f)
    else:
        index = ColPmlIndex.build(tbl, ff_bound=2, wide=True)
        index.save(index_f)
    log(f"col_pml+split: {time.perf_counter() - t:.0f}s  r' = {index.r:,}  "
        f"index bytes = {index.nbytes() / 1e9:.1f} GB  "
        f"build total = {time.perf_counter() - t_all:.0f}s")
    assert index.wide

    if args.phase == "build":
        log("build phase done (query skipped)")
        return

    # --- reads ---------------------------------------------------------------
    reads = []
    for _ in range(args.reads):
        d = int(rng.integers(0, N))
        s = d * (L + 1) + int(rng.integers(0, L - args.read_len))
        arr = bytearray(text[s:s + args.read_len].tobytes())
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, args.read_len))] = int(
                ACGT[int(rng.integers(0, 4))])
        reads.append(bytes(arr))
    del text
    gc.collect()

    # --- query (wide engine, device-built table) -----------------------------
    import jax.numpy as jnp

    from colbwt_tpu.ops import query_mega_wide
    from colbwt_tpu.utils.xfer import device_put_chunked

    t = time.perf_counter()
    mt = query_mega_wide.build_mega_table_wide(index)
    tab = mt["mega"] if "mega" in mt else mt["percha"]
    tab.block_until_ready()
    tab_bytes = sum(v.nbytes for k, v in mt.items()
                    if k in ("mega", "shared", "percha"))
    log(f"mega-wide table ({'full' if 'mega' in mt else 'compact'}, built on "
        f"device): {time.perf_counter() - t:.0f}s "
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

    # --- exactness vs the single-core C++ engine -----------------------------
    t = time.perf_counter()
    pml_cpp, cid_cpp = native.query_pml_serial(tbl, reads[:args.check])
    dt = time.perf_counter() - t
    log(f"C++ check ({args.check} reads): {dt:.2f}s "
        f"({args.check / dt:,.0f} reads/s 1-core)")
    for b in range(args.check):
        m = int(lens_[b])
        np.testing.assert_array_equal(p[b, M - m:], pml_cpp[b])
        np.testing.assert_array_equal(c[b, M - m:], cid_cpp[b])
    log(f"EXACT MATCH on {args.check} reads (chunked-construction index, "
        f"device vs C++) at n = {n:,}")
    log("chunked validation done")


if __name__ == "__main__":
    main()
