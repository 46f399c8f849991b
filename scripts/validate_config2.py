#!/usr/bin/env python3
"""BASELINE config #2 validation: E. coli-class collection (8 docs x 5 Mbp
= 40 Mbp) end-to-end through the REAL pipeline (build_pipeline on FASTA
files), then device queries with single-core C++ exactness checks.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(msg):
    print(f"[cfg2] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=8)
    ap.add_argument("--doc-len", type=int, default=5_000_000)
    ap.add_argument("--muts", type=int, default=2_500)
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--check", type=int, default=512)
    ap.add_argument("--min-mum", type=int, default=40)
    ap.add_argument("--run-split", choices=("auto", "always"), default="auto")
    ap.add_argument("--workdir", type=str, default=str(REPO / ".bench_cache" / "cfg2"))
    ap.add_argument("--query-only", action="store_true",
                    help="reuse the workdir's built index (same rng draw "
                    "sequence regenerates identical docs/reads) — for a "
                    "clean query re-measure after a contended build run")
    args = ap.parse_args()

    from colbwt_tpu.io import FastaRecord, native, write_fasta
    from colbwt_tpu.ops import oracle as O
    from colbwt_tpu.pipeline import build_pipeline
    from colbwt_tpu.pipeline.engines import QueryEngines
    from colbwt_tpu.utils.config import ColBwtConfig
    from colbwt_tpu.utils.log import enable_compilation_cache

    enable_compilation_cache()
    assert native.available()
    wd = Path(args.workdir)
    if args.query_only:
        assert (wd / "index.colpml.npz").exists(), "no built index to reuse"
    else:
        if wd.exists():
            shutil.rmtree(wd)
        wd.mkdir(parents=True)

    rng = np.random.default_rng(0xC2)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    base = rng.choice(ACGT, args.doc_len)
    docs = []
    fastas = []
    for i in range(args.docs):
        a = base.copy()
        pos = rng.integers(0, args.doc_len, args.muts)
        a[pos] = rng.choice(ACGT, args.muts)
        docs.append(a.tobytes())
        if not args.query_only:
            f = wd / f"doc{i}.fa"
            write_fasta(f, [FastaRecord(f"doc{i}", docs[-1])])
            fastas.append(str(f))
    del base
    log(f"collection: {args.docs} x {args.doc_len:,} bp"
        + (" regenerated (query-only)" if args.query_only
           else " FASTAs written"))

    cfg = ColBwtConfig(min_mum=args.min_mum, run_split=args.run_split,
                       verbose=True)
    if args.query_only:
        from colbwt_tpu.models.index import ColPmlIndex

        index = ColPmlIndex.load(wd / "index.colpml.npz")
        log(f"index loaded from workdir: r = {index.r:,}")
    else:
        t0 = time.perf_counter()
        index = build_pipeline(fastas, str(wd / "index"), cfg=cfg)
        build_s = time.perf_counter() - t0
        log(f"BUILD END-TO-END: {build_s:.1f}s  r = {index.r:,}  "
            f"ff_bound = {index.ff_bound}")

    # reads
    reads = []
    for _ in range(args.reads):
        d = docs[int(rng.integers(0, args.docs))]
        s = int(rng.integers(0, args.doc_len - 150))
        arr = bytearray(d[s:s + 150])
        for _ in range(int(rng.integers(0, 4))):
            arr[int(rng.integers(0, 150))] = int(rng.choice(list(b"ACGT")))
        reads.append(bytes(arr))

    t = time.perf_counter()
    eng = QueryEngines(index, cfg, total_chars=args.reads * 150)
    log(f"engine {eng.name} tables: {time.perf_counter() - t:.1f}s")
    # one-shot batch timing through the engine dispatch path
    t = time.perf_counter()
    res = eng.dispatch(reads, 160)
    p, c, lens_ = QueryEngines.materialize(res)
    first = time.perf_counter() - t
    log(f"first dispatch (compile): {first:.1f}s")
    best = 1e18
    for _ in range(2):
        t = time.perf_counter()
        res = eng.dispatch(reads, 160)
        p, c, lens_ = QueryEngines.materialize(res)
        best = min(best, time.perf_counter() - t)
    log(f"query: {best:.3f}s -> {len(reads) / best:,.0f} reads/s "
        f"({eng.name})")

    # C++ exactness on the unsplit oracle table
    from colbwt_tpu.io import formats as F

    heads, lens = F.read_rlbwt(str(wd / "index.fa"), cfg.rw_bytes)
    thr = F.read_thresholds_file(str(wd / "index.fa.thr_pos"), cfg.rw_bytes)
    bv = F.read_sdsl_bit_vector(str(wd / "index.fa.col_runs"))
    ids = F.read_col_ids(str(wd / "index.fa.col_ids"), 1)
    tbl = O.build_col_pml(heads, lens, np.flatnonzero(bv),
                          ids.astype(np.int64), thr.astype(np.int64))
    t = time.perf_counter()
    pml_cpp, cid_cpp = native.query_pml_serial(tbl, reads[:args.check])
    dt = time.perf_counter() - t
    log(f"C++ check ({args.check} reads): {dt:.2f}s "
        f"({args.check / dt:,.0f} reads/s 1-core)")
    W = p.shape[1]
    for b in range(args.check):
        m = int(lens_[b])
        np.testing.assert_array_equal(p[b, W - m:], pml_cpp[b])
        np.testing.assert_array_equal(c[b, W - m:], cid_cpp[b])
    log(f"EXACT MATCH on {args.check} reads (device vs C++)")
    log("config #2 validation done")


if __name__ == "__main__":
    main()
