#!/usr/bin/env python3
"""Per-phase profile of the chunked build tail (the host-bound part of a
chunked build).

Times each sub-phase separately on a synthetic SNP collection:
  per chunk: rank text prep, SA-IS, bwt/doc extraction, merge_ranks,
             kpos[sa] gather, merge_emit
  then: Beller LCP, thresholds, (optionally) the MUM scan.

Usage: python scripts/profile_build_tail.py [--docs 16] [--doc-len 18e6]
       [--chunk-chars 100e6] [--skip-mums]
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
    print(f"[prof] {msg}", file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=16)
    ap.add_argument("--doc-len", type=float, default=18e6)
    ap.add_argument("--muts", type=int, default=300)
    ap.add_argument("--chunk-chars", type=float, default=100e6)
    ap.add_argument("--skip-mums", action="store_true")
    ap.add_argument("--skip-lcp", action="store_true")
    args = ap.parse_args()

    from colbwt_tpu.io import native
    from colbwt_tpu.ops import construct_chunked as CC
    from colbwt_tpu.ops import oracle as O

    assert native.available()
    rng = np.random.default_rng(0x9B0F)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    N, L = args.docs, int(args.doc_len)
    base = rng.choice(ACGT, L)
    n_total = (L + 1) * N
    text = np.empty(n_total, np.uint8)
    doc_starts = np.zeros(N + 1, np.int64)
    pos = 0
    for d in range(N):
        a = base.copy()
        p = rng.integers(0, L, args.muts)
        a[p] = ACGT[rng.integers(0, 4, args.muts)]
        text[pos:pos + L] = a
        text[pos + L] = 1
        pos += L + 1
        doc_starts[d + 1] = pos
    log(f"collection: {N} x {L:,} bp  n = {n_total:,}")

    spans = CC.chunk_spans(doc_starts, int(args.chunk_chars))
    t_sais = t_prep = t_extract = t_ranks = t_gather = t_emit = 0.0
    heads = lens = doc_of = None
    n_a = 0
    seen: set[int] = set()
    classes, K = CC.symbol_classes(np.array([], np.uint8))
    t_stage = time.perf_counter()
    for ci, (dlo, dhi) in enumerate(spans):
        lo, hi = int(doc_starts[dlo]), int(doc_starts[dhi])
        t0 = time.perf_counter()
        text_b = np.ascontiguousarray(text[lo:hi])
        new = set(np.unique(text_b).tolist()) - seen
        if new:
            seen |= new
            classes, K = CC.symbol_classes(np.array(sorted(seen), np.uint8))
        local_starts = (doc_starts[dlo:dhi + 1] - lo).astype(np.int64)
        t_prep += time.perf_counter() - t0

        t0 = time.perf_counter()
        sa = CC._chunk_suffix_array(text_b, local_starts)
        t_sais += time.perf_counter() - t0

        t0 = time.perf_counter()
        bwt_b = text_b[sa - 1]
        doc_b = (np.searchsorted(local_starts, sa, side="right") - 1
                 + dlo).astype(np.uint16)
        t_extract += time.perf_counter() - t0

        if ci == 0:
            heads, lens = native.rle_encode(bwt_b)
            doc_of = doc_b
        else:
            t0 = time.perf_counter()
            kpos = native.bwt_merge_ranks(heads, lens, classes, K,
                                          text_b, local_starts)
            t_ranks += time.perf_counter() - t0
            t0 = time.perf_counter()
            karr = kpos[sa]
            del kpos
            t_gather += time.perf_counter() - t0
            t0 = time.perf_counter()
            heads, lens, doc_of = native.bwt_merge_emit(
                heads, lens, n_a, bwt_b, karr, doc_of, doc_b)
            t_emit += time.perf_counter() - t0
            del karr
        n_a += hi - lo
        del sa, bwt_b, text_b, doc_b
        log(f"  chunk {ci + 1}/{len(spans)}: n_a = {n_a:,} r = {heads.size:,}")
    t_rlbwt = time.perf_counter() - t_stage
    ns = lambda t: f"{t:7.1f}s ({t / n_total * 1e9:6.2f} ns/char)"
    log(f"RLBWT total  {ns(t_rlbwt)}")
    log(f"  prep       {ns(t_prep)}")
    log(f"  SA-IS      {ns(t_sais)}")
    log(f"  extract    {ns(t_extract)}")
    log(f"  merge_ranks{ns(t_ranks)}")
    log(f"  kpos[sa]   {ns(t_gather)}")
    log(f"  merge_emit {ns(t_emit)}")

    if not args.skip_lcp:
        t0 = time.perf_counter()
        lcp32 = CC.lcp_chunked(heads, lens, N)
        t_lcp = time.perf_counter() - t0
        log(f"Beller LCP   {ns(t_lcp)}")

        t0 = time.perf_counter()
        thr = O.compute_thresholds_fast(heads, lens, lcp32)
        t_thr = time.perf_counter() - t0
        log(f"thresholds   {ns(t_thr)}  (sum {int(thr.sum())})")

        if not args.skip_mums:
            from colbwt_tpu.ops import construct_jax as CJ

            t0 = time.perf_counter()
            rc = CC.run_change_from_runs(heads, lens)
            ml, mp = CJ.find_multi_mums_chunked(
                lcp32, doc_of, rc, N, 100)
            t_mum = time.perf_counter() - t0
            log(f"MUM scan     {ns(t_mum)}  ({ml.size} MUMs)")
    log(f"grand total  {time.perf_counter() - t_stage:.1f}s")


if __name__ == "__main__":
    main()
