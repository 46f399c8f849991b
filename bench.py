#!/usr/bin/env python3
"""Benchmark: batched PML+CID device-query throughput vs single-core C++.

Runs on a GPU only; prints the device (platform, device_kind, count, and the
card's name and power limit from nvidia-smi) to stderr, then ONE JSON line:
  {"metric": "reads_per_sec_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": N, ...}

vs_baseline divides device reads/s by the single-core C++ reference engine
(native/colbwt_native.cpp — the reference's own algorithmic shape: linear
pred/succ scans + LF walk, include/col_bwt.hpp:498-574) measured on the
same host.  Only the device scan is timed (ROADMAP queue 1 item 1).

The index (4 x 1 Mbp mutated haplotypes, tunneled, split-rate 10) is built
once through the real pipeline and cached under .bench_cache/.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
CACHE = REPO / ".bench_cache"

N_DOCS = 4
DOC_LEN = 1_000_000
MUT = 20_000
N_READS = 262_144
READ_LEN = 150
BASELINE_READS = 1_024
_TABLE_BUILD_S = float("nan")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_docs() -> list[bytes]:
    rng = np.random.default_rng(0xBE7C)
    base = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), DOC_LEN)
    docs = []
    for _ in range(N_DOCS):
        a = base.copy()
        pos = rng.integers(0, DOC_LEN, MUT)
        a[pos] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), MUT)
        docs.append(a.tobytes())
    return docs


def get_index_and_table():
    """Returns (k=2 run-split index for the mega engine, unsplit oracle table
    for the C++ baseline)."""
    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.ops import oracle as O

    CACHE.mkdir(exist_ok=True)
    idx_path = CACHE / "bench_index_k2.npz"
    tbl_path = CACHE / "bench_tbl.npz"
    if idx_path.exists() and tbl_path.exists():
        log("[bench] loading cached index")
        index = ColPmlIndex.load(idx_path)
        z = np.load(tbl_path)
        tbl = O.LFTableArrays(
            char=z["char"], idx=z["idx"], length=z["length"],
            dest_interval=z["dest_interval"], dest_offset=z["dest_offset"],
            n=int(z["meta"][0]), r=int(z["meta"][1]),
            col_id=z["col_id"], threshold=z["threshold"],
            bwt_r=int(z["meta"][2]))
        return index, tbl

    from colbwt_tpu.io import native
    from colbwt_tpu.ops import construct_jax as CJ
    from colbwt_tpu.ops.colsplit_jax import col_split_jax

    log("[bench] building index (first run only)")
    docs = make_docs()
    t0 = time.perf_counter()
    text, ranks, doc_ids = O.concat_collection(docs)
    if native.available():
        sa = native.suffix_array_sais(ranks)
        lcp = native.lcp_kasai(ranks, sa)
    else:
        sa, _, pyr = CJ.suffix_array_jax(ranks, with_pyramid=True)
        lcp = CJ.lcp_jax(ranks, sa, pyr)
        del pyr
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    ml, mp = CJ.find_multi_mums_jax(ranks, sa, lcp, doc_ids, N_DOCS, 20)
    mpos, mids, mhts = col_split_jax(fl, ml, mp, N_DOCS, 10, "tunnels")
    bits, ids = O.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads, fl.n)
    thr = CJ.compute_thresholds_jax(heads, lens, lcp)
    tbl = O.build_col_pml(heads, lens, bits, ids, thr)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    log(f"[bench] build {time.perf_counter()-t0:.1f}s  n={fl.n} r={index.r} "
        f"mums={ml.size}")
    index.save(idx_path.with_suffix(""))
    np.savez_compressed(
        tbl_path, char=tbl.char, idx=tbl.idx, length=tbl.length,
        dest_interval=tbl.dest_interval, dest_offset=tbl.dest_offset,
        col_id=tbl.col_id, threshold=tbl.threshold,
        meta=np.array([tbl.n, tbl.r, tbl.bwt_r], dtype=np.int64))
    return index, tbl


def make_reads(docs_needed: bool = False) -> list[bytes]:
    rng = np.random.default_rng(0x5EED)
    docs = make_docs()
    reads = []
    for _ in range(N_READS):
        d = docs[int(rng.integers(0, N_DOCS))]
        s = int(rng.integers(0, DOC_LEN - READ_LEN))
        arr = bytearray(d[s:s + READ_LEN])
        for _ in range(int(rng.integers(0, 4))):  # sequencing-like errors
            arr[int(rng.integers(0, READ_LEN))] = int(rng.choice(list(b"ACGT")))
        reads.append(bytes(arr))
    return reads


def require_gpu() -> dict:
    """The device record every result carries; exits when JAX finds no
    GPU."""
    import subprocess

    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"[bench] needs a GPU, JAX found {d.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    dev = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices()), "card": smi.splitlines()[0]}
    log(f"[bench] device: {dev}")
    return dev


def bench_device(index, reads) -> float:
    import jax.numpy as jnp
    from colbwt_tpu.ops import query_pos

    k = query_pos.choose_k(index, alphabet=b"ACGT")
    t0 = time.perf_counter()
    pt = query_pos.build_pos_tables(index, k, alphabet=b"ACGT")
    pt["table"].block_until_ready()
    global _TABLE_BUILD_S
    _TABLE_BUILD_S = time.perf_counter() - t0
    log(f"[bench] pos tables k={k} (ACGT keys) built in "
        f"{_TABLE_BUILD_S:.1f}s ({pt['table'].nbytes / 1e6:.0f} MB)")
    from colbwt_tpu.utils.xfer import device_put_chunked

    M = -(-READ_LEN // k) * k  # key folding needs a multiple of k
    enc, lens, bad = query_pos._encode_digits(index, pt, reads, M)
    assert not bad.any()  # bench reads are pure ACGT
    enc_j = device_put_chunked(enc)
    lens_j = jnp.asarray(lens)

    t0 = time.perf_counter()
    p, c = query_pos.query_batch_pos(pt["table"], pt["n"], enc_j, lens_j,
                                     k=k, A=pt["A"])
    p.block_until_ready()
    log(f"[bench] first call (transfer+compile) {time.perf_counter()-t0:.1f}s")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        p, c = query_pos.query_batch_pos(pt["table"], pt["n"], enc_j, lens_j,
                                         k=k, A=pt["A"])
        p.block_until_ready()
        times.append(time.perf_counter() - t0)
    best = min(times)
    rps = len(reads) / best
    log(f"[bench] device scan: {best:.3f}s for {len(reads)} reads -> "
        f"{rps:.0f} reads/s")
    return rps


def bench_cpp(tbl, reads) -> float:
    """Median of 5 draws: a single-core baseline on a shared host swings
    run to run for reasons outside the code — the median pins it."""
    from colbwt_tpu.io import native

    if not native.available():
        log("[bench] native baseline unavailable; using recorded fallback")
        return float("nan")
    subset = reads[:BASELINE_READS]
    native.query_pml_serial(tbl, subset[:32])  # warm
    draws = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.query_pml_serial(tbl, subset)
        draws.append(len(subset) / (time.perf_counter() - t0))
    rps = float(np.median(draws))
    log(f"[bench] C++ 1-core: median {rps:.0f} reads/s over 5 draws "
        f"[{', '.join(f'{d:.0f}' for d in sorted(draws))}]")
    return rps


def main() -> None:
    from colbwt_tpu.utils.log import enable_compilation_cache

    device = require_gpu()
    enable_compilation_cache()
    index, tbl = get_index_and_table()
    reads = make_reads()
    dev_rps = bench_device(index, reads)
    cpp_rps = bench_cpp(tbl, reads)
    vs = dev_rps / cpp_rps if cpp_rps == cpp_rps and cpp_rps > 0 else 0.0
    print(json.dumps({
        "metric": "reads_per_sec_per_chip",
        "device": device,
        "value": round(dev_rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(vs, 2),
        "baseline_reads_per_s_median_of_5": round(cpp_rps, 1),
        "pos_table_build_s": round(_TABLE_BUILD_S, 1),
    }))


if __name__ == "__main__":
    main()
