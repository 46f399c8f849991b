#!/usr/bin/env python3
"""BASELINE config #5 composed rehearsal — ONE run through the real CLI:

  1. `col-bwt build --sa-mode chunked` over 128 x 18 Mbp FASTA files
     (n = 2.304e9 > 2**31: the wide two-limb index, built by the chunked
     lane — per-chunk SA-IS + rank merge + Beller-BFS LCP, no global SA);
  2. `col-bwt query --stream` of 10,000,000 x 150 bp reads against that
     index (bounded-memory streaming driver, slim transfers);
  3. exactness spot-checks of the emitted .split.pml.bin/.split.cid.bin
     records against the single-core C++ engine.

This composes what rounds 1-3 validated only in isolation, the way the
reference's shipped pipeline composes by construction
(the reference's scripts/col-bwt.py:94-198).  Build and query run as
separate CLI subprocesses, each with fresh device state and RSS-sampled;
this process holds no device while they run (one process per card).
"""

from __future__ import annotations

import argparse
import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(msg):
    print(f"[cfg5] {msg}", file=sys.stderr, flush=True)


def sample_rss(pid: int, stop: threading.Event, out: dict, tag: str):
    peak = 0.0
    vals = []
    while not stop.is_set():
        try:
            with open(f"/proc/{pid}/status") as fh:
                for line in fh:
                    if line.startswith("VmRSS:"):
                        gb = int(line.split()[1]) / 1e6
                        vals.append(gb)
                        peak = max(peak, gb)
                        break
        except OSError:
            break
        stop.wait(2.0)
    out[tag] = {"peak_gb": peak,
                "median_gb": float(np.median(vals)) if vals else 0.0}


def run_sampled(cmd: list[str], tag: str, rss: dict, env=None) -> float:
    from colbwt_tpu.utils.hbm import require_no_device_held

    require_no_device_held(f"CLI child ({tag})")
    log(f"exec ({tag}): {' '.join(cmd)}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env)
    stop = threading.Event()
    th = threading.Thread(target=sample_rss, args=(proc.pid, stop, rss, tag),
                          daemon=True)
    th.start()
    rc = proc.wait()
    stop.set()
    th.join(timeout=5)
    dt = time.perf_counter() - t0
    if rc != 0:
        log(f"{tag} FAILED rc={rc} after {dt:.0f}s")
        sys.exit(rc)
    log(f"{tag} done in {dt:.0f}s, RSS {rss.get(tag)}")
    return dt


def scan_records(path: Path, want: dict[int, None]) -> dict[int, np.ndarray]:
    """Stream the length-prefixed u16 record file, keeping only record
    indices in `want` (3 GB files must not be read whole)."""
    out: dict[int, np.ndarray] = {}
    i = 0
    with path.open("rb") as fh:
        while True:
            hdr = fh.read(2)
            if not hdr:
                break
            (nlen,) = struct.unpack("<H", hdr)
            fh.seek(nlen, 1)
            (cnt,) = struct.unpack("<Q", fh.read(8))
            if i in want:
                out[i] = np.frombuffer(fh.read(cnt * 2), dtype="<u2")
            else:
                fh.seek(cnt * 2, 1)
            i += 1
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=128)
    ap.add_argument("--doc-len", type=int, default=18_000_000)
    ap.add_argument("--muts", type=int, default=300)
    ap.add_argument("--reads", type=int, default=10_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--check", type=int, default=128)
    ap.add_argument("--min-mum", type=int, default=100)
    ap.add_argument("--chunk-chars", type=int, default=600_000_000)
    ap.add_argument("--workdir", type=str, default=str(REPO / ".bench_cache" / "cfg5"))
    args = ap.parse_args()

    from colbwt_tpu.io import FastaRecord, native, write_fasta

    assert native.available()
    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    rss: dict = {}
    t_all = time.perf_counter()
    rng = np.random.default_rng(0xC5C5)
    ACGT = np.frombuffer(b"ACGT", np.uint8)

    # --- input FASTAs (the real CLI input surface) ---------------------------
    N, L = args.docs, args.doc_len
    base = rng.choice(ACGT, L)
    fastas = []
    mut_draws = []  # (pos, sub) per doc, for regenerating docs w/o the files
    for d in range(N):
        pos = rng.integers(0, L, args.muts)
        sub = rng.integers(0, 4, args.muts)
        mut_draws.append((pos, sub))
        f = wd / f"doc{d:03d}.fa"
        fastas.append(str(f))
        if not f.exists():
            a = base.copy()
            a[pos] = ACGT[sub]
            write_fasta(f, [FastaRecord(f"doc{d}", a.tobytes())])
    log(f"{N} FASTAs x {L:,} bp ready "
        f"({time.perf_counter() - t_all:.0f}s)  n = {(L + 1) * N:,}")

    # --- reads FASTA ---------------------------------------------------------
    reads_f = wd / "reads.fa"
    check_idx = sorted(
        int(i) for i in np.random.default_rng(0x51DE).choice(
            args.reads, size=args.check, replace=False))
    if not reads_f.exists():
        t = time.perf_counter()
        with reads_f.open("w") as fh:
            B = 100_000
            for lo in range(0, args.reads, B):
                cnt = min(B, args.reads - lo)
                dsel = rng.integers(0, N, cnt)
                ssel = rng.integers(0, L - args.read_len, cnt)
                nerr = rng.integers(0, 4, cnt)
                for j in range(cnt):
                    d = int(dsel[j])
                    a = base[ssel[j]:ssel[j] + args.read_len].copy()
                    pos, sub = mut_draws[d]
                    # apply doc d's mutations that fall inside the window
                    inw = (pos >= ssel[j]) & (pos < ssel[j] + args.read_len)
                    a[pos[inw] - ssel[j]] = ACGT[sub[inw]]
                    for _ in range(int(nerr[j])):
                        a[int(rng.integers(0, args.read_len))] = ACGT[
                            int(rng.integers(0, 4))]
                    fh.write(f">r{lo + j}\n")
                    fh.write(a.tobytes().decode())
                    fh.write("\n")
        log(f"reads.fa written: {args.reads:,} x {args.read_len} bp "
            f"({time.perf_counter() - t:.0f}s, "
            f"{reads_f.stat().st_size / 1e9:.1f} GB)")

    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"

    # --- 1. CLI build through the chunked lane -------------------------------
    idx_prefix = wd / "index"
    cli = [sys.executable, "-m", "colbwt_tpu.cli"]
    if not (wd / "index.colpml.npz").exists():
        build_s = run_sampled(
            cli + ["build", "-o", str(idx_prefix), "-l", str(args.min_mum),
                   "-v", "--sa-mode", "chunked",
                   "--chunk-chars", str(args.chunk_chars)] + fastas,
            "build", rss, env=env)
    else:
        build_s = 0.0
        log("index exists, skipping build")

    # --- 2. CLI streaming query ---------------------------------------------
    stream_s = run_sampled(
        cli + ["query", str(idx_prefix), "-p", str(reads_f), "--stream",
               "-v"],
        "stream", rss, env=env)
    log(f"composed total: build {build_s:.0f}s + stream {stream_s:.0f}s "
        f"-> {args.reads / max(stream_s, 1e-9):,.0f} reads/s streamed")

    # --- 3. exactness spot checks vs C++ ------------------------------------
    from colbwt_tpu.io import formats as F
    from colbwt_tpu.ops import oracle as O

    t = time.perf_counter()
    heads, lens = F.read_rlbwt(f"{idx_prefix}.fa", 5)
    thr = F.read_thresholds_file(f"{idx_prefix}.fa.thr_pos", 5)
    bv = F.read_sdsl_bit_vector(f"{idx_prefix}.fa.col_runs")
    ids = F.read_col_ids(f"{idx_prefix}.fa.col_ids", 1)
    tbl = O.build_col_pml(heads, lens, np.flatnonzero(bv),
                          ids.astype(np.int64), thr.astype(np.int64))
    log(f"oracle table rebuilt from CLI artifacts "
        f"({time.perf_counter() - t:.0f}s)")

    # pull the checked reads back out of reads.fa (streamed)
    from colbwt_tpu.io.fasta import stream_fasta

    want = {i: None for i in check_idx}
    reads_chk: dict[int, bytes] = {}
    for i, rec in enumerate(stream_fasta(reads_f)):
        if i in want:
            reads_chk[i] = rec.seq.upper()
            if len(reads_chk) == len(want):
                break
    pml_rec = scan_records(Path(f"{reads_f}.split.pml.bin"), want)
    cid_rec = scan_records(Path(f"{reads_f}.split.cid.bin"), want)

    t = time.perf_counter()
    subset = [reads_chk[i] for i in check_idx]
    pml_cpp, cid_cpp = native.query_pml_serial(tbl, subset)
    dt = time.perf_counter() - t
    log(f"C++ check ({len(subset)} reads): {dt:.2f}s "
        f"({len(subset) / dt:,.0f} reads/s 1-core)")
    for j, i in enumerate(check_idx):
        np.testing.assert_array_equal(pml_rec[i].astype(np.int64),
                                      pml_cpp[j], err_msg=f"PML read {i}")
        np.testing.assert_array_equal(cid_rec[i].astype(np.int64),
                                      cid_cpp[j], err_msg=f"CID read {i}")
    log(f"EXACT MATCH on {len(subset)} streamed records vs C++ "
        f"(n = {(L + 1) * N:,})")
    log(f"config #5 composed rehearsal done in "
        f"{time.perf_counter() - t_all:.0f}s  RSS: {rss}")


if __name__ == "__main__":
    main()
