#!/usr/bin/env python3
"""Reader-alone benchmark: stream_fasta throughput on gzipped FASTQ.

Real read sets are gzipped FASTQ, and the reader feeds the streaming
query driver, so it must not be the bottleneck.  Target >= 1M reads/s on
.fastq.gz (150 bp records).

Generates N reads of FASTQ (vectorized fixed-width records), gzips them
(zlib level 1 — the level does not matter for DEcompression speed), and
times full stream_fasta passes over .fastq.gz, .fastq, and .fa variants.
"""

from __future__ import annotations

import argparse
import sys
import time
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(msg):
    print(f"[reader] {msg}", file=sys.stderr, flush=True)


def gen_fastq(path: Path, n: int, m: int, gz: bool) -> None:
    rng = np.random.default_rng(0xFA57)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    pow10 = 10 ** np.arange(7, -1, -1, dtype=np.int64)
    rec_w = 11 + (m + 1) + 2 + (m + 1)  # @rNNNNNNNN\n seq\n +\n qual\n
    comp = zlib.compressobj(1, wbits=31) if gz else None
    t0 = time.perf_counter()
    with path.open("wb") as fh:
        B = 250_000
        for lo in range(0, n, B):
            cnt = min(B, n - lo)
            rec = np.empty((cnt, rec_w), np.uint8)
            rec[:, 0] = ord("@")
            rec[:, 1] = ord("r")
            ids = lo + np.arange(cnt, dtype=np.int64)
            rec[:, 2:10] = (ids[:, None] // pow10) % 10 + ord("0")
            rec[:, 10] = 10
            rec[:, 11:11 + m] = rng.integers(0, 4, (cnt, m))
            rec[:, 11:11 + m] = ACGT[rec[:, 11:11 + m] % 4]
            rec[:, 11 + m] = 10
            rec[:, 12 + m] = ord("+")
            rec[:, 13 + m] = 10
            rec[:, 14 + m:14 + 2 * m] = rng.integers(33, 74, (cnt, m))
            rec[:, 14 + 2 * m] = 10
            buf = rec.tobytes()
            fh.write(comp.compress(buf) if gz else buf)
        if gz:
            fh.write(comp.flush())
    log(f"generated {path.name}: {n:,} x {m} bp in "
        f"{time.perf_counter() - t0:.0f}s ({path.stat().st_size / 1e6:.0f} MB)")


def bench(path: Path, n: int) -> float:
    from colbwt_tpu.io.fasta import stream_fasta

    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        cnt = 0
        chars = 0
        for rec in stream_fasta(path):
            cnt += 1
            chars += len(rec.seq)
        dt = time.perf_counter() - t0
        assert cnt == n, (cnt, n)
        best = max(best, cnt / dt)
        log(f"  {path.name}: {cnt:,} reads in {dt:.2f}s -> "
            f"{cnt / dt:,.0f} reads/s ({chars / dt / 1e6:.0f} MB/s seq)")
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--workdir", type=str, default=str(REPO / ".bench_cache" / "reader"))
    args = ap.parse_args()
    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)

    fq_gz = wd / "reads.fastq.gz"
    fq = wd / "reads.fastq"
    if not fq_gz.exists():
        gen_fastq(fq_gz, args.reads, args.read_len, gz=True)
    if not fq.exists():
        gen_fastq(fq, args.reads, args.read_len, gz=False)
    r_gz = bench(fq_gz, args.reads)
    r_fq = bench(fq, args.reads)
    log(f"BEST: gzipped FASTQ {r_gz:,.0f} reads/s | plain FASTQ "
        f"{r_fq:,.0f} reads/s (target >= 1M reads/s gzipped)")


if __name__ == "__main__":
    main()
