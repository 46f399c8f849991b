#!/usr/bin/env python3
"""Streaming-query validation: 10M+ reads with flat host RSS
(the "100M reads streamed" lane of config #5 in BASELINE.json).

Builds a mid-size index, writes a multi-GB synthetic FASTA, then runs
pipeline.stream.query_stream while sampling the process RSS.  Records
sustained reads/s and the RSS envelope; spot-checks exactness on a sampled
subset vs the single-core C++ engine.
"""

from __future__ import annotations

import argparse
import resource
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def log(msg):
    print(f"[stream] {msg}", file=sys.stderr, flush=True)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class RssSampler(threading.Thread):
    """Samples current RSS from /proc (ru_maxrss only tracks the peak)."""

    def __init__(self, interval=2.0):
        super().__init__(daemon=True)
        self.samples: list[float] = []
        self.interval = interval
        self.stop = threading.Event()

    def run(self):
        pid = Path("/proc/self/statm")
        page = resource.getpagesize()
        while not self.stop.is_set():
            try:
                rss_pages = int(pid.read_text().split()[1])
                self.samples.append(rss_pages * page / 1e9)
            except Exception:
                pass
            time.sleep(self.interval)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=10_000_000)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--docs", type=int, default=4)
    ap.add_argument("--doc-len", type=int, default=1_000_000)
    ap.add_argument("--check", type=int, default=128)
    ap.add_argument("--workdir", type=str, default=str(REPO / ".bench_cache" / "stream"))
    ap.add_argument("--quiesce-pid", type=int, default=0,
                    help="SIGSTOP this PID during the measured stream "
                    "window (and SIGCONT it after) so a co-running batch "
                    "job doesn't pollute the sustained-throughput number")
    args = ap.parse_args()

    from colbwt_tpu.cli import main as cli_main
    from colbwt_tpu.io import native
    from colbwt_tpu.io import formats as F
    from colbwt_tpu.io.fasta import FastaRecord, write_fasta
    from colbwt_tpu.io.pml_out import read_pml_cid_binary
    from colbwt_tpu.ops import oracle as O
    from colbwt_tpu.pipeline import query_stream
    from colbwt_tpu.utils.config import ColBwtConfig
    from colbwt_tpu.utils.log import enable_compilation_cache

    enable_compilation_cache()
    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0x57BE)
    ACGT = np.frombuffer(b"ACGT", np.uint8)

    # --- index (bench-class) ------------------------------------------------
    if not (wd / "idx.colpml.npz").exists():
        base = rng.choice(ACGT, args.doc_len)
        for i in range(args.docs):
            d = base.copy()
            pos = rng.integers(0, args.doc_len, 1000)
            d[pos] = ACGT[rng.integers(0, 4, pos.size)]
            write_fasta(wd / f"s{i}.fa", [FastaRecord("c", d.tobytes())])
        rc = cli_main(["build", "-o", str(wd / "idx"), "-l", "40", "--keep"]
                      + [str(wd / f"s{i}.fa") for i in range(args.docs)])
        assert rc == 0
    docs = []
    from colbwt_tpu.io.fasta import read_fasta

    for i in range(args.docs):
        docs.append(b"".join(r.seq for r in read_fasta(wd / f"s{i}.fa")))

    # --- reads file (written in slabs; multi-GB at 10M+) --------------------
    reads_fa = wd / "reads.fa"
    if not reads_fa.exists() or True:  # regenerate: sizes may change
        t = time.perf_counter()
        with reads_fa.open("wb") as fh:
            B = 100_000
            for off in range(0, args.reads, B):
                k = min(B, args.reads - off)
                d_idx = rng.integers(0, args.docs, k)
                starts = rng.integers(0, args.doc_len - args.read_len, k)
                lines = []
                for j in range(k):
                    s = int(starts[j])
                    lines.append(b">r%d\n%s\n" % (
                        off + j,
                        docs[int(d_idx[j])][s:s + args.read_len]))
                fh.write(b"".join(lines))
        log(f"reads file: {reads_fa.stat().st_size / 1e9:.1f} GB "
            f"({time.perf_counter() - t:.0f}s)")

    # --- stream -------------------------------------------------------------
    import signal

    rss_before = rss_gb()
    sampler = RssSampler()
    sampler.start()
    cfg = ColBwtConfig(batch_size=16384)
    import os

    if args.quiesce_pid:
        # NOTE: only safe for processes you own directly — a supervised
        # process's parent may treat the stop as a failure and kill it
        log(f"quiescing pid {args.quiesce_pid} for the measured window")
        try:
            os.kill(args.quiesce_pid, signal.SIGSTOP)
        except ProcessLookupError:
            log("quiesce target already gone")
    try:
        stats = query_stream(str(wd / "idx"), str(reads_fa), cfg)
    finally:
        if args.quiesce_pid:
            try:
                os.kill(args.quiesce_pid, signal.SIGCONT)
                log(f"resumed pid {args.quiesce_pid}")
            except ProcessLookupError:
                pass
    sampler.stop.set()
    log(f"sustained: {stats['reads_per_s']:,.0f} reads/s over "
        f"{stats['reads']:,} reads ({stats['seconds']:.0f}s)")
    if sampler.samples:
        s = np.array(sampler.samples)
        log(f"RSS during stream: min {s.min():.2f} / median "
            f"{np.median(s):.2f} / max {s.max():.2f} GB "
            f"(peak ru_maxrss {rss_gb():.2f} GB, before-stream "
            f"{rss_before:.2f} GB)")

    # --- exactness spot check ----------------------------------------------
    assert native.available()
    heads, lens = F.read_rlbwt(wd / "idx.fa")
    thr = F.read_thresholds_file(wd / "idx.fa.thr_pos")
    bv = F.read_sdsl_bit_vector(wd / "idx.fa.col_runs")
    ids = F.read_col_ids(wd / "idx.fa.col_ids")
    tbl = O.build_col_pml(heads, lens, np.flatnonzero(bv),
                          ids.astype(np.int64), thr.astype(np.int64))
    names, pmls = read_pml_cid_binary(f"{reads_fa}.split.pml.bin")
    _, cids = read_pml_cid_binary(f"{reads_fa}.split.cid.bin")
    assert len(names) == args.reads
    pick = rng.integers(0, args.reads, args.check)
    # reread the sampled reads from the FASTA (bounded memory: by record id)
    want = {int(i) for i in pick}
    sampled = {}
    from colbwt_tpu.io.fasta import stream_fasta

    for j, rec in enumerate(stream_fasta(reads_fa)):
        if j in want:
            sampled[j] = rec.seq
        if len(sampled) == len(want):
            break
    seqs = [sampled[int(i)] for i in pick]
    pml_c, cid_c = native.query_pml_serial(tbl, seqs)
    for k, i in enumerate(pick):
        np.testing.assert_array_equal(pmls[int(i)], pml_c[k])
        np.testing.assert_array_equal(cids[int(i)], cid_c[k])
    log(f"EXACT MATCH on {args.check} sampled reads vs C++")
    log("streaming validation done")


if __name__ == "__main__":
    main()
