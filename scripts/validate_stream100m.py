#!/usr/bin/env python3
"""BASELINE config #5, the literal 100M-read lane.

Streams 100,000,000 x 150 bp reads through the real CLI (`col-bwt query
--stream`) against the CLI-built n = 2.304e9 wide index from the config-5
composed rehearsal (validate_config5.py), then spot-checks sampled output
records against the single-core C++ engine.  The reference streams any
read count one record at a time (the reference's src/pml_query.cpp:73-86);
this closes the bounded-memory claim at the config's stated scale instead
of the 10M-read rehearsal scale.

Reads are written as fixed-width 162-byte FASTA records
(">r%08d\n" + 150 bp + "\n") so checked reads are retrieved by byte
offset instead of a 16 GB parse; generation is fully vectorized
(~10 min vs ~1.5 h for the per-read path in validate_config5.py).
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

REC_BYTES = 162  # ">r%08d\n" (11) + 150 bp + "\n"
READ_LEN = 150


def log(msg):
    print(f"[s100m] {msg}", file=sys.stderr, flush=True)


def sample_rss(pid: int, stop: threading.Event, out: dict, tag: str):
    peak, vals = 0.0, []
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
    out[tag] = {"peak_gb": round(peak, 2),
                "median_gb": round(float(np.median(vals)), 2) if vals else 0.0}


def load_docs(wd: Path, n_docs: int) -> np.ndarray:
    """Stack the config-5 doc FASTAs (one record each) into (N, L) uint8."""
    rows = []
    for d in range(n_docs):
        raw = (wd / f"doc{d:03d}.fa").read_bytes()
        nl = raw.index(b"\n")
        rows.append(np.frombuffer(raw[nl + 1:].replace(b"\n", b""), np.uint8))
    return np.stack(rows)


def gen_reads(path: Path, docs: np.ndarray, n_reads: int, rng) -> None:
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    N, L = docs.shape
    t0 = time.perf_counter()
    pow10 = 10 ** np.arange(7, -1, -1, dtype=np.int64)
    with path.open("wb") as fh:
        B = 500_000
        for lo in range(0, n_reads, B):
            cnt = min(B, n_reads - lo)
            # sorted doc selection: the gather walks one 18 MB doc at a
            # time instead of thrashing the 2.3 GB stack (record order in
            # the file is irrelevant — same random (doc, pos) sample)
            dsel = np.sort(rng.integers(0, N, cnt))
            ssel = rng.integers(0, L - READ_LEN, cnt)
            win = np.empty((cnt, READ_LEN), np.uint8)
            span = ssel[:, None] + np.arange(READ_LEN)
            for d in np.unique(dsel):
                m = dsel == d
                win[m] = docs[d][span[m]]
            nerr = rng.integers(0, 4, cnt)
            for slot in range(3):  # up to 3 sequencing-like errors per read
                hit = nerr > slot
                pos = rng.integers(0, READ_LEN, cnt)
                sub = ACGT[rng.integers(0, 4, cnt)]
                win[hit, pos[hit]] = sub[hit]
            rec = np.empty((cnt, REC_BYTES), np.uint8)
            rec[:, 0] = ord(">")
            rec[:, 1] = ord("r")
            ids = lo + np.arange(cnt, dtype=np.int64)
            rec[:, 2:10] = (ids[:, None] // pow10) % 10 + ord("0")
            rec[:, 10] = 10
            rec[:, 11:161] = win
            rec[:, 161] = 10
            fh.write(rec.tobytes())
            if (lo // B) % 40 == 0:
                log(f"  gen {lo + cnt:,}/{n_reads:,} "
                    f"({(lo + cnt) / (time.perf_counter() - t0):,.0f} reads/s)")
    log(f"reads written: {n_reads:,} x {READ_LEN} bp in "
        f"{time.perf_counter() - t0:.0f}s ({path.stat().st_size / 1e9:.1f} GB)")


def read_by_offset(path: Path, idx: list[int]) -> dict[int, bytes]:
    out = {}
    with path.open("rb") as fh:
        for i in idx:
            fh.seek(i * REC_BYTES + 11)
            out[i] = fh.read(READ_LEN)
    return out


def scan_records(path: Path, want: set[int]) -> dict[int, np.ndarray]:
    """Stream the length-prefixed u16 record file, keeping only wanted
    record indices (32 GB files must not be read whole)."""
    out, i = {}, 0
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
    ap.add_argument("--reads", type=int, default=100_000_000)
    ap.add_argument("--check", type=int, default=256)
    ap.add_argument("--docs", type=int, default=128)
    ap.add_argument("--workdir", type=str, default=str(REPO / ".bench_cache" / "cfg5"))
    ap.add_argument("--skip-gen", action="store_true")
    args = ap.parse_args()

    wd = Path(args.workdir)
    idx_prefix = wd / "index"
    assert (wd / "index.colpml.npz").exists(), "run validate_config5 first"
    rss: dict = {}
    t_all = time.perf_counter()

    reads_f = wd / "reads100m.fa"
    if not args.skip_gen and not reads_f.exists():
        docs = load_docs(wd, args.docs)
        log(f"docs loaded: {docs.shape} ({docs.nbytes / 1e9:.1f} GB)")
        gen_reads(reads_f, docs, args.reads, np.random.default_rng(0x100A))
        del docs

    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    cli = [sys.executable, "-m", "colbwt_tpu.cli"]
    cmd = cli + ["query", str(idx_prefix), "-p", str(reads_f), "--stream",
                 "-v"]
    from colbwt_tpu.utils.hbm import require_no_device_held

    require_no_device_held("CLI query child")
    log(f"exec: {' '.join(cmd)}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env)
    stop = threading.Event()
    th = threading.Thread(target=sample_rss,
                          args=(proc.pid, stop, rss, "stream"), daemon=True)
    th.start()
    rc = proc.wait()
    stop.set()
    th.join(timeout=5)
    stream_s = time.perf_counter() - t0
    if rc != 0:
        log(f"stream FAILED rc={rc} after {stream_s:.0f}s")
        sys.exit(rc)
    log(f"stream done: {stream_s:.0f}s -> "
        f"{args.reads / stream_s:,.0f} reads/s sustained, RSS {rss}")

    # --- exactness spot checks vs C++ ---------------------------------------
    from colbwt_tpu.io import formats as F
    from colbwt_tpu.io import native
    from colbwt_tpu.ops import oracle as O

    check_idx = sorted(int(i) for i in np.random.default_rng(0xC4EC).choice(
        args.reads, size=args.check, replace=False))
    reads_chk = read_by_offset(reads_f, check_idx)
    want = set(check_idx)
    t = time.perf_counter()
    pml_rec = scan_records(Path(f"{reads_f}.split.pml.bin"), want)
    cid_rec = scan_records(Path(f"{reads_f}.split.cid.bin"), want)
    log(f"output records scanned ({time.perf_counter() - t:.0f}s)")

    t = time.perf_counter()
    heads, lens = F.read_rlbwt(f"{idx_prefix}.fa", 5)
    thr = F.read_thresholds_file(f"{idx_prefix}.fa.thr_pos", 5)
    bv = F.read_sdsl_bit_vector(f"{idx_prefix}.fa.col_runs")
    ids = F.read_col_ids(f"{idx_prefix}.fa.col_ids", 1)
    tbl = O.build_col_pml(heads, lens, np.flatnonzero(bv),
                          ids.astype(np.int64), thr.astype(np.int64))
    log(f"oracle table rebuilt from CLI artifacts "
        f"({time.perf_counter() - t:.0f}s)")
    subset = [reads_chk[i] for i in check_idx]
    t = time.perf_counter()
    pml_cpp, cid_cpp = native.query_pml_serial(tbl, subset)
    log(f"C++ check ({len(subset)} reads): {time.perf_counter() - t:.2f}s")
    for j, i in enumerate(check_idx):
        np.testing.assert_array_equal(pml_rec[i].astype(np.int64), pml_cpp[j],
                                      err_msg=f"PML read {i}")
        np.testing.assert_array_equal(cid_rec[i].astype(np.int64), cid_cpp[j],
                                      err_msg=f"CID read {i}")
    log(f"EXACT MATCH on {len(subset)} sampled records vs C++")
    log(f"100M-read lane done in {time.perf_counter() - t_all:.0f}s  "
        f"sustained {args.reads / stream_s:,.0f} reads/s  RSS {rss}")


if __name__ == "__main__":
    main()
