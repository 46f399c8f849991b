"""Bounded-memory streaming query driver (the 100M-read lane).

`query_pipeline` materializes every read and every output in host lists —
fine for millions of reads, not for the HPRC config's "100M reads streamed"
workload (config #5 in BASELINE.json).  `query_stream` keeps host memory flat:

- reads arrive through io.fasta.stream_fasta (one ~32 MB slab at a time),
- batches dispatch in strict input order, two deep, so the device computes
  batch i+1 while the host drains batch i (JAX async dispatch),
- PML/CID records append to the .split.*.bin files as each batch lands
  (io.pml_out.PmlCidBinaryWriter), never accumulating in memory.

The reference streams one read at a time through a single-threaded scan
(src/pml_query.cpp:73-86); this is the same bounded-memory contract at
device batch width.  Outputs are byte-identical to query_pipeline's on the
same input (tests/test_stream.py).
"""

from __future__ import annotations

from collections import deque
from pathlib import Path

import numpy as np

from colbwt_tpu.io.fasta import stream_fasta
from colbwt_tpu.io.pml_out import PmlCidBinaryWriter
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.utils.config import ColBwtConfig
from colbwt_tpu.utils.log import Timer, get_logger


def query_stream(index_prefix: str, pattern_file: str,
                 cfg: ColBwtConfig | None = None,
                 max_pending: int = 2) -> dict:
    """Stream PATTERN through the index; returns run stats (reads, chars,
    seconds, reads_per_s).  Outputs land at PATTERN.split.pml.bin/.cid.bin,
    records in input order."""
    from colbwt_tpu.pipeline.engines import QueryEngines

    cfg = cfg or ColBwtConfig()
    logger = get_logger("colbwt.stream", cfg.verbose)
    timer = Timer().start()

    index = ColPmlIndex.load(f"{index_prefix}.colpml.npz")
    eng = QueryEngines(index, cfg, total_chars=None,
                       table_dir=f"{index_prefix}.tables")
    logger.info("streaming %s with engine %s", pattern_file, eng.name)
    for ev in eng.cache_events:
        logger.info("table cache: %s", ev)

    out_pml = f"{pattern_file}.split.pml.bin"
    out_cid = f"{pattern_file}.split.cid.bin"
    total_reads = 0
    total_chars = 0
    # pending: (names, sizes, dispatch-result) in input order, bounded depth
    pending: deque = deque()

    def drain_one(writer: PmlCidBinaryWriter) -> None:
        names, result = pending.popleft()
        p, c, lens = QueryEngines.materialize(result)
        W = p.shape[1]
        writer.append(names,
                      [p[j, W - int(lens[j]):] for j in range(len(names))],
                      [c[j, W - int(lens[j]):] for j in range(len(names))])

    def flush_long(writer: PmlCidBinaryWriter, names: list[str],
                   reads: list[bytes]) -> None:
        # long reads are rare; preserve order by draining everything first
        while pending:
            drain_one(writer)
        p, c = eng.query_long_reads(reads)
        writer.append(names, p, c)

    with PmlCidBinaryWriter(out_pml, out_cid) as writer:
        batch_names: list[str] = []
        batch_reads: list[bytes] = []
        long_names: list[str] = []
        long_reads: list[bytes] = []
        long_cap = max(1, cfg.batch_size // 16)

        def dispatch_batch() -> None:
            nonlocal batch_names, batch_reads
            if not batch_names:
                return
            m = max(max(len(r) for r in batch_reads), 1)
            padded = 1 << (m - 1).bit_length()
            while len(pending) >= max_pending:
                drain_one(writer)
            pending.append((batch_names,
                            eng.dispatch(batch_reads, padded)))
            batch_names, batch_reads = [], []

        for rec in stream_fasta(pattern_file):
            seq = rec.seq.upper()
            total_reads += 1
            total_chars += len(seq)
            if eng.supports_long_streaming() and len(seq) > cfg.long_read_len:
                long_names.append(rec.name)
                long_reads.append(seq)
                if len(long_reads) >= long_cap:
                    dispatch_batch()  # keep input order
                    flush_long(writer, long_names, long_reads)
                    long_names, long_reads = [], []
                continue
            if long_reads:  # a short read after queued long ones: flush order
                dispatch_batch()
                flush_long(writer, long_names, long_reads)
                long_names, long_reads = [], []
            batch_names.append(rec.name)
            batch_reads.append(seq)
            if len(batch_reads) >= cfg.batch_size:
                dispatch_batch()
        dispatch_batch()
        if long_reads:
            flush_long(writer, long_names, long_reads)
        while pending:
            drain_one(writer)
        assert writer.records == total_reads

    timer.end()
    secs = timer.start_duration
    logger.info("streamed %d reads (%d chars) in %.2fs (%.0f reads/s)",
                total_reads, total_chars, secs,
                total_reads / max(secs, 1e-9))
    return {"reads": total_reads, "chars": total_chars, "seconds": secs,
            "reads_per_s": total_reads / max(secs, 1e-9),
            "pml_path": str(Path(out_pml)), "cid_path": str(Path(out_cid))}
