"""Multi-host orchestration (SURVEY §5.8 — new design, no reference analog).

Topology: ``jax.distributed`` + a global dp×ip mesh over all devices.  The
index is replicated per host when it fits HBM, or interval-sharded over "ip"
(parallel.query_sharded).  Read batches shard by host: each process
owns the contiguous slice [pid * ceil(R / P), ...) of the input FASTA's reads,
writes its own part files, and process 0 concatenates them in read order —
deterministic output regardless of process count.

Runs unchanged single-process (P = 1), which is how CI exercises it; the
driver's dryrun covers the multi-device mesh path.

ASSUMPTION: the part-file merge requires a filesystem visible to every
process (a shared scratch filesystem across the hosts).  Without one,
point each host's pattern_file at local scratch and concatenate the part
files out of band — the record format is self-delimiting, so plain
byte concatenation in process order is the merge.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import jax

from colbwt_tpu.utils.log import get_logger


def init_distributed() -> tuple[int, int]:
    """Initialize jax.distributed from the standard env (JAX_COORDINATOR /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID) when present.

    Returns (process_id, num_processes)."""
    coord = os.environ.get("JAX_COORDINATOR")
    nproc = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if coord and nproc > 1:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=nproc,
            process_id=int(os.environ["JAX_PROCESS_ID"]),
        )
    return jax.process_index(), jax.process_count()


def host_read_slice(num_reads: int, pid: int, nproc: int) -> tuple[int, int]:
    """Contiguous per-host slice [lo, hi) of the global read list."""
    per = -(-num_reads // nproc)
    lo = min(pid * per, num_reads)
    return lo, min(lo + per, num_reads)


def merge_part_files(out_path: str | Path, part_paths: list[str | Path],
                     bufsize: int = 32 << 20) -> None:
    """Order-preserving concatenation of per-host binary record files
    (the record format is self-delimiting — pml_out layout).  Streamed in
    bounded buffers: part files from 100M-read runs are multi-GB."""
    with Path(out_path).open("wb") as out:
        for p in part_paths:
            with Path(p).open("rb") as fh:
                while True:
                    chunk = fh.read(bufsize)
                    if not chunk:
                        break
                    out.write(chunk)


def distributed_query(index, pattern_file: str, names: list[str],
                      reads: list[bytes], query_fn) -> tuple[list, list, list]:
    """Per-host slice → local query → part files → rank-0 merge.

    query_fn(reads_slice) -> (pmls, cids).  Returns this host's
    (names, pmls, cids) slice; rank 0 additionally writes the merged
    PATTERN.split.pml.bin / .split.cid.bin.
    """
    from colbwt_tpu.io.pml_out import write_pml_cid_binary

    logger = get_logger("colbwt.dist")
    pid, nproc = jax.process_index(), jax.process_count()
    lo, hi = host_read_slice(len(reads), pid, nproc)
    logger.info("process %d/%d: reads [%d, %d)", pid, nproc, lo, hi)

    local_names = names[lo:hi]
    pmls, cids = query_fn(reads[lo:hi])

    pml_part = f"{pattern_file}.split.pml.bin.part{pid}"
    cid_part = f"{pattern_file}.split.cid.bin.part{pid}"
    write_pml_cid_binary(pml_part, cid_part, local_names, pmls, cids)

    # synchronize hosts, then rank 0 merges in read order
    if nproc > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("colbwt_query_parts")
    if pid == 0:
        parts_pml = [f"{pattern_file}.split.pml.bin.part{p}" for p in range(nproc)]
        parts_cid = [f"{pattern_file}.split.cid.bin.part{p}" for p in range(nproc)]
        merge_part_files(f"{pattern_file}.split.pml.bin", parts_pml)
        merge_part_files(f"{pattern_file}.split.cid.bin", parts_cid)
        for p in parts_pml + parts_cid:
            Path(p).unlink(missing_ok=True)
    return local_names, pmls, cids
