"""Memmap-fed, RSS-bounded driver for the chunked multi-MUM scan.

At n ~ 9e9 the scan's three n-sized inputs alone exceed host RAM when held
in memory, so:

1. **Memmap-fed inputs**: the scan's three n-sized inputs (lcp32, per-rank
   doc id, run-change bits) live as on-disk ``.npy`` files and are sliced
   per chunk (``np.load(mmap_mode="r")``), so a scanning process is
   O(chunk) resident instead of ~64 GB.  The run-change marks are stored
   bit-packed (n/8 bytes) and unpacked per chunk slice.
2. **Worker subprocesses**: the scan runs in child processes, each
   processing chunks until its RSS crosses a cap, checkpointing its
   partial results (atomic rename), and exiting, so whatever host memory
   the device runtime keeps for its transfers is returned with the worker,
   and a killed build resumes from the last checkpoint.  The XLA program
   comes from the persistent compilation cache, so a respawn does not
   compile again.  Each worker opens the device itself: the parent must
   hold none when it spawns one (utils.hbm.require_no_device_held), since
   a JAX process reserves most of a GPU's memory when it first uses it.

Reference role being replaced: the multi-MUM pass of the mumemto fork's
PFP pipeline (the reference's thirdparty/CMakeLists.txt:90-108), which
the reference runs fully host-side for the same reason (host RAM is the
only bound at this scale).
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import numpy as np

from colbwt_tpu.ops.construct_chunked import TERMINATOR


def _mem_total_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for ln in f:
                if ln.startswith("MemTotal"):
                    return int(ln.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30


def write_run_change_bits(heads: np.ndarray, lens: np.ndarray,
                          path: str | Path, block: int = 1 << 26) -> None:
    """Bit-packed (little-endian) equivalent of
    construct_chunked.run_change_from_runs, written blockwise: run starts
    are 1, and every position of a terminator run is 1 (terminators are
    pairwise-distinct ranks).  n/8 bytes on disk instead of n bytes in
    RAM."""
    heads = np.asarray(heads)
    lens = np.asarray(lens, dtype=np.int64)
    n = int(lens.sum())
    starts = np.zeros(heads.size, dtype=np.int64)
    if heads.size > 1:
        np.cumsum(lens[:-1], out=starts[1:])
    term = np.flatnonzero(heads == TERMINATOR)
    term_lo = starts[term]
    term_hi = term_lo + lens[term]
    assert block % 8 == 0
    path = Path(path)
    tmp = path.with_suffix(".tmp.npy")
    with open(tmp, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "|u1", "fortran_order": False,
                "shape": ((n + 7) // 8,)})
        for bs in range(0, n, block):
            be = min(bs + block, n)
            buf = np.zeros(be - bs, dtype=np.uint8)
            i0 = int(np.searchsorted(starts, bs))
            i1 = int(np.searchsorted(starts, be))
            buf[starts[i0:i1] - bs] = 1
            j0 = int(np.searchsorted(term_hi, bs, side="right"))
            j1 = int(np.searchsorted(term_lo, be))
            for lo, hi in zip(term_lo[j0:j1], term_hi[j0:j1]):
                buf[max(int(lo) - bs, 0):int(hi) - bs] = 1
            f.write(np.packbits(buf, bitorder="little").tobytes())
    tmp.rename(path)


def extract_npz_member(npz_path: str | Path, member: str,
                       out_path: str | Path, block: int = 1 << 24) -> None:
    """Stream one member of an (uncompressed) .npz out to a standalone
    .npy file in O(block) memory — np.load would materialize the whole
    array (18+ GB for the doc array at n ~ 9e9) just to re-save it."""
    import shutil
    import zipfile

    out_path = Path(out_path)
    tmp = out_path.with_suffix(".tmp.npy")
    with zipfile.ZipFile(npz_path) as zf:
        with zf.open(member) as src, open(tmp, "wb") as dst:
            shutil.copyfileobj(src, dst, block)
    tmp.rename(out_path)
    np.load(out_path, mmap_mode="r")  # validate the .npy header


def _progress_next(progress_path: Path) -> int:
    if not progress_path.exists():
        return 0
    with np.load(progress_path) as z:
        return int(z["next_chunk"])


def find_multi_mums_streamed(lcp_path: str | Path, doc_path: str | Path,
                             rc_path: str | Path, num_docs: int,
                             min_mum: int, progress_path=None,
                             chunk: int = 1 << 26, rss_cap: int | None = None,
                             log=None) -> tuple[np.ndarray, np.ndarray]:
    """find_multi_mums_chunked over on-disk inputs, executed by a sequence
    of RSS-bounded worker subprocesses.  Returns (ml, mp) like the
    in-process scan; resumable — partial results persist in
    ``progress_path`` across crashes and reruns."""
    import subprocess
    import sys

    from colbwt_tpu.utils.hbm import require_no_device_held

    require_no_device_held("multi-MUM scan worker")
    lcp_path, doc_path, rc_path = Path(lcp_path), Path(doc_path), Path(rc_path)
    progress_path = Path(progress_path or lcp_path.parent /
                         "mumscan_progress.npz")
    n = int(np.load(lcp_path, mmap_mode="r").shape[0])
    # mirror find_multi_mums_chunked's power-of-two chunk bucketing
    C = min(chunk, 1 << max(13, (max(n, 2) - 1).bit_length()))
    n_chunks = -(-n // C)
    if rss_cap is None:
        rss_cap = int(_mem_total_bytes() * 0.55)
    while True:
        nk = _progress_next(progress_path)
        if nk >= n_chunks:
            break
        if log:
            log(f"mum-scan worker from chunk {nk}/{n_chunks} "
                f"(rss cap {rss_cap / 1e9:.0f} GB)")
        env = dict(os.environ)
        # the worker runs `-m colbwt_tpu...`: make the package importable
        # whatever the caller's cwd is
        pkg_root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "colbwt_tpu.ops.mum_scan_stream",
             str(lcp_path), str(doc_path), str(rc_path), str(progress_path),
             str(num_docs), str(min_mum), str(chunk), str(rss_cap)],
            check=True, env=env)
        nk2 = _progress_next(progress_path)
        if log:
            log(f"mum-scan worker advanced {nk} -> {nk2}/{n_chunks} "
                f"({time.perf_counter() - t0:.0f}s)")
        if nk2 <= nk:
            raise RuntimeError(
                "mum-scan worker exited without completing a chunk "
                "(rss cap too small for even one chunk?)")
    with np.load(progress_path) as z:
        ml, mp = z["ml"].copy(), z["mp"].copy()
    progress_path.unlink()
    return ml, mp


def _worker_main(argv: list[str]) -> None:
    (lcp_path, doc_path, rc_path, progress_path,
     num_docs, min_mum, chunk, rss_cap) = argv
    from colbwt_tpu.utils.log import enable_compilation_cache

    enable_compilation_cache()
    from colbwt_tpu.ops.construct_jax import find_multi_mums_chunked

    lcp = np.load(lcp_path, mmap_mode="r")
    docs = np.load(doc_path, mmap_mode="r")
    rc = np.load(rc_path, mmap_mode="r")
    prog = Path(progress_path)
    if prog.exists():
        with np.load(prog) as z:
            k0 = int(z["next_chunk"])
            ml0, mp0 = z["ml"].copy(), z["mp"].copy()
    else:
        k0 = 0
        ml0 = mp0 = np.empty(0, dtype=np.int64)
    info: dict = {}
    ml, mp = find_multi_mums_chunked(
        lcp, docs, rc, int(num_docs), int(min_mum), chunk=int(chunk),
        run_change_packed=True, start_chunk=k0, rss_cap=int(rss_cap),
        info=info)
    tmp = prog.with_suffix(".tmp.npz")
    np.savez(tmp, next_chunk=info["next_chunk"],
             ml=np.concatenate([ml0, ml]), mp=np.concatenate([mp0, mp]))
    tmp.rename(prog)


if __name__ == "__main__":
    import sys

    _worker_main(sys.argv[1:])
