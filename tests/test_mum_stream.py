"""RSS-bounded streamed multi-MUM scan (ops.mum_scan_stream).

At n ~ 9e9 the scan runs memmap-fed in worker subprocesses (module
docstring).  These tests pin:
the bit-packed run-change writer against the n-byte reference, the packed/
memmap/sub-range scan paths against the plain in-process scan, and the
multi-worker subprocess driver end-to-end.
"""

import numpy as np

from colbwt_tpu.ops import construct_chunked as CC
from colbwt_tpu.ops import construct_jax as CJ
from colbwt_tpu.ops import mum_scan_stream as MS
from colbwt_tpu.ops import oracle as O


def _scan_inputs(rng, ndocs, doclen, muts=20):
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), doclen)
    docs = []
    for _ in range(ndocs):
        a = base.copy()
        pos = rng.integers(0, doclen, muts)
        a[pos] = rng.choice(np.frombuffer(b"ACGT", np.uint8), muts)
        docs.append(a.tobytes())
    text, ranks, doc_ids = O.concat_collection(docs)
    sa = O.suffix_array(ranks)
    lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    sa_docs = doc_ids[sa].astype(np.uint16)
    rc = CC.run_change_from_runs(heads, lens)
    return heads, lens, lcp.astype(np.int32), sa_docs, rc, ndocs


def test_run_change_bits_match_reference(rng, tmp_path):
    for trial in range(4):
        ndocs = int(rng.integers(2, 7))
        heads, lens, *_ = _scan_inputs(rng, ndocs, int(rng.integers(50, 400)))
        rc = CC.run_change_from_runs(heads, lens)
        p = tmp_path / f"rc{trial}.npy"
        MS.write_run_change_bits(heads, lens, p, block=64)
        packed = np.load(p, mmap_mode="r")
        assert packed.shape == ((rc.size + 7) // 8,)
        bits = np.unpackbits(np.asarray(packed), bitorder="little")[:rc.size]
        np.testing.assert_array_equal(bits, rc)


def test_packed_memmap_scan_matches_plain(rng, tmp_path):
    heads, lens, lcp, sa_docs, rc, N = _scan_inputs(rng, 5, 3500)
    n = lcp.size
    assert n > 2 * 8192  # multiple chunks at chunk=1<<13
    ml_ref, mp_ref = CJ.find_multi_mums_chunked(
        lcp, sa_docs, rc, N, 12, chunk=1 << 13)
    np.save(tmp_path / "lcp.npy", lcp)
    np.save(tmp_path / "doc.npy", sa_docs)
    MS.write_run_change_bits(heads, lens, tmp_path / "rc.npy")
    lcp_m = np.load(tmp_path / "lcp.npy", mmap_mode="r")
    doc_m = np.load(tmp_path / "doc.npy", mmap_mode="r")
    rc_m = np.load(tmp_path / "rc.npy", mmap_mode="r")
    ml, mp = CJ.find_multi_mums_chunked(
        lcp_m, doc_m, rc_m, N, 12, chunk=1 << 13, run_change_packed=True)
    np.testing.assert_array_equal(ml, ml_ref)
    np.testing.assert_array_equal(mp, mp_ref)

    # one-chunk-at-a-time sub-ranges compose to the same result
    parts = []
    k = 0
    n_chunks = -(-n // (1 << 13))
    while k < n_chunks:
        info = {}
        part = CJ.find_multi_mums_chunked(
            lcp_m, doc_m, rc_m, N, 12, chunk=1 << 13,
            run_change_packed=True, start_chunk=k, max_chunks=1, info=info)
        assert info["next_chunk"] == k + 1
        parts.append(part)
        k = info["next_chunk"]
    np.testing.assert_array_equal(np.concatenate([p[0] for p in parts]),
                                  ml_ref)
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]),
                                  mp_ref)


def test_streamed_driver_multi_worker(rng, tmp_path):
    """End-to-end: subprocess workers with a 1-byte rss cap (every worker
    scans exactly one chunk, then the driver respawns) reproduce the
    in-process scan and clean up their progress file."""
    heads, lens, lcp, sa_docs, rc, N = _scan_inputs(rng, 4, 3500)
    ml_ref, mp_ref = CJ.find_multi_mums_chunked(
        lcp, sa_docs, rc, N, 15, chunk=1 << 13)
    np.save(tmp_path / "lcp.npy", lcp)
    np.save(tmp_path / "doc.npy", sa_docs)
    MS.write_run_change_bits(heads, lens, tmp_path / "rc.npy")
    logs = []
    ml, mp = MS.find_multi_mums_streamed(
        tmp_path / "lcp.npy", tmp_path / "doc.npy", tmp_path / "rc.npy",
        N, 15, chunk=1 << 13, rss_cap=1, log=logs.append)
    np.testing.assert_array_equal(ml, ml_ref)
    np.testing.assert_array_equal(mp, mp_ref)
    assert not (tmp_path / "mumscan_progress.npz").exists()
    n_chunks = -(-lcp.size // (1 << 13))
    assert sum("worker advanced" in m for m in logs) == n_chunks
