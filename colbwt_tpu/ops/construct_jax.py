"""Device-side index construction: suffix array, LCP, multi-MUMs, thresholds.

The reference offloads all of this to the mumemto fork's prefix-free parsing
pipeline (SURVEY §2.2: PFP → SA/LCP → multi-MUMs + thresholds, [inferred]).
Here it is rebuilt for the device on sort/scan primitives:

- suffix array: prefix doubling — log2(n) rounds of one fused int64 key sort
  (`jax.numpy.argsort` → XLA sort) plus a cumsum re-ranking.  O(n log n) work,
  no data-dependent control flow.
- LCP: binary lifting over the retained per-round rank arrays (LCE(a,b) in
  O(log n) vectorized compares), instead of the inherently sequential Kasai
  walk of the host oracle.  Memory: n * log2(n) int32 for the rank pyramid.
- multi-MUMs: the SURVEY §2.2 window conditions evaluated for every rank
  position at once — sliding-window minima by the two-cummin van Herk trick
  (O(n) scratch at any N), document coverage via next-same-doc sliding
  minima, left-maximality by run-ids of the preceding-char array.
- thresholds: per-character segmented argmin of LCP between consecutive
  same-char runs (two segment_min passes; first-position tie-break matching
  np.argmin).

Every function is differential-tested against colbwt_tpu.ops.oracle.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# suffix array (prefix doubling)
# ---------------------------------------------------------------------------


def _rerank(order: jnp.ndarray, key_hi: jnp.ndarray, key_lo: jnp.ndarray
            ) -> jnp.ndarray:
    """Assign dense ranks to sorted (hi, lo) key pairs."""
    hi_s = key_hi[order]
    lo_s = key_lo[order]
    changed = jnp.ones(order.shape, dtype=jnp.int32)
    changed = changed.at[1:].set(
        ((hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])).astype(jnp.int32))
    ranks_sorted = jnp.cumsum(changed) - 1
    return jnp.zeros_like(ranks_sorted).at[order].set(ranks_sorted)


@jax.jit
def _doubling_round(rank: jnp.ndarray, k: jnp.ndarray):
    """One prefix-doubling round: sort by (rank, rank_{+k}), re-rank.

    k is traced (jnp.roll + mask) so every round shares one compiled program.
    The lexicographic pair sort is two stable single-key argsorts — int32-safe
    at any n (a fused int key would overflow past n ~ 46k without x64) and
    avoids a variadic 2-key lax.sort with a custom comparator."""
    n = rank.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    next_rank = jnp.where(iota < n - k, jnp.roll(rank, -k), -1)
    o1 = jnp.argsort(next_rank, stable=True).astype(jnp.int32)
    order = jnp.take(o1, jnp.argsort(jnp.take(rank, o1), stable=True)
                     ).astype(jnp.int32)
    new_rank = _rerank(order, rank, next_rank)
    return order, new_rank, new_rank[order[-1]]


def suffix_array_jax(ranks0: np.ndarray, with_pyramid: bool = False):
    """Prefix-doubling suffix array with per-round early exit.

    Rounds run as separate jit calls so the host can stop as soon as all
    ranks are distinct (max rank == n-1).  On pangenome collections the
    distinct-separator convention plus mutation density separates ranks after
    ~log2(mean mutation distance) rounds — typically 8-12 instead of
    ceil(log2 n) — a 2-3x build-time win.  Returns (sa, rank[, pyramid]);
    pyramid[j] ranks substrings of length 2**(j+1) for the LCP lifting (all
    LCP values are < 2**R at exit, so the truncated pyramid still covers
    every LCE decomposition).
    """
    n = int(ranks0.size)
    num_rounds = max(1, math.ceil(math.log2(max(n, 2))))
    rank = jnp.asarray(ranks0, dtype=jnp.int32)
    sa = jnp.argsort(rank, stable=True).astype(jnp.int32)
    pyramid = []
    k = 1
    for _ in range(num_rounds):
        sa, rank, max_rank = _doubling_round(rank, jnp.int32(k))
        if with_pyramid:
            pyramid.append(rank)
        k *= 2
        if int(max_rank) == n - 1:
            break
    if with_pyramid:
        return (np.asarray(sa), np.asarray(rank),
                [np.asarray(p) for p in pyramid])
    return np.asarray(sa), np.asarray(rank)


# ---------------------------------------------------------------------------
# LCP by binary lifting
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_rounds",))
def lcp_from_pyramid(ranks0: jnp.ndarray, sa: jnp.ndarray,
                     pyramid: list[jnp.ndarray], num_rounds: int) -> jnp.ndarray:
    """lcp[i] = LCE(sa[i-1], sa[i]) via descending power-of-two probes.

    pyramid[j][p] ranks the substring text[p : p + 2**(j+1)] (end-padded).
    Two suffixes share a prefix of length >= h + 2**j iff their pyramid[j-?]
    ranks at offset h agree; out-of-range probes compare unequal via the
    sentinel -1.
    """
    n = ranks0.shape[0]
    a = sa[:-1]
    b = sa[1:]
    h = jnp.zeros(a.shape, dtype=jnp.int32)

    def probe(level_ranks: jnp.ndarray, a, b, h, width: int):
        pa = a + h
        pb = b + h
        ra = jnp.where(pa < n, jnp.take(level_ranks, jnp.minimum(pa, n - 1)), -1)
        rb = jnp.where(pb < n, jnp.take(level_ranks, jnp.minimum(pb, n - 1)), -2)
        eq = ra == rb
        return h + jnp.where(eq, width, 0)

    # widths 2**num_rounds ... 2, then 1 via the base ranks
    for j in range(num_rounds - 1, -1, -1):
        h = probe(pyramid[j], a, b, h, 1 << (j + 1))
    h = probe(ranks0.astype(jnp.int32), a, b, h, 1)
    lcp = jnp.zeros((n,), dtype=jnp.int32).at[1:].set(h)
    return lcp


def lcp_jax(ranks0: np.ndarray, sa: np.ndarray, pyramid: list[np.ndarray]
            ) -> np.ndarray:
    return np.asarray(lcp_from_pyramid(
        jnp.asarray(ranks0, dtype=jnp.int32), jnp.asarray(sa, dtype=jnp.int32),
        [jnp.asarray(p) for p in pyramid], len(pyramid)))


# ---------------------------------------------------------------------------
# multi-MUM scan
# ---------------------------------------------------------------------------


def _shift_left(x: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    """y[i] = x[i+k] with y[i >= n-k] = fill (static k)."""
    if k == 0:
        return x
    if k >= x.shape[0]:
        return jnp.full_like(x, fill)
    return jnp.concatenate([x[k:], jnp.full((k,), fill, x.dtype)])


def _sliding_min(x: jnp.ndarray, w: int) -> jnp.ndarray:
    """out[i] = min(x[i : i+w]) treating x[>=n] as +inf (w >= 1).

    Two regimes, both O(n) memory:

    - w < 128: binary doubling — f_s[i] = min(x[i:i+s]) for s = 1,2,4,...;
      out = min(f_s[i], f_s[i+w-s]) once s <= w < 2s.  log2(w) shifted-min
      passes over flat arrays.  (The van Herk reshape below has a minor
      axis of w; a backend that pads it to a 128-wide tile would blow
      memory up 128/w-fold.)
    - w >= 128: van Herk/Gil-Werman — pad to w-blocks, cummin within blocks
      forward (P) and backward (S); a window spans at most two blocks, so
      out[i] = min(S[i], P[i+w-1]).  O(n) work independent of w (the
      doubling's n*log2(w) passes would dominate at the 10k-document
      configs), and at w >= 128 the (n/w, w) reshape's lane padding is < 2x.
    """
    if w == 1:
        return x
    n = x.shape[0]
    big = jnp.iinfo(x.dtype).max
    if w < 128:
        f = x
        s = 1
        while 2 * s <= w:
            f = jnp.minimum(f, _shift_left(f, s, big))
            s *= 2
        return jnp.minimum(f, _shift_left(f, w - s, big))
    pad = (-n) % w + w                       # round up + one spare block
    xp = jnp.concatenate([x, jnp.full((pad,), big, x.dtype)])
    blocks = xp.reshape(-1, w)
    p = jax.lax.cummin(blocks, axis=1).reshape(-1)
    s = jax.lax.cummin(blocks, axis=1, reverse=True).reshape(-1)
    return jnp.minimum(s[:n], p[w - 1:n + w - 1])


@functools.partial(jax.jit, static_argnames=("num_docs", "min_mum"))
def multi_mum_scan(lcp: jnp.ndarray, sa_docs: jnp.ndarray,
                   prev_rank: jnp.ndarray, num_docs: int, min_mum: int
                   ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Evaluate the multi-MUM window conditions at every rank position.

    Returns (is_mum mask over window starts, ell window lengths); see
    oracle.find_multi_mums for the condition definitions.  Works for any
    number of documents: a height-N window covers all N docs iff no document
    repeats inside it, i.e. min over the window of next-same-doc-occurrence
    indices lands at or past the window end (sliding-window minimum of the
    `nxt` array — O(n) work and scratch at any N, so the 10k-genome configs
    fit in HBM).
    """
    n = lcp.shape[0]
    N = num_docs
    lcp_ext = jnp.concatenate([lcp, jnp.zeros((N,), lcp.dtype)])  # lcp[>=n] = 0

    # ell[i] = min lcp[i+1 .. i+N-1]  (window of width N-1 starting at i+1)
    inner = _sliding_min(lcp_ext[1:], N - 1)[:n]          # index i -> window at i+1
    ell = inner

    uniq = (lcp_ext[:n] < ell) & (lcp_ext[N:N + n] < ell)

    # doc coverage: window [i, i+N) is a permutation of the N docs iff no doc
    # repeats inside it.  nxt[i] = next j > i with sa_docs[j] == sa_docs[i].
    pos = jnp.arange(n, dtype=jnp.int32)
    order = jnp.argsort(sa_docs * 1, stable=True)  # group by doc, pos ascending
    pos_sorted = jnp.take(pos, order)
    doc_sorted = jnp.take(sa_docs, order)
    nxt_sorted = jnp.concatenate([pos_sorted[1:], jnp.full((1,), n, jnp.int32)])
    same_doc = jnp.concatenate(
        [doc_sorted[1:] == doc_sorted[:-1], jnp.zeros((1,), bool)])
    nxt_sorted = jnp.where(same_doc, nxt_sorted, n)
    nxt = jnp.zeros((n,), dtype=jnp.int32).at[order].set(nxt_sorted)
    win_min_nxt = _sliding_min(nxt, N)
    covers = win_min_nxt >= pos + N

    # left-maximality: preceding chars not all equal across the window
    run_change = jnp.ones((n,), dtype=jnp.int32)
    run_change = run_change.at[1:].set(
        (prev_rank[1:] != prev_rank[:-1]).astype(jnp.int32))
    run_id = jnp.cumsum(run_change)
    last = jnp.concatenate(
        [run_id[N - 1:], jnp.full((N - 1,), -1, dtype=run_id.dtype)])
    left_max = run_id != last

    in_range = jnp.arange(n, dtype=jnp.int32) <= (n - N)
    is_mum = (ell >= min_mum) & uniq & covers & left_max & in_range
    return is_mum, ell


@functools.partial(jax.jit, static_argnames=("num_docs",))
def _mum_scan_chunk(lcp_s: jnp.ndarray, docs_s: jnp.ndarray,
                    chg_s: jnp.ndarray, limit: jnp.ndarray,
                    min_mum: jnp.ndarray, num_docs: int
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One chunk of the multi-MUM scan (window conditions identical to
    multi_mum_scan; differential-tested against it).

    Inputs are slices with a 2N+2 halo past the chunk: for chunk [s, s+C),
    lcp_s = lcp[s : s+C+2N+2] (0-padded past n), docs_s = doc_of_sa likewise
    (uint16 with fill 65535 when N < 65535, else int32 with fill -1 —
    either fill only self-matches in the pad region, which in-range windows
    never see), chg_s = prev-char run-change bits (uint8, 1-padded), and
    limit = n - N - s (window starts s+i with i > limit are out of range).
    All chunk-local arithmetic is int32 regardless of n (the wide regime
    n >= 2**31 only needs int64 on the host side), and peak HBM is O(C), so
    collections far beyond HBM stream through a fixed-shape program.

    Transfer-slimmed both ways: uploads are 4+2+1 B/rank, min_mum is
    traced (no per-config recompile),
    and the hit mask returns as PACKED BITS (C/8 bytes) with ell left on
    device — the caller gathers only the hit positions' lengths.
    """
    N = num_docs
    C = lcp_s.shape[0] - (2 * N + 2)

    # ell[i] = min lcp[i+1 .. i+N-1]
    ell = _sliding_min(lcp_s[1:1 + C + N], N - 1)[:C]
    uniq = (lcp_s[:C] < ell) & (lcp_s[N:N + C] < ell)

    # doc coverage via capped next-same-doc distances: d[j] = min t in
    # [1, N+1] with docs[j+t] == docs[j], else N+1 (a true distance > N+1
    # cannot break the window condition, so the cap is exact).  The window
    # test min_{j in [i, i+N)} (j + d[j]) >= i + N runs in chunk-local
    # coordinates.
    probe_len = C + N

    def d_body(t, d):
        nxt = jax.lax.dynamic_slice(docs_s, (t,), (probe_len,))
        match = nxt == docs_s[:probe_len]
        return jnp.where(match & (d == N + 1), t, d)

    d0 = jnp.full((probe_len,), N + 1, dtype=jnp.int32)
    # ascending t with "first write wins" = minimal t
    d = jax.lax.fori_loop(1, N + 2, d_body, d0)
    y = jnp.arange(probe_len, dtype=jnp.int32) + d
    win = _sliding_min(y, N)[:C]
    covers = win >= jnp.arange(C, dtype=jnp.int32) + N

    # left-maximality: any prev-char run change in (i, i+N-1]
    neg_chg = -chg_s[1:1 + C + N].astype(jnp.int32)
    left_max = _sliding_min(neg_chg, N - 1)[:C] < 0

    i_local = jnp.arange(C, dtype=jnp.int32)
    is_mum = ((ell >= min_mum) & uniq & covers & left_max
              & (i_local <= limit))
    return jnp.packbits(is_mum, bitorder="little"), ell


@jax.jit
def _gather_i32(arr: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    return jnp.take(arr, idx, mode="clip")


def _gather_hits(ell_dev, pos_local: np.ndarray) -> np.ndarray:
    """Download ell values at hit positions only: indices padded to the next
    power of two (few program shapes), gathered on device, sliced on host."""
    if pos_local.size == 0:
        return np.empty(0, dtype=np.int64)
    m = 1 << (int(pos_local.size) - 1).bit_length()
    idx = np.zeros(m, dtype=np.int32)
    idx[:pos_local.size] = pos_local
    vals = np.asarray(_gather_i32(ell_dev, jnp.asarray(idx)))
    return vals[:pos_local.size].astype(np.int64)


def _rss_bytes() -> int:
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("VmRSS"):
                    return int(ln.split()[1]) * 1024
    except OSError:
        pass
    return 0


def find_multi_mums_chunked(lcp: np.ndarray, sa_docs: np.ndarray,
                            run_change: np.ndarray, num_docs: int,
                            min_mum: int, chunk: int = 1 << 26,
                            log=None, run_change_packed: bool = False,
                            start_chunk: int = 0,
                            max_chunks: int | None = None,
                            rss_cap: int | None = None,
                            info: dict | None = None
                            ) -> tuple[np.ndarray, np.ndarray]:
    """Stream the multi-MUM scan through the device in fixed-shape chunks.

    Same outputs as find_multi_mums_jax, but peak HBM is O(chunk) instead of
    O(n), so n is bounded by host RAM only (the n >= 2**31 HPRC-class
    regime; the reference's mumemto stage runs PFP on the host for the same
    reason, SURVEY §2.2).

    The chunk size is bucketed to a power of two so the compiled program's
    shape is shared across collections (one (C, N) program per document
    count, persisted by the compilation cache across processes), and the
    compile is done AOT with its time logged separately from execution.

    Inputs may be memmaps (only one chunk slice is materialized at a time).
    With ``run_change_packed``, ``run_change`` holds little-endian
    bit-packed marks (n/8 bytes; see mum_scan_stream.write_run_change_bits)
    unpacked per chunk slice.  ``start_chunk``/``max_chunks``/``rss_cap``
    scan a sub-range — results cover only that range (positions stay
    global) and ``info["next_chunk"]`` reports the first unprocessed chunk,
    so a driver can resume where a leak-bounded worker stopped
    (mum_scan_stream.find_multi_mums_streamed)."""
    import time as _time

    n = int(lcp.shape[0])
    N = num_docs
    halo = 2 * N + 2
    C = min(chunk, 1 << max(13, (max(n, 2) - 1).bit_length()))
    use_u16 = N < 65535
    docs_dtype = np.uint16 if use_u16 else np.int32
    docs_fill = 65535 if use_u16 else -1

    def slice_padded(arr, s, fill, dtype):
        from colbwt_tpu.utils.xfer import device_put_chunked

        sl = np.asarray(arr[s:s + C + halo])
        if sl.size < C + halo:
            sl = np.concatenate(
                [sl, np.full(C + halo - sl.size, fill, arr.dtype)])
        # ~0.8 GB per scan chunk, uploaded in 16 MB slices (utils/xfer.py)
        return device_put_chunked(sl.astype(dtype, copy=False))

    def rc_slice(s):
        from colbwt_tpu.utils.xfer import device_put_chunked

        if not run_change_packed:
            return slice_padded(run_change, s, 1, np.uint8)
        # s is a multiple of C (power of two >= 8192), so bit offset s is
        # byte-aligned; positions past n (packbits zero-padding included)
        # are forced to the fill value 1
        nb = (C + halo + 7) >> 3
        raw = np.asarray(run_change[s >> 3:(s >> 3) + nb])
        if raw.size < nb:
            raw = np.concatenate(
                [raw, np.full(nb - raw.size, 0xFF, np.uint8)])
        bits = np.unpackbits(raw, bitorder="little")[:C + halo]
        if s + C + halo > n:
            bits[max(0, n - s):] = 1
        return device_put_chunked(bits)

    # AOT compile once; log compile vs execute split
    t0 = _time.perf_counter()
    shape32 = jax.ShapeDtypeStruct((C + halo,), jnp.int32)
    compiled = _mum_scan_chunk.lower(
        shape32, jax.ShapeDtypeStruct((C + halo,), docs_dtype),
        jax.ShapeDtypeStruct((C + halo,), jnp.uint8),
        jax.ShapeDtypeStruct((), jnp.int32), jax.ShapeDtypeStruct((), jnp.int32),
        num_docs=N).compile()
    compile_s = _time.perf_counter() - t0
    if log:
        log(f"mum-scan chunk program (C = {C:,}, N = {N}): "
            f"compile {compile_s:.1f}s")

    out_lens: list[np.ndarray] = []
    out_pos: list[np.ndarray] = []
    t_exec = _time.perf_counter()
    pending = None  # (s, packed_dev, ell_dev): 1-deep pipeline
    mm = jnp.int32(min_mum)

    def drain(p):
        s, packed_dev, ell_dev = p
        bits = np.unpackbits(np.asarray(packed_dev), bitorder="little")[:C]
        pos_local = np.flatnonzero(bits)
        out_pos.append(pos_local.astype(np.int64) + s)
        out_lens.append(_gather_hits(ell_dev, pos_local))

    n_chunks = -(-n // C)
    k_end = (n_chunks if max_chunks is None
             else min(n_chunks, start_chunk + max_chunks))
    next_chunk = start_chunk
    for k in range(start_chunk, k_end):
        s = k * C
        packed_dev, ell_dev = compiled(
            slice_padded(lcp, s, 0, np.int32),
            slice_padded(sa_docs, s, docs_fill, docs_dtype),
            rc_slice(s),
            jnp.int32(min(n - N - s, C)),  # clip: n - s overflows int32 at wide n
            mm)
        if pending is not None:
            drain(pending)
        pending = (s, packed_dev, ell_dev)
        next_chunk = k + 1
        if rss_cap is not None and next_chunk < k_end \
                and _rss_bytes() > rss_cap:
            break
    if pending is not None:
        drain(pending)
    if info is not None:
        info["next_chunk"] = next_chunk
    if log:
        log(f"mum-scan execute+transfer (chunks [{start_chunk},"
            f"{next_chunk}) of {n_chunks}): "
            f"{_time.perf_counter() - t_exec:.1f}s")
    if not out_pos:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy()
    return np.concatenate(out_lens), np.concatenate(out_pos)


# above this n, stream fixed-shape chunks instead of the one-shot scan:
# shared program shapes across collections (compile-cache hits) and O(C)
# device memory (the one-shot scan holds ~10 n-sized arrays)
_CHUNKED_SCAN_MIN_N = 1 << 22


def find_multi_mums_jax(ranks: np.ndarray, sa: np.ndarray, lcp: np.ndarray,
                        doc_ids: np.ndarray, num_docs: int, min_mum: int = 1,
                        log=None) -> tuple[np.ndarray, np.ndarray]:
    """Host wrapper matching oracle.find_multi_mums' signature and outputs."""
    if num_docs < 2:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    sa = np.asarray(sa)
    prev_rank = np.asarray(ranks)[sa - 1]
    sa_docs = np.asarray(doc_ids)[sa]
    if sa.shape[0] >= _CHUNKED_SCAN_MIN_N:
        run_change = np.ones(sa.shape[0], dtype=np.uint8)
        np.not_equal(prev_rank[1:], prev_rank[:-1], out=run_change[1:].view(bool))
        return find_multi_mums_chunked(lcp, sa_docs.astype(np.int32),
                                       run_change, num_docs, min_mum,
                                       log=log)
    is_mum, ell = multi_mum_scan(
        jnp.asarray(lcp, dtype=jnp.int32), jnp.asarray(sa_docs.astype(np.int32)),
        jnp.asarray(prev_rank.astype(np.int32)), num_docs, min_mum)
    mask = np.asarray(is_mum)
    pos = np.flatnonzero(mask).astype(np.int64)
    return np.asarray(ell)[pos].astype(np.int64), pos


# ---------------------------------------------------------------------------
# thresholds
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_segs",))
def _segmented_argmin(lcp: jnp.ndarray, seg_id: jnp.ndarray, num_segs: int
                      ) -> jnp.ndarray:
    """First position of the minimum lcp value within each segment."""
    big = jnp.iinfo(jnp.int32).max
    mins = jax.ops.segment_min(lcp, seg_id, num_segments=num_segs)
    pos = jnp.arange(lcp.shape[0], dtype=jnp.int32)
    cand = jnp.where(lcp == mins[seg_id], pos, big)
    return jax.ops.segment_min(cand, seg_id, num_segments=num_segs)


def compute_thresholds_jax(heads: np.ndarray, lens: np.ndarray, lcp: np.ndarray
                           ) -> np.ndarray:
    """Vectorized per-run thresholds (same contract as
    oracle.compute_thresholds: argmin of LCP over (prev c-run end, start],
    0 for the first c-run of each character)."""
    from colbwt_tpu.ops.oracle import normalize_heads

    heads = normalize_heads(heads)
    lens = np.asarray(lens, dtype=np.int64)
    r = heads.size
    starts = np.zeros(r, dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    ends = starts + lens - 1
    thresholds = np.zeros(r, dtype=np.int64)
    lcp_j = jnp.asarray(lcp, dtype=jnp.int32)
    n = int(lens.sum())

    for c in np.unique(heads):
        runs_c = np.flatnonzero(heads == c)
        if runs_c.size < 2:
            continue
        # segment s covers ranks (ends[runs_c[s]] + 1) .. starts[runs_c[s+1]]
        lo = ends[runs_c[:-1]] + 1
        hi = starts[runs_c[1:]]          # inclusive
        # map every rank position to its segment (or to a waste segment)
        seg_bounds = np.empty(2 * lo.size, dtype=np.int64)
        seg_bounds[0::2] = lo
        seg_bounds[1::2] = hi + 1
        pos_seg = np.searchsorted(seg_bounds, np.arange(n), side="right")
        in_seg = pos_seg % 2 == 1
        seg_id = np.where(in_seg, pos_seg // 2, lo.size)  # waste bucket = lo.size
        arg = np.asarray(_segmented_argmin(
            lcp_j, jnp.asarray(seg_id, dtype=jnp.int32), lo.size + 1))[:lo.size]
        thresholds[runs_c[1:]] = arg
    return thresholds
