"""Positional-automaton query engine — k pattern characters per gather.

The insight: the whole query step (col_pml::_query_pml + threshold_step,
include/col_bwt.hpp:498-574) is a pure function of (pattern char c, rank
position pos).  The reference state (interval, offset, pos) is redundant —
interval/offset are derivable from pos — and in *position space* LF needs no
fast-forward at all: LF(pos) = F_start(run(pos)) + (pos - idx[run(pos)]).

So tabulate the step function S_c : pos -> pos' once per char, and — because
position-keyed step functions COMPOSE (unlike the run-keyed mega rows, whose
next gather index depends on the evolving offset) — tabulate S_{c_k} ∘ … ∘
S_{c_1} for every k-tuple of chars: one (A^k · n, 2)-int32 table row then
advances a read k characters with ONE gather, so the dependent gathers per
read drop k-fold.  The premise that a gather's cost does not grow with the
table (so a larger k is always better while it fits the budget) is not
measured on the GPU, whose 50 MB L2 may make a small table cheaper to
gather from than a multi-GB one.

Key alphabets.  By default keys range over all A = sigma+1 dense chars.
Passing `alphabet` (e.g. b"ACGT") restricts keys to those |Q| bytes — |Q|^k
keys instead of A^k buys one more composition level at the same memory
(4^4 = 256 < 6^3 = 216): reads made purely of Q bytes take k=4 steps per
gather; the rare read containing any other byte falls back to the general
k=1 table (kept alongside, A·n·8 bytes).

Row layout ((A_key^k · n, 2) int32, key = ((c_1·A + c_2)·A + …)·A + c_k in
processing order — c_1 is the read's rightmost unprocessed char):

  word0  bits 0..27 : final position after all k steps (requires n < 2**28)
         bit  28+j  : match flag of sub-step j (drives the PML
                      extend-or-reset recurrence); j < k <= 4
  word1  bits 8j..  : col_id emitted at sub-step j (CID is sampled BEFORE
                      the step, include/col_bwt.hpp:513)

PML values are packed (pml << 8 | cid) into the scan outputs; valid for
reads shorter than 2**23 bases (guarded).

Tables are built ON DEVICE from the small per-run index arrays (r-sized),
avoiding any host->device transfer of the O(A^k n) tables themselves, and
composed directly from T1 with a donated fori_loop buffer (lax.map's
stacked accumulator double-buffers, which OOMs at multi-GB sizes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from colbwt_tpu.models.index import ColPmlIndex

INT32_MAX = 2**31 - 1
_PML_PACK_LIMIT = 1 << 23
MAX_K = 4  # 4 cid bytes fill word1
# word0 holds the position in its low 32-k bits and the k match flags above
# (bit 31 is fine: extraction is bitwise only).  T1 itself uses the k=1
# layout (match at bit 31); composition repacks at the target k's layout.
T1_POS_BITS = 31


def pos_bits(k: int) -> int:
    return 32 - k


def pos_mask(k: int) -> int:
    return (1 << pos_bits(k)) - 1


def fits(index: ColPmlIndex, k: int, A_key: int) -> bool:
    """int32 gather indices AND the position fits word0's low 32-k bits."""
    return ((A_key ** k) * index.n <= INT32_MAX
            and index.n <= (1 << pos_bits(k)))


def choose_k(index: ColPmlIndex, hbm_budget_bytes: int = 10 << 30,
             alphabet: bytes | None = None) -> int:
    """Largest k <= 4 whose table fits the memory budget, whose gather indices
    fit int32, and whose positions fit 32-k bits (restricted alphabets
    reach higher k and larger n: |Q|^k keys)."""
    if index.wide:
        return 0
    A = len(alphabet) if alphabet is not None else index.sigma + 1
    best = 0
    for k in range(1, MAX_K + 1):
        if not fits(index, k, A):
            break
        if (A ** k) * index.n * 8 > hbm_budget_bytes:
            break
        best = k
    return best


@functools.partial(jax.jit, static_argnames=("n", "C"), donate_argnums=(0,))
def _build_t1_chunk(buf, char, idx_pad, length, lf_pos0, threshold, pred_row,
                    succ_row, col_id, c, row0, s, n: int, C: int):
    """Fill T1 rows [row0, row0+C) — positions [s, s+C) for key digit char c
    — into the donated buffer: T1[q*n + pos] = [new_pos | match<<31,
    col_id].  One chunk at a time so peak device memory is the table plus
    O(C) temps; a whole-table lax.map formulation needs ~2.5x the table
    (n-sized temps + fragmentation).  pred_row/succ_row are char c's
    jump-table rows only — the full (sigma+1, r) tables are ~2 GB at
    r = 38M.

    idx_pad is the run-start array padded with >= C+1 trailing `n` values:
    because the chunk's positions are CONTIGUOUS, run ids come from a
    scatter + running-max over the <= C runs starting inside the chunk —
    O(C) — instead of a per-position binary search (O(C log r), which at
    r = 38M made the per-chunk searchsorted gather-bound and pushed a
    368 Mbp k=1 table build past half an hour)."""
    r = char.shape[0]
    pos = jax.lax.iota(jnp.int32, C) + s
    lo = (jnp.searchsorted(idx_pad, s, side="right") - 1).astype(jnp.int32)
    win = jax.lax.dynamic_slice(idx_pad, (lo + 1,), (C,))
    off = win - s
    j_rel = jax.lax.iota(jnp.int32, C) + 1
    marks = jnp.zeros(C, jnp.int32).at[
        jnp.clip(off, 0, C - 1)].max(
        jnp.where((off >= 0) & (off < C), j_rel, 0))
    run = lo + jax.lax.cummax(marks)
    offset = pos - jnp.take(idx_pad, run)
    run_char = jnp.take(char, run)
    run_cid = jnp.take(col_id, run)
    lf_match = jnp.take(lf_pos0, run) + offset  # LF needs no ff in pos space

    match = run_char == c
    si = jnp.take(succ_row, run)
    pi = jnp.take(pred_row, run)
    has_succ = si < r
    has_pred = pi >= 0
    thr = jnp.where(has_succ,
                    jnp.take(threshold, jnp.minimum(si, r - 1)), n)
    succ_pos = jnp.take(lf_pos0, jnp.minimum(si, r - 1))
    pic = jnp.maximum(pi, 0)
    pred_pos = jnp.take(lf_pos0, pic) + jnp.take(length, pic) - 1
    # threshold_step priority (include/col_bwt.hpp:531-574): pred iff
    # pos < thr and pred exists (thr == n encodes no successor, making
    # pos < thr true); else succ; else LF from the unmoved state.
    take_pred = (pos < thr) & has_pred
    take_succ = (~take_pred) & has_succ
    repos = jnp.where(take_pred, pred_pos,
                      jnp.where(take_succ, succ_pos, lf_match))
    new_pos = jnp.where(match, lf_match, repos)
    w0 = new_pos | (match.astype(jnp.int32) << T1_POS_BITS)
    block = jnp.stack([w0, run_cid], axis=1)
    return jax.lax.dynamic_update_slice(buf, block, (row0, 0))

# T1 build chunk: bounds per-chunk temps (~6 int32 arrays) to ~0.8 GB
_T1_CHUNK = 1 << 25


@functools.partial(jax.jit, static_argnames=("n", "A", "ka", "kb"),
                   donate_argnums=(0,))
def _compose_tables(buf, ta, tb, n: int, A: int, ka: int, kb: int):
    """Fill T_{ka+kb}[key][pos] = apply T_ka's high-digit block, then T_kb's
    low-digit block from the landed position — ONE chained gather per output
    element (the T_ka read is a contiguous slice).  Building T_k by repeated
    squaring (T1 -> T2 -> T4) therefore costs ~(1 + 1/A^2) gathers/element
    vs the k-1 of direct-from-T1 composition: ~2.8x fewer at k=4.  The
    donated output buffer is updated in place by the fori_loop (lax.map's
    stacked-ys accumulator would double-buffer a multi-GB table).

    Packing invariants (as query_chunk_pos reads them): pos in w0's low
    pos_bits(k) bits, match bit of the j-th processed char at bit
    pos_bits(k)+j, its col id in w1 byte j.  First processed chars are the
    KEY'S HIGH DIGITS, so T_ka covers them and its match/cid stay in the
    low bit/byte slots."""
    k = ka + kb
    pb, pba, pbb = pos_bits(k), pos_bits(ka), pos_bits(kb)
    maska, maskb = pos_mask(ka), pos_mask(kb)
    mbits_a, mbits_b = (1 << ka) - 1, (1 << kb) - 1

    def body(key, buf):
        key_hi = key // (A ** kb)
        key_lo = key % (A ** kb)
        blk_a = jax.lax.dynamic_slice(ta, (key_hi * n, 0), (n, 2))
        pos_a = blk_a[:, 0] & maska
        rows_b = jnp.take(tb, key_lo * n + pos_a, axis=0, mode="clip")
        ma = (blk_a[:, 0] >> pba) & mbits_a
        mb = (rows_b[:, 0] >> pbb) & mbits_b
        w0 = (rows_b[:, 0] & maskb) | (((mb << ka) | ma) << pb)
        w1 = (blk_a[:, 1] & ((1 << (8 * ka)) - 1)) \
            | (rows_b[:, 1] << (8 * ka))
        block = jnp.stack([w0, w1], axis=1)
        return jax.lax.dynamic_update_slice(buf, block, (key * n, 0))

    return jax.lax.fori_loop(0, A ** k, body, buf)


def build_pos_tables(index: ColPmlIndex, k: int | None = None,
                     hbm_budget_bytes: int = 10 << 30,
                     alphabet: bytes | None = None) -> dict:
    """Build the k-step tables (on device).  With `alphabet`, keys range
    over those bytes only and the general T1 is kept for fallback routing of
    reads containing other bytes."""
    if k is None:
        k = choose_k(index, hbm_budget_bytes, alphabet)
        if k == 0:
            raise ValueError("no k fits the HBM budget; use ops.query_mega")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}]")
    A_full = index.sigma + 1
    n, r = index.n, index.r

    if alphabet is not None:
        digit_dense = index.char_map[np.frombuffer(alphabet, dtype=np.uint8)]
        if np.unique(digit_dense).size != digit_dense.size:
            raise ValueError("alphabet bytes collide in the dense char map")
        A_key = len(alphabet)
    else:
        digit_dense = np.arange(A_full, dtype=np.int32)
        A_key = A_full
    if index.wide or not fits(index, k, A_key):
        raise ValueError(
            f"positional tables need A_key**k * n <= 2**31 and n <= "
            f"2**(32-k) (A_key={A_key}, k={k}, n={n}); use ops.query_mega "
            "/ query_mega_wide beyond")

    C_pad = min(n, _T1_CHUNK)
    idx = jnp.asarray(np.concatenate([
        index.idx.astype(np.int32),
        np.full(C_pad + 1, n, dtype=np.int32)]))
    length = jnp.asarray(index.length.astype(np.int32))
    di = index.dest_interval.astype(np.int64)
    lf_pos0 = jnp.asarray((index.idx.astype(np.int64)[di]
                           + index.dest_offset.astype(np.int64)
                           ).astype(np.int32))

    char_j = jnp.asarray(index.char)
    thr_j = jnp.asarray(index.threshold.astype(np.int32))
    cid_j = jnp.asarray(index.col_id)

    def t1_for(chars):
        C = min(n, _T1_CHUNK)
        buf = jnp.zeros((len(chars) * n, 2), dtype=jnp.int32)
        for q, c in enumerate(chars):
            pred_row = jnp.asarray(index.pred_jump[int(c)])
            succ_row = jnp.asarray(index.succ_jump[int(c)])
            for s in range(0, n, C):
                s = min(s, n - C)  # tail chunk overlaps; writes idempotent
                buf = _build_t1_chunk(
                    buf, char_j, idx, length, lf_pos0, thr_j, pred_row,
                    succ_row, cid_j, jnp.int32(int(c)), jnp.int32(q * n + s),
                    jnp.int32(s), n=n, C=C)
            del pred_row, succ_row
        return buf

    t1 = t1_for(digit_dense)  # keyed by the key digits themselves
    if k == 1:
        table = t1
    else:
        # repeated squaring: T2 = T1.T1, then T3 = T2.T1 / T4 = T2.T2 —
        # each level is 1 chained gather per element (see _compose_tables)
        def compose(ta, ka, tb, kb):
            buf = jnp.zeros((A_key ** (ka + kb) * n, 2), dtype=jnp.int32)
            return _compose_tables(buf, ta, tb, n=n, A=A_key, ka=ka, kb=kb)

        t2 = compose(t1, 1, t1, 1)
        if k == 2:
            del t1
            table = t2
        elif k == 3:
            table = compose(t2, 2, t1, 1)
            del t1, t2
        else:  # k == 4; peak HBM = T4 + T2 = table * (1 + 1/A^2)
            del t1  # T4 composes T2 with itself — free T1 first
            table = compose(t2, 2, t2, 2)
            del t2

    # byte -> key digit (or -1: read reroutes through the fallback — the
    # general k=1 T1 when it fits, else ops.query_xla, handled by callers)
    if alphabet is not None:
        digit_of_dense = np.full(A_full + 1, -1, dtype=np.int32)
        digit_of_dense[digit_dense] = np.arange(A_key, dtype=np.int32)
        t1_general = (t1_for(np.arange(A_full, dtype=np.int32))
                      if fits(index, 1, A_full)
                      and (A_key ** k + A_full) * n * 8 <= hbm_budget_bytes
                      else None)
    else:
        digit_of_dense = np.arange(A_full + 1, dtype=np.int32)
        digit_of_dense[A_full] = A_full  # never produced by encode_patterns
        t1_general = None  # the main table already covers every char

    return {
        "table": table,
        "t1": t1_general,  # fallback path (restricted alphabets only)
        "n": jnp.int32(n),
        "k": k,
        "A": A_key,
        "A_full": A_full,
        "digit_of_dense": digit_of_dense,
        "alphabet": alphabet,
    }


def _fold_keys(cols: jnp.ndarray, k: int, A: int) -> jnp.ndarray:
    """(M, B) reversed char columns -> (M/k, B) composed keys."""
    M, B = cols.shape
    assert M % k == 0
    grp = cols.reshape(M // k, k, B)
    key = grp[:, 0]
    for j in range(1, k):
        key = key * A + grp[:, j]
    return key


@functools.partial(jax.jit, static_argnames=("k", "A", "masked", "unroll",
                                             "packed_out", "fresh_state"))
def query_chunk_pos(pt_table, n, patterns, lengths, pos0, mlen0, step_offset,
                    k: int, A: int, masked: bool = False, unroll: int = 4,
                    packed_out: bool = False, fresh_state: bool = False):
    """One scan over a (B, M) chunk of key DIGITS (M multiple of k).
    Returns ((pml, cid), (pos, mlen)) — or ((packed, None), (pos, mlen))
    with packed_out, where packed = pml << 8 | cid as uint16 when it
    provably fits (fresh_state and M <= 255) else int32.  fresh_state is
    the caller's assertion that mlen0 == 0 (no carried match length), the
    premise of the pml < 256 bound — chunked long-read callers carry state
    and must leave it False.  packed_out serves the streaming path: one
    packed u16 plane is 4x fewer device->host bytes than two int32
    planes.

    State past a lane's end is deliberately NOT masked: reads are
    right-aligned, so every step after a lane's last real character consumes
    left-padding — and all later chunks for that lane are padding too, so
    the corrupted state can never reach a kept output.  masked=True only
    zeroes the pad outputs (cosmetic, for the chunked long-read path's
    reuse of output buffers)."""
    B, M = patterns.shape
    cols = patterns[:, ::-1].T.astype(jnp.int32)
    keys = _fold_keys(cols, k, A)
    steps = (jnp.arange(M // k, dtype=jnp.int32) * k) + step_offset
    pb = pos_bits(k)
    mask = pos_mask(k)

    def body(state, xs):
        pos, mlen = state
        key_col, i = xs
        rows = jnp.take(pt_table, key_col * n + pos, axis=0, mode="clip")
        w0 = rows[:, 0]
        w1 = rows[:, 1]
        outs = []
        ln = mlen
        for j in range(k):
            m = (w0 >> (pb + j)) & 1
            ln = (ln + 1) * m  # match ? len+1 : 0
            cid = (w1 >> (8 * j)) & 0xFF
            packed = (ln << 8) | cid
            if masked:
                packed = jnp.where(i + j < lengths, packed, 0)
            outs.append(packed)
        return (w0 & mask, ln), jnp.stack(outs)

    (pos, mlen), ys = jax.lax.scan(body, (pos0, mlen0), (keys, steps),
                                   unroll=unroll)
    packed = ys.reshape(M, B).T[:, ::-1]
    if packed_out:
        # pml <= mlen0_max + M; only callers asserting fresh state
        # (mlen0 == 0) get the u16 downcast: then M <= 255 guarantees
        # pml < 256 and the packing is lossless.  Carried-state callers
        # keep int32 (pml can exceed 255 regardless of M).
        out = (packed.astype(jnp.uint16)
               if (fresh_state and M <= 255) else packed)
        return (out, None), (pos, mlen)
    return (packed >> 8, packed & 0xFF), (pos, mlen)


def pack_digits(dig: np.ndarray, A: int) -> tuple[np.ndarray, int]:
    """Pack a (B, M) digit matrix to (B, M*bits/8) uint8 — 2 bits/digit for
    A <= 4 (ACGT keys), 4 bits for A <= 16; returns (packed, bits) or
    (dig, 0) when A is too large to pack.  M must be a multiple of 8/bits.
    Cuts the upload plane 4x (or 2x); the device unpacks with two shifts
    (query_batch_pos pack=bits)."""
    if A > 16:
        return dig, 0
    bits = 2 if A <= 4 else 4
    per = 8 // bits
    B, M = dig.shape
    assert M % per == 0, (M, per)
    grp = dig.reshape(B, M // per, per).astype(np.uint16)
    shifts = (np.arange(per, dtype=np.uint16) * bits)[None, None, :]
    return (grp << shifts).sum(axis=2).astype(np.uint8), bits


@functools.partial(jax.jit, static_argnames=("pack",))
def _unpack_digits(packed: jnp.ndarray, pack: int) -> jnp.ndarray:
    per = 8 // pack
    B = packed.shape[0]
    shifts = (jnp.arange(per, dtype=jnp.uint8) * pack)[None, None, :]
    dig = (packed[:, :, None] >> shifts) & ((1 << pack) - 1)
    return dig.reshape(B, -1)


@functools.partial(jax.jit, static_argnames=("k", "A", "packed_out", "pack"))
def query_batch_pos(pt_table, n, patterns, lengths, k: int, A: int,
                    packed_out: bool = False, pack: int = 0):
    if pack:
        patterns = _unpack_digits(patterns, pack)
    B = patterns.shape[0]
    pos0 = jnp.broadcast_to(n - 1, (B,)).astype(jnp.int32)
    mlen0 = jnp.zeros((B,), dtype=jnp.int32)
    (pml, cid), _ = query_chunk_pos(pt_table, n, patterns, lengths,
                                    pos0, mlen0, jnp.int32(0), k=k, A=A,
                                    packed_out=packed_out, fresh_state=True)
    return pml, cid


def unpack_pml_cid(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side split of a packed_out plane back into (pml, cid) int32."""
    pk = np.asarray(packed).astype(np.int32)
    return pk >> 8, pk & 0xFF


def _encode_digits(index: ColPmlIndex, pt: dict, patterns: list[bytes],
                   M: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode patterns to key digits; returns (digits, lens, fallback_mask)
    where fallback_mask marks reads containing non-alphabet bytes."""
    enc, lens = index.encode_patterns(patterns, max_len=M)
    dig = pt["digit_of_dense"][enc]
    B = enc.shape[0]
    cols = np.arange(M) >= (M - lens[:, None])
    bad = ((dig < 0) & cols).any(axis=1)
    dig = np.where(dig < 0, 0, dig)  # pad digit; bad lanes rerouted anyway
    # uint8: digits < A <= sigma+1; 4x fewer upload bytes than int32
    return dig.astype(np.uint8), lens, bad


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, pt: dict | None = None,
                k: int | None = None, alphabet: bytes | None = None
                ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Batched PML+CID queries through the positional-automaton tables.
    With a restricted-alphabet table, reads containing other bytes are
    rerouted through the general k=1 table (exact, just slower)."""
    if pt is None:
        pt = build_pos_tables(index, k, alphabet=alphabet)
    k = pt["k"]
    m_raw = max_len if max_len is not None else max(
        (len(p) for p in patterns), default=1)
    M = -(-m_raw // k) * k  # pad to a multiple of k (pads process last)
    if M >= _PML_PACK_LIMIT:
        raise ValueError(f"read length {M} overflows the pml<<8 packing")
    dig, lens, bad = _encode_digits(index, pt, patterns, M)
    pml, cid = query_batch_pos(pt["table"], pt["n"], jnp.asarray(dig),
                               jnp.asarray(lens), k=k, A=pt["A"])
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    out_p = [pml[b, M - int(lens[b]):] for b in range(len(patterns))]
    out_c = [cid[b, M - int(lens[b]):] for b in range(len(patterns))]
    if bad.any():
        idxs = np.flatnonzero(bad)
        if pt["t1"] is not None:
            enc, blens = index.encode_patterns([patterns[i] for i in idxs], M)
            p2, c2 = query_batch_pos(pt["t1"], pt["n"], jnp.asarray(enc),
                                     jnp.asarray(blens), k=1, A=pt["A_full"])
            p2 = np.asarray(p2)
            c2 = np.asarray(c2)
            pc2 = ([p2[j, M - int(blens[j]):] for j in range(idxs.size)],
                   [c2[j, M - int(blens[j]):] for j in range(idxs.size)])
        else:  # general T1 does not fit: compact engine serves the stragglers
            from colbwt_tpu.ops import query_xla

            pc2 = query_xla.query_batch(index, [patterns[i] for i in idxs],
                                        max_len=M)
        for j, i in enumerate(idxs):
            out_p[i] = pc2[0][j]
            out_c[i] = pc2[1][j]
    return out_p, out_c


def query_long_reads(index: ColPmlIndex, patterns: list[bytes],
                     chunk: int = 2048, pt: dict | None = None,
                     k: int | None = None, alphabet: bytes | None = None
                     ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Arbitrary-length reads via chunked scans with carried (pos, mlen)
    state — the -l mode (src/pml_query.cpp:126-128) on the positional
    engine.  Exactly equivalent to one giant scan (differential-tested)."""
    if pt is None:
        pt = build_pos_tables(index, k, alphabet=alphabet)
    k = pt["k"]
    A = pt["A"]
    chunk = -(-chunk // k) * k
    B = len(patterns)
    max_m = max((len(p) for p in patterns), default=1)
    n_chunks = max(1, -(-max_m // chunk))
    M = n_chunks * chunk
    if M >= _PML_PACK_LIMIT:
        raise ValueError(f"padded length {M} overflows the pml<<8 packing")
    dig, lens, bad = _encode_digits(index, pt, patterns, M)
    if bad.any():
        # reroute whole reads: through the general k=1 table when kept,
        # else the compact engine (exact either way, just slower)
        idxs = np.flatnonzero(bad)
        if pt["t1"] is not None:
            general = dict(pt, table=pt["t1"], k=1, A=pt["A_full"], t1=None,
                           alphabet=None,
                           digit_of_dense=np.arange(pt["A_full"] + 1))
            gp, gc = query_long_reads(index, [patterns[i] for i in idxs],
                                      chunk=chunk, pt=general)
        else:
            from colbwt_tpu.ops import query_xla

            gp, gc = query_xla.query_batch(index,
                                           [patterns[i] for i in idxs])
    dig_j = jnp.asarray(dig)
    lens_j = jnp.asarray(lens)

    pml_full = np.zeros((B, M), dtype=np.int32)
    cid_full = np.zeros((B, M), dtype=np.int32)
    pos = jnp.broadcast_to(pt["n"] - 1, (B,)).astype(jnp.int32)
    mlen = jnp.zeros((B,), dtype=jnp.int32)
    for j in range(n_chunks):
        lo = M - (j + 1) * chunk
        (pml, cid), (pos, mlen) = query_chunk_pos(
            pt["table"], pt["n"], dig_j[:, lo:lo + chunk], lens_j,
            pos, mlen, jnp.int32(j * chunk), k=k, A=A, masked=True)
        pml_full[:, lo:lo + chunk] = np.asarray(pml)
        cid_full[:, lo:lo + chunk] = np.asarray(cid)
    out_p = [pml_full[b, M - int(lens[b]):] for b in range(B)]
    out_c = [cid_full[b, M - int(lens[b]):] for b in range(B)]
    if bad.any():
        for j, i in enumerate(np.flatnonzero(bad)):
            out_p[i] = gp[j]
            out_c[i] = gc[j]
    return out_p, out_c
