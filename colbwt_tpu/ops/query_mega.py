"""Mega-row query engine — ONE gather index per read per character.

Every quantity the recurrence (col_pml::_query_pml, include/col_bwt.hpp:
498-574) needs at a step is a pure function of (pattern char c, current run i)
plus the lane's offset/pos — so it can all be precomputed into one
(sigma+1) * r × 16 int32 row fetched with a single gather of index c*r + i:

  [0] is_match        char[i] == c
  [1] col_id[i]       the CID emitted this step (pre-reposition)
  [2] di0             LF dest run of i
  [3] doff0           LF dest offset of i
  [4] lf_pos0         idx[di0] + doff0  (post-LF rank pos = lf_pos0 + offset)
  [5] dlen0           length[di0]       (the single k=2 fast-forward round)
  [6] thr             threshold of the successor c-run (n if none)
  [7..9]              successor repositioning outcome (interval', off', pos'),
                      already LF-stepped and fast-forwarded
  [10..12]            predecessor outcome likewise ([10] == -1 if none)

Requires a k=2 run-split index (every LF image spans <= 2 runs), so the one
fast-forward round closes the walk with the precomputed dlen0 — no dynamic
control flow, no second gather.  If gather cost is per index (see
ops.query_fused), this engine's step costs one index where the baseline
costs ~12.

Memory: 64 B per (char, run) — (sigma+1)*r*64 bytes.  For indexes where that
does not fit HBM, use ops.query_fused (2+K-1 indices, 32 B/(char,run)) or
ops.query_xla (compact, no mega-tables).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from colbwt_tpu.models.index import ColPmlIndex

NO_STATE = -1


def build_mega_table(index: ColPmlIndex) -> dict:
    if index.ff_bound < 2:
        raise ValueError("mega engine requires a run-split index "
                         "(ColPmlIndex.build(tbl, ff_bound=2))")
    if index.wide:
        raise ValueError("n >= 2**31: int32 positions would overflow — "
                         "use ops.query_mega_wide")
    r, n = index.r, index.n
    char = index.char.astype(np.int64)
    col_id = index.col_id.astype(np.int64)
    idx = index.idx.astype(np.int64)
    length = index.length.astype(np.int64)
    di = index.dest_interval.astype(np.int64)
    doff = index.dest_offset.astype(np.int64)
    thr = index.threshold.astype(np.int64)
    sigma = index.sigma

    lf_pos0 = idx[di] + doff
    dlen0 = length[di]

    def resolve(start_run, start_off, ok):
        sr = np.where(ok, start_run, 0)
        d = di[sr]
        o = doff[sr] + start_off
        pos = idx[d] + o
        out_int = np.searchsorted(idx, pos, side="right") - 1
        out_off = pos - idx[out_int]
        return (np.where(ok, out_int, NO_STATE),
                np.where(ok, out_off, 0),
                np.where(ok, pos, 0))

    mega = np.zeros(((sigma + 1) * r, 16), dtype=np.int32)
    for c in range(sigma + 1):
        blk = mega[c * r:(c + 1) * r]
        blk[:, 0] = (char == c)
        blk[:, 1] = col_id
        blk[:, 2] = di
        blk[:, 3] = doff
        blk[:, 4] = lf_pos0
        blk[:, 5] = dlen0
        si = index.succ_jump[c].astype(np.int64)
        pi = index.pred_jump[c].astype(np.int64)
        has_succ = si < r
        has_pred = pi >= 0
        blk[:, 6] = np.where(has_succ, thr[np.minimum(si, r - 1)], n)
        s_int, s_off, s_pos = resolve(si, np.zeros(r, dtype=np.int64), has_succ)
        blk[:, 7], blk[:, 8], blk[:, 9] = s_int, s_off, s_pos
        p_run = np.maximum(pi, 0)
        p_int, p_off, p_pos = resolve(p_run, length[p_run] - 1, has_pred)
        blk[:, 10], blk[:, 11], blk[:, 12] = p_int, p_off, p_pos

    from colbwt_tpu.utils.xfer import device_put_chunked

    return {
        "mega": device_put_chunked(mega),
        "length": jnp.asarray(length.astype(np.int32)),
        "n": jnp.int32(n),
        "r": jnp.int32(r),
        "last_len": jnp.int32(int(length[r - 1])),
    }


def initial_state(mt: dict, batch: int):
    """The reference's query start state: bottom of the BWT
    (include/col_bwt.hpp:503-507)."""
    B = batch
    r = mt["r"]
    n = mt["n"]
    return (jnp.broadcast_to(r - 1, (B,)).astype(jnp.int32),
            jnp.broadcast_to(mt["last_len"] - 1, (B,)).astype(jnp.int32),
            jnp.broadcast_to(n - 1, (B,)).astype(jnp.int32),
            jnp.zeros((B,), dtype=jnp.int32))


@functools.partial(jax.jit, static_argnames=("unroll", "ff_bound", "masked",
                                             "packed_out", "fresh_state"))
def query_chunk_mega(mt: dict, patterns: jnp.ndarray, lengths: jnp.ndarray,
                     state, step_offset: jnp.ndarray, unroll: int = 4,
                     ff_bound: int = 2, masked: bool = True,
                     packed_out: bool = False, fresh_state: bool = False):
    """One chunk of the backward scan with carried state (long-read streaming,
    the -l mode of src/pml_query.cpp:126-128 re-imagined as chunked device
    scans).  `lengths` are the full read lengths; a lane is active while
    step_offset + i < length.  Returns ((pml, cid), final_state).

    ff_bound is the index's achieved LF-image span: the first fast-forward
    round uses the precomputed destination-run length in the mega row, any
    further rounds gather from the length array.

    masked=False drops the per-step validity selects: for right-aligned
    single-chunk batches, steps past a lane's length only write pad columns
    (discarded at unpad) and the final state is unused — skipping the six
    selects per step shaves measurable overhead off the gather-bound loop.
    Must stay True whenever the final state is consumed (chunked long reads).

    packed_out emits one (pml << 8 | cid) plane instead of two, downcast to
    uint16 only when fresh_state (mlen0 == 0 asserted by the caller) and
    M <= 255 bound pml below 256 — the slim device->host scheme of the
    one-shot and streaming drivers.  patterns may be uint8."""
    B, M = patterns.shape
    r = mt["r"]
    n = mt["n"]
    mega = mt["mega"]
    length_arr = mt["length"]

    cols = patterns[:, ::-1].T.astype(jnp.int32)
    steps = jnp.arange(M, dtype=jnp.int32) + step_offset

    def body(state, xs):
        interval, offset, pos, mlen = state
        c, i = xs
        valid = i < lengths

        rows = jnp.take(mega, c * r + interval, axis=0, mode="clip")  # 1 gather
        match = rows[:, 0] == 1
        cid_out = rows[:, 1]

        # match / no-reposition path: LF + fast-forward (first round from the
        # precomputed dest-run length, further rounds gathered)
        doff = rows[:, 3] + offset
        lf_pos = rows[:, 4] + offset
        over = doff >= rows[:, 5]
        di = rows[:, 2] + over.astype(jnp.int32)
        doff = doff - jnp.where(over, rows[:, 5], 0)
        for _ in range(ff_bound - 2):
            ln = jnp.take(length_arr, di, mode="clip")
            over = doff >= ln
            di = di + over.astype(jnp.int32)
            doff = doff - jnp.where(over, ln, 0)

        # reposition priority (threshold_step, include/col_bwt.hpp:531-574):
        # pred if pos < thr AND a predecessor exists; else succ if one exists
        # (thr == n encodes "no successor"); else LF from the current state
        thr = rows[:, 6]
        use_pred = pos < thr
        has_pred = rows[:, 10] >= 0
        has_succ = thr < n
        take_pred = (~match) & use_pred & has_pred
        take_succ = (~match) & (~take_pred) & has_succ

        new_interval = jnp.where(take_pred, rows[:, 10],
                                 jnp.where(take_succ, rows[:, 7], di))
        new_offset = jnp.where(take_pred, rows[:, 11],
                               jnp.where(take_succ, rows[:, 8], doff))
        new_pos = jnp.where(take_pred, rows[:, 12],
                            jnp.where(take_succ, rows[:, 9], lf_pos))
        new_len = jnp.where(match, mlen + 1, 0)

        if packed_out:
            out = ((new_len << 8) | cid_out,)
        else:
            out = (new_len, cid_out)
        if not masked:
            return ((new_interval, new_offset, new_pos, new_len), out)
        interval = jnp.where(valid, new_interval, interval)
        offset = jnp.where(valid, new_offset, offset)
        pos = jnp.where(valid, new_pos, pos)
        mlen = jnp.where(valid, new_len, mlen)
        return ((interval, offset, pos, mlen),
                tuple(jnp.where(valid, o, 0) for o in out))

    final, outs = jax.lax.scan(body, state, (cols, steps), unroll=unroll)
    if packed_out:
        packed = outs[0].T[:, ::-1]
        if fresh_state and M <= 255:
            packed = packed.astype(jnp.uint16)  # pml < 256 provable
        return (packed, None), final
    return (outs[0].T[:, ::-1], outs[1].T[:, ::-1]), final


@functools.partial(jax.jit, static_argnames=("unroll", "ff_bound",
                                             "packed_out"))
def query_batch_mega(mt: dict, patterns: jnp.ndarray, lengths: jnp.ndarray,
                     unroll: int = 4, ff_bound: int = 2,
                     packed_out: bool = False
                     ) -> tuple[jnp.ndarray, jnp.ndarray]:
    (pml, cid), _ = query_chunk_mega(
        mt, patterns, lengths, initial_state(mt, patterns.shape[0]),
        jnp.int32(0), unroll=unroll, ff_bound=ff_bound, masked=False,
        packed_out=packed_out, fresh_state=True)
    return pml, cid


def query_long_reads(index: ColPmlIndex, patterns: list[bytes],
                     chunk: int = 2048, mt: dict | None = None
                     ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Arbitrary-length reads via chunked scans with carried state.

    Reads are right-aligned to a chunk multiple and processed right-to-left
    chunk by chunk; per-chunk outputs assemble the full per-base arrays.
    Exactly equivalent to one giant scan (differential-tested)."""
    if mt is None:
        mt = build_mega_table(index)
    B = len(patterns)
    max_m = max((len(p) for p in patterns), default=1)
    n_chunks = max(1, -(-max_m // chunk))
    M = n_chunks * chunk
    enc, lens = index.encode_patterns(patterns, max_len=M)
    enc_j = jnp.asarray(enc.astype(np.uint8))
    lens_j = jnp.asarray(lens)

    pml_full = np.zeros((B, M), dtype=np.int32)
    cid_full = np.zeros((B, M), dtype=np.int32)
    state = initial_state(mt, B)
    # packed int32 plane halves the download bytes of two planes, but the
    # pml << 8 packing overflows int32 once a match length reaches 2**23 —
    # contig-length reads fall back to exact two-plane outputs
    packed = (M < (1 << 23)
              and int(index.col_id.max(initial=0)) <= 0xFF)
    for j in range(n_chunks):
        lo = M - (j + 1) * chunk
        cols = enc_j[:, lo:lo + chunk]
        out, state = query_chunk_mega(
            mt, cols, lens_j, state, jnp.int32(j * chunk),
            ff_bound=index.ff_bound, packed_out=packed)
        if packed:
            pk = np.asarray(out[0])
            pml_full[:, lo:lo + chunk] = pk >> 8
            cid_full[:, lo:lo + chunk] = pk & 0xFF
        else:
            pml_full[:, lo:lo + chunk] = np.asarray(out[0])
            cid_full[:, lo:lo + chunk] = np.asarray(out[1])
    return ([pml_full[b, M - int(lens[b]):] for b in range(B)],
            [cid_full[b, M - int(lens[b]):] for b in range(B)])


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, mt: dict | None = None
                ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    if mt is None:
        mt = build_mega_table(index)
    enc, lens = index.encode_patterns(patterns, max_len)
    pml, cid = query_batch_mega(mt, jnp.asarray(enc), jnp.asarray(lens),
                                ff_bound=index.ff_bound)
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])
