"""Fused-gather query engine — the fast path.

The design premise is that a gather costs per *index*, nearly independent
of how many contiguous fields each index fetches, so a (B, 8) row gather
costs about what a (B,) scalar gather does (a hypothesis on the GPU, where
a row within one 32 B sector should cost one memory transaction; not
measured there yet).  The baseline engine (ops.query_xla) spends
~12 gather indices per read per character; this engine restructures the same
recurrence (col_pml::_query_pml, include/col_bwt.hpp:498-574) to K+1 indices
per step:

1. ``run_rows[interval]`` — one (B, 8) gather yielding char, col_id,
   dest_interval, dest_offset and ``lf_pos0 = idx[dest] + dest_offset`` (so
   the post-LF rank position is lf_pos0 + offset with no further gather).
2. ``jump_rows[c * r + interval]`` — one (B, 8) gather yielding the
   *entire precomputed mismatch outcome*: the threshold of the successor run,
   and the fully LF-stepped-and-fast-forwarded (interval, offset, pos) states
   for both the successor (top of run) and predecessor (bottom of run)
   repositioning targets.  These are fixed functions of (char, run) — the
   whole threshold_step + LF + fast-forward chain collapses into one gather.
3. K-1 scalar gathers on the run-length array for the match/fallback path's
   LF fast-forward (bounded by ops.run_split).

Same semantics, differential-tested for exact equality against the oracle and
the baseline engine.  Memory cost: 32 B/run + 32 B/(char, run) — the jump
mega-table is (sigma+1) * r * 32 bytes, the price of the speed; the compact
engine remains available for memory-constrained indexes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from colbwt_tpu.models.index import ColPmlIndex

NO_STATE = -1


def build_fused_tables(index: ColPmlIndex) -> dict:
    """Precompute the packed row and jump mega-tables (host, vectorized)."""
    if index.wide:
        raise ValueError("n >= 2**31: int32 positions would overflow — "
                         "use ops.query_mega_wide")
    r, n = index.r, index.n
    char = index.char.astype(np.int32)
    col_id = index.col_id.astype(np.int32)
    idx = index.idx.astype(np.int64)
    length = index.length.astype(np.int64)
    di = index.dest_interval.astype(np.int64)
    doff = index.dest_offset.astype(np.int64)
    thr = index.threshold.astype(np.int64)

    lf_pos0 = idx[di] + doff

    run_rows = np.zeros((r, 8), dtype=np.int32)
    run_rows[:, 0] = char
    run_rows[:, 1] = col_id
    run_rows[:, 2] = di
    run_rows[:, 3] = doff
    run_rows[:, 4] = lf_pos0
    run_rows[:, 5] = length

    def resolve(start_run: np.ndarray, start_off: np.ndarray, ok: np.ndarray):
        """LF + full fast-forward from (run, offset) -> (interval', off', pos')."""
        sr = np.where(ok, start_run, 0)
        d = di[sr]
        o = doff[sr] + start_off
        pos = idx[d] + o
        out_int = np.searchsorted(idx, pos, side="right") - 1
        out_off = pos - idx[out_int]
        return (np.where(ok, out_int, NO_STATE).astype(np.int32),
                np.where(ok, out_off, 0).astype(np.int32),
                np.where(ok, pos, 0).astype(np.int32))

    sigma = index.sigma
    jump_rows = np.zeros(((sigma + 1) * r, 8), dtype=np.int32)
    for c in range(sigma + 1):
        si = index.succ_jump[c].astype(np.int64)
        pi = index.pred_jump[c].astype(np.int64)
        has_succ = si < r
        has_pred = pi >= 0
        thr_c = np.where(has_succ, thr[np.minimum(si, r - 1)], n)
        s_int, s_off, s_pos = resolve(si, np.zeros(r, dtype=np.int64), has_succ)
        p_run = np.maximum(pi, 0)
        p_int, p_off, p_pos = resolve(p_run, length[p_run] - 1, has_pred)
        block = jump_rows[c * r:(c + 1) * r]
        block[:, 0] = thr_c
        block[:, 1] = s_int
        block[:, 2] = s_off
        block[:, 3] = s_pos
        block[:, 4] = p_int
        block[:, 5] = p_off
        block[:, 6] = p_pos

    from colbwt_tpu.utils.xfer import device_put_chunked

    return {
        "run_rows": device_put_chunked(run_rows),
        "jump_rows": device_put_chunked(jump_rows),
        "length": jnp.asarray(length.astype(np.int32)),
        "n": jnp.int32(n),
        "r": jnp.int32(r),
    }


@functools.partial(jax.jit, static_argnames=("ff_bound", "unroll"))
def query_batch_fused(ft: dict, patterns: jnp.ndarray, lengths: jnp.ndarray,
                      ff_bound: int = 4, unroll: int = 4
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(B, M) right-aligned dense-id patterns -> (pml, cid), both (B, M)."""
    B, M = patterns.shape
    r = ft["r"]
    n = ft["n"]
    run_rows = ft["run_rows"]
    jump_rows = ft["jump_rows"]
    length_arr = ft["length"]

    interval0 = jnp.broadcast_to(r - 1, (B,)).astype(jnp.int32)
    offset0 = jnp.broadcast_to(run_rows[r - 1, 5] - 1, (B,)).astype(jnp.int32)
    pos0 = jnp.broadcast_to(n - 1, (B,)).astype(jnp.int32)
    len0 = jnp.zeros((B,), dtype=jnp.int32)

    cols = patterns[:, ::-1].T  # (M, B)
    steps = jnp.arange(M, dtype=jnp.int32)

    def body(state, xs):
        interval, offset, pos, mlen = state
        c, i = xs
        valid = i < lengths

        rows = jnp.take(run_rows, interval, axis=0, mode="clip")  # gather 1
        char_i = rows[:, 0]
        cid_out = rows[:, 1]
        match = char_i == c

        jrows = jnp.take(jump_rows, c * r + interval, axis=0, mode="clip")  # 2
        # reposition priority (threshold_step, include/col_bwt.hpp:531-574):
        # pred if pos < thr AND a predecessor exists; else succ if one exists
        # (thr == n encodes "no successor"); else LF from the current state
        thr = jrows[:, 0]
        use_pred = pos < thr
        has_pred = jrows[:, 4] >= 0
        has_succ = thr < n
        take_pred = (~match) & use_pred & has_pred
        take_succ = (~match) & (~take_pred) & has_succ

        # match / fallback path: LF from (interval, offset) with bounded ff
        di = rows[:, 2]
        doff = rows[:, 3] + offset
        lf_pos = rows[:, 4] + offset
        for _ in range(ff_bound - 1):  # gathers 3..K+1
            ln = jnp.take(length_arr, di, mode="clip")
            over = doff >= ln
            di = di + over.astype(jnp.int32)
            doff = doff - jnp.where(over, ln, 0)

        new_interval = jnp.where(take_pred, jrows[:, 4],
                                 jnp.where(take_succ, jrows[:, 1], di))
        new_offset = jnp.where(take_pred, jrows[:, 5],
                               jnp.where(take_succ, jrows[:, 2], doff))
        new_pos = jnp.where(take_pred, jrows[:, 6],
                            jnp.where(take_succ, jrows[:, 3], lf_pos))
        new_len = jnp.where(match, mlen + 1, 0)

        interval = jnp.where(valid, new_interval, interval)
        offset = jnp.where(valid, new_offset, offset)
        pos = jnp.where(valid, new_pos, pos)
        mlen = jnp.where(valid, new_len, mlen)
        return ((interval, offset, pos, mlen),
                (jnp.where(valid, new_len, 0), jnp.where(valid, cid_out, 0)))

    _, (pml_steps, cid_steps) = jax.lax.scan(
        body, (interval0, offset0, pos0, len0), (cols, steps), unroll=unroll)
    return pml_steps.T[:, ::-1], cid_steps.T[:, ::-1]


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, ft: dict | None = None
                ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Host convenience API mirroring ops.query_xla.query_batch."""
    if index.ff_bound < 1:
        raise ValueError("fused engine requires a run-split index "
                         "(ColPmlIndex.build with ff_bound >= 1)")
    if ft is None:
        ft = build_fused_tables(index)
    enc, lens = index.encode_patterns(patterns, max_len)
    pml, cid = query_batch_fused(ft, jnp.asarray(enc), jnp.asarray(lens),
                                 ff_bound=index.ff_bound)
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])
