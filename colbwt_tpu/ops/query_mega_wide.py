"""Wide mega-row query engine — large-n (n >= 2**31) variant of ops.query_mega.

The reference's position budget is n < 2**40 (idx:40b, threshold:40b packed
fields, include/ds/LF_table.hpp:36-39, include/col_bwt.hpp:84) — beyond int32
but far under int64.  JAX's x64 mode is process-global, so position-valued
quantities (pos, thresholds, LF rank positions)
travel as TWO int32 limbs in base 2**30:

    value = hi * 2**30 + lo,   lo in [0, 2**30)

Adding an intra-run offset (< 2**29, enforced by ops.run_split.
split_runs_max_len at index build) to a lo limb stays below 2**31 — one
conditional carry normalizes.  Ordering tests are (hi, lo) lexicographic.
Run-valued quantities (interval, r) remain single int32, matching the
reference's RUN_BYTES=4 budget (r < 2**32).

The wide row — 16 int32 columns, 64 B, with the match flag folded into the
CID column — still costs ONE gather per read per character, so if gather
cost is per index (ops.query_fused) large-n querying runs at narrow-engine
speed.  Whether two-limb arithmetic still pays on the GPU, where int64 is
native, is not measured yet.

TABLE BUILD IS ON DEVICE.  The table is (sigma+1)*r x 16 int32 — 5.8 GB at
r = 15.2M — and materializing it on host then shipping it would need the
host copy plus the transfer.  Instead only the r-sized per-run arrays travel
(9 x 4 B/run), the per-char jump rows are recomputed on device (cummax /
reverse-cummin over the char array), the succ/pred landing runs are resolved
with the same statically-bounded LF fast-forward the engine uses (run
splitting bounds every LF image span to ff_bound runs, so the host
searchsorted is unnecessary), and each char block lands in a DONATED
preallocated buffer — peak device memory is the table plus O(r) temps.

Two layouts:

- full (default): one ((sigma+1)*r, 16) table, ONE gather per step;
- compact: the 7 char-independent columns (char/cid/LF dest) live once in a
  (r, 8)-padded shared table and only the 10 threshold_step columns replicate
  per char ((sigma+1)*r, 10) — 34% smaller at sigma = 5, two gathers per
  step.  Chosen automatically when the full table would not fit the device
  memory budget (utils/hbm).

Semantics are identical to ops.query_mega / the int64 NumPy oracle
(col_pml::_query_pml, include/col_bwt.hpp:498-574), differential-tested on
scaled move tables with n > 2**31.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from colbwt_tpu.models.index import MAX_WIDE_RUN_LEN, ColPmlIndex

NO_STATE = -1
LIMB = 2**30

# wide mega-row column layout (full table).  16 columns = 64 B rows: the
# match flag rides bit 8 of the CID column (_MC = match << 8 | cid), so a
# row is two aligned 32 B sectors instead of a boundary-straddling 68 B.
_MC, _DI0, _DOFF0, _LF_LO, _LF_HI, _DLEN0 = range(6)
_THR_LO, _THR_HI = 6, 7
_S_INT, _S_OFF, _S_LO, _S_HI = 8, 9, 10, 11
_P_INT, _P_OFF, _P_LO, _P_HI = 12, 13, 14, 15
_WIDTH = 16

# compact layout: shared (char-independent) columns, padded to 8 for layout
_SH_CHAR, _SH_CID, _SH_DI0, _SH_DOFF0, _SH_LF_LO, _SH_LF_HI, _SH_DLEN0 = range(7)
_SH_WIDTH = 8
# compact per-char columns (threshold_step operands only)
_PC_THR_LO, _PC_THR_HI = 0, 1
_PC_S_INT, _PC_S_OFF, _PC_S_LO, _PC_S_HI = 2, 3, 4, 5
_PC_P_INT, _PC_P_OFF, _PC_P_LO, _PC_P_HI = 6, 7, 8, 9
_PC_WIDTH = 10


def _limbs(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    v = np.asarray(v, dtype=np.int64)
    return ((v % LIMB).astype(np.int32), (v // LIMB).astype(np.int32))


def wide_table_bytes(index: ColPmlIndex, compact: bool = False) -> int:
    blocks = index.sigma + 1
    r = index.r
    if compact:
        return 4 * r * (_SH_WIDTH + blocks * _PC_WIDTH)
    return 4 * blocks * r * _WIDTH


# ---------------------------------------------------------------------------
# device-side block computation (shared by full and compact builders)

def _device_block_cols(c, char, col_id, di, doff, length, idx_lo, idx_hi,
                       thr_lo, thr_hi, n_lo, n_hi, ff_bound: int):
    """The 17 raw column vectors (match and cid still separate — builders
    fold them into _MC) of char block `c`, computed from the r-sized
    per-run arrays.  succ/pred landing states use the same statically
    bounded LF fast-forward as the query step (run splitting guarantees
    every LF image spans <= ff_bound runs — include/ds/LF_table.hpp:251-262
    semantics with the Movi-style bound [inferred])."""
    r = char.shape[0]
    rows_i = jax.lax.iota(jnp.int32, r)

    match = (char == c).astype(jnp.int32)
    # LF at offset 0 of each run: pos limbs + destination run/offset
    lf_lo0 = jnp.take(idx_lo, di, mode="clip") + doff
    carry = (lf_lo0 >= LIMB).astype(jnp.int32)
    lf_lo0 = lf_lo0 - carry * LIMB
    lf_hi0 = jnp.take(idx_hi, di, mode="clip") + carry
    dlen0 = jnp.take(length, di, mode="clip")

    # per-char jump rows (models/index.py pred_jump/succ_jump, recomputed):
    # succ = first c-run at or after, pred = last c-run at or before
    is_c = char == c
    s_run = jax.lax.cummin(jnp.where(is_c, rows_i, r), axis=0, reverse=True)
    p_run = jax.lax.cummax(jnp.where(is_c, rows_i, NO_STATE), axis=0)
    has_succ = s_run < r
    has_pred = p_run >= 0

    sr = jnp.minimum(s_run, r - 1)
    t_lo = jnp.where(has_succ, jnp.take(thr_lo, sr, mode="clip"), n_lo)
    t_hi = jnp.where(has_succ, jnp.take(thr_hi, sr, mode="clip"), n_hi)

    def resolve(start_run, start_off, ok):
        """Landing state of LF(start_run, start_off): run, offset, pos limbs.
        pos = idx[dest] + (doff[start] + start_off) is invariant under the
        fast-forward, so the limbs are computed once."""
        run0 = jnp.where(ok, start_run, 0)
        d = jnp.take(di, run0, mode="clip")
        o = jnp.take(doff, run0, mode="clip") + start_off
        lo = jnp.take(idx_lo, d, mode="clip") + o
        cr = (lo >= LIMB).astype(jnp.int32)
        lo = lo - cr * LIMB
        hi = jnp.take(idx_hi, d, mode="clip") + cr
        ln = jnp.take(length, d, mode="clip")
        over = o >= ln
        d = d + over.astype(jnp.int32)
        o = o - jnp.where(over, ln, 0)
        for _ in range(ff_bound - 2):
            ln = jnp.take(length, d, mode="clip")
            over = o >= ln
            d = d + over.astype(jnp.int32)
            o = o - jnp.where(over, ln, 0)
        return (jnp.where(ok, d, NO_STATE), jnp.where(ok, o, 0),
                jnp.where(ok, lo, 0), jnp.where(ok, hi, 0))

    s_int, s_off, s_lo, s_hi = resolve(sr, jnp.zeros((), jnp.int32), has_succ)
    pr = jnp.maximum(p_run, 0)
    p_int, p_off, p_lo, p_hi = resolve(
        pr, jnp.take(length, pr, mode="clip") - 1, has_pred)

    return (match, col_id, di, doff, lf_lo0, lf_hi0, dlen0,
            t_lo, t_hi, s_int, s_off, s_lo, s_hi, p_int, p_off, p_lo, p_hi)


@functools.partial(jax.jit, static_argnames=("ff_bound",),
                   donate_argnums=(0,))
def _fill_block_full(buf, c, char, col_id, di, doff, length, idx_lo, idx_hi,
                     thr_lo, thr_hi, n_lo, n_hi, ff_bound: int):
    cols = _device_block_cols(c, char, col_id, di, doff, length, idx_lo,
                              idx_hi, thr_lo, thr_hi, n_lo, n_hi, ff_bound)
    mc = (cols[0] << 8) | cols[1]  # match bit 8 | cid bits 0..7 (64 B rows)
    block = jnp.stack((mc,) + cols[2:], axis=1)
    r = char.shape[0]
    return jax.lax.dynamic_update_slice(buf, block, (c * r, 0))


@functools.partial(jax.jit, static_argnames=("ff_bound",),
                   donate_argnums=(0,))
def _fill_block_compact(buf, c, char, col_id, di, doff, length, idx_lo,
                        idx_hi, thr_lo, thr_hi, n_lo, n_hi, ff_bound: int):
    cols = _device_block_cols(c, char, col_id, di, doff, length, idx_lo,
                              idx_hi, thr_lo, thr_hi, n_lo, n_hi, ff_bound)
    block = jnp.stack(cols[7:], axis=1)  # threshold_step columns only
    r = char.shape[0]
    return jax.lax.dynamic_update_slice(buf, block, (c * r, 0))


@jax.jit
def _shared_table(char, col_id, di, doff, length, idx_lo, idx_hi):
    lf_lo0 = jnp.take(idx_lo, di, mode="clip") + doff
    carry = (lf_lo0 >= LIMB).astype(jnp.int32)
    lf_lo0 = lf_lo0 - carry * LIMB
    lf_hi0 = jnp.take(idx_hi, di, mode="clip") + carry
    dlen0 = jnp.take(length, di, mode="clip")
    pad = jnp.zeros_like(char)
    return jnp.stack([char, col_id, di, doff, lf_lo0, lf_hi0, dlen0, pad],
                     axis=1)


def _check_wide_buildable(index: ColPmlIndex) -> None:
    if index.ff_bound < 2:
        raise ValueError("mega engine requires a run-split index "
                         "(ColPmlIndex.build(tbl, ff_bound=2))")
    if int(index.length.max(initial=0)) > MAX_WIDE_RUN_LEN:
        raise ValueError("run lengths must be <= 2**29 for limb arithmetic; "
                         "build with ColPmlIndex.build")
    if int(index.col_id.max(initial=0)) > 0xFF:
        # the 64 B row folds match into the CID column's bit 8; ids beyond
        # the reference's 8-bit budget (ID_BITS, common.hpp:47) would
        # collide with the flag
        raise ValueError("wide mega rows require col ids < 256 "
                         "(id_bits > 8 is not supported by this engine)")


def _device_run_arrays(index: ColPmlIndex):
    """Upload the r-sized per-run arrays (the only host->device traffic)."""
    from colbwt_tpu.utils.xfer import device_put_chunked

    idx_lo, idx_hi = _limbs(index.idx)
    thr_lo, thr_hi = _limbs(index.threshold)
    put = device_put_chunked
    return (put(index.char.astype(np.int32)),
            put(index.col_id.astype(np.int32)),
            put(index.dest_interval.astype(np.int32)),
            put(index.dest_offset.astype(np.int32)),
            put(index.length.astype(np.int32)),
            put(idx_lo), put(idx_hi), put(thr_lo), put(thr_hi))


def _meta(index: ColPmlIndex) -> dict:
    n, r = index.n, index.r
    n_lo, n_hi = _limbs(np.array([n]))
    last_lo, last_hi = _limbs(np.array([n - 1]))
    return {
        "n_lo": jnp.int32(int(n_lo[0])), "n_hi": jnp.int32(int(n_hi[0])),
        "pos0_lo": jnp.int32(int(last_lo[0])),
        "pos0_hi": jnp.int32(int(last_hi[0])),
        "r": jnp.int32(r),
        "last_len": jnp.int32(int(index.length[r - 1])),
    }


def build_mega_table_wide(index: ColPmlIndex, compact: bool | None = None,
                          hbm_budget_bytes: int | None = None) -> dict:
    """Assemble the wide mega table on device.  compact=None auto-selects:
    full layout when it fits the HBM budget (utils/hbm), else compact."""
    _check_wide_buildable(index)
    if compact is None:
        if hbm_budget_bytes is None:
            from colbwt_tpu.utils.hbm import resolve_pos_budget
            hbm_budget_bytes = resolve_pos_budget(0)
        compact = wide_table_bytes(index, compact=False) > hbm_budget_bytes
    r = index.r
    sigma = index.sigma
    arrays = _device_run_arrays(index)
    char, col_id, di, doff, length = arrays[:5]
    meta = _meta(index)
    n_lo, n_hi = meta["n_lo"], meta["n_hi"]

    if not compact:
        buf = jnp.zeros(((sigma + 1) * r, _WIDTH), dtype=jnp.int32)
        for c in range(sigma + 1):
            buf = _fill_block_full(buf, jnp.int32(c), *arrays, n_lo, n_hi,
                                   ff_bound=index.ff_bound)
        out = {"mega": buf}
    else:
        buf = jnp.zeros(((sigma + 1) * r, _PC_WIDTH), dtype=jnp.int32)
        for c in range(sigma + 1):
            buf = _fill_block_compact(buf, jnp.int32(c), *arrays, n_lo, n_hi,
                                      ff_bound=index.ff_bound)
        out = {"shared": _shared_table(char, col_id, di, doff, length,
                                       *arrays[5:7]),
               "percha": buf}
    out["length"] = length
    out.update(meta)
    return out


def _host_block_rows(index: ColPmlIndex, c: int, a: int, b: int
                     ) -> np.ndarray:
    """Rows for char c, run indices [a, b) of the host wide mega table —
    O(b-a) work and memory (plus O(log r) searchsorted per row), so callers
    can assemble arbitrary slices without the full O(sigma*r) table."""
    r, n = index.r, index.n
    char = index.char[a:b].astype(np.int64)
    idx = index.idx.astype(np.int64)
    length = index.length.astype(np.int64)
    di_full = index.dest_interval.astype(np.int64)
    doff_full = index.dest_offset.astype(np.int64)
    di = di_full[a:b]
    doff = doff_full[a:b]
    thr = index.threshold.astype(np.int64)

    lf_pos0 = idx[di] + doff
    dlen0 = length[di]

    def resolve(start_run, start_off, ok):
        sr = np.where(ok, start_run, 0)
        d = di_full[sr]
        o = doff_full[sr] + start_off
        pos = idx[d] + o
        out_int = np.searchsorted(idx, pos, side="right") - 1
        out_off = pos - idx[out_int]
        return (np.where(ok, out_int, NO_STATE),
                np.where(ok, out_off, 0),
                np.where(ok, pos, 0))

    blk = np.zeros((b - a, _WIDTH), dtype=np.int32)
    blk[:, _MC] = ((char == c).astype(np.int32) << 8) | index.col_id[a:b]
    blk[:, _DI0] = di
    blk[:, _DOFF0] = doff
    blk[:, _LF_LO], blk[:, _LF_HI] = _limbs(lf_pos0)
    blk[:, _DLEN0] = dlen0
    si = index.succ_jump[c][a:b].astype(np.int64)
    pi = index.pred_jump[c][a:b].astype(np.int64)
    has_succ = si < r
    has_pred = pi >= 0
    thr_c = np.where(has_succ, thr[np.minimum(si, r - 1)], n)
    blk[:, _THR_LO], blk[:, _THR_HI] = _limbs(thr_c)
    s_int, s_off, s_pos = resolve(si, np.zeros(b - a, dtype=np.int64),
                                  has_succ)
    blk[:, _S_INT], blk[:, _S_OFF] = s_int, s_off
    blk[:, _S_LO], blk[:, _S_HI] = _limbs(s_pos)
    p_run = np.maximum(pi, 0)
    p_int, p_off, p_pos = resolve(p_run, length[p_run] - 1, has_pred)
    blk[:, _P_INT], blk[:, _P_OFF] = p_int, p_off
    blk[:, _P_LO], blk[:, _P_HI] = _limbs(p_pos)
    return blk


def wide_rows_host_slice(index: ColPmlIndex, lo: int, hi: int) -> np.ndarray:
    """Global rows [lo, hi) of the ((sigma+1)*r, 16) wide mega table
    (callers may request hi beyond the last real row; the excess is the ip
    padding and stays zero), assembled per intersecting char block — host
    peak O(hi-lo), the building block of the sharded-wide placement
    (parallel/query_sharded_mega_wide.shard_mega_wide)."""
    _check_wide_buildable(index)
    r = index.r
    rows = (index.sigma + 1) * r
    out = np.zeros((hi - lo, _WIDTH), dtype=np.int32)
    g = lo
    while g < min(hi, rows):
        c, i = divmod(g, r)
        take = min(hi, (c + 1) * r, rows) - g
        out[g - lo:g - lo + take] = _host_block_rows(index, c, i, i + take)
        g += take
    return out  # rows >= (sigma+1)*r stay zero (ip padding)


def build_mega_rows_wide_host(index: ColPmlIndex) -> np.ndarray:
    """Host-side ((sigma+1)*r, 16) wide mega rows — the differential oracle
    for the on-device builder and the per-slice assembler."""
    _check_wide_buildable(index)
    return wide_rows_host_slice(index, 0, (index.sigma + 1) * index.r)


def initial_state_wide(mt: dict, batch: int):
    """Query start state (include/col_bwt.hpp:503-507): bottom of the BWT,
    pos = n-1 as limbs."""
    B = batch
    r = mt["r"]
    return (jnp.broadcast_to(r - 1, (B,)).astype(jnp.int32),
            jnp.broadcast_to(mt["last_len"] - 1, (B,)).astype(jnp.int32),
            jnp.broadcast_to(mt["pos0_lo"], (B,)).astype(jnp.int32),
            jnp.broadcast_to(mt["pos0_hi"], (B,)).astype(jnp.int32),
            jnp.zeros((B,), dtype=jnp.int32))


def _lt(a_hi, a_lo, b_hi, b_lo):
    """(a_hi, a_lo) < (b_hi, b_lo) lexicographic — value order for limbs."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


@functools.partial(jax.jit, static_argnames=("unroll", "ff_bound", "masked",
                                             "packed_out", "fresh_state"))
def query_chunk_mega_wide(mt: dict, patterns: jnp.ndarray,
                          lengths: jnp.ndarray, state,
                          step_offset: jnp.ndarray, unroll: int = 4,
                          ff_bound: int = 2, masked: bool = True,
                          packed_out: bool = False,
                          fresh_state: bool = False):
    """One chunk of the backward scan, carried state, limb positions.
    Mirrors ops.query_mega.query_chunk_mega exactly apart from the limb
    arithmetic; see that docstring for masked/ff_bound semantics.  Handles
    both table layouts: full (one 17-column gather per step) and compact
    (a shared 8-column gather + a per-char 10-column gather).

    packed_out returns ((pml << 8 | cid, None), final) — one output plane
    instead of two; it downcasts to uint16 only when fresh_state (caller
    asserts mlen0 == 0) and M <= 255 make pml < 256 provable, an 8x
    device->host byte saving for the one-shot/streaming drivers.
    patterns may be uint8 (slim uploads)."""
    B, M = patterns.shape
    r = mt["r"]
    compact = "shared" in mt
    length_arr = mt["length"]
    n_lo, n_hi = mt["n_lo"], mt["n_hi"]

    cols = patterns[:, ::-1].T.astype(jnp.int32)
    steps = jnp.arange(M, dtype=jnp.int32) + step_offset

    def body(state, xs):
        interval, offset, pos_lo, pos_hi, mlen = state
        c, i = xs
        valid = i < lengths

        if compact:
            sh = jnp.take(mt["shared"], interval, axis=0, mode="clip")
            pc = jnp.take(mt["percha"], c * r + interval, axis=0, mode="clip")
            match = sh[:, _SH_CHAR] == c
            cid_out = sh[:, _SH_CID]
            di0, doff0 = sh[:, _SH_DI0], sh[:, _SH_DOFF0]
            lf_lo_b, lf_hi_b = sh[:, _SH_LF_LO], sh[:, _SH_LF_HI]
            dlen0 = sh[:, _SH_DLEN0]
            thr_lo, thr_hi = pc[:, _PC_THR_LO], pc[:, _PC_THR_HI]
            s_int, s_off = pc[:, _PC_S_INT], pc[:, _PC_S_OFF]
            s_lo, s_hi = pc[:, _PC_S_LO], pc[:, _PC_S_HI]
            p_int, p_off = pc[:, _PC_P_INT], pc[:, _PC_P_OFF]
            p_lo, p_hi = pc[:, _PC_P_LO], pc[:, _PC_P_HI]
        else:
            rows = jnp.take(mt["mega"], c * r + interval, axis=0,
                            mode="clip")  # 1 gather of one 64 B row
            mc = rows[:, _MC]
            match = (mc >> 8) == 1
            cid_out = mc & 0xFF
            di0, doff0 = rows[:, _DI0], rows[:, _DOFF0]
            lf_lo_b, lf_hi_b = rows[:, _LF_LO], rows[:, _LF_HI]
            dlen0 = rows[:, _DLEN0]
            thr_lo, thr_hi = rows[:, _THR_LO], rows[:, _THR_HI]
            s_int, s_off = rows[:, _S_INT], rows[:, _S_OFF]
            s_lo, s_hi = rows[:, _S_LO], rows[:, _S_HI]
            p_int, p_off = rows[:, _P_INT], rows[:, _P_OFF]
            p_lo, p_hi = rows[:, _P_LO], rows[:, _P_HI]

        # match / no-reposition path: LF + fast-forward
        doff = doff0 + offset
        lf_lo = lf_lo_b + offset
        carry = (lf_lo >= LIMB).astype(jnp.int32)
        lf_lo = lf_lo - carry * LIMB
        lf_hi = lf_hi_b + carry
        over = doff >= dlen0
        di = di0 + over.astype(jnp.int32)
        doff = doff - jnp.where(over, dlen0, 0)
        for _ in range(ff_bound - 2):
            ln = jnp.take(length_arr, di, mode="clip")
            over = doff >= ln
            di = di + over.astype(jnp.int32)
            doff = doff - jnp.where(over, ln, 0)

        # threshold_step (include/col_bwt.hpp:531-574): pred if pos < thr and
        # one exists; else succ if one exists (thr == n encodes "none")
        use_pred = _lt(pos_hi, pos_lo, thr_hi, thr_lo)
        has_pred = p_int >= 0
        has_succ = _lt(thr_hi, thr_lo, n_hi, n_lo)
        take_pred = (~match) & use_pred & has_pred
        take_succ = (~match) & (~take_pred) & has_succ

        new_interval = jnp.where(take_pred, p_int,
                                 jnp.where(take_succ, s_int, di))
        new_offset = jnp.where(take_pred, p_off,
                               jnp.where(take_succ, s_off, doff))
        new_lo = jnp.where(take_pred, p_lo,
                           jnp.where(take_succ, s_lo, lf_lo))
        new_hi = jnp.where(take_pred, p_hi,
                           jnp.where(take_succ, s_hi, lf_hi))
        new_len = jnp.where(match, mlen + 1, 0)

        if packed_out:
            out = ((new_len << 8) | cid_out,)
        else:
            out = (new_len, cid_out)
        if not masked:
            return ((new_interval, new_offset, new_lo, new_hi, new_len), out)
        interval = jnp.where(valid, new_interval, interval)
        offset = jnp.where(valid, new_offset, offset)
        pos_lo = jnp.where(valid, new_lo, pos_lo)
        pos_hi = jnp.where(valid, new_hi, pos_hi)
        mlen = jnp.where(valid, new_len, mlen)
        return ((interval, offset, pos_lo, pos_hi, mlen),
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
def query_batch_mega_wide(mt: dict, patterns: jnp.ndarray,
                          lengths: jnp.ndarray, unroll: int = 4,
                          ff_bound: int = 2, packed_out: bool = False
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    (pml, cid), _ = query_chunk_mega_wide(
        mt, patterns, lengths, initial_state_wide(mt, patterns.shape[0]),
        jnp.int32(0), unroll=unroll, ff_bound=ff_bound, masked=False,
        packed_out=packed_out, fresh_state=True)
    return pml, cid


def query_long_reads(index: ColPmlIndex, patterns: list[bytes],
                     chunk: int = 2048, mt: dict | None = None
                     ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Chunked state-carrying scans for arbitrary-length reads (wide)."""
    if mt is None:
        mt = build_mega_table_wide(index)
    B = len(patterns)
    max_m = max((len(p) for p in patterns), default=1)
    n_chunks = max(1, -(-max_m // chunk))
    M = n_chunks * chunk
    enc, lens = index.encode_patterns(patterns, max_len=M)
    enc_j = jnp.asarray(enc.astype(np.uint8))
    lens_j = jnp.asarray(lens)

    pml_full = np.zeros((B, M), dtype=np.int32)
    cid_full = np.zeros((B, M), dtype=np.int32)
    state = initial_state_wide(mt, B)
    # packed int32 plane halves the download bytes of two planes, but the
    # pml << 8 packing overflows int32 once a match length reaches 2**23 —
    # contig-length reads fall back to exact two-plane outputs
    packed = (M < (1 << 23)
              and int(index.col_id.max(initial=0)) <= 0xFF)
    for j in range(n_chunks):
        lo = M - (j + 1) * chunk
        cols = enc_j[:, lo:lo + chunk]
        out, state = query_chunk_mega_wide(
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
        mt = build_mega_table_wide(index)
    enc, lens = index.encode_patterns(patterns, max_len)
    pml, cid = query_batch_mega_wide(mt, jnp.asarray(enc), jnp.asarray(lens),
                                     ff_bound=index.ff_bound)
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])
