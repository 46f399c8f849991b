"""Interval-sharded WIDE mega engine: dp×ip mesh, one psum per step, limb
positions — the n >= 2**31 counterpart of parallel.query_sharded_mega.

Why it exists: a wide index's full mega table is 64 B × (sigma+1) × r —
5.8 GB at r = 15.2M and growing linearly in r — so a large enough r
outgrows one device's memory.  Sharding the table rows contiguously
over "ip" bounds the per-device slice at table/ip while reads stay sharded
over "dp"; each step every shard answers the batch's row fetch from its
block with a masked local gather and ONE psum over "ip" assembles the
(B, 16) int32 rows (B × 64 bytes of collective traffic per step).

The recurrence body is identical to ops.query_mega_wide.query_chunk_mega_wide
(full layout): positions travel as two int32 limbs in base 2**30, ordering
tests are (hi, lo) lexicographic.  The scan carries explicit state in/out, so
arbitrary-length reads stream through in fixed chunks (the sharded analog of
query_mega_wide.query_long_reads).  Differential-tested against the int64
NumPy oracle on forced-wide indexes over the virtual CPU mesh
(tests/test_parallel.py) and exercised by dryrun_multichip.

Reference semantics: col_pml::_query_pml + threshold_step
(include/col_bwt.hpp:498-574); the reference itself has no distribution
(SURVEY §2.3) — this layer is new design.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import query_mega_wide as QW
from colbwt_tpu.parallel.mesh import make_mesh

LIMB = QW.LIMB


def shard_mega_wide(index: ColPmlIndex, mesh: Mesh,
                    mega_host: np.ndarray | None = None) -> dict:
    """Place the wide mega rows on the mesh, ip-sharded over rows.

    By default each device's slice is assembled on demand from the r-sized
    per-run arrays (QW.wide_rows_host_slice) — host peak is O(table/ip),
    never the full O((sigma+1)*r*16) table (5.8 GB at r = 15.2M), which
    would move the one-device memory limit to the host.  Passing
    mega_host places a prebuilt table instead (differential tests)."""
    ip = mesh.shape["ip"]
    rows = (index.sigma + 1) * index.r
    if mega_host is not None:
        assert mega_host.shape[0] == rows
    rows_padded = rows + ((-rows) % ip)
    sharding = NamedSharding(mesh, P("ip", None))

    def _slice(idx):
        sl = idx[0]
        lo = sl.start or 0
        hi = sl.stop if sl.stop is not None else rows_padded
        if mega_host is not None:
            out = np.zeros((hi - lo, mega_host.shape[1]), mega_host.dtype)
            take = max(0, min(hi, rows) - lo)
            out[:take] = mega_host[lo:lo + take]
            return out
        return QW.wide_rows_host_slice(index, lo, hi)

    mega = jax.make_array_from_callback(
        (rows_padded, QW._WIDTH), sharding, _slice)
    n = index.n
    p0 = n - 1
    return {
        "mega": mega,
        # run lengths replicated (4 B/run) for fast-forward rounds beyond
        # the precomputed first one
        "length": jax.device_put(index.length.astype(np.int32),
                                 NamedSharding(mesh, P())),
        "rows_padded": mega.shape[0],
        "n_lo": int(n % LIMB), "n_hi": int(n // LIMB),
        "pos0_lo": int(p0 % LIMB), "pos0_hi": int(p0 // LIMB),
        "r": int(index.r),
        "last_len": int(index.length[index.r - 1]),
        "mesh": mesh,
    }


def initial_state_sharded(st: dict, batch: int, mesh: Mesh):
    """(interval, offset, pos_lo, pos_hi, mlen), dp-sharded over the batch."""
    B = batch
    sh = NamedSharding(mesh, P("dp"))

    def full(v):
        return jax.device_put(np.full(B, v, dtype=np.int32), sh)

    return (full(st["r"] - 1), full(st["last_len"] - 1),
            full(st["pos0_lo"]), full(st["pos0_hi"]), full(0))


@functools.partial(jax.jit, static_argnames=(
    "mesh", "rows_local", "n_lo", "n_hi", "r", "ff_bound"))
def _sharded_mega_wide_chunk(mesh: Mesh, mega: jnp.ndarray,
                             length_rep: jnp.ndarray, patterns: jnp.ndarray,
                             lengths: jnp.ndarray, state,
                             step_offset: jnp.ndarray, rows_local: int,
                             n_lo: int, n_hi: int, r: int,
                             ff_bound: int = 2):
    """One chunk of the sharded backward scan with carried dp-sharded state;
    processed columns are masked once a lane's read is exhausted (step index
    i >= lengths), exactly as query_chunk_mega_wide(masked=True)."""

    def shard_fn(mega_local, length_arr, pats, lens, interval, offset,
                 pos_lo, pos_hi, mlen, step0):
        B, M = pats.shape
        ip_idx = jax.lax.axis_index("ip").astype(jnp.int32)
        block_start = ip_idx * rows_local

        def fetch_rows(g):
            j = g - block_start
            ok = (j >= 0) & (j < rows_local)
            rows = jnp.take(mega_local, jnp.clip(j, 0, rows_local - 1),
                            axis=0)
            return jax.lax.psum(jnp.where(ok[:, None], rows, 0), "ip")

        cols = pats[:, ::-1].T
        steps = jnp.arange(M, dtype=jnp.int32) + step0

        def body(state, xs):
            interval, offset, pos_lo, pos_hi, mlen = state
            c, i = xs
            valid = i < lens
            rows = fetch_rows(c * r + interval)  # the ONE collective fetch
            mc = rows[:, QW._MC]
            match = (mc >> 8) == 1
            cid_out = mc & 0xFF

            # match / no-reposition path: LF with carry + fast-forward
            doff = rows[:, QW._DOFF0] + offset
            lf_lo = rows[:, QW._LF_LO] + offset
            carry = (lf_lo >= LIMB).astype(jnp.int32)
            lf_lo = lf_lo - carry * LIMB
            lf_hi = rows[:, QW._LF_HI] + carry
            over = doff >= rows[:, QW._DLEN0]
            di = rows[:, QW._DI0] + over.astype(jnp.int32)
            doff = doff - jnp.where(over, rows[:, QW._DLEN0], 0)
            for _ in range(ff_bound - 2):
                ln = jnp.take(length_arr, di, mode="clip")
                over = doff >= ln
                di = di + over.astype(jnp.int32)
                doff = doff - jnp.where(over, ln, 0)

            # threshold_step (include/col_bwt.hpp:531-574), limb compares
            thr_lo, thr_hi = rows[:, QW._THR_LO], rows[:, QW._THR_HI]
            use_pred = QW._lt(pos_hi, pos_lo, thr_hi, thr_lo)
            has_pred = rows[:, QW._P_INT] >= 0
            has_succ = QW._lt(thr_hi, thr_lo, n_hi, n_lo)
            take_pred = (~match) & use_pred & has_pred
            take_succ = (~match) & (~take_pred) & has_succ

            ni = jnp.where(take_pred, rows[:, QW._P_INT],
                           jnp.where(take_succ, rows[:, QW._S_INT], di))
            no = jnp.where(take_pred, rows[:, QW._P_OFF],
                           jnp.where(take_succ, rows[:, QW._S_OFF], doff))
            nlo = jnp.where(take_pred, rows[:, QW._P_LO],
                            jnp.where(take_succ, rows[:, QW._S_LO], lf_lo))
            nhi = jnp.where(take_pred, rows[:, QW._P_HI],
                            jnp.where(take_succ, rows[:, QW._S_HI], lf_hi))
            nlen = jnp.where(match, mlen + 1, 0)
            state = (jnp.where(valid, ni, interval),
                     jnp.where(valid, no, offset),
                     jnp.where(valid, nlo, pos_lo),
                     jnp.where(valid, nhi, pos_hi),
                     jnp.where(valid, nlen, mlen))
            return state, (jnp.where(valid, nlen, 0),
                           jnp.where(valid, cid_out, 0))

        final, (pml_steps, cid_steps) = jax.lax.scan(
            body, (interval, offset, pos_lo, pos_hi, mlen), (cols, steps))
        return (pml_steps.T[:, ::-1], cid_steps.T[:, ::-1]) + final

    out = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("ip", None), P(), P("dp", None), P("dp"),
                  P("dp"), P("dp"), P("dp"), P("dp"), P("dp"), P()),
        out_specs=(P("dp", None), P("dp", None),
                   P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
        check_vma=False,
    )(mega, length_rep, patterns, lengths, *state, step_offset)
    return (out[0], out[1]), out[2:]


def _pad_batch(index: ColPmlIndex, patterns: list[bytes], dpn: int,
               max_len: int | None):
    enc, lens = index.encode_patterns(patterns, max_len)
    B = enc.shape[0]
    pad = (-B) % dpn
    if pad:
        enc = np.concatenate([enc, np.zeros((pad, enc.shape[1]), enc.dtype)])
        lens = np.concatenate([lens, np.zeros((pad,), lens.dtype)])
    return enc, lens


def query_batch_sharded_mega_wide(index: ColPmlIndex, patterns: list[bytes],
                                  mesh: Mesh | None = None,
                                  dp: int | None = None, ip: int = 1,
                                  max_len: int | None = None,
                                  st: dict | None = None
                                  ) -> tuple[list[np.ndarray],
                                             list[np.ndarray]]:
    if mesh is None:
        dp = dp or len(jax.devices()) // ip
        mesh = make_mesh(dp, ip)
    st = st or shard_mega_wide(index, mesh)
    dpn = mesh.shape["dp"]

    enc, lens = _pad_batch(index, patterns, dpn, max_len)
    sh_mat = NamedSharding(mesh, P("dp", None))
    ps = jax.device_put(enc, sh_mat)
    ls = jax.device_put(lens, NamedSharding(mesh, P("dp")))

    rows_local = st["rows_padded"] // mesh.shape["ip"]
    state = initial_state_sharded(st, enc.shape[0], mesh)
    (pml, cid), _ = _sharded_mega_wide_chunk(
        mesh, st["mega"], st["length"], ps, ls, state, jnp.int32(0),
        rows_local, st["n_lo"], st["n_hi"], st["r"],
        ff_bound=index.ff_bound)
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])


def query_long_reads_sharded_mega_wide(index: ColPmlIndex,
                                       patterns: list[bytes],
                                       mesh: Mesh | None = None,
                                       dp: int | None = None, ip: int = 1,
                                       chunk: int = 2048,
                                       st: dict | None = None
                                       ) -> tuple[list[np.ndarray],
                                                  list[np.ndarray]]:
    """Arbitrary-length reads in fixed chunks with dp-sharded carried state
    (the -l mode, src/pml_query.cpp:126-128, distributed)."""
    if mesh is None:
        dp = dp or len(jax.devices()) // ip
        mesh = make_mesh(dp, ip)
    st = st or shard_mega_wide(index, mesh)
    dpn = mesh.shape["dp"]

    max_m = max((len(p) for p in patterns), default=1)
    n_chunks = max(1, -(-max_m // chunk))
    M = n_chunks * chunk
    enc, lens = _pad_batch(index, patterns, dpn, M)
    B = enc.shape[0]
    sh_mat = NamedSharding(mesh, P("dp", None))
    ls = jax.device_put(lens, NamedSharding(mesh, P("dp")))

    rows_local = st["rows_padded"] // mesh.shape["ip"]
    state = initial_state_sharded(st, B, mesh)
    pml_full = np.zeros((B, M), dtype=np.int32)
    cid_full = np.zeros((B, M), dtype=np.int32)
    for j in range(n_chunks):
        lo = M - (j + 1) * chunk
        cols = jax.device_put(np.ascontiguousarray(enc[:, lo:lo + chunk]),
                              sh_mat)
        (pml, cid), state = _sharded_mega_wide_chunk(
            mesh, st["mega"], st["length"], cols, ls, state,
            jnp.int32(j * chunk), rows_local, st["n_lo"], st["n_hi"],
            st["r"], ff_bound=index.ff_bound)
        pml_full[:, lo:lo + chunk] = np.asarray(pml)
        cid_full[:, lo:lo + chunk] = np.asarray(cid)
    return ([pml_full[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid_full[b, M - int(lens[b]):] for b in range(len(patterns))])
