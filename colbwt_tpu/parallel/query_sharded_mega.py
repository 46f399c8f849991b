"""Interval-sharded mega engine: dp×ip mesh, ONE psum per character step.

The mega table ((sigma+1)*r × 16, ops.query_mega) shards in contiguous row
blocks over "ip"; each step every shard answers the batch's row fetch from its
block (masked gather) and one psum over "ip" assembles the (B, 16) rows.
Per-step collective traffic: B × 64 bytes — an order of magnitude less than the
per-field sharded baseline (parallel.query_sharded), because the mega layout
already collapsed the recurrence to one row fetch per step.

Recurrence body is identical to ops.query_mega.query_chunk_mega (differential
tested); reads shard over "dp" and never communicate.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import query_mega
from colbwt_tpu.parallel.mesh import make_mesh


def shard_mega(index: ColPmlIndex, mesh: Mesh, mt: dict | None = None) -> dict:
    """Pad the mega table to an ip multiple and place it on the mesh."""
    mt = mt or query_mega.build_mega_table(index)
    mega = np.asarray(mt["mega"])
    ip = mesh.shape["ip"]
    rows = mega.shape[0]
    pad = (-rows) % ip
    if pad:
        mega = np.concatenate(
            [mega, np.zeros((pad, mega.shape[1]), mega.dtype)])
    return {
        "mega": jax.device_put(mega, NamedSharding(mesh, P("ip", None))),
        # run lengths replicated (4 B/run) for fast-forward rounds beyond the
        # precomputed first one
        "length": jax.device_put(np.asarray(mt["length"]),
                                 NamedSharding(mesh, P())),
        "rows_padded": mega.shape[0],
        "n": int(mt["n"]),
        "r": int(mt["r"]),
        "last_len": int(mt["last_len"]),
    }


@functools.partial(jax.jit, static_argnames=("mesh", "rows_local", "n", "r",
                                             "last_len", "ff_bound"))
def _sharded_mega_query(mesh: Mesh, mega: jnp.ndarray, length_rep: jnp.ndarray,
                        patterns: jnp.ndarray,
                        lengths: jnp.ndarray, rows_local: int, n: int, r: int,
                        last_len: int, ff_bound: int = 2):
    def shard_fn(mega_local, length_arr, pats, lens):
        B, M = pats.shape
        ip_idx = jax.lax.axis_index("ip").astype(jnp.int32)
        block_start = ip_idx * rows_local

        def fetch_rows(g):
            j = g - block_start
            ok = (j >= 0) & (j < rows_local)
            rows = jnp.take(mega_local, jnp.clip(j, 0, rows_local - 1), axis=0)
            return jax.lax.psum(jnp.where(ok[:, None], rows, 0), "ip")

        interval = jnp.broadcast_to(jnp.int32(r - 1), (B,))
        offset = jnp.broadcast_to(jnp.int32(last_len - 1), (B,))
        pos = jnp.broadcast_to(jnp.int32(n - 1), (B,))
        mlen = jnp.zeros((B,), dtype=jnp.int32)

        cols = pats[:, ::-1].T
        steps = jnp.arange(M, dtype=jnp.int32)

        def body(state, xs):
            interval, offset, pos, mlen = state
            c, i = xs
            valid = i < lens
            rows = fetch_rows(c * r + interval)     # the ONE collective fetch
            match = rows[:, 0] == 1
            cid_out = rows[:, 1]
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
            # reposition priority (threshold_step, include/col_bwt.hpp:531-574)
            thr = rows[:, 6]
            use_pred = pos < thr
            has_pred = rows[:, 10] >= 0
            has_succ = thr < n
            take_pred = (~match) & use_pred & has_pred
            take_succ = (~match) & (~take_pred) & has_succ
            ni = jnp.where(take_pred, rows[:, 10],
                           jnp.where(take_succ, rows[:, 7], di))
            no = jnp.where(take_pred, rows[:, 11],
                           jnp.where(take_succ, rows[:, 8], doff))
            npos = jnp.where(take_pred, rows[:, 12],
                             jnp.where(take_succ, rows[:, 9], lf_pos))
            nlen = jnp.where(match, mlen + 1, 0)
            state = (jnp.where(valid, ni, interval),
                     jnp.where(valid, no, offset),
                     jnp.where(valid, npos, pos),
                     jnp.where(valid, nlen, mlen))
            return state, (jnp.where(valid, nlen, 0),
                           jnp.where(valid, cid_out, 0))

        _, (pml_steps, cid_steps) = jax.lax.scan(
            body, (interval, offset, pos, mlen), (cols, steps))
        return pml_steps.T[:, ::-1], cid_steps.T[:, ::-1]

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("ip", None), P(), P("dp", None), P("dp")),
        out_specs=(P("dp", None), P("dp", None)),
        check_vma=False,
    )(mega, length_rep, patterns, lengths)


def query_batch_sharded_mega(index: ColPmlIndex, patterns: list[bytes],
                             mesh: Mesh | None = None, dp: int | None = None,
                             ip: int = 1, max_len: int | None = None,
                             st: dict | None = None
                             ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    if mesh is None:
        dp = dp or len(jax.devices()) // ip
        mesh = make_mesh(dp, ip)
    st = st or shard_mega(index, mesh)
    dpn = mesh.shape["dp"]

    enc, lens = index.encode_patterns(patterns, max_len)
    B = enc.shape[0]
    pad = (-B) % dpn
    if pad:
        enc = np.concatenate([enc, np.zeros((pad, enc.shape[1]), enc.dtype)])
        lens = np.concatenate([lens, np.zeros((pad,), lens.dtype)])
    ps = jax.device_put(enc, NamedSharding(mesh, P("dp", None)))
    ls = jax.device_put(lens, NamedSharding(mesh, P("dp")))

    rows_local = st["rows_padded"] // mesh.shape["ip"]
    pml, cid = _sharded_mega_query(mesh, st["mega"], st["length"], ps, ls,
                                   rows_local, st["n"], st["r"],
                                   st["last_len"], ff_bound=index.ff_bound)
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(B)],
            [cid[b, M - int(lens[b]):] for b in range(B)])
