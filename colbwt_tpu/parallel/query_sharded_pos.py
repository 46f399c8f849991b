"""Position-sharded positional-automaton engine: dp×ip mesh, one psum per
k characters.

The pos tables (ops.query_pos) are the fastest engine but cost
(sigma+1)**k · n · 8 bytes — beyond one device's memory for larger collections
(e.g. k=2 at n = 40 Mbp is ~11.5 GB).  Here the (A^k, n, 2) table shards in
contiguous POSITION blocks over "ip": each shard answers the batch's row
fetch from its block (masked gather) and one psum over "ip" assembles the
(B, 2) rows.  Per-step collective traffic is B × 8 bytes per k characters — 8k×
less than the sharded mega engine's B × 64 per character.

Sharding also relaxes the int32 gather-index constraint: each shard indexes
key · n_local + local_pos, so A^k · n/ip < 2**31 suffices (ip× larger n).

Why psum row assembly and not all_to_all state migration: LF destinations
are effectively random, so nearly every read migrates every step; exact
fixed-shape all_to_all routing needs per-(src,dst) bucket capacities that
either overflow (dropping reads — unacceptable: results must be exact) or
carry 2× slack, at which point its traffic (≥ 12 B of state per read) loses
to the 8-byte psum row.  The psum design also reuses the local engine's
step body verbatim, so sharded and local semantics cannot drift.

T1 (A · n · 8 bytes) is replicated — it is HBM-cheap (1.9 GB even at
40 Mbp) — and each shard composes its own T_k position block from it
locally: composition gathers T1 at arbitrary positions, which replication
makes collective-free at build time.

Reads shard over "dp" and never communicate.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import query_pos
from colbwt_tpu.parallel.mesh import make_mesh

INT32_MAX = 2**31 - 1


def choose_k_sharded(index: ColPmlIndex, ip: int,
                     hbm_budget_bytes: int = 10 << 30) -> int:
    """Largest k whose PER-SHARD table block fits the budget, whose
    per-shard gather indices fit int32, and whose positions fit 32-k bits
    (T1 stays replicated, so A * n <= 2**31 is also required)."""
    if index.wide or (index.sigma + 1) * index.n > INT32_MAX:
        return 0
    A = index.sigma + 1
    n_local = -(-index.n // ip)
    best = 0
    for k in (1, 2, 3, 4):
        if (A ** k) * n_local > INT32_MAX or index.n > (1 << query_pos.pos_bits(k)):
            break
        if (A ** k) * n_local * 8 > hbm_budget_bytes:
            break
        best = k
    return best


@functools.partial(jax.jit, static_argnames=("mesh", "n", "n_local", "A", "k"))
def _build_sharded_tk(mesh: Mesh, t1: jnp.ndarray, n: int, n_local: int,
                      A: int, k: int):
    """Each shard composes its (A^k · n_local, 2) block from replicated T1.

    Positions >= n (ip padding) get inert self-loop rows (never reachable:
    new_pos < n always, and pos0 = n-1 < n)."""

    t1_mask = query_pos.pos_mask(1)
    pb = query_pos.pos_bits(k)

    def shard_fn(t1_local):
        lo = jax.lax.axis_index("ip").astype(jnp.int32) * n_local

        def body(key, buf):
            digits = []
            rem = key
            for j in range(k):
                p = A ** (k - 1 - j)
                digits.append(rem // p)
                rem = rem % p
            gpos = lo + jax.lax.iota(jnp.int32, n_local)
            in_range = gpos < n
            first = jnp.take(t1_local, digits[0] * n
                             + jnp.minimum(gpos, n - 1), axis=0, mode="clip")
            pos = first[:, 0] & t1_mask
            w0 = ((first[:, 0] >> query_pos.T1_POS_BITS) & 1) << pb
            w1 = first[:, 1]
            for j in range(1, k):
                nxt = jnp.take(t1_local, digits[j] * n + pos, axis=0,
                               mode="clip")
                pos = nxt[:, 0] & t1_mask
                w0 = w0 | (((nxt[:, 0] >> query_pos.T1_POS_BITS) & 1)
                           << (pb + j))
                w1 = w1 | ((nxt[:, 1] & 0xFF) << (8 * j))
            w0 = w0 | pos
            # ip-padding rows (gpos >= n) are inert self-loops, never reached
            w0 = jnp.where(in_range, w0, jnp.minimum(gpos, n - 1))
            w1 = jnp.where(in_range, w1, 0)
            block = jnp.stack([w0, w1], axis=1)
            return jax.lax.dynamic_update_slice(buf, block, (key * n_local, 0))

        buf = jnp.zeros((A ** k * n_local, 2), dtype=jnp.int32)
        return jax.lax.fori_loop(0, A ** k, body, buf)

    return jax.shard_map(shard_fn, mesh=mesh, in_specs=(P(),),
                         out_specs=P("ip", None), check_vma=False)(t1)


def shard_pos_tables(index: ColPmlIndex, mesh: Mesh, k: int | None = None,
                     hbm_budget_bytes: int = 10 << 30) -> dict:
    ip = mesh.shape["ip"]
    if k is None:
        k = choose_k_sharded(index, ip, hbm_budget_bytes)
        if k == 0:
            raise ValueError("no k fits the per-shard HBM budget")
    A = index.sigma + 1
    n = index.n
    n_local = -(-n // ip)
    if index.wide or (A ** k) * n_local > INT32_MAX \
            or n > (1 << query_pos.pos_bits(k)) or A * n > INT32_MAX:
        raise ValueError(
            f"sharded positional tables need A**k * n/ip <= 2**31, "
            f"A * n <= 2**31 (T1 is replicated), and n <= 2**(32-k) "
            f"(A={A}, k={k}, n={n}, ip={ip})")

    C = min(n, query_pos._T1_CHUNK)
    # padded run starts: _build_t1_chunk resolves contiguous-chunk run ids
    # from a C-wide window (see its docstring)
    idx = jnp.asarray(np.concatenate([
        index.idx.astype(np.int32),
        np.full(C + 1, n, dtype=np.int32)]))
    length = jnp.asarray(index.length.astype(np.int32))
    di = index.dest_interval.astype(np.int64)
    lf_pos0 = jnp.asarray((index.idx.astype(np.int64)[di]
                           + index.dest_offset.astype(np.int64)
                           ).astype(np.int32))
    C = min(n, query_pos._T1_CHUNK)
    t1 = jnp.zeros((A * n, 2), dtype=jnp.int32)
    char_j = jnp.asarray(index.char)
    thr_j = jnp.asarray(index.threshold.astype(np.int32))
    cid_j = jnp.asarray(index.col_id)
    for q in range(A):
        pred_row = jnp.asarray(index.pred_jump[q])
        succ_row = jnp.asarray(index.succ_jump[q])
        for s in range(0, n, C):
            s = min(s, n - C)
            t1 = query_pos._build_t1_chunk(
                t1, char_j, idx, length, lf_pos0, thr_j, pred_row, succ_row,
                cid_j, jnp.int32(q), jnp.int32(q * n + s), jnp.int32(s),
                n=n, C=C)
    t1 = jax.device_put(t1, NamedSharding(mesh, P()))  # replicated
    table = _build_sharded_tk(mesh, t1, n=n, n_local=n_local, A=A, k=k)
    return {"table": table, "n": n, "n_local": n_local, "k": k, "A": A}


@functools.partial(jax.jit, static_argnames=("mesh", "n", "n_local", "A", "k"))
def _sharded_pos_query(mesh: Mesh, table, patterns, lengths,
                       n: int, n_local: int, A: int, k: int):
    def shard_fn(table_local, pats, lens):
        B, M = pats.shape
        lo = jax.lax.axis_index("ip").astype(jnp.int32) * n_local

        def fetch(key, pos):
            j = pos - lo
            ok = (j >= 0) & (j < n_local)
            rows = jnp.take(table_local,
                            key * n_local + jnp.clip(j, 0, n_local - 1),
                            axis=0, mode="clip")
            return jax.lax.psum(jnp.where(ok[:, None], rows, 0), "ip")

        cols = pats[:, ::-1].T.astype(jnp.int32)
        keys = query_pos._fold_keys(cols, k, A)
        pos0 = jnp.broadcast_to(jnp.int32(n - 1), (B,))
        mlen0 = jnp.zeros((B,), dtype=jnp.int32)

        pb = query_pos.pos_bits(k)
        mask = query_pos.pos_mask(k)

        def body(state, key_col):
            pos, mlen = state
            rows = fetch(key_col, pos)      # the ONE collective per k chars
            w0 = rows[:, 0]
            w1 = rows[:, 1]
            outs = []
            ln = mlen
            for j in range(k):
                m = (w0 >> (pb + j)) & 1
                ln = (ln + 1) * m
                outs.append((ln << 8) | ((w1 >> (8 * j)) & 0xFF))
            return (w0 & mask, ln), jnp.stack(outs)

        _, ys = jax.lax.scan(body, (pos0, mlen0), keys)
        packed = ys.reshape(M, B).T[:, ::-1]
        return packed >> 8, packed & 0xFF

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("ip", None), P("dp", None), P("dp")),
        out_specs=(P("dp", None), P("dp", None)),
        check_vma=False,
    )(table, patterns, lengths)


def query_batch_sharded_pos(index: ColPmlIndex, patterns: list[bytes],
                            mesh: Mesh | None = None, dp: int | None = None,
                            ip: int = 1, max_len: int | None = None,
                            st: dict | None = None, k: int | None = None
                            ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    if mesh is None:
        dp = dp or len(jax.devices()) // ip
        mesh = make_mesh(dp, ip)
    st = st or shard_pos_tables(index, mesh, k)
    dpn = mesh.shape["dp"]

    m_raw = max_len if max_len is not None else max(
        (len(p) for p in patterns), default=1)
    M = -(-m_raw // st["k"]) * st["k"]
    enc, lens = index.encode_patterns(patterns, max_len=M)
    B = enc.shape[0]
    pad = (-B) % dpn
    if pad:
        enc = np.concatenate([enc, np.zeros((pad, enc.shape[1]), enc.dtype)])
        lens = np.concatenate([lens, np.zeros((pad,), lens.dtype)])
    ps = jax.device_put(enc, NamedSharding(mesh, P("dp", None)))
    ls = jax.device_put(lens, NamedSharding(mesh, P("dp")))

    pml, cid = _sharded_pos_query(mesh, st["table"], ps, ls, n=st["n"],
                                  n_local=st["n_local"], A=st["A"], k=st["k"])
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])
