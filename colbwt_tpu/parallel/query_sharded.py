"""Interval-sharded + data-parallel query engine (shard_map over a dp×ip mesh).

Reads shard over "dp" and never communicate.  The move table shards over "ip"
in contiguous run blocks; every table access becomes

    local = global_row - block_start
    contribution = owner_mask * local_gather
    row = psum(contribution, "ip")          # collective row assembly

The recurrence itself is ops.query_xla.query_step with these gathers injected,
so sharded and single-device engines cannot drift semantically.  With ip == 1
the masks are all-true and XLA elides the psums — the dp-only path costs no
collectives.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops.query_xla import query_step
from colbwt_tpu.parallel.mesh import make_mesh, shard_index, shard_reads

_FIELDS = ("char", "idx", "length", "dest_interval", "dest_offset",
           "col_id", "threshold")


def _local_gathers(tb_local: dict[str, jnp.ndarray], r_local: int):
    """Masked-gather closures for one ip shard."""
    ip_idx = jax.lax.axis_index("ip")
    block_start = ip_idx.astype(jnp.int32) * r_local

    def gather(name: str, g: jnp.ndarray) -> jnp.ndarray:
        j = g - block_start
        ok = (j >= 0) & (j < r_local)
        v = jnp.take(tb_local[name], jnp.clip(j, 0, r_local - 1))
        return jax.lax.psum(jnp.where(ok, v, 0), "ip")

    def gather_jump(which: str, c: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
        j = g - block_start
        ok = (j >= 0) & (j < r_local)
        flat = c * r_local + jnp.clip(j, 0, r_local - 1)
        v = jnp.take(tb_local[which].reshape(-1), flat, mode="clip")
        return jax.lax.psum(jnp.where(ok, v, 0), "ip")

    return gather, gather_jump


@functools.partial(jax.jit,
                   static_argnames=("mesh", "ff_bound", "r_local", "n", "r"))
def _sharded_query(mesh: Mesh, tb_sharded: dict, patterns: jnp.ndarray,
                   lengths: jnp.ndarray, ff_bound: int, r_local: int,
                   n: int, r: int):
    table_specs = {k: (P(None, "ip") if tb_sharded[k].ndim == 2 else P("ip"))
                   for k in tb_sharded}

    def shard_fn(tb_local, pats, lens):
        B, M = pats.shape
        tb = dict(tb_local)
        tb["n"] = jnp.int32(n)
        tb["r"] = jnp.int32(r)
        gather, gather_jump = _local_gathers(tb_local, r_local)

        interval0 = jnp.full((B,), r - 1, dtype=jnp.int32)
        offset0 = jnp.broadcast_to(gather("length", interval0[:1]) - 1, (B,)
                                   ).astype(jnp.int32)
        pos0 = jnp.full((B,), n - 1, dtype=jnp.int32)
        length0 = jnp.zeros((B,), dtype=jnp.int32)

        cols = pats[:, ::-1].T
        steps = jnp.arange(M, dtype=jnp.int32)

        def body(state, xs):
            ccol, i = xs
            valid = i < lens
            return query_step(tb, state, ccol, valid, ff_bound,
                              gather=gather, gather_jump=gather_jump)

        _, (pml_steps, cid_steps) = jax.lax.scan(
            body, (interval0, offset0, pos0, length0), (cols, steps))
        return pml_steps.T[:, ::-1], cid_steps.T[:, ::-1]

    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(table_specs, P("dp", None), P("dp")),
        out_specs=(P("dp", None), P("dp", None)),
        check_vma=False,
    )(tb_sharded, patterns, lengths)


def query_batch_sharded(index: ColPmlIndex, patterns: list[bytes],
                        mesh: Mesh | None = None, dp: int | None = None,
                        ip: int = 1, max_len: int | None = None
                        ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Host API: encode, shard over the mesh, query, unpad.

    Pads the batch up to a dp multiple with empty reads (masked out)."""
    if index.ff_bound < 1:
        raise ValueError(
            "sharded query needs a run-split index (ColPmlIndex.build with "
            "ff_bound >= 1): the dynamic fast-forward would read local-only "
            "run lengths")
    if mesh is None:
        dp = dp or len(jax.devices()) // ip
        mesh = make_mesh(dp, ip)
    dpn = mesh.shape["dp"]

    enc, lens = index.encode_patterns(patterns, max_len)
    B = enc.shape[0]
    pad = (-B) % dpn
    if pad:
        enc = np.concatenate([enc, np.zeros((pad, enc.shape[1]), enc.dtype)])
        lens = np.concatenate([lens, np.zeros((pad,), lens.dtype)])

    tb = shard_index(index, mesh)
    r_local = tb.pop("r_padded") // mesh.shape["ip"]
    n = tb.pop("n")
    r = tb.pop("r")
    ps, ls = shard_reads(enc, lens, mesh)
    k = index.ff_bound
    pml, cid = _sharded_query(mesh, tb, ps, ls, k, r_local, n, r)
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(B)],
            [cid[b, M - int(lens[b]):] for b in range(B)])
