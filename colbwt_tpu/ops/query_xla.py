"""Batched PML+CID query engine — pure XLA (jit + lax.scan).

Reproduces col_pml::_query_pml (include/col_bwt.hpp:498-529) exactly, but
data-parallel over a batch of reads: thousands of reads advance in lockstep,
one backward character step per scan iteration, with every table access a
(B,)-shaped gather into the structure-of-arrays index (SURVEY §5.7/§7).

The sequential dependence is along the read (each step consumes the previous
LF state), so the scan axis is the character position and the vector axis is
the batch.  Per step and lane:

  c       = pattern[b, M-1-i]                     (dense char id)
  cid_out = col_id[interval]                      (sampled BEFORE the step,
                                                   include/col_bwt.hpp:513)
  match   = char[interval] == c -> length += 1
  else    : length = 0; threshold reposition      (include/col_bwt.hpp:531-574)
            succ = succ_jump[c, interval]; thr = threshold[succ] (or n)
            pred = pred_jump[c, interval]
            pos < thr and pred exists -> bottom of pred run, else top of succ
  LF      : pos' = idx[dest] + dest_offset + offset; fast-forward over runs
            (include/ds/LF_table.hpp:251-268)

The LF fast-forward is a batched while_loop that runs until every lane has
landed (move-structure locality keeps the trip count tiny; a build-time
Movi-style run-splitting bound is applied by ops.run_split).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from colbwt_tpu.models.index import ColPmlIndex


def index_device_arrays(index: ColPmlIndex) -> dict[str, jnp.ndarray]:
    """The index fields as a dict of int32 device arrays (jit-friendly)."""
    if index.wide:
        raise ValueError("n >= 2**31: this engine's int32 positions would "
                         "overflow — use ops.query_mega_wide")
    return {
        "char": jnp.asarray(index.char, dtype=jnp.int32),
        "idx": jnp.asarray(index.idx, dtype=jnp.int32),
        "length": jnp.asarray(index.length, dtype=jnp.int32),
        "dest_interval": jnp.asarray(index.dest_interval, dtype=jnp.int32),
        "dest_offset": jnp.asarray(index.dest_offset, dtype=jnp.int32),
        "col_id": jnp.asarray(index.col_id, dtype=jnp.int32),
        "threshold": jnp.asarray(index.threshold, dtype=jnp.int32),
        "pred_jump": jnp.asarray(index.pred_jump, dtype=jnp.int32),
        "succ_jump": jnp.asarray(index.succ_jump, dtype=jnp.int32),
        "n": jnp.int32(index.n),
        "r": jnp.int32(index.r),
    }


def _gather(arr, i):
    return jnp.take(arr, i, axis=0, mode="clip")


def lf_fast_forward(length: jnp.ndarray, di: jnp.ndarray, doff: jnp.ndarray
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched dynamic run fast-forward (include/ds/LF_table.hpp:256-259):
    while_loop until every lane lands — correct for any (unsplit) table.
    Split tables use the statically unrolled path in query_step instead
    (no dynamic control flow, so it compiles much faster)."""

    def cond(state):
        di, doff = state
        return jnp.any(doff >= _gather(length, di))

    def body(state):
        di, doff = state
        ln = _gather(length, di)
        over = doff >= ln
        return (di + over.astype(jnp.int32),
                doff - jnp.where(over, ln, 0))

    return jax.lax.while_loop(cond, body, (di, doff))


def _gather_jump(tb, which: str, c, interval):
    flat = c * tb[which].shape[1] + interval
    return jnp.take(tb[which].reshape(-1), flat, mode="clip")


def query_step(tb: dict[str, jnp.ndarray], state, c: jnp.ndarray,
               valid: jnp.ndarray, ff_bound: int = 0,
               gather=None, gather_jump=None):
    """One backward character step for the whole batch.

    state = (interval, offset, pos, length), all (B,) int32.
    Returns (new_state, (pml_out, cid_out)).

    `gather(field_name, indices)` / `gather_jump(which, c, interval)` abstract
    the table access so the interval-sharded engine (parallel.query_sharded)
    can substitute masked-gather + psum collectives while reusing these exact
    recurrence semantics.
    """
    interval, offset, pos, length = state
    r = tb["r"]
    n = tb["n"]
    if gather is None:
        gather = lambda name, i: _gather(tb[name], i)  # noqa: E731
    if gather_jump is None:
        gather_jump = lambda which, cc, ii: _gather_jump(tb, which, cc, ii)  # noqa: E731

    cid_out = gather("col_id", interval)
    run_char = gather("char", interval)
    match = run_char == c

    # threshold repositioning (computed for every lane, selected on mismatch)
    si = gather_jump("succ_jump", c, interval)
    pi = gather_jump("pred_jump", c, interval)
    has_succ = si < r
    has_pred = pi >= 0
    thr = jnp.where(has_succ, gather("threshold", si), n)
    use_pred = (pos < thr) & has_pred
    # no succ and no pred -> keep current (reference keeps state unchanged)
    ti = jnp.where(use_pred, pi, jnp.where(has_succ, si, interval))
    toff = jnp.where(use_pred, gather("length", pi) - 1,
                     jnp.where(has_succ, jnp.zeros_like(offset), offset))

    new_interval = jnp.where(match, interval, ti)
    new_offset = jnp.where(match, offset, toff)
    new_length = jnp.where(match, length + 1, 0)

    # LF step (include/ds/LF_table.hpp:251-268)
    di = gather("dest_interval", new_interval)
    doff = gather("dest_offset", new_interval) + new_offset
    new_pos = gather("idx", di) + doff
    if ff_bound > 0:
        for _ in range(ff_bound - 1):
            ln = gather("length", di)
            over = doff >= ln
            di = di + over.astype(jnp.int32)
            doff = doff - jnp.where(over, ln, 0)
    else:
        di, doff = lf_fast_forward(tb["length"], di, doff)

    # frozen lanes (padding) keep their state
    interval = jnp.where(valid, di, interval)
    offset = jnp.where(valid, doff, offset)
    pos = jnp.where(valid, new_pos, pos)
    length = jnp.where(valid, new_length, length)
    pml_out = jnp.where(valid, new_length, 0)
    cid_out = jnp.where(valid, cid_out, 0)
    return (interval, offset, pos, length), (pml_out, cid_out)


@functools.partial(jax.jit, static_argnames=("unroll", "ff_bound"))
def query_batch_device(tb: dict[str, jnp.ndarray], patterns: jnp.ndarray,
                       lengths: jnp.ndarray, unroll: int = 1,
                       ff_bound: int = 0
                       ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Run the full backward scan for a (B, M) right-aligned batch.

    Returns (pml, cid), each (B, M) int32 aligned with `patterns` (column
    M-1-i holds the value for pattern position m-1-i; left-pad columns are 0).
    """
    B, M = patterns.shape
    r = tb["r"]
    n = tb["n"]

    interval0 = jnp.broadcast_to(r - 1, (B,)).astype(jnp.int32)
    offset0 = jnp.broadcast_to(_gather(tb["length"], r - 1) - 1, (B,)).astype(jnp.int32)
    pos0 = jnp.broadcast_to(n - 1, (B,)).astype(jnp.int32)
    length0 = jnp.zeros((B,), dtype=jnp.int32)

    cols = patterns[:, ::-1].T  # (M, B): step i reads column M-1-i
    steps = jnp.arange(M, dtype=jnp.int32)

    def body(state, xs):
        c, i = xs
        valid = i < lengths  # right-aligned: step i valid while i < m
        return query_step(tb, state, c, valid, ff_bound)

    _, (pml_steps, cid_steps) = jax.lax.scan(
        body, (interval0, offset0, pos0, length0), (cols, steps), unroll=unroll)
    # step i wrote pattern column M-1-i
    pml = pml_steps.T[:, ::-1]
    cid = cid_steps.T[:, ::-1]
    return pml, cid


def query_batch(index: ColPmlIndex, patterns: list[bytes],
                max_len: int | None = None, ff_bound: int | None = None
                ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """Convenience host API: encode, run on device, unpad.

    ff_bound defaults to the index's recorded bound (0 = unbounded table,
    dynamic while_loop)."""
    tb = index_device_arrays(index)
    enc, lens = index.encode_patterns(patterns, max_len)
    k = index.ff_bound if ff_bound is None else ff_bound
    pml, cid = query_batch_device(tb, jnp.asarray(enc), jnp.asarray(lens),
                                  ff_bound=k)
    pml = np.asarray(pml)
    cid = np.asarray(cid)
    M = enc.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(len(patterns))],
            [cid[b, M - int(lens[b]):] for b in range(len(patterns))])
