"""Device-side col-split: batched FL walking over all multi-MUMs at once.

The reference walks each MUM's BWT range forward one FL step at a time,
sequentially per MUM (col_split::split, include/col_split.hpp:54-136; the
SURVEY §3.2 hot loop).  The device formulation advances *every* MUM in
lockstep:

- **Tunneled mode** (the O(r + n/d) headline mode): a MUM's range survives
  only while its FL image stays contiguous, so its whole walk is a single
  (position, alive) state per MUM.  Fragmentation of [p, p+N) is detected
  without materializing the range: it fragments iff a run boundary falls
  inside, i.e. interval(p) != interval(p+N-1) — two vectorized searchsorteds.
  Cost per step: O(M log r) gathers, independent of N (so the
  10k-document configs are in reach; the reference pays O(N) per step).

- **All mode**: ranges fragment and persist; we decompose each MUM's N-high
  range into N unit walkers.  A fragment splits between walker d-1 and d
  exactly when walker d's position is a run head, and splits are permanent —
  so a walker is a fragment head iff d == 0 or any of its past positions was
  a run head.  Fragment heights come from O(N) segment arithmetic (a head's
  height is the distance to the next head, via a reverse cummin of head
  indices), so cost per step is O(M·N·log r) for any document count — the
  bucketing budget (area x num_docs) bounds the walk footprint, no N cap.

Mark-merge semantics (collect_ids, include/col_split.hpp:114-127) are
reproduced order-independently: Tunneled keeps the last mark in reference
visit order (MUM position order, then step); All keeps the first mark in
visit order among those of maximal height.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from colbwt_tpu.ops.oracle import FLTableArrays


def fl_device_arrays(fl: FLTableArrays) -> dict[str, jnp.ndarray]:
    return {
        "idx": jnp.asarray(fl.idx, dtype=jnp.int32),
        "dest_interval": jnp.asarray(fl.dest_interval, dtype=jnp.int32),
        "dest_offset": jnp.asarray(fl.dest_offset, dtype=jnp.int32),
    }


def _fl_unit(fd, p):
    """Forward-step rank positions: p -> rank of the next text position.
    Exact position arithmetic — no run fast-forward needed
    (FL preserves idx[dest] + dest_offset + offset, include/ds/FL_table.hpp:227-238)."""
    i = jnp.searchsorted(fd["idx"], p, side="right").astype(jnp.int32) - 1
    di = jnp.take(fd["dest_interval"], i, mode="clip")
    doff = jnp.take(fd["dest_offset"], i, mode="clip")
    return jnp.take(fd["idx"], di, mode="clip") + doff + (p - jnp.take(fd["idx"], i, mode="clip"))


@functools.partial(jax.jit, static_argnames=("num_steps", "rate", "num_docs"))
def _tunneled_walk(fd, p0: jnp.ndarray, lens: jnp.ndarray,
                   num_steps: int, rate: int, num_docs: int):
    """Scan all MUM walkers num_steps forward.

    Returns (mark_pos (T, M), mark_valid (T, M)): step t0 marks position
    p^(t0+1) when the range is still whole, t0 % rate == 0 and t0 < len
    (loop structure of include/col_split.hpp:70-99)."""

    def step(carry, t0):
        p, alive = carry
        i_lo = jnp.searchsorted(fd["idx"], p, side="right")
        i_hi = jnp.searchsorted(fd["idx"], p + num_docs - 1, side="right")
        frag = i_lo != i_hi
        alive = alive & ~frag
        p_next = _fl_unit(fd, p)
        valid = alive & (t0 % rate == 0) & (t0 < lens)
        return (p_next, alive), (p_next, valid)

    (_, _), (pos, valid) = jax.lax.scan(
        step, (p0, jnp.ones_like(p0, dtype=bool)),
        jnp.arange(num_steps, dtype=jnp.int32))
    return pos, valid


@functools.partial(jax.jit, static_argnames=("num_steps", "rate", "num_docs"))
def _all_walk(fd, p0: jnp.ndarray, lens: jnp.ndarray,
              num_steps: int, rate: int, num_docs: int):
    """All-mode walkers: p0 (M,) start positions -> per-step fragment marks.

    Returns (pos (T, M, N), height (T, M, N), valid (T, M, N)) where valid
    selects fragment-head walkers of active MUMs at marking steps."""
    M = p0.shape[0]
    N = num_docs
    d = jnp.arange(N, dtype=jnp.int32)
    p = p0[:, None] + d[None, :]
    sep0 = jnp.zeros((M, N), dtype=bool)

    def step(carry, t0):
        p, sep = carry
        active = (t0 < lens)[:, None]
        flat = p.reshape(-1)
        i = (jnp.searchsorted(fd["idx"], flat, side="right") - 1).astype(jnp.int32)
        run_start = jnp.take(fd["idx"], i, mode="clip")
        is_head = (flat == run_start).reshape(M, N)
        new_sep = sep | (is_head & active & (d[None, :] > 0))
        di = jnp.take(fd["dest_interval"], i, mode="clip")
        doff = jnp.take(fd["dest_offset"], i, mode="clip")
        p_next = (jnp.take(fd["idx"], di, mode="clip") + doff
                  + (flat - run_start)).reshape(M, N)
        p_next = jnp.where(active, p_next, p)
        # fragment heights in O(N): a fragment head's height is the distance
        # to the next head (splits are permanent and walker order is the
        # fragment order, so segments are [head, next_head))
        first = new_sep | (d[None, :] == 0)
        head_or_n = jnp.where(first, d[None, :], N)
        next_head = jnp.concatenate(
            [jax.lax.cummin(head_or_n, axis=1, reverse=True)[:, 1:],
             jnp.full((M, 1), N, dtype=head_or_n.dtype)], axis=1)
        height = next_head - d[None, :]
        valid = first & active & ((t0 % rate) == 0)
        return (p_next, new_sep), (p_next, height, valid)

    (_, _), (pos, height, valid) = jax.lax.scan(
        step, (p, sep0), jnp.arange(num_steps, dtype=jnp.int32))
    return pos, height, valid


def _bin_id(ids: np.ndarray, id_bits: int) -> np.ndarray:
    id_max = 1 << id_bits
    ids = np.asarray(ids, dtype=np.int64)
    return np.where(ids >= id_max, (ids % (id_max - 1)) + 1, ids)


def col_split_tunneled_numpy(fl: FLTableArrays, mum_lens: np.ndarray,
                             mum_pos: np.ndarray, num_docs: int,
                             split_rate: int = 10, id_bits: int = 8
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host int64 tunneled walk — the wide-n (n >= 2**31) lane.

    Same lockstep formulation and outputs as col_split_jax(mode="tunnels"):
    all MUM walkers advance one FL step per iteration, a walker dies when its
    N-high range fragments (a run boundary inside [p, p+N), detected as
    p+N-1 reaching past the next run start), and positions are marked every
    split_rate steps while alive (include/col_split.hpp:70-99).  NumPy int64
    vectorization over live walkers: the device walker's int32 positions cap
    at n < 2**31, this one is bounded by host RAM only.
    """
    M = int(np.asarray(mum_pos).size)
    if M == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    N = num_docs
    idx = np.asarray(fl.idx, dtype=np.int64)
    nxt_start = np.empty(idx.size, dtype=np.int64)
    nxt_start[:-1] = idx[1:]
    nxt_start[-1] = fl.n
    dest_i = np.asarray(fl.dest_interval, dtype=np.int64)
    dest_o = np.asarray(fl.dest_offset, dtype=np.int64)

    order = np.argsort(np.asarray(mum_pos), kind="stable")
    pos0 = np.asarray(mum_pos, dtype=np.int64)[order]
    lens0 = np.asarray(mum_lens, dtype=np.int64)[order]
    c_ids0 = np.arange(1, M + 1, dtype=np.int64)
    g_t = int(lens0.max()) + 1  # visit-key stride, as in col_split_jax

    # ascending by length: finished lanes form a moving prefix
    by_len = np.argsort(lens0, kind="stable")
    p = pos0[by_len].copy()
    lens = lens0[by_len]
    cid = c_ids0[by_len]
    alive = np.ones(M, dtype=bool)
    T = int(lens[-1])

    out_pos: list[np.ndarray] = []
    out_id: list[np.ndarray] = []
    out_visit: list[np.ndarray] = []
    lo = 0
    for t in range(T):
        lo = int(np.searchsorted(lens, t, side="right"))
        if lo:  # drop finished lanes (and any dead lanes swept along)
            p, lens, cid, alive = p[lo:], lens[lo:], cid[lo:], alive[lo:]
            lo = 0
        if p.size == 0:
            break
        i = np.searchsorted(idx, p, side="right") - 1
        frag = p + N - 1 >= nxt_start[i]
        alive &= ~frag
        if not alive.any():
            # every remaining lane is dead; the prefix drop can't reap them
            p = p[:0]
            break
        p_next = idx[dest_i[i]] + dest_o[i] + (p - idx[i])
        np.copyto(p, p_next, where=alive)
        if t % split_rate == 0:
            live = np.flatnonzero(alive)
            out_pos.append(p[live])
            out_id.append(cid[live])
            out_visit.append(cid[live] * g_t + t)
        # compact dead lanes once they dominate
        if t % 256 == 255 and alive.size and alive.mean() < 0.5:
            keep = alive
            p, lens, cid, alive = p[keep], lens[keep], cid[keep], alive[keep]

    if not out_pos:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    pos_all = np.concatenate(out_pos)
    ids_all = _bin_id(np.concatenate(out_id), id_bits)
    visit = np.concatenate(out_visit)
    o = np.lexsort((visit, pos_all))
    pos_s, ids_s = pos_all[o], ids_all[o]
    last = np.r_[pos_s[1:] != pos_s[:-1], True]
    heights = np.full(int(last.sum()), N, dtype=np.int64)
    return pos_s[last], ids_s[last], heights


def col_split_all_numpy(fl: FLTableArrays, mum_lens: np.ndarray,
                        mum_pos: np.ndarray, num_docs: int,
                        split_rate: int = 10, id_bits: int = 8
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All-mode col-split as a fragment-event walk — O(live fragments) per
    step instead of the O(N) per-MUM walker decomposition of _all_walk.

    A MUM's N-high range stays a set of contiguous fragments: a fragment
    [p, p+h) walks FL intact while no run starts fall in (p, p+h), and splits
    into sub-fragments at exactly those boundaries (splits are permanent,
    include/col_split.hpp:54-136).  Per step: one vectorized multi-split
    expansion (repeat over boundary counts) then one affine FL step per
    fragment.  Each fragment carries its offset d0 inside the original range
    so visit keys — (mum, step, walker-index) — and the first-among-maximal-
    height merge match _all_walk / the oracle exactly.  Host int64, so the
    wide (n >= 2**31) regime and N = 10k-class document counts both work.
    """
    M = int(np.asarray(mum_pos).size)
    if M == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    N = num_docs
    idx = np.asarray(fl.idx, dtype=np.int64)
    dest_pos = (np.asarray(fl.idx, dtype=np.int64)[
        np.asarray(fl.dest_interval, dtype=np.int64)]
        + np.asarray(fl.dest_offset, dtype=np.int64))

    order = np.argsort(np.asarray(mum_pos), kind="stable")
    pos = np.asarray(mum_pos, dtype=np.int64)[order].copy()
    lens = np.asarray(mum_lens, dtype=np.int64)[order]
    cid = np.arange(1, M + 1, dtype=np.int64)
    g_t = int(lens.max()) + 1

    h = np.full(M, N, dtype=np.int64)
    d0 = np.zeros(M, dtype=np.int64)
    T = int(lens.max())

    out_pos: list[np.ndarray] = []
    out_id: list[np.ndarray] = []
    out_h: list[np.ndarray] = []
    out_visit: list[np.ndarray] = []
    for t in range(T):
        act = t < lens
        if not act.all():
            pos, h, d0, cid, lens = (pos[act], h[act], d0[act], cid[act],
                                     lens[act])
        if pos.size == 0:
            break
        # split phase: boundaries strictly inside (p, p+h) become new heads
        first_in = np.searchsorted(idx, pos, side="right")
        cnt = np.searchsorted(idx, pos + h, side="left") - first_in
        if cnt.max(initial=0) > 0:
            pieces = cnt + 1
            rep = np.repeat(np.arange(pos.size), pieces)
            jj = (np.arange(rep.size, dtype=np.int64)
                  - np.repeat(np.cumsum(pieces) - pieces, pieces))
            b_idx = first_in[rep] + jj - 1
            st = np.where(jj == 0, pos[rep], idx[np.maximum(b_idx, 0)])
            is_last = jj == cnt[rep]
            en = np.where(is_last, pos[rep] + h[rep],
                          idx[np.minimum(first_in[rep] + jj, idx.size - 1)])
            d0 = d0[rep] + (st - pos[rep])
            pos, h, cid, lens = st, en - st, cid[rep], lens[rep]
        # step phase: every fragment sits inside one run now
        i = np.searchsorted(idx, pos, side="right") - 1
        pos = dest_pos[i] + (pos - idx[i])
        if t % split_rate == 0:
            out_pos.append(pos.copy())
            out_id.append(cid.copy())
            out_h.append(h.copy())
            out_visit.append((cid * g_t + t) * (N + 1) + d0)

    if not out_pos:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    pos_all = np.concatenate(out_pos)
    ids_all = _bin_id(np.concatenate(out_id), id_bits)
    h_all = np.concatenate(out_h)
    visit = np.concatenate(out_visit)
    # first mark (visit order) among maximal heights wins per position
    o = np.lexsort((visit, -h_all, pos_all))
    pos_s, ids_s, h_s = pos_all[o], ids_all[o], h_all[o]
    firsts = np.r_[True, pos_s[1:] != pos_s[:-1]]
    return pos_s[firsts], ids_s[firsts], h_s[firsts]


def col_split_jax(fl: FLTableArrays, mum_lens: np.ndarray, mum_pos: np.ndarray,
                  num_docs: int, split_rate: int = 10, mode: str = "tunnels",
                  id_bits: int = 8, step_budget: int = 1 << 24
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Device col-split; same outputs as oracle.col_split_oracle:
    (mark_positions sorted, mark_ids binned, mark_heights)."""
    order = np.argsort(np.asarray(mum_pos), kind="stable")
    pos_sorted = np.asarray(mum_pos, dtype=np.int64)[order]
    len_sorted = np.asarray(mum_lens, dtype=np.int64)[order]
    c_ids = np.arange(1, order.size + 1, dtype=np.int64)
    M = order.size
    if M == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()

    tunneled = mode in ("tunnels", "tunneled")
    if not tunneled and num_docs > 64:
        # the device All-walk materializes (T, M, N) arrays — O(N) per MUM
        # per step.  Beyond small N the fragment-event walk wins outright
        # (O(live fragments) per step, any N).
        return col_split_all_numpy(fl, mum_lens, mum_pos, num_docs,
                                   split_rate, id_bits)
    fd = fl_device_arrays(fl)

    # bucket MUMs (ascending length) so T * M_bucket walk area stays bounded
    by_len = np.argsort(len_sorted, kind="stable")
    g_t = int(len_sorted.max()) + 1  # global visit-key stride across buckets
    all_pos: list[np.ndarray] = []
    all_ids: list[np.ndarray] = []
    all_heights: list[np.ndarray] = []
    all_visit: list[np.ndarray] = []

    start = 0
    while start < M:
        end = start + 1
        while end < M:
            area = int(len_sorted[by_len[end]]) * (end + 1 - start)
            if not tunneled:
                area *= num_docs
            if area > step_budget:
                break
            end += 1
        sel = by_len[start:end]
        T = int(len_sorted[sel].max())
        p0 = jnp.asarray(pos_sorted[sel], dtype=jnp.int32)
        lens_j = jnp.asarray(len_sorted[sel], dtype=jnp.int32)

        if tunneled:
            pos_t, valid_t = _tunneled_walk(fd, p0, lens_j, T, split_rate, num_docs)
            pos_np = np.asarray(pos_t)          # (T, Mb)
            val_np = np.asarray(valid_t)
            t_idx, m_idx = np.nonzero(val_np)
            all_pos.append(pos_np[t_idx, m_idx].astype(np.int64))
            all_ids.append(c_ids[sel][m_idx])
            all_heights.append(np.full(t_idx.size, num_docs, dtype=np.int64))
            # visit key: (c_id, t) lexicographic, comparable across buckets
            all_visit.append(c_ids[sel][m_idx] * g_t + t_idx)
        else:
            pos_t, h_t, valid_t = _all_walk(fd, p0, lens_j, T, split_rate, num_docs)
            pos_np = np.asarray(pos_t)          # (T, Mb, N)
            h_np = np.asarray(h_t)
            val_np = np.asarray(valid_t)
            t_idx, m_idx, d_idx = np.nonzero(val_np)
            all_pos.append(pos_np[t_idx, m_idx, d_idx].astype(np.int64))
            all_ids.append(c_ids[sel][m_idx])
            all_heights.append(h_np[t_idx, m_idx, d_idx].astype(np.int64))
            all_visit.append((c_ids[sel][m_idx] * g_t + t_idx) * (num_docs + 1)
                             + d_idx)
        start = end

    pos_all = np.concatenate(all_pos)
    ids_all = _bin_id(np.concatenate(all_ids), id_bits)
    h_all = np.concatenate(all_heights)
    visit = np.concatenate(all_visit)
    if pos_all.size == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z.copy(), z.copy()

    if tunneled:
        # last mark in visit order wins per position
        o = np.lexsort((visit, pos_all))
        pos_s, ids_s, h_s = pos_all[o], ids_all[o], h_all[o]
        last = np.r_[pos_s[1:] != pos_s[:-1], True]
        return pos_s[last], ids_s[last], h_s[last]
    else:
        # first mark (visit order) among maximal heights wins per position
        o = np.lexsort((visit, -h_all, pos_all))
        pos_s, ids_s, h_s = pos_all[o], ids_all[o], h_all[o]
        firsts = np.r_[True, pos_s[1:] != pos_s[:-1]]
        return pos_s[firsts], ids_s[firsts], h_s[firsts]
