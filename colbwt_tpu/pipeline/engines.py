"""Query-engine selection and batch dispatch, shared by the one-shot
(`query_pipeline`) and streaming (`query_stream`) drivers.

Engine ladder (fastest first; docs/DESIGN_NOTES.md):

- positional automaton (k chars per gather; needs (sigma+1)**k * n * 8 B HBM)
- mega-wide (wide indexes, n >= 2**31: two-limb positions, 1 gather/char)
- mega (1 gather/char; needs a run-split index, ff_bound >= 2)
- fused (K+1 gathers/char; ff_bound >= 1)
- compact xla (table-free fallback)

All engines produce bit-identical PML+CID (col_pml::_query_pml semantics,
include/col_bwt.hpp:498-574), differential-tested against the NumPy oracle
and the single-core C++ engine.
"""

from __future__ import annotations

import numpy as np

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.utils.config import ColBwtConfig


class QueryEngines:
    """Owns the device tables for one index and dispatches read batches."""

    def __init__(self, index: ColPmlIndex, cfg: ColBwtConfig,
                 total_chars: int | None = None,
                 table_dir: str | None = None):
        from colbwt_tpu.ops import query_mega, query_pos

        from colbwt_tpu.utils.hbm import resolve_pos_budget

        self.index = index
        self.cfg = cfg
        self.table_dir = (table_dir if cfg.table_cache != "off" else None)
        self.cache_events: list[dict] = []  # load/build provenance per table
        # The pos tables cost O(A^k n) device work to build, so under "auto"
        # they only pay off for real workloads; total_chars=None means "the
        # workload is large/unbounded" (streaming drivers).
        large = total_chars is None or total_chars >= 1_000_000
        budget = resolve_pos_budget(cfg.pos_hbm_budget)
        pos_k = (query_pos.choose_k(index, budget)
                 if (not index.wide and cfg.engine in ("auto", "pos")) else 0)
        pos_alpha = None
        # The restricted-alphabet upgrade must run even when the GENERAL
        # table doesn't fit (pos_k == 0): at config-4 scale the 6*n general
        # T1 overflows the budget while the 5^k ACGT table fits — the
        # restricted engine is exactly what large ACGT indexes need.
        if (not index.wide and cfg.engine in ("auto", "pos")
                and set(index.alphabet.tolist()) - {1} <= set(b"ACGT")):
            kq = query_pos.choose_k(index, budget, alphabet=b"ACGT")
            if kq >= max(pos_k, 1):
                pos_k, pos_alpha = kq, b"ACGT"
        self.pos_budget = budget
        self.pos_k = pos_k
        # packed (pml << 8 | cid) output planes require 8-bit cids — true
        # for the reference's ID_BITS=8 budget; an id_bits>8 extension
        # index falls back to two-plane outputs
        self._cid8 = int(index.col_id.max(initial=0)) <= 0xFF
        self.use_pos = pos_k >= 1 and (cfg.engine == "pos" or large)
        self.use_wide = index.wide
        if self.use_wide and index.ff_bound < 2:
            raise ValueError("wide index lacks run splitting (ff_bound < 2); "
                             "rebuild with ColPmlIndex.build")
        self.use_mega = (not self.use_pos and not self.use_wide
                         and index.ff_bound >= 2
                         and cfg.engine in ("auto", "mega"))
        self.use_fused = (not self.use_pos and not self.use_wide
                          and not self.use_mega and index.ff_bound >= 1
                          and cfg.engine in ("auto", "fused"))
        self.pt = (self._tables("pos", lambda: query_pos.build_pos_tables(
            index, pos_k, hbm_budget_bytes=budget, alphabet=pos_alpha))
            if self.use_pos else None)
        if self.use_wide:
            from colbwt_tpu.ops import query_mega_wide

            self.mt = self._tables(
                "megawide", lambda: query_mega_wide.build_mega_table_wide(
                    index, hbm_budget_bytes=budget))
        else:
            self.mt = (self._tables(
                "mega", lambda: query_mega.build_mega_table(index))
                if self.use_mega else None)
        self.ft = None
        if self.use_fused:
            from colbwt_tpu.ops import query_fused

            self.ft = query_fused.build_fused_tables(index)
        self._xla_tb = None

    def _tables(self, kind: str, build_fn):
        """Build an engine's device tables, or reload them from the
        persisted table cache next to the index (pipeline/tables.py).

        The load-vs-rebuild choice is MEASURED, not assumed: one ~32 MB
        bandwidth probe per process projects the transfer time, and the
        cache is used only when that beats the recorded build time.
        Records one provenance event either way."""
        import time

        if self.table_dir is None:
            return build_fn()
        from colbwt_tpu.pipeline import tables as TB

        force = self.cfg.table_cache == "force"
        meta = TB.peek(self.table_dir, kind, self.index)
        have_cache = meta is not None
        if have_cache:
            bw = TB.h2d_bandwidth()
            proj = meta["dev_bytes"] / bw
            build_s = meta.get("build_seconds")
            if force or build_s is None or proj < build_s:
                t0 = time.perf_counter()
                got = TB.load_tables(self.table_dir, kind, self.index)
                if got is not None:
                    tbl, info = got
                    self.cache_events.append({
                        "kind": kind, "event": "load",
                        "seconds": time.perf_counter() - t0,
                        "replaced_build_seconds": build_s})
                    return tbl
                have_cache = False  # half-written entry: fall through
            else:
                self.cache_events.append({
                    "kind": kind, "event": "skip-load",
                    "projected_seconds": proj, "build_seconds": build_s,
                    "bandwidth_bytes_per_s": bw})
        t0 = time.perf_counter()
        tbl = build_fn()
        build_s = time.perf_counter() - t0
        if have_cache:  # valid cache we declined: don't pay the save again
            return tbl
        dev_bytes = sum(v.nbytes if TB._placement(v) == "dev" else 0
                        for v in tbl.values())
        proj_save = dev_bytes / TB.h2d_bandwidth()
        if force or proj_save < build_s:
            t0 = time.perf_counter()
            TB.save_tables(self.table_dir, kind, self.index, tbl,
                           build_seconds=build_s)
            self.cache_events.append({
                "kind": kind, "event": "build+save", "seconds": build_s,
                "save_seconds": time.perf_counter() - t0})
        else:
            self.cache_events.append({
                "kind": kind, "event": "build+skip-save",
                "seconds": build_s, "projected_save_seconds": proj_save})
        return tbl

    @property
    def name(self) -> str:
        if self.use_pos:
            return f"pos(k={self.pos_k})"
        if self.use_wide:
            return "mega-wide"
        if self.use_mega:
            return "mega"
        if self.use_fused:
            return "fused"
        return "xla"

    # ------------------------------------------------------------------
    def dispatch(self, batch: list[bytes], padded: int):
        """Enqueue one device batch without blocking (JAX async dispatch);
        returns (device_pml, device_cid, lens, fallback) to materialize
        later — back-to-back batches overlap host transfer with compute."""
        import jax.numpy as jnp

        from colbwt_tpu.ops import query_mega, query_pos, query_xla
        from colbwt_tpu.utils.xfer import device_put_chunked

        index, pt, mt, ft = self.index, self.pt, self.mt, self.ft
        if self.use_pos:
            # M must divide both k (key folding) and the digit-packing
            # group (4 digits/byte at A <= 4, 2 at A <= 16)
            import math

            per = 4 if pt["A"] <= 4 else (2 if pt["A"] <= 16 else 1)
            grp = math.lcm(self.pos_k, per)  # e.g. k=3, per=4 -> 12
            padded = -(-padded // grp) * grp
            if padded > 255 and max(len(r) for r in batch) <= 252:
                padded = 252  # largest <= 255 multiple of every k <= 4:
                # keeps the u16 packed plane for standard short reads whose
                # power-of-2 bucket would round to 256
            dig, lens, bad = query_pos._encode_digits(index, pt, batch, padded)
            # 2-bit packed digits up (ACGT keys) + one packed u16 plane
            # down: ~16x fewer upload + 4x fewer download bytes than int32
            # digits + two int32 planes, for drivers bound by the
            # host<->device link
            dig, pack = query_pos.pack_digits(dig, pt["A"])
            ej, lj = device_put_chunked(dig), jnp.asarray(lens)
            p, c = query_pos.query_batch_pos(pt["table"], pt["n"], ej, lj,
                                             k=self.pos_k, A=pt["A"],
                                             packed_out=True, pack=pack)
            if bad.any():  # reads with non-key bytes: general k=1 fallback
                idxs = np.flatnonzero(bad)
                e2, l2 = index.encode_patterns([batch[i] for i in idxs],
                                               padded)
                if pt["t1"] is not None:
                    p2, c2 = query_pos.query_batch_pos(
                        pt["t1"], pt["n"], jnp.asarray(e2), jnp.asarray(l2),
                        k=1, A=pt["A_full"])
                else:  # general T1 doesn't fit HBM: compact engine
                    if self._xla_tb is None:
                        self._xla_tb = query_xla.index_device_arrays(index)
                    p2, c2 = query_xla.query_batch_device(
                        self._xla_tb, jnp.asarray(e2), jnp.asarray(l2),
                        ff_bound=index.ff_bound)
                return p, c, lens, (idxs, p2, c2)
            return p, c, lens, None
        if self.use_wide or self.use_mega:
            if padded > 255 and max(len(r) for r in batch) <= 255:
                padded = 255  # keep the u16 packed plane for short reads
                # whose power-of-2 bucket would round to 256
        enc, lens = index.encode_patterns(batch, padded)
        if self.use_wide or self.use_mega:
            # slim transfer scheme (same as the pos path above): uint8
            # dense-id uploads + one packed u16 output plane when the
            # padded length allows — ~8x fewer bytes/batch over the
            # host<->device link than int32 enc + two int32 planes
            enc = enc.astype(np.uint8)  # dense ids <= sigma < 256
        ej, lj = device_put_chunked(enc), jnp.asarray(lens)
        if self.use_wide:
            from colbwt_tpu.ops import query_mega_wide

            # packed_out is u16 at padded <= 255, else a single int32
            # plane (still 2x fewer bytes than two planes; lossless while
            # reads stay under the 2**23 pml guard and cids fit 8 bits)
            p, c = query_mega_wide.query_batch_mega_wide(
                mt, ej, lj, ff_bound=index.ff_bound,
                packed_out=self._cid8 and padded < (1 << 23))
        elif self.use_mega:
            p, c = query_mega.query_batch_mega(
                mt, ej, lj, ff_bound=index.ff_bound,
                packed_out=self._cid8 and padded < (1 << 23))
        elif self.use_fused:
            from colbwt_tpu.ops import query_fused

            p, c = query_fused.query_batch_fused(ft, ej, lj,
                                                 ff_bound=index.ff_bound)
        else:
            if self._xla_tb is None:
                self._xla_tb = query_xla.index_device_arrays(index)
            p, c = query_xla.query_batch_device(self._xla_tb, ej, lj,
                                                ff_bound=index.ff_bound)
        return p, c, lens, None

    @staticmethod
    def materialize(result) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Block on a dispatch() result; returns (pml (B, W), cid (B, W),
        lens (B,)) with any fallback reads spliced back in.  A packed_out
        plane (cid side None) is split on the host."""
        from colbwt_tpu.ops import query_pos

        p_dev, c_dev, lens, fallback = result
        if c_dev is None:
            p, c = query_pos.unpack_pml_cid(p_dev)
        else:
            p = np.asarray(p_dev)
            c = np.asarray(c_dev)
        if fallback is not None:
            idxs, p2_dev, c2_dev = fallback
            p, c = np.array(p), np.array(c)  # asarray views are read-only
            p[idxs] = np.asarray(p2_dev)
            c[idxs] = np.asarray(c2_dev)
        return p, c, np.asarray(lens)

    # ------------------------------------------------------------------
    def query_long_reads(self, reads: list[bytes]
                         ) -> tuple[list[np.ndarray], list[np.ndarray]]:
        """Chunked carried-state scans for reads beyond cfg.long_read_len
        (the -l mode, src/pml_query.cpp:126-128)."""
        from colbwt_tpu.ops import query_mega, query_pos

        chunk = self.cfg.long_read_chunk
        if self.use_pos:
            return query_pos.query_long_reads(self.index, reads, chunk=chunk,
                                              pt=self.pt)
        if self.use_wide:
            from colbwt_tpu.ops import query_mega_wide

            return query_mega_wide.query_long_reads(self.index, reads,
                                                    chunk=chunk, mt=self.mt)
        if self.use_mega:
            return query_mega.query_long_reads(self.index, reads, chunk=chunk,
                                               mt=self.mt)
        # fused/xla engines handle any length in one batch (no table growth
        # with M) — reuse dispatch at the padded length
        padded = 1 << (max(max(len(r) for r in reads), 1) - 1).bit_length()
        p, c, lens = self.materialize(self.dispatch(reads, padded))
        W = p.shape[1]
        return ([p[i, W - int(lens[i]):] for i in range(len(reads))],
                [c[i, W - int(lens[i]):] for i in range(len(reads))])

    def supports_long_streaming(self) -> bool:
        return self.use_pos or self.use_mega or self.use_wide
