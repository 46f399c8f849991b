"""Staged, artifact-checkpointed build pipeline.

Behavioral equivalent of the reference orchestrator (scripts/col-bwt.py:94-189):
every stage writes its artifacts next to the output prefix, a stage is skipped
when its artifacts already exist (file-existence resumability, SURVEY §5.3),
--force re-runs everything, and a failed stage removes its partial artifacts.

Stage map (reference stage → ours):

  mumemto mum -K -R -T      → stage_mums     (device SA/LCP/MUM/threshold ops)
                              writes PREFIX.fa.bwt.heads/.bwt.len/.thr_pos/
                              .col_mums/PREFIX.lengths
  rlbwt_to_bwt              → stage_bwt      (PREFIX.fa.bwt)
  build_FL                  → in-memory FL table (the reference's .FL_table is
                              an internal handoff; rebuilt from the RLBWT in
                              milliseconds, so no artifact)
  col_split -m -s           → stage_colsplit (PREFIX.fa.col_runs [sdsl plain
                              bit_vector] + PREFIX.fa.col_ids)
  movi-split build          → stage_index    (PREFIX.colpml.npz: the
                              run-split ColPmlIndex)
  movi-split query          → query_pipeline (PATTERN.split.pml.bin/.cid.bin)
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from colbwt_tpu.io import formats as F
from colbwt_tpu.io.fasta import read_fasta, reverse_complement
from colbwt_tpu.io.pml_out import write_pml_cid_binary, write_pml_cid_text
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.utils.config import ColBwtConfig
from colbwt_tpu.utils.log import Timer, get_logger, status

# below this n the host oracle beats device dispatch for construction
_DEVICE_MIN_N = 1 << 18


def _exists(*paths: Path) -> bool:
    return all(p.exists() for p in paths)


def _cleanup(paths: list[Path]) -> None:
    for p in paths:
        p.unlink(missing_ok=True)


def load_documents(fastas: list[str], filelist: str | None,
                   rev_comp: bool) -> list[bytes]:
    """Collect one document per FASTA file (records concatenated), with
    optional reverse complements appended (scripts/col-bwt.py:109-139)."""
    files = list(fastas)
    if filelist:
        files = []
        for line in Path(filelist).read_text().splitlines():
            if line.strip():
                files.append(line.split()[0])
    docs = []
    for f in files:
        seq = b"".join(rec.seq for rec in read_fasta(f))
        if rev_comp:
            seq = seq + reverse_complement(seq)
        docs.append(seq.upper())
    return docs


def stage_mums(docs: list[bytes], prefix: str, cfg: ColBwtConfig, logger):
    """SA/LCP → RLBWT + thresholds + multi-MUMs, written to the mumemto file
    contracts (SURVEY §2.4)."""
    fa = f"{prefix}.fa"
    outs = [Path(f"{fa}.bwt.heads"), Path(f"{fa}.bwt.len"),
            Path(f"{fa}.thr_pos"), Path(f"{fa}.col_mums"),
            Path(f"{prefix}.lengths")]
    if _exists(*outs) and not cfg.force:
        logger.info("[mums] artifacts exist, skipping")
        return
    try:
        from colbwt_tpu.io import native as native_lib
        from colbwt_tpu.utils.hbm import resolve_sa_budget_chars

        n_total = sum(len(d) + 1 for d in docs)
        sa_budget = resolve_sa_budget_chars(cfg.sa_ram_chars)
        use_chunked = (cfg.sa_mode == "chunked"
                       or (cfg.sa_mode == "auto" and n_total > sa_budget))
        if use_chunked:
            if not native_lib.available():
                raise RuntimeError(
                    "chunked construction needs the native library "
                    "(make -C native); monolithic SA at this n would need "
                    f"~{n_total * 40 / 1e9:.0f} GB of host RAM")
            _stage_mums_chunked(docs, prefix, cfg, logger, sa_budget)
            return
        text, ranks, doc_ids = O.concat_collection(docs)
        n = text.size
        use_device = n >= _DEVICE_MIN_N
        with status("suffix array + LCP", logger):
            # preference order: native SA-IS (linear time — the
            # libdivsufsort/PFP role of the reference's mumemto stage),
            # then the device prefix-doubling path, then the host oracle
            from colbwt_tpu.io import native as native_lib

            if native_lib.available():
                sa = native_lib.suffix_array_sais(ranks)
                lcp = native_lib.lcp_kasai(ranks, sa)
            elif use_device:
                from colbwt_tpu.ops import construct_jax as CJ
                sa, _, pyr = CJ.suffix_array_jax(ranks, with_pyramid=True)
                lcp = CJ.lcp_jax(ranks, sa, pyr)
                del pyr
            else:
                sa = O.suffix_array(ranks)
                lcp = O.lcp_kasai(ranks, sa)
        with status("BWT + RLE", logger):
            heads, lens = O.rle(O.bwt_from_sa(text, sa))
        with status("multi-MUMs", logger):
            if use_device and len(docs) >= 2:
                from colbwt_tpu.ops import construct_jax as CJ
                ml, mp = CJ.find_multi_mums_jax(
                    ranks, sa, lcp, doc_ids, len(docs), cfg.min_mum,
                    log=lambda m: logger.info("[mums] %s", m))
            else:
                ml, mp = O.find_multi_mums(
                    ranks, sa, lcp, doc_ids, len(docs), cfg.min_mum)
        with status("thresholds", logger):
            # packed-reduceat host path: O(n) memory, streams at any n
            # (the device version's n-sized HBM arrays cap out near 2**31)
            thr = (O.compute_thresholds_fast(heads, lens, lcp) if use_device
                   else O.compute_thresholds(heads, lens, lcp))

        F.write_rlbwt(fa, heads, lens, cfg.rw_bytes)
        F.write_thresholds_file(f"{fa}.thr_pos", thr, cfg.rw_bytes)
        F.write_col_mums(f"{fa}.col_mums", len(docs), ml, mp, cfg.rw_bytes)
        Path(f"{prefix}.lengths").write_text(
            "".join(f"{len(d)}\n" for d in docs))
        logger.info("[mums] n=%d runs=%d multi-MUMs=%d", n, heads.size, ml.size)
    except Exception:
        _cleanup(outs)
        raise


def _stage_mums_chunked(docs: list[bytes], prefix: str, cfg: ColBwtConfig,
                        logger, sa_budget: int):
    """stage_mums via chunked construction (ops.construct_chunked): per-chunk
    SA-IS + rank-based BWT merge + LCP from the merged RLBWT — the scale lane
    for collections beyond the monolithic-SA RAM budget (the reference's PFP
    role, thirdparty/CMakeLists.txt:89-108).  Writes the same artifacts."""
    import gc
    import shutil

    from colbwt_tpu.ops import construct_chunked as CC

    fa = f"{prefix}.fa"
    n_total = sum(len(d) + 1 for d in docs)
    chunk = cfg.chunk_chars or max(1, sa_budget // 2)
    logger.info("[mums] chunked construction: n=%d chunk=%d", n_total, chunk)

    text = np.empty(n_total, dtype=np.uint8)
    doc_starts = np.zeros(len(docs) + 1, dtype=np.int64)
    pos = 0
    for i, d in enumerate(docs):
        arr = np.frombuffer(d, dtype=np.uint8)
        text[pos:pos + arr.size] = arr
        text[pos + arr.size] = CC.TERMINATOR
        pos += arr.size + 1
        doc_starts[i + 1] = pos

    # Intra-stage checkpoints: the RLBWT merge state is checkpointed per
    # chunk and the two long sub-stages (RLBWT, LCP) cache their results,
    # so a killed multi-hour build resumes where it died instead of at the
    # stage boundary (the reference resumes per stage only,
    # scripts/col-bwt.py:122-137).  The cache dir is removed once the
    # stage's real artifacts are written.
    ck = Path(f"{prefix}.chunked_cache")
    ck.mkdir(parents=True, exist_ok=True)
    fprint = CC._input_fingerprint(text, doc_starts, True)
    # stage caches are written to a temp name then renamed: a kill DURING
    # the multi-GB write (the exact crash this cache exists to survive)
    # must not leave a truncated file that poisons every resume
    rle_f = ck / f"rlbwt.{fprint}.npz"
    with status("chunked RLBWT + doc array", logger):
        heads = None
        if rle_f.exists():
            try:
                z = np.load(rle_f)
                # doc_of stays on disk: the scan phase memmaps it
                # (mum_scan_stream), so the scan starts from a near-zero
                # resident plateau
                heads, lens = z["heads"], z["lens"]
                logger.info("[mums] chunked RLBWT loaded from stage cache")
            except Exception:
                logger.warning("[mums] corrupt RLBWT stage cache — "
                               "rebuilding")
                rle_f.unlink(missing_ok=True)
        if heads is None:
            heads, lens, doc_of = CC.build_rlbwt_chunked(
                text, doc_starts, chunk,
                log=lambda m: logger.info("[mums] %s", m), cache_dir=ck,
                fingerprint=fprint)
            tmp = rle_f.with_suffix(".tmp.npz")
            np.savez(tmp, heads=heads, lens=lens, doc_of=doc_of)
            tmp.rename(rle_f)
            del doc_of
    del text
    gc.collect()
    lcp_f = ck / f"lcp32.{fprint}.npy"
    with status("LCP from RLBWT (Beller BFS)", logger):
        lcp_cached = False
        if lcp_f.exists():
            try:
                # header + length check only; contents stay on disk
                np.load(lcp_f, mmap_mode="r")
                lcp_cached = True
                logger.info("[mums] LCP stage cache on disk (memmap)")
            except Exception:
                logger.warning("[mums] corrupt LCP stage cache — rebuilding")
                lcp_f.unlink(missing_ok=True)
        if not lcp_cached:
            lcp32 = CC.lcp_chunked(heads, lens, len(docs))
            tmp = lcp_f.with_suffix(".tmp.npy")
            np.save(tmp, lcp32)
            tmp.rename(lcp_f)
            del lcp32
            gc.collect()
    lcp32 = np.load(lcp_f, mmap_mode="r")
    with status("thresholds", logger):
        thr = O.compute_thresholds_fast(heads, lens, lcp32)
    with status("multi-MUMs", logger):
        if len(docs) >= 2:
            from colbwt_tpu.ops import mum_scan_stream as MS

            doc_f = ck / f"doc_of.{fprint}.u16.npy"
            rc_f = ck / f"rc.{fprint}.bits.npy"
            if not rc_f.exists():
                MS.write_run_change_bits(heads, lens, rc_f)
            if not doc_f.exists():
                MS.extract_npz_member(rle_f, "doc_of.npy", doc_f)
            ml, mp = MS.find_multi_mums_streamed(
                lcp_f, doc_f, rc_f, len(docs), cfg.min_mum,
                progress_path=ck / f"mumscan.{fprint}.npz",
                log=lambda m: logger.info("[mums] %s", m))
        else:
            ml = np.empty(0, dtype=np.int64)
            mp = np.empty(0, dtype=np.int64)
        del lcp32
        gc.collect()

    F.write_rlbwt(fa, heads, lens, cfg.rw_bytes)
    F.write_thresholds_file(f"{fa}.thr_pos", thr, cfg.rw_bytes)
    F.write_col_mums(f"{fa}.col_mums", len(docs), ml, mp, cfg.rw_bytes)
    Path(f"{prefix}.lengths").write_text(
        "".join(f"{len(d)}\n" for d in docs))
    shutil.rmtree(ck, ignore_errors=True)  # stage artifacts now authoritative
    logger.info("[mums] n=%d runs=%d multi-MUMs=%d (chunked)",
                n_total, heads.size, ml.size)


def stage_bwt(prefix: str, cfg: ColBwtConfig, logger):
    """Expand the RLBWT to PREFIX.fa.bwt (src/rlbwt_to_bwt.cpp:22-27)."""
    fa = f"{prefix}.fa"
    out = Path(f"{fa}.bwt")
    if out.exists() and not cfg.force:
        logger.info("[bwt] exists, skipping")
        return
    try:
        heads, lens = F.read_rlbwt(fa, cfg.rw_bytes)
        F.write_plain_bwt(out, heads, lens)
    except Exception:
        _cleanup([out])
        raise


def stage_colsplit(prefix: str, cfg: ColBwtConfig, logger):
    """FL walk + interval sweep → .col_runs + .col_ids
    (src/col_split.cpp:62-141)."""
    fa = f"{prefix}.fa"
    outs = [Path(f"{fa}.col_runs"), Path(f"{fa}.col_ids")]
    if _exists(*outs) and not cfg.force:
        logger.info("[colsplit] artifacts exist, skipping")
        return
    try:
        heads, lens = F.read_rlbwt(fa, cfg.rw_bytes)
        num_docs, ml, mp = F.read_col_mums(f"{fa}.col_mums", cfg.rw_bytes)
        fl = O.build_fl_table(heads, lens)
        wide = fl.n > min(cfg.wide_n_limit, 2**31 - 1)
        tunneled = cfg.mode.value in ("tunnels", "tunneled")
        with status("col-split FL walk", logger):
            if wide and tunneled:
                # device walker positions are int32; the host int64 walk
                # covers the n >= 2**31 lane
                from colbwt_tpu.ops.colsplit_jax import col_split_tunneled_numpy
                mpos, mids, mhts = col_split_tunneled_numpy(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.id_bits)
            elif wide:
                from colbwt_tpu.ops.colsplit_jax import col_split_all_numpy
                mpos, mids, mhts = col_split_all_numpy(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.id_bits)
            elif fl.n >= _DEVICE_MIN_N or ml.size > 256:
                from colbwt_tpu.ops.colsplit_jax import col_split_jax
                mpos, mids, mhts = col_split_jax(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.mode.value,
                    cfg.id_bits)
            else:
                mpos, mids, mhts = O.col_split_oracle(
                    fl, ml, mp, num_docs, cfg.split_rate, cfg.mode.value,
                    cfg.id_bits)
        with status("find_col_runs sweep", logger):
            if mhts.size and (mhts == mhts[0]).all():
                # tunneled mode: uniform heights -> vectorized FIFO sweep
                from colbwt_tpu.ops.colruns_vec import find_col_runs_uniform
                bits, ids = find_col_runs_uniform(mpos, mids, int(mhts[0]),
                                                  fl.l_heads, fl.n)
            else:
                # All mode: mixed heights -> vectorized event-stream sweep
                from colbwt_tpu.ops.colruns_vec import find_col_runs_mixed
                bits, ids = find_col_runs_mixed(mpos, mids, mhts,
                                                fl.l_heads, fl.n)
        bv = np.zeros(fl.n, dtype=bool)
        bv[bits] = True
        F.write_sdsl_bit_vector(outs[0], bv)
        F.write_col_ids(outs[1], ids, (cfg.id_bits + 7) // 8, cfg.id_bits)
        logger.info("[colsplit] marks=%d col_runs bits=%d", mpos.size, bits.size)
    except Exception:
        _cleanup(outs)
        raise


def stage_index(prefix: str, cfg: ColBwtConfig, logger):
    """Assemble the queryable run-split index (the movi-split build role)."""
    fa = f"{prefix}.fa"
    out = Path(f"{prefix}.colpml.npz")
    col_pml_out = Path(f"{fa}.col_pml")
    if _exists(out, col_pml_out) and not cfg.force:
        logger.info("[index] exists, skipping")
        return
    try:
        heads, lens = F.read_rlbwt(fa, cfg.rw_bytes)
        thr = F.read_thresholds_file(f"{fa}.thr_pos", cfg.rw_bytes)
        bv = F.read_sdsl_bit_vector(f"{fa}.col_runs")
        ids = F.read_col_ids(f"{fa}.col_ids", (cfg.id_bits + 7) // 8)
        bits = np.flatnonzero(bv)
        with status("col_pml table", logger):
            tbl = O.build_col_pml(heads, lens, bits, ids.astype(np.int64),
                                  thr.astype(np.int64))
        # the reference alt-path interchange file (packed col_thr rows,
        # include/col_bwt.hpp:360-380) — written from the unsplit table
        F.write_col_pml_file(
            f"{fa}.col_pml", bwt_r=int(tbl.bwt_r), n=int(tbl.n),
            char=tbl.char, idx=tbl.idx,
            dest_interval=tbl.dest_interval, dest_offset=tbl.dest_offset,
            col_id=tbl.col_id, threshold=tbl.threshold)
        # Run splitting (the movi-split fast-forward bound) only serves the
        # mega/fused engines; the positional-automaton engine needs no ff
        # bound, so skip the O(rounds * r log r) splitting when pos tables
        # are viable for this index.  Wide tables always split (run-length
        # cap for the int32-limb layout).
        from colbwt_tpu.utils.hbm import resolve_pos_budget

        wide = tbl.n > cfg.wide_n_limit
        sigma = int(np.unique(O.normalize_heads(tbl.char)).size)
        pos_viable = (not wide and tbl.n < 2**28
                      and (sigma + 1) * tbl.n * 8
                      <= resolve_pos_budget(cfg.pos_hbm_budget))
        split = (wide or cfg.run_split == "always"
                 or (cfg.run_split == "auto" and not pos_viable))
        if split:
            with status("run splitting", logger):
                # the wide engine is mega-row based: needs ff_bound >= 2
                ffb = max(cfg.ff_bound, 2) if wide else cfg.ff_bound
                index = ColPmlIndex.build(tbl, ff_bound=ffb, wide=wide or None)
        else:
            logger.info("[index] pos engine viable: skipping run splitting")
            index = ColPmlIndex.from_table(tbl)
        index.save(out.with_suffix(""))
        logger.info("[index] r=%d (bwt_r=%d) ff_bound=%d bytes=%d",
                    index.r, index.bwt_r, index.ff_bound, index.nbytes())
    except Exception:
        _cleanup([out, col_pml_out])
        raise


def stage_prewarm(prefix: str, cfg: ColBwtConfig, logger) -> None:
    """Make the shipped index query-ready at build exit (the reference's
    Movi index is, scripts/col-bwt.py:176-189): instantiate the chosen
    engine — building and, per the cache policy, persisting its device
    tables — and compile its hot query program shapes into the persistent
    XLA cache.  A fresh process's first real query then pays a cache load
    instead of a cold compile.  Disable with --no-prewarm."""
    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.pipeline.engines import QueryEngines

    t0 = time.perf_counter()
    index = ColPmlIndex.load(f"{prefix}.colpml.npz")
    eng = QueryEngines(index, cfg, total_chars=None,
                       table_dir=f"{prefix}.tables")
    for ev in eng.cache_events:
        logger.info("[prewarm] table cache: %s", ev)
    alph = index.alphabet[index.alphabet > 1]
    byte = int(alph[0]) if alph.size else 0x41
    # the two batch shapes real queries hit: the one-shot default and the
    # streaming default (cli.py); padded 256 is the 150 bp read bucket
    for bs in sorted({cfg.batch_size, 32768}):
        t1 = time.perf_counter()
        dummy = [bytes([byte]) * 150] * bs
        p, c, _, _ = eng.dispatch(dummy, 256)
        p.block_until_ready()  # compile + execute; results stay on device
        if c is not None:
            c.block_until_ready()
        del p, c
        logger.info("[prewarm] query program B=%d compiled+cached in %.1fs",
                    bs, time.perf_counter() - t1)
    if eng.name != "xla" and index.r < (1 << 24):
        # small one-shot workloads select the compact xla engine instead
        # (QueryEngines weighs table cost against workload size) — compile
        # that program too so either first query hits the cache.  Skipped
        # for huge indexes, where the warm-up transfer would dominate.
        import dataclasses

        t1 = time.perf_counter()
        eng2 = QueryEngines(index, dataclasses.replace(cfg, engine="xla"),
                            total_chars=None, table_dir=None)
        p, c, _, _ = eng2.dispatch([bytes([byte]) * 150] * cfg.batch_size,
                                   256)
        p.block_until_ready()
        if c is not None:
            c.block_until_ready()
        del p, c, eng2
        logger.info("[prewarm] xla program B=%d compiled+cached in %.1fs",
                    cfg.batch_size, time.perf_counter() - t1)
    logger.info("[prewarm] engine %s ready in %.1fs", eng.name,
                time.perf_counter() - t0)


def build_pipeline(fastas: list[str], output: str,
                   cfg: ColBwtConfig | None = None,
                   filelist: str | None = None) -> ColPmlIndex:
    """`col-bwt build` (scripts/col-bwt.py:94-189): run every stage with
    skipping + cleanup, return the loaded index."""
    cfg = cfg or ColBwtConfig()
    logger = get_logger("colbwt.build", cfg.verbose)
    timer = Timer().start()
    Path(output).parent.mkdir(parents=True, exist_ok=True)

    docs = load_documents(fastas, filelist, cfg.rev_comp)
    logger.info("documents: %d (total %d bases)", len(docs),
                sum(len(d) for d in docs))
    stage_mums(docs, output, cfg, logger)
    stage_bwt(output, cfg, logger)
    stage_colsplit(output, cfg, logger)
    stage_index(output, cfg, logger)
    if cfg.prewarm:
        stage_prewarm(output, cfg, logger)

    if not cfg.keep_temp:
        fa = f"{output}.fa"
        _cleanup([Path(f"{fa}.bwt")])
    timer.end()
    logger.info("build complete in %.2fs", timer.start_duration)
    return ColPmlIndex.load(f"{output}.colpml.npz")


def query_pipeline(index_prefix: str, pattern_file: str,
                   cfg: ColBwtConfig | None = None,
                   write_text: bool = False,
                   write_text_long: bool = False) -> tuple[list, list, list]:
    """`col-bwt query` (scripts/col-bwt.py:191-198): batched device queries,
    outputs PATTERN.split.pml.bin/.split.cid.bin (+ optional .pml/.cid text,
    the src/pml_query.cpp:74-90 format)."""
    from colbwt_tpu.pipeline.engines import QueryEngines

    cfg = cfg or ColBwtConfig()
    logger = get_logger("colbwt.query", cfg.verbose)
    timer = Timer().start()

    index = ColPmlIndex.load(f"{index_prefix}.colpml.npz")
    names: list[str] = []
    reads: list[bytes] = []
    for rec in read_fasta(pattern_file):
        names.append(rec.name)
        reads.append(rec.seq.upper())
    logger.info("querying %d reads against r=%d index", len(reads), index.r)
    if len(reads) >= 1_000_000:
        logger.warning(
            "%d reads held in host memory by the one-shot query path — "
            "use --stream for bounded-memory streaming at this scale",
            len(reads))

    total_chars = sum(len(rd) for rd in reads)
    eng = QueryEngines(index, cfg, total_chars,
                       table_dir=f"{index_prefix}.tables")
    logger.info("engine: %s", eng.name)
    for ev in eng.cache_events:
        logger.info("table cache: %s", ev)

    # bucket by padded length to bound recompilation while avoiding wasted
    # steps; long reads stream in chunks with carried state (the -l mode,
    # src/pml_query.cpp:126-128)
    pmls: list[np.ndarray] = [None] * len(reads)  # type: ignore[list-item]
    cids: list[np.ndarray] = [None] * len(reads)  # type: ignore[list-item]
    buckets: dict[int, list[int]] = {}
    long_idxs: list[int] = []
    for i, rd in enumerate(reads):
        m = max(1, len(rd))
        if eng.supports_long_streaming() and m > cfg.long_read_len:
            long_idxs.append(i)
            continue
        padded = 1 << (m - 1).bit_length()
        buckets.setdefault(padded, []).append(i)
    # phase 1: dispatch every bucketed batch (async); phase 2: materialize
    pending = []
    for padded, idxs in sorted(buckets.items()):
        for off in range(0, len(idxs), cfg.batch_size):
            chunk = idxs[off:off + cfg.batch_size]
            pending.append(
                (chunk, eng.dispatch([reads[i] for i in chunk], padded)))
    for chunk, result in pending:
        p, c, lens = QueryEngines.materialize(result)
        width = p.shape[1]  # may exceed the bucket (pos pads to k-multiple)
        for j, i in enumerate(chunk):
            m = int(lens[j])
            pmls[i] = p[j, width - m:]
            cids[i] = c[j, width - m:]
    for off in range(0, len(long_idxs), max(1, cfg.batch_size // 16)):
        chunk = long_idxs[off:off + max(1, cfg.batch_size // 16)]
        p, c = eng.query_long_reads([reads[i] for i in chunk])
        for j, i in enumerate(chunk):
            pmls[i] = p[j]
            cids[i] = c[j]

    write_pml_cid_binary(f"{pattern_file}.split.pml.bin",
                         f"{pattern_file}.split.cid.bin", names, pmls, cids)
    if write_text:
        write_pml_cid_text(f"{pattern_file}.pml", f"{pattern_file}.cid",
                           names, pmls, cids)
    if write_text_long:
        # the -l streaming text mode (src/pml_query.cpp:126-128)
        from colbwt_tpu.io.pml_out import write_pml_cid_text_long

        write_pml_cid_text_long(f"{pattern_file}.pml", f"{pattern_file}.cid",
                                names, pmls, cids)
    timer.end()
    logger.info("query complete in %.2fs (%.0f reads/s)",
                timer.start_duration,
                len(reads) / max(timer.start_duration, 1e-9))
    return names, pmls, cids
