"""Regression tests for the round-1 code-review findings."""

import numpy as np
import pytest

from colbwt_tpu.cli import main as cli_main
from colbwt_tpu.io import formats as F
from colbwt_tpu.io.fasta import FastaRecord, write_fasta
from colbwt_tpu.io.pml_out import read_pml_cid_binary
from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_fused, query_mega, query_xla
from colbwt_tpu.ops.run_split import max_ff_span, split_runs_bounded_ff
from colbwt_tpu.pipeline import build_pipeline, query_pipeline
from colbwt_tpu.utils.config import ColBwtConfig
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads


def _self_overlap_docs(rng):
    """Docs with a shared non-MUM repeat (occurs twice per doc): its BWT run
    survives col-split and its LF image overlaps itself."""
    u1 = bytes(rng.choice(list(b"ACGT"), 200).astype("uint8"))
    u2 = bytes(rng.choice(list(b"ACGT"), 200).astype("uint8"))
    rep = b"G" * 4000
    return [u1 + rep + u2 + rep, u2 + rep + u1 + rep]


def test_run_split_best_effort_on_self_overlap(rng):
    """Previously raised 'did not converge'; now returns the achieved bound
    and queries stay exact."""
    docs = _self_overlap_docs(rng)
    tbl, _ = build_index(docs, min_mum=30)
    split = split_runs_bounded_ff(tbl, 2)  # must not raise
    achieved = max_ff_span(split)
    assert achieved >= 2
    index = ColPmlIndex.build(tbl, ff_bound=2)
    assert index.ff_bound == achieved
    reads = [docs[0][100:160], b"G" * 50, docs[1][4100:4200]]
    pmls, cids = query_mega.query_batch(index, reads)
    for read, pml, cid in zip(reads, pmls, cids):
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(pml, ep)
        np.testing.assert_array_equal(cid, ec)


def test_build_pipeline_self_overlap(tmp_path, rng):
    """End-to-end build on the repeat-heavy collection (previously crashed)."""
    docs = _self_overlap_docs(rng)
    for i, d in enumerate(docs):
        write_fasta(tmp_path / f"s{i}.fa", [FastaRecord(f"s{i}", d)])
    index = build_pipeline([str(tmp_path / "s0.fa"), str(tmp_path / "s1.fa")],
                           str(tmp_path / "idx"),
                           ColBwtConfig(min_mum=30, split_rate=5,
                                        run_split="always"))
    assert index.ff_bound >= 2
    # run_split="auto" skips the splitter when pos tables are viable
    index2 = build_pipeline([str(tmp_path / "s0.fa"), str(tmp_path / "s1.fa")],
                            str(tmp_path / "idx2"),
                            ColBwtConfig(min_mum=30, split_rate=5))
    assert index2.ff_bound == 0


def test_id_bits_16_roundtrip(tmp_path, rng):
    """stage_index must read .col_ids at the configured width."""
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 2, mutate_from=base)
    for i, d in enumerate(docs):
        write_fasta(tmp_path / f"s{i}.fa", [FastaRecord(f"s{i}", d)])
    cfg = ColBwtConfig(min_mum=10, split_rate=2, id_bits=16)
    build_pipeline([str(tmp_path / "s0.fa"), str(tmp_path / "s1.fa")],
                   str(tmp_path / "w"), cfg)
    # ids file is 2 bytes per set bit
    bv = F.read_sdsl_bit_vector(tmp_path / "w.fa.col_runs")
    ids_file = (tmp_path / "w.fa.col_ids").stat().st_size
    assert ids_file == 2 * int(bv.sum())
    # queries against the oracle built at the same width
    heads, lens = F.read_rlbwt(tmp_path / "w.fa")
    thr = F.read_thresholds_file(tmp_path / "w.fa.thr_pos")
    ids = F.read_col_ids(tmp_path / "w.fa.col_ids", 2)
    tbl = O.build_col_pml(heads, lens, np.flatnonzero(bv),
                          ids.astype(np.int64), thr.astype(np.int64))
    write_fasta(tmp_path / "p.fa", [FastaRecord("p", docs[0][50:110])])
    names, pmls, cids = query_pipeline(str(tmp_path / "w"),
                                       str(tmp_path / "p.fa"), cfg)
    ep, ec = O.query_pml_oracle(tbl, docs[0][50:110])
    np.testing.assert_array_equal(pmls[0], ep)
    np.testing.assert_array_equal(cids[0], ec)


def test_succ_kept_when_pred_missing_external_thresholds(rng):
    """Doctored thresholds make (pos < thr) true at a first-c-run with no
    predecessor: the reference keeps the successor — mega/fused must match
    the oracle (previously fell back to LF-from-current)."""
    docs = random_docs(rng, 2, lo=80, hi=150)
    tbl, _ = build_index(docs)
    # inflate every first-c-run threshold so pos < thr triggers there
    thr = np.asarray(tbl.threshold).copy()
    seen = set()
    for i in range(tbl.r):
        c = int(tbl.char[i])
        if c not in seen:
            seen.add(c)
            thr[i] = tbl.n - 1
    tbl.threshold = thr
    index = ColPmlIndex.build(tbl, ff_bound=2)
    reads = make_reads(rng, docs, 16) + [b"ACGTACGT" * 4]
    p_m, c_m = query_mega.query_batch(index, reads)
    p_f, c_f = query_fused.query_batch(ColPmlIndex.build(tbl, ff_bound=4), reads)
    for read, pm, cm, pf, cf in zip(reads, p_m, c_m, p_f, c_f):
        ep, ec = O.query_pml_oracle(tbl, read)
        np.testing.assert_array_equal(pm, ep, err_msg=f"mega PML {read!r}")
        np.testing.assert_array_equal(cm, ec, err_msg=f"mega CID {read!r}")
        np.testing.assert_array_equal(pf, ep, err_msg=f"fused PML {read!r}")
        np.testing.assert_array_equal(cf, ec, err_msg=f"fused CID {read!r}")


def test_mega_accepts_larger_bounds(rng):
    docs = random_docs(rng, 2, lo=60, hi=120)
    tbl, _ = build_index(docs)
    i4 = ColPmlIndex.build(tbl, ff_bound=4)
    reads = make_reads(rng, docs, 8)
    p1, c1 = query_mega.query_batch(i4, reads)
    p2, c2 = query_xla.query_batch(i4, reads)
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a, b)


def test_engine_fused_config_routes(tmp_path, rng):
    base = bytes(rng.choice(list(b"ACGT"), 250).astype("uint8"))
    docs = random_docs(rng, 2, mutate_from=base)
    for i, d in enumerate(docs):
        write_fasta(tmp_path / f"s{i}.fa", [FastaRecord(f"s{i}", d)])
    cfg = ColBwtConfig(min_mum=10, engine="fused")
    build_pipeline([str(tmp_path / "s0.fa"), str(tmp_path / "s1.fa")],
                   str(tmp_path / "f"), cfg)
    write_fasta(tmp_path / "p.fa", [FastaRecord("p", docs[0][40:100])])
    names, pmls, cids = query_pipeline(str(tmp_path / "f"),
                                       str(tmp_path / "p.fa"), cfg)
    heads, lens = F.read_rlbwt(tmp_path / "f.fa")
    thr = F.read_thresholds_file(tmp_path / "f.fa.thr_pos")
    bv = F.read_sdsl_bit_vector(tmp_path / "f.fa.col_runs")
    ids = F.read_col_ids(tmp_path / "f.fa.col_ids")
    tbl = O.build_col_pml(heads, lens, np.flatnonzero(bv),
                          ids.astype(np.int64), thr.astype(np.int64))
    ep, ec = O.query_pml_oracle(tbl, docs[0][40:100])
    np.testing.assert_array_equal(pmls[0], ep)


def test_clean_removes_col_pml(tmp_path, rng):
    base = bytes(rng.choice(list(b"ACGT"), 200).astype("uint8"))
    docs = random_docs(rng, 2, mutate_from=base)
    for i, d in enumerate(docs):
        write_fasta(tmp_path / f"s{i}.fa", [FastaRecord(f"s{i}", d)])
    cli_main(["build", "-o", str(tmp_path / "c"), "-l", "10", "--clean",
              str(tmp_path / "s0.fa"), str(tmp_path / "s1.fa")])
    assert not (tmp_path / "c.fa.col_pml").exists()
    assert (tmp_path / "c.colpml.npz").exists()


def test_resolve_pos_budget():
    """Budget auto-derivation: explicit value wins; the CPU backend gets the
    named CPU budget; a GPU maps to a fraction of its allocator limit; an
    accelerator without a limit is an error, never a silent default."""
    from colbwt_tpu.utils.hbm import (CPU_POS_BUDGET, _RESERVE_FRACTION,
                                      device_memory_bytes, resolve_pos_budget)

    assert resolve_pos_budget(5 << 30) == 5 << 30
    # under the test conftest we are on CPU: no device memory to discover
    assert device_memory_bytes() is None
    assert resolve_pos_budget(0) == CPU_POS_BUDGET

    class FakeGpu:
        device_kind = "NVIDIA H100 80GB HBM3"
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 60 << 30, "bytes_in_use": 0}

    assert device_memory_bytes(FakeGpu()) == 60 << 30
    assert resolve_pos_budget(0, FakeGpu()) == int((60 << 30)
                                                   * _RESERVE_FRACTION)
    # an explicit budget never consults the device
    assert resolve_pos_budget(7, FakeGpu()) == 7

    class FakeNoStats(FakeGpu):
        def memory_stats(self):
            return None

    with pytest.raises(RuntimeError, match="bytes_limit"):
        device_memory_bytes(FakeNoStats())
    with pytest.raises(RuntimeError, match="bytes_limit"):
        resolve_pos_budget(0, FakeNoStats())


def test_packed_planes_guard_wide_cids(rng):
    """Indexes whose col ids exceed 8 bits (id_bits > 8 extension) must not
    go through the (pml << 8 | cid) packed planes: dispatch falls back to
    exact two-plane outputs, and the wide table build refuses outright."""
    import pytest

    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.ops import query_mega_wide
    from colbwt_tpu.pipeline.engines import QueryEngines
    from colbwt_tpu.utils.config import ColBwtConfig
    from tests.test_query_xla import build_index, make_reads
    from tests.conftest import random_docs

    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    # force a >8-bit cid (as an id_bits=16 build would produce)
    index.col_id = index.col_id.copy()
    index.col_id[index.col_id.argmax()] = 300
    eng = QueryEngines(index, ColBwtConfig(engine="mega"),
                       total_chars=10_000_000)
    assert eng.use_mega and not eng._cid8
    reads = make_reads(rng, docs, 4)
    p, c, lens = QueryEngines.materialize(eng.dispatch(reads, 64))
    assert c is not None  # two-plane path, no truncating pack
    assert int(p.max()) >= 0

    wtbl = build_index(docs)[0]
    widx = ColPmlIndex.build(wtbl, ff_bound=2, wide=True)
    widx.col_id = widx.col_id.copy()
    widx.col_id[0] = 300
    with pytest.raises(ValueError, match="col ids"):
        query_mega_wide.build_mega_table_wide(widx)
