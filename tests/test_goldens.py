"""Checked-in toy-config goldens (tests/goldens/): the full pipeline must
reproduce them byte-for-byte, and the oracle and native C++ engine must
agree on them independently.  These pin the query semantics so any drift
(threshold tie-breaks, CID sampling point, id binning) is caught against
committed bytes, not parity-with-self."""

from pathlib import Path

import numpy as np
import pytest

from colbwt_tpu.io import formats as F
from colbwt_tpu.io.fasta import read_fasta
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.pipeline import build_pipeline, query_pipeline
from colbwt_tpu.utils.config import ColBwtConfig

GOLD = Path(__file__).parent / "goldens"


def test_toy_config_matches_goldens(tmp_path):
    import shutil

    for f in ("seq1.fa", "seq2.fa", "pattern.fa"):
        shutil.copy(GOLD / f, tmp_path / f)
    cfg = ColBwtConfig(min_mum=20, split_rate=10, rev_comp=True,
                       keep_temp=True)
    build_pipeline([str(tmp_path / "seq1.fa"), str(tmp_path / "seq2.fa")],
                   str(tmp_path / "toy"), cfg)
    query_pipeline(str(tmp_path / "toy"), str(tmp_path / "pattern.fa"),
                   cfg, write_text=True)
    assert (tmp_path / "pattern.fa.pml").read_bytes() == \
        (GOLD / "pattern.fa.pml.golden").read_bytes()
    assert (tmp_path / "pattern.fa.cid").read_bytes() == \
        (GOLD / "pattern.fa.cid.golden").read_bytes()


def test_goldens_oracle_and_native_agree(tmp_path):
    import shutil

    from colbwt_tpu.io import native

    if not native.available():
        pytest.skip("native helpers not built")
    for f in ("seq1.fa", "seq2.fa", "pattern.fa"):
        shutil.copy(GOLD / f, tmp_path / f)
    cfg = ColBwtConfig(min_mum=20, split_rate=10, rev_comp=True,
                       keep_temp=True)
    build_pipeline([str(tmp_path / "seq1.fa"), str(tmp_path / "seq2.fa")],
                   str(tmp_path / "toy"), cfg)
    heads, lens = F.read_rlbwt(tmp_path / "toy.fa")
    thr = F.read_thresholds_file(tmp_path / "toy.fa.thr_pos")
    bv = F.read_sdsl_bit_vector(tmp_path / "toy.fa.col_runs")
    ids = F.read_col_ids(tmp_path / "toy.fa.col_ids")
    tbl = O.build_col_pml(heads, lens, np.flatnonzero(bv),
                          ids.astype(np.int64), thr.astype(np.int64))
    reads = [r.seq for r in read_fasta(GOLD / "pattern.fa")]
    pml_c, cid_c = native.query_pml_serial(tbl, reads)

    gp = (GOLD / "pattern.fa.pml.golden").read_text().splitlines()
    gc = (GOLD / "pattern.fa.cid.golden").read_text().splitlines()
    for j in range(len(reads)):
        np.testing.assert_array_equal(
            pml_c[j], np.array([int(v) for v in gp[1 + 2 * j].split()]))
        np.testing.assert_array_equal(
            cid_c[j], np.array([int(v) for v in gc[1 + 2 * j].split()]))
