"""Sharded query engine on the 8-device virtual CPU mesh: results must be
identical to the single-device engine for every dp×ip layout."""

import numpy as np
import pytest
import jax

from colbwt_tpu.models.index import ColPmlIndex
from colbwt_tpu.ops import oracle as O
from colbwt_tpu.ops import query_xla
from colbwt_tpu.parallel import make_mesh, query_batch_sharded
from tests.conftest import random_docs
from tests.test_query_xla import build_index, make_reads


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(42)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index = ColPmlIndex.build(tbl, ff_bound=4)
    reads = make_reads(rng, docs, 24)
    ref_p, ref_c = query_xla.query_batch(index, reads)
    return index, reads, ref_p, ref_c


@pytest.mark.parametrize("dp,ip", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
def test_sharded_matches_local(setup, dp, ip):
    index, reads, ref_p, ref_c = setup
    mesh = make_mesh(dp, ip)
    p, c = query_batch_sharded(index, reads, mesh=mesh)
    for a, b in zip(p[:len(reads)], ref_p):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c[:len(reads)], ref_c):
        np.testing.assert_array_equal(a, b)


def test_sharded_pads_ragged_batch(setup):
    index, reads, ref_p, ref_c = setup
    mesh = make_mesh(8, 1)
    # 13 reads does not divide 8 -> padding lanes must not disturb results
    p, c = query_batch_sharded(index, reads[:13], mesh=mesh)
    for a, b in zip(p[:13], ref_p[:13]):
        np.testing.assert_array_equal(a, b)


def test_sharded_requires_split_index(setup):
    index, reads, *_ = setup
    unsplit = ColPmlIndex(
        **{f: getattr(index, f) for f in (
            "char", "idx", "length", "dest_interval", "dest_offset",
            "col_id", "threshold", "pred_jump", "succ_jump", "alphabet",
            "char_map", "n", "r", "bwt_r")}, ff_bound=0)
    with pytest.raises(ValueError, match="run-split"):
        query_batch_sharded(unsplit, reads[:8], mesh=make_mesh(2, 2))


def test_mesh_validation():
    with pytest.raises(ValueError, match="devices"):
        make_mesh(16, 2)


@pytest.mark.parametrize("dp,ip", [(4, 2), (1, 8), (2, 2), (8, 1)])
def test_sharded_mega_matches_local(setup, dp, ip):
    from colbwt_tpu.ops import run_split
    from colbwt_tpu.parallel.query_sharded_mega import query_batch_sharded_mega
    from tests.test_query_xla import build_index

    rng = np.random.default_rng(77)
    base = bytes(rng.choice(list(b"ACGT"), 300).astype("uint8"))
    from tests.conftest import random_docs
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    index2 = ColPmlIndex.build(tbl, ff_bound=2)
    from tests.test_query_xla import make_reads
    reads = make_reads(rng, docs, 17)  # ragged vs dp

    from colbwt_tpu.ops import query_mega
    ref_p, ref_c = query_mega.query_batch(index2, reads)
    mesh = make_mesh(dp, ip)
    p, c = query_batch_sharded_mega(index2, reads, mesh=mesh)
    for a, b in zip(p[:len(reads)], ref_p):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c[:len(reads)], ref_c):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dp,ip", [(4, 2), (1, 8), (2, 2), (8, 1)])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_sharded_pos_matches_local(setup, dp, ip, k):
    from colbwt_tpu.ops import query_pos
    from colbwt_tpu.parallel.query_sharded_pos import query_batch_sharded_pos

    index, reads, _, _ = setup
    reads = reads[:17]  # ragged vs dp
    ref_p, ref_c = query_pos.query_batch(index, reads, k=k)
    mesh = make_mesh(dp, ip)
    p, c = query_batch_sharded_pos(index, reads, mesh=mesh, k=k)
    for a, b in zip(p[:len(reads)], ref_p):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c[:len(reads)], ref_c):
        np.testing.assert_array_equal(a, b)


def test_sharded_pos_choose_k_relaxes_with_ip(setup):
    from colbwt_tpu.parallel.query_sharded_pos import choose_k_sharded

    index, _, _, _ = setup
    A = index.sigma + 1
    one_shard_k2 = (A ** 2) * index.n * 8
    # a budget that fits k=2 only when halved per shard
    assert choose_k_sharded(index, 1, one_shard_k2 // 2 + A * index.n * 8) == 1
    assert choose_k_sharded(index, 2, one_shard_k2 // 2 + A * index.n * 8) >= 2


# ---------------------------------------------------------------------------
# wide sharded engine + router


@pytest.fixture(scope="module")
def wide_setup():
    from tests.test_query_wide import scale_table

    rng = np.random.default_rng(0xB17)
    base = bytes(rng.choice(list(b"ACGT"), 250).astype("uint8"))
    docs = random_docs(rng, 3, mutate_from=base)
    tbl, _ = build_index(docs)
    big = scale_table(tbl, 2**23)
    assert big.n > 2**31
    index = ColPmlIndex.build(big, ff_bound=2)
    assert index.wide
    reads = make_reads(rng, docs, 24) + [b"NNNNN", b"A"]
    ref = [O.query_pml_oracle(big, r) for r in reads]
    return index, reads, [p for p, _ in ref], [c for _, c in ref]


@pytest.mark.parametrize("dp,ip", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_mega_wide_matches_oracle(wide_setup, dp, ip):
    from colbwt_tpu.parallel.query_sharded_mega_wide import (
        query_batch_sharded_mega_wide)

    index, reads, ref_p, ref_c = wide_setup
    mesh = make_mesh(dp, ip)
    p, c = query_batch_sharded_mega_wide(index, reads, mesh=mesh)
    for a, b in zip(p[:len(reads)], ref_p):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c[:len(reads)], ref_c):
        np.testing.assert_array_equal(a, b)


def test_sharded_mega_wide_long_reads(wide_setup):
    from colbwt_tpu.parallel.query_sharded_mega_wide import (
        query_batch_sharded_mega_wide, query_long_reads_sharded_mega_wide)

    index, reads, *_ = wide_setup
    rng = np.random.default_rng(3)
    long_reads = [bytes(rng.choice(list(b"ACGTN"), 300).astype("uint8")),
                  reads[0] * 4, reads[1][:33]]
    mesh = make_mesh(4, 2)
    p1, c1 = query_batch_sharded_mega_wide(index, long_reads, mesh=mesh)
    p2, c2 = query_long_reads_sharded_mega_wide(index, long_reads,
                                                mesh=mesh, chunk=64)
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c1, c2):
        np.testing.assert_array_equal(a, b)


def test_router_routes_wide(wide_setup, setup):
    from colbwt_tpu.parallel import (choose_sharded_engine,
                                     query_batch_sharded_auto)

    wide_index, wide_reads, wp, wc = wide_setup
    assert choose_sharded_engine(wide_index, ip=2) == "sharded-mega-wide"
    mesh = make_mesh(4, 2)
    p, c, name = query_batch_sharded_auto(wide_index, wide_reads, mesh=mesh)
    assert name == "sharded-mega-wide"
    for a, b in zip(p[:len(wide_reads)], wp):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(c[:len(wide_reads)], wc):
        np.testing.assert_array_equal(a, b)

    narrow_index, reads, ref_p, ref_c = setup
    name = choose_sharded_engine(narrow_index, ip=2)
    assert name in ("sharded-pos", "sharded-mega")
    p, c, used = query_batch_sharded_auto(narrow_index, reads, mesh=mesh)
    assert used == name
    for a, b in zip(p[:len(reads)], ref_p):
        np.testing.assert_array_equal(a, b)


def test_shard_mega_wide_slice_placement_matches_host_table(wide_setup):
    """The on-demand per-slice placement (host peak O(table/ip)) must equal
    placing the prebuilt host table, for every ip split."""
    from colbwt_tpu.ops import query_mega_wide as QW
    from colbwt_tpu.parallel.query_sharded_mega_wide import shard_mega_wide

    index, _, _, _ = wide_setup
    host = QW.build_mega_rows_wide_host(index)
    for dp, ip in ((2, 4), (1, 8), (8, 1)):
        mesh = make_mesh(dp, ip)
        st_cb = shard_mega_wide(index, mesh)
        st_host = shard_mega_wide(index, mesh, mega_host=host)
        np.testing.assert_array_equal(np.asarray(st_cb["mega"]),
                                      np.asarray(st_host["mega"]))


def test_host_lean_wide_slices_cross_char_blocks():
    """The host-lean per-slice assembly (shard_mega_wide's default path,
    O(table/ip) host peak) must equal the prebuilt full table even when
    every device's slice spans multiple char blocks of the (sigma+1)*r
    row space — the placement real pangenome-scale tables hit."""
    from colbwt_tpu.ops import query_mega_wide as QW
    from colbwt_tpu.parallel.query_sharded_mega_wide import (
        query_batch_sharded_mega_wide, shard_mega_wide)

    rng = np.random.default_rng(0xD15C)
    # a single random document: dense runs, r in the tens of thousands
    doc = rng.choice(np.frombuffer(b"ACGT", np.uint8), 30_000).tobytes()
    tbl, _ = build_index([doc, doc[:17_000] + doc[19_000:]])
    index = ColPmlIndex.build(tbl, ff_bound=2, wide=True)
    assert index.wide and index.r > 20_000
    ip = 4
    mesh = make_mesh(2, ip)
    rows = (index.sigma + 1) * index.r
    assert rows // ip > index.r  # each slice crosses >= 1 char-block edge

    st = shard_mega_wide(index, mesh)  # host-lean assembly
    full = QW.build_mega_rows_wide_host(index)  # the oracle table
    got = np.asarray(st["mega"])
    np.testing.assert_array_equal(got[:rows], full)
    assert not got[rows:].any()  # ip padding rows stay zero

    reads = [doc[int(rng.integers(0, 29_000)):][:60] for _ in range(16)]
    p, c = query_batch_sharded_mega_wide(index, reads, mesh=mesh)
    for j, rd in enumerate(reads):
        p_ref, c_ref = O.query_pml_oracle(tbl, rd)
        np.testing.assert_array_equal(p[j], p_ref, err_msg=f"read {j}")
        np.testing.assert_array_equal(c[j], c_ref, err_msg=f"read {j}")
