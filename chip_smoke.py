#!/usr/bin/env python3
"""Smoke run of colbwt-tpu on an NVIDIA GPU: the main path and every query
engine, checked exactly against the repository's references.

    python3 chip_smoke.py [--out DIR] [--seed N]
    python3 chip_smoke.py --four-cards [--out DIR] [--seed N]

One process drives the card.  Phases, in order (any failure exits non-zero):

1. device      - JAX platform, device kind and count, JAX version, the
                 card's name and power limit (nvidia-smi), allocator limit.
2. main path   - 8 genomes of 5 Mbp (the shape of config #2 in
                 BASELINE.json) built through `col-bwt build`, then 100,000
                 gzipped-FASTQ reads of 150 bp (~1% carry an N) streamed
                 through `col-bwt query --stream`; sampled output records are
                 compared with the single-core C++ engine on the unsplit table.
3. engines     - pos (ACGT and general keys), mega, fused, xla and mega-wide
                 on one 8192-read batch of a 4 x 1 Mbp collection, plus the
                 long-read carried-state path of pos, mega and mega-wide, all
                 compared with the C++ engine and the NumPy oracle.

With --four-cards only the sharded engines run, on the dp x ip meshes 4x1,
2x2 and 1x4 over four GPUs, each compared with the one-card engine.

Data is generated from --seed.  Everything written goes under --out.  The
last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}; it is
printed only when every phase passed.  Without a GPU the script exits
non-zero before any phase.
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

MAIN_DOCS, MAIN_DOC_LEN = 8, 5_000_000
MAIN_READS, READ_LEN = 100_000, 150
SAMPLE_RECORDS = 1024
ENG_DOCS, ENG_DOC_LEN, ENG_BATCH = 4, 1_000_000, 8192
LONG_READS, LONG_LEN = 32, 5_000
MUT_RATE = 0.02      # substituted positions per genome (bench.py's shape)
N_READ_RATE = 0.01   # share of reads that carry one N


def info(card: str, msg: str) -> None:
    print(f"info [{card}]: {msg}", flush=True)


# ---------------------------------------------------------------------------
# data, generated from the seed
# ---------------------------------------------------------------------------


def make_genomes(rng: np.random.Generator, n_docs: int, doc_len: int
                 ) -> list[bytes]:
    """One random ancestor and n_docs copies with MUT_RATE substitutions."""
    base = rng.choice(ACGT, doc_len)
    n_mut = int(doc_len * MUT_RATE)
    docs = []
    for _ in range(n_docs):
        a = base.copy()
        a[rng.integers(0, doc_len, n_mut)] = rng.choice(ACGT, n_mut)
        docs.append(a.tobytes())
    return docs


def make_reads(rng: np.random.Generator, docs: list[bytes], n: int,
               length: int, n_rate: float = N_READ_RATE) -> list[bytes]:
    """Reads drawn from the genomes with Illumina-like substitutions (the
    per-base rate rises from 0.1% at the 5' end to 1% at the 3' end); a
    share n_rate of them carry one N."""
    arrs = [np.frombuffer(d, dtype=np.uint8) for d in docs]
    which = rng.integers(0, len(docs), n)
    out = np.empty((n, length), dtype=np.uint8)
    for d, a in enumerate(arrs):
        rows = np.flatnonzero(which == d)
        starts = rng.integers(0, a.size - length + 1, rows.size)
        out[rows] = a[starts[:, None] + np.arange(length)]
    err = rng.random((n, length)) < np.linspace(0.001, 0.01, length)
    out[err] = rng.choice(ACGT, int(err.sum()))
    n_rows = np.flatnonzero(rng.random(n) < n_rate)
    out[n_rows, rng.integers(0, length, n_rows.size)] = ord("N")
    return [row.tobytes() for row in out]


def write_fastq_gz(path: Path, reads: list[bytes]) -> None:
    recs = []
    for i, r in enumerate(reads):
        recs.append(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r)))
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(b"".join(recs))


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


def table_from_artifacts(prefix: str):
    """The unsplit col-pml table from a build's artifacts (the table the
    C++ engine and the oracle query)."""
    from colbwt_tpu.io import formats as F
    from colbwt_tpu.ops import oracle as O

    fa = f"{prefix}.fa"
    heads, lens = F.read_rlbwt(fa)
    thr = F.read_thresholds_file(f"{fa}.thr_pos")
    bv = F.read_sdsl_bit_vector(f"{fa}.col_runs")
    ids = F.read_col_ids(f"{fa}.col_ids")
    return O.build_col_pml(heads, lens, np.flatnonzero(bv),
                           ids.astype(np.int64), thr.astype(np.int64))


def table_from_docs(docs: list[bytes], min_mum: int = 20,
                    split_rate: int = 10):
    """The unsplit col-pml table of a collection, built by the library's
    device construction ops (the bench.py path)."""
    from colbwt_tpu.io import native
    from colbwt_tpu.ops import construct_jax as CJ
    from colbwt_tpu.ops import oracle as O
    from colbwt_tpu.ops.colsplit_jax import col_split_jax

    text, ranks, doc_ids = O.concat_collection(docs)
    if native.available():
        sa = native.suffix_array_sais(ranks)
        lcp = native.lcp_kasai(ranks, sa)
    else:
        sa = O.suffix_array(ranks)
        lcp = O.lcp_kasai(ranks, sa)
    heads, lens = O.rle(O.bwt_from_sa(text, sa))
    fl = O.build_fl_table(heads, lens)
    ml, mp = CJ.find_multi_mums_jax(ranks, sa, lcp, doc_ids, len(docs),
                                    min_mum)
    mpos, mids, mhts = col_split_jax(fl, ml, mp, len(docs), split_rate,
                                     "tunnels")
    bits, ids = O.find_col_runs_oracle(mpos, mids, mhts, fl.l_heads, fl.n)
    thr = CJ.compute_thresholds_jax(heads, lens, lcp)
    return O.build_col_pml(heads, lens, bits, ids, thr)


def cpp_answers(tbl, reads: list[bytes]):
    """The single-core C++ engine's (pml, cid) per read; the NumPy oracle
    where the native library is missing."""
    from colbwt_tpu.io import native

    if native.available():
        return native.query_pml_serial(tbl, reads)
    return oracle_answers(tbl, reads)


def oracle_answers(tbl, reads: list[bytes]):
    from colbwt_tpu.ops import oracle as O

    out = [O.query_pml_oracle(tbl, r) for r in reads]
    return [p for p, _ in out], [c for _, c in out]


def mismatches(got, ref) -> int:
    """Reads whose PML or CID differ anywhere (got, ref: (pmls, cids))."""
    bad = 0
    for gp, gc, rp, rc in zip(got[0], got[1], ref[0], ref[1]):
        if not (np.array_equal(np.asarray(gp, np.int64), rp)
                and np.array_equal(np.asarray(gc, np.int64), rc)):
            bad += 1
    return bad + abs(len(got[0]) - len(ref[0]))


def check(card: str, what: str, got, refs: dict) -> None:
    """Compare one engine's answers with every reference; raise on any
    mismatch."""
    counts = {name: mismatches(got, ref) for name, ref in refs.items()}
    info(card, f"{what}: {len(got[0])} reads, mismatches "
               + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if any(counts.values()):
        raise AssertionError(f"{what}: mismatches {counts}")


def _rows(p, c, lens):
    W = p.shape[1]
    return ([p[j, W - int(lens[j]):] for j in range(len(lens))],
            [c[j, W - int(lens[j]):] for j in range(len(lens))])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def nvidia_smi() -> str:
    """`name, power.limit` of the cards, one line each, as nvidia-smi
    gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def phase_device(card: str) -> None:
    import jax

    from colbwt_tpu.utils.hbm import device_memory_bytes

    d = jax.devices()[0]
    info(card, f"device: platform {d.platform}, kind {d.device_kind!r}, "
               f"count {len(jax.devices())}, jax {jax.__version__}")
    info(card, f"device: allocator bytes_limit {device_memory_bytes(d)}")


class _LogCapture(logging.Handler):
    """Keeps the program's own log messages (stage times, table and
    compile events) so the phase can report them."""

    def __init__(self) -> None:
        super().__init__(logging.DEBUG)
        self.messages: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())


_REPORT = re.compile(r"DONE \(|\[prewarm\]|table cache|compile|"
                     r"build complete|streamed|streaming .* with engine|"
                     r"\[index\]|\[mums\] n=")


def phase_main_path(out: Path, seed: int, card: str,
                    n_docs: int = MAIN_DOCS, doc_len: int = MAIN_DOC_LEN,
                    n_reads: int = MAIN_READS,
                    sample: int = SAMPLE_RECORDS) -> dict:
    """`col-bwt build` then `col-bwt query --stream`, in this process;
    sampled output records against the C++ engine."""
    import jax

    from colbwt_tpu import cli
    from colbwt_tpu.io.fasta import FastaRecord, write_fasta
    from colbwt_tpu.io.pml_out import read_pml_cid_binary

    rng = np.random.default_rng(seed)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    docs = make_genomes(rng, n_docs, doc_len)
    fastas = []
    for i, d in enumerate(docs):
        p = out / f"genome{i}.fa"
        write_fasta(p, [FastaRecord(f"genome{i}", d)])
        fastas.append(str(p))
    reads = make_reads(rng, docs, n_reads, READ_LEN)
    reads_path = out / "reads.fq.gz"
    write_fastq_gz(reads_path, reads)
    n_with_n = sum(b"N" in r for r in reads)
    info(card, f"main path: generated {n_docs} x {doc_len} bp genomes and "
               f"{n_reads} reads ({n_with_n} with N) in "
               f"{time.perf_counter() - t0:.1f}s")

    cap = _LogCapture()
    logging.getLogger("colbwt").addHandler(cap)
    try:
        idx = str(out / "idx")
        t0 = time.perf_counter()
        rc = cli.main(["build", "-v", "--force", "-o", idx] + fastas)
        build_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"col-bwt build returned {rc}")
        for m in cap.messages:
            if _REPORT.search(m):
                info(card, f"build: {m}")
        cap.messages.clear()
        t0 = time.perf_counter()
        rc = cli.main(["query", "-v", idx, "-p", str(reads_path), "--stream"])
        query_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"col-bwt query returned {rc}")
        for m in cap.messages:
            if _REPORT.search(m):
                info(card, f"query: {m}")
        engine = next((m.split("with engine ")[1] for m in cap.messages
                       if "with engine " in m), "?")
    finally:
        logging.getLogger("colbwt").removeHandler(cap)
    stats = jax.devices()[0].memory_stats() or {}
    info(card, f"main path: build {build_s:.1f}s, query --stream "
               f"{query_s:.1f}s ({n_reads / query_s:.0f} reads/s incl. "
               f"engine set-up), engine {engine}, peak_bytes_in_use "
               f"{stats.get('peak_bytes_in_use')}")

    names, pmls = read_pml_cid_binary(f"{reads_path}.split.pml.bin")
    names_c, cids = read_pml_cid_binary(f"{reads_path}.split.cid.bin")
    if names != [f"r{i}" for i in range(n_reads)] or names_c != names:
        raise AssertionError("output records are not the input reads in "
                             "input order")
    with_n = [i for i, r in enumerate(reads) if b"N" in r]
    pick = set(rng.choice(n_reads, min(sample, n_reads),
                          replace=False).tolist())
    pick.update(with_n[:max(1, sample // 4)])
    pick = sorted(pick)
    tbl = table_from_artifacts(idx)
    ref = cpp_answers(tbl, [reads[i] for i in pick])
    got = ([pmls[i] for i in pick], [cids[i] for i in pick])
    check(card, f"main path records ({sum(b'N' in reads[i] for i in pick)} "
                "with N)", got, {"C++": ref})
    return {"engine": engine, "build_s": build_s, "query_s": query_s,
            "sampled": len(pick)}


def phase_engines(seed: int, card: str, n_docs: int = ENG_DOCS,
                  doc_len: int = ENG_DOC_LEN, batch: int = ENG_BATCH,
                  n_long: int = LONG_READS, long_len: int = LONG_LEN) -> None:
    """Every single-device engine on one batch at real widths, and the
    long-read path, against the C++ engine and the oracle."""
    import jax

    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.ops import query_mega, query_pos
    from colbwt_tpu.pipeline.engines import QueryEngines
    from colbwt_tpu.utils.config import ColBwtConfig
    from colbwt_tpu.utils.hbm import resolve_pos_budget

    rng = np.random.default_rng(seed + 1)
    t0 = time.perf_counter()
    docs = make_genomes(rng, n_docs, doc_len)
    tbl = table_from_docs(docs)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    index_w = ColPmlIndex.build(tbl, ff_bound=2, wide=True)
    info(card, f"engines: {n_docs} x {doc_len} bp collection, n={index.n} "
               f"r={index.r} (unsplit {tbl.r}), built in "
               f"{time.perf_counter() - t0:.1f}s")

    reads = make_reads(rng, docs, batch, READ_LEN)
    long_reads = make_reads(rng, docs, n_long, long_len, n_rate=0.0)
    long_reads[0] = long_reads[0][:long_len // 2] + b"N" \
        + long_reads[0][long_len // 2 + 1:]
    t0 = time.perf_counter()
    refs = {"C++": cpp_answers(tbl, reads),
            "oracle": oracle_answers(tbl, reads)}
    long_refs = {"C++": cpp_answers(tbl, long_reads),
                 "oracle": oracle_answers(tbl, long_reads)}
    info(card, f"engines: references for {batch} + {n_long} reads in "
               f"{time.perf_counter() - t0:.1f}s")

    budget = resolve_pos_budget(0)
    for engine, idx in (("pos", index), ("mega", index), ("fused", index),
                        ("xla", index), ("auto", index_w)):
        eng = QueryEngines(idx, ColBwtConfig(engine=engine),
                           total_chars=None)
        t0 = time.perf_counter()
        p, c, lens = QueryEngines.materialize(eng.dispatch(reads, 256))
        check(card, f"engine {eng.name} (batch {batch}, padded {p.shape[1]}, "
                    f"first call {time.perf_counter() - t0:.1f}s)",
              _rows(p, c, lens), refs)
        if eng.supports_long_streaming():
            check(card, f"engine {eng.name} long reads ({long_len} bp)",
                  eng.query_long_reads(long_reads), long_refs)
        if eng.use_pos:
            pt = eng.pt
            spec = jax.ShapeDtypeStruct
            ma = query_pos.query_batch_pos.lower(
                pt["table"], pt["n"], spec((batch, 252 // 4), np.uint8),
                spec((batch,), np.int32), k=pt["k"], A=pt["A"],
                packed_out=True, pack=2).compile().memory_analysis()
            info(card, f"engine {eng.name}: step memory_analysis {ma}")
        if eng.use_mega:
            spec = jax.ShapeDtypeStruct
            ma = query_mega.query_batch_mega.lower(
                eng.mt, spec((batch, 255), np.uint8),
                spec((batch,), np.int32), ff_bound=idx.ff_bound,
                packed_out=True).compile().memory_analysis()
            info(card, f"engine {eng.name}: step memory_analysis {ma}")
        del eng

    k = query_pos.choose_k(index, budget)
    pt = query_pos.build_pos_tables(index, k, hbm_budget_bytes=budget)
    check(card, f"engine pos(k={k}, general keys) (batch {batch}, padded 252)",
          query_pos.query_batch(index, reads, max_len=252, pt=pt), refs)


def phase_four_cards(seed: int, card: str, n_docs: int = ENG_DOCS,
                     doc_len: int = ENG_DOC_LEN,
                     batch: int = ENG_BATCH) -> None:
    """The sharded engines on dp x ip meshes over four devices, each
    compared with the one-card engine on the same reads."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from colbwt_tpu.models.index import ColPmlIndex
    from colbwt_tpu.parallel import make_mesh, query_batch_sharded_auto
    from colbwt_tpu.parallel.query_sharded_mega import shard_mega
    from colbwt_tpu.parallel.query_sharded_mega_wide import shard_mega_wide
    from colbwt_tpu.parallel.query_sharded_pos import shard_pos_tables
    from colbwt_tpu.pipeline.engines import QueryEngines
    from colbwt_tpu.utils.config import ColBwtConfig

    devices = jax.devices()[:4]
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, have {devices}")
    rng = np.random.default_rng(seed + 2)
    docs = make_genomes(rng, n_docs, doc_len)
    tbl = table_from_docs(docs)
    index = ColPmlIndex.build(tbl, ff_bound=2)
    index_w = ColPmlIndex.build(tbl, ff_bound=2, wide=True)
    reads = make_reads(rng, docs, batch, READ_LEN)

    def placement(arr) -> str:
        return " ".join(f"{s.device.id}:{s.index}"
                        for s in sorted(arr.addressable_shards,
                                        key=lambda s: s.device.id))

    for name, idx in (("narrow", index), ("wide", index_w)):
        eng = QueryEngines(idx, ColBwtConfig(), total_chars=None)
        one = _rows(*QueryEngines.materialize(eng.dispatch(reads, 256)))
        del eng
        check(card, f"four cards: one-card {name} reference", one,
              {"C++": cpp_answers(tbl, reads)})
        for dp, ip in ((4, 1), (2, 2), (1, 4)):
            mesh = make_mesh(dp, ip, devices=devices)
            t0 = time.perf_counter()
            p, c, engine = query_batch_sharded_auto(idx, reads, mesh=mesh,
                                                    max_len=256)
            secs = time.perf_counter() - t0
            check(card, f"four cards: {name} {engine} dp={dp} ip={ip} "
                        f"(first call {secs:.1f}s)", (p, c),
                  {"one-card": one})
            # where the engine's inputs land on this mesh: the same
            # sharding functions the routed engine calls
            if engine == "sharded-pos":
                table = shard_pos_tables(idx, mesh)["table"]
            elif engine == "sharded-mega-wide":
                table = shard_mega_wide(idx, mesh)["mega"]
            elif engine == "sharded-mega":
                table = shard_mega(idx, mesh)["mega"]
            else:
                table = None
            if table is not None:
                info(card, f"four cards: {name} dp={dp} ip={ip} table "
                           f"shards {placement(table)}")
            enc, _ = idx.encode_patterns(reads, 256)
            ps = jax.device_put(enc, NamedSharding(mesh, P("dp", None)))
            info(card, f"four cards: {name} dp={dp} ip={ip} read shards "
                       f"{placement(ps)}")
            del table, ps
    used = {d.id: (d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devices}
    info(card, f"four cards: peak_bytes_in_use per device {used}")
    if any(v == 0 for v in used.values()):  # None: the CPU reports no stats
        raise AssertionError(f"a device held no data: {used}")


# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=REPO / ".chip_smoke",
                    help="directory for everything the run writes")
    ap.add_argument("--seed", type=int, default=0xC01B)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engines on four GPUs")
    args = ap.parse_args(argv)

    import jax

    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {d0.platform} "
              f"({d0.device_kind})", file=sys.stderr)
        return 2
    # the checkout may carry a native library built for another host
    subprocess.run(["make", "-B", "-C", str(REPO / "native")], check=True,
                   stdout=subprocess.DEVNULL)
    smi = nvidia_smi()
    card = smi.splitlines()[0]
    print(smi, flush=True)
    phase_device(card)
    if args.four_cards:
        phase_four_cards(args.seed, card)
    else:
        phase_main_path(args.out, args.seed, card)
        phase_engines(args.seed, card)
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
