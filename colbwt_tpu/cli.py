"""col-bwt command-line interface.

Flag-compatible with the reference orchestrator (scripts/col-bwt.py:200-248):

    col-bwt build [-i INPUT] -o OUTPUT [-r] [-m MODE] [-s SUB_SAMPLE]
                  [-l MIN_MUM] [-v] [--force] [--keep] [--clean] [fastas ...]
    col-bwt query INDEX -p PATTERN [--text]

(the reference README shows a `-o` on query that its parser never defined,
SURVEY §2.5 — we accept `--text` instead to also emit the .pml/.cid text
files of the in-repo alt path.)
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from colbwt_tpu.utils.config import ColBwtConfig, SplitMode

ASCII_ART = r"""
        colbwt-tpu — pangenomic chain statistics on an accelerator
"""

CLEAN_EXTS = ["bwt", "thr_pos", "col_mums", "bwt.heads", "bwt.len",
              "col_ids", "col_runs", "col_pml"]


def _build(args: argparse.Namespace) -> int:
    from colbwt_tpu.pipeline import build_pipeline

    if not args.fastas and not args.input:
        print("Error: either positional 'fastas' or -i/--input is required.",
              file=sys.stderr)
        return 1
    cfg = ColBwtConfig(
        mode=SplitMode(args.mode), split_rate=args.sub_sample,
        min_mum=args.min_mum, rev_comp=args.rev_comp, verbose=args.verbose,
        force=args.force, keep_temp=args.keep,
        sa_mode=args.sa_mode, chunk_chars=args.chunk_chars,
        prewarm=not args.no_prewarm)
    build_pipeline(args.fastas, args.output, cfg, filelist=args.input)
    if args.clean:
        fa = f"{args.output}.fa"
        for ext in CLEAN_EXTS:
            Path(f"{fa}.{ext}").unlink(missing_ok=True)
        Path(f"{args.output}.lengths").unlink(missing_ok=True)
    print(f"Index output at {args.output}.colpml.npz")
    return 0


def _query(args: argparse.Namespace) -> int:
    from colbwt_tpu.pipeline import query_pipeline, query_stream

    if args.batch_size < 0:
        print("Error: --batch-size must be >= 0 (0 = config default).",
              file=sys.stderr)
        return 1
    cfg = ColBwtConfig(verbose=args.verbose, engine=args.engine)
    if args.batch_size:
        cfg.batch_size = args.batch_size
    elif args.stream:
        # bulk streaming defaults to deeper batches: per-batch dispatch and
        # transfer latency amortize over more reads, and first-output
        # latency does not matter for a bulk run
        cfg.batch_size = 32768
    if args.stream:
        if args.text:
            print("Error: --stream writes binary outputs only.",
                  file=sys.stderr)
            return 1
        query_stream(args.index, args.pattern, cfg)
    else:
        query_pipeline(args.index, args.pattern, cfg,
                       write_text=args.text and not args.long,
                       write_text_long=args.text and args.long)
    print(f"Output at {args.pattern}.split.pml.bin and "
          f"{args.pattern}.split.cid.bin")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="col-bwt",
        description="Full-text index for pangenomes using chain statistics "
                    "(JAX, accelerator-resident index)")
    sub = parser.add_subparsers(dest="command")

    b = sub.add_parser("build", help="Find multi-MUMs and build the col-bwt")
    b.add_argument("fastas", nargs="*", type=str,
                   help="fasta files to index")
    b.add_argument("-i", "--input", type=str,
                   help="file-list of genomes (overrides positional args)")
    b.add_argument("-o", "--output", required=True, type=str,
                   help="output prefix path")
    b.add_argument("-r", "--rev_comp", action="store_true", default=False,
                   help="include reverse complements")
    b.add_argument("-m", "--mode", type=str, default="tunnels",
                   choices=["tunnels", "all"], help="splitting mode")
    b.add_argument("-s", "--sub-sample", type=int, default=10,
                   help="sub-sample (split) rate")
    b.add_argument("-l", "--min-mum", type=int, default=20,
                   help="minimum multi-MUM length")
    b.add_argument("-v", "--verbose", action="store_true")
    b.add_argument("--force", action="store_true",
                   help="force all build steps to run")
    b.add_argument("--keep", action="store_true",
                   help="keep all temporary files")
    b.add_argument("--clean", action="store_true",
                   help="remove all intermediate files")
    b.add_argument("--sa-mode", type=str, default="auto",
                   choices=["auto", "monolithic", "chunked"],
                   help="suffix-array construction lane: 'chunked' builds "
                        "the RLBWT by per-chunk SA-IS + rank merge (no "
                        "global SA; the reference's PFP scale role), "
                        "'auto' switches when n exceeds the host SA budget")
    b.add_argument("--no-prewarm", action="store_true",
                   help="skip the build-exit query-path prewarm (table "
                        "build/persist + XLA program compile into the "
                        "persistent cache)")
    b.add_argument("--chunk-chars", type=int, default=0,
                   help="chunk size (characters) for --sa-mode chunked; "
                        "0 = auto (half the monolithic SA RAM budget)")

    q = sub.add_parser("query", help="Compute PMLs and chain statistics")
    q.add_argument("index", type=str, help="output prefix of the build")
    q.add_argument("-p", "--pattern", required=True, type=str,
                   help="pattern fasta file")
    q.add_argument("--text", action="store_true",
                   help="also write .pml/.cid text outputs")
    q.add_argument("-l", "--long", action="store_true",
                   help="long-pattern mode: with --text, write the "
                        "reference's -l streaming text format "
                        "(src/pml_query.cpp:32-63)")
    q.add_argument("-v", "--verbose", action="store_true")
    q.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming mode for huge pattern "
                        "files (binary outputs only)")
    q.add_argument("--batch-size", type=int, default=0,
                   help="reads per device batch (0 = config default 8192, "
                        "32768 with --stream); larger batches amortize "
                        "per-batch dispatch and transfer latency")
    q.add_argument("--engine", type=str, default="auto",
                   choices=["auto", "pos", "mega", "fused", "xla"],
                   help="query engine override (auto picks the fastest "
                        "that fits device memory)")

    args = parser.parse_args(argv)
    if args.command in ("build", "query"):
        from colbwt_tpu.utils.log import enable_compilation_cache

        enable_compilation_cache()
    if args.command == "build":
        return _build(args)
    if args.command == "query":
        return _query(args)
    print(ASCII_ART)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
