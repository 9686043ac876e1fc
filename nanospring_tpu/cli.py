"""CLI — flag surface mirrors the reference (reference: src/main.cpp:47-78).

    nstpu -c -i reads.fastq[.gz] -o out.nstpu [-t N] [-k K] [-n N] ...
    nstpu -d -i out.nstpu -o reads.txt [-m GB]

Also exposes ``nstpu synth`` (synthetic dataset generation) and
``nstpu lone-stats`` (the testLoneReads analysis-tool analog,
reference: src/testLoneReads.cpp).
"""

from __future__ import annotations

import argparse
import signal
import sys

from .config import CompressConfig, DecompressConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nstpu", description=__doc__)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("-c", "--compress", action="store_true")
    mode.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-i", "--input", help="input path")
    p.add_argument("-o", "--output", help="output path")
    p.add_argument("-t", "--num-threads", type=int, default=0)
    p.add_argument("-k", "--kmer", type=int, default=23, help="MinHash k-mer size")
    p.add_argument("-n", "--num-hashes", type=int, default=60)
    p.add_argument("--overlap-sketch-thr", type=int, default=6)
    p.add_argument("--seed-k", type=int, default=20, help="anchor k-mer size (minimap-k analog)")
    p.add_argument("--seed-w", type=int, default=50, help="minimizer window (minimap-w analog)")
    p.add_argument("--max-chain-iter", type=int, default=400)
    p.add_argument("--edge-thr", type=int, default=4_000_000)
    # engine/codec knobs (the reference sweeps these via rebuild or env;
    # exposing them makes the logs/2022-style parameter sweeps scriptable)
    p.add_argument("--band", type=int, default=128,
                   help="banded-DP half-width (escalation band)")
    p.add_argument("--band-min", type=int, default=64,
                   help="adaptive first-try band half-width")
    p.add_argument("--polish-rounds", type=int, default=1,
                   help="consensus column-voting rounds (0 disables)")
    p.add_argument("--aligner", choices=["auto", "native", "device", "python"],
                   default="auto", help="DP backend for contig growth")
    p.add_argument("--workers", type=int, default=0,
                   help="contig-growth worker processes (0 = auto)")
    p.add_argument("--min-overlap", type=int, default=150)
    p.add_argument("--base-codec", default=None,
                   help="codec for .base/.lone streams (default: config)")
    p.add_argument("--pos-codec", default=None,
                   help="codec for the .pos stream (default: config)")
    p.add_argument("--default-codec", default=None,
                   help="codec for the remaining streams (default: nsbwt)")
    p.add_argument("-w", "--work-dir", default=None, help="temp dir root")
    p.add_argument("--low-mem", action="store_true", default=None,
                   help="disk-backed read store (default: auto by input size)")
    p.add_argument("--no-assembly", action="store_true", help="store all reads lone")
    p.add_argument("--checks", action="store_true",
                   help="edit-script replay invariants after every accept "
                        "(the reference's -DCHECKS build, CMakeLists.txt:32)")
    p.add_argument(
        "-m", "--decompression-memory", type=float, default=5.0, help="GB for reorder"
    )
    p.add_argument("-q", "--quiet", action="store_true")

    sub = p.add_subparsers(dest="cmd")
    sp = sub.add_parser("synth", help="generate a synthetic FASTQ dataset")
    sp.add_argument("-o", "--output", required=True)
    sp.add_argument("--genome-len", type=int, default=1_000_000)
    sp.add_argument("--num-reads", type=int, default=2000)
    sp.add_argument("--mean-len", type=int, default=8000)
    sp.add_argument("--seed", type=int, default=42)
    sp.add_argument("--n-frac", type=float, default=0.0)
    sp.add_argument("--realistic", action="store_true",
                    help="hardened model: repeats, homopolymer-biased "
                         "indels, lognormal lengths (the bench headline)")

    lp = sub.add_parser("lone-stats", help="analyze lone reads of an archive")
    lp.add_argument("-i", "--input", required=True)
    return p


def main(argv: list[str] | None = None) -> int:
    # catch-all: temp files are owned by try/finally inside the stages, so
    # any exception (or SIGINT -> SystemExit) unwinds through their cleanup
    # before we report and exit nonzero (reference: src/main.cpp:160-176)
    try:
        return _dispatch(argv)
    except KeyboardInterrupt:
        print("interrupted", file=sys.stderr)
        return 130
    except Exception as e:  # noqa: BLE001 - CLI boundary
        print(f"nstpu: error: {e}", file=sys.stderr)
        return 1


def _dispatch(argv: list[str] | None) -> int:
    args = build_parser().parse_args(argv)

    # SIGINT: temp files are cleaned by context managers; just exit nonzero
    # (reference installs a handler to delete its temp dir, src/main.cpp:20-28)
    signal.signal(signal.SIGINT, lambda *_: sys.exit(130))

    if args.cmd == "synth":
        from .utils import synth

        synth.make_dataset(
            args.output,
            genome_len=args.genome_len,
            num_reads=args.num_reads,
            mean_len=args.mean_len,
            seed=args.seed,
            p_n_base=args.n_frac,
            realistic=args.realistic,
        )
        print(f"wrote {args.output}")
        return 0

    if args.cmd == "lone-stats":
        from .pipeline import lone_stats

        lone_stats.report(args.input)
        return 0

    if args.compress:
        if not args.input or not args.output:
            print("compress requires -i and -o", file=sys.stderr)
            return 2
        cfg = CompressConfig(
            kmer_size=args.kmer,
            num_hashes=args.num_hashes,
            overlap_sketch_threshold=args.overlap_sketch_thr,
            seed_kmer_size=args.seed_k,
            seed_window=args.seed_w,
            max_chain_iter=args.max_chain_iter,
            edge_threshold=args.edge_thr,
            num_threads=args.num_threads,
            low_mem=args.low_mem,
            work_dir=args.work_dir,
            disable_assembly=args.no_assembly,
            checks=args.checks,
            band_width=args.band,
            band_width_min=args.band_min,
            polish_rounds=args.polish_rounds,
            aligner=args.aligner,
            pipeline_workers=args.workers,
            min_overlap=args.min_overlap,
        )
        if args.base_codec:
            cfg.base_codec = args.base_codec
        if args.pos_codec:
            cfg.pos_codec = args.pos_codec
        if args.default_codec:
            cfg.default_codec = args.default_codec
        from .compressor import compress_file

        compress_file(args.input, args.output, cfg, report=not args.quiet)
        return 0

    if args.decompress:
        if not args.input or not args.output:
            print("decompress requires -i and -o", file=sys.stderr)
            return 2
        cfg = DecompressConfig(
            memory_gb=args.decompression_memory,
            num_threads=args.num_threads,
            work_dir=args.work_dir,
        )
        from .decompressor import decompress_file

        decompress_file(args.input, args.output, cfg, report=not args.quiet)
        return 0

    build_parser().print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
