"""Configuration for compression / decompression.

Defaults mirror the reference CLI defaults (reference: src/main.cpp:47-78 —
k=23, n=60, overlap-sketch-thr=6, minimap k=20/w=50, max-chain-iter=400,
edge-thr=4e6, t=20, decompression-memory=5 GB) so ratio comparisons are
apples-to-apples, but the knobs control a different, batch-first pipeline.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile


@dataclasses.dataclass
class CompressConfig:
    # --- MinHash sketching (reference: src/ReadFilter.cpp) ---
    kmer_size: int = 23                # -k: sketch k-mer length (<=32)
    num_hashes: int = 60               # -n: hash functions per sketch
    overlap_sketch_threshold: int = 6  # min matching sketch slots for a candidate
    sketch_seed: int = 0x5EEDF00D      # deterministic (reference uses random_device)

    # --- seeding / alignment (reference: minimap2 map-ont usage) ---
    seed_kmer_size: int = 20           # --minimap-k analog: anchor k-mer size
    seed_window: int = 50              # --minimap-w analog: minimizer window
    max_bucket: int = 256              # sketch-slot bucket cap (buckets
                                       # larger than this are repetitive
                                       # k-mers and skipped; drops counted
                                       # in FunnelStats.capped_* — measured
                                       # at 256/1024/uncapped in
                                       # docs/JOIN_CAP.md)
    max_chain_iter: int = 400          # chaining iteration cap analog
    band_width: int = 128              # banded-DP half-width for extension
    band_width_min: int = 64           # adaptive first-try band (native
                                       # engine escalates to band_width on
                                       # rejection; tighter bands give
                                       # tighter scripts AND less DP work)
    max_edit_frac: float = 0.5         # reject alignment if edits/len above this
    min_overlap: int = 150             # min overlapping bases to accept a member
    max_place_attempts: int = 8        # stale-clip retry cap per candidate
                                       # (engine.cpp apply(); gates how hard
                                       # end-extension races are retried)

    # --- contig building (reference: src/Consensus.cpp) ---
    edge_threshold: int = 4_000_000    # --edge-thr analog: cap on contig work
    window_step_frac: float = 0.25     # window step = avgReadLen * this (ref :54)
    min_read_len_for_sketch: int = 32  # reads shorter than this are lone reads
    repetitive_offsets: int = 6        # self-similarity screen offsets 1..6
    repetitive_threshold: float = 0.7  # Hamming self-similarity cutoff
    polish_rounds: int = 1             # consensus column-voting rounds

    # --- batching (device batch shapes) ---
    sketch_batch_reads: int = 4096     # reads per sketch kernel launch
    align_batch: int = 512             # (window, candidate) pairs per align launch
    frontier_target: int = 96          # queue depth the seeder tops up to;
                                       # more = fuller align batches but more
                                       # concurrent contigs (fragmentation)
    max_read_len_bucket: int = 1 << 17 # pad bucket ceiling for kernel launches

    # --- pipeline selection ---
    disable_assembly: bool = False     # True: every read stored lone (testing)
    short_read_lone_threshold: int = 256  # avg read length below which
                                       # assembly is skipped: per-member
                                       # stream overhead (~15-20 B) rivals a
                                       # packed short read, while the BWT
                                       # codec already captures the cross-
                                       # read coverage redundancy in the
                                       # lone stream (measured on the
                                       # new_zymo-like regime: lone-only
                                       # 4.8x vs assembled 4.0x; reference
                                       # gets 3.88x, logs/2022/new_zymo.log)
    checks: bool = False               # validate every member's edit script
                                       # against the live consensus (the
                                       # reference's -DCHECKS replay equality,
                                       # src/Consensus.cpp:280-337); slow
    aligner: str = "auto"              # "native" = C++ stitched/banded DP;
                                       # "device" = the lax DP
                                       # (ops/align_device.py) as the
                                       # engine's batch DP, grown in the
                                       # process that owns the card;
                                       # "python" = the numpy oracle
                                       # wavefront; "auto" = native until
                                       # a measurement favours the device
                                       # (docs/ALIGNER.md)

    # --- resources ---
    num_threads: int = 0               # 0 = os.cpu_count(); host-side pools
    pipeline_workers: int = 0          # contig-growth processes (0 = auto);
                                       # components are disjoint, so workers
                                       # (or hosts) need no coordination
    low_mem: bool | None = None        # disk-backed read store; None = auto
                                       # (on above low_mem_auto_bytes input
                                       # size — the in-memory worker fan-out
                                       # would otherwise duplicate the packed
                                       # dataset per worker)
    low_mem_auto_bytes: int = 2 << 30  # auto threshold on input file size
    work_dir: str | None = None        # temp dir root (None -> system tmp)

    # --- codec stage (reference: src/Compressor.cpp:126-130) ---
    # Per-stream winners, measured in docs/CODECS.md: the from-scratch LZ77
    # + range coder (nslz, the fast-lzma2 role) owns .pos and .base (beats
    # both nsbwt and stdlib lzma-6 on .base, within 0.6% of lzma-6 on
    # .pos); the from-scratch BWT codec (nsbwt, the libbsc role) owns the
    # rest. "lzma"/"bz2"/"zlib" remain available per stream.
    base_codec: str = "nslz"           # .base stream codec (LZ77 wins the
                                       # near-random literal stream)
    pos_codec: str = "nsbwt"           # .pos stream codec (LZP+BWT order-1
                                       # beats lzma-6 and nslz; docs/CODECS.md)
    default_codec: str = "nsbwt"       # remaining streams (incl .lone)
    exc_codec: str = "nso1"            # .exc stream codec (order-1 range
                                       # coder, no transform: the position
                                       # varints are near-uniform, which a
                                       # BWT scrambles; beats lzma-6 —
                                       # docs/CODECS.md)

    def resolved_threads(self) -> int:
        return self.num_threads or (os.cpu_count() or 1)

    def effective_min_overlap(self, avg_len: float) -> int:
        """min_overlap scaled down for short-read datasets (a 97-base
        new_zymo-style read can never reach the 150-base default; the
        reference accepts any alignment with >= 1 SAME base,
        src/ConsensusGraph.cpp:391-397)."""
        return min(self.min_overlap, max(24, int(avg_len * 0.6)))

    def effective_seed_window(self, avg_len: float) -> int:
        """Minimizer window scaled down for short reads so every read
        still carries a usable anchor set (the reference scales its
        consensus window step by avgReadLen the same way,
        src/Consensus.cpp:54)."""
        return min(self.seed_window, max(8, int(avg_len // 8)))

    def resolved_workers(self) -> int:
        """Contig-growing worker processes (owner-computes over components).

        Each worker runs a 2-thread software pipeline (placement thread +
        OpenMP DP), so one worker per two cores; fewer cores than that and
        the single pipelined worker wins outright.
        """
        if self.pipeline_workers:
            return self.pipeline_workers
        cores = os.cpu_count() or 1
        return max(1, min(self.resolved_threads(), cores) // 2)

    def resolved_work_root(self) -> str:
        return self.work_dir or tempfile.gettempdir()


@dataclasses.dataclass
class DecompressConfig:
    memory_gb: float = 5.0             # --decompression-memory analog: reorder budget
    num_threads: int = 0
    work_dir: str | None = None

    def resolved_threads(self) -> int:
        return self.num_threads or (os.cpu_count() or 1)

    def resolved_work_root(self) -> str:
        return self.work_dir or tempfile.gettempdir()
