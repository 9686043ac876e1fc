"""Observability: stage timers, RSS sampling, funnel counters, trace log.

The reference's equivalents: std::chrono stage spans + stdout reports
(src/Compressor.cpp:59-82), RSS from /proc/self/stat (src/Compressor.cpp:20-45),
the CountStats candidate funnel (include/Consensus.h:19-35, printed at
src/Consensus.cpp:154-164), and the optional -DLOG per-thread trace files
(src/Consensus.cpp:32-49).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import sys
import time

logger = logging.getLogger("nanospring_tpu")


def rss_gb() -> float:
    """Current resident set size in GB (Linux)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9
    except (OSError, ValueError, IndexError):
        return 0.0


def gpu_card() -> str:
    """The card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them; read by a child process that stays off JAX."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


class StageTimer:
    """Named stage spans with wall-clock + RSS reporting."""

    def __init__(self, report: bool = True):
        self.spans: dict[str, float] = {}
        self.report = report
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            self.spans[name] = self.spans.get(name, 0.0) + dt
            if self.report:
                print(
                    f"[nstpu] {name}: {dt:.2f}s (rss {rss_gb():.2f} GB)",
                    file=sys.stderr,
                )

    def total(self) -> float:
        return time.perf_counter() - self._t0


@dataclasses.dataclass
class FunnelStats:
    """Candidate funnel counters — the CountStats analog.

    Tracks how many candidate (window, read) pairs survive each filter so
    ratio regressions can be localized (sketch recall vs aligner acceptance).
    """

    minhash_hits: int = 0        # pairs passing the sketch-collision threshold
    not_claimed: int = 0         # of those, reads not yet claimed by a contig
    aligned_ok: int = 0          # of those, accepted by the aligner
    repetitive: int = 0          # reads excluded by the self-similarity screen
    capped_buckets: int = 0      # sketch buckets dropped by the size cap
    capped_reads: int = 0        # reads touched by a dropped bucket
    reads_in_contigs: int = 0
    lone_reads: int = 0
    contigs: int = 0

    def merge(self, other: "FunnelStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def report(self) -> str:
        return (
            f"funnel: minhash={self.minhash_hits} unclaimed={self.not_claimed} "
            f"aligned={self.aligned_ok} repetitive={self.repetitive} "
            f"capped_buckets={self.capped_buckets} | "
            f"contigs={self.contigs} in_contigs={self.reads_in_contigs} "
            f"lone={self.lone_reads}"
        )
