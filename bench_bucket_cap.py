"""Measure max_bucket (sketch-slot cap) effect on ratio/time/recall
(round-3 verdict ask #6; findings recorded in docs/JOIN_CAP.md).

Usage: JAX_PLATFORMS=cpu python bench_bucket_cap.py
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from nanospring_tpu import compressor
from nanospring_tpu.config import CompressConfig
from nanospring_tpu.pipeline import candidates
from nanospring_tpu.utils import synth


def main() -> int:
    work = tempfile.mkdtemp(prefix="nstpu_cap_")
    regimes = {
        "realistic": dict(genome_len=2_000_000, num_reads=12_000,
                          mean_len=5_000, seed=1234, realistic=True),
        "high_error": dict(genome_len=400_000, num_reads=2_500,
                           mean_len=5_000, p_ins=0.03, p_del=0.03,
                           p_sub=0.036, seed=77, realistic=True),
        # the cap binds only when slot-bucket size (~coverage x repeat
        # multiplicity) crosses it; 24-30x benches never get near 256
        "high_cov_150x": dict(genome_len=200_000, num_reads=6_000,
                              mean_len=5_000, seed=42, realistic=True),
    }
    out = {}
    for name, kw in regimes.items():
        fq = os.path.join(work, f"{name}.fastq")
        reads = synth.make_dataset(fq, p_n_base=0.0005, **kw)
        total = sum(len(r) for r in reads)
        del reads
        for cap in (64, 256, 1024, 1 << 30):
            arc = os.path.join(work, f"{name}.{cap}.nstpu")
            t0 = time.time()
            res = compressor.compress_file(
                fq, arc, CompressConfig(max_bucket=cap), report=False)
            dt = time.time() - t0
            js = dict(candidates.JOIN_STATS)
            key = f"{name}/{cap if cap < 1 << 30 else 'uncapped'}"
            out[key] = {"ratio": round(res["ratio"], 3),
                        "wall_s": round(dt, 1),
                        "mbases_s": round(total / dt / 1e6, 2),
                        "dropped_buckets": js.get("dropped_buckets"),
                        "dropped_entries": js.get("dropped_entries"),
                        "capped_reads": js.get("capped_reads")}
            print(key, json.dumps(out[key]), flush=True)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
