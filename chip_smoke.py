"""Smoke run of the compressor on an NVIDIA GPU, through its normal entry
points, at real sizes, with exact checks against the host references.

    python chip_smoke.py               # one card: phases (a)-(e)
    python chip_smoke.py --four-cards  # compress_mesh on four cards vs one

(a) the headline dataset (bench.py's): ``cli -c`` then ``cli -d``,
    byte-compared; the sketch runs on the device;
(b) hs2-shaped long reads with ``--aligner device``: byte-identical, and
    the device carried DP batches;
(c) one engine-shaped batch of 512 pairs at (b)'s lengths: the lax DP vs
    the host DP (W = 63), equal costs and replaying edit scripts;
(d) the largest sketch bucket, 4,096 reads at pad 32,768: device vs host
    sketch, bit-identical;
(e) the ``gpu``-marked tests, in this process.

Both kernels are integer arithmetic, so every comparison is exact. The
script refuses to run without a GPU, and any failed phase exits non-zero
before the result line. The last line of stdout is one JSON object naming
the device. Run it from the root of a checkout: one process uses the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

from nanospring_tpu import cli, native
from nanospring_tpu.config import CompressConfig
from nanospring_tpu.ops import align as al
from nanospring_tpu.ops import align_device as ad
from nanospring_tpu.ops import sketch as sk
from nanospring_tpu.pipeline import contigs
from nanospring_tpu.utils import synth
from nanospring_tpu.utils.observe import gpu_card

HERE = os.path.dirname(os.path.abspath(__file__))

# bench.py's headline dataset: realistic model, ~60 Mbases at 30x
HEADLINE = dict(genome_len=2_000_000, num_reads=12_000, mean_len=5_000,
                seed=1234, p_n_base=0.0005, realistic=True)
# hs2-shaped: mean read length 24.5 kb (BASELINE.md), >= 30 Mbases, ~25x
LONG_READS = dict(genome_len=1_200_000, num_reads=1_400, mean_len=24_500,
                  seed=77, p_n_base=0.0005, realistic=True)
# the largest sketch bucket a run makes: sketch_batch_reads at pad 32,768
SKETCH_BUCKET = (CompressConfig().sketch_batch_reads, 32_768)
# the four-card check: the realistic model at 15 Mbases, 30x
FOUR_CARDS = dict(genome_len=500_000, num_reads=3_000, mean_len=5_000,
                  seed=4, p_n_base=0.0005, realistic=True)


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _host_info() -> None:
    import jax

    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()
    print(gpu_card())
    print(f"jax {jax.__version__}; {gxx[0] if gxx else 'g++ not found'}; "
          f"host cores {os.cpu_count()}", flush=True)


def _roundtrip(phase: str, work: str, data: dict, extra: list[str]) -> dict:
    """Generate, compress and decompress through the CLI; byte-compare."""
    fq = os.path.join(work, f"{phase}.fastq")
    arc = os.path.join(work, f"{phase}.nstpu")
    out = os.path.join(work, f"{phase}.reads")
    reads = synth.make_dataset(fq, **data)
    bases = sum(map(len, reads))
    t0 = time.perf_counter()
    if cli.main(["-c", "-i", fq, "-o", arc, *extra]) != 0:
        raise RuntimeError(f"{phase}: compress failed")
    t_c = time.perf_counter() - t0
    stages, dp = dict(contigs.PIPE_STAGES), dict(contigs.DP_INFO)
    t0 = time.perf_counter()
    if cli.main(["-d", "-i", arc, "-o", out]) != 0:
        raise RuntimeError(f"{phase}: decompress failed")
    t_d = time.perf_counter() - t0
    with open(out, "rb") as f:
        if f.read().splitlines() != reads:
            raise RuntimeError(f"{phase}: round trip is not byte-identical")
    _say(phase, f"byte-identical: {len(reads)} reads, {bases} bases, ratio "
         f"{bases / os.path.getsize(arc):.3f}; compress {t_c:.2f} s "
         f"({bases / t_c / 1e6:.2f} Mb/s), decompress {t_d:.2f} s "
         f"(cold process: compile included)")
    _say(phase, "pipeline stages (s or counts): " + json.dumps(
        {k: round(v, 3) for k, v in stages.items()}))
    if stages.get("sketch_backend_device") != 1.0:
        raise RuntimeError(f"{phase}: the sketch did not run on the device")
    _say(phase, "sketch_backend_device == 1")
    stages["bases"] = bases
    stages.update(dp)
    return stages


def phase_headline(work: str) -> None:
    t0 = time.perf_counter()
    native.get_lib()
    _say("a", f"set-up: native library ready in "
         f"{time.perf_counter() - t0:.2f} s (built for this host if absent)")
    _roundtrip("a", work, HEADLINE, [])


def phase_long_reads(work: str) -> None:
    st = _roundtrip("b", work, LONG_READS, ["--aligner", "device"])
    if st["bases"] < 30_000_000:
        raise RuntimeError(f"b: only {st['bases']} bases")
    if st.get("dp_backend") != "device" or not st.get("device_batches"):
        raise RuntimeError(f"b: no DP batch ran on the device: {st}")
    _say("b", f"device_batches {st['device_batches']}, host-only batches "
         f"{st['host_batches']}, over-cap pairs routed to the host "
         f"{int(st['host_routed_long_pairs'])} "
         f"({int(st['host_routed_long_bases'])} bases), device DP "
         f"{st['dp_device']:.2f} s")


def _long_pairs(P: int, rng, m_cap: int):
    """Engine-shaped pairs at hs2 lengths: each query is a mutated copy of
    its target window (1.2% deletions, 1.2% insertions, 1.3% substitutions),
    anchored at d0 = 200."""
    genome = rng.integers(0, 4, 4_000_000, dtype=np.uint8)
    sigma = 0.5
    lens = rng.lognormal(np.log(24_500) - sigma ** 2 / 2, sigma, P)
    lens = np.clip(lens.astype(np.int64), 2_000, m_cap * 9 // 10)
    tf, qf = [], []
    for L in lens:
        s = int(rng.integers(0, len(genome) - L - 600))
        seg = genome[s + 200: s + 200 + L]
        seg = seg[rng.random(L) >= 0.012]
        seg = np.repeat(seg, 1 + (rng.random(len(seg)) < 0.012))
        subs = rng.random(len(seg)) < 0.013
        seg[subs] = (seg[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
        tf.append(genome[s: s + L + 600])
        qf.append(seg.astype(np.uint8))
    t_len = np.array([len(t) for t in tf])
    q_len = np.array([len(q) for q in qf])
    off = lambda n: np.concatenate([[0], np.cumsum(n)[:-1]])
    return (np.concatenate(tf), off(t_len), t_len, np.concatenate(qf),
            off(q_len), q_len, np.full(P, 200))


def _replays(t, q, ts, te, ops: bytes) -> bool:
    o = np.frombuffer(ops, np.uint8)
    cq, ct = o != ord("d"), o != ord("i")
    qi = np.cumsum(cq) - cq
    tj = ts + np.cumsum(ct) - ct
    eq = o == ord("=")
    return (int(cq.sum()) == len(q) and ts + int(ct.sum()) == te
            and bool((tj[eq] < len(t)).all())
            and bool((t[tj[eq]] == q[qi[eq]]).all()))


def phase_dp(work: str) -> None:
    import jax

    native.get_lib()   # a first-use build must not land in the timing
    P, m_cap = contigs._DeviceDpHook.P_CAP, ad.M_CAP_MAX
    kb = int(CompressConfig().max_edit_frac * 1000)
    args = _long_pairs(P, np.random.default_rng(5), m_cap)
    tfl, t_off, t_len, qfl, q_off, q_len, d0 = args
    _say("c", f"{P} pairs, query rows mean {q_len.mean():.0f} max "
         f"{q_len.max()}, m_cap {m_cap}, {int(q_len.sum())} query bases")
    packed = ad.pack_batch(*args, max_cost_per_kb=kb, p_cap=P, m_cap=m_cap)
    t0 = time.perf_counter()
    compiled = ad.align_padded.lower(*packed).compile()
    _say("c", f"compile {time.perf_counter() - t0:.2f} s; memory_analysis: "
         f"{compiled.memory_analysis()}")
    dev_in = jax.device_put(packed)
    jax.block_until_ready(compiled(*dev_in))
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(*dev_in))
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    [np.asarray(a) for a in ad.align_padded(*packed)]
    t_call = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = al.banded_align_batch(*args, band=ad.W, max_cost_per_kb=kb,
                                use_native=True)
    t_host = time.perf_counter() - t0
    dev = ad.banded_align_batch_device(*args, max_cost_per_kb=kb, p_cap=P,
                                       m_cap=m_cap)
    if not np.array_equal(ref.cost, dev.cost):
        bad = np.flatnonzero(ref.cost != dev.cost)
        raise RuntimeError(f"c: {len(bad)} costs differ, first {bad[:5]}")
    acc = np.flatnonzero(dev.cost >= 0)
    for p in acc:
        t = tfl[t_off[p]: t_off[p] + t_len[p]]
        q = qfl[q_off[p]: q_off[p] + q_len[p]]
        if not _replays(t, q, int(dev.tstart[p]), int(dev.tend[p]),
                        dev.ops(p)):
            raise RuntimeError(f"c: pair {p}'s edit script does not replay")
    if len(acc) < P // 2:
        raise RuntimeError(f"c: only {len(acc)} of {P} pairs accepted")
    _say("c", f"costs equal on {P} pairs, {len(acc)} accepted scripts "
         f"replay; lax DP {t_dev:.3f} s on the device "
         f"(block_until_ready), {t_call:.3f} s with transfers; host DP "
         f"{t_host:.3f} s on {os.cpu_count()} cores")


def phase_sketch(work: str) -> None:
    import jax

    from nanospring_tpu.io import read_store

    cfg = CompressConfig()
    rng = np.random.default_rng(9)
    genome = synth.random_genome(8_000_000, rng)
    B, pad = SKETCH_BUCKET
    lens = rng.integers(pad // 2 + 1, pad + 1, B)
    starts = rng.integers(0, len(genome) - pad, B)
    fq = os.path.join(work, "d.fastq")
    synth.write_fastq(fq, [genome[s: s + n].tobytes()
                           for s, n in zip(starts, lens)], gz=False)
    store = read_store.load_fastq(fq)
    rids = np.arange(B, dtype=np.int64)
    seeds = sk.make_seeds(cfg.num_hashes, cfg.sketch_seed)
    packed, plens = store.get_batch_packed(rids, pad_to=pad)
    plens = plens.astype(np.int32)
    t0 = time.perf_counter()
    compiled = sk.sketch_batch_packed.lower(
        packed, plens, seeds, k=cfg.kmer_size).compile()
    _say("d", f"compile {time.perf_counter() - t0:.2f} s; memory_analysis: "
         f"{compiled.memory_analysis()}")
    dev_in = jax.device_put((packed, plens, seeds))
    jax.block_until_ready(compiled(*dev_in))
    t0 = time.perf_counter()
    got = np.asarray(jax.block_until_ready(compiled(*dev_in)))
    t_dev = time.perf_counter() - t0
    ref = np.full_like(got, sk.EMPTY_SLOT)
    lib = native.get_lib()
    t0 = time.perf_counter()
    contigs._sketch_native_into(
        lib, store, rids, seeds, cfg.kmer_size,
        max(cfg.kmer_size, cfg.min_read_len_for_sketch), ref)
    t_host = time.perf_counter() - t0
    if not np.array_equal(got, ref):
        raise RuntimeError(f"d: {int((got != ref).any(1).sum())} of {B} "
                           f"sketches differ")
    _say("d", f"{B} reads at pad {pad} ({int(lens.sum())} bases) "
         f"bit-identical; device {t_dev:.3f} s (block_until_ready), host "
         f"{t_host:.3f} s on {os.cpu_count()} cores")


def phase_gpu_tests(work: str) -> None:
    import pytest

    class _Count:
        passed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.passed and report.when == "call":
                self.passed += 1
            elif report.skipped:
                self.skipped += 1

    count = _Count()
    # --noconftest: conftest.py pins the CPU for the hermetic suite, and
    # this process already owns the card
    rc = pytest.main(["-q", "-m", "gpu", "--noconftest", "-p",
                      "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu.py")],
                     plugins=[count])
    if rc != 0 or count.skipped or not count.passed:
        raise RuntimeError(f"e: pytest rc {rc}, {count.passed} passed, "
                           f"{count.skipped} skipped")
    _say("e", f"{count.passed} gpu-marked tests passed")


def phase_four_cards(work: str) -> None:
    """compress_mesh over four cards vs the one-card compress of the same
    reads: both decode byte-identically, and the sharded join's pairs equal
    the single-host SketchIndex's."""
    import jax

    from nanospring_tpu import compressor, decompressor
    from nanospring_tpu.io import read_store
    from nanospring_tpu.parallel import mesh as pm
    from nanospring_tpu.parallel import pipeline as pp
    from nanospring_tpu.parallel import sharded_join as sj
    from nanospring_tpu.pipeline import candidates

    cfg = CompressConfig()
    fq = os.path.join(work, "four.fastq")
    reads = synth.make_dataset(fq, **FOUR_CARDS)
    store = read_store.load_fastq(fq)
    mesh = pm.make_mesh(4)
    for name, run in (
            ("mesh", lambda arc: pp.compress_mesh(store, arc, cfg, mesh)),
            ("one card", lambda arc: compressor.compress_file(
                fq, arc, cfg, report=False))):
        arc = os.path.join(work, f"four_{name[0]}.nstpu")
        out = arc + ".reads"
        t0 = time.perf_counter()
        res = run(arc)
        t_c = time.perf_counter() - t0
        decompressor.decompress_file(arc, out, report=False)
        with open(out, "rb") as f:
            if f.read().splitlines() != reads:
                raise RuntimeError(f"four: {name} archive is not lossless")
        _say("four", f"{name}: byte-identical, ratio {res['ratio']:.3f}, "
             f"compress {t_c:.2f} s (compile included)")
    sketches = contigs.compute_all_sketches(store, cfg)
    thr = cfg.overlap_sketch_threshold
    q, r, _ = sj.sharded_candidate_pairs(mesh, sketches, thr)
    got = set(zip(q.tolist(), r.tolist()))
    iq, ir, _ = candidates.SketchIndex(sketches).query(sketches, thr)
    keep = iq != ir
    want = set(zip(iq[keep].tolist(), ir[keep].tolist()))
    if got != want:
        raise RuntimeError(f"four: sharded join {len(got)} pairs, "
                           f"SketchIndex {len(want)}")
    _say("four", f"sharded join on {mesh.devices.size} "
         f"{jax.devices()[0].device_kind} = SketchIndex: {len(got)} pairs")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run compress_mesh on four cards and nothing else")
    args = ap.parse_args(argv)
    import jax

    _host_info()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r}); "
              f"refusing to run", file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} cards, found {len(devices)}",
              file=sys.stderr)
        return 2
    phases = ([phase_four_cards] if args.four_cards else
              [phase_headline, phase_long_reads, phase_dp, phase_sketch,
               phase_gpu_tests])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        for phase in phases:
            t0 = time.perf_counter()
            try:
                phase(work)
            except Exception:  # noqa: BLE001 - report and fail the run
                traceback.print_exc()
                print(f"chip_smoke: {phase.__name__} failed", file=sys.stderr)
                return 1
            print(f"{phase.__name__}: ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
