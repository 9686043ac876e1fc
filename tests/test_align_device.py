"""The lax DP (ops/align_device.py) vs the exact host DP (native/align.cpp,
W = 63): identical costs and replay-valid edit scripts, run on XLA:CPU; and
the engine's device hook end to end (aligner="device")."""

import numpy as np
import pytest

from nanospring_tpu.ops import align_device as ad
from nanospring_tpu.ops.align import banded_align_batch


def _mkbatch(P, rng, tmin=300, tmax=900, minov=100):
    tf, qf = [], []
    t_off, t_len, q_off, q_len, d0 = [], [], [], [], []
    to = qo = 0
    for _ in range(P):
        n = int(rng.integers(tmin, tmax))
        t = rng.integers(0, 4, n).astype(np.uint8)
        s = int(rng.integers(0, n // 3))
        e = int(rng.integers(s + minov, n))
        out = []
        for c in t[s:e]:
            r = rng.random()
            if r < 0.03:
                out.append(int(rng.integers(0, 4)))
            elif r < 0.06:
                pass
            elif r < 0.09:
                out.extend([int(c), int(rng.integers(0, 4))])
            else:
                out.append(int(c))
        q = np.array(out, np.uint8)
        tf.append(t)
        qf.append(q)
        t_off.append(to)
        t_len.append(n)
        to += n
        q_off.append(qo)
        q_len.append(len(q))
        qo += len(q)
        d0.append(s)
    return (np.concatenate(tf), np.array(t_off), np.array(t_len),
            np.concatenate(qf), np.array(q_off), np.array(q_len),
            np.array(d0))


def _replay_ok(args, res, p) -> bool:
    tfl, t_off, t_len, qfl, q_off, q_len, _ = args
    t = tfl[t_off[p]: t_off[p] + t_len[p]]
    q = qfl[q_off[p]: q_off[p] + q_len[p]]
    j, qi = int(res.tstart[p]), 0
    for o in res.ops(p):
        if o == ord("="):
            if j >= len(t) or t[j] != q[qi]:
                return False
            j += 1
            qi += 1
        elif o == ord("s"):
            j += 1
            qi += 1
        elif o == ord("i"):
            qi += 1
        else:
            j += 1
    return qi == len(q) and j == int(res.tend[p])


def _check_against_native(args, dev):
    ref = banded_align_batch(*args, band=ad.W, use_native=True)
    assert np.array_equal(ref.cost, dev.cost), (ref.cost, dev.cost)
    for p in range(len(dev.cost)):
        if dev.cost[p] >= 0:
            assert _replay_ok(args, dev, p), p


@pytest.mark.parametrize("P,seed,shape", [
    (5, 5, {}),
    (19, 3, {}),
    (6, 7, dict(tmin=2200, tmax=3400, minov=1500)),
    # rows above 8,192
    (2, 11, dict(tmin=12500, tmax=13000, minov=8300)),
])
def test_device_dp_matches_native(P, seed, shape):
    rng = np.random.default_rng(seed)
    args = _mkbatch(P, rng, **shape)
    dev = ad.banded_align_batch_device(*args)
    _check_against_native(args, dev)
    assert (dev.cost >= 0).sum() >= P // 2   # the batch exercises accepts


def test_device_dp_rejects_garbage():
    rng = np.random.default_rng(4)
    t = rng.integers(0, 4, 600).astype(np.uint8)
    q = rng.integers(0, 4, 500).astype(np.uint8)  # unrelated
    res = ad.banded_align_batch_device(
        t, np.array([0]), np.array([600]), q, np.array([0]), np.array([500]),
        np.array([50]), max_cost_per_kb=300)
    assert res.cost[0] == -1 and res.ops_len[0] == 0


def test_escape_rows_rerun_on_host():
    """A 100-base deletion inside one query row needs more deletions than a
    trace byte holds: the row escapes, and the pair runs on the host DP.
    The deleted run is a homopolymer flanked by other bases, so the only
    optimal path takes all 100 deletions after one query row."""
    rng = np.random.default_rng(21)
    t = rng.integers(0, 4, 1400).astype(np.uint8)
    t[500:600] = 0
    t[499], t[600] = 1, 2
    q = np.concatenate([t[200:500], t[600:1000]])
    args = (t, np.array([0]), np.array([len(t)]), q, np.array([0]),
            np.array([len(q)]), np.array([250]))
    packed = ad.pack_batch(*args, max_cost_per_kb=500, p_cap=1, m_cap=1024)
    cost, _, _, trace = (np.asarray(a) for a in ad.align_padded(*packed))
    assert cost[0] >= 0
    assert ad.expand_trace(trace[0, : len(q)]) is None
    dev = ad.banded_align_batch_device(*args)
    _check_against_native(args, dev)
    assert dev.ops(0).count(b"d") >= 100


def test_padding_pairs_change_nothing():
    """Unused pair slots (qlen 0) cost 0 and leave real pairs untouched."""
    rng = np.random.default_rng(8)
    args = _mkbatch(7, rng)
    tight = ad.banded_align_batch_device(*args)
    roomy = ad.banded_align_batch_device(*args, p_cap=16, m_cap=2048)
    assert np.array_equal(tight.cost, roomy.cost)
    assert np.array_equal(tight.ops_flat, roomy.ops_flat)
    packed = ad.pack_batch(*args, max_cost_per_kb=500, p_cap=16, m_cap=1024)
    cost, ts, te, trace = (np.asarray(a) for a in ad.align_padded(*packed))
    assert (cost[7:] == 0).all() and (trace[7:] == 0).all()
    assert (ts[7:] == 0).all() and (te[7:] == 0).all()


def test_pack_batch_refuses_over_capacity():
    rng = np.random.default_rng(2)
    args = _mkbatch(3, rng)
    with pytest.raises(ValueError):
        ad.pack_batch(*args, max_cost_per_kb=500, p_cap=2, m_cap=1024)
    with pytest.raises(ValueError):
        ad.pack_batch(*args, max_cost_per_kb=500, p_cap=4, m_cap=64)


def test_expand_trace_layout():
    """Each trace byte is the row's op, then its deletions."""
    rows = np.array([0, 1 << 6, (2 << 6) | 2, 3], np.uint8)
    assert ad.expand_trace(rows) == b"=sidd=ddd"
    assert ad.expand_trace(np.array([0, ad.TRACE_ESC], np.uint8)) is None


def _dataset(tmp_path):
    from nanospring_tpu.utils import synth

    rng = np.random.default_rng(17)
    genome = synth.random_genome(12_000, rng)
    reads = synth.make_reads(genome, 40, 900, rng)
    fq = str(tmp_path / "in.fastq")
    synth.write_fastq(fq, reads, gz=False)
    return fq, reads


@pytest.fixture
def small_hook(monkeypatch):
    # the card's shape is 512 pairs; a few dozen keep XLA:CPU quick
    from nanospring_tpu.pipeline import contigs

    monkeypatch.setattr(contigs._DeviceDpHook, "P_CAP", 32)


def test_engine_device_aligner_roundtrip(tmp_path, small_hook):
    from nanospring_tpu.compressor import compress_file
    from nanospring_tpu.config import CompressConfig
    from nanospring_tpu.decompressor import decompress_file

    fq, reads = _dataset(tmp_path)
    arc = str(tmp_path / "o.nstpu")
    res = compress_file(fq, arc, CompressConfig(aligner="device",
                                                pipeline_workers=4),
                        report=False)
    out = str(tmp_path / "o.reads")
    decompress_file(arc, out, report=False)
    with open(out, "rb") as f:
        assert f.read().split(b"\n")[:-1] == reads
    assert res["dp_info"]["dp_backend"] == "device"
    assert res["dp_info"]["device_batches"] > 0
    assert res["pipe_split"]["dp_device"] > 0
    assert res["funnel"].contigs > 0


def test_engine_device_failure_aborts(tmp_path, small_hook, monkeypatch):
    """A device DP error fails the compress; the engine does not fall back
    to the host DP."""
    from nanospring_tpu.compressor import compress_file
    from nanospring_tpu.config import CompressConfig

    calls = []

    def _broken(*a):
        calls.append(1)
        raise FloatingPointError("device lost")

    monkeypatch.setattr(ad, "align_padded", _broken)
    fq, _ = _dataset(tmp_path)
    with pytest.raises(RuntimeError, match="device DP failed") as ei:
        compress_file(fq, str(tmp_path / "o.nstpu"),
                      CompressConfig(aligner="device"), report=False)
    assert isinstance(ei.value.__cause__, FloatingPointError)
    # batches already in flight are rejected without another device call
    assert len(calls) == 1
