"""Parity tests: native hot-loop kernels (native/hot.cpp) vs numpy paths.

The numpy implementations are the oracles; the native versions must match
bit-for-bit (same policy as the aligner backends, tests/test_align_device.py).
"""

import sys

import numpy as np
import pytest

from nanospring_tpu.config import CompressConfig
from nanospring_tpu.io import read_store as rs
from nanospring_tpu.ops import align as al
from nanospring_tpu.pipeline import contigs as cg


@pytest.fixture(scope="module")
def lib():
    from nanospring_tpu import native

    return native.get_lib()


def _mk_store(rng, n_reads=300, max_len=2000, repetitive_frac=0.2):
    lens = rng.integers(5, max_len, n_reads).astype(np.int64)
    nb = (lens + 3) // 4
    offs = np.zeros(n_reads, np.int64)
    np.cumsum(nb[:-1], out=offs[1:])
    packed = np.zeros(int(nb.sum()), np.uint8)
    codes_list = []
    for r in range(n_reads):
        if rng.random() < repetitive_frac:
            unit = rng.integers(0, 4, int(rng.integers(1, 4))).astype(np.uint8)
            c = np.tile(unit, lens[r] // len(unit) + 1)[: lens[r]]
        else:
            c = rng.integers(0, 4, lens[r]).astype(np.uint8)
        codes_list.append(c)
        pad = np.zeros(int(nb[r] * 4), np.uint8)
        pad[: lens[r]] = c
        q = pad.reshape(-1, 4)
        packed[offs[r]: offs[r] + nb[r]] = (
            q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)
        ).astype(np.uint8)
    store = rs.ReadStore(packed, offs, lens, np.zeros(0, np.int64),
                         np.zeros(0, np.int64), np.zeros(0, np.uint8))
    return store, codes_list


def test_unpack_batch_matches_per_read(lib):
    rng = np.random.default_rng(11)
    store, codes_list = _mk_store(rng)
    rids = rng.permutation(store.num_reads)[:100]
    codes, lens = store.get_batch_padded(rids, pad_to=2048, fill=9)
    for i, r in enumerate(rids):
        assert np.array_equal(codes[i, : lens[i]], codes_list[r])
        assert (codes[i, lens[i]:] == 9).all()


def test_repetitive_screen_native_matches_definition(lib):
    rng = np.random.default_rng(12)
    store, codes_list = _mk_store(rng, repetitive_frac=0.3)
    cfg = CompressConfig()
    got = cg.repetitive_screen(store, cfg)
    exp = np.zeros(store.num_reads, bool)
    for r, c in enumerate(codes_list):
        L = len(c)
        if L <= cfg.repetitive_offsets:
            continue
        best = 0.0
        for off in range(1, cfg.repetitive_offsets + 1):
            best = max(best, (c[off:] == c[:-off]).sum() / max(L - off, 1))
        exp[r] = best > cfg.repetitive_threshold
    assert np.array_equal(got, exp)


def test_edit_scripts_native_matches_numpy(lib):
    rng = np.random.default_rng(13)
    P = 150
    ops_list = []
    for _ in range(P):
        n = int(rng.integers(0, 300))
        ops = rng.choice(
            [ord("="), ord("s"), ord("i"), ord("d")], size=n,
            p=[0.8, 0.07, 0.07, 0.06],
        ).astype(np.uint8)
        if n > 10 and rng.random() < 0.5:
            h = int(rng.integers(0, 6))
            t = int(rng.integers(0, 6))
            ops[:h] = ord("i")
            if t:
                ops[n - t:] = ord("i")
        ops_list.append(ops)
    ops_len = np.array([len(o) for o in ops_list], np.int64)
    ops_off = np.zeros(P, np.int64)
    np.cumsum(ops_len[:-1], out=ops_off[1:])
    ops_flat = np.concatenate(ops_list)
    q_len = np.array([int((o != ord("d")).sum()) for o in ops_list], np.int64)
    q_off = np.zeros(P, np.int64)
    np.cumsum(q_len[:-1], out=q_off[1:])
    queries_flat = rng.integers(0, 4, int(q_len.sum())).astype(np.uint8)
    res = al.AlignResult(
        cost=np.zeros(P, np.int32),
        tstart=rng.integers(0, 50, P).astype(np.int64),
        tend=np.zeros(P, np.int64),
        ops_flat=ops_flat, ops_off=ops_off, ops_len=ops_len,
    )
    sel = np.arange(P)
    nat = al._ops_to_edit_scripts_native(lib, res, sel, queries_flat, q_off)

    real = sys.modules.get("nanospring_tpu.native")

    class _NoNative:
        @staticmethod
        def get_lib():
            raise RuntimeError("forced numpy path")

    sys.modules["nanospring_tpu.native"] = _NoNative
    try:
        ref = al.ops_to_edit_scripts(res, sel, queries_flat, q_off, q_len)
    finally:
        sys.modules["nanospring_tpu.native"] = real
    for f in ("start_pos", "head_ins", "tail_ins", "n_edits",
              "runs_flat", "types_flat", "bases_flat"):
        assert np.array_equal(getattr(nat, f), getattr(ref, f)), f
