"""Contig building: sketch-join clustering + wavefront-batched consensus growth.

The reference grows one pointer-DAG contig per OpenMP thread, sliding a
window over the consensus and re-indexing it with minimap2 for every
candidate (reference: src/Consensus.cpp:21-340, src/ConsensusGraph.cpp).
This engine is restructured around batch stages and owner-computes claims:

1. **Sketch** every read once (device kernel, ops/sketch.py, on the GPU).
2. **Join**: one batched index query finds all overlap-candidate pairs
   (reads sharing >= threshold sketch slots) up front — no per-window
   re-queries.
3. **Wavefront growth**: many contigs are grown concurrently. Each step
   drains a cross-contig frontier of (contig, candidate, parent) items:
   host-side anchoring places each candidate on its contig's consensus
   (minimizer match against the BFS parent, whose minimizer positions are
   already mapped to consensus coordinates), then ONE batched banded
   alignment verifies the whole frontier — the batch axis is what the
   accelerator consumes. No index is ever rebuilt (the reference rebuilds
   one per candidate, src/ConsensusGraph.cpp:195-217: its #1 structural
   inefficiency).
4. **Apply**: accepted alignments splice their overhangs into the consensus
   (mosaic growth, both directions). Consensus coordinates are absolute
   (head growth moves ``lo`` negative), so results computed against a
   snapshot stay valid after other batch members splice; a result whose
   clipped overhang could now match newly-grown consensus is retried
   instead, to protect ratio.

Per-batch work is data-parallel over pairs (C++/OpenMP, or the lax DP on
the device); contigs are independent: the parallel axis for hosts/chips.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import numpy as np

from ..config import CompressConfig
from ..io import packed as pk
from ..io.serialize import ContigBatch
from ..ops import align as al
from ..ops import minimizers as mz
from ..ops import sketch as sk
from ..utils.observe import FunnelStats
from . import candidates


# last run's DP backend observability (bench/CLI reporting): which backend
# carried the batch DP, and how many batches ran on the device
DP_INFO: dict = {"dp_backend": "native"}

# last run's pipeline sub-stage walls (seconds) + DP counters — the
# machine-readable analog of the reference's per-stage stdout report
# (src/Compressor.cpp:59-82). Populated by build_contigs / the engine's
# ns_engine_timings; summed across worker processes.
PIPE_STAGES: dict = {}


def _merge_timings(dst: dict, src: dict) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0.0) + float(v)


@dataclasses.dataclass
class _Member:
    rid: int
    strand: int            # 0 forward, 1 reverse-complement
    tstart: int            # consensus coords (origin = seed start, may go <0)
    ops: np.ndarray        # uint8 op bytes
    cost: int


def _sketch_native_into(lib, store, rids: np.ndarray, seeds: np.ndarray,
                        k: int, min_len: int, out: np.ndarray) -> None:
    """Host MinHash for the given read ids, writing rows of ``out``."""
    import ctypes

    rids = np.ascontiguousarray(rids, dtype=np.int64)
    if len(rids) == 0:
        return
    packed = store.packed
    rows = np.empty((len(rids), seeds.shape[0]), dtype=np.uint32)
    s_lo = np.ascontiguousarray(seeds[:, 0])
    s_hi = np.ascontiguousarray(seeds[:, 1])
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ns_sketch_reads(
        packed.ctypes.data_as(u8p), store.offsets.ctypes.data_as(i64p),
        store.lengths.ctypes.data_as(i64p), rids.ctypes.data_as(i64p),
        ctypes.c_int64(len(rids)),
        s_lo.ctypes.data_as(u32p), s_hi.ctypes.data_as(u32p),
        ctypes.c_int64(seeds.shape[0]), ctypes.c_int64(k),
        ctypes.c_int64(min_len), rows.ctypes.data_as(u32p))
    out[rids] = rows


def sketch_backend() -> str:
    """``"device"`` when JAX runs on a GPU, else ``"native"`` (host C++).

    Both backends produce identical bits (native/sketch.cpp implements the
    exact hash family of ops/sketch.py), so the choice never changes the
    candidate graph.
    """
    import jax

    return "device" if jax.default_backend() == "gpu" else "native"


def compute_all_sketches(store, cfg: CompressConfig) -> np.ndarray:
    """Sketch every read on the backend :func:`sketch_backend` names."""
    N = store.num_reads
    seeds = sk.make_seeds(cfg.num_hashes, cfg.sketch_seed)
    out = np.full((N, cfg.num_hashes), sk.EMPTY_SLOT, dtype=np.uint32)
    min_len = max(cfg.kmer_size, cfg.min_read_len_for_sketch)
    device = sketch_backend() == "device"
    PIPE_STAGES["sketch_backend_device"] = float(device)
    if not device:
        from .. import native as _nat

        _sketch_native_into(_nat.get_lib(), store, np.arange(N, dtype=np.int64),
                            seeds, cfg.kmer_size, min_len, out)
        return out

    order = np.argsort(store.lengths, kind="stable")
    # fixed pad buckets limit recompilation: powers of two
    i = 0
    while i < N:
        L0 = int(store.lengths[order[i]])
        if L0 < min_len:
            i += 1
            continue
        pad = 1 << max(8, (L0 - 1).bit_length())
        # take all reads fitting this bucket
        j = i
        while j < N and store.lengths[order[j]] <= pad and j - i < cfg.sketch_batch_reads:
            j += 1
        rids = order[i:j]
        packed, lens = store.get_batch_packed(rids, pad_to=pad)
        out[rids] = np.asarray(sk.sketch_batch_packed(
            packed, lens.astype(np.int32), seeds, k=cfg.kmer_size))
        i = j
    return out


def repetitive_screen(store, cfg: CompressConfig) -> np.ndarray:
    """Self-similar (repetitive) read mask, vectorized over padded batches.

    The reference computes per-read Hamming self-similarity at offsets 1..6
    and flags reads above 0.7 (checkRepetitive, src/Consensus.cpp:405-424);
    repetitive reads are never seeded or claimed (:203-208) because their
    sketches recruit spurious overlaps. Same screen here as shifted-equality
    means over (B, Lpad) code matrices (numpy fallback); the native path
    runs the per-read scan directly on the packed store (hot.cpp).
    """
    N = store.num_reads
    try:
        from .. import native as _nat

        lib = _nat.get_lib()
    except Exception:
        lib = None
    if lib is not None and hasattr(store, "packed"):
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        packed = store.packed
        if not packed.flags["C_CONTIGUOUS"]:
            packed = np.ascontiguousarray(packed)
        mask = np.zeros(N, dtype=np.uint8)
        lib.ns_repetitive_screen(
            packed.ctypes.data_as(u8p),
            store.offsets.ctypes.data_as(i64p),
            store.lengths.ctypes.data_as(i64p),
            ctypes.c_int64(N), ctypes.c_int32(cfg.repetitive_offsets),
            ctypes.c_int32(int(round(cfg.repetitive_threshold * 1e6))),
            mask.ctypes.data_as(u8p),
        )
        return mask.astype(bool)
    rep = np.zeros(N, dtype=bool)
    order = np.argsort(store.lengths, kind="stable")
    maxoff = cfg.repetitive_offsets
    thr = cfg.repetitive_threshold
    i = 0
    while i < N:
        L0 = int(store.lengths[order[i]])
        if L0 <= maxoff:
            i += 1
            continue
        pad = 1 << max(8, (L0 - 1).bit_length())
        j = i
        while j < N and store.lengths[order[j]] <= pad and j - i < 4096:
            j += 1
        rids = order[i:j]
        codes, lens = store.get_batch_padded(rids, pad_to=pad, fill=255)
        best = np.zeros(len(rids))
        pos = np.arange(pad, dtype=np.int64)
        for off in range(1, maxoff + 1):
            eq = codes[:, off:] == codes[:, :-off]
            real = pos[None, : pad - off] < (lens - off)[:, None]
            valid = np.maximum(lens - off, 1)
            frac = (eq & real).sum(axis=1) / valid
            best = np.maximum(best, frac)
        rep[rids] = best > thr
        i = j
    return rep


def _orient_codes(codes: np.ndarray, strand: int) -> np.ndarray:
    return pk.revcomp_codes(codes) if strand else codes


def _mirror_anchors(h, p, f, read_len: int, k: int):
    """Minimizer set of the reverse complement, derived for free.

    Canonical k-mer hashes are strand-invariant, positions mirror to
    read_len - k - pos, and the forward-is-canonical flag flips.
    """
    return h, (read_len - k) - p, ~f


class _ContigState:
    """Mutable consensus + placed-member anchor tables for one contig."""

    def __init__(self, cid: int, seed_rid: int, seed_codes: np.ndarray,
                 cfg: CompressConfig):
        self.cid = cid
        self.cfg = cfg
        # consensus lives in a slack buffer so head/tail growth is amortized
        # O(growth) instead of O(len) per accept (contigs reach megabases)
        n = len(seed_codes)
        self._buf = np.empty(2 * n + 512, dtype=np.uint8)
        self._start = n // 2 + 128
        self._len = n
        self._buf[self._start: self._start + n] = seed_codes
        self.lo = 0  # consensus coords of cons[0]
        self.members: list[_Member] = []
        self.total_aligned = 0
        self.pending = 0       # frontier items referencing this contig
        self.closed = False    # edge_threshold reached: stop growing
        # parent anchor tables: rid -> (hash, tpos, fwdflag)
        self.anchors: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    @property
    def cons(self) -> np.ndarray:
        return self._buf[self._start: self._start + self._len]

    @cons.setter
    def cons(self, arr: np.ndarray) -> None:
        arr = np.asarray(arr, dtype=np.uint8)
        self._buf = arr.copy() if arr.base is self._buf else arr
        self._start = 0
        self._len = len(arr)

    def _prepend(self, codes: np.ndarray) -> None:
        n = len(codes)
        if n > self._start:
            grow = max(n, self._len) + 512
            nb = np.empty(grow + self._start + len(self._buf), dtype=np.uint8)
            nb[grow + self._start: grow + self._start + self._len] = self.cons
            self._buf = nb
            self._start += grow
        self._start -= n
        self._len += n
        self._buf[self._start: self._start + n] = codes

    def _append(self, codes: np.ndarray) -> None:
        n = len(codes)
        end = self._start + self._len
        if end + n > len(self._buf):
            grow = max(n, self._len) + 512
            nb = np.empty(len(self._buf) + grow, dtype=np.uint8)
            nb[self._start: end] = self.cons
            self._buf = nb
        self._buf[end: end + n] = codes
        self._len += n

    @property
    def hi(self) -> int:
        return self.lo + self._len

    def add_seed_member(self, rid: int, codes: np.ndarray) -> None:
        ops = np.full(len(codes), ord("="), dtype=np.uint8)
        self.members.append(_Member(rid, 0, 0, ops, 0))
        h, p, f = mz.minimizers(codes, self.cfg.seed_kmer_size, self.cfg.seed_window)
        self.anchors[rid] = mz.prepare_anchors(h, p.astype(np.int64), f)
        self.total_aligned += len(codes)

    def accept(self, rid: int, is_rc: int, tstart_abs: int, tend_abs: int,
               ops: np.ndarray, cost: int, codes: np.ndarray,
               fwd_anchors) -> None:
        """Record an accepted alignment; splice overhangs into the consensus.

        ``ops`` may begin/end with 'i' runs (clipped overhangs). If an 'i'
        run touches the consensus end it becomes consensus growth (the run
        flips to '='); otherwise it stays an insertion run — lossless either
        way, growth is just better for ratio.
        """
        cfg = self.cfg
        mlen = len(codes)
        head = 0
        while head < len(ops) and ops[head] == ord("i"):
            head += 1
        tail = 0
        while tail < len(ops) and ops[len(ops) - 1 - tail] == ord("i"):
            tail += 1
        if head and tstart_abs == self.lo:
            self._prepend(codes[:head])
            self.lo -= head
            ops[:head] = ord("=")
            tstart_abs -= head
        if tail and tend_abs == self.hi and head + tail <= len(ops):
            self._append(codes[mlen - tail:])
            ops[len(ops) - tail:] = ord("=")

        self.members.append(_Member(rid, is_rc, tstart_abs, ops, cost))
        self.total_aligned += mlen

        # anchor table for this member: minimizer positions mapped through
        # the alignment into consensus coords (oriented coords -> tpos).
        # Positions inside 'i' runs are DROPPED: an inserted query base has
        # no target position (q2t collapses whole runs onto one cursor
        # value), and anchors built there would hand children wildly wrong
        # diagonals — a self-reinforcing misplacement cascade.
        # fwd_anchors is already prepared (sorted-unique), so the output
        # table is too (native one-pass in ops/minimizers.accept_anchors).
        h, p, f = fwd_anchors
        self.anchors[rid] = mz.accept_anchors(
            ops, tstart_abs, mlen, is_rc, cfg.seed_kmer_size, h, p, f)


def _check_member(st: _ContigState, m: _Member, codes: np.ndarray | None = None,
                  store=None) -> None:
    """Edit-script replay equality: walking the member's op tape over the
    live consensus must reproduce the oriented read exactly ('=' ops match,
    cursors end exactly at read/consensus bounds). The reference runs the
    same invariant after every alignment and graph update under -DCHECKS
    (src/Consensus.cpp:280-337, src/ConsensusGraph.cpp:1187-1239)."""
    if codes is None:
        codes = _orient_codes(store.get_codes(m.rid), m.strand)
    ops = m.ops
    consumes_t = ops != ord("i")
    consumes_q = ops != ord("d")
    if int(consumes_q.sum()) != len(codes):
        raise AssertionError(
            f"rid {m.rid}: ops consume {int(consumes_q.sum())} query bases, "
            f"read has {len(codes)}")
    tcol = (m.tstart - st.lo) + np.cumsum(consumes_t) - consumes_t
    qpos = np.cumsum(consumes_q) - consumes_q
    eq = ops == ord("=")
    cols = tcol[eq]
    if len(cols) and (cols.min() < 0 or cols.max() >= len(st.cons)):
        raise AssertionError(f"rid {m.rid}: '=' column out of consensus bounds")
    if not np.array_equal(st.cons[cols], codes[qpos[eq]]):
        raise AssertionError(f"rid {m.rid}: '=' ops disagree with consensus")
    sub = ops == ord("s")
    if sub.any() and (st.cons[tcol[sub]] == codes[qpos[sub]]).any():
        raise AssertionError(f"rid {m.rid}: 's' op where bases match")


def check_contigs(states: list, store) -> None:
    """Run the -DCHECKS invariants over every member of every contig."""
    for st in states:
        for m in st.members:
            _check_member(st, m, store=store)


def _polish_contig(state: _ContigState, store) -> None:
    """Majority-vote substitution polish of the consensus (one pass).

    The mosaic consensus keeps the seed read's bases in the interior, so
    every member pays an 's' edit wherever the seed erred (~error-rate of
    the seed, at full coverage). The reference fixes this with weighted
    heaviest-path recompute (src/ConsensusGraph.cpp:559-615
    calculateMainPathGreedy); here the same effect is a vectorized pileup
    vote. Substitution-only polish is purely mechanical on the op tapes:
    'd' consumes no base and literals are re-extracted from the query codes
    downstream (ops_to_edit_scripts), so changing consensus column c from X
    to Y just flips members' ops at c between '=' and 's' — no re-alignment.
    """
    members = state.members
    if len(members) < 3:
        return
    L = len(state.cons)
    vote_keys = []
    per_member = []  # (ops_idx_of_base_ops, tcols, bases)
    for m in members:
        ops = m.ops
        consumes_t = ops != ord("i")
        tcol = (m.tstart - state.lo) + np.cumsum(consumes_t) - consumes_t
        consumes_q = ops != ord("d")
        qpos = np.cumsum(consumes_q) - consumes_q
        codes = _orient_codes(store.get_codes(m.rid), m.strand)
        has_base = consumes_t & consumes_q          # '=' or 's'
        cols = tcol[has_base]
        bases = codes[qpos[has_base]]
        vote_keys.append(cols * 4 + bases)
        per_member.append((has_base, cols, bases))
    votes = np.bincount(
        np.concatenate(vote_keys), minlength=L * 4
    ).reshape(L, 4)

    best = np.argmax(votes, axis=1).astype(np.uint8)
    old = state.cons
    maxv = votes[np.arange(L), best]
    oldv = votes[np.arange(L), old]
    new = np.where((maxv > oldv), best, old)        # ties keep the old base
    if not (new != old).any():
        return
    state.cons = new.astype(np.uint8)
    for m, (has_base, cols, bases) in zip(members, per_member):
        newop = np.where(bases == new[cols], np.uint8(ord("=")), np.uint8(ord("s")))
        m.ops[has_base] = newop


def _excl_cumsum64(x: np.ndarray) -> np.ndarray:
    out = np.zeros(len(x), dtype=np.int64)
    if len(x) > 1:
        np.cumsum(x[:-1], out=out[1:])
    return out


def _member_codes_flat(states: list, store):
    """Oriented query codes of every member of every contig, flat (native)."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    rids = np.array([m.rid for st in states for m in st.members], np.int64)
    strand = np.array([m.strand for st in states for m in st.members], np.uint8)
    codes_len = store.lengths[rids].astype(np.int64)
    codes_off = _excl_cumsum64(codes_len)
    codes_flat = np.empty(int(codes_len.sum()), np.uint8)
    packed = store.packed
    if not packed.flags["C_CONTIGUOUS"]:
        packed = np.ascontiguousarray(packed)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ns_unpack_oriented(
        packed.ctypes.data_as(u8p),
        store.offsets.ctypes.data_as(i64p),
        store.lengths.ctypes.data_as(i64p),
        rids.ctypes.data_as(i64p), strand.ctypes.data_as(u8p),
        ctypes.c_int64(len(rids)), codes_off.ctypes.data_as(i64p),
        codes_flat.ctypes.data_as(u8p),
    )
    return codes_flat, codes_off, codes_len


def _polish_batch_native(states: list, store) -> bool:
    """Batched C++ polish of all contigs (native/polish.cpp); mutates the
    states in place. Returns False when the native lib is unavailable so
    the caller can fall back to the numpy oracle path."""
    try:
        import ctypes

        from .. import native

        lib = native.get_lib()
    except Exception:
        return False
    C = len(states)
    if C == 0:
        return True
    cons_len = np.array([len(st.cons) for st in states], np.int64)
    cons_off = _excl_cumsum64(cons_len)
    cons_flat = (np.concatenate([st.cons for st in states])
                 if C else np.zeros(0, np.uint8)).astype(np.uint8, copy=False)
    m_cnt = np.array([len(st.members) for st in states], np.int64)
    m_off = _excl_cumsum64(m_cnt)
    members = [m for st in states for m in st.members]
    M = len(members)
    ops_len = np.array([len(m.ops) for m in members], np.int64)
    ops_off = _excl_cumsum64(ops_len)
    ops_flat = (np.concatenate([m.ops for m in members])
                if M else np.zeros(0, np.uint8)).astype(np.uint8, copy=False)
    tstart_rel = np.empty(M, np.int64)
    k = 0
    for st in states:
        for m in st.members:
            tstart_rel[k] = m.tstart - st.lo
            k += 1
    codes_flat, codes_off, _ = _member_codes_flat(states, store)

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    out_cons_total = ctypes.c_int64()
    out_ops_total = ctypes.c_int64()
    h = lib.ns_polish_batch(
        cons_flat.ctypes.data_as(u8p), cons_off.ctypes.data_as(i64p),
        cons_len.ctypes.data_as(i64p), ctypes.c_int64(C),
        ops_flat.ctypes.data_as(u8p), ops_off.ctypes.data_as(i64p),
        ops_len.ctypes.data_as(i64p), tstart_rel.ctypes.data_as(i64p),
        m_off.ctypes.data_as(i64p), m_cnt.ctypes.data_as(i64p),
        codes_flat.ctypes.data_as(u8p), codes_off.ctypes.data_as(i64p),
        ctypes.byref(out_cons_total), ctypes.byref(out_ops_total),
    )
    try:
        new_cons_flat = np.empty(out_cons_total.value, np.uint8)
        new_cons_len = np.empty(C, np.int64)
        new_ops_flat = np.empty(out_ops_total.value, np.uint8)
        new_ops_len = np.empty(M, np.int64)
        new_tstart = np.empty(M, np.int64)
        lib.ns_polish_fetch(
            ctypes.c_void_p(h),
            new_cons_flat.ctypes.data_as(u8p), new_cons_len.ctypes.data_as(i64p),
            new_ops_flat.ctypes.data_as(u8p), new_ops_len.ctypes.data_as(i64p),
            new_tstart.ctypes.data_as(i64p),
        )
    finally:
        lib.ns_polish_free(ctypes.c_void_p(h))
    # unflatten
    oo = 0
    mi = 0
    cpos = 0
    ci = 0
    for st in states:
        L = int(new_cons_len[ci])
        st.cons = new_cons_flat[cpos: cpos + L].copy()
        cpos += L
        ci += 1
        for m in st.members:
            ln = int(new_ops_len[mi])
            m.ops = new_ops_flat[oo: oo + ln].copy()
            m.tstart = st.lo + int(new_tstart[mi])
            oo += ln
            mi += 1
    return True


def _member_tape(state: _ContigState, store, m: _Member):
    """Per-op (target column, query pos, codes) arrays for one member."""
    ops = m.ops
    consumes_t = ops != ord("i")
    tcol = (m.tstart - state.lo) + np.cumsum(consumes_t) - consumes_t
    consumes_q = ops != ord("d")
    qpos = np.cumsum(consumes_q) - consumes_q
    codes = _orient_codes(store.get_codes(m.rid), m.strand)
    return ops, consumes_t, tcol, consumes_q, qpos, codes


def _polish_indels(state: _ContigState, store) -> None:
    """Column-voting indel polish (one pass each of deletions, insertions).

    Seed-read indel errors survive in the consensus: every member pays a
    'd' at a spurious column and an 'i' at a missing one (the reference
    heals these through its weighted DAG re-extension,
    src/ConsensusGraph.cpp:559-615). Both fixes are mechanical op rewrites:

    - delete column c (majority 'd' there): members' 'd' ops at c vanish;
      members with a base there keep it as an 'i' (literals re-extracted
      from query codes downstream).
    - insert base b at gap g (majority of spanning members carry a first
      'i' of base b there): those 'i' ops flip to '='; other spanning
      members gain a 'd'.
    """
    members = state.members
    if len(members) < 3:
        return

    # --- deletions ---------------------------------------------------------
    L = len(state.cons)
    dv_keys, bv_keys = [], []
    for m in members:
        ops, consumes_t, tcol, consumes_q, qpos, codes = _member_tape(state, store, m)
        dv_keys.append(tcol[ops == ord("d")])
        bv_keys.append(tcol[consumes_t & consumes_q])
    del_votes = np.bincount(np.concatenate(dv_keys), minlength=L + 1)
    base_votes = np.bincount(np.concatenate(bv_keys), minlength=L + 1)
    delmask = del_votes[:L] > base_votes[:L]
    if delmask.any():
        ndel_before = np.cumsum(delmask) - delmask
        for m in members:
            ops = m.ops
            consumes_t = ops != ord("i")
            tcol = (m.tstart - state.lo) + np.cumsum(consumes_t) - consumes_t
            at_del = consumes_t & delmask[np.minimum(tcol, L - 1)] & (tcol < L)
            if not at_del.any():
                ts_rel = m.tstart - state.lo
                m.tstart = state.lo + ts_rel - int(ndel_before[min(ts_rel, L - 1)])
                continue
            drop = at_del & (ops == ord("d"))
            to_i = at_del & (ops != ord("d"))
            ops2 = ops.copy()
            ops2[to_i] = ord("i")
            m.ops = ops2[~drop]
            ts_rel = m.tstart - state.lo
            m.tstart = state.lo + ts_rel - int(ndel_before[min(ts_rel, L - 1)])
        state.cons = state.cons[~delmask]

    # --- insertions --------------------------------------------------------
    L = len(state.cons)
    iv = np.zeros((L + 1, 4), np.int64)
    cov = np.zeros(L + 3, np.int64)
    tapes = []
    for m in members:
        tape = _member_tape(state, store, m)
        tapes.append(tape)
        ops, consumes_t, tcol, consumes_q, qpos, codes = tape
        n = len(ops)
        if n == 0 or not consumes_t.any():
            continue
        isi = ~consumes_t
        idx = np.arange(n)
        first_c = int(np.argmax(consumes_t))
        last_c = n - 1 - int(np.argmax(consumes_t[::-1]))
        interior = isi & (idx > first_c) & (idx < last_c)
        ii = np.flatnonzero(interior)
        ts_rel = int(tcol[first_c])
        te_rel = int(tcol[last_c]) + 1
        cov[ts_rel + 1] += 1
        cov[max(te_rel, ts_rel + 1)] -= 1
        if len(ii):
            gaps = tcol[ii]
            bases = codes[qpos[ii]]
            firstmask = np.ones(len(ii), bool)
            firstmask[1:] = gaps[1:] != gaps[:-1]
            np.add.at(iv, (gaps[firstmask], bases[firstmask]), 1)
    cov = np.cumsum(cov)[: L + 1]
    best_b = np.argmax(iv, axis=1)
    best_v = iv[np.arange(L + 1), best_b]
    insmask = best_v * 2 > np.maximum(cov, 1)
    ins_gaps = np.flatnonzero(insmask)
    if len(ins_gaps) == 0:
        return
    ins_base = best_b[ins_gaps].astype(np.uint8)
    gap_newbase = np.full(L + 1, 255, np.uint8)
    gap_newbase[ins_gaps] = ins_base
    nins_leq = np.cumsum(insmask)          # inserted gaps with index <= c
    for m, tape in zip(members, tapes):
        ops, consumes_t, tcol, consumes_q, qpos, codes = tape
        n = len(ops)
        if n == 0 or not consumes_t.any():
            continue
        idx = np.arange(n)
        first_c = int(np.argmax(consumes_t))
        last_c = n - 1 - int(np.argmax(consumes_t[::-1]))
        ts_rel = int(tcol[first_c])
        te_rel = int(tcol[last_c]) + 1
        isi = ~consumes_t
        interior = isi & (idx > first_c) & (idx < last_c)
        ii = np.flatnonzero(interior)
        flip = np.zeros(n, bool)
        matched_gap = np.zeros(L + 1, bool)
        if len(ii):
            gaps = tcol[ii]
            firstmask = np.ones(len(ii), bool)
            firstmask[1:] = gaps[1:] != gaps[:-1]
            fi = ii[firstmask]
            fgaps = tcol[fi]
            fbase = codes[qpos[fi]]
            hit = insmask[fgaps] & (fbase == gap_newbase[fgaps])
            flip[fi[hit]] = True
            matched_gap[fgaps[hit]] = True
        ops2 = ops.copy()
        ops2[flip] = ord("=")
        # spanning gaps without a matching first-'i' gain a 'd' before the
        # op that consumes column g
        need_d = insmask.copy()
        need_d[: ts_rel + 1] = False
        need_d[te_rel:] = False
        need_d &= ~matched_gap
        dg = np.flatnonzero(need_d)
        if len(dg):
            # position: first op with consumes_t and tcol == g
            pos = np.searchsorted(tcol[consumes_t], dg)
            cons_idx = np.flatnonzero(consumes_t)
            at = cons_idx[pos]
            ops2 = np.insert(ops2, at, ord("d"))
        m.ops = ops2
        m.tstart = state.lo + ts_rel + int(nins_leq[ts_rel])
    state.cons = np.insert(state.cons, ins_gaps, ins_base)


def _emit_group(states: list, store) -> dict:
    """Pack a group of finished contigs into flat member-order arrays.

    One edit-script extraction call over every member of every contig —
    the batch axis replaces the reference's per-read writeRead loop
    (src/ConsensusGraph.cpp:984-1178).
    """
    members = [m for st in states for m in st.members]
    M = len(members)
    ops_len = np.array([len(m.ops) for m in members], dtype=np.int64)
    ops_off = _excl_cumsum64(ops_len)
    ops_flat = np.concatenate([m.ops for m in members]) if M else np.zeros(0, np.uint8)
    rids = np.array([m.rid for m in members], dtype=np.int64)
    strands = np.array([m.strand for m in members], dtype=np.uint8)
    tstarts = np.empty(M, dtype=np.int64)
    k = 0
    for st in states:
        for m in st.members:
            tstarts[k] = m.tstart - st.lo
            k += 1

    # oriented query codes for literal extraction
    try:
        queries_flat, q_off, q_len = _member_codes_flat(states, store)
    except Exception:
        q_len = store.lengths[rids].astype(np.int64) if M else np.zeros(0, np.int64)
        q_off = _excl_cumsum64(q_len)
        qparts = [_orient_codes(store.get_codes(m.rid), m.strand) for m in members]
        queries_flat = np.concatenate(qparts) if M else np.zeros(0, np.uint8)

    res = al.AlignResult(
        cost=np.zeros(M, np.int32), tstart=tstarts,
        tend=np.zeros(M, np.int64),
        ops_flat=ops_flat, ops_off=ops_off, ops_len=ops_len,
    )
    es = al.ops_to_edit_scripts(res, np.arange(M), queries_flat, q_off, q_len)
    trace = os.environ.get("NSTPU_TRACE")
    if trace:
        # per-contig trace lines (the reference's -DLOG per-thread logfile
        # timelines, src/Consensus.cpp:32-49); lines carry the pid because
        # grow workers append concurrently and contig indices are per-group
        pid = os.getpid()
        lines = "".join(
            f"pid {pid} contig {i} members={len(st.members)} "
            f"cons_len={len(st.cons)} lo={st.lo}\n"
            for i, st in enumerate(states))
        with open(trace, "a") as f:
            f.write(lines)
    return {
        "consensus_list": [st.cons for st in states],
        "reads_per_contig": np.array([len(st.members) for st in states], np.int64),
        "ids": rids,
        "strand": strands,
        "es": es,
    }


@dataclasses.dataclass
class _Item:
    """One frontier entry: candidate rid to be placed on contig cid."""
    cid: int
    rid: int
    parent: int
    attempts: int = 0


@dataclasses.dataclass
class _Placed:
    """A frontier item that anchored successfully, ready for banded DP."""
    item: _Item
    is_rc: int
    codes: np.ndarray       # oriented query codes
    qlo: int
    qhi: int
    wlo: int                # consensus-coord window passed as DP target
    whi: int
    snap_lo: int            # contig extent at placement time
    snap_hi: int
    d0_win: int             # expected diagonal in window/clipped coords
    fwd_anchors: tuple      # candidate's forward-orientation minimizers


class _Wavefront:
    """Cross-contig frontier scheduler around the batched aligner."""

    def __init__(self, store, cfg: CompressConfig, stats: FunnelStats,
                 adj_off: np.ndarray, adj: np.ndarray, claimed: np.ndarray,
                 comp_of: np.ndarray):
        self.store = store
        self.cfg = cfg
        self.stats = stats
        self.adj_off = adj_off
        self.adj = adj
        self.claimed = claimed
        self.states: dict[int, _ContigState] = {}
        self.queue: list[_Item] = []
        self.done: list[_ContigState] = []
        self.visited: dict[int, set] = {}  # cid -> rids ever enqueued
        self._mz_cache: dict[int, tuple] = {}
        self._next_cid = 0
        # Contigs per component: unconstrained concurrent seeds inside one
        # component fragment it into competing contigs, but one contig at a
        # time starves the alignment batch (frontier width ~ coverage). So
        # extra seeds are allowed only where no frontier has reached yet
        # (``touched`` = enqueued by any contig): contigs stay >=2 hops
        # apart and meet at claim boundaries — the same partitioning the
        # reference gets from its per-thread contigs
        # (reference: src/Consensus.cpp:41,444-468, thread-count-dependent).
        self.comp_of = comp_of
        self.touched = np.zeros(len(claimed), dtype=bool)
        self._comp_cursor: dict[int, int] = {}  # comp -> next seed scan pos
        self._comp_phase: dict[int, int] = {}   # 0 = fresh pass, 1 = residual
        self._comp_members: dict[int, np.ndarray] = {}
        self.comp_active: dict[int, int] = {}   # comp -> live contig count

    # -- contig lifecycle ---------------------------------------------------

    def register_component(self, comp: int, members: np.ndarray) -> None:
        self._comp_members[comp] = members
        self._comp_cursor[comp] = 0
        self._comp_phase[comp] = 0
        self.comp_active[comp] = 0

    def expandable_comps(self) -> list[int]:
        return [c for c, ph in self._comp_phase.items()
                if ph == 0 and c in self._comp_members]

    def activate_next_in_comp(self, comp: int, fresh_only: bool = False) -> bool:
        """Claim the next eligible seed of a component; False if none.

        The fresh pass only seeds untouched reads (keeps concurrent contigs
        separated); the residual pass reclaims unclaimed leftovers and only
        runs once the component has no live contigs. Iterates until an
        activated seed actually has work (a seed whose neighbors were all
        claimed by earlier contigs finalizes instantly).
        """
        min_len = max(self.cfg.kmer_size, self.cfg.min_read_len_for_sketch)
        while True:
            members = self._comp_members.get(comp)
            if members is None:
                return False
            fresh = self._comp_phase[comp] == 0
            if not fresh and (fresh_only or self.comp_active.get(comp, 0) > 0):
                return False
            cur = self._comp_cursor[comp]
            seed = -1
            while cur < len(members):
                s = int(members[cur])
                cur += 1
                if self.claimed[s] or self.store.lengths[s] < min_len:
                    continue
                if fresh and self.touched[s]:
                    continue
                seed = s
                break
            self._comp_cursor[comp] = cur
            if seed < 0:
                if fresh:
                    self._comp_phase[comp] = 1
                    self._comp_cursor[comp] = 0
                    continue
                del self._comp_members[comp]
                return False
            if self._activate_seed(seed):
                return True

    def _activate_seed(self, seed: int) -> bool:
        """Start a contig at ``seed``; False if it had no live frontier."""
        self.claimed[seed] = True
        self.touched[seed] = True
        cid = self._next_cid
        self._next_cid += 1
        st = _ContigState(cid, seed, self.store.get_codes(seed), self.cfg)
        st.add_seed_member(seed, st.cons)
        self.states[cid] = st
        self.visited[cid] = {seed}
        self.comp_active[int(self.comp_of[seed])] += 1
        self._enqueue_children(st, seed)
        if st.pending == 0:
            self._finalize(st, reseed=False)
            return False
        return True

    def _enqueue_children(self, st: _ContigState, rid: int) -> None:
        vis = self.visited[st.cid]
        for r2 in self.adj[self.adj_off[rid]: self.adj_off[rid + 1]]:
            r2 = int(r2)
            if not self.claimed[r2] and r2 not in vis:
                vis.add(r2)
                self.touched[r2] = True
                self.queue.append(_Item(st.cid, r2, rid))
                st.pending += 1

    def _finalize(self, st: _ContigState, reseed: bool = True) -> None:
        if st.cid not in self.states:
            return
        del self.states[st.cid]
        del self.visited[st.cid]
        if len(st.members) > 1:
            self.done.append(st)
        else:
            self.claimed[st.members[0].rid] = False  # lone after all
        comp = int(self.comp_of[st.members[0].rid])
        self.comp_active[comp] -= 1
        if reseed:
            # hand the component to its next unclaimed seed (residual reads
            # the finished contig failed to absorb get their own chance)
            self.activate_next_in_comp(comp)

    # -- frontier batch -----------------------------------------------------

    def _align(self, tf, t_off, t_len, qf, q_off, q_len, d0) -> al.AlignResult:
        """One frontier batch on the exact host DP."""
        return al.banded_align_batch(
            tf, t_off, t_len, qf, q_off, q_len, d0,
            band=self.cfg.band_width,
            max_cost_per_kb=int(self.cfg.max_edit_frac * 1000),
        )

    def _forward_minimizers(self, rid: int, codes: np.ndarray):
        a = self._mz_cache.get(rid)
        if a is None:
            h, p, f = mz.minimizers(codes, self.cfg.seed_kmer_size,
                                    self.cfg.seed_window)
            a = mz.prepare_anchors(h, p.astype(np.int64), f)
            self._mz_cache[rid] = a
        return a

    def _place(self, it: _Item) -> _Placed | None:
        """Host anchoring: candidate -> (orientation, clipped window, d0)."""
        cfg = self.cfg
        st = self.states.get(it.cid)
        if st is None or st.closed:
            return None
        pa = st.anchors.get(it.parent)
        if pa is None:
            return None
        codes_fwd = self.store.get_codes(it.rid)
        r_h, r_p, r_f = self._forward_minimizers(it.rid, codes_fwd)
        if len(r_h) == 0:
            return None
        m = mz.match_anchors_prepared(
            pa[0], pa[1], pa[2], r_h, r_p, r_f, len(codes_fwd),
            cfg.seed_kmer_size, max_anchors=cfg.max_chain_iter,
        )
        if m is None:
            return None
        is_rc, d0_abs, _votes = m
        codes = _orient_codes(codes_fwd, int(is_rc))
        mlen = len(codes)
        band = cfg.band_width
        # clip the query to the predicted overlap window: overhangs past the
        # consensus ends would walk out of the band as insertion runs, so
        # align only [qlo, qhi) and re-attach the clipped ends as head/tail
        # insertions (which accept() converts to consensus growth).
        qlo = max(0, (st.lo - d0_abs) - band // 2)
        qhi = min(mlen, (st.hi - d0_abs) + band // 2)
        if qhi - qlo < cfg.min_overlap:
            return None
        # clip the DP target to the band-reachable consensus window
        wlo = max(st.lo, d0_abs + qlo - band)
        whi = min(st.hi, d0_abs + qhi + band)
        return _Placed(
            item=it, is_rc=int(is_rc), codes=codes, qlo=qlo, qhi=qhi,
            wlo=wlo, whi=whi, snap_lo=st.lo, snap_hi=st.hi,
            d0_win=(d0_abs + qlo) - wlo,
            fwd_anchors=(r_h, r_p, r_f),
        )

    def collect_batch(self) -> tuple[list[_Placed], list[_Item]]:
        """Pop + place up to align_batch frontier items (host-side work)."""
        batch: list[_Placed] = []
        consumed: list[_Item] = []
        while self.queue and len(batch) < self.cfg.align_batch:
            it = self.queue.pop()
            consumed.append(it)
            if self.claimed[it.rid]:
                continue
            self.stats.not_claimed += 1
            p = self._place(it)
            if p is not None:
                batch.append(p)
        return batch, consumed

    def build_arrays(self, batch: list[_Placed]):
        """Snapshot the batch's DP inputs (targets copied out of the live
        consensus buffers, so later splices can't corrupt an in-flight DP)."""
        if not batch:
            return None
        t_parts = [self.states[p.item.cid].cons[p.wlo - self.states[p.item.cid].lo:
                                                p.whi - self.states[p.item.cid].lo]
                   for p in batch]
        q_parts = [p.codes[p.qlo:p.qhi] for p in batch]
        t_len = np.array([len(t) for t in t_parts], dtype=np.int64)
        q_len = np.array([len(q) for q in q_parts], dtype=np.int64)
        t_off = np.zeros(len(batch), np.int64)
        np.cumsum(t_len[:-1], out=t_off[1:])
        q_off = np.zeros(len(batch), np.int64)
        np.cumsum(q_len[:-1], out=q_off[1:])
        return (np.concatenate(t_parts), t_off, t_len,
                np.concatenate(q_parts), q_off, q_len,
                np.array([p.d0_win for p in batch], np.int64))

    def apply_batch(self, batch: list[_Placed], consumed: list[_Item],
                    res: al.AlignResult | None) -> None:
        if res is not None:
            for bi, p in enumerate(batch):
                self._apply(p, res, bi)
        # decrement pending and finalize drained contigs
        for it in consumed:
            st = self.states.get(it.cid)
            if st is None:
                continue
            st.pending -= 1
            if st.pending == 0:
                self._finalize(st)

    def run_batch(self) -> None:
        batch, consumed = self.collect_batch()
        arrays = self.build_arrays(batch)
        res = self._align(*arrays) if arrays else None
        self.apply_batch(batch, consumed, res)

    def _apply(self, p: _Placed, res: al.AlignResult, bi: int) -> None:
        it = p.item
        st = self.states.get(it.cid)
        if st is None or st.closed or self.claimed[it.rid]:
            return
        if res.cost[bi] < 0:
            return
        mlen = len(p.codes)
        core_ops = res.ops_flat[res.ops_off[bi]: res.ops_off[bi] + res.ops_len[bi]]
        ops = np.concatenate([
            np.full(p.qlo, ord("i"), dtype=np.uint8),
            core_ops,
            np.full(mlen - p.qhi, ord("i"), dtype=np.uint8),
        ])
        tstart_abs = p.wlo + int(res.tstart[bi])
        tend_abs = p.wlo + int(res.tend[bi])
        # The result wanted to splice its overhang onto a consensus end that
        # another batch member already extended (only the first splicer of
        # an end wins; coords are absolute so interior results stay valid).
        # Accepting now would store the whole overhang as insertion runs —
        # retry instead: once the end stabilizes the overhang aligns
        # against the newly grown consensus. Bounded by coverage, so the
        # attempt cap is just a livelock guard.
        head_run = int(np.argmax(ops != ord("i"))) if (ops != ord("i")).any() else len(ops)
        tail_run = (int(np.argmax(ops[::-1] != ord("i")))
                    if (ops != ord("i")).any() else 0)
        head_lost = head_run > 0 and tstart_abs == p.snap_lo and st.lo != p.snap_lo
        tail_lost = tail_run > 0 and tend_abs == p.snap_hi and st.hi != p.snap_hi
        # Stale-placement variant (the DP pipeline places against a snapshot
        # one batch older): the query was clipped to the snapshot extents and
        # the contig has since grown past them — a fresh placement would
        # align the clipped overhang instead of storing it as insertions.
        head_lost |= head_run > 0 and p.qlo > 0 and st.lo < p.snap_lo
        tail_lost |= tail_run > 0 and p.qhi < mlen and st.hi > p.snap_hi
        if (head_lost or tail_lost) and it.attempts < 8:
            it.attempts += 1
            self.queue.append(it)
            st.pending += 1
            return
        self.stats.aligned_ok += 1
        self.claimed[it.rid] = True
        self._mz_cache.pop(it.rid, None)
        st.accept(it.rid, p.is_rc, tstart_abs, tend_abs, ops,
                  int(res.cost[bi]), p.codes, p.fwd_anchors)
        if self.cfg.checks:
            _check_member(st, st.members[-1], p.codes)
        self._enqueue_children(st, it.rid)
        if st.total_aligned > self.cfg.edge_threshold:
            st.closed = True


def _precompute_minimizers(store, cfg: CompressConfig):
    """Whole-dataset per-read minimizer tables (prepared/deduped), computed
    on host threads. Launched in the background so it overlaps the
    sketch; the engine then memcpys slices instead of re-extracting
    per candidate (~1s of the 60 Mb bench). Returns (off, h, p, f)."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    N = store.num_reads
    packed = store.packed
    if not packed.flags["C_CONTIGUOUS"]:
        packed = np.ascontiguousarray(packed)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    counts = np.zeros(N, np.int64)
    args0 = (packed.ctypes.data_as(u8p), store.offsets.ctypes.data_as(i64p),
             store.lengths.ctypes.data_as(i64p), ctypes.c_int64(N),
             ctypes.c_int32(cfg.seed_kmer_size),
             ctypes.c_int32(cfg.seed_window))
    nullh = ctypes.cast(None, u64p)
    null64 = ctypes.cast(None, i64p)
    null8 = ctypes.cast(None, u8p)
    lib.ns_minimizers_all(*args0, ctypes.c_int32(0),
                          counts.ctypes.data_as(i64p), nullh, null64, null8)
    off = np.zeros(N + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    total = int(off[-1])
    h = np.empty(total, np.uint64)
    p = np.empty(total, np.int64)
    f = np.empty(total, np.uint8)
    lib.ns_minimizers_all(*args0, ctypes.c_int32(1),
                          off.ctypes.data_as(i64p), h.ctypes.data_as(u64p),
                          p.ctypes.data_as(i64p), f.ctypes.data_as(u8p))
    return off, h, p, f


# minimizer tables cost ~0.7 B/base; precompute only when that fits
# comfortably (the engine falls back to on-demand builds above this)
PREMZ_MAX_BASES = int(float(os.environ.get("NSTPU_PREMZ_MAX_BASES", 8e9)))


def _build_candidate_graph(store, cfg: CompressConfig, stats: FunnelStats,
                           report: bool) -> dict:
    """Sketch + hash-join + components + repetitive screen (the shared,
    device-side half of the pipeline)."""
    N = store.num_reads
    premz_fut = None
    # The precomputed minimizer tables STAY ON in low-mem runs: measured
    # at 1 Gbase (round 5), disabling them pushed the engine onto its
    # on-demand mz_cache, whose per-read vector/map overhead grew peak
    # RSS 1.73 -> 3.18 GB — the packed tables (~0.7 B/base) are the
    # cheaper memory by >2x AND avoid recomputing minimizers per
    # placement. (An earlier advisor note flagged the low-mem gate here
    # as a silent no-op; making it effective was measured worse on both
    # axes, so the gate is deliberately absent — this comment is the
    # record.)
    if (not getattr(cfg, "disable_assembly", False)
            and cfg.aligner != "python"
            and 0 < store.total_bases <= PREMZ_MAX_BASES):
        import concurrent.futures as _cf

        _premz_pool = _cf.ThreadPoolExecutor(1)
        try:
            from .. import native as _nat

            _nat.get_lib()
            premz_fut = _premz_pool.submit(_precompute_minimizers, store, cfg)
        except Exception:
            premz_fut = None
        finally:
            _premz_pool.shutdown(wait=False)

    def _sketch_and_join(c: CompressConfig):
        sketches = compute_all_sketches(store, c)
        nat = candidates.all_pairs_native(sketches, c.overlap_sketch_threshold,
                                          getattr(c, "max_bucket", 256))
        if nat is not None:
            q_, r_, _cnt = nat
            return q_, r_
        index = candidates.SketchIndex(sketches,
                                       getattr(c, "max_bucket", 256))
        pairs_q: list[np.ndarray] = []
        pairs_r: list[np.ndarray] = []
        B = c.sketch_batch_reads
        for i in range(0, N, B):
            q, r, _hits = index.query(sketches[i: i + B],
                                      c.overlap_sketch_threshold)
            keep = (q + i) != r
            pairs_q.append(q[keep] + i)
            pairs_r.append(r[keep])
        q_ = np.concatenate(pairs_q) if pairs_q else np.zeros(0, np.int64)
        r_ = np.concatenate(pairs_r) if pairs_r else np.zeros(0, np.int64)
        return q_, r_

    _t0 = time.perf_counter()
    candidates.reset_join_stats()
    pq, pr = _sketch_and_join(cfg)
    # Adaptive recovery for high-error data (hs1-like old basecaller):
    # k=23 minhash sketches barely collide at ~10% error, so a sparse
    # candidate graph (< ~1.5 neighbors/read; healthy data sits at 30+)
    # triggers one re-sketch with a shorter k-mer and a lower slot
    # threshold. The reference has no such fallback — its hs1 ratio decays
    # with the same fixed parameters (logs/2022/hs1.log).
    if N and len(pq) * 2 < 3 * N and cfg.kmer_size > 17:
        import dataclasses as _dc

        cfg2 = _dc.replace(
            cfg, kmer_size=17,
            overlap_sketch_threshold=max(3, cfg.overlap_sketch_threshold // 2))
        pq2, pr2 = _sketch_and_join(cfg2)
        if len(pq2) > len(pq):
            if report:
                print(f"[nstpu] sparse candidate graph "
                      f"({len(pq)} pairs / {N} reads): re-sketched with "
                      f"k=17 thr={cfg2.overlap_sketch_threshold} -> "
                      f"{len(pq2)} pairs")
            pq, pr = pq2, pr2
    stats.minhash_hits += len(pq)
    stats.capped_buckets += candidates.JOIN_STATS["dropped_buckets"]
    stats.capped_reads += candidates.JOIN_STATS["capped_reads"]
    _merge_timings(PIPE_STAGES, {"sketch_join": time.perf_counter() - _t0,
                                 "capped_buckets":
                                     candidates.JOIN_STATS["dropped_buckets"],
                                 "capped_reads":
                                     candidates.JOIN_STATS["capped_reads"]})
    _t0 = time.perf_counter()

    # adjacency CSR over both directions
    src = np.concatenate([pq, pr])
    dst = np.concatenate([pr, pq])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=N)
    adj_off = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(deg, out=adj_off[1:])

    # overlap components of the pair graph: disjoint work units — the
    # owner-computes partition that shards contig building across workers
    # here and across hosts at scale (replaces the reference's shared
    # inGraph[] + striped locks, src/Consensus.cpp:256-277,444-468)
    try:
        import ctypes

        from .. import native as _nat

        _lib = _nat.get_lib()
        comp_of = np.empty(N, dtype=np.int64)
        _pq = np.ascontiguousarray(pq, dtype=np.int64)
        _pr = np.ascontiguousarray(pr, dtype=np.int64)
        _i64p = ctypes.POINTER(ctypes.c_int64)
        n_comp = int(_lib.ns_components(
            _pq.ctypes.data_as(_i64p), _pr.ctypes.data_as(_i64p),
            ctypes.c_int64(len(_pq)), ctypes.c_int64(N),
            comp_of.ctypes.data_as(_i64p)))
    except Exception:
        import scipy.sparse as sp
        from scipy.sparse import csgraph

        g = sp.csr_matrix(
            (np.ones(len(src), dtype=np.int8), (src, dst)), shape=(N, N)
        )
        n_comp, comp_of = csgraph.connected_components(g, directed=False)
    comp_sizes = np.bincount(comp_of, minlength=n_comp)
    comp_order = np.argsort(comp_of, kind="stable")
    boundaries = np.zeros(n_comp + 1, dtype=np.int64)
    np.cumsum(comp_sizes, out=boundaries[1:])

    _merge_timings(PIPE_STAGES, {"components": time.perf_counter() - _t0})
    _t0 = time.perf_counter()
    rep = repetitive_screen(store, cfg)
    stats.repetitive = int(rep.sum())
    _merge_timings(PIPE_STAGES, {"screen": time.perf_counter() - _t0})
    premz = None
    if premz_fut is not None:
        try:
            premz = premz_fut.result()
        except Exception:
            premz = None
    return {
        "adj_off": adj_off, "dst": dst, "comp_of": comp_of,
        "n_comp": n_comp, "comp_order": comp_order, "boundaries": boundaries,
        "rep": rep, "premz": premz,
    }


class _ShimState:
    """Minimal contig-state shim around the native engine's output, duck-
    typed for _polish_batch_native / _emit_group / check_contigs."""

    __slots__ = ("cons", "lo", "members")

    def __init__(self, cons, members):
        self.cons = cons
        self.lo = 0
        self.members = members


class _DeviceDpHook:
    """Registers the lax DP (ops/align_device.py) as the engine's batch DP.

    The engine fills the flat buffers here (diagonal-shifted target
    windows, oriented queries, scalars), calls ``fn`` from its DP thread
    (ctypes re-acquires the GIL; the engine's main thread is pure C++ and
    keeps placing/settling meanwhile), and reads costs + byte traces back
    out of the same buffers. Fixed shapes (P_CAP x m_cap) keep it at one
    compile per process. A failing call is kept in ``error``; the engine
    stops, and the caller raises it."""

    P_CAP = 512

    def __init__(self, lib, max_read_len: int):
        import ctypes

        from ..ops import align_device as ad

        # row capacity follows the dataset; queries beyond it (and pairs
        # beyond P_CAP) run on the host DP and are counted
        self.m_cap = ad.row_capacity(max_read_len)
        self.lib = lib
        tw, qw = ad.buffer_widths(self.m_cap)
        P = self.P_CAP
        self.tpad = np.empty((P, tw), np.uint8)
        self.qbuf = np.empty((P, qw), np.uint8)
        self.d0, self.qlen, self.tlen, self.maxc, self.cost, self.ts, \
            self.te = (np.zeros(P, np.int32) for _ in range(7))
        self.trace = np.zeros((P, self.m_cap), np.uint8)
        self.error: Exception | None = None

        @ctypes.CFUNCTYPE(ctypes.c_int32, ctypes.c_int64)
        def _cb(n_pairs):
            try:
                out = ad.align_padded(self.d0, self.qlen, self.tlen,
                                      self.maxc, self.tpad, self.qbuf)
                self.cost[:], self.ts[:], self.te[:], self.trace[:] = (
                    np.asarray(a) for a in out)
                return 0
            except Exception as e:  # noqa: BLE001 - re-raised by the caller
                self.error = e
                return 1

        self._cb = _cb  # keep the callback object alive

    def _set(self, fn, p_cap: int, m_cap: int) -> None:
        import ctypes

        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        bufs = [self.tpad, self.qbuf, self.d0, self.qlen, self.tlen,
                self.maxc, self.cost, self.ts, self.te, self.trace]
        ptrs = [b.ctypes.data_as(u8p if b.dtype == np.uint8 else i32p)
                if fn is not None else None for b in bufs]
        self.lib.ns_engine_set_device(fn, *ptrs, ctypes.c_int64(p_cap),
                                      ctypes.c_int64(m_cap))

    def install(self) -> None:
        import ctypes

        self._set(ctypes.cast(self._cb, ctypes.c_void_p), self.P_CAP,
                  self.m_cap)

    def clear(self) -> None:
        self._set(None, 0, 0)


def _grow_components_engine(store, cfg: CompressConfig, stats: FunnelStats,
                            graph: dict, comp_subset) -> dict | None:
    """Whole grow loop in C++ (native/engine.cpp); None -> use the Python
    wavefront (no compiler available, or aligner="python" requested)."""
    if cfg.aligner == "python":
        return None
    try:
        import ctypes

        from .. import native

        lib = native.get_lib()
    except Exception:
        if cfg.aligner == "device":
            raise
        return None
    dev_hook = None
    if cfg.aligner == "device":
        max_len = int(store.lengths.max()) if store.num_reads else 1
        dev_hook = _DeviceDpHook(lib, max_len)
        dev_hook.install()
    comp_order = graph["comp_order"]
    boundaries = graph["boundaries"]
    comps = []
    memb_parts = []
    for comp in comp_subset:
        members = comp_order[boundaries[comp]: boundaries[comp + 1]]
        if len(members) < 2:
            continue
        comps.append(comp)
        memb_parts.append(np.ascontiguousarray(members, dtype=np.int64))
    comps_a = np.asarray(comps, dtype=np.int64)
    memb_off = np.zeros(len(comps) + 1, np.int64)
    np.cumsum([len(m) for m in memb_parts], out=memb_off[1:])
    memb_flat = (np.concatenate(memb_parts) if memb_parts
                 else np.zeros(0, np.int64))
    claimed = np.ascontiguousarray(graph["rep"], dtype=np.uint8).copy()
    packed = store.packed
    if not packed.flags["C_CONTIGUOUS"]:
        packed = np.ascontiguousarray(packed)
    params = np.array([
        cfg.seed_kmer_size, cfg.seed_window, cfg.max_chain_iter,
        cfg.band_width, int(cfg.max_edit_frac * 1000), cfg.min_overlap,
        cfg.align_batch, cfg.frontier_target, cfg.edge_threshold,
        max(cfg.kmer_size, cfg.min_read_len_for_sketch),
        cfg.max_place_attempts,
        min(cfg.band_width_min, cfg.band_width),
        1 if cfg.polish_rounds > 0 else 0,   # in-engine polish
    ], dtype=np.int64)
    adj_off = np.ascontiguousarray(graph["adj_off"], np.int64)
    adj = np.ascontiguousarray(graph["dst"], np.int64)
    comp_of = np.ascontiguousarray(graph["comp_of"], np.int64)

    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    premz = graph.get("premz")
    if premz is not None:
        pz_off, pz_h, pz_p, pz_f = premz
        lib.ns_engine_set_premz(
            pz_off.ctypes.data_as(i64p), pz_h.ctypes.data_as(u64p),
            pz_p.ctypes.data_as(i64p), pz_f.ctypes.data_as(u8p))
    c64 = lambda a: a.ctypes.data_as(i64p)
    nc = ctypes.c_int64()
    nm = ctypes.c_int64()
    ctot = ctypes.c_int64()
    otot = ctypes.c_int64()
    st2 = np.zeros(2, np.int64)
    _t_eng = time.perf_counter()
    h = lib.ns_engine_run(
        packed.ctypes.data_as(u8p), c64(store.offsets), c64(store.lengths),
        ctypes.c_int64(store.num_reads),
        c64(adj_off), c64(adj), c64(comp_of),
        c64(comps_a), c64(memb_off), c64(memb_flat),
        ctypes.c_int64(len(comps)),
        claimed.ctypes.data_as(u8p), c64(params),
        ctypes.byref(nc), ctypes.byref(nm), ctypes.byref(ctot),
        ctypes.byref(otot), c64(st2),
    )
    try:
        _eng_wall = time.perf_counter() - _t_eng
        _tim = np.zeros(24, np.float64)
        lib.ns_engine_timings(ctypes.c_void_p(h),
                              _tim.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_double)))
        timings = {
            "place": _tim[0], "dp": _tim[1], "apply": _tim[2],
            "polish": _tim[3], "dp_stitch": _tim[6], "dp_full": _tim[7],
            "dp_device": _tim[8], "engine_wall": _eng_wall,
            "dp_pairs": _tim[10], "dp_bases": _tim[11],
            "stitch_bases": _tim[12], "full_dp_bases": _tim[13],
            "dp_rejects": _tim[14], "dp_retries": _tim[15],
            "host_routed_long_pairs": _tim[18],
            "host_routed_long_bases": _tim[19],
            "device_batches": _tim[20], "host_batches": _tim[21],
        }
        if _tim[22]:
            raise RuntimeError("device DP failed; the run was stopped") \
                from dev_hook.error
        C, M = nc.value, nm.value
        flat_fast = not cfg.checks and not os.environ.get("NSTPU_TRACE")
        if flat_fast:
            # flat fast path, fetched in BOUNDED SLICES: the old monolithic
            # fetch materialized ops_flat + codes_flat (~2 B per aligned
            # base) in one transient — the top RSS term on Gbase-class
            # inputs. Each slice is fetched with release=1 so the engine's
            # own copy drains as the caller converts; peak extra memory is
            # one slice (~2 * EMIT_SLICE_OPS) plus the compact edit
            # streams (~0.2 B/base).
            _t_emit = time.perf_counter()
            per_cons = np.empty(C, np.int64)
            per_m = np.empty(C, np.int64)
            per_ops = np.empty(C, np.int64)
            lib.ns_engine_contig_sizes(
                ctypes.c_void_p(h), c64(per_cons), c64(per_m), c64(per_ops))
            slice_cap = int(float(os.environ.get(
                "NSTPU_EMIT_SLICE_OPS", 96e6)))
            consensus_list = []
            pieces = []        # per-slice (rid, strand, es)
            u8pp = ctypes.POINTER(ctypes.c_uint8)
            i64pp = ctypes.POINTER(ctypes.c_int64)
            c0 = 0
            while c0 < C:
                c1 = c0 + 1
                acc = int(per_ops[c0])
                while c1 < C and acc + int(per_ops[c1]) <= slice_cap:
                    acc += int(per_ops[c1])
                    c1 += 1
                _t1 = time.perf_counter()
                Ms = int(per_m[c0:c1].sum())
                cons_flat = np.empty(int(per_cons[c0:c1].sum()), np.uint8)
                cons_len = np.empty(c1 - c0, np.int64)
                m_cnt_s = np.empty(c1 - c0, np.int64)
                rid_s = np.empty(Ms, np.int64)
                strand_s = np.empty(Ms, np.uint8)
                tstart_s = np.empty(Ms, np.int64)
                ops_len_s = np.empty(Ms, np.int64)
                ops_flat = np.empty(acc, np.uint8)
                lib.ns_engine_fetch_range(
                    ctypes.c_void_p(h), ctypes.c_int64(c0),
                    ctypes.c_int64(c1), ctypes.c_int32(1),
                    cons_flat.ctypes.data_as(u8p), c64(cons_len),
                    c64(m_cnt_s), c64(rid_s), strand_s.ctypes.data_as(u8p),
                    c64(tstart_s), c64(ops_len_s),
                    ops_flat.ctypes.data_as(u8p),
                )
                _t2 = time.perf_counter()
                ops_off = np.zeros(Ms + 1, np.int64)
                np.cumsum(ops_len_s, out=ops_off[1:])
                codes_len = (store.lengths[rid_s].astype(np.int64) if Ms
                             else np.zeros(0, np.int64))
                codes_off = np.zeros(Ms + 1, np.int64)
                np.cumsum(codes_len, out=codes_off[1:])
                codes_flat = np.empty(int(codes_len.sum()), np.uint8)
                lib.ns_unpack_oriented(
                    packed.ctypes.data_as(u8pp),
                    store.offsets.ctypes.data_as(i64pp),
                    store.lengths.ctypes.data_as(i64pp),
                    rid_s.ctypes.data_as(i64pp),
                    strand_s.ctypes.data_as(u8pp),
                    ctypes.c_int64(Ms), codes_off.ctypes.data_as(i64pp),
                    codes_flat.ctypes.data_as(u8pp),
                )
                res = al.AlignResult(
                    cost=np.zeros(Ms, np.int32), tstart=tstart_s,
                    tend=np.zeros(Ms, np.int64),
                    ops_flat=ops_flat, ops_off=ops_off[:-1],
                    ops_len=ops_len_s,
                )
                _t3 = time.perf_counter()
                es_s = al.ops_to_edit_scripts(res, np.arange(Ms),
                                              codes_flat, codes_off[:-1],
                                              codes_len)
                if os.environ.get("NS_EMIT_DEBUG"):
                    print(f"[emit] slice {c0}-{c1}: fetch {_t2-_t1:.3f}s "
                          f"unpack {_t3-_t2:.3f}s es "
                          f"{time.perf_counter()-_t3:.3f}s", flush=True)
                cpos = 0
                for ln in cons_len:
                    consensus_list.append(
                        cons_flat[cpos: cpos + int(ln)])
                    cpos += int(ln)
                pieces.append((rid_s, strand_s, m_cnt_s, es_s))
                c0 = c1
            m_cnt = (np.concatenate([p[2] for p in pieces]) if pieces
                     else np.zeros(0, np.int64))
            rid = (np.concatenate([p[0] for p in pieces]) if pieces
                   else np.zeros(0, np.int64))
            strand = (np.concatenate([p[1] for p in pieces]) if pieces
                      else np.zeros(0, np.uint8))
            if pieces:
                ess = [p[3] for p in pieces]
                es = al.EditScripts(*[
                    np.concatenate([getattr(e, f) for e in ess])
                    for f in ("start_pos", "head_ins", "tail_ins",
                              "n_edits", "runs_flat", "types_flat",
                              "bases_flat")])
            else:
                z = lambda dt: np.zeros(0, dtype=dt)
                es = al.EditScripts(z(np.int64), z(np.int64), z(np.int64),
                                    z(np.int64), z(np.int64), z(np.uint8),
                                    z(np.uint8))
            timings["emit"] = time.perf_counter() - _t_emit
        else:
            cons_flat = np.empty(ctot.value, np.uint8)
            cons_len = np.empty(C, np.int64)
            m_cnt = np.empty(C, np.int64)
            rid = np.empty(M, np.int64)
            strand = np.empty(M, np.uint8)
            tstart_rel = np.empty(M, np.int64)
            ops_len = np.empty(M, np.int64)
            ops_flat = np.empty(otot.value, np.uint8)
            lib.ns_engine_fetch(
                ctypes.c_void_p(h), cons_flat.ctypes.data_as(u8p),
                c64(cons_len), c64(m_cnt), c64(rid),
                strand.ctypes.data_as(u8p),
                c64(tstart_rel), c64(ops_len),
                ops_flat.ctypes.data_as(u8p),
            )
    finally:
        lib.ns_engine_free(ctypes.c_void_p(h))
        if premz is not None:
            null64 = ctypes.cast(None, i64p)
            lib.ns_engine_set_premz(null64, ctypes.cast(None, u64p),
                                    null64, ctypes.cast(None, u8p))
        if dev_hook is not None:
            dev_hook.clear()
    stats.not_claimed += int(st2[0])
    stats.aligned_ok += int(st2[1])
    DP_INFO.clear()
    DP_INFO.update(
        dp_backend="device" if timings["device_batches"] else "native",
        device_batches=int(timings["device_batches"]),
        host_batches=int(timings["host_batches"]),
    )

    if flat_fast:
        return {
            "consensus_list": consensus_list,
            "reads_per_contig": m_cnt,
            "ids": rid,
            "strand": strand,
            "es": es,
            "timings": timings,
        }

    states = []
    cpos = 0
    mi = 0
    oo = 0
    for c in range(C):
        cons = cons_flat[cpos: cpos + int(cons_len[c])].copy()
        cpos += int(cons_len[c])
        members = []
        for _ in range(int(m_cnt[c])):
            ln = int(ops_len[mi])
            members.append(_Member(int(rid[mi]), int(strand[mi]),
                                   int(tstart_rel[mi]),
                                   ops_flat[oo: oo + ln].copy(), 0))
            oo += ln
            mi += 1
        states.append(_ShimState(cons, members))

    # polish already ran inside the engine (P_POLISH), on its own contig
    # structures — no flatten/fetch round trip here
    if cfg.checks:
        check_contigs(states, store)
    _t_emit = time.perf_counter()
    g = _emit_group(states, store)
    timings["emit"] = time.perf_counter() - _t_emit
    g["timings"] = timings
    return g


def _grow_components(store, cfg: CompressConfig, stats: FunnelStats,
                     graph: dict, comp_subset) -> dict:
    """Grow + polish + emit one contig group for a subset of components.

    Components are disjoint in reads, so subsets run with zero coordination
    (no locks, no shared claim table) — one subset per worker process here,
    one per host in the multi-host layout. The hot loop runs in C++
    (native/engine.cpp) when available; this Python wavefront is the
    readable oracle.
    """
    g = _grow_components_engine(store, cfg, stats, graph, comp_subset)
    if g is not None:
        return g
    import collections

    N = store.num_reads
    # repetitive reads are never seeded or claimed (they go lone), matching
    # the reference's screen (src/Consensus.cpp:203-208,405-424)
    claimed_for_wf = graph["rep"].copy()
    wf = _Wavefront(store, cfg, stats, graph["adj_off"], graph["dst"],
                    claimed_for_wf, graph["comp_of"])

    comp_order = graph["comp_order"]
    boundaries = graph["boundaries"]
    expand = collections.deque()
    for comp in comp_subset:
        members = comp_order[boundaries[comp]: boundaries[comp + 1]]
        if len(members) < 2:
            continue
        wf.register_component(comp, members)
        expand.append(comp)

    # main loop: top the frontier up with fresh well-separated seeds
    # (round-robin over components) so every alignment batch is full.
    # Two-stage software pipeline: while the banded DP for batch k runs in
    # a worker thread (C++ releases the GIL),
    # the main thread places batch k+1 — anchoring/bookkeeping and the DP
    # overlap instead of alternating (the reference interleaves them inside
    # each OpenMP thread, src/Consensus.cpp:168-340).
    import concurrent.futures as _cf

    def _top_up():
        while len(wf.queue) < cfg.frontier_target and expand:
            if wf.activate_next_in_comp(expand[0], fresh_only=True):
                expand.rotate(-1)
            else:
                expand.popleft()

    with _cf.ThreadPoolExecutor(1) as _pool:
        fut = None
        inflight = None
        while True:
            _top_up()
            batch, consumed = wf.collect_batch()
            arrays = wf.build_arrays(batch)
            nfut = _pool.submit(wf._align, *arrays) if arrays else None
            if inflight is not None:
                wf.apply_batch(inflight[0], inflight[1],
                               fut.result() if fut is not None else None)
            fut = nfut
            inflight = (batch, consumed) if (batch or consumed) else None
            # applying a batch can finalize+reseed (new queue items), so
            # only stop when nothing is in flight and nothing is queued
            if fut is None and inflight is None and not wf.queue and not expand:
                break
    # residual drain: components whose leftovers weren't reseeded yet
    for comp in list(wf._comp_members.keys()):
        while wf.activate_next_in_comp(comp):
            while wf.queue:
                wf.run_batch()
    for st in list(wf.states.values()):
        wf._finalize(st)

    if cfg.polish_rounds > 0:
        # substitutions -> indels -> substitutions: the second sub pass
        # settles columns whose votes shifted when indel columns moved.
        # One batched native call when available; numpy oracle otherwise.
        if not _polish_batch_native(wf.done, store):
            for st in wf.done:
                _polish_contig(st, store)
                _polish_indels(st, store)
                _polish_contig(st, store)
    if cfg.checks:
        check_contigs(wf.done, store)
    return _emit_group(wf.done, store)


def grow_worker_env() -> dict:
    """Environment for grow workers: the package importable, and no
    accelerator visible, so a worker can never open the card."""
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return dict(os.environ, PYTHONPATH=repo_root, JAX_PLATFORMS="cpu",
                CUDA_VISIBLE_DEVICES="")


def build_contigs(
    store, cfg: CompressConfig, stats: FunnelStats, report: bool = True
) -> tuple[list[ContigBatch], np.ndarray]:
    N = store.num_reads
    PIPE_STAGES.clear()
    # dataset-scaled knobs: short-read datasets need a denser anchor set
    # and a reachable overlap floor (config.py effective_*)
    cfg = dataclasses.replace(
        cfg,
        seed_window=cfg.effective_seed_window(store.avg_len),
        min_overlap=cfg.effective_min_overlap(store.avg_len),
    )
    graph = _build_candidate_graph(store, cfg, stats, report)
    boundaries = graph["boundaries"]
    comp_sizes = np.diff(boundaries)
    eligible = np.flatnonzero(comp_sizes >= 2)

    # one process per card: the device DP grows in this process, and grow
    # workers run host-only with the card hidden
    W = 1 if cfg.aligner == "device" else cfg.resolved_workers()
    fan_out = W > 1 and len(eligible) >= 2
    if report:
        print(f"[nstpu] card user: pid {os.getpid()} (sketch "
              f"{sketch_backend()}, DP "
              f"{'device' if cfg.aligner == 'device' else 'host'}); "
              f"{W if fan_out else 0} grow workers, card hidden")
    if fan_out:
        # greedy size-balanced bins, largest components first
        order = eligible[np.argsort(-comp_sizes[eligible])]
        bins = [[] for _ in range(W)]
        loads = np.zeros(W, dtype=np.int64)
        for c in order:
            b = int(np.argmin(loads))
            bins[b].append(int(c))
            loads[b] += comp_sizes[c]
        bins = [b for b in bins if b]
        import pickle
        import subprocess
        import sys as _sys
        import tempfile as _tf

        # low-mem stores ship the spill-file path, not the packed buffer:
        # pickling the memmap would materialize the whole dataset per
        # worker (the reference's disk-backed mode exists for exactly the
        # inputs where that matters, src/ReadData.cpp:156-235)
        if store.temp_path:
            store_parts = ("lowmem", store.temp_path, store.offsets,
                           store.lengths, store.exc_read, store.exc_pos,
                           store.exc_byte)
        else:
            store_parts = ("mem", store.packed, store.offsets, store.lengths,
                           store.exc_read, store.exc_pos, store.exc_byte)
        omp = max(1, (cfg.resolved_threads() or 2) // len(bins))
        env = grow_worker_env()
        # premz tables stay local: pickling ~0.7 B/base per worker defeats
        # the point (workers rebuild minimizers on demand)
        graph_wire = {k: v for k, v in graph.items() if k != "premz"}
        procs, files = [], []
        for b in bins:
            fi = _tf.NamedTemporaryFile(suffix=".in.pkl", delete=False)
            fo = _tf.NamedTemporaryFile(suffix=".out.pkl", delete=False)
            fo.close()
            pickle.dump((store_parts, cfg, graph_wire, b, omp), fi,
                        protocol=pickle.HIGHEST_PROTOCOL)
            fi.close()
            p = subprocess.Popen(
                [_sys.executable, "-m", "nanospring_tpu.pipeline.grow_worker",
                 fi.name, fo.name],
                env=env,
            )
            procs.append(p)
            files.append((fi.name, fo.name))
        groups = []
        for p, (fin, fout) in zip(procs, files):
            rc = p.wait()
            if rc != 0:
                raise RuntimeError(f"grow worker failed with exit code {rc}")
            with open(fout, "rb") as f:
                g, wstats = pickle.load(f)
            groups.append(g)
            stats.not_claimed += wstats.not_claimed
            stats.aligned_ok += wstats.aligned_ok
            os.unlink(fin)
            os.unlink(fout)
    else:
        groups = [_grow_components(store, cfg, stats, graph, eligible.tolist())]

    member_mask = np.zeros(N, dtype=bool)
    for g in groups:
        member_mask[g["ids"]] = True
        _merge_timings(PIPE_STAGES, g.pop("timings", {}))
    lone = np.flatnonzero(~member_mask)

    # combine all groups into one ContigBatch
    groups = [g for g in groups if len(g["consensus_list"])]
    if groups:
        cb = ContigBatch(
            consensus_list=[c for g in groups for c in g["consensus_list"]],
            reads_per_contig=np.concatenate([g["reads_per_contig"] for g in groups]),
            ids=np.concatenate([g["ids"] for g in groups]),
            strand=np.concatenate([g["strand"] for g in groups]),
            start_pos=np.concatenate([g["es"].start_pos for g in groups]),
            head_ins=np.concatenate([g["es"].head_ins for g in groups]),
            tail_ins=np.concatenate([g["es"].tail_ins for g in groups]),
            n_edits=np.concatenate([g["es"].n_edits for g in groups]),
            runs_flat=np.concatenate([g["es"].runs_flat for g in groups]),
            types_flat=np.concatenate([g["es"].types_flat for g in groups]),
            bases_flat=np.concatenate([g["es"].bases_flat for g in groups]),
        )
        batches = [cb]
    else:
        batches = []
    return batches, lone
