"""Minimizer extraction + anchor matching — the seeding stage.

From-scratch equivalent of minimap2's mm_sketch minimizers
(reference: minimap2/sketch.c:77-143) and the chaining stage's job of
producing a mapping diagonal (minimap2/chain.c) — but instead of an O(A^2)
chain DP we use diagonal voting over matched minimizers (the banded aligner
absorbs residual drift), which is branch-free and batchable.

Host-side numpy implementation (uint64 available here; the device variant
of dense k-mer hashing lives in ops/sketch.py). Canonical k-mers make anchors
strand-invariant; each anchor carries a flag saying whether the forward
orientation won, so relative strand falls out of matched flags.
"""

from __future__ import annotations

import numpy as np


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (public-domain constants)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


def dense_kmer_hashes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All canonical k-mer hashes of one sequence.

    Returns (hashes uint64 (P,), fwd_is_canonical bool (P,)); P = L-k+1.
    """
    L = len(codes)
    P = L - k + 1
    if P <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    c = codes.astype(np.uint64)
    fwd = np.zeros(P, dtype=np.uint64)
    rc = np.zeros(P, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(k):
            fwd |= c[j : j + P] << np.uint64(2 * (k - 1 - j))
            rc |= (np.uint64(3) - c[j : j + P]) << np.uint64(2 * j)
    take_fwd = fwd <= rc
    canon = np.where(take_fwd, fwd, rc)
    return _mix64(canon), take_fwd


def minimizers_np(
    codes: np.ndarray, k: int, w: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy reference implementation (oracle for the C++ fast path)."""
    h, fwdflag = dense_kmer_hashes(codes, k)
    P = len(h)
    if P == 0:
        return h, np.zeros(0, dtype=np.int64), fwdflag
    if P <= w:
        p = np.array([int(np.argmin(h))], dtype=np.int64)
        return h[p], p, fwdflag[p]
    win = np.lib.stride_tricks.sliding_window_view(h, w)
    pos = win.argmin(axis=1) + np.arange(P - w + 1)
    pos = np.unique(pos)  # dedupe consecutive windows picking the same k-mer
    return h[pos], pos.astype(np.int64), fwdflag[pos]


_NATIVE = None


def minimizers(
    codes: np.ndarray, k: int, w: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hashes uint64, positions int64, fwd_flags bool) of (w,k)-minimizers.

    C++ fast path (native/minimizers.cpp, exact same definition) with numpy
    fallback; tested equal in tests/test_align.py.
    """
    global _NATIVE
    if _NATIVE is None:
        try:
            from .. import native

            native.get_lib()
            _NATIVE = True
        except Exception:
            _NATIVE = False
    if not _NATIVE:
        return minimizers_np(codes, k, w)
    import ctypes

    from .. import native

    lib = native.get_lib()
    L = len(codes)
    cap = max(1, L - k + 1)
    out_h = np.empty(cap, dtype=np.uint64)
    out_pos = np.empty(cap, dtype=np.int64)
    out_fwd = np.empty(cap, dtype=np.uint8)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = lib.ns_minimizers(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(L), ctypes.c_int32(k), ctypes.c_int32(w),
        out_h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_fwd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out_h[:n], out_pos[:n], out_fwd[:n].astype(bool)


def match_anchors(
    h_a: np.ndarray, pos_a: np.ndarray, fwd_a: np.ndarray,
    h_b: np.ndarray, pos_b: np.ndarray, fwd_b: np.ndarray,
    len_b: int, k: int,
    max_anchors: int = 400,
) -> tuple[bool, int, int] | None:
    """Estimate relative placement of sequence b against sequence a.

    Returns (b_is_reverse, diagonal, votes) where diagonal d0 satisfies
    pos_in_a ~= d0 + pos_in_oriented_b, or None if no anchors matched.
    Diagonal voting: majority strand first, then median diagonal.
    """
    # unique-ify (intersect semantics); first occurrence wins
    ua, ia = np.unique(h_a, return_index=True)
    ub, ib = np.unique(h_b, return_index=True)
    common, ca, cb = np.intersect1d(ua, ub, assume_unique=True, return_indices=True)
    if len(common) == 0:
        return None
    if len(common) > max_anchors:
        sel = np.linspace(0, len(common) - 1, max_anchors).astype(np.int64)
        ca, cb = ca[sel], cb[sel]
    pa = pos_a[ia[ca]]
    pb = pos_b[ib[cb]]
    rel_rc = fwd_a[ia[ca]] != fwd_b[ib[cb]]
    n_rc = int(rel_rc.sum())
    is_rc = n_rc * 2 > len(rel_rc)
    if is_rc:
        m = rel_rc
        diag = pa[m] - (len_b - k - pb[m])
    else:
        m = ~rel_rc
        diag = pa[m] - pb[m]
    votes = int(m.sum())
    if votes == 0:
        return None
    return is_rc, int(np.median(diag)), votes


def _lib_or_none():
    global _NATIVE
    if _NATIVE is None:
        try:
            from .. import native

            native.get_lib()
            _NATIVE = True
        except Exception:
            _NATIVE = False
    if not _NATIVE:
        return None
    from .. import native

    return native.get_lib()


def prepare_anchors(h: np.ndarray, p: np.ndarray, f: np.ndarray):
    """Sorted-unique anchor table (by hash; smallest position wins).

    Pre-sorting at table-build time turns every subsequent match into a
    linear merge-join (the numpy match re-sorted the parent table per
    candidate). np.unique keeps the first occurrence — same rule.
    """
    lib = _lib_or_none()
    p = np.ascontiguousarray(p, dtype=np.int64)
    if lib is not None and len(h):
        import ctypes

        h = np.ascontiguousarray(h, dtype=np.uint64)
        fu = np.ascontiguousarray(f, dtype=np.uint8)
        m = lib.ns_anchor_prepare(
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            fu.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(len(h)),
        )
        return h[:m], p[:m], fu[:m].astype(bool)
    ua, ia = np.unique(h, return_index=True)
    return ua, p[ia], np.asarray(f, dtype=bool)[ia]


def match_anchors_prepared(
    h_a, pos_a, fwd_a, h_b, pos_b, fwd_b, len_b: int, k: int,
    max_anchors: int = 400,
):
    """match_anchors for tables already prepared (sorted unique)."""
    lib = _lib_or_none()
    if lib is None:
        return match_anchors(h_a, pos_a, fwd_a, h_b, pos_b, fwd_b,
                             len_b, k, max_anchors)
    import ctypes

    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fa = np.ascontiguousarray(fwd_a, dtype=np.uint8)
    fb = np.ascontiguousarray(fwd_b, dtype=np.uint8)
    is_rc = ctypes.c_int32()
    d0 = ctypes.c_int64()
    votes = ctypes.c_int64()
    found = lib.ns_anchor_join(
        np.ascontiguousarray(h_a, np.uint64).ctypes.data_as(u64p),
        np.ascontiguousarray(pos_a, np.int64).ctypes.data_as(i64p),
        fa.ctypes.data_as(u8p), ctypes.c_int64(len(h_a)),
        np.ascontiguousarray(h_b, np.uint64).ctypes.data_as(u64p),
        np.ascontiguousarray(pos_b, np.int64).ctypes.data_as(i64p),
        fb.ctypes.data_as(u8p), ctypes.c_int64(len(h_b)),
        ctypes.c_int64(len_b), ctypes.c_int32(k),
        ctypes.c_int32(max_anchors),
        ctypes.byref(is_rc), ctypes.byref(d0), ctypes.byref(votes),
    )
    if not found:
        return None
    return bool(is_rc.value), int(d0.value), int(votes.value)


def accept_anchors(ops: np.ndarray, tstart_abs: int, mlen: int, is_rc: int,
                   k: int, h: np.ndarray, p: np.ndarray, f: np.ndarray):
    """Accepted member's anchor table: mirror (if rc), drop anchors inside
    insertion runs, map positions to target coords. Native one-pass with a
    numpy fallback (both orderings sorted-unique by hash)."""
    lib = _lib_or_none()
    if lib is not None:
        import ctypes

        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        n = len(h)
        oh = np.empty(n, np.uint64)
        otp = np.empty(n, np.int64)
        of = np.empty(n, np.uint8)
        opsu = np.ascontiguousarray(ops, np.uint8)
        m = lib.ns_accept_anchors(
            opsu.ctypes.data_as(u8p), ctypes.c_int64(len(ops)),
            ctypes.c_int64(tstart_abs), ctypes.c_int64(mlen),
            ctypes.c_int32(int(is_rc)), ctypes.c_int32(k),
            np.ascontiguousarray(h, np.uint64).ctypes.data_as(u64p),
            np.ascontiguousarray(p, np.int64).ctypes.data_as(i64p),
            np.ascontiguousarray(f, np.uint8).ctypes.data_as(u8p),
            ctypes.c_int64(n),
            oh.ctypes.data_as(u64p), otp.ctypes.data_as(i64p),
            of.ctypes.data_as(u8p),
        )
        return oh[:m], otp[:m], of[:m].astype(bool)
    # numpy fallback (same semantics)
    p = np.asarray(p, np.int64)
    f = np.asarray(f, bool)
    if is_rc:
        p = (mlen - k) - p
        f = ~f
    p = np.clip(p, 0, mlen - 1)
    consumes_q = ops != ord("d")
    qop = ops[consumes_q]
    keep = qop[p] != ord("i")
    q2t = qpos_to_tpos_map(ops, tstart_abs, mlen)
    return np.asarray(h)[keep], q2t[p][keep], f[keep]


def qpos_to_tpos_map(ops: np.ndarray, tstart: int, q_len: int) -> np.ndarray:
    """Map query positions -> target positions through an alignment's ops.

    For query positions consumed by '='/'s', the exact target position; for
    'i' positions, the current target cursor. Vectorized.
    """
    consumes_t = (ops == ord("=")) | (ops == ord("s")) | (ops == ord("d"))
    consumes_q = (ops == ord("=")) | (ops == ord("s")) | (ops == ord("i"))
    tpos = tstart + np.cumsum(consumes_t) - consumes_t  # t cursor before op
    out = np.zeros(q_len, dtype=np.int64)
    qi = np.cumsum(consumes_q) - consumes_q             # q index of op
    sel = consumes_q
    out[qi[sel]] = tpos[sel]
    return out
