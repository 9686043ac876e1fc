"""Batched banded glocal alignment on the device, in plain ``lax``.

The contig engine's batch DP hook (pipeline/contigs.py::_DeviceDpHook,
native/engine.cpp::dp_run_device) fills fixed-shape buffers and calls
:func:`align_padded`. Band semantics are exactly ``ns_banded_align`` with
W = 63 (native/align.cpp), so costs are bit-identical to the host DP:

- slot k in [1, 127] of query row i is target column j = d0 + i + k - KOFF
  (KOFF = 64); slot 0 is never valid;
- unit-cost moves: diag (match 0 / substitution 1), up = insertion,
  left = deletion; row 0 starts free anywhere inside the band (glocal);
- ``tpad[p, y] = target[y + d0 - KOFF - 1]`` (0xFF outside the target), so
  row i's diagonal characters are the contiguous slice ``tpad[p, i:i+128]``;
  ``qbuf[p, i-1]`` is query base i.

The forward pass is a loop over query rows, vectorised over pairs x 128
slots; the in-row deletion chain is a prefix minimum (7 shifted minimums).
It stores one direction code per cell, and a backward loop over rows
resolves every pair's traceback at once, emitting one byte per query row:
``dels | op << 6`` (op 0 '=', 1 's', 2 'i'; ``dels`` deletions follow the
row's op), or ``TRACE_ESC`` when a row needs more than 62 deletions, in
which case the caller re-runs that pair on the host DP. A pair whose best
cost exceeds ``maxc`` gets cost -1; padding pairs (``qlen == 0``) cost 0.

Rows run in chunks of ``_CHUNK``: a while loop over chunks (trip count from
the batch's longest query) around a fixed-length scan, so the host reads the
loop predicate once per chunk, not once per row.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .align import AlignResult

W = 63              # band half-width (ns_banded_align semantics)
SLOTS = 128         # band slots per row, slot 0 unused
KOFF = 64           # slot k <-> diagonal offset k - KOFF
TRACE_ESC = 255     # trace byte: re-run this pair on the host DP
M_CAP_MAX = 65536   # longest query row count the hook compiles for
_CHUNK = 32         # rows per scan chunk (M caps are multiples of it)
_INF = 1 << 30


def row_capacity(max_len: int) -> int:
    """Rows to compile for queries up to ``max_len``: a power of two, at
    least 512, at most ``M_CAP_MAX`` (longer queries go to the host)."""
    return min(M_CAP_MAX, max(512, 1 << (max(1, max_len) - 1).bit_length()))


def buffer_widths(m_cap: int) -> tuple[int, int]:
    """(tpad, qbuf) row widths for a row capacity ``m_cap``."""
    return m_cap + 3 * SLOTS, m_cap + 2 * SLOTS


@jax.jit
def align_padded(d0, qlen, tlen, maxc, tpad, qbuf):
    """One fixed-shape batch: int32 (P,) scalars, uint8 (P, m_cap + 384)
    targets and (P, m_cap + 256) queries -> (cost, tstart, tend) int32 (P,)
    and the (P, m_cap) uint8 trace."""
    P = tpad.shape[0]
    m_cap = qbuf.shape[1] - 2 * SLOTS
    assert m_cap % _CHUNK == 0, m_cap
    d0 = d0.astype(jnp.int32)[:, None]
    m = qlen.astype(jnp.int32)[:, None]
    n = tlen.astype(jnp.int32)[:, None]
    k = jnp.arange(SLOTS, dtype=jnp.int32)[None, :]
    INF = jnp.int32(_INF)
    n_chunks = (jnp.max(qlen) + _CHUNK - 1) // _CHUNK

    j0 = d0 + k - KOFF
    prev0 = jnp.where((k >= 1) & (j0 >= 0) & (j0 <= n), 0, INF)

    def row(prev, i):
        tchar = lax.dynamic_slice_in_dim(tpad, i, SLOTS, axis=1)
        qc = lax.dynamic_slice_in_dim(qbuf, i - 1, 1, axis=1)
        j = d0 + i + k - KOFF
        jvalid = (k >= 1) & (j >= 0) & (j <= n)
        match = tchar == qc
        diag = jnp.where((j >= 1) & (j <= n) & (prev < INF),
                         prev + jnp.where(match, 0, 1), INF)
        up = jnp.concatenate([prev[:, 1:], jnp.full((P, 1), INF)], axis=1)
        up = jnp.where(up < INF, up + 1, INF)
        base = jnp.where(jvalid, jnp.minimum(diag, up), INF)
        # deletion chain cur[k] = min_{k' <= k} base[k'] + (k - k'):
        # prefix minimum of base - k, then + k
        x = base - k
        for sh in (1, 2, 4, 8, 16, 32, 64):
            x = jnp.minimum(x, jnp.concatenate(
                [jnp.full((P, sh), INF), x[:, :-sh]], axis=1))
        cur = jnp.where(jvalid, jnp.minimum(base, x + k), INF)
        # direction | match << 2: diag wins ties, left only if strictly less
        d = jnp.where(cur == diag, jnp.where(match, 4, 0),
                      jnp.where(cur == up, 1, 2))
        d = jnp.where(cur >= INF, 3, d).astype(jnp.uint8)
        return jnp.where((i <= m), cur, prev), d

    def fwd_chunk(carry):
        c, prev, dirs = carry
        rows = c * _CHUNK + 1 + jnp.arange(_CHUNK, dtype=jnp.int32)
        prev, ds = lax.scan(row, prev, rows)
        return c + 1, prev, lax.dynamic_update_slice_in_dim(
            dirs, ds, c * _CHUNK, axis=0)

    dirs0 = jnp.zeros((m_cap, P, SLOTS), jnp.uint8)
    _, last, dirs = lax.while_loop(lambda c: c[0] < n_chunks, fwd_chunk,
                                   (jnp.int32(0), prev0, dirs0))

    jm = d0 + m + k - KOFF
    final = jnp.where((k >= 1) & (jm >= 0) & (jm <= n), last, INF)
    best = jnp.min(final, axis=1)
    best_k = jnp.argmin(final, axis=1).astype(jnp.int32)   # first minimum
    ok = (best <= maxc) & (qlen > 0)

    def back(kk, xs):
        i, row_d = xs
        row_d = row_d.astype(jnp.int32)
        active = (i <= qlen) & ok
        # nearest non-deletion slot at or left of the cursor
        kp = jnp.max(jnp.where(((row_d & 3) != 2) & (k <= kk[:, None]),
                               k, -1), axis=1)
        dval = jnp.take_along_axis(row_d, jnp.maximum(kp, 0)[:, None],
                                   axis=1)[:, 0]
        dval = jnp.where(kp >= 0, dval, -1)
        optype = dval & 3
        dels = kk - kp
        op2 = jnp.where(optype == 1, 2, jnp.where(dval >> 2 == 1, 0, 1))
        esc = (dels > 62) | (optype == 3) | (dval < 0)
        rec = jnp.where(esc, TRACE_ESC, (op2 << 6) | dels)
        rec = jnp.where(active, rec, 0).astype(jnp.uint8)
        kk = jnp.where(active, kp + (optype == 1), kk)
        return kk, rec

    def back_chunk(carry):
        c, kk, trace = carry
        rows = c * _CHUNK + 1 + jnp.arange(_CHUNK, dtype=jnp.int32)
        ds = lax.dynamic_slice_in_dim(dirs, c * _CHUNK, _CHUNK, axis=0)
        kk, recs = lax.scan(back, kk, (rows, ds), reverse=True)
        return c - 1, kk, lax.dynamic_update_slice_in_dim(
            trace, recs, c * _CHUNK, axis=0)

    trace0 = jnp.zeros((m_cap, P), jnp.uint8)
    _, k_fin, trace = lax.while_loop(lambda c: c[0] >= 0, back_chunk,
                                     (n_chunks - 1, best_k, trace0))

    d0 = d0[:, 0]
    cost = jnp.where(ok, best, jnp.where(qlen > 0, -1, 0)).astype(jnp.int32)
    tstart = jnp.where(ok, d0 + k_fin - KOFF, 0).astype(jnp.int32)
    tend = jnp.where(ok, d0 + qlen + best_k - KOFF, 0).astype(jnp.int32)
    return cost, tstart, tend, trace.T


def pack_batch(targets_flat, t_off, t_len, queries_flat, q_off, q_len, d0,
               max_cost_per_kb: int, p_cap: int, m_cap: int):
    """Host-side fill of the engine-shaped buffers (dp_run_device's layout):
    returns (d0, qlen, tlen, maxc, tpad, qbuf) for :func:`align_padded`."""
    P = len(q_len)
    if P > p_cap or (P and int(np.max(q_len)) > m_cap):
        raise ValueError(f"batch of {P} pairs exceeds ({p_cap}, {m_cap})")
    tw, qw = buffer_widths(m_cap)
    tpad = np.full((p_cap, tw), 0xFF, np.uint8)
    qbuf = np.zeros((p_cap, qw), np.uint8)
    scal = np.zeros((4, p_cap), np.int32)
    for p in range(P):
        m, nt, dd = int(q_len[p]), int(t_len[p]), int(d0[p])
        qbuf[p, :m] = queries_flat[q_off[p]: q_off[p] + m]
        lo = dd - (KOFF + 1)
        b, e = max(0, -lo), min(tw, nt - lo)
        if e > b:
            tpad[p, b:e] = targets_flat[t_off[p] + lo + b: t_off[p] + lo + e]
        scal[:, p] = (dd, m, nt, m * max_cost_per_kb // 1000 + 8)
    return (*scal, tpad, qbuf)


def expand_trace(rows: np.ndarray) -> bytes | None:
    """One pair's trace bytes (one per query row) -> op bytes, or None when
    a row escaped (the pair needs the host DP)."""
    if (rows == TRACE_ESC).any():
        return None
    dels = (rows & 63).astype(np.int64)
    op2 = rows >> 6
    out = np.full(len(rows) + int(dels.sum()), ord("d"), np.uint8)
    start = np.concatenate([[0], np.cumsum(1 + dels)[:-1]]).astype(np.int64)
    out[start] = np.where(op2 == 2, ord("i"), np.where(op2 == 0, ord("="),
                                                      ord("s")))
    return out.tobytes()


def banded_align_batch_device(
    targets_flat: np.ndarray, t_off: np.ndarray, t_len: np.ndarray,
    queries_flat: np.ndarray, q_off: np.ndarray, q_len: np.ndarray,
    d0: np.ndarray, max_cost_per_kb: int = 500,
    p_cap: int | None = None, m_cap: int | None = None,
) -> AlignResult:
    """Drop-in for ``ops.align.banded_align_batch(..., band=63)``: packs one
    fixed-shape batch, runs :func:`align_padded`, expands the traces, and
    re-runs escaped pairs on the exact host DP (as the engine does)."""
    P = len(q_len)
    p_cap = p_cap or max(1, P)
    m_cap = m_cap or row_capacity(int(np.max(q_len, initial=1)))
    d0a, qla, tla, mca, tpad, qbuf = pack_batch(
        targets_flat, t_off, t_len, queries_flat, q_off, q_len, d0,
        max_cost_per_kb, p_cap, m_cap)
    cost, ts, te, trace = (np.asarray(a) for a in align_padded(
        d0a, qla, tla, mca, tpad, qbuf))
    cost = cost[:P].copy()
    ts = ts[:P].astype(np.int64)
    te = te[:P].astype(np.int64)
    parts: list[bytes] = []
    for p in range(P):
        ops = b""
        if cost[p] >= 0:
            ops = expand_trace(trace[p, : int(q_len[p])])
            if ops is None:
                cost[p], ts[p], te[p], ops = _host_pair(
                    targets_flat[t_off[p]: t_off[p] + t_len[p]],
                    queries_flat[q_off[p]: q_off[p] + q_len[p]],
                    int(d0[p]), int(mca[p]))
        parts.append(ops)
    ops_len = np.array([len(o) for o in parts], np.int64)
    ops_off = np.concatenate([[0], np.cumsum(ops_len)[:-1]]).astype(np.int64)
    ops_flat = np.frombuffer(b"".join(parts), np.uint8).copy()
    return AlignResult(cost, ts, te, ops_flat, ops_off, ops_len)


def _host_pair(t: np.ndarray, q: np.ndarray, d0: int, max_cost: int):
    from .. import native

    lib = native.get_lib()
    t = np.ascontiguousarray(t, np.uint8)
    q = np.ascontiguousarray(q, np.uint8)
    cap = 2 * len(q) + 2 * W + 2
    buf = np.empty(cap, np.uint8)
    ol, t1, t2 = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    c = lib.ns_banded_align(
        t.ctypes.data_as(u8p), len(t), q.ctypes.data_as(u8p), len(q),
        d0, W, max_cost, buf.ctypes.data_as(u8p), cap,
        ctypes.byref(ol), ctypes.byref(t1), ctypes.byref(t2))
    if c < 0:
        return c, 0, 0, b""
    return c, t1.value, t2.value, buf[: ol.value].tobytes()
