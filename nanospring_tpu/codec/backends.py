"""Host-CPU entropy-coding backends for the archive streams.

Role of libbsc (BWT + QLFC, reference: src/bsc.cpp, 48 MB blocks, coder e2)
and fast-lzma2 (reference: src/lzma2.cpp, preset 6) — entropy coding is
byte-serial and branchy, the wrong shape for a wide accelerator, so this
stage stays on host CPUs (SURVEY.md §2.3).

Current backends use the stdlib's native (C) codecs:
- ``bz2``  — BWT + MTF + Huffman, the same codec family as libbsc; used for
  the genome/pos/type/complement/lone/id/exc streams.
- ``lzma`` — LZMA, the same family as fast-lzma2; used for the ``base``
  stream (reference maps .base -> lzma2, src/Compressor.cpp:126-130).
Streams are chunked so multi-core compressors can parallelize by chunk.

A from-scratch C++ BWT/rank-coder stage (nanospring_tpu/native) replaces
these when ratio parity requires it.
"""

from __future__ import annotations

import bz2
import concurrent.futures as cf
import lzma
import struct
import zlib

_CHUNK = 32 << 20  # block-chunked like the reference's 48 MB bsc blocks
                   # (bsc_helper.h:6). 32 MB: on Gbase-class inputs the
                   # genome/pos streams reach hundreds of MB, where bigger
                   # blocks buy LZP/BWT context (round-3 ask #8); medium
                   # streams still split enough for the thread pool, and
                   # SA-IS scratch stays ~5x chunk per worker

_LZMA_FILTERS = [{"id": lzma.FILTER_LZMA2, "preset": 6}]


def _bz2_c(b: bytes) -> bytes:
    return bz2.compress(b, 9)


def _bz2_d(b: bytes) -> bytes:
    return bz2.decompress(b)


def _lzma_c(b: bytes) -> bytes:
    return lzma.compress(b, format=lzma.FORMAT_RAW, filters=_LZMA_FILTERS)


def _lzma_d(b: bytes) -> bytes:
    return lzma.decompress(b, format=lzma.FORMAT_RAW, filters=_LZMA_FILTERS)


def _zlib_c(b: bytes) -> bytes:
    return zlib.compress(b, 6)


def _zlib_d(b: bytes) -> bytes:
    return zlib.decompress(b)


def _nsbwt_c(b: bytes) -> bytes:
    """From-scratch C++ BWT+MTF+RLE0+range-coder block codec (native/codec.cpp),
    the libbsc-role stage (reference: src/bsc.cpp, libbsc/)."""
    import ctypes

    import numpy as np

    from .. import native

    lib = native.get_lib()
    src = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(len(b) + 1024, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_bsc_compress(
        src.ctypes.data_as(u8p), ctypes.c_int64(len(b)), out.ctypes.data_as(u8p)
    )
    return out[:n].tobytes()


def _nsbwt_d(b: bytes) -> bytes:
    import ctypes
    import struct as _st

    import numpy as np

    from .. import native

    lib = native.get_lib()
    (raw_n,) = _st.unpack_from("<I", b, 0)
    src = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(max(raw_n, 1), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_bsc_decompress(
        src.ctypes.data_as(u8p), ctypes.c_int64(len(b)), out.ctypes.data_as(u8p)
    )
    return out[:n].tobytes()


def _nslz_c(b: bytes) -> bytes:
    """From-scratch C++ LZ77 + range coder (native/codec.cpp ns_lz_*),
    the fast-lzma2-role stage (reference: src/lzma2.cpp, fast-lzma2/)."""
    import ctypes

    import numpy as np

    from .. import native

    lib = native.get_lib()
    src_ = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(len(b) + len(b) // 8 + 1024, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_lz_compress(
        src_.ctypes.data_as(u8p), ctypes.c_int64(len(b)),
        out.ctypes.data_as(u8p))
    return out[:n].tobytes()


def _nslz_d(b: bytes) -> bytes:
    import ctypes
    import struct as _st

    import numpy as np

    from .. import native

    lib = native.get_lib()
    (raw_n,) = _st.unpack_from("<I", b, 0)
    src_ = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(max(raw_n, 1), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_lz_decompress(
        src_.ctypes.data_as(u8p), ctypes.c_int64(len(b)),
        out.ctypes.data_as(u8p))
    return out[:n].tobytes()


def _nso1_c(b: bytes) -> bytes:
    """Order-1 adaptive range coder, no transform (native/codec.cpp
    ns_o1_*): owner of the exc stream, whose position varints a BWT
    scrambles (docs/CODECS.md)."""
    import ctypes

    import numpy as np

    from .. import native

    lib = native.get_lib()
    src_ = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(len(b) + 1024, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_o1_compress(
        src_.ctypes.data_as(u8p), ctypes.c_int64(len(b)),
        out.ctypes.data_as(u8p))
    return out[:n].tobytes()


def _nso1_d(b: bytes) -> bytes:
    import ctypes
    import struct as _st

    import numpy as np

    from .. import native

    lib = native.get_lib()
    (raw_n,) = _st.unpack_from("<I", b, 0)
    src_ = np.frombuffer(b, dtype=np.uint8)
    out = np.empty(max(raw_n, 1), dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.ns_o1_decompress(
        src_.ctypes.data_as(u8p), ctypes.c_int64(len(b)),
        out.ctypes.data_as(u8p))
    return out[:n].tobytes()


_BACKENDS: dict[str, tuple] = {
    "nslz": (_nslz_c, _nslz_d),
    "bz2": (_bz2_c, _bz2_d),
    "lzma": (_lzma_c, _lzma_d),
    "zlib": (_zlib_c, _zlib_d),
    "nsbwt": (_nsbwt_c, _nsbwt_d),
    "nso1": (_nso1_c, _nso1_d),
    "raw": (lambda b: b, lambda b: b),
}


def register(name: str, compress_fn, decompress_fn) -> None:
    _BACKENDS[name] = (compress_fn, decompress_fn)


def split_chunks(data: bytes) -> list[bytes]:
    """The chunking used by compress(), exposed so callers can flatten
    (stream, chunk) jobs across one pool (io/archive.py)."""
    return [data[i: i + _CHUNK] for i in range(0, len(data), _CHUNK)] or [b""]


def compress_chunk(name: str, chunk: bytes) -> bytes:
    return _BACKENDS[name][0](chunk)


def assemble_chunks(payloads: list[bytes]) -> bytes:
    header = struct.pack("<I", len(payloads)) + b"".join(
        struct.pack("<Q", len(p)) for p in payloads
    )
    return header + b"".join(payloads)


def compress(name: str, data: bytes, pool: cf.Executor | None = None) -> bytes:
    """Chunked compression: [u32 nchunks][u64 raw_len per chunk][payloads...].

    Chunking bounds memory like the reference's 48 MB bsc blocks and lets a
    thread pool run chunks in parallel (the stdlib codecs release the GIL).
    """
    c, _ = _BACKENDS[name]
    chunks = [data[i : i + _CHUNK] for i in range(0, len(data), _CHUNK)] or [b""]
    if pool is not None and len(chunks) > 1:
        payloads = list(pool.map(c, chunks))
    else:
        payloads = [c(ch) for ch in chunks]
    header = struct.pack("<I", len(chunks)) + b"".join(
        struct.pack("<Q", len(p)) for p in payloads
    )
    return header + b"".join(payloads)


def split_payloads(data: bytes) -> list[bytes]:
    """Inverse of assemble_chunks: the coded chunk payloads."""
    (nchunks,) = struct.unpack_from("<I", data, 0)
    off = 4
    sizes = []
    for _ in range(nchunks):
        (sz,) = struct.unpack_from("<Q", data, off)
        sizes.append(sz)
        off += 8
    payloads = []
    for sz in sizes:
        payloads.append(data[off: off + sz])
        off += sz
    return payloads


def decompress_chunk(name: str, payload: bytes) -> bytes:
    return _BACKENDS[name][1](payload)


def decompress(name: str, data: bytes, pool: cf.Executor | None = None) -> bytes:
    _, d = _BACKENDS[name]
    (nchunks,) = struct.unpack_from("<I", data, 0)
    off = 4
    sizes = []
    for _ in range(nchunks):
        (sz,) = struct.unpack_from("<Q", data, off)
        sizes.append(sz)
        off += 8
    payloads = []
    for sz in sizes:
        payloads.append(data[off : off + sz])
        off += sz
    if pool is not None and nchunks > 1:
        return b"".join(pool.map(d, payloads))
    return b"".join(d(p) for p in payloads)
