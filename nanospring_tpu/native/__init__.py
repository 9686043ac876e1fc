"""Native (C++) components, built on demand with g++ and loaded via ctypes.

The reference vendors minimap2/libbsc/fast-lzma2 as C/C++ (SURVEY.md §2.3);
our native layer is from-scratch C++ for the same host-side roles. Build is
a single g++ invocation (no cmake needed for one TU). The library is built
with ``-march=native``, so its file name carries a hash of the sources'
contents, the flags and the CPU features that flag resolved to: a checkout
copied onto another machine builds its own library instead of loading one
compiled for a foreign CPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

_SOURCES = ["align.cpp", "codec.cpp", "fastq.cpp", "replay.cpp",
            "minimizers.cpp", "hot.cpp", "polish.cpp", "join.cpp",
            "anchors.cpp", "engine.cpp", "sketch.cpp", "polish_core.h"]
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-fopenmp"]
# NSTPU_ASAN=1 builds the native stage with AddressSanitizer (the
# reference's Debug config, CMakeLists.txt:180-183); load with
# LD_PRELOAD=$(g++ -print-file-name=libasan.so) python ...
_ASAN_FLAGS = ["-fsanitize=address", "-fno-omit-frame-pointer", "-g"]


def _cpu_key() -> str:
    """The target options g++ resolves ``-march=native`` to on this host."""
    out = subprocess.run(
        ["g++", "-march=native", "-E", "-v", "-x", "c++", os.devnull,
         "-o", os.devnull], capture_output=True, text=True, check=True).stderr
    cc1 = next(ln for ln in out.splitlines() if "cc1plus" in ln)
    return " ".join(t for t in cc1.split() if t.startswith(("-m", "--param")))


def so_path(flags: list[str], cpu_key: str) -> str:
    """Library path keyed by sources, flags and CPU."""
    h = hashlib.sha256()
    for src in _SOURCES:
        with open(os.path.join(_DIR, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(flags).encode() + b"\0" + cpu_key.encode())
    prefix = "libnstpu_asan" if "-fsanitize=address" in flags else "libnstpu"
    return os.path.join(_DIR, f"{prefix}-{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Build the library for this host unless it exists; returns its path.

    Concurrent builders (test workers, grow workers) serialise on a lock
    file, and the library appears under its final name atomically.
    """
    flags = _FLAGS + (_ASAN_FLAGS if os.environ.get("NSTPU_ASAN") == "1"
                      else [])
    path = so_path(flags, _cpu_key())
    if os.path.exists(path):
        return path
    with open(os.path.join(_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ["g++", *flags, "-o", tmp] + [
            os.path.join(_DIR, s) for s in _SOURCES if s.endswith(".cpp")]
        if verbose:
            print("[nstpu] building native lib:", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, path)
        prefix = os.path.basename(path).split("-")[0]
        for old in glob.glob(os.path.join(_DIR, f"{prefix}-*.so")):
            if old != path:
                os.unlink(old)
    return path


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            i64 = ctypes.c_int64
            i32 = ctypes.c_int32
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.ns_banded_align.restype = i32
            lib.ns_banded_align.argtypes = [
                u8p, i64, u8p, i64, i64, i32, i32,
                u8p, i64, i64p, i64p, i64p,
            ]
            lib.ns_banded_align_batch.restype = None
            lib.ns_banded_align_batch.argtypes = [
                u8p, i64p, i64p, u8p, i64p, i64p, i64p, i32, i32, i64,
                u8p, i64p, i64, i64p, i64p, i64p, i32p,
            ]
            lib.ns_bsc_compress.restype = i64
            lib.ns_bsc_compress.argtypes = [u8p, i64, u8p]
            lib.ns_bsc_decompress.restype = i64
            lib.ns_bsc_decompress.argtypes = [u8p, i64, u8p]
            lib.ns_lz_compress.restype = i64
            lib.ns_lz_compress.argtypes = [u8p, i64, u8p]
            lib.ns_lz_decompress.restype = i64
            lib.ns_lz_decompress.argtypes = [u8p, i64, u8p]
            lib.ns_o1_compress.restype = i64
            lib.ns_o1_compress.argtypes = [u8p, i64, u8p]
            lib.ns_o1_decompress.restype = i64
            lib.ns_o1_decompress.argtypes = [u8p, i64, u8p]
            lib.ns_fastq_scan.restype = i32
            lib.ns_fastq_scan.argtypes = [u8p, i64, i64p, i64p, i64p]
            lib.ns_fastq_pack.restype = None
            lib.ns_fastq_pack.argtypes = [u8p, i64, u8p, i64p, i64p, i64p, u8p]
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.ns_minimizers.restype = i64
            lib.ns_minimizers.argtypes = [
                u8p, i64, i32, i32, u64p, i64p, u8p,
            ]
            lib.ns_minimizers_all.restype = None
            lib.ns_minimizers_all.argtypes = [
                u8p, i64p, i64p, i64, i32, i32, i32,
                i64p, u64p, i64p, u8p,
            ]
            lib.ns_engine_set_premz.restype = None
            lib.ns_engine_set_premz.argtypes = [i64p, u64p, i64p, u8p]
            lib.ns_gather_reads.restype = None
            lib.ns_gather_reads.argtypes = [
                u8p, u8p, i64p, u8p, i64p, i64, u8p,
            ]
            lib.ns_replay_members.restype = None
            lib.ns_replay_members.argtypes = [
                u8p, i64p, i64p, i64p, i64p, i64p, i64p,
                i64p, i64p, i64p, u8p, i64p, u8p, u8p, i64,
                i64p, i64p, u8p,
            ]
            lib.ns_unpack_batch.restype = None
            lib.ns_unpack_batch.argtypes = [
                u8p, i64p, i64p, i64p, i64, i64, ctypes.c_uint8, u8p,
            ]
            lib.ns_gather_packed.restype = None
            lib.ns_gather_packed.argtypes = [
                u8p, i64p, i64p, i64p, i64, i64, u8p,
            ]
            lib.ns_repetitive_screen.restype = None
            lib.ns_repetitive_screen.argtypes = [
                u8p, i64p, i64p, i64, i32, i32, u8p,
            ]
            lib.ns_edit_counts.restype = None
            lib.ns_edit_counts.argtypes = [
                u8p, i64p, i64p, i64, i64p, i64p, i64p, i64p,
            ]
            lib.ns_edit_fill.restype = None
            lib.ns_edit_fill.argtypes = [
                u8p, i64p, i64p, u8p, i64p, i64p, i64p, i64p, i64p, i64,
                i64p, u8p, u8p,
            ]
            lib.ns_unpack_oriented.restype = None
            lib.ns_unpack_oriented.argtypes = [
                u8p, i64p, i64p, i64p, u8p, i64, i64p, u8p,
            ]
            lib.ns_polish_batch.restype = ctypes.c_void_p
            lib.ns_polish_batch.argtypes = [
                u8p, i64p, i64p, i64,
                u8p, i64p, i64p, i64p, i64p, i64p,
                u8p, i64p, i64p, i64p,
            ]
            lib.ns_polish_fetch.restype = None
            lib.ns_polish_fetch.argtypes = [
                ctypes.c_void_p, u8p, i64p, u8p, i64p, i64p,
            ]
            lib.ns_polish_free.restype = None
            lib.ns_polish_free.argtypes = [ctypes.c_void_p]
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.ns_join_run.restype = ctypes.c_void_p
            lib.ns_join_run.argtypes = [u32p, i64, i32, i32, i32, i64p]
            lib.ns_join_fetch.restype = None
            lib.ns_join_fetch.argtypes = [ctypes.c_void_p, i64p, i64p, i64p]
            lib.ns_join_free.restype = None
            lib.ns_join_free.argtypes = [ctypes.c_void_p]
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.ns_anchor_prepare.restype = i64
            lib.ns_anchor_prepare.argtypes = [u64p, i64p, u8p, i64]
            lib.ns_anchor_join.restype = i32
            lib.ns_anchor_join.argtypes = [
                u64p, i64p, u8p, i64, u64p, i64p, u8p, i64,
                i64, i32, i32, i32p, i64p, i64p,
            ]
            lib.ns_anchor_join_chain.restype = i32
            lib.ns_anchor_join_chain.argtypes = [
                u64p, i64p, u8p, i64, u64p, i64p, u8p, i64,
                i64, i32, i32, i32p, i64p, i64p,
                i64p, i64p, i64, i64p,
            ]
            lib.ns_stitch_align.restype = i32
            lib.ns_stitch_align.argtypes = [
                u8p, i64, u8p, i64, i64p, i64p, i64,
                i64, i32, i32, i32, u8p, i64, i64p, i64p, i64p,
            ]
            lib.ns_accept_anchors.restype = i64
            lib.ns_accept_anchors.argtypes = [
                u8p, i64, i64, i64, i32, i32,
                u64p, i64p, u8p, i64, u64p, i64p, u8p,
            ]
            lib.ns_engine_run.restype = ctypes.c_void_p
            lib.ns_engine_run.argtypes = [
                u8p, i64p, i64p, i64,
                i64p, i64p, i64p,
                i64p, i64p, i64p, i64,
                u8p, i64p,
                i64p, i64p, i64p, i64p, i64p,
            ]
            lib.ns_engine_set_device.restype = None
            lib.ns_engine_set_device.argtypes = [
                ctypes.c_void_p, u8p, u8p,
                i32p, i32p, i32p, i32p,
                i32p, i32p, i32p, u8p,
                i64, i64,
            ]
            lib.ns_engine_fetch.restype = None
            lib.ns_engine_fetch.argtypes = [
                ctypes.c_void_p, u8p, i64p, i64p,
                i64p, u8p, i64p, i64p, u8p,
            ]
            lib.ns_engine_contig_sizes.restype = None
            lib.ns_engine_contig_sizes.argtypes = [
                ctypes.c_void_p, i64p, i64p, i64p,
            ]
            lib.ns_engine_fetch_range.restype = None
            lib.ns_engine_fetch_range.argtypes = [
                ctypes.c_void_p, i64, i64, i32,
                u8p, i64p, i64p,
                i64p, u8p, i64p, i64p, u8p,
            ]
            lib.ns_engine_free.restype = None
            lib.ns_engine_free.argtypes = [ctypes.c_void_p]
            dp = ctypes.POINTER(ctypes.c_double)
            lib.ns_engine_timings.restype = None
            lib.ns_engine_timings.argtypes = [ctypes.c_void_p, dp]
            lib.ns_join_stats.restype = None
            lib.ns_join_stats.argtypes = [ctypes.c_void_p, i64p]
            lib.ns_components.restype = i64
            lib.ns_components.argtypes = [i64p, i64p, i64, i64, i64p]
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.ns_sketch_reads.restype = None
            lib.ns_sketch_reads.argtypes = [
                u8p, i64p, i64p, i64p, i64, u32p, u32p, i64, i64, i64, u32p,
            ]
            lib.ns_emit_lone.restype = i64
            lib.ns_emit_lone.argtypes = [u8p, i64p, i64p, i64p, i64, u8p]
            lib.ns_varint_encode.restype = i64
            lib.ns_varint_encode.argtypes = [u64p, i64, u8p]
            lib.ns_varint_decode.restype = i64
            lib.ns_varint_decode.argtypes = [u8p, i64, u64p]
            _LIB = lib
    return _LIB
