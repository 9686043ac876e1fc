"""Flat-array read store: every read 2-bit packed in one buffer.

The reference keeps reads either as a vector of per-read DnaBitset objects or
as a single mutex-guarded temp file (reference: src/ReadData.cpp:110-142 and
:156-235; the mutex at :226-235 is a known sequential bottleneck). Here the
store is three numpy arrays — packed codes, byte offsets, lengths — so:

- random access is lock-free array slicing,
- whole batches unpack to a padded (B, Lpad) uint8 matrix for device kernels,
- low-mem mode swaps the packed buffer for an np.memmap with identical code
  paths (no separate mutex-serialized file protocol).

Non-ACGT characters are recorded as (read_id, pos, byte) exception triples so
decompression can restore arbitrary input bytes (see io/packed.py).
"""

from __future__ import annotations

import os

import numpy as np

from . import packed as pk


def _native_lib():
    """The native lib, or None when no compiler is available."""
    try:
        from .. import native

        return native.get_lib()
    except Exception:
        return None


class ReadStore:
    """Immutable collection of reads built via ReadStoreBuilder."""

    def __init__(
        self,
        packed_buf: np.ndarray,
        offsets: np.ndarray,      # int64, per-read start byte in packed_buf
        lengths: np.ndarray,      # int64, per-read length in bases
        exc_read: np.ndarray,     # int64 read ids with exceptions (sorted)
        exc_pos: np.ndarray,      # int64 position within read
        exc_byte: np.ndarray,     # uint8 original byte
    ):
        self.packed = np.asarray(packed_buf)
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.lengths = np.ascontiguousarray(lengths, dtype=np.int64)
        self.exc_read = exc_read
        self.exc_pos = exc_pos
        self.exc_byte = exc_byte
        self.temp_path: str | None = None  # low-mem spill file (owned)
        self.low_mem: bool = False  # set by ReadStoreBuilder.finish()

    def cleanup(self) -> None:
        """Delete the low-mem spill file (no-op for in-memory stores).

        The reference leaves this to its temp-dir teardown
        (src/main.cpp:160-176); here the store owns its own spill.
        """
        if self.temp_path and os.path.exists(self.temp_path):
            # drop the memmap reference first so the unlink isn't holding
            # a mapped file open on platforms that care
            self.packed = np.zeros(0, dtype=np.uint8)
            os.unlink(self.temp_path)
            self.temp_path = None

    @property
    def num_reads(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def total_bases(self) -> int:
        return int(self.lengths.sum())

    @property
    def avg_len(self) -> float:
        return float(self.lengths.mean()) if self.num_reads else 0.0

    @property
    def max_len(self) -> int:
        return int(self.lengths.max()) if self.num_reads else 0

    def get_codes(self, rid: int) -> np.ndarray:
        """2-bit codes (uint8 per base) of one read."""
        off = self.offsets[rid]
        ln = int(self.lengths[rid])
        nbytes = (ln + 3) // 4
        return pk.unpack_codes(self.packed[off : off + nbytes], ln)

    def get_seq(self, rid: int) -> str:
        return pk.codes_to_seq(self.get_codes(rid))

    def get_batch_padded(
        self, rids: np.ndarray, pad_to: int | None = None, fill: int = 0
    ) -> tuple[np.ndarray, np.ndarray]:
        """Unpack a batch into a (B, Lpad) uint8 code matrix + lengths.

        Vectorized gather: builds one flat byte-index array for all reads at
        once, a single fancy-index into the packed buffer, then one unpack.
        """
        # ctypes paths read raw pointers: force C-contiguity (a strided
        # int64 view would silently gather wrong reads)
        rids = np.ascontiguousarray(rids, dtype=np.int64)
        lens = self.lengths[rids]
        Lpad = int(pad_to if pad_to is not None else (lens.max() if len(lens) else 0))
        B = len(rids)
        lib = _native_lib()
        if lib is not None and B:
            import ctypes

            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            out = np.empty((B, Lpad), dtype=np.uint8)
            packed = self.packed
            if not packed.flags["C_CONTIGUOUS"]:
                packed = np.ascontiguousarray(packed)
            lib.ns_unpack_batch(
                packed.ctypes.data_as(u8p),
                self.offsets.ctypes.data_as(i64p),
                self.lengths.ctypes.data_as(i64p),
                rids.ctypes.data_as(i64p),
                ctypes.c_int64(B), ctypes.c_int64(Lpad),
                ctypes.c_uint8(fill), out.ctypes.data_as(u8p),
            )
            return out, lens
        nbytes = (Lpad + 3) // 4
        # (B, nbytes) byte indices, clamped so out-of-range lanes read byte 0
        byte_idx = self.offsets[rids][:, None] + np.arange(nbytes, dtype=np.int64)[None, :]
        valid = np.arange(nbytes, dtype=np.int64)[None, :] < ((lens[:, None] + 3) // 4)
        byte_idx = np.where(valid, byte_idx, 0)
        packed_rows = self.packed[byte_idx]  # (B, nbytes) uint8
        codes = np.empty((B, nbytes * 4), dtype=np.uint8)
        codes[:, 0::4] = packed_rows & 3
        codes[:, 1::4] = (packed_rows >> 2) & 3
        codes[:, 2::4] = (packed_rows >> 4) & 3
        codes[:, 3::4] = (packed_rows >> 6) & 3
        codes = codes[:, :Lpad]
        mask = np.arange(Lpad, dtype=np.int64)[None, :] < lens[:, None]
        codes = np.where(mask, codes, np.uint8(fill))
        return codes, lens

    def get_batch_packed(
        self, rids: np.ndarray, pad_to: int
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """(B, ceil(pad_to/4)) raw packed bytes + lengths, zero-padded.

        Ships reads to the accelerator packed (the sketch kernel unpacks
        on device). None when the native lib is unavailable.
        """
        lib = _native_lib()
        if lib is None:
            return None
        import ctypes

        # ctypes paths read raw pointers: force C-contiguity (a strided
        # int64 view would silently gather wrong reads)
        rids = np.ascontiguousarray(rids, dtype=np.int64)
        lens = self.lengths[rids]
        B = len(rids)
        nbytes_pad = (pad_to + 3) // 4
        out = np.empty((B, nbytes_pad), dtype=np.uint8)
        packed = self.packed
        if not packed.flags["C_CONTIGUOUS"]:
            packed = np.ascontiguousarray(packed)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ns_gather_packed(
            packed.ctypes.data_as(u8p),
            self.offsets.ctypes.data_as(i64p),
            self.lengths.ctypes.data_as(i64p),
            rids.ctypes.data_as(i64p),
            ctypes.c_int64(B), ctypes.c_int64(nbytes_pad),
            out.ctypes.data_as(u8p),
        )
        return out, lens

    def exceptions_for_read(self, rid: int) -> tuple[np.ndarray, np.ndarray]:
        lo = np.searchsorted(self.exc_read, rid, side="left")
        hi = np.searchsorted(self.exc_read, rid, side="right")
        return self.exc_pos[lo:hi], self.exc_byte[lo:hi]


class ReadStoreBuilder:
    """Accumulates batches from the FASTQ reader into a ReadStore.

    low_mem=True streams packed bytes to a temp file and memmaps it, the
    analog of the reference's disk-backed mode (src/ReadData.cpp:156-235) but
    without the global read mutex.
    """

    def __init__(self, low_mem: bool = False, work_dir: str = "/tmp"):
        self.low_mem = low_mem
        self.work_dir = work_dir
        self._packed_parts: list[np.ndarray] = []
        self._lengths: list[np.ndarray] = []
        self._exc_read: list[np.ndarray] = []
        self._exc_pos: list[np.ndarray] = []
        self._exc_byte: list[np.ndarray] = []
        self._num_reads = 0
        self._file = None
        self._file_path = None
        self._file_bytes = 0
        if low_mem:
            import tempfile

            fd, self._file_path = tempfile.mkstemp(
                prefix="nstpu_reads_", suffix=".packed", dir=work_dir)
            self._file = os.fdopen(fd, "wb")

    def add_batch(self, ascii_flat: np.ndarray, lengths: np.ndarray) -> None:
        """Add a batch of reads (concatenated ASCII bytes + per-read lengths)."""
        # exceptions (vectorized over the whole batch)
        bad_pos, bad_byte = pk.find_exceptions(ascii_flat)
        if len(bad_pos):
            starts = np.zeros(len(lengths) + 1, dtype=np.int64)
            np.cumsum(lengths, out=starts[1:])
            owner = np.searchsorted(starts, bad_pos, side="right") - 1
            self._exc_read.append(owner + self._num_reads)
            self._exc_pos.append(bad_pos - starts[owner])
            self._exc_byte.append(bad_byte)

        codes = pk.encode_ascii(ascii_flat)
        # pack each read independently (byte-aligned per read): scatter codes
        # into a zero-padded buffer where every read starts at a multiple of
        # 4 bases, then pack 4 lanes with shifts (no slow unbuffered ufuncs).
        nbytes_per_read = (lengths + 3) // 4
        byte_starts = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(nbytes_per_read, out=byte_starts[1:])
        total_bytes = int(byte_starts[-1])
        base_starts = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(lengths, out=base_starts[1:])
        read_of_base = np.repeat(np.arange(len(lengths)), lengths)
        idx_in_read = np.arange(len(codes), dtype=np.int64) - base_starts[read_of_base]
        padded = np.zeros(total_bytes * 4, dtype=np.uint8)
        padded[byte_starts[read_of_base] * 4 + idx_in_read] = codes
        quads = padded.reshape(-1, 4)
        packed = (
            quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
            | (quads[:, 3] << 6)
        ).astype(np.uint8)

        if self.low_mem:
            self._file.write(packed.tobytes())
            self._file_bytes += total_bytes
        else:
            self._packed_parts.append(packed)
        self._lengths.append(lengths.astype(np.int64))
        self._num_reads += len(lengths)

    def add_packed_batch(self, packed: np.ndarray, lengths: np.ndarray,
                         exc_read: np.ndarray, exc_pos: np.ndarray,
                         exc_byte: np.ndarray) -> None:
        """Add a batch already 2-bit packed (from native/fastq.cpp).

        ``exc_read`` is batch-local; exception positions are read-local.
        """
        if len(exc_read):
            self._exc_read.append(exc_read + self._num_reads)
            self._exc_pos.append(exc_pos)
            self._exc_byte.append(exc_byte)
        if self.low_mem:
            self._file.write(packed.tobytes())
            self._file_bytes += len(packed)
        else:
            self._packed_parts.append(packed)
        self._lengths.append(lengths.astype(np.int64))
        self._num_reads += len(lengths)

    def finish(self) -> ReadStore:
        lengths = (
            np.concatenate(self._lengths) if self._lengths else np.zeros(0, dtype=np.int64)
        )
        nbytes_per_read = (lengths + 3) // 4
        offsets = np.zeros(len(lengths), dtype=np.int64)
        if len(lengths):
            np.cumsum(nbytes_per_read[:-1], out=offsets[1:])
        if self.low_mem:
            self._file.close()
            buf = np.memmap(self._file_path, dtype=np.uint8, mode="r") \
                if self._file_bytes else np.zeros(0, dtype=np.uint8)
        else:
            buf = (
                np.concatenate(self._packed_parts)
                if self._packed_parts
                else np.zeros(0, dtype=np.uint8)
            )
        if self._exc_read:
            exc_read = np.concatenate(self._exc_read)
            exc_pos = np.concatenate(self._exc_pos)
            exc_byte = np.concatenate(self._exc_byte)
            order = np.argsort(exc_read, kind="stable")
            exc_read, exc_pos, exc_byte = exc_read[order], exc_pos[order], exc_byte[order]
        else:
            exc_read = np.zeros(0, dtype=np.int64)
            exc_pos = np.zeros(0, dtype=np.int64)
            exc_byte = np.zeros(0, dtype=np.uint8)
        store = ReadStore(buf, offsets, lengths, exc_read, exc_pos, exc_byte)
        store.temp_path = self._file_path  # None unless low_mem
        store.low_mem = self.low_mem
        return store

    def cleanup(self) -> None:
        if self._file_path and os.path.exists(self._file_path):
            os.unlink(self._file_path)


def _iter_record_blocks(path: str, chunk_bytes: int = 64 << 20):
    """Yield FASTQ text blocks cut at 4-line record boundaries."""
    import gzip

    # gzip by magic, not extension (the reference handles gzip
    # transparently via boost::iostreams, src/ReadData.cpp:95-106)
    with open(path, "rb") as probe:
        is_gz = probe.read(2) == b"\x1f\x8b"
    opener = gzip.open if is_gz else open
    carry = b""
    with opener(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            buf = carry + chunk
            nlines = buf.count(b"\n")
            keep = nlines - (nlines % 4)
            if keep == 0:
                carry = buf
                continue
            arr = np.frombuffer(buf, dtype=np.uint8)
            nl = np.flatnonzero(arr == ord("\n"))
            cut = int(nl[keep - 1]) + 1
            yield buf[:cut]
            carry = buf[cut:]
    if carry.strip():
        yield carry


def _pack_block_native(block: bytes):
    """C++ scan+pack of one FASTQ text block (native/fastq.cpp)."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    txt = np.frombuffer(block, dtype=np.uint8)
    nr = ctypes.c_int64()
    nb = ctypes.c_int64()
    ne = ctypes.c_int64()
    rc = lib.ns_fastq_scan(
        txt.ctypes.data_as(u8p), ctypes.c_int64(len(txt)),
        ctypes.byref(nr), ctypes.byref(nb), ctypes.byref(ne),
    )
    if rc != 0:
        raise ValueError("malformed FASTQ: line count not a multiple of 4")
    lengths = np.zeros(nr.value, dtype=np.int64)
    exc_read = np.zeros(ne.value, dtype=np.int64)
    exc_pos = np.zeros(ne.value, dtype=np.int64)
    exc_byte = np.zeros(ne.value, dtype=np.uint8)
    # packed size: sum of ceil(len/4) <= nbases/4 + nreads
    packed = np.zeros(nb.value // 4 + nr.value, dtype=np.uint8)
    lib.ns_fastq_pack(
        txt.ctypes.data_as(u8p), ctypes.c_int64(len(txt)),
        packed.ctypes.data_as(u8p), lengths.ctypes.data_as(i64p),
        exc_read.ctypes.data_as(i64p), exc_pos.ctypes.data_as(i64p),
        exc_byte.ctypes.data_as(u8p),
    )
    nbytes = int(((lengths + 3) // 4).sum())
    return packed[:nbytes], lengths, exc_read, exc_pos, exc_byte


def load_fastq(path: str, low_mem: bool = False, work_dir: str = "/tmp",
               use_native: bool = True) -> ReadStore:
    b = ReadStoreBuilder(low_mem=low_mem, work_dir=work_dir)
    if use_native:
        try:
            from .. import native

            native.get_lib()
        except Exception:
            use_native = False
    if use_native:
        # pipeline: reader thread feeds pack jobs; ctypes releases the GIL
        # during ns_fastq_scan/pack so blocks pack in parallel (the
        # reference packs 5000-read blocks under OpenMP,
        # src/ReadData.cpp:110-142)
        import concurrent.futures as cf
        import os as _os

        workers = max(2, min(4, _os.cpu_count() or 2))
        with cf.ThreadPoolExecutor(workers) as pool:
            pending = []
            for block in _iter_record_blocks(path, chunk_bytes=8 << 20):
                pending.append(pool.submit(_pack_block_native, block))
                while len(pending) > 2 * workers:
                    b.add_packed_batch(*pending.pop(0).result())
            for fut in pending:
                b.add_packed_batch(*fut.result())
    else:
        from . import fastq

        for flat, lengths in fastq.iter_sequence_batches(path):
            b.add_batch(flat, lengths)
    return b.finish()


# ---------------------------------------------------------------------------
# Sharded ingestion (multi-process scale path, SURVEY §5.8): each process
# reads only its own byte range of the FASTQ — the reference's low-mem
# machinery exists for exactly the inputs where whole-file-per-process
# dies (src/ReadData.cpp:156-235).
# ---------------------------------------------------------------------------

def _fastq_sync_point(f, offset: int, file_size: int) -> int:
    """First byte >= offset that starts a FASTQ record (pure function of
    the file bytes, so every process computes identical boundaries)."""
    if offset <= 0:
        return 0
    f.seek(offset)
    # skip the (possibly partial) current line
    f.readline()
    base = f.tell()
    lines = []
    pos = []
    while len(lines) < 8 and f.tell() < file_size:
        pos.append(f.tell())
        lines.append(f.readline())
    for j in range(min(4, len(lines))):
        if (lines[j].startswith(b"@") and j + 2 < len(lines)
                and lines[j + 2].startswith(b"+")):
            return pos[j]
    return base  # degenerate tail (no full record follows)


def fastq_shard_bounds(path: str, nshards: int) -> list[int] | None:
    """Byte offsets [b0..b_nshards] cutting the file at record boundaries.
    Returns None for gzip inputs (not byte-range shardable)."""
    with open(path, "rb") as f:
        if f.read(2) == b"\x1f\x8b":
            return None
        f.seek(0, 2)
        size = f.tell()
        bounds = [0]
        for s in range(1, nshards):
            bounds.append(_fastq_sync_point(f, s * size // nshards, size))
        bounds.append(size)
    # syncs can collide on tiny files; make monotone
    for i in range(1, len(bounds)):
        bounds[i] = max(bounds[i], bounds[i - 1])
    return bounds


def load_fastq_shard(path: str, shard: int, nshards: int, work_dir: str,
                     spill_name: str | None = None):
    """Parse only this shard's records into a disk-backed local store.

    Returns (store, n_local_reads). Read ids inside the store are
    shard-local (0-based); the caller offsets them by the allgathered
    counts of lower shards. The spill file is written to ``work_dir`` with
    a deterministic name so peer processes can memmap it (the federated
    read store). Gzip inputs cannot be byte-range sharded: every process
    streams the file but packs only its contiguous record-index range
    (bounded memory, duplicated IO — documented tradeoff).
    """
    spill = os.path.join(work_dir, spill_name or f"shard_{shard}.pack")
    b = ReadStoreBuilder(low_mem=True, work_dir=work_dir)
    # retarget the spill to the deterministic path
    b._file.close()
    os.replace(b._file_path, spill)
    b._file = open(spill, "wb")
    b._file_path = spill

    bounds = fastq_shard_bounds(path, nshards)
    if bounds is not None:
        lo, hi = bounds[shard], bounds[shard + 1]
        with open(path, "rb") as f:
            f.seek(lo)
            carry = b""
            left = hi - lo
            while left > 0:
                chunk = f.read(min(8 << 20, left))
                if not chunk:
                    break
                left -= len(chunk)
                buf = carry + chunk
                nlines = buf.count(b"\n")
                keep = nlines - (nlines % 4)
                if keep == 0:
                    carry = buf
                    continue
                arr = np.frombuffer(buf, dtype=np.uint8)
                nl = np.flatnonzero(arr == ord("\n"))
                cut = int(nl[keep - 1]) + 1
                b.add_packed_batch(*_pack_block_native(buf[:cut]))
                carry = buf[cut:]
            if carry.strip():
                b.add_packed_batch(*_pack_block_native(carry))
    else:
        # gzip: two-phase stream — count records, then pack own range
        total = 0
        for block in _iter_record_blocks(path, chunk_bytes=8 << 20):
            total += block.count(b"\n") // 4
        lo_idx = shard * total // nshards
        hi_idx = (shard + 1) * total // nshards
        seen = 0
        for block in _iter_record_blocks(path, chunk_bytes=8 << 20):
            nrec = block.count(b"\n") // 4
            if seen + nrec <= lo_idx or seen >= hi_idx:
                seen += nrec
                continue
            # cut the overlap range out of this block
            arr = np.frombuffer(block, dtype=np.uint8)
            nl = np.flatnonzero(arr == ord("\n"))
            a = max(lo_idx - seen, 0)
            z = min(hi_idx - seen, nrec)
            start = 0 if a == 0 else int(nl[a * 4 - 1]) + 1
            end = int(nl[z * 4 - 1]) + 1
            b.add_packed_batch(*_pack_block_native(block[start:end]))
            seen += nrec
    store = b.finish()
    return store, store.num_reads
