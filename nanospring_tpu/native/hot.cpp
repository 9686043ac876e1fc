// Host-side hot loops that were numpy-bound: batch unpack of the 2-bit
// read store, the repetitive-read screen, and edit-script extraction.
//
// These are the framework's native runtime pieces, replacing numpy
// multi-pass array pipelines with single-pass OpenMP C++ (the reference
// does the corresponding work inside its OpenMP loops:
// src/ReadData.cpp:110-142 unpacking, src/Consensus.cpp:405-424 the
// repetitive screen, src/ConsensusGraph.cpp:1031-1178 read2EditScript).
//
// C ABI only (consumed via ctypes).

#include <cstdint>
#include <cstring>

extern "C" {

// Unpack a batch of reads into a (B, Lpad) uint8 code matrix (row-major),
// padded with `fill`. offsets are per-read start BYTES in `packed`;
// every read is byte-aligned (4 bases/byte, LSB-first within the byte).
void ns_unpack_batch(
    const uint8_t* packed, const int64_t* offsets, const int64_t* lengths,
    const int64_t* rids, int64_t B, int64_t Lpad, uint8_t fill,
    uint8_t* out)
{
    #pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < B; ++b) {
        const int64_t rid = rids[b];
        const int64_t len = lengths[rid];
        const uint8_t* src = packed + offsets[rid];
        uint8_t* dst = out + b * Lpad;
        const int64_t nb = len / 4;
        for (int64_t i = 0; i < nb; ++i) {
            const uint8_t v = src[i];
            dst[4 * i + 0] = v & 3;
            dst[4 * i + 1] = (v >> 2) & 3;
            dst[4 * i + 2] = (v >> 4) & 3;
            dst[4 * i + 3] = (v >> 6) & 3;
        }
        for (int64_t p = 4 * nb; p < len; ++p)
            dst[p] = (src[p / 4] >> (2 * (p % 4))) & 3;
        if (len < Lpad) std::memset(dst + len, fill, (size_t)(Lpad - len));
    }
}

// Same but gathers the packed BYTES only: out is (B, ceil(Lpad/4)) uint8.
// Used to ship reads to the accelerator packed (4x less PCIe/host work);
// the sketch kernel unpacks on device.
void ns_gather_packed(
    const uint8_t* packed, const int64_t* offsets, const int64_t* lengths,
    const int64_t* rids, int64_t B, int64_t nbytes_pad,
    uint8_t* out)
{
    #pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < B; ++b) {
        const int64_t rid = rids[b];
        const int64_t nb = (lengths[rid] + 3) / 4;
        uint8_t* dst = out + b * nbytes_pad;
        std::memcpy(dst, packed + offsets[rid], (size_t)nb);
        if (nb < nbytes_pad) std::memset(dst + nb, 0, (size_t)(nbytes_pad - nb));
    }
}

// Repetitive-read screen: flag reads whose best Hamming self-similarity at
// offsets 1..maxoff exceeds thr (fraction scaled by 1e6 to keep the ABI
// integral). Semantics mirror the reference checkRepetitive
// (src/Consensus.cpp:405-424): similarity(off) = matches / (len - off);
// reads with len <= maxoff are never flagged.
void ns_repetitive_screen(
    const uint8_t* packed, const int64_t* offsets, const int64_t* lengths,
    int64_t N, int32_t maxoff, int32_t thr_x1e6,
    uint8_t* out_mask)
{
    #pragma omp parallel
    {
        int64_t cap = 0;
        uint8_t* buf = nullptr;
        #pragma omp for schedule(dynamic, 64)
        for (int64_t r = 0; r < N; ++r) {
            const int64_t len = lengths[r];
            out_mask[r] = 0;
            if (len <= maxoff) continue;
            if (len > cap) {
                delete[] buf;
                cap = len + (len >> 2) + 64;
                buf = new uint8_t[cap];
            }
            const uint8_t* src = packed + offsets[r];
            const int64_t nb = len / 4;
            for (int64_t i = 0; i < nb; ++i) {
                const uint8_t v = src[i];
                buf[4 * i + 0] = v & 3;
                buf[4 * i + 1] = (v >> 2) & 3;
                buf[4 * i + 2] = (v >> 4) & 3;
                buf[4 * i + 3] = (v >> 6) & 3;
            }
            for (int64_t p = 4 * nb; p < len; ++p)
                buf[p] = (src[p / 4] >> (2 * (p % 4))) & 3;
            for (int32_t off = 1; off <= maxoff; ++off) {
                const int64_t span = len - off;
                int64_t matches = 0;
                const uint8_t* a = buf;
                const uint8_t* b = buf + off;
                for (int64_t i = 0; i < span; ++i)
                    matches += (int64_t)(a[i] == b[i]);
                // frac > thr  <=>  matches * 1e6 > thr_x1e6 * span
                if (matches * 1000000 > (int64_t)thr_x1e6 * span) {
                    out_mask[r] = 1;
                    break;
                }
            }
        }
        delete[] buf;
    }
}

// ---------------------------------------------------------------------------
// Edit-script extraction (ops bytes -> archive fields), two-pass.
//
// Semantics identical to the numpy version in ops/align.py
// (reference equivalent: read2EditScript, src/ConsensusGraph.cpp:1031-1096):
//   head = leading 'i'-run length (all-'i' script: head = len, tail = 0)
//   tail = trailing 'i'-run length
//   body = ops[head : len - tail]; edits are body ops != '='
//   runs = per edit, count of '=' since previous edit; +1 final run
//   literals = query base (ASCII) for every 'i' or 's' op, in op order,
//              INCLUDING head/tail 'i' runs.
// ---------------------------------------------------------------------------

// Pass 1: per-member counts. n_edits[p], n_lits[p], head[p], tail[p].
void ns_edit_counts(
    const uint8_t* ops_flat, const int64_t* ops_off, const int64_t* ops_len,
    int64_t P,
    int64_t* n_edits, int64_t* n_lits, int64_t* head, int64_t* tail)
{
    #pragma omp parallel for schedule(dynamic, 16)
    for (int64_t p = 0; p < P; ++p) {
        const uint8_t* ops = ops_flat + ops_off[p];
        const int64_t len = ops_len[p];
        int64_t h = 0;
        while (h < len && ops[h] == 'i') ++h;
        int64_t t = 0;
        if (h < len) {
            while (t < len && ops[len - 1 - t] == 'i') ++t;
        }
        int64_t ne = 0, nl = 0;
        for (int64_t x = 0; x < len; ++x) {
            const uint8_t o = ops[x];
            if (o == 'i' || o == 's') ++nl;
            if (x >= h && x < len - t && o != '=') ++ne;
        }
        n_edits[p] = ne;
        n_lits[p] = nl;
        head[p] = h;
        tail[p] = t;
    }
}

// Pass 2: fill runs/types/bases. run_off[p] = exclusive cumsum of
// (n_edits+1); lit_off[p] = exclusive cumsum of n_lits. queries are 2-bit
// codes; bases_out is ASCII.
void ns_edit_fill(
    const uint8_t* ops_flat, const int64_t* ops_off, const int64_t* ops_len,
    const uint8_t* queries_flat, const int64_t* q_off,
    const int64_t* head, const int64_t* tail,
    const int64_t* run_off, const int64_t* lit_off,
    int64_t P,
    int64_t* runs_out, uint8_t* types_out, uint8_t* bases_out)
{
    static const char LUT[4] = {'A', 'C', 'G', 'T'};
    #pragma omp parallel for schedule(dynamic, 16)
    for (int64_t p = 0; p < P; ++p) {
        const uint8_t* ops = ops_flat + ops_off[p];
        const int64_t len = ops_len[p];
        const uint8_t* q = queries_flat + q_off[p];
        const int64_t h = head[p], t = tail[p];
        int64_t* runs = runs_out + run_off[p];
        // run slots per member = edits + 1, so the member's type offset is
        // its run offset minus its index.
        uint8_t* ty = types_out + (run_off[p] - p);
        int64_t qpos = 0, li = lit_off[p];
        int64_t eq_run = 0, ei = 0;
        for (int64_t x = 0; x < len; ++x) {
            const uint8_t o = ops[x];
            const bool body = (x >= h) && (x < len - t);
            if (o == 'i' || o == 's') bases_out[li++] = (uint8_t)LUT[q[qpos] & 3];
            if (body) {
                if (o == '=') {
                    ++eq_run;
                } else {
                    runs[ei] = eq_run;
                    ty[ei] = o;
                    ++ei;
                    eq_run = 0;
                }
            }
            if (o != 'd') ++qpos;  // '=', 's', 'i' consume query
        }
        runs[ei] = eq_run;  // final run
    }
}

// ---------------------------------------------------------------------------
// LEB128 varints (the archive's .pos/.exc number encoding; reference
// equivalent: DirectoryUtils write/read_var_uint32,
// src/DirectoryUtils.cpp:6-28). Single-pass native versions of the
// multi-pass numpy codecs in io/streams.py.
// ---------------------------------------------------------------------------

// out must have capacity 10 bytes per value; returns bytes written.
int64_t ns_varint_encode(const uint64_t* vals, int64_t n, uint8_t* out)
{
    int64_t o = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t v = vals[i];
        while (v >= 0x80) {
            out[o++] = (uint8_t)(v | 0x80);
            v >>= 7;
        }
        out[o++] = (uint8_t)v;
    }
    return o;
}

// out must have capacity = number of bytes < 0x80 in buf; returns count.
int64_t ns_varint_decode(const uint8_t* buf, int64_t n, uint64_t* out)
{
    int64_t m = 0;
    uint64_t v = 0;
    int shift = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t b = buf[i];
        v |= (uint64_t)(b & 0x7F) << shift;
        if (b < 0x80) {
            out[m++] = v;
            v = 0;
            shift = 0;
        } else {
            shift += 7;
        }
    }
    return m;
}


// Unpack lone reads straight into an ASCII line buffer: for each id,
// 2-bit codes -> "ACGT" bytes + '\n'. Replaces the python path's padded
// (n, Lpad) matrix + boolean mask + scatter (serialize.py serialize_lone
// was ~65 MB/s; this runs at memory speed). Reference role: the .lone
// stream write, src/ConsensusGraph.cpp:1014-1016.
int64_t ns_emit_lone(const uint8_t* packed, const int64_t* offsets,
                     const int64_t* lengths, const int64_t* ids, int64_t n,
                     uint8_t* out)
{
    static const char* B = "ACGT";
    int64_t o = 0;
    for (int64_t x = 0; x < n; ++x) {
        const int64_t r = ids[x];
        const int64_t len = lengths[r];
        const uint8_t* src = packed + offsets[r];
        int64_t i = 0;
        for (; i + 4 <= len; i += 4) {
            const uint8_t b = src[i >> 2];
            out[o++] = (uint8_t)B[b & 3];
            out[o++] = (uint8_t)B[(b >> 2) & 3];
            out[o++] = (uint8_t)B[(b >> 4) & 3];
            out[o++] = (uint8_t)B[(b >> 6) & 3];
        }
        for (; i < len; ++i)
            out[o++] = (uint8_t)B[(src[i >> 2] >> (2 * (i & 3))) & 3];
        out[o++] = '\n';
    }
    return o;
}

}  // extern "C"
