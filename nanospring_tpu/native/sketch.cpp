// Host-side MinHash sketching — bit-identical to the device kernel in
// ops/sketch.py (same canonical k-mer construction and murmur3-finalizer
// hash family), so the backend choice (the device kernel on a GPU, this
// one on a CPU backend; contigs.py::sketch_backend) can never change the
// candidate graph or the archive bytes.
//
// Reference role: MinHashReadFilter::string2Sketch
// (reference src/ReadFilter.cpp:117-136) — per read, all k-mers, n hash
// functions, per-function minimum. Differences (shared with the device
// kernel): canonical (strand-invariant) k-mers and deterministic seeds.
//
// Hash (must match ops/sketch.py exactly):
//   v      = min(fwd, rc) as the 2k-bit k-mer integer
//   lo, hi = low/high 32 bits of v
//   y      = fmix32(lo);  z = fmix32(hi ^ y)   (mixed once per k-mer)
//   h_j    = y * (seed_lo[j] | 1) + z * (seed_hi[j] | 1)
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

}  // namespace

extern "C" {

// packed: 2-bit codes, 4 bases/byte LSB-first; per-read byte offsets.
// out: n_rids x n_seeds uint32, row-major, pre-filled by caller or not
// (every row is fully written: EMPTY=0xFFFFFFFF for reads below min_len).
void ns_sketch_reads(
    const uint8_t* packed, const int64_t* offsets, const int64_t* lengths,
    const int64_t* rids, int64_t n_rids,
    const uint32_t* seed_lo, const uint32_t* seed_hi, int64_t n_seeds,
    int64_t k, int64_t min_len, uint32_t* out)
{
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int rc_shift = (int)(2 * (k - 1));
    #pragma omp parallel
    {
        std::vector<uint32_t> best((size_t)n_seeds);
        #pragma omp for schedule(dynamic, 16)
        for (int64_t i = 0; i < n_rids; ++i) {
            const int64_t rid = rids[i];
            const int64_t len = lengths[rid];
            uint32_t* row = out + (size_t)i * (size_t)n_seeds;
            if (len < min_len || len < k) {
                for (int64_t j = 0; j < n_seeds; ++j) row[j] = 0xFFFFFFFFu;
                continue;
            }
            for (int64_t j = 0; j < n_seeds; ++j) best[(size_t)j] = 0xFFFFFFFFu;
            const uint8_t* src = packed + offsets[rid];
            uint64_t fwd = 0, rc = 0;
            for (int64_t p = 0; p < len; ++p) {
                const uint64_t c = (src[p >> 2] >> (2 * (p & 3))) & 3;
                fwd = ((fwd << 2) | c) & mask;
                rc = (rc >> 2) | ((3ULL - c) << rc_shift);
                if (p < k - 1) continue;
                const uint64_t v = fwd < rc ? fwd : rc;
                const uint32_t lo = (uint32_t)v;
                const uint32_t hi = (uint32_t)(v >> 32);
                const uint32_t y = fmix32(lo);
                const uint32_t z = fmix32(hi ^ y);
                uint32_t* __restrict__ b = best.data();
                // fixed-trip multiply-add family (one mix per k-mer
                // above): 32-bit mul/add — vectorizes to mullo_epi32
                for (int64_t j = 0; j < n_seeds; ++j) {
                    const uint32_t h =
                        y * (seed_lo[j] | 1u) + z * (seed_hi[j] | 1u);
                    if (h < b[j]) b[j] = h;
                }
            }
            std::memcpy(row, best.data(), (size_t)n_seeds * 4);
        }
    }
}

}  // extern "C"
