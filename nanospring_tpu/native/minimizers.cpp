// (w,k)-minimizer extraction over 2-bit codes — the seeding-stage hot loop
// (role of minimap2's mm_sketch, reference: minimap2/sketch.c:77-143).
// Exactly matches ops/minimizers.py's numpy definition: canonical k-mer
// (big-endian fwd packing vs little-endian complement), splitmix64 finalize,
// per-window FIRST minimum, consecutive duplicates deduplicated.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// out arrays must have capacity >= L - k + 1. Returns emitted count
// (0 if L < k).
int64_t ns_minimizers(const uint8_t* codes, int64_t L, int32_t k, int32_t w,
                      uint64_t* out_h, int64_t* out_pos, uint8_t* out_fwd) {
  const int64_t P = L - k + 1;
  if (P <= 0) return 0;
  // rolling canonical k-mer hashes
  static thread_local uint64_t* h = nullptr;
  static thread_local uint8_t* f = nullptr;
  static thread_local int64_t h_cap = 0;
  if (P > h_cap) {
    delete[] h;
    delete[] f;
    h_cap = P * 2;
    h = new uint64_t[h_cap];
    f = new uint8_t[h_cap];
  }
  const uint64_t mask = (k == 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  uint64_t fwd = 0, rc = 0;
  for (int64_t j = 0; j < k; ++j) {
    fwd = ((fwd << 2) | codes[j]) & mask;
    rc = (rc >> 2) | (uint64_t(3 - codes[j]) << (2 * (k - 1)));
  }
  h[0] = mix64(fwd <= rc ? fwd : rc);
  f[0] = fwd <= rc;
  for (int64_t i = 1; i < P; ++i) {
    uint64_t c = codes[i + k - 1];
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | (uint64_t(3 - c) << (2 * (k - 1)));
    h[i] = mix64(fwd <= rc ? fwd : rc);
    f[i] = fwd <= rc;
  }
  if (P <= w) {
    // single window: global first-minimum
    int64_t best = 0;
    for (int64_t i = 1; i < P; ++i)
      if (h[i] < h[best]) best = i;
    out_h[0] = h[best];
    out_pos[0] = best;
    out_fwd[0] = f[best];
    return 1;
  }
  // monotonic deque of indices; front = first minimum of current window
  static thread_local int64_t* dq = nullptr;
  static thread_local int64_t dq_cap = 0;
  if (P > dq_cap) {
    delete[] dq;
    dq_cap = P * 2;
    dq = new int64_t[dq_cap];
  }
  int64_t head = 0, tail = 0;  // [head, tail)
  int64_t n = 0;
  int64_t last = -1;
  for (int64_t i = 0; i < P; ++i) {
    while (tail > head && h[dq[tail - 1]] > h[i]) --tail;  // keep first min
    dq[tail++] = i;
    if (dq[head] <= i - w) ++head;
    if (i >= w - 1) {
      int64_t p = dq[head];
      if (p != last) {
        out_h[n] = h[p];
        out_pos[n] = p;
        out_fwd[n] = f[p];
        ++n;
        last = p;
      }
    }
  }
  return n;
}

// Whole-dataset minimizer tables, prepared (sorted-by-hash, deduped) per
// read — precomputed once on host threads (overlapped with the sketch)
// so the engine's per-candidate build_minimizers becomes a memcpy.
// pass 0: counts[r] = prepared entry count per read.
// pass 1: counts is the exclusive-cumsum offsets (N+1); h/p/f filled.
extern int64_t ns_anchor_prepare(uint64_t*, int64_t*, uint8_t*, int64_t);

void ns_minimizers_all(
    const uint8_t* packed, const int64_t* offsets, const int64_t* lengths,
    int64_t N, int32_t k, int32_t w, int32_t pass,
    int64_t* counts, uint64_t* out_h, int64_t* out_p, uint8_t* out_f)
{
  // runs in a background thread overlapped with the sketch. Full team:
  // the device sketch's feeder mostly waits on the device, and the native
  // sketch's own OMP loop time-slices fine — reserving it a core just meant the
  // premz tail (single-threaded on a 2-core host) stalled the engine
  // start for ~0.6s on the 60 Mb bench
  int nt = 1;
  #ifdef _OPENMP
  nt = omp_get_max_threads();
  #endif
  #pragma omp parallel num_threads(nt)
  {
    std::vector<uint8_t> codes;
    std::vector<uint64_t> th;
    std::vector<int64_t> tp;
    std::vector<uint8_t> tf;
    #pragma omp for schedule(dynamic, 64)
    for (int64_t r = 0; r < N; ++r) {
      const int64_t len = lengths[r];
      const int64_t cap = len - k + 1;
      if (cap <= 0) {
        if (pass == 0) counts[r] = 0;
        continue;
      }
      if ((int64_t)codes.size() < len) codes.resize((size_t)len + 64);
      const uint8_t* src = packed + offsets[r];
      for (int64_t i = 0; i < len; ++i)
        codes[(size_t)i] = (src[i / 4] >> (2 * (i % 4))) & 3;
      if ((int64_t)th.size() < cap) {
        th.resize((size_t)cap);
        tp.resize((size_t)cap);
        tf.resize((size_t)cap);
      }
      int64_t n = ns_minimizers(codes.data(), len, k, w,
                                th.data(), tp.data(), tf.data());
      n = ns_anchor_prepare(th.data(), tp.data(), tf.data(), n);
      if (pass == 0) {
        counts[r] = n;
      } else {
        const int64_t off = counts[r];
        std::memcpy(out_h + off, th.data(), (size_t)n * 8);
        std::memcpy(out_p + off, tp.data(), (size_t)n * 8);
        std::memcpy(out_f + off, tf.data(), (size_t)n);
      }
    }
  }
}

}  // extern "C"
