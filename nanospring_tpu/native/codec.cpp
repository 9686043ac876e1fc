// Block-sorting entropy codec: SA-IS BWT + MTF + RLE0 + adaptive binary
// range coder. From-scratch C++ host-CPU stage filling the role libbsc
// (BWT via libsais + QLFC coder) plays in the reference
// (reference: src/bsc.cpp:1045-1057 — 48 MB blocks, coder e2;
//  libbsc/bwt/libsais, libbsc/coder/qlfc). Entropy coding is byte-serial
// and branchy — the wrong shape for a wide accelerator — so it stays
// native on host.
//
// Block format: [u32 n][u32 primary][rc payload]  (raw-escape: primary =
// 0xFFFFFFFF, payload = the input verbatim, for incompressible blocks).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SA-IS suffix array (Nong–Zhang–Chan induced sorting), int32 indices.
// s[n-1] must be a unique smallest sentinel (0).
// ---------------------------------------------------------------------------

template <typename C>
void sais_int(const C* s, int32_t* SA, int32_t n, int32_t K) {
  std::vector<uint8_t> t(n);  // 1 = S-type
  t[n - 1] = 1;
  for (int32_t i = n - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;
  auto isLMS = [&](int32_t i) { return i > 0 && t[i] && !t[i - 1]; };

  // bucket counts once per level (getBuckets used to re-scan s[] on
  // every induce pass - 2 extra O(n) reads per call)
  std::vector<int32_t> cnt(K, 0), bkt(K);
  for (int32_t i = 0; i < n; ++i) cnt[s[i]]++;
  auto getBuckets = [&](bool end) {
    int32_t sum = 0;
    for (int32_t i = 0; i < K; ++i) {
      sum += cnt[i];
      bkt[i] = end ? sum : sum - cnt[i];
    }
  };

  auto induceSAl = [&]() {
    getBuckets(false);
    for (int32_t i = 0; i < n; ++i) {
      int32_t j = SA[i] - 1;
      if (SA[i] > 0 && !t[j]) SA[bkt[s[j]]++] = j;
    }
  };
  auto induceSAs = [&]() {
    getBuckets(true);
    for (int32_t i = n - 1; i >= 0; --i) {
      int32_t j = SA[i] - 1;
      if (SA[i] > 0 && t[j]) SA[--bkt[s[j]]] = j;
    }
  };

  // stage 1: sort LMS substrings
  getBuckets(true);
  for (int32_t i = 0; i < n; ++i) SA[i] = -1;
  for (int32_t i = 1; i < n; ++i)
    if (isLMS(i)) SA[--bkt[s[i]]] = i;
  induceSAl();
  induceSAs();

  // compact sorted LMS positions into SA[0..n1)
  int32_t n1 = 0;
  for (int32_t i = 0; i < n; ++i)
    if (isLMS(SA[i])) SA[n1++] = SA[i];
  for (int32_t i = n1; i < n; ++i) SA[i] = -1;

  // name LMS substrings
  int32_t name = 0, prev = -1;
  for (int32_t i = 0; i < n1; ++i) {
    int32_t pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (int32_t d = 0;; ++d) {
        if (pos + d == n || prev + d == n) { diff = (pos + d == n) != (prev + d == n); break; }
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) { diff = true; break; }
        if (d > 0 && (isLMS(pos + d) || isLMS(prev + d))) {
          diff = !(isLMS(pos + d) && isLMS(prev + d));
          break;
        }
      }
    }
    if (diff) { ++name; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  for (int32_t i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  // stage 2: recurse if names are not unique
  int32_t* SA1 = SA;
  int32_t* s1 = SA + n - n1;
  if (name < n1) {
    sais_int<int32_t>(s1, SA1, n1, name);
  } else {
    for (int32_t i = 0; i < n1; ++i) SA1[s1[i]] = i;
  }

  // stage 3: induce the full SA from sorted LMS suffixes
  std::vector<int32_t> lms(n1);
  for (int32_t i = 1, j = 0; i < n; ++i)
    if (isLMS(i)) lms[j++] = i;
  for (int32_t i = 0; i < n1; ++i) SA1[i] = lms[SA1[i]];
  for (int32_t i = n1; i < n; ++i) SA[i] = -1;
  getBuckets(true);
  for (int32_t i = n1 - 1; i >= 0; --i) {
    int32_t j = SA[i];
    SA[i] = -1;
    SA[--bkt[s[j]]] = j;
  }
  induceSAl();
  induceSAs();
}

// BWT of data[0..n) via the suffix array of data + sentinel.
// Returns primary index (row of the sentinel-started suffix's predecessor).
// Checkpointed BWT: alongside the transform, emit ISA samples at the
// decode-chain boundaries so the inverse can run nck independent LF walks
// (one serial pointer-chase was ~90% of decode wall; k interleaved chains
// hide the cache-miss latency). ck[s] = ISA[n - s*L] for s in [1, nck),
// L = n / nck — free here because the suffix array is already built.
uint32_t bwt_forward(const uint8_t* data, int64_t n, uint8_t* out,
                     int nck = 1, uint32_t* ck = nullptr) {
  std::vector<uint16_t> s(n + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = uint16_t(data[i]) + 1;
  s[n] = 0;
  std::vector<int32_t> SA(n + 1);
  sais_int<uint16_t>(s.data(), SA.data(), int32_t(n + 1), 258);
  uint32_t primary = 0;
  int64_t k = 0;
  const int64_t L = nck > 1 ? n / nck : 0;
  for (int64_t i = 0; i <= n; ++i) {
    const int64_t j = SA[i];
    if (nck > 1 && j > 0 && (n - j) % L == 0) {
      const int64_t cs = (n - j) / L;
      if (cs >= 1 && cs < nck) ck[cs] = uint32_t(i);
    }
    if (j == 0) {
      primary = uint32_t(i);
      continue;
    }
    out[k++] = data[j - 1];
  }
  return primary;
}

// Inverse BWT: bwt[0..n) + primary -> original data.
//
// The LF walk is a serial random pointer-chase — one outstanding cache
// miss per step made it ~90% of nsbwt decode wall (0.65 s for 2.9 MB on
// the bench host). Two fixes:
//   - next-pointer and output byte are packed into ONE row-indexed array
//     (u32 when they fit, u64 otherwise), so each step costs a single
//     random load instead of two plus a branch;
//   - with ISA checkpoints (ck[s] from bwt_forward), the walk splits
//     into nck independent chains executed round-robin in one loop, so
//     the core keeps nck cache misses in flight instead of 1.
// The reference's libbsc role gets this from libsais's optimized unbwt
// (/root/reference/libbsc/bwt/libsais/libsais.c); this is the same idea
// rebuilt on the ISA-checkpoint formulation.
template <typename NXT>
void bwt_inverse_chains(const uint8_t* bwt, int64_t n, uint32_t primary,
                        uint8_t* out, int nck, const uint32_t* ck) {
  std::vector<int64_t> cnt(257, 0);
  for (int64_t i = 0; i < n; ++i) cnt[bwt[i] + 1]++;
  int64_t sum = 1;  // sentinel occupies rank 0
  std::vector<int64_t> C(256);
  for (int32_t c = 0; c < 256; ++c) {
    C[c] = sum;
    sum += cnt[c + 1];
  }
  // nxt[row] = (LF(row) << 8) | bwt-char(row); row primary unused.
  // bwt index bi < primary maps to row bi, bi >= primary to row bi+1.
  std::vector<NXT> nxt((size_t)n + 1);
  std::vector<int64_t> occ(256, 0);
  for (int64_t bi = 0; bi < n; ++bi) {
    const uint8_t c = bwt[bi];
    const int64_t lf = C[c] + occ[c]++;
    nxt[(size_t)(bi + (bi >= (int64_t)primary ? 1 : 0))] =
        (NXT(lf) << 8) | NXT(c);
  }
  constexpr int KMAX = 32;
  if (nck <= 1 || !ck) {
    NXT row = 0;
    for (int64_t i = n - 1; i >= 0; --i) {
      const NXT v = nxt[(size_t)row];
      out[i] = uint8_t(v);
      row = v >> 8;
    }
    return;
  }
  if (nck > KMAX) nck = KMAX;  // encoder never writes more
  const int64_t L = n / nck;
  NXT row[KMAX];
  int64_t pos[KMAX];
  row[0] = 0;
  pos[0] = n - 1;
  for (int s = 1; s < nck; ++s) {
    row[s] = (NXT)ck[s];
    pos[s] = n - 1 - (int64_t)s * L;
  }
  // round-robin main loop: all chains advance one step per iteration,
  // keeping nck independent misses in flight
  for (int64_t step = 0; step < L; ++step) {
    for (int s = 0; s < nck; ++s) {
      const NXT v = nxt[(size_t)row[s]];
      out[pos[s]--] = uint8_t(v);
      row[s] = v >> 8;
    }
  }
  // chain nck-1 owns the n % nck remainder at the low end
  {
    const int s = nck - 1;
    while (pos[s] >= 0) {
      const NXT v = nxt[(size_t)row[s]];
      out[pos[s]--] = uint8_t(v);
      row[s] = v >> 8;
    }
  }
}

void bwt_inverse(const uint8_t* bwt, int64_t n, uint32_t primary, uint8_t* out,
                 int nck = 1, const uint32_t* ck = nullptr) {
  if (n <= 0) return;
  if (n + 1 < (int64_t(1) << 24))
    bwt_inverse_chains<uint32_t>(bwt, n, primary, out, nck, ck);
  else
    bwt_inverse_chains<uint64_t>(bwt, n, primary, out, nck, ck);
}

// ---------------------------------------------------------------------------
// LZMA-style binary range coder with adaptive 12-bit probabilities.
// ---------------------------------------------------------------------------

// Dual-rate adaptive probability (libbsc's qlfc counter idea): a fast
// counter tracks local statistics, a slow one the block-wide distribution;
// coding uses their mean. Beats a single shift-5 counter on every stream
// measured (docs/CODECS.md).
struct Prob {
  uint16_t fast = 2048, slow = 2048;
  inline uint32_t p() const { return (uint32_t(fast) + uint32_t(slow)) >> 1; }
  inline void update(int bit) {
    if (!bit) {
      fast += (4096 - fast) >> 3;
      slow += (4096 - slow) >> 6;
    } else {
      fast -= fast >> 3;
      slow -= slow >> 6;
    }
  }
};

struct RangeEncoder {
  std::vector<uint8_t>& out;
  uint64_t low = 0;
  uint32_t range = 0xFFFFFFFFu;
  uint8_t cache = 0;
  int64_t cacheSize = 1;

  explicit RangeEncoder(std::vector<uint8_t>& o) : out(o) {}

  void shiftLow() {
    if (uint32_t(low) < 0xFF000000u || (low >> 32) != 0) {
      uint8_t carry = uint8_t(low >> 32);
      while (cacheSize) {
        out.push_back(uint8_t(cache + carry));
        cache = 0xFF;
        --cacheSize;
      }
      cache = uint8_t(low >> 24);
    }
    ++cacheSize;
    low = (low << 8) & 0xFFFFFFFFu;
  }

  void encode(uint16_t& p, int bit) {
    uint32_t bound = (range >> 12) * p;
    if (!bit) {
      range = bound;
      p += (4096 - p) >> 5;
    } else {
      low += bound;
      range -= bound;
      p -= p >> 5;
    }
    while (range < (1u << 24)) {
      shiftLow();
      range <<= 8;
    }
  }

  void encode4(uint16_t& p, int bit) {
    uint32_t bound = (range >> 12) * p;
    if (!bit) {
      range = bound;
      p += (4096 - p) >> 4;
    } else {
      low += bound;
      range -= bound;
      p -= p >> 4;
    }
    while (range < (1u << 24)) {
      shiftLow();
      range <<= 8;
    }
  }

  void encode(Prob& pr, int bit) {
    uint32_t bound = (range >> 12) * pr.p();
    if (!bit) {
      range = bound;
    } else {
      low += bound;
      range -= bound;
    }
    pr.update(bit);
    while (range < (1u << 24)) {
      shiftLow();
      range <<= 8;
    }
  }

  void encodeDirect(uint32_t v, int nbits) {
    for (int i = nbits - 1; i >= 0; --i) {
      range >>= 1;
      if ((v >> i) & 1) low += range;
      while (range < (1u << 24)) {
        shiftLow();
        range <<= 8;
      }
    }
  }

  void flush() {
    for (int i = 0; i < 5; ++i) shiftLow();
  }
};

struct RangeDecoder {
  const uint8_t* in;
  int64_t pos = 0, size;
  uint32_t range = 0xFFFFFFFFu;
  uint32_t code = 0;

  RangeDecoder(const uint8_t* i, int64_t n) : in(i), size(n) {
    ++pos;  // first byte is always 0
    for (int k = 0; k < 4; ++k) code = (code << 8) | next();
  }
  uint8_t next() { return pos < size ? in[pos++] : 0; }

  int decode(uint16_t& p) {
    uint32_t bound = (range >> 12) * p;
    int bit;
    if (code < bound) {
      range = bound;
      p += (4096 - p) >> 5;
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      p -= p >> 5;
      bit = 1;
    }
    while (range < (1u << 24)) {
      code = (code << 8) | next();
      range <<= 8;
    }
    return bit;
  }

  int decode4(uint16_t& p) {
    uint32_t bound = (range >> 12) * p;
    int bit;
    if (code < bound) {
      range = bound;
      p += (4096 - p) >> 4;
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      p -= p >> 4;
      bit = 1;
    }
    while (range < (1u << 24)) {
      code = (code << 8) | next();
      range <<= 8;
    }
    return bit;
  }

  int decode(Prob& pr) {
    uint32_t bound = (range >> 12) * pr.p();
    int bit;
    if (code < bound) {
      range = bound;
      bit = 0;
    } else {
      code -= bound;
      range -= bound;
      bit = 1;
    }
    pr.update(bit);
    while (range < (1u << 24)) {
      code = (code << 8) | next();
      range <<= 8;
    }
    return bit;
  }

  uint32_t decodeDirect(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i) {
      range >>= 1;
      int bit = 0;
      if (code >= range) {
        code -= range;
        bit = 1;
      }
      v = (v << 1) | uint32_t(bit);
      while (range < (1u << 24)) {
        code = (code << 8) | next();
        range <<= 8;
      }
    }
    return v;
  }
};

// ---------------------------------------------------------------------------
// MTF + RLE0 + context-modeled coding of BWT output (QLFC-class).
// ---------------------------------------------------------------------------

struct Model {
  // zero-run lengths: Elias-gamma with adaptive bits, contexted by the
  // preceding rank class (runs after rank-1 symbols behave differently
  // from runs after deep ranks — QLFC-e2's insight, libbsc qlfc.cpp role)
  uint16_t runLen[2][32];     // unary length-of-length bits
  uint16_t runBits[2][32];    // value bits by position
  // nonzero ranks: 8-bit bit-tree, context = previous rank class (4) x
  // whether a zero run intervened (2)
  uint16_t rank[8][256];
  Model() {
    for (auto& c : runLen)
      for (auto& p : c) p = 2048;
    for (auto& c : runBits)
      for (auto& p : c) p = 2048;
    for (auto& c : rank)
      for (auto& p : c) p = 2048;
  }
};

inline int rank_class(int r) {
  return r == 1 ? 0 : (r == 2 ? 1 : (r < 8 ? 2 : 3));
}

void encode_run(RangeEncoder& rc, Model& m, int ctx, uint64_t v) {
  // encode v (>= 0) as gamma of v+1
  uint64_t x = v + 1;
  int nb = 63 - __builtin_clzll(x);  // number of value bits after the top 1
  for (int i = 0; i < nb; ++i) rc.encode(m.runLen[ctx][i < 31 ? i : 31], 1);
  rc.encode(m.runLen[ctx][nb < 31 ? nb : 31], 0);
  for (int i = nb - 1; i >= 0; --i)
    rc.encode(m.runBits[ctx][i < 31 ? i : 31], int((x >> i) & 1));
}

uint64_t decode_run(RangeDecoder& rc, Model& m, int ctx) {
  int nb = 0;
  while (rc.decode(m.runLen[ctx][nb < 31 ? nb : 31])) ++nb;
  uint64_t x = 1;
  for (int i = nb - 1; i >= 0; --i)
    x = (x << 1) | uint64_t(rc.decode(m.runBits[ctx][i < 31 ? i : 31]));
  return x - 1;
}

void encode_rank(RangeEncoder& rc, Model& m, int ctx, uint8_t r) {
  // bit-tree over the 8 bits of r (r >= 1)
  uint32_t node = 1;
  for (int b = 7; b >= 0; --b) {
    int bit = (r >> b) & 1;
    rc.encode(m.rank[ctx][node], bit);
    node = (node << 1) | uint32_t(bit);
  }
}

uint8_t decode_rank(RangeDecoder& rc, Model& m, int ctx) {
  uint32_t node = 1;
  for (int b = 7; b >= 0; --b) node = (node << 1) | uint32_t(rc.decode(m.rank[ctx][node]));
  return uint8_t(node & 0xFF);
}

// LZP long-range pre-pass (the role of libbsc's lzp stage): at each
// position whose preceding HLEN bytes hash to a previously seen position,
// a match of >= MINLEN bytes collapses to [ESC][gamma(len-MINLEN)]; the
// residue (mostly literals) then goes through BWT + the contexted coder.
// The decoder rebuilds the same hash table from its own output, so the
// transform is self-synchronizing. This is what lets the block coder
// capture the multi-kb overlaps between neighboring contig consensi that
// an LZ77 window exploits natively.
namespace lzp {

constexpr int HLEN = 16;
constexpr int64_t MINLEN = 32;
constexpr uint8_t ESC = 0xFB;   // rare in 2-bit-coded / varint streams
constexpr int HBITS = 20;

inline uint32_t hash16(const uint8_t* p) {
  uint64_t a, b;
  std::memcpy(&a, p, 8);
  std::memcpy(&b, p + 8, 8);
  uint64_t h = (a * 0x9E3779B97F4A7C15ull) ^ (b * 0xC2B2AE3D27D4EB4Full);
  return uint32_t(h >> (64 - HBITS));
}

inline void put_gamma(std::vector<uint8_t>& out, uint64_t v) {
  // LEB128 of v (byte-aligned; feeds the BWT stage, so byte structure
  // beats bit packing here)
  while (v >= 0x80) {
    out.push_back(uint8_t(v) | 0x80);
    v >>= 7;
  }
  out.push_back(uint8_t(v));
}

int64_t encode(const uint8_t* in, int64_t n, std::vector<uint8_t>& out) {
  std::vector<int64_t> table(size_t(1) << HBITS, -1);
  out.clear();
  out.reserve(size_t(n));
  int64_t i = 0;
  while (i < n) {
    if (i >= HLEN && i + MINLEN <= n) {
      const uint32_t h = hash16(in + i - HLEN);
      const int64_t p = table[h];
      table[h] = i;
      if (p >= 0 && std::memcmp(in + p - HLEN, in + i - HLEN, HLEN) == 0) {
        int64_t len = 0;
        const int64_t cap = n - i;
        while (len < cap && in[p + len] == in[i + len]) ++len;
        if (len >= MINLEN) {
          out.push_back(ESC);
          put_gamma(out, uint64_t(len - MINLEN + 1));
          i += len;
          continue;
        }
      }
    }
    const uint8_t c = in[i++];
    out.push_back(c);
    if (c == ESC) put_gamma(out, 0);   // literal escape
  }
  return int64_t(out.size());
}

void decode(const uint8_t* in, int64_t n, std::vector<uint8_t>& out) {
  // The decoder's table replays the encoder's update sequence exactly
  // (same positions, same content), so the encoder-side memcmp guard is
  // redundant here — a match token's source IS the table hit. Dropping
  // the per-literal 16-byte compare and using an int32 table took decode
  // from ~16 to ~50+ MB/s on the genome stream.
  std::vector<int32_t> table(size_t(1) << HBITS, -1);
  out.clear();
  int64_t i = 0;
  while (i < n) {
    const int64_t opos = (int64_t)out.size();
    int64_t mpos = -1;
    if (opos >= HLEN) {
      const uint32_t h = hash16(out.data() + opos - HLEN);
      mpos = table[h];
      table[h] = int32_t(opos);
    }
    const uint8_t c = in[i++];
    if (c == ESC) {
      uint64_t v = 0;
      int sh = 0;
      while (true) {
        const uint8_t b = in[i++];
        v |= uint64_t(b & 0x7F) << sh;
        if (!(b & 0x80)) break;
        sh += 7;
      }
      if (v == 0) {
        out.push_back(ESC);
        continue;
      }
      const int64_t len = int64_t(v) - 1 + MINLEN;
      // match source: the table hit (must exist by construction);
      // copies may overlap themselves (periodic matches), so the byte
      // loop over raw pointers is the safe fast path
      out.resize(size_t(opos + len));
      uint8_t* dst = out.data() + opos;
      const uint8_t* src = out.data() + mpos;
      for (int64_t k = 0; k < len; ++k) dst[k] = src[k];
      continue;
    }
    out.push_back(c);
  }
}

}  // namespace lzp

// Direct order-1 coder (no MTF): run length of the current symbol via
// adaptive gamma, then the next (different) symbol via an 8-bit tree
// contexted on the previous symbol byte — lzma-class literal modeling on
// the BWT output, which keeps the context information MTF destroys.
// Wins on byte-structured streams (pos varints, base literals); the MTF
// coder stays better on tiny-alphabet streams, so ns_bsc_compress tries
// both and keeps the smaller (1 mode byte per block).
struct DirectModel {
  uint16_t runLen[256][32];
  uint16_t runBits[256][32];
  uint16_t sym[256][256];
  DirectModel() {
    for (auto& c : runLen)
      for (auto& p : c) p = 2048;
    for (auto& c : runBits)
      for (auto& p : c) p = 2048;
    for (auto& c : sym)
      for (auto& p : c) p = 2048;
  }
};

void d_encode_run(RangeEncoder& rc, DirectModel& m, int ctx, uint64_t v) {
  uint64_t x = v + 1;
  int nb = 63 - __builtin_clzll(x);
  for (int i = 0; i < nb; ++i) rc.encode(m.runLen[ctx][i < 31 ? i : 31], 1);
  rc.encode(m.runLen[ctx][nb < 31 ? nb : 31], 0);
  for (int i = nb - 1; i >= 0; --i)
    rc.encode(m.runBits[ctx][i < 31 ? i : 31], int((x >> i) & 1));
}

uint64_t d_decode_run(RangeDecoder& rc, DirectModel& m, int ctx) {
  int nb = 0;
  while (rc.decode(m.runLen[ctx][nb < 31 ? nb : 31])) ++nb;
  uint64_t x = 1;
  for (int i = nb - 1; i >= 0; --i)
    x = (x << 1) | uint64_t(rc.decode(m.runBits[ctx][i < 31 ? i : 31]));
  return x - 1;
}

int64_t coder2_encode(const uint8_t* bwt, int64_t n, std::vector<uint8_t>& out) {
  RangeEncoder rc(out);
  static thread_local DirectModel* mp = nullptr;
  if (!mp) mp = new DirectModel();
  *mp = DirectModel();
  DirectModel& m = *mp;
  uint8_t prev = 0;
  int64_t i = 0;
  while (i < n) {
    // run of prev
    uint64_t run = 0;
    while (i + (int64_t)run < n && bwt[i + run] == prev) ++run;
    d_encode_run(rc, m, prev, run);
    i += (int64_t)run;
    if (i >= n) break;
    const uint8_t c = bwt[i];
    uint32_t node = 1;
    for (int b = 7; b >= 0; --b) {
      int bit = (c >> b) & 1;
      rc.encode(m.sym[prev][node], bit);
      node = (node << 1) | uint32_t(bit);
    }
    prev = c;
    ++i;
  }
  rc.flush();
  return int64_t(out.size());
}

void coder2_decode(const uint8_t* in, int64_t in_n, uint8_t* out, int64_t n) {
  RangeDecoder rc(in, in_n);
  static thread_local DirectModel* mp = nullptr;
  if (!mp) mp = new DirectModel();
  *mp = DirectModel();
  DirectModel& m = *mp;
  uint8_t prev = 0;
  int64_t i = 0;
  while (i < n) {
    uint64_t run = d_decode_run(rc, m, prev);
    while (run-- && i < n) out[i++] = prev;
    if (i >= n) break;
    uint32_t node = 1;
    for (int b = 7; b >= 0; --b)
      node = (node << 1) | uint32_t(rc.decode(m.sym[prev][node]));
    prev = uint8_t(node & 0xFF);
    out[i++] = prev;
  }
}

// Small-alphabet order-2 coder: blocks with <= 16 distinct bytes (DNA
// consensus, type stream) remap symbols to 4-bit codes and model them
// with a 16-node tree contexted on the previous TWO symbols (K^2 <= 256
// contexts) — the extra context order is affordable precisely because
// the alphabet is tiny. Header: [u8 K][K alphabet bytes].
struct SmallModel {
  uint16_t runLen[256][32];
  uint16_t runBits[256][32];
  uint16_t sym[1024][16];
  SmallModel() {
    for (auto& c : runLen)
      for (auto& p : c) p = 2048;
    for (auto& c : runBits)
      for (auto& p : c) p = 2048;
    for (auto& c : sym)
      for (auto& p : c) p = 2048;
  }
};

int64_t coder3_encode(const uint8_t* bwt, int64_t n, int K,
                      const uint8_t* alpha, const uint8_t* amap,
                      std::vector<uint8_t>& out) {
  out.push_back(uint8_t(K));
  for (int i = 0; i < K; ++i) out.push_back(alpha[i]);
  RangeEncoder rc(out);
  static thread_local SmallModel* mp = nullptr;
  if (!mp) mp = new SmallModel();
  *mp = SmallModel();
  SmallModel& m = *mp;
  const bool o3 = K <= 8;    // order-3 context when the alphabet allows
  uint32_t p1 = 0, p2 = 0, p3 = 0;   // mapped prev symbols
  int64_t i = 0;
  while (i < n) {
    uint64_t run = 0;
    while (i + (int64_t)run < n && amap[bwt[i + run]] == p1) ++run;
    {
      const uint32_t rctx = p1 * 16 + p2;
      uint64_t x = run + 1;
      int nb = 63 - __builtin_clzll(x);
      for (int b = 0; b < nb; ++b)
        rc.encode(m.runLen[rctx][b < 31 ? b : 31], 1);
      rc.encode(m.runLen[rctx][nb < 31 ? nb : 31], 0);
      for (int b = nb - 1; b >= 0; --b)
        rc.encode(m.runBits[rctx][b < 31 ? b : 31], int((x >> b) & 1));
    }
    i += (int64_t)run;
    if (i >= n) break;
    const uint32_t c = amap[bwt[i]];
    const uint32_t ctx = o3 ? (p1 * 64 + p2 * 8 + p3) : (p1 * 16 + p2);
    uint32_t node = 1;
    for (int b = 3; b >= 0; --b) {
      int bit = (c >> b) & 1;
      rc.encode(m.sym[ctx][node], bit);
      node = (node << 1) | uint32_t(bit);
    }
    p3 = p2;
    p2 = p1;
    p1 = c;
    ++i;
  }
  rc.flush();
  return int64_t(out.size());
}

void coder3_decode(const uint8_t* in, int64_t in_n, uint8_t* out, int64_t n) {
  const int K = in[0];
  const uint8_t* alpha = in + 1;
  RangeDecoder rc(in + 1 + K, in_n - 1 - K);
  static thread_local SmallModel* mp = nullptr;
  if (!mp) mp = new SmallModel();
  *mp = SmallModel();
  SmallModel& m = *mp;
  const bool o3 = K <= 8;
  uint32_t p1 = 0, p2 = 0, p3 = 0;
  int64_t i = 0;
  while (i < n) {
    const uint32_t rctx = p1 * 16 + p2;
    int nb = 0;
    while (rc.decode(m.runLen[rctx][nb < 31 ? nb : 31])) ++nb;
    uint64_t x = 1;
    for (int b = nb - 1; b >= 0; --b)
      x = (x << 1) | uint64_t(rc.decode(m.runBits[rctx][b < 31 ? b : 31]));
    uint64_t run = x - 1;
    while (run-- && i < n) out[i++] = alpha[p1];
    if (i >= n) break;
    const uint32_t ctx = o3 ? (p1 * 64 + p2 * 8 + p3) : (p1 * 16 + p2);
    uint32_t node = 1;
    for (int b = 3; b >= 0; --b)
      node = (node << 1) | uint32_t(rc.decode(m.sym[ctx][node]));
    p3 = p2;
    p2 = p1;
    p1 = node & 15;
    out[i++] = alpha[p1];
  }
}

int64_t coder_encode(const uint8_t* bwt, int64_t n, std::vector<uint8_t>& out) {
  uint8_t mtf[256];
  for (int i = 0; i < 256; ++i) mtf[i] = uint8_t(i);
  RangeEncoder rc(out);
  Model m;
  uint64_t zrun = 0;
  int rcls = 0;   // previous rank class
  for (int64_t i = 0; i < n; ++i) {
    uint8_t c = bwt[i];
    // find rank
    int r = 0;
    while (mtf[r] != c) ++r;
    if (r == 0) {
      ++zrun;
      continue;
    }
    encode_run(rc, m, rcls == 0 ? 0 : 1, zrun);
    encode_rank(rc, m, rcls * 2 + (zrun > 0 ? 1 : 0), uint8_t(r));
    zrun = 0;
    rcls = rank_class(r);
    // move to front
    for (int k = r; k > 0; --k) mtf[k] = mtf[k - 1];
    mtf[0] = c;
  }
  encode_run(rc, m, rcls == 0 ? 0 : 1, zrun);
  rc.flush();
  return int64_t(out.size());
}

void coder_decode(const uint8_t* in, int64_t in_n, uint8_t* out, int64_t n) {
  uint8_t mtf[256];
  for (int i = 0; i < 256; ++i) mtf[i] = uint8_t(i);
  RangeDecoder rc(in, in_n);
  Model m;
  int rcls = 0;
  int64_t i = 0;
  while (i < n) {
    uint64_t zrun = decode_run(rc, m, rcls == 0 ? 0 : 1);
    const bool had_run = zrun > 0;
    while (zrun-- && i < n) out[i++] = mtf[0];
    if (i >= n) break;
    uint8_t r = decode_rank(rc, m, rcls * 2 + (had_run ? 1 : 0));
    rcls = rank_class(r);
    uint8_t c = mtf[r];
    for (int k = r; k > 0; --k) mtf[k] = mtf[k - 1];
    mtf[0] = c;
    out[i++] = c;
  }
}

}  // namespace

extern "C" {

// out must have capacity n + 1024. Returns compressed size.
//
// Block format: [u32 n][u32 primary][u8 mode][u32 lzp_n?][payload]
//   primary == 0xFFFFFFFF: raw escape, payload = input verbatim (no mode).
//   mode bit0-1: coder (1 = direct order-1, 2 = small-alphabet order-2);
//   mode bit2: LZP long-range pre-pass applied (lzp_n u32 follows: the
//   transformed length the coder/BWT stage ran on).
int64_t ns_bsc_compress(const uint8_t* in, int64_t n, uint8_t* out) {
  uint32_t nn = uint32_t(n);
  std::memcpy(out, &nn, 4);
  if (n == 0) {
    uint32_t esc = 0xFFFFFFFFu;
    std::memcpy(out + 4, &esc, 4);
    return 8;
  }
  // LZP pre-pass: collapses multi-kb repeats (overlapping contig
  // consensi) the block coder cannot reach. The decision is by FINAL
  // coded size — LZP can shrink the bytes yet scramble the BWT structure
  // the coder feeds on (measured on the type stream), so when it engages
  // both variants are coded and the smaller wins.
  auto code_block = [](const uint8_t* src, int64_t m,
                       std::vector<uint8_t>& payload,
                       uint32_t* primary, int* nck,
                       uint32_t* ck) -> uint8_t {
    const bool dbg = std::getenv("NSTPU_CODEC_DEBUG") != nullptr;
    auto now = []() {
      struct timespec t;
      clock_gettime(CLOCK_MONOTONIC, &t);
      return t.tv_sec + 1e-9 * t.tv_nsec;
    };
    double t0 = dbg ? now() : 0;
    // inverse-BWT chain count: >= 64k steps per chain, up to 16 chains
    // (see bwt_inverse_chains); 4 bytes of header per chain
    *nck = int(std::min<int64_t>(16, std::max<int64_t>(1, m >> 16)));
    std::vector<uint8_t> bwt((size_t)m);
    *primary = bwt_forward(src, m, bwt.data(), *nck, ck);
    if (dbg) {
      std::fprintf(stderr, "[codec] bwt %.3fs (%lld bytes)\n", now() - t0,
                   (long long)m);
      t0 = now();
    }
    uint8_t amap[256];
    uint8_t alpha[256];
    bool seen[256] = {};
    for (int64_t i = 0; i < m; ++i) seen[bwt[size_t(i)]] = true;
    int K = 0;
    for (int c = 0; c < 256; ++c)
      if (seen[c]) { amap[c] = uint8_t(K); alpha[K++] = uint8_t(c); }
    payload.clear();
    payload.reserve(size_t(m / 2 + 64));
    uint8_t r;
    if (K <= 16) {
      coder3_encode(bwt.data(), m, K, alpha, amap, payload);
      r = 2;
    } else {
      coder2_encode(bwt.data(), m, payload);
      r = 1;
    }
    if (dbg)
      std::fprintf(stderr, "[codec] coder%d %.3fs -> %lld\n", r == 2 ? 3 : 2,
                   now() - t0, (long long)payload.size());
    return r;
  };

  std::vector<uint8_t> lz;
  lzp::encode(in, n, lz);
  std::vector<uint8_t> payload;
  uint32_t primary;
  uint32_t ck[32];
  int nck = 1;
  bool use_lzp = false;
  int64_t m = n;
  const bool lzp_engages0 = int64_t(lz.size()) + n / 50 < n;
  const bool lzp_decisive0 = int64_t(lz.size()) + (3 * n) / 25 < n;
  uint8_t mode = 0;
  if (!lzp_decisive0)
    mode = code_block(in, n, payload, &primary, &nck, ck);
  // LZP engagement policy, measured (round 5, NSTPU_CODEC_DEBUG):
  //   shrink <  2%: never survives the final-size comparison (pos
  //                 stream: 1.2% shrink, 0.09% final difference) — skip.
  //   shrink >= 12%: LZP wins decisively (genome stream: 13.6% shrink,
  //                 8.5% smaller coded) — code ONLY the LZP variant and
  //                 save a whole BWT+coder pass.
  //   2-12%:        marginal (base stream: 3.0% shrink, 0.4% win) and
  //                 LZP can scramble the BWT structure the coder feeds
  //                 on (measured on the type stream) — code both, keep
  //                 the smaller.
  if (lzp_engages0) {
    if (std::getenv("NSTPU_CODEC_DEBUG"))
      std::fprintf(stderr, "[codec] lzp %s: n=%lld lz=%lld "
                   "shrink=%.1f%%\n",
                   lzp_decisive0 ? "single-pass" : "dual-pass",
                   (long long)n, (long long)lz.size(),
                   100.0 * double(n - (int64_t)lz.size()) / double(n));
    std::vector<uint8_t> payload2;
    uint32_t primary2;
    uint32_t ck2[32];
    int nck2 = 1;
    const uint8_t coder2m = code_block(lz.data(), (int64_t)lz.size(),
                                       payload2, &primary2, &nck2, ck2);
    if (lzp_decisive0 || payload2.size() + 4 < payload.size()) {
      payload.swap(payload2);
      primary = primary2;
      mode = coder2m | 4;
      use_lzp = true;
      m = (int64_t)lz.size();
      nck = nck2;
      std::memcpy(ck, ck2, sizeof ck);
    }
  }

  if (nck > 1) mode |= 8;  // inverse-BWT chain checkpoints present
  const int64_t head =
      8 + 1 + (use_lzp ? 4 : 0) + (nck > 1 ? 1 + 4 * (nck - 1) : 0);
  if (head + int64_t(payload.size()) >= n) {  // incompressible: store raw
    uint32_t esc = 0xFFFFFFFFu;
    std::memcpy(out + 4, &esc, 4);
    std::memcpy(out + 8, in, size_t(n));
    return 8 + n;
  }
  std::memcpy(out + 4, &primary, 4);
  out[8] = mode;
  int64_t off = 9;
  if (use_lzp) {
    uint32_t mm = uint32_t(m);
    std::memcpy(out + off, &mm, 4);
    off += 4;
  }
  if (nck > 1) {
    out[off++] = uint8_t(nck);
    std::memcpy(out + off, ck + 1, 4 * size_t(nck - 1));
    off += 4 * (nck - 1);
  }
  std::memcpy(out + off, payload.data(), payload.size());
  return off + int64_t(payload.size());
}

// Returns decompressed size (== stored n). out must have capacity >= n.
int64_t ns_bsc_decompress(const uint8_t* in, int64_t in_n, uint8_t* out) {
  uint32_t nn, primary;
  std::memcpy(&nn, in, 4);
  std::memcpy(&primary, in + 4, 4);
  int64_t n = nn;
  if (n == 0) return 0;
  if (primary == 0xFFFFFFFFu) {
    std::memcpy(out, in + 8, size_t(n));
    return n;
  }
  const uint8_t mode = in[8];
  int64_t off = 9;
  int64_t m = n;
  if (mode & 4) {
    uint32_t mm;
    std::memcpy(&mm, in + off, 4);
    off += 4;
    m = mm;
  }
  uint32_t ck[32] = {0};
  int nck = 1;
  if (mode & 8) {
    nck = in[off++];
    if (nck < 1 || nck > 32) return -1;  // corrupt header
    std::memcpy(ck + 1, in + off, 4 * size_t(nck - 1));
    off += 4 * (nck - 1);
  }
  const bool dbg = std::getenv("NSTPU_CODEC_DEBUG") != nullptr;
  auto now = []() {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return t.tv_sec + 1e-9 * t.tv_nsec;
  };
  double t0 = dbg ? now() : 0;
  std::vector<uint8_t> bwt((size_t)m);
  if ((mode & 3) == 2)
    coder3_decode(in + off, in_n - off, bwt.data(), m);
  else
    coder2_decode(in + off, in_n - off, bwt.data(), m);
  if (dbg) {
    std::fprintf(stderr, "[codec] d coder%d %.3fs (%lld bytes)\n",
                 (mode & 3) == 2 ? 3 : 2, now() - t0, (long long)m);
    t0 = now();
  }
  if (mode & 4) {
    std::vector<uint8_t> lz((size_t)m);
    bwt_inverse(bwt.data(), m, primary, lz.data(), nck, ck);
    if (dbg) {
      std::fprintf(stderr, "[codec] d ibwt %.3fs (nck=%d)\n", now() - t0,
                   nck);
      t0 = now();
    }
    std::vector<uint8_t> dec;
    dec.reserve(size_t(n));
    lzp::decode(lz.data(), m, dec);
    std::memcpy(out, dec.data(), size_t(n));
    if (dbg)
      std::fprintf(stderr, "[codec] d lzp %.3fs\n", now() - t0);
  } else {
    bwt_inverse(bwt.data(), m, primary, out, nck, ck);
    if (dbg)
      std::fprintf(stderr, "[codec] d ibwt %.3fs (nck=%d)\n", now() - t0,
                   nck);
  }
  return n;
}

}  // extern "C"


// ---------------------------------------------------------------------------
// nslz: from-scratch LZ77 + adaptive range coder (the fast-lzma2 role,
// reference: src/lzma2.cpp + fast-lzma2/). Hash-chain match finder with
// one-step lazy matching and a rep0 distance, LZMA-style length/dist-slot
// models over the same binary range coder the BWT stage uses. Payload:
// [u32 raw_n][u8 mode(0 stored, 1 lz)][coded...]; incompressible chunks
// are stored.
// ---------------------------------------------------------------------------

namespace {

constexpr int LZ_MIN_MATCH = 4;
constexpr int LZ_MAX_MATCH = 273;
constexpr int LZ_HASH_BITS = 17;
constexpr int LZ_MAX_CHAIN = 24;

struct LzModel {
  uint16_t is_match[2];          // ctx: previous symbol was a match
  uint16_t is_rep[2];
  uint16_t lit[256][256];        // order-1: ctx = previous byte; bit tree
  uint16_t len_choice[2][2];     // [rep][level]
  uint16_t len_low[2][8];
  uint16_t len_mid[2][8];
  uint16_t len_high[2][256];
  uint16_t dist_slot[4][64];     // ctx: min(len - LZ_MIN_MATCH, 3)
  uint16_t align4[16];

  LzModel() {
    auto fill = [](uint16_t* a, size_t c) {
      for (size_t i = 0; i < c; ++i) a[i] = 2048;
    };
    fill(is_match, 2);
    fill(is_rep, 2);
    fill(&lit[0][0], 256 * 256);
    fill(&len_choice[0][0], 4);
    fill(&len_low[0][0], 16);
    fill(&len_mid[0][0], 16);
    fill(&len_high[0][0], 512);
    fill(&dist_slot[0][0], 4 * 64);
    fill(align4, 16);
  }
};

template <int NB>
inline void tree_encode(RangeEncoder& rc, uint16_t* probs, uint32_t v) {
  uint32_t node = 1;
  for (int b = NB - 1; b >= 0; --b) {
    const int bit = int((v >> b) & 1);
    rc.encode(probs[node], bit);
    node = (node << 1) | uint32_t(bit);
  }
}

template <int NB>
inline uint32_t tree_decode(RangeDecoder& rc, uint16_t* probs) {
  uint32_t node = 1;
  for (int b = 0; b < NB; ++b) node = (node << 1) | uint32_t(rc.decode(probs[node]));
  return node - (1u << NB);
}

inline void len_encode(RangeEncoder& rc, LzModel& m, int rep, uint32_t l) {
  // l = len - LZ_MIN_MATCH in [0, 269]
  if (l < 8) {
    rc.encode(m.len_choice[rep][0], 0);
    tree_encode<3>(rc, m.len_low[rep], l);
  } else if (l < 16) {
    rc.encode(m.len_choice[rep][0], 1);
    rc.encode(m.len_choice[rep][1], 0);
    tree_encode<3>(rc, m.len_mid[rep], l - 8);
  } else {
    rc.encode(m.len_choice[rep][0], 1);
    rc.encode(m.len_choice[rep][1], 1);
    tree_encode<8>(rc, m.len_high[rep], l - 16);
  }
}

inline uint32_t len_decode(RangeDecoder& rc, LzModel& m, int rep) {
  if (!rc.decode(m.len_choice[rep][0])) return tree_decode<3>(rc, m.len_low[rep]);
  if (!rc.decode(m.len_choice[rep][1]))
    return 8 + tree_decode<3>(rc, m.len_mid[rep]);
  return 16 + tree_decode<8>(rc, m.len_high[rep]);
}

inline void dist_encode(RangeEncoder& rc, LzModel& m, uint32_t lctx,
                        uint32_t dist) {
  const uint32_t dd = dist - 1;
  uint32_t slot, nb = 0;
  if (dd < 4) {
    slot = dd;
  } else {
    nb = 31 - uint32_t(__builtin_clz(dd));
    slot = (nb << 1) | ((dd >> (nb - 1)) & 1);
  }
  tree_encode<6>(rc, m.dist_slot[lctx], slot);
  if (slot >= 4) {
    const int extra = int(nb) - 1;
    const uint32_t rem = dd & ((1u << extra) - 1);
    if (extra <= 4) {
      rc.encodeDirect(rem, extra);
    } else {
      rc.encodeDirect(rem >> 4, extra - 4);
      tree_encode<4>(rc, m.align4, rem & 15);
    }
  }
}

inline uint32_t dist_decode(RangeDecoder& rc, LzModel& m, uint32_t lctx) {
  const uint32_t slot = tree_decode<6>(rc, m.dist_slot[lctx]);
  if (slot < 4) return slot + 1;
  const uint32_t nb = slot >> 1;
  const int extra = int(nb) - 1;
  uint32_t dd = (2 | (slot & 1)) << (nb - 1);
  if (extra <= 4) {
    dd |= rc.decodeDirect(extra);
  } else {
    dd |= rc.decodeDirect(extra - 4) << 4;
    dd |= tree_decode<4>(rc, m.align4);
  }
  return dd + 1;
}

inline uint32_t lz_hash4(const uint8_t* p) {
  // hash 5 bytes: on 4-letter DNA-shaped streams a 4-byte hash buries the
  // chains in spurious matches (1/256 collision rate vs 1/1024 here)
  uint64_t v;
  std::memcpy(&v, p, 8);
  v &= 0xFFFFFFFFFFull;
  return uint32_t((v * 0x9E3779B185EBCA87ull) >> (64 - LZ_HASH_BITS));
}

inline int lz_match_len(const uint8_t* a, const uint8_t* b, int64_t cap) {
  int l = 0;
  while (l + 8 <= cap) {
    uint64_t x, y;
    std::memcpy(&x, a + l, 8);
    std::memcpy(&y, b + l, 8);
    const uint64_t d = x ^ y;
    if (d) return l + (__builtin_ctzll(d) >> 3);
    l += 8;
  }
  while (l < cap && a[l] == b[l]) ++l;
  return l;
}

struct LzFinder {
  std::vector<int32_t> head, prev;
  const uint8_t* in;
  int64_t n;

  LzFinder(const uint8_t* i, int64_t len) : in(i), n(len) {
    head.assign(1 << LZ_HASH_BITS, -1);
    prev.assign((size_t)std::max<int64_t>(n, 1), -1);
  }

  void insert(int64_t i) {
    if (i + 8 > n) return;   // hash reads 8 bytes
    const uint32_t h = lz_hash4(in + i);
    if (head[h] == (int32_t)i) return;   // lazy path may re-insert i:
    prev[(size_t)i] = head[h];           // a self-link would loop chains
    head[h] = (int32_t)i;
  }

  // best (len, dist) at i; returns len (0 when no profitable match).
  // Profit filter: a short far match costs more bits than the literals it
  // replaces on low-entropy streams (order-1 DNA literals are ~2 bits).
  int find(int64_t i, uint32_t* dist_out) {
    if (i + 8 > n) return 0;
    const int64_t cap = std::min<int64_t>(n - i, LZ_MAX_MATCH);
    int best = 7;            // short matches lose to ~2-bit DNA literals:
    uint32_t bdist = 0;      // accept len >= 16, or len >= 8 nearby
    int32_t j = head[lz_hash4(in + i)];
    int chain = LZ_MAX_CHAIN;
    while (j >= 0 && chain-- > 0) {
      if (in[j + best] == in[i + best]) {
        const int l = lz_match_len(in + j, in + i, cap);
        if (l > best && (l >= 16 || (l >= 11 && i - j < 1024))) {
          best = l;
          bdist = uint32_t(i - j);
          if (l >= 128) break;
        }
      }
      j = prev[(size_t)j];
    }
    if (best < 8) return 0;
    *dist_out = bdist;
    return best;
  }
};

}  // namespace

extern "C" {

// out must hold n + n/8 + 1024 bytes. Returns the payload size.
int64_t ns_lz_compress(const uint8_t* in, int64_t n, uint8_t* out) {
  std::memcpy(out, &n, 4);
  std::vector<uint8_t> coded;
  coded.reserve((size_t)(n / 2 + 4096));
  {
    RangeEncoder rc(coded);
    LzModel* m = new LzModel();
    LzFinder f(in, n);
    uint32_t rep0 = 1;
    int prev_match = 0;
    uint8_t prev_byte = 0;
    int64_t i = 0;
    uint32_t ndist = 0;
    int nlen = 0;
    int64_t nb_lit = 0;   // accelerating skip: long literal runs mean the
                          // data is match-free here, so probe the finder
                          // less often (every position is still inserted)
    while (i < n) {
      ndist = 0;
      nlen = 0;
      const int64_t skip = 1 + (nb_lit >> 7);
      if (skip <= 1 || (i % skip) == 0) nlen = f.find(i, &ndist);
      // prefer the rep0 distance when it is (nearly) as long
      int rlen = 0;
      if (rep0 <= (uint32_t)i) {
        const int64_t cap = std::min<int64_t>(n - i, LZ_MAX_MATCH);
        rlen = lz_match_len(in + i - rep0, in + i, cap);
      }
      bool use_rep = rlen >= LZ_MIN_MATCH && rlen + 1 >= nlen;
      int len = use_rep ? rlen : nlen;
      if (len >= LZ_MIN_MATCH && !use_rep && i + 1 < n) {
        // one-step lazy: a longer match at i+1 wins
        f.insert(i);
        uint32_t d1 = 0;
        const int l1 = f.find(i + 1, &d1);
        if (l1 > len) {
          rc.encode(m->is_match[prev_match], 0);
          tree_encode<8>(rc, m->lit[prev_byte], in[i]);
          prev_byte = in[i];
          prev_match = 0;
          ++i;
          nb_lit = 0;
          len = l1;
          ndist = d1;
          // fall through to emit the (i+1) match below
        }
        if (len >= LZ_MIN_MATCH) {
          rc.encode(m->is_match[prev_match], 1);
          rc.encode(m->is_rep[prev_match], 0);
          const uint32_t l = uint32_t(len - LZ_MIN_MATCH);
          len_encode(rc, *m, 0, l);
          dist_encode(rc, *m, l < 3 ? l : 3, ndist);
          rep0 = ndist;
          for (int64_t x = i; x < i + len; ++x) f.insert(x);
          i += len;
          nb_lit = 0;
          prev_byte = in[i - 1];
          prev_match = 1;
          continue;
        }
      }
      if (len >= LZ_MIN_MATCH) {
        rc.encode(m->is_match[prev_match], 1);
        if (use_rep) {
          rc.encode(m->is_rep[prev_match], 1);
          len_encode(rc, *m, 1, uint32_t(len - LZ_MIN_MATCH));
        } else {
          rc.encode(m->is_rep[prev_match], 0);
          const uint32_t l = uint32_t(len - LZ_MIN_MATCH);
          len_encode(rc, *m, 0, l);
          dist_encode(rc, *m, l < 3 ? l : 3, ndist);
          rep0 = ndist;
        }
        for (int64_t x = i; x < i + len; ++x) f.insert(x);
        i += len;
        nb_lit = 0;
        prev_byte = in[i - 1];
        prev_match = 1;
      } else {
        rc.encode(m->is_match[prev_match], 0);
        tree_encode<8>(rc, m->lit[prev_byte], in[i]);
        prev_byte = in[i];
        f.insert(i);
        ++i;
        ++nb_lit;
        prev_match = 0;
      }
    }
    rc.flush();
    delete m;
  }
  if ((int64_t)coded.size() >= n) {     // incompressible: store
    out[4] = 0;
    std::memcpy(out + 5, in, (size_t)n);
    return n + 5;
  }
  out[4] = 1;
  std::memcpy(out + 5, coded.data(), coded.size());
  return (int64_t)coded.size() + 5;
}

int64_t ns_lz_decompress(const uint8_t* in, int64_t in_n, uint8_t* out) {
  uint32_t n32;
  std::memcpy(&n32, in, 4);
  const int64_t n = n32;
  if (in[4] == 0) {
    std::memcpy(out, in + 5, (size_t)n);
    return n;
  }
  RangeDecoder rc(in + 5, in_n - 5);
  LzModel* m = new LzModel();
  uint32_t rep0 = 1;
  int prev_match = 0;
  uint8_t prev_byte = 0;
  int64_t i = 0;
  while (i < n) {
    if (!rc.decode(m->is_match[prev_match])) {
      const uint8_t b = (uint8_t)tree_decode<8>(rc, m->lit[prev_byte]);
      out[i++] = b;
      prev_byte = b;
      prev_match = 0;
      continue;
    }
    uint32_t dist, len;
    if (rc.decode(m->is_rep[prev_match])) {
      dist = rep0;
      len = len_decode(rc, *m, 1) + LZ_MIN_MATCH;
    } else {
      const uint32_t l = len_decode(rc, *m, 0);
      len = l + LZ_MIN_MATCH;
      dist = dist_decode(rc, *m, l < 3 ? l : 3);
      rep0 = dist;
    }
    const uint8_t* src = out + (i - (int64_t)dist);
    for (uint32_t x = 0; x < len; ++x) out[i + x] = src[x];
    i += len;
    prev_byte = out[i - 1];
    prev_match = 1;
  }
  delete m;
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// nso1: order-1 adaptive binary-tree range coder, no transform.
//
// Owner of the `exc` stream (non-ACGT exception triples). The stream is
// three concatenated sections — read-id delta varints, position varints,
// raw exception bytes — whose positions are near-uniform within a read:
// entropy ~ log2(read_len) bits per exception. A BWT scrambles the
// 2-byte varint structure (nsbwt coded the pos section at ~13.9
// bits/exc), while a plain order-1 model captures the full joint
// H(b0) + H(b1 | b0) of the varint bytes and adapts per section.
// Reference role: the exc stream is strictly additional losslessness over
// the reference (it maps non-ACGT via the 2-bit trick and loses them,
// src/dnaToBits.cpp:6-9); closing docs/CODECS.md's one remaining
// lzma-parity asterisk (round-4 verdict ask #7).
// ---------------------------------------------------------------------------

namespace o1 {

struct Model {
  // [context = top 3 bits of previous byte][tree node]. The coarse
  // context is deliberate (the same choice as LZMA's lc=3): the exc
  // corpus is ~100 KB per chunk, so a full 256-way context leaves ~1
  // sample per tree node and the model never adapts — 8 contexts beat
  // 256 by ~1.3% measured (docs/CODECS.md).
  uint16_t t[8][256];
  Model() {
    for (auto& c : t)
      for (auto& p : c) p = 2048;
  }
};

}  // namespace o1

extern "C" {

int64_t ns_o1_compress(const uint8_t* in, int64_t n, uint8_t* out) {
  uint32_t nn = uint32_t(n);
  std::memcpy(out, &nn, 4);
  if (n == 0) return 4;
  std::vector<uint8_t> payload;
  payload.reserve(size_t(n / 2 + 64));
  {
    RangeEncoder rc(payload);
    o1::Model* m = new o1::Model();
    uint8_t prev = 0;
    for (int64_t i = 0; i < n; ++i) {
      const uint8_t b = in[i];
      uint32_t idx = 1;
      for (int k = 7; k >= 0; --k) {
        const int bit = (b >> k) & 1;
        rc.encode4(m->t[prev >> 5][idx], bit);
        idx = idx * 2 + uint32_t(bit);
      }
      prev = b;
    }
    delete m;
    rc.flush();
  }
  if (4 + 1 + int64_t(payload.size()) >= n + 5) {  // incompressible: raw
    out[4] = 0;
    std::memcpy(out + 5, in, size_t(n));
    return 5 + n;
  }
  out[4] = 1;
  std::memcpy(out + 5, payload.data(), payload.size());
  return 5 + int64_t(payload.size());
}

int64_t ns_o1_decompress(const uint8_t* in, int64_t in_n, uint8_t* out) {
  uint32_t nn;
  std::memcpy(&nn, in, 4);
  const int64_t n = nn;
  if (n == 0) return 0;
  if (in[4] == 0) {
    std::memcpy(out, in + 5, size_t(n));
    return n;
  }
  RangeDecoder rc(in + 5, in_n - 5);
  o1::Model* m = new o1::Model();
  uint8_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t idx = 1;
    for (int k = 0; k < 8; ++k) idx = idx * 2 + uint32_t(rc.decode4(m->t[prev >> 5][idx]));
    const uint8_t b = uint8_t(idx & 0xFF);
    out[i] = b;
    prev = b;
  }
  delete m;
  return n;
}

}  // extern "C"
