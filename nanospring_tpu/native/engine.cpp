// Native wavefront contig engine: the whole grow loop in C++.
//
// Same algorithm as pipeline/contigs.py::_Wavefront (which remains the
// readable oracle): seed well-separated contigs
// per overlap component, drain a frontier of (contig, candidate, parent)
// items in batches, anchor each candidate on its BFS parent's anchor
// table, verify with one banded-DP batch (OpenMP), splice overhangs into
// the consensus, re-enqueue neighbors. The reference's equivalent hot
// loop is Consensus::generateAndWriteConsensus + addRelatedReads
// (src/Consensus.cpp:21-340) with per-thread pointer-DAG contigs.
//
// Differences from the Python engine: placement happens after the
// previous batch is applied (fresh extents; the Python engine pipelines
// placement against a one-batch-stale snapshot because its placement is
// the bottleneck — here placement is cheap and the DP batch is the only
// parallel section). The stale-clip retry rules are kept identical.
//
// C ABI, handle pattern. Calls sibling TUs' C functions directly.

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#include "polish_core.h"

namespace {
inline double now_s() {
    return std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}
}  // namespace

extern "C" {
int64_t ns_minimizers(const uint8_t*, int64_t, int32_t, int32_t,
                      uint64_t*, int64_t*, uint8_t*);
int64_t ns_anchor_prepare(uint64_t*, int64_t*, uint8_t*, int64_t);
int32_t ns_anchor_vote_chain(
    const int64_t*, const int64_t*, const uint8_t*, int64_t,
    int64_t, int32_t, int32_t, int32_t*, int64_t*, int64_t*,
    int64_t*, int64_t*, int64_t, int64_t*);
int32_t ns_stitch_align(const uint8_t*, int64_t, const uint8_t*, int64_t,
                        const int64_t*, const int64_t*, int64_t,
                        int64_t, int32_t, int32_t, int32_t,
                        uint8_t*, int64_t, int64_t*, int64_t*, int64_t*);
int32_t ns_wfa_align(const uint8_t*, int64_t, const uint8_t*, int64_t,
                     int64_t, int32_t, int32_t,
                     uint8_t*, int64_t, int64_t*, int64_t*, int64_t*);
int64_t ns_accept_anchors(const uint8_t*, int64_t, int64_t, int64_t, int32_t,
                          int32_t, const uint64_t*, const int64_t*,
                          const uint8_t*, int64_t,
                          uint64_t*, int64_t*, uint8_t*);
int32_t ns_banded_align(const uint8_t*, int64_t, const uint8_t*, int64_t,
                        int64_t, int32_t, int32_t,
                        uint8_t*, int64_t, int64_t*, int64_t*, int64_t*);
}

namespace {

// Device DP hook: the lax DP (ops/align_device.py) plugs in as the batch
// aligner. Python registers flat numpy buffers + a callback; dp_run fills
// the buffers (diagonal-shifted targets, oriented queries), the callback
// runs the DP on the device, and the byte trace comes back for expansion.
// A callback that returns nonzero aborts the run (no host fallback).
struct DeviceHook {
    int32_t (*fn)(int64_t n_pairs) = nullptr;
    uint8_t* tpad = nullptr;
    uint8_t* qbuf = nullptr;
    int32_t* d0 = nullptr;
    int32_t* qlen = nullptr;
    int32_t* tlen = nullptr;
    int32_t* maxc = nullptr;
    int32_t* cost = nullptr;
    int32_t* ts = nullptr;
    int32_t* te = nullptr;
    uint8_t* trace = nullptr;
    int64_t p_cap = 0, m_cap = 0;
};
DeviceHook g_dev;
constexpr int32_t DEV_W = 63;        // device DP band semantics
constexpr int64_t DEV_KOFF = 64;

// Precomputed per-read minimizer tables (ns_minimizers_all): when set,
// Engine::build_minimizers is a memcpy of the read's slice instead of a
// fresh extraction+sort. Precomputed on host threads overlapped with the
// sketch (pipeline/contigs.py::_build_candidate_graph).
struct PreMz {
    const int64_t* off = nullptr;   // N+1 exclusive cumsum
    const uint64_t* h = nullptr;
    const int64_t* p = nullptr;
    const uint8_t* f = nullptr;
};
PreMz g_premz;

}  // namespace

extern "C" void ns_engine_set_premz(
    const int64_t* off, const uint64_t* h, const int64_t* p,
    const uint8_t* f)
{
    g_premz.off = off;
    g_premz.h = h;
    g_premz.p = p;
    g_premz.f = f;
}

extern "C" void ns_engine_set_device(
    void* fn, uint8_t* tpad, uint8_t* qbuf,
    int32_t* d0, int32_t* qlen, int32_t* tlen, int32_t* maxc,
    int32_t* cost, int32_t* ts, int32_t* te, uint8_t* trace,
    int64_t p_cap, int64_t m_cap)
{
    g_dev.fn = (int32_t (*)(int64_t))fn;
    g_dev.tpad = tpad;
    g_dev.qbuf = qbuf;
    g_dev.d0 = d0;
    g_dev.qlen = qlen;
    g_dev.tlen = tlen;
    g_dev.maxc = maxc;
    g_dev.cost = cost;
    g_dev.ts = ts;
    g_dev.te = te;
    g_dev.trace = trace;
    g_dev.p_cap = p_cap;
    g_dev.m_cap = m_cap;
}

namespace {

enum Param {
    P_SEED_K = 0, P_SEED_W, P_MAX_CHAIN, P_BAND, P_MAXCOST_KB,
    P_MIN_OVERLAP, P_ALIGN_BATCH, P_FRONTIER, P_EDGE_THR, P_MIN_LEN,
    P_MAX_ATTEMPTS, P_BAND_MIN, P_POLISH, P_COUNT
};

struct Anchors {
    std::vector<uint64_t> h;
    std::vector<int64_t> p;
    std::vector<uint8_t> f;
};

struct Member {
    int64_t rid;
    uint8_t strand;
    int64_t tstart;               // absolute consensus coords
    std::vector<uint8_t> ops;     // RLE tokens (see ops_rle_encode)
    int64_t raw_len = 0;          // decoded op count
};

// Member edit scripts dominate engine-resident memory on Gbase-class
// inputs (~1.05 B per aligned base raw). Ops are 4-symbol with long '='
// runs, so one byte per token — op(2 bits) | run-1(6 bits), runs up to
// 64 — stores them at ~0.15-0.2 B/base. Encode on accept, decode for
// polish and the emit fetch.
inline uint8_t ops_code(uint8_t c) {
    switch (c) {
        case 's': return 1;
        case 'i': return 2;
        case 'd': return 3;
        default: return 0;      // '='
    }
}
constexpr uint8_t OPS_CHAR[4] = {'=', 's', 'i', 'd'};

inline void ops_rle_encode(const uint8_t* raw, int64_t n,
                           std::vector<uint8_t>& out) {
    out.clear();
    out.reserve((size_t)(n / 16 + 8));
    int64_t i = 0;
    while (i < n) {
        const uint8_t c = raw[i];
        int64_t run = 1;
        while (i + run < n && run < 64 && raw[i + run] == c) ++run;
        out.push_back((uint8_t)((ops_code(c) << 6) | (run - 1)));
        i += run;
    }
}

inline void ops_rle_decode(const uint8_t* rle, int64_t ntok, uint8_t* out) {
    int64_t o = 0;
    for (int64_t t = 0; t < ntok; ++t) {
        const uint8_t c = OPS_CHAR[rle[t] >> 6];
        const int64_t run = (rle[t] & 63) + 1;
        std::memset(out + o, c, (size_t)run);
        o += run;
    }
}

// Flat open-addressing map for the contig anchor table (minimizer hash ->
// pos*2+strand). This is probed ~90x per placement and extended ~90x per
// accept — a node-based unordered_map paid a cache miss + allocation per
// op on exactly the per-batch critical path. Keys are already well-mixed
// minimizer hashes; one multiplicative scramble places them. Stored
// values are pos*2+strand where pos is an ABSOLUTE consensus coordinate
// — negative after prepends — so the empty sentinel is INT64_MIN, not -1.
struct AnchorMap {
    static constexpr int64_t ABSENT = INT64_MIN;
    std::vector<uint64_t> keys;
    std::vector<int64_t> vals;
    int64_t count = 0;
    int64_t mask = -1;            // capacity-1; -1 = unallocated

    static inline uint64_t mix(uint64_t k) {
        return (k * 0x9E3779B97F4A7C15ULL) >> 13;
    }
    void reserve(int64_t n) {
        int64_t cap = 16;
        while (cap < 2 * n) cap <<= 1;
        if (cap - 1 == mask) return;
        rehash(cap);
    }
    void rehash(int64_t cap) {
        std::vector<uint64_t> ok;
        std::vector<int64_t> ov;
        ok.swap(keys);
        ov.swap(vals);
        keys.assign((size_t)cap, 0);
        vals.assign((size_t)cap, ABSENT);
        const int64_t omask = mask;
        mask = cap - 1;
        for (int64_t i = 0; i <= omask; ++i)
            if (ov[(size_t)i] != ABSENT) {
                int64_t x = (int64_t)(mix(ok[(size_t)i]) & (uint64_t)mask);
                while (vals[(size_t)x] != ABSENT) x = (x + 1) & mask;
                keys[(size_t)x] = ok[(size_t)i];
                vals[(size_t)x] = ov[(size_t)i];
            }
    }
    // keep-first semantics (matches the unordered_map::emplace it replaces)
    inline void emplace_first(uint64_t k, int64_t v) {
        if (count * 2 >= mask + 1) rehash(mask < 0 ? 16 : 2 * (mask + 1));
        int64_t x = (int64_t)(mix(k) & (uint64_t)mask);
        while (vals[(size_t)x] != ABSENT) {
            if (keys[(size_t)x] == k) return;
            x = (x + 1) & mask;
        }
        keys[(size_t)x] = k;
        vals[(size_t)x] = v;
        ++count;
    }
    inline void prefetch(uint64_t k) const {
        if (mask >= 0)
            __builtin_prefetch(&vals[(size_t)(mix(k) & (uint64_t)mask)]);
    }
    inline int64_t find(uint64_t k) const {    // ABSENT when missing
        if (mask < 0) return ABSENT;
        int64_t x = (int64_t)(mix(k) & (uint64_t)mask);
        while (vals[(size_t)x] != ABSENT) {
            if (keys[(size_t)x] == k) return vals[(size_t)x];
            x = (x + 1) & mask;
        }
        return ABSENT;
    }
    void clear_release() {
        std::vector<uint64_t>().swap(keys);
        std::vector<int64_t>().swap(vals);
        count = 0;
        mask = -1;
    }
};

struct Contig {
    int64_t cid = 0;
    std::vector<uint8_t> buf;     // consensus with slack
    int64_t start = 0, len = 0;   // cons = buf[start : start+len]
    int64_t lo = 0;               // consensus coord of cons[0]
    std::vector<Member> members;
    int64_t total_aligned = 0;
    int64_t pending = 0;
    bool closed = false;
    // contig-wide anchor map: minimizer hash -> (consensus pos * 2 + strand),
    // the union over all accepted members (first occurrence wins). Replaces
    // per-member tables so candidate pins span the whole consensus overlap,
    // not just the BFS parent's extent.
    AnchorMap amap;
    std::unordered_set<int64_t> visited;

    int64_t hi() const { return lo + len; }
    const uint8_t* cons() const { return buf.data() + start; }
    void prepend(const uint8_t* codes, int64_t n) {
        if (n > start) {
            const int64_t grow = std::max(n, len) + 512;
            std::vector<uint8_t> nb((size_t)(grow + start + (int64_t)buf.size()));
            std::memcpy(nb.data() + grow + start, cons(), (size_t)len);
            buf.swap(nb);
            start += grow;
        }
        start -= n;
        len += n;
        std::memcpy(buf.data() + start, codes, (size_t)n);
    }
    void append(const uint8_t* codes, int64_t n) {
        if (start + len + n > (int64_t)buf.size()) {
            const int64_t grow = std::max(n, len) + 512;
            std::vector<uint8_t> nb(buf.size() + (size_t)grow);
            std::memcpy(nb.data() + start, cons(), (size_t)len);
            buf.swap(nb);
        }
        std::memcpy(buf.data() + start + len, codes, (size_t)n);
        len += n;
    }
};

struct Item {
    int64_t cid, rid, parent;
    int32_t attempts = 0;
    int32_t full_band = 0;   // escalated after a min-band rejection
};

struct Placed {
    Item item;
    int64_t band;
    int32_t is_rc;
    std::vector<uint8_t> codes;   // oriented full query
    std::vector<uint8_t> tgt;     // consensus window snapshot (the DP for
                                  // batch k runs while batch k-1's applies
                                  // mutate the live consensus buffers)
    std::vector<int64_t> aq, at;  // anchor pins, (clipped query, window)
                                  // coords, sorted by aq — feed the
                                  // stitched aligner
    int64_t qlo, qhi, wlo, whi, snap_lo, snap_hi, d0_win;
    // DP outputs
    std::vector<uint8_t> ops;
    int64_t ops_len = 0, tstart = 0, tend = 0;
    int32_t cost = -1;
};

struct Engine {
    // inputs
    const uint8_t* packed;
    const int64_t* offsets;
    const int64_t* lengths;
    const int64_t* adj_off;
    const int64_t* adj;
    const int64_t* comp_of;
    uint8_t* claimed;
    std::vector<uint8_t> touched;
    int64_t N;
    int64_t prm[P_COUNT];

    // component seeding state (registration order preserved)
    std::vector<int64_t> comp_ids;
    std::vector<const int64_t*> comp_members;
    std::vector<int64_t> comp_size, comp_cursor;
    std::vector<int8_t> comp_phase;     // 0 fresh, 1 residual, 2 exhausted
    std::unordered_map<int64_t, int64_t> comp_slot;     // comp id -> index
    std::unordered_map<int64_t, int64_t> comp_active;   // comp id -> live contigs

    // runtime
    std::unordered_map<int64_t, Contig> states;
    std::vector<Item> queue;            // LIFO (pop from back)
    std::vector<Contig> done;
    std::unordered_map<int64_t, Anchors> mz_cache;
    int64_t mz_bytes = 0;               // cache budget accounting: entries
                                        // for reads that never get accepted
                                        // (place-fail, re-queues) would pin
                                        // ~0.5 B/base forever at scale
    static constexpr int64_t MZ_CACHE_CAP = 2LL << 30;   // 2 GB
    int64_t next_cid = 0;
    int64_t stat_not_claimed = 0, stat_aligned_ok = 0;
    double t_place = 0, t_dp = 0, t_apply = 0, t_mz = 0;
    double t_dp_stitch = 0, t_dp_full = 0, t_dp_resize = 0;
    double t_dp_device = 0;             // device DP time inside dp_run
    int64_t n_device_batches = 0;       // batches the device DP carried
    int64_t n_host_batches = 0;         // device mode, no eligible pair:
                                        // the batch ran on the host DP
    std::atomic<bool> dev_failed{false};  // device callback failed: stop
    double t_polish = 0;
    double t_placefn = 0;
    int64_t n_dp = 0, dp_bases = 0;
    int64_t n_stitch_bases = 0, n_full_dp_bases = 0;
    int64_t n_retry = 0, n_reject = 0, n_claimed_skip = 0, n_place_fail = 0;
    // device-routing accounting: pairs/bases the device batch could not
    // take because the query exceeds its row capacity (m_cap) or the batch
    // its pair capacity (p_cap); they run on the host DP
    int64_t n_host_long_pairs = 0, n_host_long_bases = 0;
    // full-band DP outcome accounting by escalation class (NS_ENGINE_DEBUG):
    // [class]: 0 chain<2, 1 stitch structural fail, 2 escalated retry;
    // acc/rej per class + wall per class
    int64_t fb_acc[3] = {0, 0, 0}, fb_rej[3] = {0, 0, 0};
    double fb_s[3] = {0, 0, 0};

    // per-thread scratch (collect's place() fans out over OpenMP)
    static thread_local std::vector<uint8_t> scratch;   // forward unpack
    static thread_local std::vector<int64_t> pin_q, pin_t;  // anchor chain
    static thread_local std::vector<int64_t> m_pa, m_pb;    // match list
    static thread_local std::vector<uint8_t> m_rc;

    const uint8_t* unpack_fwd(int64_t rid) {
        const int64_t len = lengths[rid];
        if ((int64_t)scratch.size() < len) scratch.resize((size_t)len + 64);
        const uint8_t* src = packed + offsets[rid];
        for (int64_t i = 0; i < len; ++i)
            scratch[(size_t)i] = (src[i / 4] >> (2 * (i % 4))) & 3;
        return scratch.data();
    }

    void unpack_oriented(int64_t rid, int32_t is_rc, std::vector<uint8_t>& out) {
        // table-driven: one packed byte -> 4 codes in a single u32 store
        // (the per-base shift/mask loop was ~1/3 of place() wall)
        static const std::array<std::array<uint32_t, 256>, 2> LUT = [] {
            std::array<std::array<uint32_t, 256>, 2> t{};
            for (int b = 0; b < 256; ++b)
                for (int j = 0; j < 4; ++j) {
                    const uint32_t c = (uint32_t)((b >> (2 * j)) & 3);
                    t[0][b] |= c << (8 * j);                    // forward
                    t[1][b] |= (3u - c) << (8 * (3 - j));       // rc order
                }
            return t;
        }();
        const int64_t len = lengths[rid];
        out.resize((size_t)len + 4);       // slack for the 4-wide stores
        const uint8_t* src = packed + offsets[rid];
        const int64_t nb = (len + 3) / 4;
        if (!is_rc) {
            uint8_t* dst = out.data();
            for (int64_t b = 0; b < nb; ++b) {
                const uint32_t v = LUT[0][src[b]];
                std::memcpy(dst + 4 * b, &v, 4);
            }
        } else {
            // byte b's 4 bases land reversed+complemented at the tail end;
            // the final read starts at out[pad] where pad = 4*nb - len
            uint8_t* dst = out.data();
            for (int64_t b = 0; b < nb; ++b) {
                const uint32_t v = LUT[1][src[b]];
                std::memcpy(dst + 4 * (nb - 1 - b), &v, 4);
            }
            const int64_t pad = 4 * nb - len;
            if (pad) std::memmove(dst, dst + pad, (size_t)len);
        }
        out.resize((size_t)len);
    }

    Anchors build_minimizers(int64_t rid) {
        Anchors a;
        if (g_premz.off) {
            const int64_t b = g_premz.off[rid], e = g_premz.off[rid + 1];
            const int64_t n = e - b;
            a.h.resize((size_t)n);
            a.p.resize((size_t)n);
            a.f.resize((size_t)n);
            std::memcpy(a.h.data(), g_premz.h + b, (size_t)n * 8);
            std::memcpy(a.p.data(), g_premz.p + b, (size_t)n * 8);
            std::memcpy(a.f.data(), g_premz.f + b, (size_t)n);
            return a;
        }
        const int64_t len = lengths[rid];
        const int64_t cap = std::max<int64_t>(1, len - prm[P_SEED_K] + 1);
        a.h.resize((size_t)cap);
        a.p.resize((size_t)cap);
        a.f.resize((size_t)cap);
        const uint8_t* codes = unpack_fwd(rid);
        int64_t n = ns_minimizers(codes, len, (int32_t)prm[P_SEED_K],
                                  (int32_t)prm[P_SEED_W],
                                  a.h.data(), a.p.data(), a.f.data());
        n = ns_anchor_prepare(a.h.data(), a.p.data(), a.f.data(), n);
        a.h.resize((size_t)n);
        a.p.resize((size_t)n);
        a.f.resize((size_t)n);
        return a;
    }

    static int64_t anchors_bytes(const Anchors& a) {
        return (int64_t)a.h.size() * (8 + 8 + 1);
    }

    const Anchors& forward_minimizers(int64_t rid) {
        if (g_premz.off) {
            // precomputed tables ARE the cache: copy the slice into a
            // thread-local scratch instead of duplicating up to 2 GB of
            // anchors into mz_cache (callers finish with the reference
            // before their next call on the same thread)
            static thread_local Anchors tmp;
            const int64_t b = g_premz.off[rid], e = g_premz.off[rid + 1];
            const int64_t n = e - b;
            tmp.h.resize((size_t)n);
            tmp.p.resize((size_t)n);
            tmp.f.resize((size_t)n);
            std::memcpy(tmp.h.data(), g_premz.h + b, (size_t)n * 8);
            std::memcpy(tmp.p.data(), g_premz.p + b, (size_t)n * 8);
            std::memcpy(tmp.f.data(), g_premz.f + b, (size_t)n);
            return tmp;
        }
        auto it = mz_cache.find(rid);
        if (it != mz_cache.end()) return it->second;
        Anchors a = build_minimizers(rid);
        mz_bytes += anchors_bytes(a);
        return mz_cache.emplace(rid, std::move(a)).first->second;
    }

    void enqueue_children(Contig& st, int64_t rid) {
        for (int64_t e = adj_off[rid]; e < adj_off[rid + 1]; ++e) {
            const int64_t r2 = adj[e];
            if (!claimed[r2] && !st.visited.count(r2)) {
                st.visited.insert(r2);
                touched[(size_t)r2] = 1;
                queue.push_back(Item{st.cid, r2, rid});
                st.pending += 1;
            }
        }
    }

    bool activate_seed(int64_t seed) {
        claimed[seed] = 1;
        touched[(size_t)seed] = 1;
        const int64_t cid = next_cid++;
        Contig st;
        st.cid = cid;
        const int64_t len = lengths[seed];
        st.buf.resize((size_t)(2 * len + 512));
        st.start = len / 2 + 128;
        st.len = len;
        const uint8_t* src = packed + offsets[seed];
        for (int64_t i = 0; i < len; ++i)
            st.buf[(size_t)(st.start + i)] = (src[i / 4] >> (2 * (i % 4))) & 3;
        Member m;
        m.rid = seed;
        m.strand = 0;
        m.tstart = 0;
        m.raw_len = len;
        m.ops.assign((size_t)((len + 63) / 64), (uint8_t)63);
        if (len % 64)
            m.ops.back() = (uint8_t)(len % 64 - 1);
        st.members.push_back(std::move(m));
        st.total_aligned = len;
        {   // seed the contig anchor map (tpos == read pos at creation)
            const Anchors& fw = forward_minimizers(seed);
            st.amap.reserve((int64_t)fw.h.size());
            for (size_t x = 0; x < fw.h.size(); ++x)
                st.amap.emplace_first(fw.h[x],
                                      fw.p[x] * 2 + (int64_t)fw.f[x]);
        }
        st.visited.insert(seed);
        comp_active[comp_of[seed]] += 1;
        auto res = states.emplace(cid, std::move(st));
        enqueue_children(res.first->second, seed);
        if (res.first->second.pending == 0) {
            finalize(res.first->second, /*reseed=*/false);
            return false;
        }
        return true;
    }

    bool activate_next_in_comp(int64_t comp, bool fresh_only) {
        while (true) {
            auto sl = comp_slot.find(comp);
            if (sl == comp_slot.end()) return false;
            const int64_t s = sl->second;
            if (comp_phase[(size_t)s] == 2) return false;
            const bool fresh = comp_phase[(size_t)s] == 0;
            if (!fresh && (fresh_only || comp_active[comp] > 0)) return false;
            int64_t cur = comp_cursor[(size_t)s];
            int64_t seed = -1;
            while (cur < comp_size[(size_t)s]) {
                const int64_t cand = comp_members[(size_t)s][cur];
                ++cur;
                if (claimed[cand] || lengths[cand] < prm[P_MIN_LEN]) continue;
                if (fresh && touched[(size_t)cand]) continue;
                seed = cand;
                break;
            }
            comp_cursor[(size_t)s] = cur;
            if (seed < 0) {
                if (fresh) {
                    comp_phase[(size_t)s] = 1;
                    comp_cursor[(size_t)s] = 0;
                    continue;
                }
                comp_phase[(size_t)s] = 2;  // exhausted ("deleted")
                return false;
            }
            if (activate_seed(seed)) return true;
        }
    }

    void finalize(Contig& st, bool reseed = true) {
        auto it = states.find(st.cid);
        if (it == states.end()) return;
        const int64_t comp = comp_of[st.members[0].rid];
        if (st.members.size() > 1) {
            it->second.amap.clear_release();  // anchors die with growth
            done.push_back(std::move(it->second));
        } else {
            claimed[st.members[0].rid] = 0;  // lone after all
        }
        states.erase(it);
        comp_active[comp] -= 1;
        if (reseed) activate_next_in_comp(comp, false);
    }

    // place() sub-phase profile (NS_ENGINE_DEBUG): [0] mz fetch,
    // [1] amap probe, [2] vote+chain, [3] unpack, [4] window copies
    static std::atomic<int64_t> pl_ns[5];
    static bool pl_dbg;

    bool place(const Item& it, Placed& out) {
        auto sit = states.find(it.cid);
        if (sit == states.end() || sit->second.closed) return false;
        Contig& st = sit->second;
        const double tp0 = pl_dbg ? now_s() : 0;
        const Anchors& rb = forward_minimizers(it.rid);
        if (pl_dbg) pl_ns[0] += (int64_t)((now_s() - tp0) * 1e9);
        if (rb.h.empty()) return false;
        // probe the contig-wide anchor map with the candidate's minimizers
        const double tp1 = pl_dbg ? now_s() : 0;
        m_pa.clear(); m_pb.clear(); m_rc.clear();
        const size_t R = rb.h.size();
        for (size_t x = 0; x < R; ++x) {
            if (x + 8 < R) st.amap.prefetch(rb.h[x + 8]);
            const int64_t hv = st.amap.find(rb.h[x]);
            if (hv == AnchorMap::ABSENT) continue;
            m_pa.push_back(hv >> 1);
            m_pb.push_back(rb.p[x]);
            m_rc.push_back((uint8_t)((hv & 1) != (int64_t)rb.f[x]));
        }
        if (pl_dbg) pl_ns[1] += (int64_t)((now_s() - tp1) * 1e9);
        if (m_pa.empty()) return false;
        int32_t is_rc;
        int64_t d0_abs, votes, n_pins = 0;
        const int64_t len_fwd = lengths[it.rid];
        const int64_t cap = (int64_t)m_pa.size();
        pin_q.resize((size_t)cap);
        pin_t.resize((size_t)cap);
        const double tp2 = pl_dbg ? now_s() : 0;
        const bool chain_ok = ns_anchor_vote_chain(
            m_pa.data(), m_pb.data(), m_rc.data(), cap,
            len_fwd, (int32_t)prm[P_SEED_K],
            (int32_t)prm[P_MAX_CHAIN],
            &is_rc, &d0_abs, &votes,
            pin_q.data(), pin_t.data(), cap, &n_pins) != 0;
        if (pl_dbg) pl_ns[2] += (int64_t)((now_s() - tp2) * 1e9);
        if (!chain_ok) return false;
        const int64_t mlen = len_fwd;
        // adaptive band: the anchor median pins the diagonal well, so a
        // narrow band suffices (and yields tighter scripts: better ratio);
        // a rejected pair escalates to the full band once.
        const int64_t band = it.full_band ? prm[P_BAND] : prm[P_BAND_MIN];
        const int64_t qlo = std::max<int64_t>(0, (st.lo - d0_abs) - band / 2);
        const int64_t qhi = std::min(mlen, (st.hi() - d0_abs) + band / 2);
        if (qhi - qlo < prm[P_MIN_OVERLAP]) return false;
        out.item = it;
        out.band = band;
        out.is_rc = is_rc;
        const double tp3 = pl_dbg ? now_s() : 0;
        unpack_oriented(it.rid, is_rc, out.codes);
        if (pl_dbg) pl_ns[3] += (int64_t)((now_s() - tp3) * 1e9);
        out.qlo = qlo;
        out.qhi = qhi;
        out.wlo = std::max(st.lo, d0_abs + qlo - band);
        out.whi = std::min(st.hi(), d0_abs + qhi + band);
        out.snap_lo = st.lo;
        out.snap_hi = st.hi();
        out.d0_win = (d0_abs + qlo) - out.wlo;
        const double tp4 = pl_dbg ? now_s() : 0;
        out.tgt.assign(st.cons() + (out.wlo - st.lo),
                       st.cons() + (out.whi - st.lo));
        if (pl_dbg) pl_ns[4] += (int64_t)((now_s() - tp4) * 1e9);
        // pins translated to (clipped query, window) coords for stitching
        out.aq.clear();
        out.at.clear();
        const int64_t mwin = out.qhi - out.qlo;
        const int64_t nwin = out.whi - out.wlo;
        for (int64_t x = 0; x < n_pins; ++x) {
            const int64_t qw = pin_q[(size_t)x] - qlo;
            const int64_t tw = pin_t[(size_t)x] - out.wlo;
            if (qw < 0 || qw >= mwin || tw < 0 || tw >= nwin) continue;
            out.aq.push_back(qw);
            out.at.push_back(tw);
        }
        return true;
    }

    // accept() sub-profile: [0] splice, [1] accept_anchors, [2] amap merge
    static std::atomic<int64_t> ac_ns[3];

    void accept(Contig& st, Placed& p, std::vector<uint8_t>& ops,
                int64_t tstart_abs, int64_t tend_abs) {
        const double ts0 = pl_dbg ? now_s() : 0;
        const int64_t mlen = (int64_t)p.codes.size();
        int64_t head = 0;
        while (head < (int64_t)ops.size() && ops[(size_t)head] == 'i') ++head;
        int64_t tail = 0;
        while (tail < (int64_t)ops.size() &&
               ops[ops.size() - 1 - (size_t)tail] == 'i')
            ++tail;
        if (head && tstart_abs == st.lo) {
            st.prepend(p.codes.data(), head);
            st.lo -= head;
            std::fill(ops.begin(), ops.begin() + head, '=');
            tstart_abs -= head;
        }
        if (tail && tend_abs == st.hi() && head + tail <= (int64_t)ops.size()) {
            st.append(p.codes.data() + mlen - tail, tail);
            std::fill(ops.end() - tail, ops.end(), '=');
        }
        if (pl_dbg) ac_ns[0] += (int64_t)((now_s() - ts0) * 1e9);
        Member m;
        m.rid = p.item.rid;
        m.strand = (uint8_t)p.is_rc;
        m.tstart = tstart_abs;
        m.raw_len = (int64_t)ops.size();
        const double tr0 = pl_dbg ? now_s() : 0;
        ops_rle_encode(ops.data(), (int64_t)ops.size(), m.ops);
        if (pl_dbg) ap_ns[2] += (int64_t)((now_s() - tr0) * 1e9);
        st.members.push_back(std::move(m));
        st.total_aligned += mlen;
        // map the member's minimizers through its alignment and merge
        // them into the contig anchor map (first occurrence wins);
        // forward_minimizers re-creates the cache entry if a reordering
        // ever evicted it (place() normally populates it first)
        const double tc0 = pl_dbg ? now_s() : 0;
        const Anchors& fw = forward_minimizers(p.item.rid);
        Anchors out;
        out.h.resize(fw.h.size());
        out.p.resize(fw.p.size());
        out.f.resize(fw.f.size());
        const int64_t n = ns_accept_anchors(
            ops.data(), (int64_t)ops.size(), tstart_abs, mlen, p.is_rc,
            (int32_t)prm[P_SEED_K],
            fw.h.data(), fw.p.data(), fw.f.data(), (int64_t)fw.h.size(),
            out.h.data(), out.p.data(), out.f.data());
        const double tc1 = pl_dbg ? now_s() : 0;
        for (int64_t x = 0; x < n; ++x)
            st.amap.emplace_first(
                out.h[(size_t)x],
                out.p[(size_t)x] * 2 + (int64_t)out.f[(size_t)x]);
        if (pl_dbg) {
            ac_ns[1] += (int64_t)((tc1 - tc0) * 1e9);
            ac_ns[2] += (int64_t)((now_s() - tc1) * 1e9);
        }
    }

    // apply() sub-phase profile (NS_ENGINE_DEBUG): [0] ops assembly,
    // [1] accept: splice+anchor merge, [2] RLE encode, [3] enqueue
    static std::atomic<int64_t> ap_ns[4];

    void apply(Placed& p) {
        auto sit = states.find(p.item.cid);
        if (sit == states.end() || sit->second.closed ||
            claimed[p.item.rid]) {
            n_claimed_skip += 1;
            return;
        }
        Contig& st = sit->second;
        if (p.cost < 0) {
            n_reject += 1;
            // escalate to a full-band re-place only for band/budget
            // rejects (-1): a -2 means the stitch wavefront hit its
            // divergence-slope abort (wrong-locus evidence), where the
            // full-band DP re-rejected 73% of the time in round 4 while
            // costing band*len cells per pair
            if (p.cost == -1 &&
                !p.item.full_band && prm[P_BAND_MIN] < prm[P_BAND]) {
                Item esc = p.item;
                esc.full_band = 1;
                queue.push_back(esc);
                st.pending += 1;
            }
            return;
        }
        const int64_t mlen = (int64_t)p.codes.size();
        const double ta0 = pl_dbg ? now_s() : 0;
        std::vector<uint8_t> ops;
        ops.reserve((size_t)(p.qlo + p.ops_len + (mlen - p.qhi)));
        ops.insert(ops.end(), (size_t)p.qlo, 'i');
        ops.insert(ops.end(), p.ops.begin(), p.ops.begin() + p.ops_len);
        ops.insert(ops.end(), (size_t)(mlen - p.qhi), 'i');
        if (pl_dbg) ap_ns[0] += (int64_t)((now_s() - ta0) * 1e9);
        const int64_t tstart_abs = p.wlo + p.tstart;
        const int64_t tend_abs = p.wlo + p.tend;
        int64_t head_run = 0;
        while (head_run < (int64_t)ops.size() && ops[(size_t)head_run] == 'i')
            ++head_run;
        int64_t tail_run = 0;
        if (head_run < (int64_t)ops.size())
            while (ops[ops.size() - 1 - (size_t)tail_run] == 'i') ++tail_run;
        bool head_lost = head_run > 0 && tstart_abs == p.snap_lo &&
                         st.lo != p.snap_lo;
        bool tail_lost = tail_run > 0 && tend_abs == p.snap_hi &&
                         st.hi() != p.snap_hi;
        head_lost |= head_run > 0 && p.qlo > 0 && st.lo < p.snap_lo;
        tail_lost |= tail_run > 0 && p.qhi < mlen && st.hi() > p.snap_hi;
        if ((head_lost || tail_lost) && p.item.attempts < prm[P_MAX_ATTEMPTS]) {
            Item retry = p.item;
            retry.attempts += 1;
            queue.push_back(retry);
            st.pending += 1;
            n_retry += 1;
            return;
        }
        stat_aligned_ok += 1;
        claimed[p.item.rid] = 1;
        const double ta1 = pl_dbg ? now_s() : 0;
        mz_cache_evict_after_accept(st, p, ops, tstart_abs, tend_abs);
        const double ta2 = pl_dbg ? now_s() : 0;
        if (pl_dbg) ap_ns[1] += (int64_t)((ta2 - ta1) * 1e9);
        enqueue_children(st, p.item.rid);
        if (pl_dbg) ap_ns[3] += (int64_t)((now_s() - ta2) * 1e9);
        if (st.total_aligned > prm[P_EDGE_THR]) st.closed = true;
    }

    void mz_cache_evict_after_accept(Contig& st, Placed& p,
                                     std::vector<uint8_t>& ops,
                                     int64_t tstart_abs, int64_t tend_abs) {
        accept(st, p, ops, tstart_abs, tend_abs);  // needs the cache entry
        auto it = mz_cache.find(p.item.rid);
        if (it != mz_cache.end()) {
            mz_bytes -= anchors_bytes(it->second);
            mz_cache.erase(it);
        }
    }

    struct BatchState {
        std::vector<Placed> batch;
        std::vector<Item> consumed;
        std::vector<Item> deferred;
        bool any() const {
            return !batch.empty() || !consumed.empty() || !deferred.empty();
        }
    };

    void collect(BatchState& bs) {
        std::vector<Placed>& batch = bs.batch;
        std::vector<Item>& consumed = bs.consumed;
        std::vector<Item>& deferred = bs.deferred;
        // End-extension admission: only one candidate per (contig, side)
        // per batch. Every other end-extender in the batch would lose the
        // splice race and retry with a full re-alignment (the dominant DP
        // waste: ~60% of pairs were retries before this), so defer them
        // un-aligned; they re-place against the fresh end next batch.
        //
        // Two phases per chunk: place() fans out over OpenMP (no shared
        // state is mutated during collect), then admission runs serially
        // in pop order — output is identical to the sequential loop.
        std::unordered_set<int64_t> side_taken;
        double t0 = now_s();
        std::vector<Item> picked;
        std::vector<Placed> placed;
        std::vector<uint8_t> okv;
        while (!queue.empty() && (int64_t)batch.size() < prm[P_ALIGN_BATCH]) {
            picked.clear();
            // small overshoot only: every placed-but-not-admitted item is
            // re-queued and re-placed later, so chunks barely larger than
            // the remaining need waste the least placement work
            const int64_t want =
                prm[P_ALIGN_BATCH] - (int64_t)batch.size() + 32;
            while (!queue.empty() && (int64_t)picked.size() < want) {
                Item it = queue.back();
                queue.pop_back();
                if (claimed[it.rid]) {
                    consumed.push_back(it);
                    continue;
                }
                picked.push_back(it);
            }
            if (picked.empty()) break;
            // candidate minimizer tables not yet cached (dedup: two
            // contigs can queue the same rid); with precomputed tables
            // there is nothing to build or cache
            std::vector<int64_t> need;
            if (!g_premz.off) {
                std::unordered_set<int64_t> seen;
                for (const Item& it : picked)
                    if (!mz_cache.count(it.rid) && seen.insert(it.rid).second)
                        need.push_back(it.rid);
            }
            if (mz_bytes > MZ_CACHE_CAP) {
                // over budget: drop everything (entries rebuild on demand;
                // a full reset amortizes better than per-entry LRU here)
                mz_cache.clear();
                mz_bytes = 0;
                std::unordered_set<int64_t> seen2;
                need.clear();
                for (const Item& it : picked)
                    if (seen2.insert(it.rid).second) need.push_back(it.rid);
            }
            std::vector<Anchors> built((size_t)need.size());
            const double tmz = now_s();
            #pragma omp parallel for schedule(dynamic, 8)
            for (int64_t x = 0; x < (int64_t)need.size(); ++x)
                built[(size_t)x] = build_minimizers(need[(size_t)x]);
            t_mz += now_s() - tmz;
            for (size_t x = 0; x < need.size(); ++x) {
                mz_bytes += anchors_bytes(built[x]);
                mz_cache.emplace(need[x], std::move(built[x]));
            }
            placed.assign(picked.size(), Placed());
            okv.assign(picked.size(), 0);
            const double tpl = now_s();
            #pragma omp parallel for schedule(dynamic, 4)
            for (int64_t x = 0; x < (int64_t)picked.size(); ++x)
                okv[(size_t)x] =
                    place(picked[(size_t)x], placed[(size_t)x]) ? 1 : 0;
            t_placefn += now_s() - tpl;
            for (size_t x = 0; x < picked.size(); ++x) {
                const Item& it = picked[x];
                if ((int64_t)batch.size() >= prm[P_ALIGN_BATCH]) {
                    // chunk overshoot: back on the queue, untouched
                    queue.push_back(it);
                    continue;
                }
                if (!okv[x]) {
                    consumed.push_back(it);
                    stat_not_claimed += 1;
                    n_place_fail += 1;
                    continue;
                }
                Placed& pl = placed[x];
                const bool headext = pl.qlo > 0;
                const bool tailext = pl.qhi < (int64_t)pl.codes.size();
                const bool blocked =
                    (headext && side_taken.count(it.cid * 2)) ||
                    (tailext && side_taken.count(it.cid * 2 + 1));
                if (blocked) {
                    deferred.push_back(it);
                    continue;
                }
                if (headext) side_taken.insert(it.cid * 2);
                if (tailext) side_taken.insert(it.cid * 2 + 1);
                consumed.push_back(it);
                stat_not_claimed += 1;
                batch.push_back(std::move(pl));
            }
        }
        t_place += now_s() - t0;
    }

    // Device batch DP: fill the registered buffers, run the DP via the
    // Python callback, expand the byte traces into op tapes. Pairs the
    // device can't take (escalated full-band retries, over-long queries,
    // escape rows) run on the exact scalar DP. Returns 0 when the device
    // ran, 1 when no pair was eligible, 2 when the callback failed.
    int dp_run_device(BatchState& bs) {
        std::vector<Placed>& batch = bs.batch;
        const int64_t tw = g_dev.m_cap + 3 * 128;
        const int64_t qw = g_dev.m_cap + 2 * 128;
        std::vector<int64_t> tp_idx;      // batch index per kernel slot
        tp_idx.reserve(batch.size());
        for (int64_t b = 0; b < (int64_t)batch.size(); ++b) {
            Placed& p = batch[(size_t)b];
            const int64_t m = p.qhi - p.qlo;
            const bool eligible = !p.item.full_band && m > 0;
            if (eligible && m <= g_dev.m_cap &&
                (int64_t)tp_idx.size() < g_dev.p_cap) {
                tp_idx.push_back(b);
            } else if (eligible && (m > g_dev.m_cap ||
                       (int64_t)tp_idx.size() >= g_dev.p_cap)) {
                // host-routed for CAPACITY reasons only (row cap or slot
                // cap): escalated full-band retries are host-bound by
                // design and must not inflate the routing stats
                n_host_long_pairs += 1;
                n_host_long_bases += m;
            }
        }
        if (tp_idx.empty()) return 1;
        const int64_t P = (int64_t)tp_idx.size();
        const int64_t P_pad = g_dev.p_cap;   // fixed shape: one compile
        #pragma omp parallel for schedule(dynamic, 8)
        for (int64_t x = 0; x < P_pad; ++x) {
            uint8_t* trow = g_dev.tpad + x * tw;
            uint8_t* qrow = g_dev.qbuf + x * qw;
            if (x >= P) {
                g_dev.d0[x] = 0; g_dev.qlen[x] = 0;
                g_dev.tlen[x] = 0; g_dev.maxc[x] = 0;
                continue;
            }
            Placed& p = batch[(size_t)tp_idx[(size_t)x]];
            const int64_t m = p.qhi - p.qlo;
            const int64_t n = (int64_t)p.tgt.size();
            std::memset(trow, 0xFF, (size_t)tw);
            // tpad[y] = tgt[y + d0 - (KOFF+1)]
            const int64_t lo = p.d0_win - (DEV_KOFF + 1);
            int64_t b0 = lo < 0 ? -lo : 0;
            int64_t e0 = tw;
            if (lo + e0 > n) e0 = n - lo;
            if (e0 > b0)
                std::memcpy(trow + b0, p.tgt.data() + lo + b0,
                            (size_t)(e0 - b0));
            std::memcpy(qrow, p.codes.data() + p.qlo, (size_t)m);
            if (m < qw) std::memset(qrow + m, 0, (size_t)(qw - m));
            g_dev.d0[x] = (int32_t)p.d0_win;
            g_dev.qlen[x] = (int32_t)m;
            g_dev.tlen[x] = (int32_t)n;
            g_dev.maxc[x] =
                (int32_t)((m * prm[P_MAXCOST_KB]) / 1000 + 8);
        }
        if (g_dev.fn(P_pad) != 0) return 2;
        // expand traces (+ per-pair exact-DP fallback on escapes/rejects)
        #pragma omp parallel for schedule(dynamic, 8)
        for (int64_t x = 0; x < P; ++x) {
            Placed& p = batch[(size_t)tp_idx[(size_t)x]];
            const int64_t m = p.qhi - p.qlo;
            const int64_t ops_cap = 2 * m + 2 * p.band + 2;
            p.ops.resize((size_t)ops_cap);
            const uint8_t* rows = g_dev.trace + x * g_dev.m_cap;
            bool esc = false;
            if (g_dev.cost[x] >= 0) {
                int64_t len = 0;
                for (int64_t r = 0; r < m; ++r) {
                    const uint8_t rec = rows[r];
                    if (rec == 255) { esc = true; break; }
                    const int64_t dels = rec & 63;
                    const uint8_t op2 = rec >> 6;
                    if (len + 1 + dels > ops_cap) { esc = true; break; }
                    p.ops[(size_t)len++] =
                        op2 == 2 ? 'i' : (op2 == 0 ? '=' : 's');
                    for (int64_t y = 0; y < dels; ++y)
                        p.ops[(size_t)len++] = 'd';
                }
                if (!esc) {
                    p.cost = g_dev.cost[x];
                    p.ops_len = len;
                    p.tstart = g_dev.ts[x];
                    p.tend = g_dev.te[x];
                }
            } else {
                p.cost = -1;
                p.ops_len = 0;
                p.tstart = 0;
                p.tend = 0;
            }
            if (esc) {
                const int32_t max_cost =
                    (int32_t)((m * prm[P_MAXCOST_KB]) / 1000 + 8);
                p.cost = ns_banded_align(
                    p.tgt.data(), (int64_t)p.tgt.size(),
                    p.codes.data() + p.qlo, m,
                    p.d0_win, DEV_W, max_cost,
                    p.ops.data(), ops_cap, &p.ops_len, &p.tstart, &p.tend);
                if (p.cost < 0) { p.ops_len = 0; p.tstart = 0; p.tend = 0; }
            }
        }
        // everything the kernel didn't take runs on the host path
        std::vector<uint8_t> taken(batch.size(), 0);
        for (int64_t x : tp_idx) taken[(size_t)x] = 1;
        #pragma omp parallel for schedule(dynamic, 2)
        for (int64_t b = 0; b < (int64_t)batch.size(); ++b) {
            if (taken[(size_t)b]) continue;
            Placed& p = batch[(size_t)b];
            const int64_t m = p.qhi - p.qlo;
            const int64_t ops_cap = 2 * m + 2 * p.band + 2;
            p.ops.resize((size_t)ops_cap);
            const int32_t max_cost =
                (int32_t)((m * prm[P_MAXCOST_KB]) / 1000 + 8);
            p.cost = ns_banded_align(
                p.tgt.data(), (int64_t)p.tgt.size(),
                p.codes.data() + p.qlo, m,
                p.d0_win, (int32_t)p.band, max_cost,
                p.ops.data(), ops_cap, &p.ops_len, &p.tstart, &p.tend);
            if (p.cost < 0) { p.ops_len = 0; p.tstart = 0; p.tend = 0; }
        }
        return 0;
    }

    void dp_run(BatchState& bs) {
        if (bs.batch.empty()) return;
        const double t0 = now_s();
        int r = 1;
        if (g_dev.fn) {
            r = dev_failed ? 2 : dp_run_device(bs);
            if (r == 0) {
                t_dp_device += now_s() - t0;
                n_device_batches += 1;
            } else if (r == 1) {
                n_host_batches += 1;
            } else {
                // the error surfaces in Python; reject the batch so the
                // run winds down without touching the host DP
                dev_failed = true;
                for (Placed& p : bs.batch) { p.cost = -1; p.ops_len = 0; }
                return;
            }
        }
        if (r != 0) dp_run_native(bs);
        t_dp += now_s() - t0;
        n_dp += (int64_t)bs.batch.size();
        for (const Placed& p : bs.batch) dp_bases += p.qhi - p.qlo;
    }

    // DP only: touches nothing but the batch's own snapshots (safe to run
    // concurrently with settle() of the previous batch)
    void dp_run_native(BatchState& bs) {
        if (bs.batch.empty()) return;
        std::vector<Placed>& batch = bs.batch;
        int64_t stitch_bases = 0, full_dp_bases = 0;
        double s_stitch = 0, s_full = 0, s_resize = 0;
        // the DP worker thread runs concurrently with settle+collect on
        // the main thread; leave one core to them or the two OpenMP
        // barriers fight over the same cores (2-core hosts: DP team of 1)
        int nt = 1;
        #ifdef _OPENMP
        nt = omp_get_max_threads();
        if (nt < 1) nt = 1;
        #endif
        #pragma omp parallel for schedule(dynamic, 2) num_threads(nt) \
            reduction(+:stitch_bases, full_dp_bases, s_stitch, s_full, s_resize)
        for (int64_t b = 0; b < (int64_t)batch.size(); ++b) {
            Placed& p = batch[(size_t)b];
            const int64_t m = p.qhi - p.qlo;
            const int64_t ops_cap = 2 * m + 2 * p.band + 2;
            double tt = now_s();
            p.ops.resize((size_t)ops_cap);
            s_resize += now_s() - tt;
            const int32_t max_cost =
                (int32_t)((m * prm[P_MAXCOST_KB]) / 1000 + 8);
            // stitched first: verify anchor-to-anchor runs, DP only the
            // gaps (~5% of the bases). -4 = chain unusable -> full DP;
            // -1 = reject -> apply() escalates to a full-band DP retry.
            // The retry preserves the BAND-exact admission decision up to
            // the divergence-slope abort both DPs share (align.cpp:156):
            // a pair whose prefix cost exceeds 0.35/row + 240 is rejected
            // for good — measured as verdict-neutral for every genuine
            // overlap shape in the regime suite, and the reason rejects
            // cost ~1/3 of a full scan instead of band*len.
            p.cost = -4;
            if (!p.item.full_band && (int64_t)p.aq.size() >= 2) {
                tt = now_s();
                p.cost = ns_stitch_align(
                    p.tgt.data(), (int64_t)p.tgt.size(),
                    p.codes.data() + p.qlo, m,
                    p.aq.data(), p.at.data(), (int64_t)p.aq.size(),
                    p.d0_win, (int32_t)p.band, (int32_t)prm[P_BAND],
                    max_cost,
                    p.ops.data(), ops_cap, &p.ops_len, &p.tstart, &p.tend);
                s_stitch += now_s() - tt;
                stitch_bases += m;
            }
            const bool was_struct_fail = (p.cost == -4) &&
                !p.item.full_band && (int64_t)p.aq.size() >= 2;
            if (p.cost == -4) {
                tt = now_s();
                p.cost = ns_banded_align(
                    p.tgt.data(), (int64_t)p.tgt.size(),
                    p.codes.data() + p.qlo, m,
                    p.d0_win, (int32_t)p.band, max_cost,
                    p.ops.data(), ops_cap, &p.ops_len, &p.tstart, &p.tend);
                const double dt = now_s() - tt;
                s_full += dt;
                full_dp_bases += m;
                const int cls = p.item.full_band ? 2
                                : (was_struct_fail ? 1 : 0);
                #pragma omp critical(fb_stats)
                {
                    fb_s[cls] += dt;
                    (p.cost >= 0 ? fb_acc : fb_rej)[cls] += 1;
                }
            }
            if (p.cost < 0) { p.ops_len = 0; p.tstart = 0; p.tend = 0; }
        }
        n_stitch_bases += stitch_bases;
        n_full_dp_bases += full_dp_bases;
        t_dp_stitch += s_stitch;
        t_dp_full += s_full;
        t_dp_resize += s_resize;
    }

    void settle(BatchState& bs) {
        const double t0 = now_s();
        for (Placed& p : bs.batch) apply(p);
        t_apply += now_s() - t0;
        for (const Item& it : bs.consumed) {
            auto sit = states.find(it.cid);
            if (sit == states.end()) continue;
            sit->second.pending -= 1;
            if (sit->second.pending == 0) finalize(sit->second);
        }
        // deferred items were never consumed: pending unchanged, re-queued
        // for a fresh placement against the now-extended consensus
        for (const Item& it : bs.deferred) queue.push_back(it);
    }

    void run_batch() {
        BatchState bs;
        collect(bs);
        dp_run(bs);
        settle(bs);
    }

    void run() {
        std::deque<int64_t> expand;
        for (int64_t s = 0; s < (int64_t)comp_ids.size(); ++s)
            expand.push_back(comp_ids[(size_t)s]);
        auto top_up = [&]() {
            while ((int64_t)queue.size() < prm[P_FRONTIER] && !expand.empty()) {
                if (activate_next_in_comp(expand.front(), /*fresh_only=*/true)) {
                    expand.push_back(expand.front());
                    expand.pop_front();
                } else {
                    expand.pop_front();
                }
            }
        };
        // software pipeline with a PERSISTENT DP worker: main collects up
        // to PIPE_DEPTH batches ahead and settles them strictly in
        // collection order; the worker drains the ready queue FIFO. The
        // per-batch spawn/join of the old two-stage loop made each side
        // wait out the other's tail every iteration (~25% of both threads
        // idle on the 60 Mb bench); the queue decouples them. DP touches
        // only its own snapshots; placement sees an up-to-PIPE_DEPTH-stale
        // consensus, which the stale-clip retry rules in apply() already
        // cover (same rules as the one-batch-stale schedule before).
        constexpr int64_t PIPE_DEPTH = 4;
        std::mutex mu;
        std::condition_variable cv_worker, cv_main;
        std::deque<BatchState*> ready;    // collected, awaiting DP (FIFO)
        std::deque<BatchState*> dp_done;  // DP finished, awaiting settle
        bool stopping = false;
        std::thread worker([&] {
            std::unique_lock<std::mutex> lk(mu);
            while (true) {
                cv_worker.wait(lk,
                               [&] { return stopping || !ready.empty(); });
                if (ready.empty()) return;   // stopping && drained
                BatchState* b = ready.front();
                ready.pop_front();
                lk.unlock();
                dp_run(*b);
                lk.lock();
                dp_done.push_back(b);
                cv_main.notify_one();
            }
        });
        // Fixed alternation keeps the schedule DETERMINISTIC (same input
        // -> same archive): after the ramp-up the loop settles exactly one
        // batch per collect, blocking on the worker only when the oldest
        // batch's DP is genuinely unfinished — the interleave never
        // depends on thread timing, only the waiting does.
        auto settle_one = [&] {
            BatchState* b = nullptr;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_main.wait(lk, [&] { return !dp_done.empty(); });
                b = dp_done.front();
                dp_done.pop_front();
            }
            settle(*b);
            delete b;
        };
        int64_t inflight = 0;
        while (true) {
            bool collected = false;
            if (inflight < PIPE_DEPTH && !dev_failed) {
                top_up();
                BatchState* b = new BatchState();
                collect(*b);
                if (b->any()) {
                    collected = true;
                    ++inflight;
                    {
                        std::lock_guard<std::mutex> lk(mu);
                        ready.push_back(b);
                    }
                    cv_worker.notify_one();
                } else {
                    delete b;
                }
            }
            if (collected && inflight < PIPE_DEPTH) continue;  // ramp-up
            if (inflight == 0) break;       // drained and nothing active
            settle_one();
            --inflight;
        }
        {
            std::lock_guard<std::mutex> lk(mu);
            stopping = true;
        }
        cv_worker.notify_one();
        worker.join();
        if (dev_failed) return;
        for (int64_t s = 0; s < (int64_t)comp_ids.size(); ++s) {
            while (activate_next_in_comp(comp_ids[(size_t)s], false))
                while (!queue.empty()) run_batch();
        }
        std::vector<int64_t> leftover;
        for (auto& kv : states) leftover.push_back(kv.first);
        std::sort(leftover.begin(), leftover.end());
        for (int64_t cid : leftover) {
            auto it = states.find(cid);
            if (it != states.end()) finalize(it->second);
        }
    }
};

thread_local std::vector<uint8_t> Engine::scratch;
thread_local std::vector<int64_t> Engine::pin_q;
thread_local std::vector<int64_t> Engine::pin_t;
thread_local std::vector<int64_t> Engine::m_pa;
thread_local std::vector<int64_t> Engine::m_pb;
thread_local std::vector<uint8_t> Engine::m_rc;
std::atomic<int64_t> Engine::pl_ns[5];
std::atomic<int64_t> Engine::ap_ns[4];
std::atomic<int64_t> Engine::ac_ns[3];
bool Engine::pl_dbg = std::getenv("NS_ENGINE_DEBUG") != nullptr;

}  // namespace

extern "C" {

// comp member lists: for registered component i (of n_comps, ids in
// comps[]), members are memb_flat[memb_off[i] : memb_off[i+1]).
void* ns_engine_run(
    const uint8_t* packed, const int64_t* offsets, const int64_t* lengths,
    int64_t N,
    const int64_t* adj_off, const int64_t* adj,
    const int64_t* comp_of,
    const int64_t* comps, const int64_t* memb_off, const int64_t* memb_flat,
    int64_t n_comps,
    uint8_t* claimed,
    const int64_t* params,
    int64_t* out_ncontig, int64_t* out_nmember,
    int64_t* out_cons_total, int64_t* out_ops_total,
    int64_t* stats_out)
{
    Engine* e = new Engine();
    // the sub-phase profile atomics are process-wide statics: zero them
    // per run so NS_ENGINE_DEBUG prints per-run splits, not totals
    // accumulated across a bench's best-of-N reps
    for (auto& a : Engine::pl_ns) a = 0;
    for (auto& a : Engine::ap_ns) a = 0;
    for (auto& a : Engine::ac_ns) a = 0;
    extern void ns_stitch_stats_reset();
    ns_stitch_stats_reset();
    e->packed = packed;
    e->offsets = offsets;
    e->lengths = lengths;
    e->adj_off = adj_off;
    e->adj = adj;
    e->comp_of = comp_of;
    e->claimed = claimed;
    e->N = N;
    e->touched.assign((size_t)N, 0);
    std::memcpy(e->prm, params, sizeof(e->prm));
    for (int64_t i = 0; i < n_comps; ++i) {
        const int64_t comp = comps[i];
        e->comp_ids.push_back(comp);
        e->comp_members.push_back(memb_flat + memb_off[i]);
        e->comp_size.push_back(memb_off[i + 1] - memb_off[i]);
        e->comp_cursor.push_back(0);
        e->comp_phase.push_back(0);
        e->comp_slot[comp] = i;
        e->comp_active[comp] = 0;
    }
    e->run();
    if (e->prm[P_POLISH] && !e->dev_failed) {
        // in-engine consensus polish (subs -> indels -> subs, the same
        // pass order as the Python batch path): contigs are independent,
        // members' oriented codes are re-unpacked per contig and dropped
        // immediately -- no flatten/fetch round trip through Python.
        const double tp0 = now_s();
        std::vector<Contig>& done = e->done;
        #pragma omp parallel for schedule(dynamic, 1)
        for (int64_t c = 0; c < (int64_t)done.size(); ++c) {
            Contig& st = done[(size_t)c];
            if (st.members.size() < 3) continue;
            std::vector<uint8_t> cons(st.cons(), st.cons() + st.len);
            std::vector<std::vector<uint8_t>> codes(st.members.size());
            std::vector<nsp::Member> pm(st.members.size());
            for (size_t k = 0; k < st.members.size(); ++k) {
                Member& m = st.members[k];
                e->unpack_oriented(m.rid, m.strand, codes[k]);
                pm[k].ops.resize((size_t)m.raw_len);
                ops_rle_decode(m.ops.data(), (int64_t)m.ops.size(),
                               pm[k].ops.data());
                pm[k].tstart = m.tstart - st.lo;
                pm[k].codes = codes[k].data();
            }
            nsp::polish_subs(cons, pm);
            nsp::polish_indels(cons, pm);
            nsp::polish_subs(cons, pm);
            st.buf.assign(cons.begin(), cons.end());
            st.start = 0;
            st.len = (int64_t)cons.size();
            for (size_t k = 0; k < st.members.size(); ++k) {
                st.members[k].raw_len = (int64_t)pm[k].ops.size();
                ops_rle_encode(pm[k].ops.data(),
                               (int64_t)pm[k].ops.size(),
                               st.members[k].ops);
                st.members[k].tstart = st.lo + pm[k].tstart;
            }
        }
        e->t_polish = now_s() - tp0;
    }
    if (std::getenv("NS_ENGINE_DEBUG")) {
        extern void ns_stitch_stats(int64_t*);
        extern void ns_stitch_prof(int64_t*);
        extern void ns_core_prof(int64_t*);
        int64_t ss[8], sp[8], cp[8];
        ns_stitch_stats(ss);
        ns_stitch_prof(sp);
        ns_core_prof(cp);
        std::fprintf(stderr,
                     "[engine] core reseed: calls %lld ok %lld rej %lld "
                     "nopins %lld | dcap falls %lld cells %.1fM\n",
                     (long long)cp[0], (long long)cp[1], (long long)cp[2],
                     (long long)cp[3], (long long)cp[6], cp[4] / 1e6);
        std::fprintf(stderr,
                     "[engine] stitch prof: pairs %lld verify %.1fMb "
                     "segcalls %lld wfacells %.1fM areacells %.1fM "
                     "pins %lld anchors %.1fM\n",
                     (long long)sp[0], sp[1] / 1e6, (long long)sp[2],
                     sp[3] / 1e6, sp[5] / 1e6, (long long)sp[4],
                     sp[6] / 1e6);
        std::fprintf(stderr,
                     "[engine] stitch fails: F<2 %lld C<2 %lld head %lld "
                     "mid %lld tail %lld cost %lld | ok %lld rescued %lld\n",
                     (long long)ss[0], (long long)ss[1], (long long)ss[2],
                     (long long)ss[3], (long long)ss[4], (long long)ss[5],
                     (long long)ss[6], (long long)ss[7]);
        std::fprintf(stderr,
                     "[engine] place %.1fs dp %.1fs (%lld pairs, %.1f Mb: "
                     "stitch %.1f full %.1f) apply %.1fs | retry %lld "
                     "reject %lld claimed %lld placefail %lld\n",
                     e->t_place, e->t_dp, (long long)e->n_dp,
                     e->dp_bases / 1e6, e->n_stitch_bases / 1e6,
                     e->n_full_dp_bases / 1e6,
                     e->t_apply, (long long)e->n_retry,
                     (long long)e->n_reject, (long long)e->n_claimed_skip,
                     (long long)e->n_place_fail);
        std::fprintf(stderr,
                     "[engine] dp split: stitch %.2fs full %.2fs "
                     "resize %.2fs | polish %.2fs | mz %.2fs "
                     "placefn %.2fs\n",
                     e->t_dp_stitch, e->t_dp_full, e->t_dp_resize,
                     e->t_polish, e->t_mz, e->t_placefn);
        std::fprintf(stderr,
                     "[engine] place split: mzfetch %.2fs probe %.2fs "
                     "chain %.2fs unpack %.2fs wincopy %.2fs\n",
                     Engine::pl_ns[0] / 1e9, Engine::pl_ns[1] / 1e9,
                     Engine::pl_ns[2] / 1e9, Engine::pl_ns[3] / 1e9,
                     Engine::pl_ns[4] / 1e9);
        std::fprintf(stderr,
                     "[engine] apply split: opsasm %.2fs accept %.2fs "
                     "rle %.2fs enqueue %.2fs | splice %.2fs anchors %.2fs "
                     "amerge %.2fs\n",
                     Engine::ap_ns[0] / 1e9, Engine::ap_ns[1] / 1e9,
                     Engine::ap_ns[2] / 1e9, Engine::ap_ns[3] / 1e9,
                     Engine::ac_ns[0] / 1e9, Engine::ac_ns[1] / 1e9,
                     Engine::ac_ns[2] / 1e9);
        std::fprintf(stderr,
                     "[engine] fullband classes: chain<2 %lld/%lld %.2fs | "
                     "structfail %lld/%lld %.2fs | escalated %lld/%lld "
                     "%.2fs (acc/total)\n",
                     (long long)e->fb_acc[0],
                     (long long)(e->fb_acc[0] + e->fb_rej[0]), e->fb_s[0],
                     (long long)e->fb_acc[1],
                     (long long)(e->fb_acc[1] + e->fb_rej[1]), e->fb_s[1],
                     (long long)e->fb_acc[2],
                     (long long)(e->fb_acc[2] + e->fb_rej[2]), e->fb_s[2]);
    }
    int64_t nm = 0, ct = 0, ot = 0;
    for (const Contig& c : e->done) {
        nm += (int64_t)c.members.size();
        ct += c.len;
        for (const Member& m : c.members) ot += m.raw_len;
    }
    *out_ncontig = (int64_t)e->done.size();
    *out_nmember = nm;
    *out_cons_total = ct;
    *out_ops_total = ot;
    stats_out[0] = e->stat_not_claimed;
    stats_out[1] = e->stat_aligned_ok;
    return e;
}

// Per-contig sizes so the caller can plan bounded fetch slices (the
// monolithic fetch materialized ~2 B per aligned base in one transient —
// the top RSS term on Gbase-class inputs).
void ns_engine_contig_sizes(void* handle, int64_t* cons_len,
                            int64_t* m_cnt, int64_t* ops_bytes)
{
    Engine* e = (Engine*)handle;
    int64_t ci = 0;
    for (const Contig& c : e->done) {
        cons_len[ci] = c.len;
        m_cnt[ci] = (int64_t)c.members.size();
        int64_t ot = 0;
        for (const Member& m : c.members) ot += m.raw_len;
        ops_bytes[ci] = ot;
        ++ci;
    }
}

// Fetch contigs [c0, c1). release != 0 frees each contig's member ops +
// consensus as it is copied out, so engine-resident memory drains while
// the caller serializes slice by slice.
void ns_engine_fetch_range(void* handle, int64_t c0, int64_t c1,
                           int32_t release,
                           uint8_t* cons_flat, int64_t* cons_len,
                           int64_t* m_cnt,
                           int64_t* rid, uint8_t* strand,
                           int64_t* tstart_rel,
                           int64_t* ops_len, uint8_t* ops_flat)
{
    Engine* e = (Engine*)handle;
    const int64_t nc = c1 - c0;
    std::vector<int64_t> coff((size_t)nc + 1, 0), moff((size_t)nc + 1, 0),
        ooff((size_t)nc + 1, 0);
    for (int64_t x = 0; x < nc; ++x) {
        const Contig& c = e->done[(size_t)(c0 + x)];
        int64_t ot = 0;
        for (const Member& m : c.members) ot += m.raw_len;
        coff[(size_t)x + 1] = coff[(size_t)x] + c.len;
        moff[(size_t)x + 1] = moff[(size_t)x] + (int64_t)c.members.size();
        ooff[(size_t)x + 1] = ooff[(size_t)x] + ot;
    }
    #pragma omp parallel for schedule(dynamic, 8)
    for (int64_t x = 0; x < nc; ++x) {
        Contig& c = e->done[(size_t)(c0 + x)];
        std::memcpy(cons_flat + coff[(size_t)x], c.cons(), (size_t)c.len);
        cons_len[x] = c.len;
        m_cnt[x] = (int64_t)c.members.size();
        int64_t mi = moff[(size_t)x], oo = ooff[(size_t)x];
        for (Member& m : c.members) {
            rid[mi] = m.rid;
            strand[mi] = m.strand;
            tstart_rel[mi] = m.tstart - c.lo;
            ops_len[mi] = m.raw_len;
            ops_rle_decode(m.ops.data(), (int64_t)m.ops.size(),
                           ops_flat + oo);
            oo += m.raw_len;
            ++mi;
            if (release) std::vector<uint8_t>().swap(m.ops);
        }
        if (release) {
            std::vector<uint8_t>().swap(c.buf);
            c.members.clear();
            c.members.shrink_to_fit();
        }
    }
}

void ns_engine_fetch(void* handle,
                     uint8_t* cons_flat, int64_t* cons_len,
                     int64_t* m_cnt,
                     int64_t* rid, uint8_t* strand, int64_t* tstart_rel,
                     int64_t* ops_len, uint8_t* ops_flat)
{
    Engine* e = (Engine*)handle;
    ns_engine_fetch_range(handle, 0, (int64_t)e->done.size(), 0,
                          cons_flat, cons_len, m_cnt, rid, strand,
                          tstart_rel, ops_len, ops_flat);
}

void ns_engine_free(void* handle) { delete (Engine*)handle; }

// Per-run stage timings + DP counters for the bench's pipeline split (the
// reference prints per-stage walls from src/Compressor.cpp:59-82; ours are
// machine-readable). out[] must hold >= 23 doubles:
//   0 t_place  1 t_dp  2 t_apply  3 t_polish  4 t_mz  5 t_placefn
//   6 t_dp_stitch  7 t_dp_full  8 t_dp_device  9 t_dp_resize
//   10 n_dp_pairs  11 dp_bases  12 stitch_bases  13 full_dp_bases
//   14 n_reject  15 n_retry  16 n_place_fail  17 n_claimed_skip
//   18 host_routed_long_pairs  19 host_routed_long_bases (pairs beyond
//      the device DP's row or pair capacity, 0 when no hook is installed)
//   20 device_batches  21 host_batches (device mode, no eligible pair)
//   22 device_failed (the device callback failed; the run is void)
void ns_engine_timings(void* handle, double* out) {
    Engine* e = (Engine*)handle;
    out[0] = e->t_place;      out[1] = e->t_dp;
    out[2] = e->t_apply;      out[3] = e->t_polish;
    out[4] = e->t_mz;         out[5] = e->t_placefn;
    out[6] = e->t_dp_stitch;  out[7] = e->t_dp_full;
    out[8] = e->t_dp_device;  out[9] = e->t_dp_resize;
    out[10] = (double)e->n_dp;            out[11] = (double)e->dp_bases;
    out[12] = (double)e->n_stitch_bases;  out[13] = (double)e->n_full_dp_bases;
    out[14] = (double)e->n_reject;        out[15] = (double)e->n_retry;
    out[16] = (double)e->n_place_fail;    out[17] = (double)e->n_claimed_skip;
    out[18] = (double)e->n_host_long_pairs;
    out[19] = (double)e->n_host_long_bases;
    out[20] = (double)e->n_device_batches;
    out[21] = (double)e->n_host_batches;
    out[22] = e->dev_failed ? 1.0 : 0.0;
}

}  // extern "C"
