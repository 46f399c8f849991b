// Chunked (beyond-one-host-RAM) index construction kernels.
//
// Role: the reference reaches pangenome scale through prefix-free parsing
// inside its mumemto fork (thirdparty/CMakeLists.txt:89-108) because a
// monolithic suffix array of the concatenation does not fit RAM.  This
// module is the from-scratch equivalent capability with a different
// decomposition: the collection is split into document chunks, each chunk
// gets a local SA-IS suffix array (native/sais.cpp), and chunk BWTs are
// merged by rank — never materializing a global SA — with the LCP array
// recovered afterwards directly from the merged RLBWT.
//
// The three kernels:
//
// 1. bwt_merge_ranks — for every suffix of chunk B, the number of suffixes
//    of the accumulated collection A that precede it, via the classic
//    backward-extension recurrence  k(i) = C_A[c] + rank_c(BWT_A, k(i+1))
//    with c = B[i], walked independently per document (each suffix's order
//    is decided at or before its own document's terminator because
//    terminators are pairwise distinct and rank below every real symbol —
//    oracle.concat_collection semantics).  The base case k(terminator of
//    any B document) = (number of A terminators): A documents all precede
//    B documents, and terminator-led suffixes sort below everything else.
//
// 2. bwt_merge_emit — stable interleave of BWT_A (run-compressed) with
//    BWT_B (in chunk suffix order) keyed by the sorted insertion ranks,
//    emitting merged runs and, optionally, the merged per-rank document-id
//    array.  Terminators are stored as byte 1 in every BWT; identity is
//    never needed (rank queries only touch real symbols) — chunk-local
//    BWTs equal the global BWT restricted to chunk suffixes because every
//    chunk ends with a terminator.
//
// 3. lcp_from_rlbwt — LCP array from the merged RLBWT by the BFS of
//    Beller, Gog, Ohlebusch & Schnattinger (JDA 2013): pop an omega-
//    interval at depth l, enumerate the symbols present in BWT[lo, hi)
//    (a run scan, cheap on an RLBWT), and for each child c-interval set
//    LCP[end] = l when unset, pushing the child at depth l+1.  Terminator
//    extensions are never pushed: the longest common prefix of two
//    suffixes can contain no terminator (each occurs once), so every
//    LCP-setting interval is terminator-free; boundaries inside the
//    terminator block are patched to 0 directly.
//
// Differential-tested against the monolithic SA-IS path
// (tests/test_chunked.py): merged runs == rle(bwt(SA)), doc array ==
// SA-derived, LCP == Kasai.

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

using std::vector;

// Dense symbol classes: class 0 = terminator (byte 1), classes 1..K = real
// symbols in byte order, 255 = absent.  `classes` is a 256-entry map.

struct RunIndex {
    // Two cache-behavior devices (the backward-extension rank walk is
    // cache-miss-bound; these cut ~25 scattered probes per query to ~3):
    //
    // 1. position-block run sampling: sample[b] = run containing position
    //    b << shift; run_of binary-searches only the handful of runs in
    //    one block instead of the full multi-hundred-MB array.  The block
    //    size adapts to run density (~8 runs per block) so the in-block
    //    search touches 1-2 cache lines at any n/r ratio.
    //
    // 2. array-of-structs run records: rec[j*stride] = (cum[j] << 8) |
    //    cls[j], followed by the K occ counters of run j — one rank query
    //    lands on one contiguous record (40 B at K = 4) instead of three
    //    scattered arrays.  Caps n < 2^55 (far above the 2^40 design
    //    budget, include/ds/LF_table.hpp:36-39).  A sentinel record at
    //    j = r carries cum = n and the final totals.
    int shift = 13;
    int64_t stride = 0;    // K + 1 int64s per record
    vector<int64_t> rec;
    vector<int64_t> C;     // C[c] = # suffixes starting with class < c
    vector<int64_t> sample;
    int64_t r = 0, n = 0, K = 0;

    inline int64_t cum_of(int64_t j) const {
        return rec[(size_t)(j * stride)] >> 8;
    }
    inline uint8_t cls_of(int64_t j) const {
        return (uint8_t)(rec[(size_t)(j * stride)] & 0xff);
    }
    // occurrences of class c (1..K) in BWT[0, cum_of(j))
    inline int64_t occ_of(int64_t j, int64_t c) const {
        return rec[(size_t)(j * stride + c)];
    }

    void build(const uint8_t* heads, const int64_t* lens, int64_t r_,
               const uint8_t* classes, int64_t K_) {
        r = r_;
        K = K_;
        stride = K + 1;
        rec.assign((size_t)(r + 1) * stride, 0);
        vector<int64_t> counts(K + 1, 0);
        vector<int64_t> running(K, 0);
        int64_t cum = 0;
        for (int64_t j = 0; j < r; ++j) {
            uint8_t c = classes[heads[j]];
            int64_t* rj = rec.data() + (size_t)j * stride;
            rj[0] = (cum << 8) | c;
            for (int64_t q = 0; q < K; ++q) rj[1 + q] = running[q];
            cum += lens[j];
            counts[c] += lens[j];
            if (c >= 1) running[c - 1] += lens[j];
        }
        n = cum;
        int64_t* rr = rec.data() + (size_t)r * stride;
        rr[0] = (n << 8);  // sentinel: cum_of(r) = n
        for (int64_t q = 0; q < K; ++q) rr[1 + q] = running[q];
        C.assign(K + 2, 0);
        for (int64_t c = 0; c <= K; ++c) C[c + 1] = C[c] + counts[c];
        shift = 3;  // target ~8 runs per block
        while ((int64_t(1) << shift) < (8 * n) / (r > 0 ? r : 1)) ++shift;
        while ((n >> shift) > (int64_t(1) << 24)) ++shift;  // cap table 128 MB
        int64_t nb = (n >> shift) + 2;
        sample.assign(nb, r > 0 ? r - 1 : 0);
        int64_t b = 0;
        for (int64_t j = 0; j < r && b < nb; ++j)
            while (b < nb && (b << shift) < cum_of(j + 1)) sample[b++] = j;
    }

    // run containing position p (0 <= p < n): largest j with cum_of(j) <= p
    inline int64_t run_of(int64_t p) const {
        int64_t lo = sample[p >> shift];
        int64_t hi = sample[(p >> shift) + 1];
        while (lo < hi) {
            int64_t mid = (lo + hi + 1) >> 1;
            if (cum_of(mid) <= p) lo = mid; else hi = mid - 1;
        }
        return lo;
    }

    // occurrences of real class c (1..K) in BWT[0, p), 0 <= p <= n
    inline int64_t rank(int64_t c, int64_t p) const {
        if (p <= 0) return 0;
        int64_t pp = std::min(p, n) - 1;
        int64_t j = run_of(pp);
        const int64_t* rj = rec.data() + (size_t)(j * stride);
        int64_t base = rj[c];
        if ((rj[0] & 0xff) == (uint8_t)c) base += pp + 1 - (rj[0] >> 8);
        return base;
    }
};

}  // namespace

extern "C" {

// kpos[i] = number of A-suffixes preceding the suffix of B starting at i.
// doc_starts has ndocsB+1 entries; document d occupies
// [doc_starts[d], doc_starts[d+1]) and its LAST position is its terminator.
void bwt_merge_ranks(const uint8_t* headsA, const int64_t* lensA, int64_t rA,
                     const uint8_t* classes, int64_t K,
                     const uint8_t* textB, int64_t nB,
                     const int64_t* doc_starts, int64_t ndocsB,
                     int64_t* kpos_out) {
    RunIndex A;
    A.build(headsA, lensA, rA, classes, K);
    const int64_t nsepA = A.C[1];  // class-0 (terminator) count
    (void)nB;

    // Each document's walk is a dependent chain of ~3 cache misses per
    // rank query (sample -> in-block probes -> record), so a one-doc-at-
    // a-time loop is latency-bound.  Walks are independent across
    // documents: each thread advances up to G of its documents in
    // lockstep stages with prefetches, keeping G misses in flight —
    // memory-level parallelism instead of one serialized chain.
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
#ifdef _OPENMP
        const int64_t nth = omp_get_num_threads();
        const int64_t tid = omp_get_thread_num();
#else
        const int64_t nth = 1, tid = 0;
#endif
        constexpr int G = 16;
        int64_t pos[G], stop[G], k[G];          // per-slot walk state
        int64_t c[G], p[G], lo[G], hi[G];       // per-step scratch
        bool stepping[G];
        int active = 0;
        int64_t next_doc = tid;                 // docs tid, tid+nth, ...
        auto refill = [&]() {
            while (active < G && next_doc < ndocsB) {
                int64_t d = next_doc;
                next_doc += nth;
                int64_t dlo = doc_starts[d], dhi = doc_starts[d + 1];
                kpos_out[dhi - 1] = nsepA;      // the terminator suffix
                if (dhi - 1 > dlo) {
                    pos[active] = dhi - 2;
                    stop[active] = dlo;
                    k[active] = nsepA;
                    ++active;
                }
            }
        };
        refill();
        while (active > 0) {
            // stage 1: symbol + sample-block lookups, all slots
            for (int g = 0; g < active; ++g) {
                c[g] = classes[textB[pos[g]]];
                p[g] = k[g] - 1;                // rank position (k <= nA)
                stepping[g] = p[g] >= 0;        // rank(c, k<=0) == 0
                if (stepping[g])
                    __builtin_prefetch(&A.sample[p[g] >> A.shift]);
            }
            for (int g = 0; g < active; ++g) {
                if (!stepping[g]) continue;
                lo[g] = A.sample[p[g] >> A.shift];
                hi[g] = A.sample[(p[g] >> A.shift) + 1];
                int64_t m = lo[g] < hi[g] ? (lo[g] + hi[g] + 1) >> 1 : lo[g];
                __builtin_prefetch(&A.rec[(size_t)(m * A.stride)]);
            }
            // stage 2: lockstep in-block binary probes
            for (bool any = true; any; ) {
                any = false;
                for (int g = 0; g < active; ++g) {
                    if (!stepping[g] || lo[g] >= hi[g]) continue;
                    int64_t mid = (lo[g] + hi[g] + 1) >> 1;
                    if (A.cum_of(mid) <= p[g]) lo[g] = mid;
                    else hi[g] = mid - 1;
                    int64_t m = lo[g] < hi[g] ? (lo[g] + hi[g] + 1) >> 1
                                              : lo[g];
                    __builtin_prefetch(&A.rec[(size_t)(m * A.stride)]);
                    any |= lo[g] < hi[g];
                }
            }
            // stage 3: fold the rank into k, store, advance
            for (int g = 0; g < active; ++g) {
                int64_t base = 0;
                if (stepping[g]) {
                    const int64_t* rj =
                        A.rec.data() + (size_t)(lo[g] * A.stride);
                    base = rj[c[g]];
                    if ((rj[0] & 0xff) == (uint8_t)c[g])
                        base += p[g] + 1 - (rj[0] >> 8);
                }
                k[g] = A.C[c[g]] + base;
                kpos_out[pos[g]] = k[g];
                --pos[g];
            }
            // retire finished walks, then top the window back up
            int w = 0;
            for (int g = 0; g < active; ++g) {
                if (pos[g] < stop[g]) continue;
                pos[w] = pos[g];
                stop[w] = stop[g];
                k[w] = k[g];
                ++w;
            }
            active = w;
            refill();
        }
    }
}

// Stable interleave of run-compressed BWT_A with BWT_B (chunk suffix
// order) keyed by non-decreasing insertion ranks karr.  heads_out/lens_out
// need capacity rA + nB runs; doc_out (when with_doc) capacity nA + nB.
// Returns the merged run count.
int64_t bwt_merge_emit(const uint8_t* headsA, const int64_t* lensA,
                       int64_t rA, int64_t nA,
                       const uint8_t* bwtB, const int64_t* karr, int64_t nB,
                       const uint16_t* docA, const uint16_t* docB,
                       int32_t with_doc,
                       uint8_t* heads_out, int64_t* lens_out,
                       uint16_t* doc_out) {
    int64_t rout = 0;
    auto emit = [&](uint8_t ch, int64_t len) {
        if (len <= 0) return;
        if (rout > 0 && heads_out[rout - 1] == ch) {
            lens_out[rout - 1] += len;
        } else {
            heads_out[rout] = ch;
            lens_out[rout] = len;
            ++rout;
        }
    };

    int64_t ja = 0;           // current A run
    int64_t a_pos = 0;        // global A position consumed so far
    int64_t a_run_off = 0;    // consumed inside run ja
    int64_t out_pos = 0;      // merged positions emitted (doc_out cursor)
    auto emit_A_until = [&](int64_t target) {
        if (with_doc && target > a_pos) {
            std::memcpy(doc_out + out_pos, docA + a_pos,
                        (size_t)(target - a_pos) * sizeof(uint16_t));
            out_pos += target - a_pos;
        }
        while (a_pos < target) {
            int64_t take = std::min(lensA[ja] - a_run_off, target - a_pos);
            emit(headsA[ja], take);
            a_pos += take;
            a_run_off += take;
            if (a_run_off == lensA[ja]) { ++ja; a_run_off = 0; }
        }
    };

    for (int64_t t = 0; t < nB; ++t) {
        emit_A_until(karr[t]);
        emit(bwtB[t], 1);
        if (with_doc) doc_out[out_pos++] = docB[t];
    }
    emit_A_until(nA);
    return rout;
}

// LCP array from a run-length BWT (Beller et al. BFS).  nsep = number of
// terminators (class 0); lcp_out has n entries, lcp_out[0] = 0 and
// lcp_out[i] = lcp(suffix at rank i-1, suffix at rank i) for i >= 1.
void lcp_from_rlbwt(const uint8_t* heads, const int64_t* lens, int64_t r,
                    int64_t nsep, const uint8_t* classes, int64_t K,
                    int32_t* lcp_out) {
    RunIndex A;
    A.build(heads, lens, r, classes, K);
    const int64_t n = A.n;
    if (n == 0) return;
    const bool stats = getenv("COLBWT_LCP_STATS") != nullptr;
    int64_t st_levels = 0, st_ivs = 0, st_narrow_levels = 0;
    std::fill(lcp_out, lcp_out + n, -1);
    // "boundary n" sentinel: intervals touching the right edge still get
    // pushed exactly once (the published algorithm's LCP[n] slot).
    int32_t end_slot = -1;

    // term = the interval's string ENDS with a (merged) terminator: such
    // omega-$ groups carry one suffix per document sharing exactly omega,
    // so every inner boundary is |omega| = |string|-1 — the same value as
    // the end boundary — and gets batch-set when the group is generated.
    // (A terminator can appear in an LCP-setter string only as its LAST
    // character: the common prefix itself is terminator-free.)
    struct IV { int64_t lo, hi; bool term; };
    vector<IV> cur, nxt;

    // depth-0: children of the root are the class blocks [C[c], C[c+1]).
    lcp_out[0] = 0;
    for (int64_t c = 0; c <= K; ++c) {
        int64_t lo = A.C[c], hi = A.C[c + 1];
        if (lo == hi) continue;
        if (hi < n) {
            if (lcp_out[hi] < 0) lcp_out[hi] = 0;
        } else {
            end_slot = 0;
        }
        cur.push_back({lo, hi, c == 0});
    }
    // boundaries inside the terminator block: terminators are pairwise
    // distinct, so adjacent terminator-led suffixes share no prefix.
    for (int64_t i = 1; i < nsep && i < n; ++i) lcp_out[i] = 0;

    int64_t depth = 1;
    while (!cur.empty()) {
        nxt.clear();
        const bool parallel_level = cur.size() >= 256;
#ifdef _OPENMP
        int nthreads = parallel_level ? omp_get_max_threads() : 1;
#else
        int nthreads = 1;
        (void)parallel_level;
#endif
        vector<vector<IV>> locals(nthreads);
        // within one level intervals are pairwise disjoint, so child
        // boundary writes are disjoint — no races on lcp_out; end_slot can
        // only be claimed by one interval per level.
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads) if (parallel_level)
#endif
        {
#ifdef _OPENMP
            int tid = omp_get_thread_num();
#else
            int tid = 0;
#endif
            vector<IV>& out = locals[tid];
            // Per-interval work is a dependent chain of ~4 cache misses
            // (run_of probes -> run scan -> boundary write) over arrays
            // far larger than cache, and levels are narrow (a few hundred
            // intervals), so one-at-a-time processing is latency-bound —
            // the same failure mode as the rank walk.  Process intervals
            // in windows of G: every stage advances all G chains one miss
            // with prefetches, keeping G misses in flight.
            constexpr int G = 16;
            int64_t L[G], H[G], slo[G], shi[G], jj[G];
            bool tm[G];
            vector<int64_t> rl((size_t)(K + 1) * G), rh((size_t)(K + 1) * G);
            const size_t m = cur.size();
            const size_t nblk = (m + 63) / 64;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
            for (size_t blk = 0; blk < nblk; ++blk) {
              const size_t qe = std::min(m, blk * 64 + 64);
              for (size_t w0 = blk * 64; w0 < qe; w0 += G) {
                const int W = (int)std::min((size_t)G, qe - w0);
                // stage A: sampled run_of(lo), all windows interleaved
                for (int w = 0; w < W; ++w) {
                    L[w] = cur[w0 + w].lo;
                    H[w] = cur[w0 + w].hi;
                    tm[w] = cur[w0 + w].term;
                    __builtin_prefetch(&A.sample[L[w] >> A.shift]);
                }
                for (int w = 0; w < W; ++w) {
                    slo[w] = A.sample[L[w] >> A.shift];
                    shi[w] = A.sample[(L[w] >> A.shift) + 1];
                    int64_t mid = slo[w] < shi[w]
                        ? (slo[w] + shi[w] + 1) >> 1 : slo[w];
                    __builtin_prefetch(&A.rec[(size_t)(mid * A.stride)]);
                }
                for (bool any = true; any; ) {
                    any = false;
                    for (int w = 0; w < W; ++w) {
                        if (slo[w] >= shi[w]) continue;
                        int64_t mid = (slo[w] + shi[w] + 1) >> 1;
                        if (A.cum_of(mid) <= L[w]) slo[w] = mid;
                        else shi[w] = mid - 1;
                        int64_t nx = slo[w] < shi[w]
                            ? (slo[w] + shi[w] + 1) >> 1 : slo[w];
                        __builtin_prefetch(&A.rec[(size_t)(nx * A.stride)]);
                        any |= slo[w] < shi[w];
                    }
                }
                // stage B: per-class ranks at lo, then lockstep run scans
                for (int w = 0; w < W; ++w) {
                    jj[w] = slo[w];
                    const int64_t* rj =
                        A.rec.data() + (size_t)(jj[w] * A.stride);
                    int64_t* rlw = rl.data() + (size_t)w * (K + 1);
                    int64_t* rhw = rh.data() + (size_t)w * (K + 1);
                    for (int64_t c = 1; c <= K; ++c)
                        rlw[c] = rhw[c] = rj[c];
                    uint8_t cj = (uint8_t)(rj[0] & 0xff);
                    if (cj >= 1) rlw[cj] += L[w] - (rj[0] >> 8);
                }
                for (bool any = true; any; ) {
                    any = false;
                    for (int w = 0; w < W; ++w) {
                        if (jj[w] >= A.r || A.cum_of(jj[w]) >= H[w])
                            continue;
                        const int64_t* rj =
                            A.rec.data() + (size_t)(jj[w] * A.stride);
                        uint8_t cj = (uint8_t)(rj[0] & 0xff);
                        if (cj >= 1) {
                            int64_t end =
                                std::min(H[w], A.cum_of(jj[w] + 1));
                            rh[(size_t)w * (K + 1) + cj] =
                                rj[cj] + (end - (rj[0] >> 8));
                        }
                        ++jj[w];
                        __builtin_prefetch(
                            &A.rec[(size_t)(jj[w] * A.stride)]);
                        any |= jj[w] < A.r && A.cum_of(jj[w]) < H[w];
                    }
                }
                // stage C: child boundaries — prefetch the write targets,
                // then set/push.  Left-extend by real symbols only: a
                // terminator prepended to a nonempty string can never be
                // a common prefix (each terminator occurs once) — the
                // root already emitted the terminator block.
                for (int w = 0; w < W; ++w)
                    for (int64_t c = 1; c <= K; ++c) {
                        int64_t rhv = rh[(size_t)w * (K + 1) + c];
                        if (rhv > rl[(size_t)w * (K + 1) + c] &&
                            A.C[c] + rhv < n)
                            __builtin_prefetch(&lcp_out[A.C[c] + rhv]);
                    }
                for (int w = 0; w < W; ++w) {
                    const int64_t* rlw = rl.data() + (size_t)w * (K + 1);
                    const int64_t* rhw = rh.data() + (size_t)w * (K + 1);
                    for (int64_t c = 1; c <= K; ++c) {
                        if (rhw[c] <= rlw[c]) continue;
                        int64_t clo = A.C[c] + rlw[c];
                        int64_t chi = A.C[c] + rhw[c];
                        bool any = false;
                        if (tm[w]) {
                            for (int64_t p = clo + 1; p < chi; ++p)
                                if (lcp_out[p] < 0) {
                                    lcp_out[p] = (int32_t)depth;
                                    any = true;
                                }
                        }
                        if (chi < n) {
                            if (lcp_out[chi] < 0) {
                                lcp_out[chi] = (int32_t)depth;
                                any = true;
                            }
                        } else {
                            if (end_slot < 0) end_slot = (int32_t)depth;
                            // right-edge intervals (prefixes of the
                            // largest suffix — exactly one per level) and
                            // terminator groups always extend: their
                            // descendants' sets are unreachable any other
                            // way, and the extra work is bounded by
                            // |largest suffix| resp. n.
                            any = true;
                        }
                        if (any || tm[w]) out.push_back({clo, chi, tm[w]});
                    }
                }
              }
            }
        }
        for (auto& v : locals)
            nxt.insert(nxt.end(), v.begin(), v.end());
        if (stats) {
            st_levels += 1;
            st_ivs += (int64_t)cur.size();
            if (cur.size() < 16) st_narrow_levels += 1;
        }
        cur.swap(nxt);
        ++depth;
    }
    if (stats)
        fprintf(stderr,
                "[lcp-stats] levels=%lld narrow=%lld intervals=%lld "
                "max_depth=%lld\n",
                (long long)st_levels, (long long)st_narrow_levels,
                (long long)st_ivs, (long long)depth);
}

}  // extern "C"
