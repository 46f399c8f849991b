// SA-IS: linear-time suffix array by induced sorting (Nong, Zhang & Chan),
// implemented from scratch for integer alphabets.
//
// Role: host-side suffix sorting for index construction — the same job
// libdivsufsort / prefix-free parsing performs inside the reference's
// mumemto stage (thirdparty/CMakeLists.txt:51-69, SURVEY §2.2).  The input
// is the int rank text of oracle.concat_collection (distinct separator
// ranks), end-of-string sorting smaller than every symbol.
//
// The core is templated on the index/text integer type: SA-IS is memory-
// bound (the induce passes are data-dependent scattered stores over the
// whole SA), so running chunks that fit int32 in 4-byte arrays instead of
// 8-byte ones halves the random-access working set (a host-side
// measurement gave ~1.9x on gigabase chunks).  Chunked construction always
// fits: chunk_chars <= ~600M << 2^31.
//
// Differential-tested against the NumPy prefix-doubling oracle and the
// device suffix array.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using std::vector;

// s: integer string of length n over alphabet [0, K); SA: output length n.
template <typename I>
void sais_core(const I* s, I* SA, I n, I K) {
    if (n <= 0) return;
    if (n == 1) { SA[0] = 0; return; }

    // classify: t[i] = 1 if suffix i is S-type
    vector<uint8_t> t(n);
    t[n - 1] = 1;  // last suffix is S by the sentinel convention
    for (I i = n - 2; i >= 0; --i)
        t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);

    auto is_lms = [&](I i) {
        return i > 0 && t[i] && !t[i - 1];
    };

    // bucket sizes: counted once, rebuilt into start/end offsets per pass
    vector<I> counts(K, 0);
    for (I i = 0; i < n; ++i) ++counts[s[i]];
    vector<I> bkt(K);
    auto get_buckets = [&](bool end) {
        I sum = 0;
        for (I c = 0; c < K; ++c) {
            sum += counts[c];
            bkt[c] = end ? sum : sum - counts[c];
        }
    };

    auto induce = [&]() {
        // L-type from left
        get_buckets(false);
        for (I i = 0; i < n; ++i) {
            I j = SA[i] - 1;
            if (SA[i] > 0 && !t[j]) SA[bkt[s[j]]++] = j;
        }
        // S-type from right
        get_buckets(true);
        for (I i = n - 1; i >= 0; --i) {
            I j = SA[i] - 1;
            if (SA[i] > 0 && t[j]) SA[--bkt[s[j]]] = j;
        }
    };

    // stage 1: place LMS suffixes at bucket ends, induce
    std::fill(SA, SA + n, (I)-1);
    get_buckets(true);
    for (I i = n - 1; i >= 1; --i)
        if (is_lms(i)) SA[--bkt[s[i]]] = i;
    induce();

    // compact sorted LMS positions into SA[0..n1)
    I n1 = 0;
    for (I i = 0; i < n; ++i)
        if (is_lms(SA[i])) SA[n1++] = SA[i];

    // name LMS substrings
    std::fill(SA + n1, SA + n, (I)-1);
    I name = 0, prev = -1;
    for (I i = 0; i < n1; ++i) {
        I pos = SA[i];
        bool diff = false;
        if (prev == -1) {
            diff = true;
        } else {
            for (I d = 0; d < n; ++d) {
                I a = pos + d, b = prev + d;
                if (a == n || b == n) { diff = (a != b); break; }
                if (s[a] != s[b] || t[a] != t[b]) { diff = true; break; }
                if (d > 0 && (is_lms(a) || is_lms(b))) {
                    diff = !(is_lms(a) && is_lms(b));
                    break;
                }
            }
        }
        if (diff) { ++name; prev = pos; }
        SA[n1 + pos / 2] = name - 1;
    }
    // gather names in text order
    for (I i = n - 1, j = n - 1; i >= n1; --i)
        if (SA[i] >= 0) SA[j--] = SA[i];

    // stage 2: sort the reduced problem
    I* s1 = SA + n - n1;
    if (name < n1) {
        sais_core<I>(s1, SA, n1, name);
    } else {
        for (I i = 0; i < n1; ++i) SA[s1[i]] = i;
    }

    // stage 3: map reduced SA back to LMS positions, induce final order
    vector<I> lms(n1);
    for (I i = 0, j = 0; i < n; ++i)
        if (is_lms(i)) lms[j++] = i;
    for (I i = 0; i < n1; ++i) SA[i] = lms[SA[i]];
    std::fill(SA + n1, SA + n, (I)-1);
    get_buckets(true);
    for (I i = n1 - 1; i >= 0; --i) {
        I j = SA[i];
        SA[i] = -1;
        SA[--bkt[s[j]]] = j;
    }
    induce();
}

}  // namespace

extern "C" {

// Suffix array of an int32 rank text with values >= 1 (values in [1, K));
// end-of-string compares smaller than every symbol — realized by appending
// a unique 0 sentinel internally (SA-IS requires it).  Requires
// n + 1 < 2^31.  This is the chunked-construction fast path: 4-byte
// arrays halve the induce passes' random-access working set.
void suffix_array_sais32(const int32_t* s, int64_t n, int64_t K,
                         int32_t* sa_out) {
    if (n <= 0) return;
    vector<int32_t> s2((size_t)n + 1);
    std::memcpy(s2.data(), s, (size_t)n * sizeof(int32_t));
    s2[n] = 0;
    vector<int32_t> sa2((size_t)n + 1);
    sais_core<int32_t>(s2.data(), sa2.data(), (int32_t)(n + 1), (int32_t)K);
    // sa2[0] == n (the sentinel); the rest is the answer
    std::memcpy(sa_out, sa2.data() + 1, (size_t)n * sizeof(int32_t));
}

// int64 entry (monolithic lane / values beyond int32).  Routes through the
// int32 core whenever the problem fits it — the conversion passes are
// sequential and cheap next to the ~2x induce speedup.
void suffix_array_sais(const int64_t* s, int64_t n, int64_t K,
                       int64_t* sa_out) {
    if (n <= 0) return;
    if (n + 1 < INT32_MAX && K < INT32_MAX) {
        vector<int32_t> s2((size_t)n + 1);
        for (int64_t i = 0; i < n; ++i) s2[i] = (int32_t)s[i];
        s2[n] = 0;
        vector<int32_t> sa2((size_t)n + 1);
        sais_core<int32_t>(s2.data(), sa2.data(), (int32_t)(n + 1),
                           (int32_t)K);
        for (int64_t i = 0; i < n; ++i) sa_out[i] = sa2[i + 1];
        return;
    }
    vector<int64_t> s2((size_t)n + 1);
    std::memcpy(s2.data(), s, (size_t)n * sizeof(int64_t));
    s2[n] = 0;
    vector<int64_t> sa2((size_t)n + 1);
    sais_core<int64_t>(s2.data(), sa2.data(), n + 1, K);
    std::memcpy(sa_out, sa2.data() + 1, (size_t)n * sizeof(int64_t));
}

}  // extern "C"
