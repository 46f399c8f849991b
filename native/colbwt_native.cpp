// Native single-core reference engine + IO helpers for colbwt_tpu.
//
// query_pml_serial reproduces the reference's query loop semantics
// (col_pml::_query_pml at include/col_bwt.hpp:498-529 of drnatebrown/col-bwt:
// per-base backward scan, threshold repositioning with linear pred/succ run
// scans per include/ds/LF_table.hpp:271-298, LF fast-forward walk per
// :251-262) against the same structure-of-arrays table the device engines
// use.  It is the single-core C++ baseline that bench.py measures the device
// against and the exactness reference of chip_smoke.py — intentionally the
// reference's algorithmic shape (linear scans, no jump tables), not ours.
//
// Build: make -C native   (produces libcolbwt_native.so, loaded via ctypes)

#include <cstdint>
#include <cstring>

namespace {

struct Table {
    const uint8_t* chr;
    const int64_t* idx;
    const int64_t* len;
    const int64_t* dest_interval;
    const int64_t* dest_offset;
    const uint8_t* col_id;
    const int64_t* threshold;
    int64_t r;
    int64_t n;
};

inline int64_t get_length(const Table& t, int64_t i) {
    return t.len[i];
}

// include/ds/LF_table.hpp:251-262
inline void lf_step(const Table& t, int64_t& interval, int64_t& offset) {
    int64_t di = t.dest_interval[interval];
    int64_t doff = t.dest_offset[interval] + offset;
    while (doff >= get_length(t, di)) {
        doff -= get_length(t, di);
        ++di;
    }
    interval = di;
    offset = doff;
}

// include/ds/LF_table.hpp:271-283 — linear scan downward
inline bool pred_char(const Table& t, int64_t run, uint8_t c,
                      int64_t& out_run, int64_t& out_off) {
    while (t.chr[run] != c) {
        if (run == 0) return false;
        --run;
    }
    out_run = run;
    out_off = get_length(t, run) - 1;
    return true;
}

// include/ds/LF_table.hpp:286-298 — linear scan upward
inline bool succ_char(const Table& t, int64_t run, uint8_t c,
                      int64_t& out_run, int64_t& out_off) {
    while (t.chr[run] != c) {
        if (run == t.r - 1) return false;
        ++run;
    }
    out_run = run;
    out_off = 0;
    return true;
}

// include/col_bwt.hpp:531-574
inline void threshold_step(const Table& t, int64_t& interval, int64_t& offset,
                           int64_t pos, uint8_t c) {
    int64_t new_interval = interval;
    int64_t new_offset = offset;
    int64_t thr = t.n;

    int64_t si, so;
    bool has_succ = succ_char(t, interval, c, si, so);
    if (has_succ) {
        thr = t.threshold[si];
        new_interval = si;
        new_offset = so;
    }
    if (pos < thr) {
        int64_t pi, po;
        if (pred_char(t, interval, c, pi, po)) {
            new_interval = pi;
            new_offset = po;
        }
    }
    interval = new_interval;
    offset = new_offset;
}

}  // namespace

extern "C" {

// Per-read PML+CID (include/col_bwt.hpp:498-529).  patterns is the
// concatenation of all reads; read i spans [pat_offsets[i], pat_offsets[i+1]).
// Outputs are written at the same offsets.
void query_pml_serial(
    const uint8_t* chr, const int64_t* idx, const int64_t* len,
    const int64_t* dest_interval, const int64_t* dest_offset,
    const uint8_t* col_id, const int64_t* threshold,
    int64_t r, int64_t n,
    const uint8_t* patterns, const int64_t* pat_offsets, int64_t num_reads,
    int32_t* pml_out, int32_t* cid_out) {
    Table t{chr, idx, len, dest_interval, dest_offset, col_id, threshold, r, n};
    for (int64_t rd = 0; rd < num_reads; ++rd) {
        const uint8_t* pat = patterns + pat_offsets[rd];
        int64_t m = pat_offsets[rd + 1] - pat_offsets[rd];
        int32_t* pml = pml_out + pat_offsets[rd];
        int32_t* cid = cid_out + pat_offsets[rd];

        int64_t pos = t.n - 1;
        int64_t interval = t.r - 1;
        int64_t offset = get_length(t, interval) - 1;
        int64_t length = 0;

        for (int64_t i = 0; i < m; ++i) {
            uint8_t c = pat[m - i - 1];
            int64_t cid_val = t.col_id[interval];
            if (t.chr[interval] == c) {
                ++length;
            } else {
                length = 0;
                threshold_step(t, interval, offset, pos, c);
            }
            pml[m - i - 1] = static_cast<int32_t>(length);
            cid[m - i - 1] = static_cast<int32_t>(cid_val);
            lf_step(t, interval, offset);
            pos = t.idx[interval] + offset;
        }
    }
}

// Fast run-length encode of a byte buffer: writes run heads + lengths,
// returns the run count (rlbwt_to_bwt's inverse; used by the IO layer).
int64_t rle_encode(const uint8_t* data, int64_t size,
                   uint8_t* heads_out, int64_t* lens_out) {
    if (size == 0) return 0;
    int64_t runs = 0;
    uint8_t cur = data[0];
    int64_t len = 1;
    for (int64_t i = 1; i < size; ++i) {
        if (data[i] == cur) {
            ++len;
        } else {
            heads_out[runs] = cur;
            lens_out[runs] = len;
            ++runs;
            cur = data[i];
            len = 1;
        }
    }
    heads_out[runs] = cur;
    lens_out[runs] = len;
    return runs + 1;
}

// Kasai LCP in native code (the host-side O(n) construction fallback;
// semantics of ops/oracle.lcp_kasai).
void lcp_kasai(const int64_t* ranks, const int64_t* sa, int64_t n,
               int64_t* lcp_out) {
    int64_t* inv = new int64_t[n];
    for (int64_t i = 0; i < n; ++i) inv[sa[i]] = i;
    int64_t h = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t p = inv[i];
        if (p > 0) {
            int64_t j = sa[p - 1];
            while (i + h < n && j + h < n && ranks[i + h] == ranks[j + h]) ++h;
            lcp_out[p] = h;
            if (h > 0) --h;
        } else {
            lcp_out[p] = 0;
            h = 0;
        }
    }
    delete[] inv;
}

// FASTQ slab scanning (the kseq role for FASTQ, reference
// include/common/io.hpp:6-35).  Records are '@name / sequence lines / +
// separator / quality bytes totaling the sequence length'.  Only COMPLETE
// records are reported; *consumed is the offset just past the last
// complete record, so slab streaming can carry the partial tail — a
// byte-level boundary search is unsound for FASTQ because '@' is a legal
// quality character.  With fill == 0 this is the counting pass (output
// pointers may be null); both passes compute identical *consumed.
int64_t fastq_scan(const uint8_t* data, int64_t size, int64_t* consumed,
                   int32_t fill, uint8_t* seq_out,
                   int64_t* name_off, int64_t* name_len,
                   int64_t* seq_off, int64_t* seq_len) {
    int64_t count = 0;
    *consumed = 0;
    int64_t i = 0, out = 0;
    while (i < size) {
        while (i < size && (data[i] == '\n' || data[i] == '\r')) ++i;
        if (i >= size) break;
        if (data[i] != '@') {  // stray line: skip it (lenient, like kseq)
            while (i < size && data[i] != '\n') ++i;
            continue;
        }
        ++i;
        int64_t noff = i;
        while (i < size && data[i] != '\n' && data[i] != ' '
               && data[i] != '\t' && data[i] != '\r') ++i;
        int64_t nlen = i - noff;
        while (i < size && data[i] != '\n') ++i;  // rest of header
        if (i >= size) break;                      // header cut by slab end
        ++i;
        // sequence lines until the '+' separator line
        int64_t slen = 0;
        int64_t sout = out;
        bool plus = false, cut = false;
        while (i < size) {
            if (data[i] == '+') {
                plus = true;
                while (i < size && data[i] != '\n') ++i;
                if (i >= size) cut = true; else ++i;
                break;
            }
            int64_t ls = i;
            while (i < size && data[i] != '\n') ++i;
            if (i >= size) { cut = true; break; }  // line cut by slab end
            int64_t len = i - ls;
            if (len > 0 && data[ls + len - 1] == '\r') --len;
            if (fill && len > 0) memcpy(seq_out + out, data + ls, len);
            out += len;
            slen += len;
            ++i;
        }
        if (!plus || cut) break;
        // quality: non-newline bytes until the sequence length is covered
        int64_t q = 0;
        while (i < size && q < slen) {
            if (data[i] != '\n' && data[i] != '\r') ++q;
            ++i;
        }
        if (q < slen) break;  // quality cut by slab end
        if (fill) {
            name_off[count] = noff;
            name_len[count] = nlen;
            seq_off[count] = sout;
            seq_len[count] = slen;
        }
        ++count;
        *consumed = i;
    }
    return count;
}

}  // extern "C"


extern "C" {

// Buffered FASTA parsing (the kseq role, include/common/io.hpp:6-35 of the
// reference).  Pass 1: count records.  Pass 2: compact sequence bytes into
// seq_out (newlines stripped) and fill per-record (name_off, name_len,
// seq_off, seq_len); offsets into `data` for names, into seq_out for
// sequences.  Returns total compacted sequence bytes.
int64_t fasta_count(const uint8_t* data, int64_t size) {
    int64_t count = 0;
    bool at_line_start = true;
    for (int64_t i = 0; i < size; ++i) {
        if (at_line_start && data[i] == '>') ++count;
        at_line_start = (data[i] == '\n');
    }
    return count;
}

int64_t fasta_parse(const uint8_t* data, int64_t size, uint8_t* seq_out,
                    int64_t* name_off, int64_t* name_len,
                    int64_t* seq_off, int64_t* seq_len) {
    int64_t rec = -1;
    int64_t out = 0;
    int64_t i = 0;
    while (i < size) {
        if (data[i] == '>') {
            ++rec;
            ++i;
            name_off[rec] = i;
            while (i < size && data[i] != '\n' && data[i] != ' '
                   && data[i] != '\t' && data[i] != '\r') ++i;
            name_len[rec] = i - name_off[rec];
            while (i < size && data[i] != '\n') ++i;  // rest of header
            ++i;
            seq_off[rec] = out;
            seq_len[rec] = 0;
        } else {
            int64_t line_start = i;
            while (i < size && data[i] != '\n') ++i;
            int64_t len = i - line_start;
            if (len > 0 && data[line_start + len - 1] == '\r') --len;
            if (rec >= 0 && len > 0) {
                memcpy(seq_out + out, data + line_start, len);
                out += len;
                seq_len[rec] += len;
            }
            ++i;
        }
    }
    return out;
}

}  // extern "C"
