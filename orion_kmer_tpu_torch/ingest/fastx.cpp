// Native FASTA/FASTQ tokenizer + 2-bit packer.
//
// Host-side ingest hot path (the C++ counterpart of the reference's
// needletail parser, orion-kmer count.rs:63 / build.rs:42): parses an
// in-memory (already decompressed) buffer and emits, in one pass:
//   * a 2-bit code stream (0..3, 255 = invalid base) with `sep` invalid
//     positions inserted between records so no k-mer window can span two
//     records -- directly consumable by the device extraction kernel
//   * per-record code-end offsets (for window->read ownership)
//   * record ids (header lines) as a blob + end offsets
//
// Two base LUT modes mirror the engine's semantics:
//   normalize=1 (count/build/classify): case-insensitive ACGT, U/u -> T
//   normalize=0 (query, raw bytes):     case-insensitive ACGT only
//
// Build: g++ -O3 -shared -fPIC -o libokt_fastx.so fastx.cpp

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t INVALID = 255;

struct Luts {
    uint8_t norm[256];
    uint8_t raw[256];
    Luts() {
        std::memset(norm, INVALID, sizeof(norm));
        std::memset(raw, INVALID, sizeof(raw));
        const char* bases = "ACGT";
        for (int i = 0; i < 4; ++i) {
            uint8_t u = (uint8_t)bases[i];
            uint8_t l = (uint8_t)(bases[i] + 32);
            norm[u] = norm[l] = (uint8_t)i;
            raw[u] = raw[l] = (uint8_t)i;
        }
        norm[(uint8_t)'U'] = norm[(uint8_t)'u'] = 3;  // needletail normalize: U->T
    }
};
const Luts kLuts;

struct Cursor {
    const uint8_t* p;
    const uint8_t* end;
    bool last_nl = false;  // did the last line end with '\n'?
    bool eof() const { return p >= end; }
    // Returns [line_start, line_end) excluding trailing \r, advances past \n.
    bool next_line(const uint8_t*& s, const uint8_t*& e) {
        if (eof()) return false;
        s = p;
        const uint8_t* nl = (const uint8_t*)memchr(p, '\n', (size_t)(end - p));
        if (nl) {
            e = nl;
            p = nl + 1;
            last_nl = true;
        } else {
            e = end;
            p = end;
            last_nl = false;
        }
        if (e > s && e[-1] == '\r') --e;
        return true;
    }
};

struct Out {
    uint8_t* codes;
    int64_t codes_cap;
    int64_t codes_len = 0;
    int64_t* rec_code_end;
    uint8_t* id_blob;
    int64_t id_cap;
    int64_t id_len = 0;
    int64_t* id_end;
    int64_t max_records;
    int64_t n_records = 0;
    int64_t sep;
    const uint8_t* lut;

    bool add_record_id(const uint8_t* s, const uint8_t* e) {
        if (n_records >= max_records) return false;
        int64_t len = e - s;
        if (id_len + len > id_cap) return false;
        std::memcpy(id_blob + id_len, s, (size_t)len);
        id_len += len;
        id_end[n_records] = id_len;
        return true;
    }
    bool add_seq_line(const uint8_t* s, const uint8_t* e) {
        int64_t len = e - s;
        if (codes_len + len > codes_cap) return false;
        uint8_t* dst = codes + codes_len;
        for (int64_t i = 0; i < len; ++i) dst[i] = lut[s[i]];
        codes_len += len;
        return true;
    }
    bool end_record() {
        if (codes_len + sep > codes_cap) return false;
        std::memset(codes + codes_len, INVALID, (size_t)sep);
        codes_len += sep;
        rec_code_end[n_records] = codes_len - sep;  // end of this record's bases
        ++n_records;
        return true;
    }
};

}  // namespace

extern "C" {

// Error codes
enum {
    OKT_OK = 0,
    OKT_EMPTY = -1,
    OKT_UNKNOWN_FORMAT = -2,
    OKT_MALFORMED = -3,
    OKT_CAPACITY = -4,
    OKT_BADCOUNT = -5,
};

// Incremental chunk parse.  With eof=0 the buffer is a chunk of a
// larger stream: the trailing incomplete record (a FASTA record is only
// complete when the next '>' or EOF is seen; a FASTQ record when all 4
// lines are newline-terminated) is ROLLED BACK and out[3] reports the
// byte offset it starts at, so the caller carries buf[consumed:] into
// the next chunk.  With eof=1 behavior matches the original whole-file
// parse (truncation is malformed, emptiness is an error).  This is the
// streaming contract of the reference's BufRead + per-record loop
// (orion-kmer utils.rs:125-152, count.rs:63-79): memory stays O(chunk),
// never O(file).
//
// out[0]=n_records, out[1]=codes_len, out[2]=id_len, out[3]=consumed
long okt_parse_fastx(const uint8_t* data, long len, int normalize, long sep,
                     int eof, uint8_t* codes, long codes_cap,
                     int64_t* rec_code_end, uint8_t* id_blob, long id_cap,
                     int64_t* id_end, long max_records, int64_t* out) {
    out[0] = out[1] = out[2] = 0;
    out[3] = len;
    // skip leading whitespace to find the format marker
    const uint8_t* q = data;
    const uint8_t* qend = data + len;
    while (q < qend && (*q == '\n' || *q == '\r' || *q == ' ' || *q == '\t')) ++q;
    if (q >= qend) return eof ? OKT_EMPTY : OKT_OK;

    Out o;
    o.codes = codes;
    o.codes_cap = codes_cap;
    o.rec_code_end = rec_code_end;
    o.id_blob = id_blob;
    o.id_cap = id_cap;
    o.id_end = id_end;
    o.max_records = max_records;
    o.sep = sep;
    o.lut = normalize ? kLuts.norm : kLuts.raw;

    Cursor cur{q, qend};
    const uint8_t *s, *e;
    int64_t consumed = len;

    if (*q == '>') {
        // FASTA: header lines start records; sequence may span lines.
        bool in_record = false;
        const uint8_t* rec_start = q;
        int64_t snap_codes = 0, snap_id = 0;
        while (cur.next_line(s, e)) {
            if (s < e && *s == '>') {
                if (in_record && !o.end_record()) return OKT_CAPACITY;
                rec_start = s;
                snap_codes = o.codes_len;
                snap_id = o.id_len;
                if (!o.add_record_id(s + 1, e)) return OKT_CAPACITY;
                in_record = true;
            } else if (s < e) {
                if (!in_record) return OKT_MALFORMED;
                if (!o.add_seq_line(s, e)) return OKT_CAPACITY;
            }
        }
        if (in_record) {
            if (eof) {
                if (!o.end_record()) return OKT_CAPACITY;
            } else {
                // record may continue in the next chunk: roll it back
                o.codes_len = snap_codes;
                o.id_len = snap_id;
                consumed = rec_start - data;
            }
        }
    } else if (*q == '@') {
        // FASTQ: strict 4-line records.
        while (true) {
            const uint8_t* rec_start = cur.p;
            int64_t snap_codes = o.codes_len, snap_id = o.id_len;
            if (!cur.next_line(s, e)) break;
            if (s == e) continue;  // tolerate blank lines between records
            bool incomplete = false;
            if (*s != '@') return OKT_MALFORMED;
            if (!cur.last_nl && !eof) {
                incomplete = true;  // header cut mid-line
            } else {
                if (!o.add_record_id(s + 1, e)) return OKT_CAPACITY;
                const uint8_t *ss, *se;
                if (!cur.next_line(ss, se) || (!cur.last_nl && !eof)) {
                    incomplete = true;  // sequence line missing or cut
                } else {
                    int64_t seq_len = se - ss;
                    if (!o.add_seq_line(ss, se)) return OKT_CAPACITY;
                    if (!cur.next_line(s, e) || (!cur.last_nl && !eof)) {
                        incomplete = true;  // '+' line missing or cut
                    } else if (s == e || *s != '+') {
                        return OKT_MALFORMED;
                    } else if (!cur.next_line(s, e) || (!cur.last_nl && !eof)) {
                        incomplete = true;  // quality line missing or cut
                    } else if ((e - s) != seq_len) {
                        return OKT_MALFORMED;
                    } else if (!o.end_record()) {
                        return OKT_CAPACITY;
                    }
                }
            }
            if (incomplete) {
                if (eof) return OKT_MALFORMED;
                o.codes_len = snap_codes;
                o.id_len = snap_id;
                consumed = rec_start - data;
                break;
            }
        }
    } else {
        return OKT_UNKNOWN_FORMAT;
    }

    if (o.n_records == 0 && eof) return OKT_EMPTY;
    out[0] = o.n_records;
    out[1] = o.codes_len;
    out[2] = o.id_len;
    out[3] = consumed;
    return OKT_OK;
}

// Pack a 2-bit code stream (0..3 valid, anything >3 invalid) into the
// device wire format (engine.pack_for_transfer semantics): 16 bases per
// u32 lane, base j at bits 2j..2j+1 (invalid bases contribute 0 bits),
// plus a 1-bit-per-base invalid bitmap, 32 flags per u32 little-endian.
// `size` (multiple of 32) >= n; positions n..size are padding = invalid.
// Replaces the numpy shift loop (~195 Mbases/s single-core) on the
// host's critical path.
long okt_pack_wire(const uint8_t* codes, long n, long size,
                   uint32_t* lanes, uint32_t* invalid_words) {
    if (size % 32 != 0 || n > size) return OKT_CAPACITY;
    long full_words = n / 32;  // invalid-bitmap words with all-real bases
    for (long w = 0; w < full_words; ++w) {
        const uint8_t* c = codes + w * 32;
        uint32_t lane0 = 0, lane1 = 0, inv = 0;
        for (int j = 0; j < 16; ++j) {
            uint8_t a = c[j];
            uint8_t b = c[16 + j];
            uint32_t abad = a > 3, bbad = b > 3;
            lane0 |= (uint32_t)(abad ? 0u : a) << (2 * j);
            lane1 |= (uint32_t)(bbad ? 0u : b) << (2 * j);
            inv |= (abad << j) | (bbad << (16 + j));
        }
        lanes[2 * w] = lane0;
        lanes[2 * w + 1] = lane1;
        invalid_words[w] = inv;
    }
    // tail: remaining real codes + padding
    for (long w = full_words; w < size / 32; ++w) {
        uint32_t lane0 = 0, lane1 = 0, inv = 0;
        for (int j = 0; j < 32; ++j) {
            long pos = w * 32 + j;
            uint8_t v = pos < n ? codes[pos] : INVALID;
            uint32_t bad = v > 3;
            uint32_t code = bad ? 0u : v;
            if (j < 16) lane0 |= code << (2 * j);
            else lane1 |= code << (2 * (j - 16));
            inv |= bad << j;
        }
        lanes[2 * w] = lane0;
        lanes[2 * w + 1] = lane1;
        invalid_words[w] = inv;
    }
    return OKT_OK;
}

// Pack S code rows (each `stride` bytes, with a separate invalid-flag
// byte mask) into S wire-format rows of `size` positions each, in one
// native pass -- replaces S Python-loop pack_for_transfer calls (plus
// their np.where masking) in the sharded update path on 1-core hosts.
// codes[s*stride + j] is position j of shard s; invalid[s*stride + j]
// nonzero forces the position invalid even when the code is 0..3
// (block tail padding).  Positions stride..size are padding = invalid.
long okt_pack_wire_multi(const uint8_t* codes, const uint8_t* invalid,
                         long n_rows, long stride, long size,
                         uint32_t* lanes, uint32_t* invalid_words) {
    if (size % 32 != 0 || stride > size) return OKT_CAPACITY;
    for (long r = 0; r < n_rows; ++r) {
        const uint8_t* c = codes + r * stride;
        const uint8_t* iv = invalid + r * stride;
        uint32_t* lrow = lanes + r * (size / 16);
        uint32_t* irow = invalid_words + r * (size / 32);
        long full_words = stride / 32;
        for (long w = 0; w < full_words; ++w) {
            const uint8_t* cc = c + w * 32;
            const uint8_t* ii = iv + w * 32;
            uint32_t lane0 = 0, lane1 = 0, inv = 0;
            for (int j = 0; j < 16; ++j) {
                uint8_t a = cc[j];
                uint8_t b = cc[16 + j];
                uint32_t abad = (a > 3) | (ii[j] != 0);
                uint32_t bbad = (b > 3) | (ii[16 + j] != 0);
                lane0 |= (uint32_t)(abad ? 0u : a) << (2 * j);
                lane1 |= (uint32_t)(bbad ? 0u : b) << (2 * j);
                inv |= (abad << j) | (bbad << (16 + j));
            }
            lrow[2 * w] = lane0;
            lrow[2 * w + 1] = lane1;
            irow[w] = inv;
        }
        for (long w = full_words; w < size / 32; ++w) {
            uint32_t lane0 = 0, lane1 = 0, inv = 0;
            for (int j = 0; j < 32; ++j) {
                long pos = w * 32 + j;
                uint8_t v = pos < stride ? c[pos] : INVALID;
                uint32_t bad = (v > 3) | (pos < stride && iv[pos] != 0);
                uint32_t code = bad ? 0u : v;
                if (j < 16) lane0 |= code << (2 * j);
                else lane1 |= code << (2 * (j - 16));
                inv |= bad << j;
            }
            lrow[2 * w] = lane0;
            lrow[2 * w + 1] = lane1;
            irow[w] = inv;
        }
    }
    return OKT_OK;
}

// Merge two sorted-unique (vals u64, counts i64) runs, summing counts
// of values present in both -- the host overflow tier of the LSM count
// table (engine.CountAccumulator; one-count-per-key semantics of the
// reference's count.rs:106-135).  A linear two-pointer pass: the numpy
// searchsorted interleave this replaces ran at ~2.2M elems/s on the
// 1-core host (binary searches, cache-hostile); this is a sequential
// memory-bound scan.  out_v/out_c must hold n1 + n2; returns the number
// of merged uniques.
long okt_merge_unique(const uint64_t* v1, const int64_t* c1, long n1,
                      const uint64_t* v2, const int64_t* c2, long n2,
                      uint64_t* out_v, int64_t* out_c) {
    long i = 0, j = 0, o = 0;
    while (i < n1 && j < n2) {
        uint64_t a = v1[i], b = v2[j];
        if (a < b) {
            out_v[o] = a;
            out_c[o++] = c1[i++];
        } else if (b < a) {
            out_v[o] = b;
            out_c[o++] = c2[j++];
        } else {
            out_v[o] = a;
            out_c[o++] = c1[i++] + c2[j++];
        }
    }
    while (i < n1) {
        out_v[o] = v1[i];
        out_c[o++] = c1[i++];
    }
    while (j < n2) {
        out_v[o] = v2[j];
        out_c[o++] = c2[j++];
    }
    return o;
}

// K-way variant: merge r sorted-unique runs in ONE pass with ONE output
// allocation.  On this VM first-touch page faults on a fresh output
// buffer cost ~10x the merge scan itself (measured ~4.4 s faults vs
// 0.3 s scan at 2x20M), so a pairwise reduction pays that fault bill
// once per level; the k-way pass pays it once total.  Linear head scan
// per output element -- O(N*r), fine for the accumulator's small run
// counts (consolidation bounds r); callers cap r.
long okt_merge_unique_kway(const uint64_t* const* vs, const int64_t* const* cs,
                           const long* ns, long r,
                           uint64_t* out_v, int64_t* out_c) {
    long* idx = new long[r];
    for (long i = 0; i < r; ++i) idx[i] = 0;
    long o = 0;
    long live = 0;
    for (long i = 0; i < r; ++i) live += (ns[i] > 0);
    while (live > 1) {
        uint64_t m = ~0ull;
        for (long i = 0; i < r; ++i)
            if (idx[i] < ns[i] && vs[i][idx[i]] < m) m = vs[i][idx[i]];
        int64_t cnt = 0;
        for (long i = 0; i < r; ++i) {
            if (idx[i] < ns[i] && vs[i][idx[i]] == m) {
                cnt += cs[i][idx[i]];
                if (++idx[i] == ns[i]) --live;
            }
        }
        out_v[o] = m;
        out_c[o++] = cnt;
    }
    for (long i = 0; i < r; ++i) {
        long rem = ns[i] - idx[i];
        if (rem > 0) {
            std::memcpy(out_v + o, vs[i] + idx[i], rem * sizeof(uint64_t));
            std::memcpy(out_c + o, cs[i] + idx[i], rem * sizeof(int64_t));
            o += rem;
        }
    }
    delete[] idx;
    return o;
}

// Decode (vals u64, counts i64) into "KMER\tCOUNT\n" ASCII lines
// (count.rs:127-135 output format; byte-identical to the Python
// codec.u64s_to_seqs + f-string path it accelerates -- that path
// measured 0.83M lines/s on this host, ~48 s for a 40M-unique table).
// Returns bytes written, OKT_CAPACITY if out is too small, or
// OKT_BADCOUNT on a count <= 0: pipeline counts are >= 1 by
// construction, so a non-positive value is table corruption and must
// fail loudly rather than be serialized as a fabricated line.
long okt_write_counts_tsv(const uint64_t* vals, const int64_t* counts, long n,
                          int k, uint8_t* out, long cap) {
    static const char BASES[4] = {'A', 'C', 'G', 'T'};
    long o = 0;
    for (long i = 0; i < n; ++i) {
        if (o + k + 22 > cap) return OKT_CAPACITY;
        uint64_t v = vals[i];
        for (int j = k - 1; j >= 0; --j) {
            out[o + j] = BASES[v & 3];
            v >>= 2;
        }
        o += k;
        out[o++] = '\t';
        char tmp[20];
        int t = 0;
        int64_t c = counts[i];
        if (c <= 0) {
            return OKT_BADCOUNT;
        } else {
            while (c > 0) {
                tmp[t++] = (char)('0' + (c % 10));
                c /= 10;
            }
            while (t > 0) out[o++] = tmp[--t];
        }
        out[o++] = '\n';
    }
    return o;
}

// The fused tail of `count`: over one chunk of sorted (vals u64, counts
// i64) rows, render the rows whose count is >= min_count as
// "KMER\tCOUNT\n" lines (count.rs:127-135; byte-identical to the Python
// codec.u64s_to_seqs + f-string path), and, when hist is not null, add
// every row's count, kept or not, into hist[count] for 1 <= count <=
// hist_cap: `count --histogram` is taken over all rows, before the
// filter.  Counts outside [1, hist_cap] are left to the caller, which
// finds them in the chunk; their number goes to *n_outside.  With out
// null nothing is rendered.  Returns bytes written, OKT_CAPACITY if out
// is too small, or OKT_BADCOUNT on a kept row whose count is <= 0:
// pipeline counts are >= 1 by construction, so a non-positive value is
// table corruption and must fail loudly rather than be serialized as a
// fabricated line.  Chunks are independent, so callers render several
// at once on threads (ctypes releases the GIL around the call).
long okt_render_counts(const uint64_t* vals, const int64_t* counts, long n,
                       int k, int64_t min_count, uint8_t* out, long cap,
                       int64_t* hist, long hist_cap, long* n_outside) {
    // four bases a byte of the value, most significant first
    static const struct Quads {
        uint32_t q[256];
        Quads() {
            static const char BASES[4] = {'A', 'C', 'G', 'T'};
            for (int b = 0; b < 256; ++b) {
                char s[4] = {BASES[(b >> 6) & 3], BASES[(b >> 4) & 3],
                             BASES[(b >> 2) & 3], BASES[b & 3]};
                std::memcpy(&q[b], s, 4);
            }
        }
    } quads;
    static const char BASES[4] = {'A', 'C', 'G', 'T'};
    long o = 0, outside = 0;
    for (long i = 0; i < n; ++i) {
        int64_t c = counts[i];
        if (hist != nullptr) {
            if (c >= 1 && c <= hist_cap) ++hist[c];
            else ++outside;
        }
        if (out == nullptr || c < min_count) continue;
        if (c <= 0) return OKT_BADCOUNT;
        if (o + k + 22 > cap) return OKT_CAPACITY;
        uint64_t v = vals[i];
        int j = k;
        for (; j >= 4; j -= 4) {
            std::memcpy(out + o + j - 4, &quads.q[v & 255], 4);
            v >>= 8;
        }
        for (; j > 0; --j) {
            out[o + j - 1] = BASES[v & 3];
            v >>= 2;
        }
        o += k;
        out[o++] = '\t';
        char tmp[20];
        int t = 0;
        while (c > 0) {
            tmp[t++] = (char)('0' + (c % 10));
            c /= 10;
        }
        while (t > 0) out[o++] = tmp[--t];
        out[o++] = '\n';
    }
    if (n_outside != nullptr) *n_outside = outside;
    return o;
}

}  // extern "C"
