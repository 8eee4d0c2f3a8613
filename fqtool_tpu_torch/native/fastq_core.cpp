// Copy of fqtool_tpu/native/fastq_core.cpp, unchanged: io/native.py of the
// port builds its own libfastq_core.so from it.
// fastq_core: native host-side FASTQ runtime.
//
// The TPU device pipeline consumes struct-of-array packs; this module is the
// native replacement for the per-record host work around it -- tokenizing
// FASTQ text into record spans, packing bases/qualities into fixed-shape
// matrices, and re-materializing output records from (select, start, len)
// index arithmetic.  It plays the role of the reference's FqReader/Writer hot
// loops (reference: src/fqreader.cpp:90-195, src/read.h:166-176) as a
// zero-copy batch transform.
//
// It also carries the native gzip codec (zlib streaming inflate/deflate)
// replacing the reference's gzread/gzwrite paths (reference:
// src/fqreader.cpp:28-49, src/writer.cpp:37-41): byte-identical output to
// the Python zlib fallback (same libz), callable from IO worker threads
// without the interpreter.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libfastq_core.so fastq_core.cpp -lz
// Exposed via ctypes (extern "C"), no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// gzip codec
// ---------------------------------------------------------------------------

// Streaming multi-member gzip inflater (wbits 47 = zlib|gzip autodetect).
void* gz_inflate_new() {
    z_stream* zs = (z_stream*)calloc(1, sizeof(z_stream));
    if (inflateInit2(zs, 47) != Z_OK) { free(zs); return nullptr; }
    return zs;
}

// Inflate as much of in[0..in_len) as fits into out[0..out_cap).
// Concatenated gzip members are handled transparently (inflateReset at each
// member boundary, like the multi-member Python fallback).  Returns bytes
// written, sets *in_used; *state = 0 ok, 1 clean end-of-stream with all
// input consumed, -1 corrupt stream.
int64_t gz_inflate(void* ctx, const uint8_t* in, int64_t in_len,
                   uint8_t* out, int64_t out_cap,
                   int64_t* in_used, int32_t* state) {
    z_stream* zs = (z_stream*)ctx;
    zs->next_in = (Bytef*)in;
    zs->avail_in = (uInt)in_len;
    zs->next_out = out;
    zs->avail_out = (uInt)out_cap;
    *state = 0;
    while (zs->avail_out > 0) {
        int rc = inflate(zs, Z_NO_FLUSH);
        if (rc == Z_STREAM_END) {
            if (zs->avail_in > 0) {
                if (inflateReset(zs) != Z_OK) { *state = -1; break; }
                continue;  // next gzip member
            }
            *state = 1;
            break;
        }
        if (rc == Z_OK || rc == Z_BUF_ERROR) {
            if (zs->avail_in == 0) break;  // need more input
            if (rc == Z_BUF_ERROR && zs->avail_out == 0) break;
            if (rc == Z_BUF_ERROR) { *state = -1; break; }
            continue;
        }
        *state = -1;
        break;
    }
    *in_used = in_len - (int64_t)zs->avail_in;
    return out_cap - (int64_t)zs->avail_out;
}

void gz_inflate_free(void* ctx) {
    z_stream* zs = (z_stream*)ctx;
    inflateEnd(zs);
    free(zs);
}

// Tokenize a FASTQ text buffer into up to max_records records.
//
// Semantics follow the reference reader (fqreader.cpp:160-195): blank lines
// and lines not starting with '@' are skipped while looking for a name line;
// '\r\n' and '\n' both terminate lines; a quality/sequence length mismatch
// stops the stream (returns the records parsed so far and sets *error = 1).
//
// Only complete records are consumed: *consumed is the byte offset just past
// the last complete record, so the caller can carry the tail over to the next
// buffer.  final_buffer != 0 means EOF follows this buffer and a trailing
// record without a final newline is accepted.
//
// Offsets/lengths are written per record for name (including '@'), sequence,
// strand line, and quality.
int64_t fq_parse(const char* buf, int64_t len, int64_t max_records,
                 int32_t final_buffer,
                 int64_t* name_off, int32_t* name_len,
                 int64_t* seq_off, int32_t* seq_len,
                 int64_t* strand_off, int32_t* strand_len,
                 int64_t* qual_off, int32_t* qual_len,
                 int64_t* consumed, int32_t* error) {
    int64_t pos = 0;
    int64_t n = 0;
    *error = 0;
    *consumed = 0;

    // Reference getLine semantics (fqreader.cpp:90-150): a line ends at the
    // FIRST of '\r' or '\n'; after consuming the terminator, one following
    // '\n' is swallowed -- which handles \r\n pairs AND merges an empty next
    // line into the break -- unless that '\n' is the buffer's last byte
    // (the reference's end < mBufDataLen-1 guard).  For non-final buffers we
    // wait for more bytes when the swallow decision would touch the last
    // byte, so the outcome never depends on our chunking.
    auto next_line = [&](int64_t& off, int64_t& llen) -> bool {
        if (pos >= len) return false;
        off = pos;
        int64_t end = pos;
        while (end < len && buf[end] != '\n' && buf[end] != '\r') ++end;
        if (end == len) {
            if (!final_buffer) return false;  // incomplete line, wait for more
            pos = len;
            llen = end - off;
            return true;
        }
        int64_t after = end + 1;
        if (after >= len - 1 && !final_buffer) return false;  // swallow undecided
        pos = after;
        if (pos < len - 1 && buf[pos] == '\n') ++pos;
        llen = end - off;
        return true;
    };

    while (n < max_records) {
        int64_t noff = 0, nlen = 0;
        // scan for a name line
        bool have = false;
        while (next_line(noff, nlen)) {
            if (nlen > 0 && buf[noff] == '@') { have = true; break; }
        }
        if (!have) break;
        int64_t soff = 0, slen = 0, toff = 0, tlen = 0, qoff = 0, qlen = 0;
        if (!next_line(soff, slen)) break;
        if (!next_line(toff, tlen)) { if (!final_buffer) break; toff = soff + slen; tlen = 0; }
        if (!next_line(qoff, qlen)) {
            if (!final_buffer) break;
            qoff = toff + tlen; qlen = 0;
        }
        if (qlen != slen) {
            *error = 1;
            *consumed = pos;
            return n;
        }
        name_off[n] = noff; name_len[n] = (int32_t)nlen;
        seq_off[n] = soff; seq_len[n] = (int32_t)slen;
        strand_off[n] = toff; strand_len[n] = (int32_t)tlen;
        qual_off[n] = qoff; qual_len[n] = (int32_t)qlen;
        ++n;
        *consumed = pos;
    }
    return n;
}

// Pack sequence/quality spans into zero-padded [n, width] matrices.
// phred64 != 0 converts quality to phred33 clamped at 33 (read.h:71-75).
void fq_pack(const char* buf, int64_t n,
             const int64_t* seq_off, const int32_t* seq_len,
             const int64_t* qual_off,
             uint8_t* seq_out, uint8_t* qual_out, int64_t width,
             int32_t phred64) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t l = seq_len[i];
        if (l > width) l = (int32_t)width;
        uint8_t* srow = seq_out + i * width;
        uint8_t* qrow = qual_out + i * width;
        memcpy(srow, buf + seq_off[i], (size_t)l);
        memset(srow + l, 0, (size_t)(width - l));
        memcpy(qrow, buf + qual_off[i], (size_t)l);
        memset(qrow + l, 0, (size_t)(width - l));
        if (phred64) {
            for (int32_t j = 0; j < l; ++j) {
                int q = (int)qrow[j] - 31;
                qrow[j] = (uint8_t)(q < 33 ? 33 : q);
            }
        }
    }
}

// Byte count needed by fq_format for the selected records.
int64_t fq_format_size(int64_t n, const uint8_t* select,
                       const char* names_buf,  // unused, kept for symmetry
                       const int32_t* name_len,
                       const int32_t* strand_len,
                       const int32_t* out_len,
                       const int32_t* tag_len) {
    (void)names_buf;
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (!select[i]) continue;
        total += (int64_t)name_len[i] + 1 + out_len[i] + 1 + strand_len[i] + 1
                 + out_len[i] + 1;
        if (tag_len) total += tag_len[i] ? (int64_t)tag_len[i] + 1 : 0;
    }
    return total;
}

// Materialize 4-line FASTQ records (read.h:166-176) for every selected read:
//   name [+ " " tag] \n  seq[start:start+len] \n  strand \n  qual[...] \n
// seq/qual come from [n, width] matrices; names/strands/tags from
// concatenated buffers with per-record offsets.  Returns bytes written.
int64_t fq_format(int64_t n, const uint8_t* select,
                  const char* names_buf, const int64_t* name_off, const int32_t* name_len,
                  const char* strands_buf, const int64_t* strand_off, const int32_t* strand_len,
                  const uint8_t* seq, const uint8_t* qual, int64_t width,
                  const int32_t* start, const int32_t* out_len,
                  const char* tags_buf, const int64_t* tag_off, const int32_t* tag_len,
                  char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        if (!select[i]) continue;
        memcpy(p, names_buf + name_off[i], (size_t)name_len[i]);
        p += name_len[i];
        if (tags_buf && tag_len[i]) {
            *p++ = ' ';
            memcpy(p, tags_buf + tag_off[i], (size_t)tag_len[i]);
            p += tag_len[i];
        }
        *p++ = '\n';
        int64_t s = start[i];
        int32_t l = out_len[i];
        memcpy(p, seq + i * width + s, (size_t)l);
        p += l;
        *p++ = '\n';
        memcpy(p, strands_buf + strand_off[i], (size_t)strand_len[i]);
        p += strand_len[i];
        *p++ = '\n';
        memcpy(p, qual + i * width + s, (size_t)l);
        p += l;
        *p++ = '\n';
    }
    return p - out;
}

// Like fq_format, but each record's seq/qual row comes from one of up to
// three content planes (plane_id / row_idx per record).  Serves the PE
// merged-stream (merged read OR kept r1 then r2 per pair,
// reference: src/peprocessor.cpp:355-385) and the failed-stream pair
// interleave (src/peprocessor.cpp:404-428) without materializing a
// [3n, max_width] interleaved copy of the three sources on the host.
int64_t fq_format_planes(
    int64_t n, const uint8_t* select,
    const char* names_buf, const int64_t* name_off, const int32_t* name_len,
    const char* strands_buf, const int64_t* strand_off, const int32_t* strand_len,
    const uint8_t* seq0, const uint8_t* qual0, int64_t width0,
    const uint8_t* seq1, const uint8_t* qual1, int64_t width1,
    const uint8_t* seq2, const uint8_t* qual2, int64_t width2,
    const uint8_t* plane_id, const int32_t* row_idx,
    const int32_t* start, const int32_t* out_len,
    const char* tags_buf, const int64_t* tag_off, const int32_t* tag_len,
    char* out) {
    const uint8_t* seqs[3] = {seq0, seq1, seq2};
    const uint8_t* quals[3] = {qual0, qual1, qual2};
    const int64_t widths[3] = {width0, width1, width2};
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        if (!select[i]) continue;
        memcpy(p, names_buf + name_off[i], (size_t)name_len[i]);
        p += name_len[i];
        if (tags_buf && tag_len[i]) {
            *p++ = ' ';
            memcpy(p, tags_buf + tag_off[i], (size_t)tag_len[i]);
            p += tag_len[i];
        }
        *p++ = '\n';
        const int pl = plane_id[i];
        const int64_t base = (int64_t)row_idx[i] * widths[pl] + start[i];
        int32_t l = out_len[i];
        memcpy(p, seqs[pl] + base, (size_t)l);
        p += l;
        *p++ = '\n';
        memcpy(p, strands_buf + strand_off[i], (size_t)strand_len[i]);
        p += strand_len[i];
        *p++ = '\n';
        memcpy(p, quals[pl] + base, (size_t)l);
        p += l;
        *p++ = '\n';
    }
    return p - out;
}

// ---------------------------------------------------------------------------
// adapter-detection seed histogram
// ---------------------------------------------------------------------------

// Count every 2-bit-packed k-mer at positions >= 20 (and <= rlen - keylen -
// shift_tail) over an [n, rlen] block of uniform-length reads, rolling-window
// with an invalid-base tracker.  Mirrors the reference seed scan
// (reference: src/evaluator.cpp:266-282, seq2int mapping A=0 T=1 C=2 G=3).
void fq_seed_hist(const uint8_t* seqs, int64_t n, int64_t rlen,
                  int32_t keylen, int32_t shift_tail, int64_t* counts) {
    int8_t lut[256];
    memset(lut, -1, sizeof(lut));
    lut['A'] = 0; lut['T'] = 1; lut['C'] = 2; lut['G'] = 3;
    const uint32_t mask = (keylen >= 16) ? 0xffffffffu
                                         : ((1u << (2 * keylen)) - 1u);
    const int64_t last = rlen - keylen - shift_tail;  // max window start
    if (last < 20) return;
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* row = seqs + r * rlen;
        uint32_t key = 0;
        int64_t last_bad = 19;  // windows must start at pos >= 20
        const int64_t jend = last + keylen;  // window [s, s+keylen), s <= last
        for (int64_t j = 20; j < jend; ++j) {
            int8_t c = lut[row[j]];
            if (c < 0) { last_bad = j; c = 0; }
            key = ((key << 2) | (uint32_t)c) & mask;
            int64_t s = j - keylen + 1;
            if (s >= 20 && last_bad < s) ++counts[key];
        }
    }
}

// ---------------------------------------------------------------------------
// overrepresented-sequence window scan
// ---------------------------------------------------------------------------

// Count every length-``step`` window that stays inside its read (window
// start i < rlen - step, matching the reference loop evaluator.cpp:131) via
// 64-bit rolling polynomial hashes + sort, and emit (first position, count)
// for every group with count >= threshold.  The Python caller extracts the
// exact substring at the first position.  Replaces the reference's
// std::map<substring> insert storm (reference: src/evaluator.cpp:120-161).
int64_t fq_ors_scan(const uint8_t* flat,
                    const int64_t* starts, const int64_t* lens,
                    int64_t nreads, int32_t step, int64_t threshold,
                    int64_t* out_pos, int64_t* out_count, int64_t max_out) {
    const uint64_t P = 1099511628211ull;  // FNV prime
    uint64_t ptop = 1;
    for (int32_t i = 0; i < step - 1; ++i) ptop *= P;

    int64_t total = 0;
    for (int64_t r = 0; r < nreads; ++r)
        if (lens[r] > step) total += lens[r] - step;
    std::vector<std::pair<uint64_t, int64_t>> v;
    v.reserve((size_t)total);

    for (int64_t r = 0; r < nreads; ++r) {
        const int64_t L = lens[r];
        if (L <= step) continue;
        const uint8_t* s = flat + starts[r];
        uint64_t h = 0;
        for (int32_t j = 0; j < step; ++j) h = h * P + s[j];
        v.push_back({h, starts[r]});
        for (int64_t i = 1; i < L - step; ++i) {
            h = (h - (uint64_t)s[i - 1] * ptop) * P + s[i + step - 1];
            v.push_back({h, starts[r] + i});
        }
    }
    std::sort(v.begin(), v.end());

    int64_t out = 0;
    size_t i = 0;
    while (i < v.size() && out < max_out) {
        size_t j = i + 1;
        while (j < v.size() && v[j].first == v[i].first) ++j;
        if ((int64_t)(j - i) >= threshold) {
            out_pos[out] = v[i].second;  // sorted by (hash, pos): first = min
            out_count[out] = (int64_t)(j - i);
            ++out;
        }
        i = j;
    }
    return out;
}

// (short, long) containment candidate pairs: for every length-``step``
// window FULLY contained in an item strictly longer than ``step``, probe the
// caller's SORTED array of short-string hashes and emit (rank in that array,
// containing item) on hit.  Probing ~15k sorted hashes per window beats
// sorting millions of window pairs (the ORS superstring-containment index,
// reference: src/evaluator.cpp:166-188).  Returns the pair count (capped at
// max_out; candidates are verified exactly by the caller anyway).
int64_t fq_contain_pairs(const uint8_t* flat,
                         const int64_t* starts, const int64_t* lens,
                         int64_t n_items, int32_t step,
                         const uint64_t* short_hash, int64_t n_short,
                         int64_t* out_short, int64_t* out_item,
                         int64_t max_out) {
    const uint64_t P = 1099511628211ull;
    uint64_t ptop = 1;
    for (int32_t i = 0; i < step - 1; ++i) ptop *= P;
    const uint64_t* se = short_hash + n_short;
    std::vector<int64_t> last_item(n_short, -1);  // (short, item) dedup
    int64_t out = 0;
    for (int64_t r = 0; r < n_items && out < max_out; ++r) {
        const int64_t L = lens[r];
        if (L <= step) continue;
        const uint8_t* s = flat + starts[r];
        uint64_t h = 0;
        for (int32_t j = 0; j < step; ++j) h = h * P + s[j];
        for (int64_t i = 0;; ++i) {
            const uint64_t* lo = std::lower_bound(short_hash, se, h);
            for (const uint64_t* q = lo; q != se && *q == h && out < max_out; ++q) {
                int64_t rank = q - short_hash;
                if (last_item[rank] == r) continue;
                last_item[rank] = r;
                out_short[out] = rank;
                out_item[out] = r;
                ++out;
            }
            if (i + 1 + step > L) break;
            h = (h - (uint64_t)s[i] * ptop) * P + s[i + step];
        }
    }
    return out;
}

// ---------------------------------------------------------------------------
// merged-pair assembly
// ---------------------------------------------------------------------------

// Build merged reads (reference: src/overlapanalysis.cpp:74-104):
//   merged = r1[0:len1] ++ revcomp(r2)[ol : ol+len2]
// for every selected row, from the (corrected) pack matrices.  Row i of the
// second part reads r2[front2 + rlen2-1-(ol + i - len1)] complemented.
// Unselected rows are zeroed.  All indices are clamped defensively.
void fq_assemble_merged(const uint8_t* m1s, const uint8_t* m1q, int64_t w1,
                        const uint8_t* m2s, const uint8_t* m2q, int64_t w2,
                        int64_t n, const uint8_t* sel,
                        const int32_t* front1, const int32_t* front2,
                        const int32_t* rlen2, const int32_t* ol,
                        const int32_t* len1, const int32_t* len2,
                        uint8_t* ms, uint8_t* mq, int64_t wm) {
    uint8_t comp[256];
    memset(comp, 'N', sizeof(comp));
    comp['A'] = 'T'; comp['a'] = 'T'; comp['T'] = 'A'; comp['t'] = 'A';
    comp['C'] = 'G'; comp['c'] = 'G'; comp['G'] = 'C'; comp['g'] = 'C';
    for (int64_t r = 0; r < n; ++r) {
        uint8_t* os = ms + r * wm;
        uint8_t* oq = mq + r * wm;
        memset(os, 0, (size_t)wm);
        memset(oq, 0, (size_t)wm);
        if (!sel[r]) continue;
        int64_t l1 = len1[r];
        if (l1 < 0) l1 = 0;
        if (l1 > wm) l1 = wm;
        int64_t f1 = front1[r];
        if (f1 < 0) f1 = 0;
        int64_t c1 = l1;
        if (f1 + c1 > w1) c1 = w1 - f1 > 0 ? w1 - f1 : 0;
        memcpy(os, m1s + r * w1 + f1, (size_t)c1);
        memcpy(oq, m1q + r * w1 + f1, (size_t)c1);
        int64_t l2 = len2[r];
        if (l2 < 0) l2 = 0;
        if (l1 + l2 > wm) l2 = wm - l1;
        const uint8_t* s2 = m2s + r * w2;
        const uint8_t* q2 = m2q + r * w2;
        const int64_t f2 = front2[r];
        for (int64_t i = 0; i < l2; ++i) {
            int64_t j = f2 + (int64_t)rlen2[r] - 1 - (ol[r] + i);
            if (j < 0) j = 0;
            if (j >= w2) j = w2 - 1;
            os[l1 + i] = comp[s2[j]];
            oq[l1 + i] = q2[j];
        }
    }
}

// ---------------------------------------------------------------------------
// packed transport encode (ops/packed.py)
// ---------------------------------------------------------------------------

// enc = lut[seq, qual] in one pass; returns the max encoded value (255 =
// invalid content somewhere, caller falls back to the raw path).
int32_t fq_encode(const uint8_t* seq, const uint8_t* qual, int64_t n,
                  const uint8_t* lut /* [256*256] */, uint8_t* enc) {
    uint8_t mx = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t v = lut[((int32_t)seq[i] << 8) | qual[i]];
        enc[i] = v;
        if (v > mx) mx = v;
    }
    return mx;
}

// 5-bit dictionary packing of enc: builds the value dictionary (<= 32
// distinct values or returns -1), then packs 8 dictionary indices into 5
// bytes (little-endian bit offsets 5*i).  rows are [B, L] with L padded to
// a multiple of 8 via `lp`; tail positions past l pack as index 0 (the
// device decode slices them away before use).
int64_t fq_pack5(const uint8_t* enc, int64_t b, int64_t l, int64_t lp,
                 uint8_t* packed, uint8_t* dict32) {
    uint8_t present[256];
    memset(present, 0, sizeof(present));
    const int64_t n = b * l;
    for (int64_t i = 0; i < n; ++i) present[enc[i]] = 1;
    uint8_t inv[256];
    int64_t nvals = 0;
    for (int32_t v = 0; v < 256; ++v) {
        if (present[v]) {
            if (nvals >= 32) return -1;
            dict32[nvals] = (uint8_t)v;
            inv[v] = (uint8_t)nvals;
            ++nvals;
        }
    }
    const int64_t groups = lp / 8;
    for (int64_t r = 0; r < b; ++r) {
        const uint8_t* row = enc + r * l;
        uint8_t* out = packed + r * groups * 5;
        for (int64_t g = 0; g < groups; ++g) {
            uint8_t c[8];
            for (int k = 0; k < 8; ++k) {
                int64_t j = g * 8 + k;
                c[k] = j < l ? inv[row[j]] : (uint8_t)0;
            }
            out[g * 5 + 0] = (uint8_t)(c[0] | (c[1] << 5));
            out[g * 5 + 1] = (uint8_t)((c[1] >> 3) | (c[2] << 2) | (c[3] << 7));
            out[g * 5 + 2] = (uint8_t)((c[3] >> 1) | (c[4] << 4));
            out[g * 5 + 3] = (uint8_t)((c[4] >> 4) | (c[5] << 1) | (c[6] << 6));
            out[g * 5 + 4] = (uint8_t)((c[6] >> 2) | (c[7] << 3));
        }
    }
    return nvals;
}

// Generic ragged span copy (host/names.py::copy_spans):
//   dst[dst_off[i] : +lens[i]] = src[src_off[i] : +lens[i]]
// memcpy per row instead of the numpy formulation's arange/repeat index
// vectors (~6 passes with 8-byte indices per output byte).  Offsets are
// trusted (the caller computed them from its own cumsums); lens <= 0 skip.
void fq_copy_spans(uint8_t* dst, const int64_t* dst_off,
                   const uint8_t* src, const int64_t* src_off,
                   const int64_t* lens, int64_t n) {
    for (int64_t r = 0; r < n; ++r) {
        if (lens[r] > 0)
            memcpy(dst + dst_off[r], src + src_off[r], (size_t)lens[r]);
    }
}

// 64-bit polynomial hash of one span (same P as the window scans).
uint64_t fq_hash64(const uint8_t* s, int64_t n) {
    const uint64_t P = 1099511628211ull;
    uint64_t h = 0;
    for (int64_t i = 0; i < n; ++i) h = h * P + s[i];
    return h;
}

// All occurrences of `seed` in each row of a [n, width] matrix, replicating
// the reference's find loop (evaluator.cpp:398-409): positions scanned from
// min_pos, accepted while pos <= len - seedlen - shift_tail.  Returns the
// TOTAL occurrence count; only the first `cap` pairs are written, so a
// return > cap tells the caller to retry with a bigger buffer.
int64_t fq_find_seed(const uint8_t* mat, int64_t n, int64_t width,
                     const int32_t* lens, const uint8_t* seed,
                     int32_t seedlen, int32_t min_pos, int32_t shift_tail,
                     int64_t* out_row, int32_t* out_pos, int64_t cap) {
    int64_t m = 0;
    for (int64_t r = 0; r < n; ++r) {
        int32_t last = lens[r] - seedlen - shift_tail;
        const uint8_t* row = mat + r * width;
        for (int32_t p = min_pos; p <= last; ++p) {
            if (memcmp(row + p, seed, (size_t)seedlen) == 0) {
                if (m < cap) { out_row[m] = r; out_pos[m] = p; }
                ++m;
            }
        }
    }
    return m;
}

// The reference's quirky top-10 seed insertion loop, replicated exactly
// (evaluator.cpp:287-337): iterate candidate keys ascending; a value beating
// position t>0 inserts at t+1, while one beating position 0 shifts and
// inserts at 0.  Inherently sequential (the break threshold counts[top[9]]
// evolves per insertion), so it lives here: ~1 ms over ~100k candidates vs
// ~0.2 s for the same loop in Python.  topkeys must arrive zero-initialized.
void fq_top_keys(const int64_t* counts, const int64_t* cand, int64_t n,
                 int32_t topnum, int64_t* topkeys) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t k = cand[i];
        int64_t v = counts[k];
        for (int32_t t = topnum - 1; t >= 0; --t) {
            if (v < counts[topkeys[t]]) {
                if (t < topnum - 1) {
                    for (int32_t m = topnum - 1; m > t + 1; --m)
                        topkeys[m] = topkeys[m - 1];
                    topkeys[t + 1] = k;
                }
                break;
            } else if (t == 0) {
                for (int32_t m = topnum - 1; m > 0; --m)
                    topkeys[m] = topkeys[m - 1];
                topkeys[t] = k;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// parallel-ingest line scanner (dist/ingest.py)
// ---------------------------------------------------------------------------
//
// Multi-host runs split each input file into per-rank byte regions; every
// rank scans ONLY its region, and the tiny per-region summaries compose into
// an exact global pack plan (replacing the round-3 design where every rank
// inflated and boundary-scanned the ENTIRE input -- the O(world) duplicated
// work called out as the round-3 scaling tail).  The plan is only valid for
// strict 4-line FASTQ (no '\r', no blank/skipped lines); the scanner proves
// that property for its region under all four possible line phases, and any
// violation makes the caller fall back to the serial-scan path whose
// semantics match the reference reader exactly (src/fqreader.cpp:90-195).
//
// A region generally starts and ends mid-line.  Lines are indexed locally:
// line 0 is the line the region's first byte belongs to (its head may live
// in the previous region), so all checks involving line 0 are skipped here
// and re-verified by rank 0 from the stitched boundary info (head/tail
// lengths and first bytes of the 4 boundary lines on each side).

struct line_scan_t {
    int64_t n_nl;          // '\n' seen (== local index of the current line)
    int64_t cur_len;       // bytes of the current line so far
    uint8_t cur_first;     // first byte of the current line (if cur_len > 0)
    int64_t head_len;      // visible length of local line 0
    uint8_t head_first;    // first visible byte of local line 0
    uint8_t seen_cr;       // any '\r' in the region
    uint8_t at_start;      // region starts at stream offset 0 (line 0 complete)
    uint8_t ok[4];         // strictness under phase hypothesis h (line 0's role)
    int64_t stash[4];      // seq length awaiting the qual compare, -1 = unset
    // boundary info for rank-0 stitching: first/last 4 complete lines
    int64_t first_lens[4]; uint8_t first_bytes[4]; int32_t n_first;
    int64_t last_lens[4];  uint8_t last_bytes[4];  int64_t n_lines_done;
};

void* fq_scan_new(int32_t at_stream_start) {
    line_scan_t* s = (line_scan_t*)calloc(1, sizeof(line_scan_t));
    s->at_start = (uint8_t)(at_stream_start != 0);
    for (int h = 0; h < 4; ++h) { s->ok[h] = 1; s->stash[h] = -1; }
    return s;
}

static void scan_line_done(line_scan_t* s) {
    const int64_t j = s->n_nl;       // local index of the finished line
    const int64_t len = s->cur_len;
    const uint8_t first = s->cur_first;
    if (j == 0) { s->head_len = len; s->head_first = first; }
    if (j > 0 || s->at_start) {
        // role checks under each hypothesis h: line j plays role (h+j)&3,
        // roles: 0 name('@'), 1 seq, 2 strand('+'), 3 qual(len==seq len)
        for (int h = 0; h < 4; ++h) {
            if (!s->ok[h]) continue;
            switch ((int)((h + j) & 3)) {
            case 0: if (len <= 0 || first != '@') s->ok[h] = 0; break;
            case 1: s->stash[h] = len; break;
            case 2: if (len <= 0 || first != '+') s->ok[h] = 0; break;
            case 3:
                if (s->stash[h] >= 0 && s->stash[h] != len) s->ok[h] = 0;
                s->stash[h] = -1;
                break;
            }
        }
        if (s->n_first < 4) {
            s->first_lens[s->n_first] = len;
            s->first_bytes[s->n_first] = first;
            ++s->n_first;
        }
        s->last_lens[s->n_lines_done & 3] = len;
        s->last_bytes[s->n_lines_done & 3] = first;
        ++s->n_lines_done;
    }
    // (line 0 of a mid-stream region is recorded via head_len/head_first
    // only; rank 0 re-verifies it from the stitched boundary info)
    ++s->n_nl;
    s->cur_len = 0;
    s->cur_first = 0;
}

void fq_scan_feed(void* ctx, const uint8_t* buf, int64_t len) {
    line_scan_t* s = (line_scan_t*)ctx;
    int64_t i = 0;
    while (i < len) {
        const uint8_t* nl = (const uint8_t*)memchr(buf + i, '\n', (size_t)(len - i));
        const int64_t stop = nl ? (nl - buf) : len;
        if (stop > i) {
            if (s->cur_len == 0) s->cur_first = buf[i];
            if (!s->seen_cr && memchr(buf + i, '\r', (size_t)(stop - i)))
                s->seen_cr = 1;
            s->cur_len += stop - i;
        }
        if (!nl) break;
        scan_line_done(s);
        i = stop + 1;
    }
}

// Fill out[0..24) with the region summary:
//  [0] n_nl  [1] head_len  [2] head_first  [3] tail_len  [4] tail_first
//  [5] seen_cr  [6..9] ok[h]  [10..13] first_lens  [14..17] first_bytes
//  [18..21] last 4 complete line lens (oldest first)  [22] n_first
//  [23] n_lines_done
void fq_scan_finish(void* ctx, int64_t* out, uint8_t* last4_bytes) {
    line_scan_t* s = (line_scan_t*)ctx;
    out[0] = s->n_nl;
    out[1] = s->n_nl == 0 ? s->cur_len : s->head_len;
    out[2] = s->n_nl == 0 ? s->cur_first : s->head_first;
    out[3] = s->cur_len;     // trailing partial (0 if region ends at '\n')
    out[4] = s->cur_first;
    out[5] = s->seen_cr;
    for (int h = 0; h < 4; ++h) out[6 + h] = s->ok[h];
    for (int k = 0; k < 4; ++k) {
        out[10 + k] = k < s->n_first ? s->first_lens[k] : -1;
        out[14 + k] = k < s->n_first ? s->first_bytes[k] : 0;
    }
    const int64_t nd = s->n_lines_done;
    for (int k = 0; k < 4; ++k) {
        // oldest-first of the last min(4, nd) complete lines
        int64_t cnt = nd < 4 ? nd : 4;
        if (k < cnt) {
            int64_t idx = (nd - cnt + k) & 3;
            out[18 + k] = s->last_lens[idx];
            last4_bytes[k] = s->last_bytes[idx];
        } else {
            out[18 + k] = -1;
            last4_bytes[k] = 0;
        }
    }
    out[22] = s->n_first;
    out[23] = nd;
}

void fq_scan_free(void* ctx) { free(ctx); }

// Skip up to k '\n' bytes in buf; returns bytes consumed, sets *skipped.
int64_t fq_skip_newlines(const uint8_t* buf, int64_t len, int64_t k,
                         int64_t* skipped) {
    int64_t i = 0, done = 0;
    while (done < k) {
        const uint8_t* nl = (const uint8_t*)memchr(buf + i, '\n',
                                                   (size_t)(len - i));
        if (!nl) { i = len; break; }
        i = (nl - buf) + 1;
        ++done;
    }
    *skipped = done;
    return i;
}

// Single-member-bounded inflate: like gz_inflate but STOPS at each gzip
// member end instead of resetting, so the caller can track member
// boundaries (state 2 = member end, input may remain; call
// gz_inflate_reset before continuing).  Used by the parallel-ingest region
// scan to verify a region ends exactly on a member boundary.
int64_t gz_inflate_member(void* ctx, const uint8_t* in, int64_t in_len,
                          uint8_t* out, int64_t out_cap,
                          int64_t* in_used, int32_t* state) {
    z_stream* zs = (z_stream*)ctx;
    zs->next_in = (Bytef*)in;
    zs->avail_in = (uInt)in_len;
    zs->next_out = out;
    zs->avail_out = (uInt)out_cap;
    *state = 0;
    while (zs->avail_out > 0) {
        int rc = inflate(zs, Z_NO_FLUSH);
        if (rc == Z_STREAM_END) { *state = 2; break; }
        if (rc == Z_OK || rc == Z_BUF_ERROR) {
            if (zs->avail_in == 0) break;
            if (rc == Z_BUF_ERROR && zs->avail_out == 0) break;
            if (rc == Z_BUF_ERROR) { *state = -1; break; }
            continue;
        }
        *state = -1;
        break;
    }
    *in_used = in_len - (int64_t)zs->avail_in;
    return out_cap - (int64_t)zs->avail_out;
}

int32_t gz_inflate_reset(void* ctx) {
    return inflateReset((z_stream*)ctx) == Z_OK ? 0 : -1;
}

}  // extern "C"
