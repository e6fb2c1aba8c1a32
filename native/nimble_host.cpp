// Native host ops for nimble_tpu.
//
// The reference gets its host-side speed from Rust + C dependencies
// (rust-debruijn's packed DnaStrings, htslib, jemalloc); here the hot host
// paths are C++ behind a ctypes boundary with pure-Python fallbacks:
//
//   * encode_bases      — byte -> 2-bit code LUT translation (FASTQ/BAM ingest)
//   * fastq_scan        — record-boundary scan of a FASTQ text buffer
//   * build_hash_table  — open-addressing insertion loop for the k-mer table
//                         (must match ops/device_index.py's fmix32 hashing)
//   * extract_kmer_keys — rolling 60-bit k-mer keys of a code array
//
// Build: g++ -O3 -march=native -shared -fPIC nimble_host.cpp -o libnimble_host.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

#include <zlib.h>

namespace {
// open-addressing exact-key set: keys live in an append-only arena,
// the table stores (hash, offset) and collisions compare full bytes.
// ~3x faster than unordered_set<string> (no per-key node allocations).
struct DedupSet {
    std::vector<uint8_t> arena;       // [u32 len][bytes] entries
    std::vector<uint64_t> hashes;     // 0 = empty slot
    std::vector<uint64_t> offsets;
    size_t count = 0;

    DedupSet() : hashes(1 << 16, 0), offsets(1 << 16, 0) {}

    // Streaming word-wise FNV over a LOGICAL byte stream: feed() may be
    // called any number of times and the hash depends only on the
    // concatenated bytes — the score-map key is the plain r1+r2
    // concatenation (`src/align.rs:576-579`), so differently-split pairs
    // with an equal concatenation MUST hash equal.  Word-at-a-time is
    // ~6x faster than the byte loop on 100-200B read keys.  The final
    // mix folds in the total length to separate zero-padded tails; exact
    // equality is always re-checked via key_equals, so the hash only has
    // to be consistent, never collision-free.
    struct StreamHash {
        uint64_t h = 1469598103934665603ULL;
        uint64_t buf = 0;
        unsigned nb = 0;       // pending bytes in buf (little-endian)
        uint64_t total = 0;

        inline void feed(const uint8_t* p, size_t n) {
            total += n;
            size_t i = 0;
            if (nb) {
                while (nb < 8 && i < n)
                    buf |= (uint64_t)p[i++] << (8 * nb++);
                if (nb < 8) return;
                h = (h ^ buf) * 1099511628211ULL;
                buf = 0;
                nb = 0;
            }
            for (; i + 8 <= n; i += 8) {
                uint64_t w;
                std::memcpy(&w, p + i, 8);
                h = (h ^ w) * 1099511628211ULL;
            }
            while (i < n) buf |= (uint64_t)p[i++] << (8 * nb++);
        }

        inline uint64_t finish() {
            if (nb) h = (h ^ buf) * 1099511628211ULL;
            h = (h ^ total) * 1099511628211ULL;
            h ^= h >> 29; h *= 0xBF58476D1CE4E5B9ULL; h ^= h >> 32;
            return h ? h : 1;  // 0 marks empty slots
        }
    };

    static uint64_t hash_bytes(const uint8_t* p, size_t n) {
        StreamHash s;
        s.feed(p, n);
        return s.finish();
    }

    bool key_equals(uint64_t off, const uint8_t* a, size_t la,
                    const uint8_t* b, size_t lb) const {
        uint32_t len;
        std::memcpy(&len, arena.data() + off, 4);
        if ((size_t)len != la + lb) return false;
        const uint8_t* k = arena.data() + off + 4;
        return std::memcmp(k, a, la) == 0 &&
               (lb == 0 || std::memcmp(k + la, b, lb) == 0);
    }

    void grow() {
        size_t n = hashes.size() * 2;
        std::vector<uint64_t> nh(n, 0), no(n, 0);
        size_t mask = n - 1;
        for (size_t i = 0; i < hashes.size(); ++i) {
            if (!hashes[i]) continue;
            size_t s = hashes[i] & mask;
            while (nh[s]) s = (s + 1) & mask;
            nh[s] = hashes[i];
            no[s] = offsets[i];
        }
        hashes.swap(nh);
        offsets.swap(no);
    }

    // insert the concatenation a|b; returns true when newly added
    bool insert2(const uint8_t* a, size_t la, const uint8_t* b, size_t lb) {
        if ((count + 1) * 10 > hashes.size() * 7) grow();
        // hash over the concatenation without materializing it (the
        // streaming hash is split-invariant by construction)
        StreamHash sh;
        sh.feed(a, la);
        if (lb) sh.feed(b, lb);
        uint64_t h = sh.finish();
        size_t mask = hashes.size() - 1;
        size_t s = h & mask;
        while (hashes[s]) {
            if (hashes[s] == h && key_equals(offsets[s], a, la, b, lb))
                return false;
            s = (s + 1) & mask;
        }
        uint64_t off = arena.size();
        uint32_t len = (uint32_t)(la + lb);
        arena.insert(arena.end(), (uint8_t*)&len, (uint8_t*)&len + 4);
        arena.insert(arena.end(), a, a + la);
        if (lb) arena.insert(arena.end(), b, b + lb);
        hashes[s] = h;
        offsets[s] = off;
        ++count;
        return true;
    }
};
}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// base encoding: A/a=0 C/c=1 G/g=2 T/t=3, everything else 0 (DnaString rule)
// ---------------------------------------------------------------------------
void nimble_encode_bases(const uint8_t* in, int64_t n, int8_t* out) {
    static int8_t lut[256];
    static bool init = false;
    if (!init) {
        std::memset(lut, 0, sizeof(lut));
        lut['A'] = 0; lut['a'] = 0;
        lut['C'] = 1; lut['c'] = 1;
        lut['G'] = 2; lut['g'] = 2;
        lut['T'] = 3; lut['t'] = 3;
        init = true;
    }
    for (int64_t i = 0; i < n; ++i) out[i] = lut[in[i]];
}

// ---------------------------------------------------------------------------
// FASTQ record scan: finds (seq_offset, seq_len) per record in a text buffer.
// Returns the number of records, or -1 on a malformed record (missing '@'
// header / '+' separator / truncated quality line) — the caller raises the
// reference-compatible "Unable to read sequence" error.
// ---------------------------------------------------------------------------
static inline int64_t next_line(const uint8_t* buf, int64_t n, int64_t pos,
                                int64_t* start, int64_t* len) {
    if (pos >= n) return -1;
    int64_t s = pos;
    while (pos < n && buf[pos] != '\n') ++pos;
    int64_t e = pos;
    while (e > s && (buf[e - 1] == '\r' || buf[e - 1] == ' ')) --e;
    *start = s;
    *len = e - s;
    return pos < n ? pos + 1 : n;
}

int64_t nimble_fastq_scan(const uint8_t* buf, int64_t n,
                          int64_t* seq_offsets, int64_t* seq_lens,
                          int64_t max_records) {
    int64_t pos = 0, count = 0;
    while (pos < n && count < max_records) {
        int64_t hs, hl;
        pos = next_line(buf, n, pos, &hs, &hl);
        if (pos < 0) break;
        if (hl == 0) continue;  // blank line tolerance
        if (buf[hs] != '@') return -1;
        int64_t ss, sl;
        pos = next_line(buf, n, pos, &ss, &sl);
        if (pos < 0) return -1;
        int64_t ps, plen;
        pos = next_line(buf, n, pos, &ps, &plen);
        if (pos < 0 || plen == 0 || buf[ps] != '+') return -1;
        int64_t qs, ql;
        pos = next_line(buf, n, pos, &qs, &ql);
        if (pos < 0) return -1;
        seq_offsets[count] = ss;
        seq_lens[count] = sl;
        ++count;
    }
    return count;
}

// Streaming variant: stops at the last COMPLETE record and reports the
// bytes consumed, so callers can scan fixed-size blocks and carry the
// partial tail.  A record is complete when its quality line is
// newline-terminated (or is_final).  Malformed records (non-'@' header,
// non-'+' separator on a complete line, or a truncated final record)
// return -1 — the reference's "Unable to read sequence".
int64_t nimble_fastq_scan2(const uint8_t* buf, int64_t n, int32_t is_final,
                           int64_t* seq_offsets, int64_t* seq_lens,
                           int64_t max_records, int64_t* consumed) {
    int64_t pos = 0, count = 0;
    *consumed = 0;
    while (pos < n && count < max_records) {
        int64_t hs, hl;
        int64_t p = next_line(buf, n, pos, &hs, &hl);
        if (p < 0) break;
        bool h_term = p < n || buf[n - 1] == '\n';
        if (hl == 0) {
            if (!h_term && !is_final) break;  // partial blank tail
            pos = p;
            *consumed = pos;
            continue;
        }
        if (buf[hs] != '@') return -1;  // record starts are exact: malformed
        int64_t ss, sl;
        int64_t p2 = next_line(buf, n, p, &ss, &sl);
        if (p2 < 0) { if (is_final) return -1; break; }
        int64_t ps, plen;
        int64_t p3 = next_line(buf, n, p2, &ps, &plen);
        if (p3 < 0) { if (is_final) return -1; break; }
        bool p_term = p3 < n || buf[n - 1] == '\n';
        if (p_term || is_final) {
            if (plen == 0 || buf[ps] != '+') return -1;
        } else {
            break;  // separator line may be truncated: carry
        }
        int64_t qs, ql;
        int64_t p4 = next_line(buf, n, p3, &qs, &ql);
        if (p4 < 0) { if (is_final) return -1; break; }
        bool q_term = p4 < n || buf[n - 1] == '\n';
        if (!q_term && !is_final) break;  // quality may be truncated: carry
        seq_offsets[count] = ss;
        seq_lens[count] = sl;
        ++count;
        pos = p4;
        *consumed = pos;
    }
    return count;
}

// Padded (n, W) matrix fill from scanned record spans: row i copies
// codes[offsets[i] .. +lens[i]] (zero padding preset by the caller).
void nimble_fill_matrix(const int8_t* codes, const int64_t* offsets,
                        const int64_t* lens, int64_t n, int64_t W,
                        int8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(out + i * W, codes + offsets[i], (size_t)lens[i]);
    }
}

// Fused encode + fill: rows are copied straight from the RAW FASTQ text
// with the base LUT applied per byte (A/a=0 C/c=1 G/g=2 T/t=3, unknown=0
// — exactly nimble_encode_bases / utils.dna.encode_bases).  Replaces the
// whole-block nimble_encode_bases pass, which encoded header/plus/quality
// bytes (~4x the sequence volume) only to have fill_matrix copy the
// sequence spans out.  Threaded over row ranges: pure LUT-memcpy work.
void nimble_fill_matrix_encode(const uint8_t* raw, const int64_t* offsets,
                               const int64_t* lens, int64_t n, int64_t W,
                               int8_t* out, int64_t n_threads) {
    static int8_t lut[256];
    static bool init = false;
    if (!init) {
        std::memset(lut, 0, sizeof(lut));
        lut['A'] = 0; lut['a'] = 0;
        lut['C'] = 1; lut['c'] = 1;
        lut['G'] = 2; lut['g'] = 2;
        lut['T'] = 3; lut['t'] = 3;
        init = true;
    }
    auto fill_range = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const uint8_t* src = raw + offsets[i];
            int8_t* dst = out + i * W;
            int64_t len = lens[i];
            for (int64_t j = 0; j < len; ++j) dst[j] = lut[src[j]];
        }
    };
    int64_t nt = std::min<int64_t>(
        n_threads, std::max<int64_t>(1, (int64_t)std::thread::hardware_concurrency()));
    if (nt <= 1 || n < 4096) {
        fill_range(0, n);
        return;
    }
    std::vector<std::thread> workers;
    int64_t per = (n + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
        int64_t lo = t * per, hi = std::min(n, lo + per);
        if (lo >= hi) break;
        workers.emplace_back(fill_range, lo, hi);
    }
    for (auto& w : workers) w.join();
}

// ---------------------------------------------------------------------------
// k-mer key extraction: packed 2-bit base-major keys, one per position.
// ---------------------------------------------------------------------------
void nimble_extract_kmer_keys(const int8_t* codes, int64_t n, int32_t k,
                              uint64_t* keys_out) {
    if (n < k) return;
    const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    uint64_t key = 0;
    for (int64_t i = 0; i < k; ++i) key = (key << 2) | (uint64_t)codes[i];
    keys_out[0] = key & mask;
    for (int64_t i = k; i < n; ++i) {
        key = ((key << 2) | (uint64_t)codes[i]) & mask;
        keys_out[i - k + 1] = key;
    }
}

// ---------------------------------------------------------------------------
// open-addressing hash table build (matches ops/device_index.py exactly)
// ---------------------------------------------------------------------------
static inline uint32_t fmix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

int32_t nimble_build_hash_table(
    const uint64_t* keys, const int32_t* starts, const int32_t* counts,
    int64_t n_keys,
    uint32_t* table_key_lo, uint32_t* table_key_hi,
    int32_t* table_start, int32_t* table_count,
    int64_t table_size) {
    const int64_t mask = table_size - 1;
    int32_t max_probe = 1;
    // caller pre-fills table_key_lo/hi with the 0xFFFFFFFF sentinel
    for (int64_t i = 0; i < n_keys; ++i) {
        uint32_t lo = (uint32_t)(keys[i] & 0x3FFFFFFFULL);
        uint32_t hi = (uint32_t)((keys[i] >> 30) & 0x3FFFFFFFULL);
        int64_t slot = (int64_t)(fmix32(lo ^ fmix32(hi))) & mask;
        int32_t probe = 1;
        while (table_key_lo[slot] != 0xFFFFFFFFu || table_key_hi[slot] != 0xFFFFFFFFu) {
            slot = (slot + 1) & mask;
            ++probe;
        }
        table_key_lo[slot] = lo;
        table_key_hi[slot] = hi;
        table_start[slot] = starts[i];
        table_count[slot] = counts[i];
        if (probe > max_probe) max_probe = probe;
    }
    return max_probe;
}

// Bucketized variant (ops/device_index.py BucketedDeviceIndex): WIDTH slots
// per bucket row, linear probing over BUCKETS when a bucket is full.  The
// bucket index uses the same fmix32 mixing as the flat table; starts/counts
// arrive as int64 (CSR spans) and are narrowed on store.  Returns max_probe
// in bucket hops.  Caller pre-fills bkey_lo/hi with the 0xFFFFFFFF sentinel.
int32_t nimble_build_bucket_table(
    const uint64_t* keys, const int64_t* starts, const int64_t* counts,
    int64_t n_keys,
    uint32_t* bkey_lo, uint32_t* bkey_hi,
    int32_t* bstart, int32_t* bcount,
    int64_t n_buckets, int32_t width) {
    const int64_t mask = n_buckets - 1;
    std::vector<int32_t> fill((size_t)n_buckets, 0);
    int32_t max_probe = 1;
    for (int64_t i = 0; i < n_keys; ++i) {
        uint32_t lo = (uint32_t)(keys[i] & 0x3FFFFFFFULL);
        uint32_t hi = (uint32_t)((keys[i] >> 30) & 0x3FFFFFFFULL);
        int64_t b = (int64_t)(fmix32(lo ^ fmix32(hi))) & mask;
        int32_t probe = 1;
        while (fill[(size_t)b] >= width) {
            b = (b + 1) & mask;
            ++probe;
        }
        int64_t at = b * width + fill[(size_t)b];
        bkey_lo[at] = lo;
        bkey_hi[at] = hi;
        bstart[at] = (int32_t)starts[i];
        bcount[at] = (int32_t)counts[i];
        ++fill[(size_t)b];
        if (probe > max_probe) max_probe = probe;
    }
    return max_probe;
}

// ---------------------------------------------------------------------------
// global read-pair dedupe set (the score map is keyed by read strings,
// `src/align.rs:574-579`; duplicates count once).  Keys are exact-length
// byte strings; the handle owns an arena-backed hash set that persists
// across chunks for streaming runs.
// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// BAM record batch scan: parses a decompressed BAM record stream into flat
// arrays (the role htslib's C decoder plays for the reference).  Returns the
// number of complete records parsed; *consumed gets the bytes consumed so a
// streaming caller can carry partial trailing records into the next chunk.
// Z-type aux tags are extracted into a compact blob per record
// ([tag 2B][len u16][bytes]); other aux types are skipped (every consumer in
// the pipeline filters for Z — htslib semantics are preserved).
// ---------------------------------------------------------------------------
static const char kSeqDecode[17] = "=ACMGRSVTWYHKDBN";

int64_t nimble_bam_scan(
    const uint8_t* buf, int64_t n, int64_t max_records,
    int32_t* fixed,          // (max_records, 8): flag,tid,pos,mapq,mtid,mpos,tlen,l_seq
    int64_t* qname_off, uint8_t* qname_flat,
    int64_t* seq_off, uint8_t* seq_flat,
    int64_t* qual_off, uint8_t* qual_flat,
    int64_t* aux_off, uint8_t* aux_flat,
    int64_t* cigar_off, uint32_t* cigar_flat,
    int64_t* consumed) {
    int64_t pos = 0, count = 0;
    int64_t qn = 0, sq = 0, ql = 0, ax = 0, cg = 0;
    qname_off[0] = seq_off[0] = qual_off[0] = aux_off[0] = cigar_off[0] = 0;
    while (count < max_records) {
        if (pos + 4 > n) break;
        int32_t block_size;
        std::memcpy(&block_size, buf + pos, 4);
        if (block_size <= 0 || pos + 4 + block_size > n) break;
        const uint8_t* r = buf + pos + 4;
        int32_t tid, rpos, l_seq, mtid, mpos, tlen;
        std::memcpy(&tid, r + 0, 4);
        std::memcpy(&rpos, r + 4, 4);
        uint8_t l_read_name = r[8];
        uint8_t mapq = r[9];
        uint16_t n_cigar, flag;
        std::memcpy(&n_cigar, r + 12, 2);
        std::memcpy(&flag, r + 14, 2);
        std::memcpy(&l_seq, r + 16, 4);
        std::memcpy(&mtid, r + 20, 4);
        std::memcpy(&mpos, r + 24, 4);
        std::memcpy(&tlen, r + 28, 4);

        int32_t* f = fixed + count * 8;
        f[0] = flag; f[1] = tid; f[2] = rpos; f[3] = mapq;
        f[4] = mtid; f[5] = mpos; f[6] = tlen; f[7] = l_seq;

        int64_t off = 32;
        // qname (drop trailing NUL)
        std::memcpy(qname_flat + qn, r + off, l_read_name - 1);
        qn += l_read_name - 1;
        off += l_read_name;
        std::memcpy(cigar_flat + cg, r + off, 4LL * n_cigar);
        cg += n_cigar;
        off += 4LL * n_cigar;
        // seq: unpack 4-bit codes to ASCII
        const uint8_t* sp = r + off;
        for (int32_t i = 0; i < l_seq; ++i) {
            uint8_t b = sp[i >> 1];
            seq_flat[sq + i] = kSeqDecode[(i & 1) ? (b & 0xF) : (b >> 4)];
        }
        sq += l_seq;
        off += (l_seq + 1) / 2;
        // qual (raw values)
        std::memcpy(qual_flat + ql, r + off, l_seq);
        ql += l_seq;
        off += l_seq;
        // aux: extract Z tags into [tag2][u16 len][bytes] entries
        while (off + 3 <= block_size) {
            uint8_t t0 = r[off], t1 = r[off + 1];
            char typ = (char)r[off + 2];
            off += 3;
            if (typ == 'Z' || typ == 'H') {
                int64_t s = off;
                while (off < block_size && r[off] != 0) ++off;
                int64_t len = off - s;
                // only Z tags enter the blob: htslib's aux-string lookup
                // (`Aux::String`) matches Z but not H, and every consumer
                // filters for Z — keeping H out preserves that semantics
                if (typ == 'Z') {
                    aux_flat[ax] = t0; aux_flat[ax + 1] = t1;
                    uint16_t l16 = (uint16_t)(len > 65535 ? 65535 : len);
                    std::memcpy(aux_flat + ax + 2, &l16, 2);
                    std::memcpy(aux_flat + ax + 4, r + s, l16);
                    ax += 4 + l16;
                }
                ++off;  // NUL
            } else if (typ == 'A' || typ == 'c' || typ == 'C') {
                off += 1;
            } else if (typ == 's' || typ == 'S') {
                off += 2;
            } else if (typ == 'i' || typ == 'I' || typ == 'f') {
                off += 4;
            } else if (typ == 'B') {
                if (off + 5 > block_size) break;
                char sub = (char)r[off];
                int32_t cnt32;
                std::memcpy(&cnt32, r + off + 1, 4);
                int64_t esz = (sub == 'c' || sub == 'C') ? 1
                             : (sub == 's' || sub == 'S') ? 2 : 4;
                off += 5 + esz * cnt32;
            } else {
                break;  // unknown type
            }
        }

        ++count;
        qname_off[count] = qn;
        seq_off[count] = sq;
        qual_off[count] = ql;
        aux_off[count] = ax;
        cigar_off[count] = cg;
        pos += 4 + block_size;
    }
    *consumed = pos;
    return count;
}

// ---------------------------------------------------------------------------
// Columnar BAM metadata builder: derives, per record, everything the UMI
// pipeline needs — without ever materializing Python record objects.
// (The role of `record_metadata` / `src/parse/bam.rs:197-236`, vectorized.)
//
// Per record the outputs are:
//   meta      — the 35 leading output metadata fields tab-joined (field order
//               of BAM_FIELDS_TO_REPORT minus QUAL(1), SEQ(15) and the
//               trailing SKIP_ALIGN(37), which the pipeline appends itself);
//               per field, a Z aux tag whose first two bytes match the field
//               name wins (htslib 2-byte tag resolution quirk), else the
//               built-in accessor value
//   seq2      — 2-bit codes of the clipped, normalized sequence (alignment
//               input; 124bp 10x rule from `src/parse/bam.rs:258-268`)
//   meta1     — metadata[1] (QUAL field: aux "QU" override, else the clipped
//               qual value bytes, reversed for reverse reads)
//   meta15    — metadata[15] (SEQ field: aux "SE" override, else the
//               normalized clipped sequence string)
//   rev2      — metadata[2] (REVERSE: aux "RE" override, else true/false)
//   qn        — metadata[0] (QNAME: aux "QN" override, else qname)
//   cb/umi/sk — CB tag, UB-else-UR tag, SK tag (empty when absent)
//   oflags    — bit0 paired, bit1 reverse, bit2 has_cb, bit3 has_umi
// Returns 0, or -1 if an output buffer would overflow (caller re-allocates).
// ---------------------------------------------------------------------------
namespace {

struct AuxView {
    const uint8_t* blob;
    int64_t begin, end;
    // find a Z tag by its first two bytes; returns length or -1
    int64_t find(char a, char b, const uint8_t** val) const {
        int64_t p = begin;
        while (p + 4 <= end) {
            uint16_t len = (uint16_t)(blob[p + 2] | (blob[p + 3] << 8));
            if ((char)blob[p] == a && (char)blob[p + 1] == b) {
                *val = blob + p + 4;
                return len;
            }
            p += 4 + len;
        }
        return -1;
    }
};

struct Out {
    uint8_t* buf;
    int64_t pos, cap;
    bool overflow;
    void put(const uint8_t* src, int64_t n) {
        if (pos + n > cap) { overflow = true; return; }
        std::memcpy(buf + pos, src, n);
        pos += n;
    }
    void putc(char c) {
        if (pos + 1 > cap) { overflow = true; return; }
        buf[pos++] = (uint8_t)c;
    }
    void puts(const char* s) { put((const uint8_t*)s, (int64_t)std::strlen(s)); }
    void puti(int64_t v) {
        char tmp[24];
        int n = 0;
        if (v < 0) { putc('-'); v = -v; }
        if (v == 0) tmp[n++] = '0';
        while (v > 0) { tmp[n++] = (char)('0' + v % 10); v /= 10; }
        while (n > 0) putc(tmp[--n]);
    }
};

const int kClipLength = 13;  // `src/parse/bam.rs:7` CLIP_LENGTH

}  // namespace

int32_t nimble_bam_meta(
    const int32_t* fixed,
    const int64_t* qname_off, const uint8_t* qname_flat,
    const int64_t* seq_off, const uint8_t* seq_flat,
    const int64_t* qual_off, const uint8_t* qual_flat,
    const int64_t* aux_off, const uint8_t* aux_flat,
    int64_t n,
    uint8_t* meta_flat, int64_t* meta_offs, int64_t meta_cap,
    int8_t* seq2_flat, int64_t* seq2_offs, int64_t seq2_cap,
    uint8_t* meta1_flat, int64_t* meta1_offs, int64_t meta1_cap,
    uint8_t* meta15_flat, int64_t* meta15_offs, int64_t meta15_cap,
    uint8_t* rev2_flat, int64_t* rev2_offs, int64_t rev2_cap,
    uint8_t* qn_flat, int64_t* qn_offs, int64_t qn_cap,
    uint8_t* cb_flat, int64_t* cb_offs, int64_t cb_cap,
    uint8_t* umi_flat, int64_t* umi_offs, int64_t umi_cap,
    uint8_t* sk_flat, int64_t* sk_offs, int64_t sk_cap,
    uint8_t* oflags) {
    static int8_t code_lut[256];
    static uint8_t norm_lut[256];
    static bool init = false;
    if (!init) {
        std::memset(code_lut, 0, sizeof(code_lut));
        code_lut['A'] = 0; code_lut['a'] = 0;
        code_lut['C'] = 1; code_lut['c'] = 1;
        code_lut['G'] = 2; code_lut['g'] = 2;
        code_lut['T'] = 3; code_lut['t'] = 3;
        static const char dec[4] = {'A', 'C', 'G', 'T'};
        for (int i = 0; i < 256; ++i) norm_lut[i] = (uint8_t)dec[code_lut[i]];
        init = true;
    }

    Out meta{meta_flat, 0, meta_cap, false};
    Out m1{meta1_flat, 0, meta1_cap, false};
    Out m15{meta15_flat, 0, meta15_cap, false};
    Out rv{rev2_flat, 0, rev2_cap, false};
    Out qn{qn_flat, 0, qn_cap, false};
    Out cb{cb_flat, 0, cb_cap, false};
    Out um{umi_flat, 0, umi_cap, false};
    Out sk{sk_flat, 0, sk_cap, false};
    int64_t s2 = 0;

    meta_offs[0] = meta1_offs[0] = meta15_offs[0] = rev2_offs[0] = 0;
    qn_offs[0] = cb_offs[0] = umi_offs[0] = sk_offs[0] = seq2_offs[0] = 0;

    for (int64_t i = 0; i < n; ++i) {
        const int32_t* f = fixed + i * 8;
        int32_t flag = f[0], tid = f[1], pos = f[2], mapq = f[3];
        int32_t mtid = f[4], mpos = f[5], tlen = f[6], l_seq = f[7];
        bool rev = (flag & 0x10) != 0;
        AuxView aux{aux_flat, aux_off[i], aux_off[i + 1]};
        const uint8_t* v;
        int64_t vl;

        // --- seq2: clipped normalized codes ---
        const uint8_t* sp = seq_flat + seq_off[i];
        int64_t slen = seq_off[i + 1] - seq_off[i];
        int64_t sbeg = 0, send = slen;
        if (slen == 124) {           // strip_nonbio_regions
            if (rev) send -= kClipLength; else sbeg += kClipLength;
        }
        int64_t clen = send - sbeg;
        if (s2 + clen > seq2_cap) return -1;
        for (int64_t j = 0; j < clen; ++j)
            seq2_flat[s2 + j] = code_lut[sp[sbeg + j]];
        s2 += clen;
        seq2_offs[i + 1] = s2;

        // --- meta1 = QUAL field: aux "QU" else clipped (reversed) qual ---
        if ((vl = aux.find('Q', 'U', &v)) >= 0) {
            m1.put(v, vl);
        } else {
            const uint8_t* qp = qual_flat + qual_off[i];
            int64_t qlen = qual_off[i + 1] - qual_off[i];
            int64_t qbeg = 0, qend = qlen;
            if (qlen == 124) {       // strip_nonbio_regions_qual
                if (rev) qend -= kClipLength; else qbeg += kClipLength;
            }
            if (rev) {
                for (int64_t j = qend - 1; j >= qbeg; --j) m1.putc((char)qp[j]);
            } else {
                m1.put(qp + qbeg, qend - qbeg);
            }
        }
        meta1_offs[i + 1] = m1.pos;

        // --- meta15 = SEQ field: aux "SE" else normalized clipped seq ---
        if ((vl = aux.find('S', 'E', &v)) >= 0) {
            m15.put(v, vl);
        } else {
            if (m15.pos + clen > m15.cap) return -1;
            for (int64_t j = 0; j < clen; ++j)
                m15.buf[m15.pos + j] = norm_lut[sp[sbeg + j]];
            m15.pos += clen;
        }
        meta15_offs[i + 1] = m15.pos;

        // --- rev2 = REVERSE field ---
        if ((vl = aux.find('R', 'E', &v)) >= 0) rv.put(v, vl);
        else rv.puts(rev ? "true" : "false");
        rev2_offs[i + 1] = rv.pos;

        // --- qn = QNAME field ---
        if ((vl = aux.find('Q', 'N', &v)) >= 0) qn.put(v, vl);
        else qn.put(qname_flat + qname_off[i], qname_off[i + 1] - qname_off[i]);
        qn_offs[i + 1] = qn.pos;

        // --- cb / umi / sk tag columns ---
        uint8_t ofl = 0;
        if (flag & 0x1) ofl |= 1;
        if (rev) ofl |= 2;
        if (flag & 0x40) ofl |= 16;  // first-in-template (pairing order)
        if ((vl = aux.find('C', 'B', &v)) >= 0) { cb.put(v, vl); ofl |= 4; }
        cb_offs[i + 1] = cb.pos;
        if ((vl = aux.find('U', 'B', &v)) >= 0) { um.put(v, vl); ofl |= 8; }
        else if ((vl = aux.find('U', 'R', &v)) >= 0) { um.put(v, vl); ofl |= 8; }
        umi_offs[i + 1] = um.pos;
        if ((vl = aux.find('S', 'K', &v)) >= 0) sk.put(v, vl);
        sk_offs[i + 1] = sk.pos;

        // --- the 35-field joined metadata prefix ---
        // field order: BAM_FIELDS_TO_REPORT minus indices 1 (QUAL), 15 (SEQ),
        // 37 (SKIP_ALIGN, appended by the pipeline)
        // 0 QNAME
        if ((vl = aux.find('Q', 'N', &v)) >= 0) meta.put(v, vl);
        else meta.put(qname_flat + qname_off[i], qname_off[i + 1] - qname_off[i]);
        meta.putc('\t');
        // 2 REVERSE
        if ((vl = aux.find('R', 'E', &v)) >= 0) meta.put(v, vl);
        else meta.puts(rev ? "true" : "false");
        meta.putc('\t');
        // 3 MATE_REVERSE (prefix MA)
        if ((vl = aux.find('M', 'A', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x20) ? "true" : "false");
        meta.putc('\t');
        // 4 PAIRED (prefix PA)
        if ((vl = aux.find('P', 'A', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x1) ? "true" : "false");
        meta.putc('\t');
        // 5 PROPER_PAIRED (prefix PR)
        if ((vl = aux.find('P', 'R', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x2) ? "true" : "false");
        meta.putc('\t');
        // 6 PAIR_ORIENTATION (prefix PA)
        if ((vl = aux.find('P', 'A', &v)) >= 0) meta.put(v, vl);
        else {
            bool paired = (flag & 0x1) != 0;
            bool unmapped = (flag & 0x4) != 0, munmapped = (flag & 0x8) != 0;
            // rust-htslib 0.40 semantics: same-start mates are undecidable
            // (-> "None"); otherwise leftmost mate's label leads
            if (paired && !unmapped && !munmapped && tid == mtid && pos != mpos) {
                bool first = (flag & 0x40) != 0;
                bool mrev = (flag & 0x20) != 0;
                char self_l[3] = {rev ? 'R' : 'F', first ? '1' : '2', 0};
                char mate_l[3] = {mrev ? 'R' : 'F', first ? '2' : '1', 0};
                if (pos < mpos) { meta.puts(self_l); meta.puts(mate_l); }
                else { meta.puts(mate_l); meta.puts(self_l); }
            } else {
                meta.puts("None");
            }
        }
        meta.putc('\t');
        // 7 UNMAPPED (UN)
        if ((vl = aux.find('U', 'N', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x4) ? "true" : "false");
        meta.putc('\t');
        // 8 MATE_UNMAPPED (MA)
        if ((vl = aux.find('M', 'A', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x8) ? "true" : "false");
        meta.putc('\t');
        // 9 FIRST_IN_TEMPLATE (FI)
        if ((vl = aux.find('F', 'I', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x40) ? "true" : "false");
        meta.putc('\t');
        // 10 LAST_IN_TEMPLATE (LA)
        if ((vl = aux.find('L', 'A', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x80) ? "true" : "false");
        meta.putc('\t');
        // 11 STRAND (ST)
        if ((vl = aux.find('S', 'T', &v)) >= 0) meta.put(v, vl);
        else meta.putc(rev ? '-' : '+');
        meta.putc('\t');
        // 12 MAPQ (MA)
        if ((vl = aux.find('M', 'A', &v)) >= 0) meta.put(v, vl);
        else meta.puti(mapq);
        meta.putc('\t');
        // 13 POS (PO)
        if ((vl = aux.find('P', 'O', &v)) >= 0) meta.put(v, vl);
        else meta.puti(pos);
        meta.putc('\t');
        // 14 MATE_POS (MA)
        if ((vl = aux.find('M', 'A', &v)) >= 0) meta.put(v, vl);
        else meta.puti(mpos);
        meta.putc('\t');
        // 16 SEQ_LEN (SE)
        if ((vl = aux.find('S', 'E', &v)) >= 0) meta.put(v, vl);
        else meta.puti(l_seq);
        meta.putc('\t');
        // 17 INSERT_SIZE (IN)
        if ((vl = aux.find('I', 'N', &v)) >= 0) meta.put(v, vl);
        else meta.puti(tlen);
        meta.putc('\t');
        // 18 QUALITY_FAILED (QU)
        if ((vl = aux.find('Q', 'U', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x200) ? "true" : "false");
        meta.putc('\t');
        // 19 SECONDARY (SE)
        if ((vl = aux.find('S', 'E', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x100) ? "true" : "false");
        meta.putc('\t');
        // 20 DUPLICATE (DU)
        if ((vl = aux.find('D', 'U', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x400) ? "true" : "false");
        meta.putc('\t');
        // 21 SUPPLEMENTARY (SU)
        if ((vl = aux.find('S', 'U', &v)) >= 0) meta.put(v, vl);
        else meta.puts((flag & 0x800) ? "true" : "false");
        meta.putc('\t');
        // 22..36: aux-only fields NH HI AS GN TX AN nM fx RE CR CY CB UR UY UB
        static const char tag_fields[15][2] = {
            {'N','H'},{'H','I'},{'A','S'},{'G','N'},{'T','X'},{'A','N'},
            {'n','M'},{'f','x'},{'R','E'},{'C','R'},{'C','Y'},{'C','B'},
            {'U','R'},{'U','Y'},{'U','B'},
        };
        for (int t = 0; t < 15; ++t) {
            if ((vl = aux.find(tag_fields[t][0], tag_fields[t][1], &v)) >= 0)
                meta.put(v, vl);
            if (t != 14) meta.putc('\t');
        }
        meta_offs[i + 1] = meta.pos;
        oflags[i] = ofl;

        if (meta.overflow || m1.overflow || m15.overflow || rv.overflow ||
            qn.overflow || cb.overflow || um.overflow || sk.overflow)
            return -1;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// BAM run/group emitter: the SortedBamReader + UMIReader index logic
// (UMI-run detection, per-run stable CB sort, dummy-pair expansion, qname
// pairing, UMI x CB[-2] group boundaries) over columnar string data.
// Semantics: `src/parse/sorted_bam_reader.rs:31-162`, `src/parse/bam.rs:178`.
//
// Inputs are the surviving records of the pending stream in order.  oflags
// bit0 = paired, bit4 = first-in-template.  Returns 0 on success, -1 if any
// run contains an unpaired-qname irregularity (caller falls back to the
// Python path, which prints the reference's warnings).
//
// Outputs: emit_idx/emit_skip (0=FALSE,1=TRUE,2=aux-SK) of emitted records,
// group_off boundaries into the emit arrays, n_groups, consumed (= records
// of complete runs; the final possibly-incomplete run is carried unless
// is_final).  The final run of the file is NOT CB-sorted (reference quirk).
// ---------------------------------------------------------------------------
namespace {
struct BytesView {
    const uint8_t* p;
    int64_t len;
    bool operator<(const BytesView& o) const {
        int64_t n = len < o.len ? len : o.len;
        int c = std::memcmp(p, o.p, (size_t)n);
        if (c != 0) return c < 0;
        return len < o.len;
    }
    bool operator==(const BytesView& o) const {
        return len == o.len && std::memcmp(p, o.p, (size_t)len) == 0;
    }
};
}  // namespace

int32_t nimble_bam_runs(
    const int64_t* umi_off, const uint8_t* umi_flat,
    const int64_t* cb_off, const uint8_t* cb_flat,
    const int64_t* qn_off, const uint8_t* qn_flat,
    const uint8_t* oflags,
    int64_t n, int32_t force_paired, int32_t is_final,
    int32_t free_pass_used_in, int64_t groups_started_before,
    int64_t* emit_idx, int8_t* emit_skip, int64_t* emit_cnt,
    int64_t* group_off, int64_t* n_groups,
    int64_t* consumed, int32_t* free_pass_used_out,
    int64_t* ec_at_pass) {
    auto umi = [&](int64_t i) {
        return BytesView{umi_flat + umi_off[i], umi_off[i + 1] - umi_off[i]};
    };
    auto cbv = [&](int64_t i) {
        return BytesView{cb_flat + cb_off[i], cb_off[i + 1] - cb_off[i]};
    };
    auto qn = [&](int64_t i) {
        return BytesView{qn_flat + qn_off[i], qn_off[i + 1] - qn_off[i]};
    };
    // group key: the CONCATENATED string umi + cb[:-2] — the reference
    // compares `read_umi + current_cell_barcode` as one string
    // (`src/parse/bam.rs:178`), so umi/cb boundary shifts that leave the
    // concatenation equal (e.g. "AAAB"+"CD" vs "AAA"+"BCD") are the SAME
    // group; a component-wise compare would split them
    auto key_eq = [&](int64_t a, int64_t b) {
        BytesView ua = umi(a), ub = umi(b);
        BytesView ca = cbv(a), cb2 = cbv(b);
        ca.len = ca.len >= 2 ? ca.len - 2 : 0;
        cb2.len = cb2.len >= 2 ? cb2.len - 2 : 0;
        if (ua.len + ca.len != ub.len + cb2.len) return false;
        for (int64_t i = 0; i < ua.len + ca.len; ++i) {
            uint8_t x = i < ua.len ? ua.p[i] : ca.p[i - ua.len];
            uint8_t y = i < ub.len ? ub.p[i] : cb2.p[i - ub.len];
            if (x != y) return false;
        }
        return true;
    };

    std::vector<int64_t> order;
    std::vector<std::pair<int64_t, int8_t>> buf;  // (idx, skip)
    int64_t ec = 0, gc = 0;
    int64_t last_emitted = -1;  // carry group-key comparisons across runs
    group_off[0] = 0;

    int64_t run_start = 0;
    while (run_start < n) {
        int64_t run_end = run_start + 1;
        while (run_end < n && umi(run_end) == umi(run_start)) ++run_end;
        bool final_run = run_end >= n;
        if (final_run && !is_final) break;  // incomplete run: carry

        order.clear();
        for (int64_t i = run_start; i < run_end; ++i) order.push_back(i);
        if (!final_run) {
            std::stable_sort(order.begin(), order.end(),
                             [&](int64_t a, int64_t b) { return cbv(a) < cbv(b); });
        }

        buf.clear();
        if (!force_paired) {
            for (int64_t i : order) {
                buf.emplace_back(i, 0);
                if (!(oflags[i] & 1)) buf.emplace_back(i, 1);  // dummy TRUE
            }
        } else {
            for (int64_t i : order) buf.emplace_back(i, 2);  // aux SK value
        }

        int64_t m = (int64_t)buf.size();
        int64_t run_emitted = 0;
        for (int64_t j = 0; j + 1 < m; j += 2) {
            int64_t i1 = buf[j].first, i2 = buf[j + 1].first;
            if (!(qn(i1) == qn(i2))) return -1;  // irregular: Python fallback
            int64_t a = i1, b = i2;
            int8_t sa = buf[j].second, sb = buf[j + 1].second;
            if (!(oflags[i1] & 16)) {  // not first-in-template: swap
                a = i2; b = i1;
                sa = buf[j + 1].second; sb = buf[j].second;
            }
            if (last_emitted < 0 || !key_eq(a, last_emitted)) {
                group_off[gc++] = ec;
            }
            emit_idx[ec] = a; emit_skip[ec] = sa; ++ec;
            last_emitted = a;
            if (!key_eq(b, last_emitted)) {
                group_off[gc++] = ec;
            }
            emit_idx[ec] = b; emit_skip[ec] = sb; ++ec;
            last_emitted = b;
            run_emitted += 2;
        }
        run_start = run_end;
        if (run_emitted == 0) {
            // a run that pairs down to NOTHING raises BamTruncatedRecord in
            // the reference (`src/parse/sorted_bam_reader.rs:164-185`); the
            // producer loop (`src/process/bam.rs:163-179`) then BREAKS iff
            // a group was already delivered (has_aligned) — otherwise it
            // sends the (possibly empty) current group and keeps reading:
            // exactly one free pass, consumed on producer iteration 1.
            bool aligned = free_pass_used_in || *free_pass_used_out ||
                           (groups_started_before + gc) >= 2;
            if (!aligned) {
                *free_pass_used_out = 1;
                *ec_at_pass = ec;  // entries after = final ec - this
                last_emitted = -1;  // current group delivered; key resets
                continue;
            }
            // rc=1: outputs valid through this run; stream over, the open
            // group is the stream's final group (the producer's quirk
            // handling drops or keeps it).
            group_off[gc] = ec;
            *emit_cnt = ec;
            *n_groups = gc;
            *consumed = run_start;
            return 1;
        }
    }
    group_off[gc] = ec;
    *emit_cnt = ec;
    *n_groups = gc;
    *consumed = run_start;
    return 0;
}

// 2-bit launch-buffer pack (models/aligner.py::_pack_reads): int8 base
// codes (m, width) + i32 lengths -> rows [0, m) of a caller-zeroed uint8
// (B, nb+2) buffer: nb = ceil(bucket/4) packed-code bytes then the length
// as u16 LE.  Codes are 0..3 by construction (encode LUT); `& 3` keeps the
// pack well-defined regardless.  One buffer per launch: every transfer
// has a fixed latency, so the whole chunk ships as a single contiguous
// array.
void nimble_pack_reads(const int8_t* mat, int64_t m, int64_t width,
                       const int32_t* lens, int64_t bucket, uint8_t* out,
                       int32_t n_threads) {
    const int64_t nb = (bucket + 3) / 4;
    const int64_t stride = nb + 2;
    const int64_t take = width < bucket ? width : bucket;
    auto pack_rows = [=](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const int8_t* row = mat + i * width;
            uint8_t* o = out + i * stride;
            const int64_t full = take & ~int64_t(3);
            int64_t j = 0;
            for (; j < full; j += 4) {
                o[j >> 2] = (uint8_t)((row[j] & 3) | ((row[j + 1] & 3) << 2) |
                                      ((row[j + 2] & 3) << 4) |
                                      ((row[j + 3] & 3) << 6));
            }
            if (j < take) {
                uint8_t v = 0;
                for (int s = 0; j < take; ++j, s += 2)
                    v |= (uint8_t)(row[j] & 3) << s;
                o[full >> 2] = v;
            }
            o[nb] = (uint8_t)(lens[i] & 0xFF);
            o[nb + 1] = (uint8_t)((lens[i] >> 8) & 0xFF);
        }
    };
    int64_t nt = std::min<int64_t>(
        std::max<int32_t>(n_threads, 1),
        std::max<int64_t>(1, (int64_t)std::thread::hardware_concurrency()));
    nt = std::min(nt, std::max<int64_t>(1, m / (1 << 14)));
    if (nt <= 1) {
        pack_rows(0, m);
        return;
    }
    std::vector<std::thread> workers;
    workers.reserve((size_t)nt);
    for (int64_t t = 0; t < nt; ++t)
        workers.emplace_back(pack_rows, m * t / nt, m * (t + 1) / nt);
    for (auto& w : workers) w.join();
}

// Ragged row gather: out row j = in row idx[j].  offs_out must be the
// exclusive prefix sum of the gathered row lengths (computed by the
// caller, which also sizes flat_out).  Replaces numpy fancy-indexed
// gathers whose int64 index temporaries dwarf the payload.
void nimble_take_rows(
    const int64_t* offs_in, const uint8_t* flat_in,
    const int64_t* idx, int64_t k,
    const int64_t* offs_out, uint8_t* flat_out) {
    for (int64_t j = 0; j < k; ++j) {
        int64_t i = idx[j];
        int64_t len = offs_in[i + 1] - offs_in[i];
        std::memcpy(flat_out + offs_out[j], flat_in + offs_in[i], (size_t)len);
    }
}

// Oriented padded code matrix + its ASCII decode in ONE pass
// (pipeline/bam_fast._prepare_batch's matrix-fill / revcomp-gather /
// decode-LUT chain, `src/process/bam.rs:322-326` orientation): flat
// ragged int8 base codes + i64 offsets + per-row rev flags ->
//   oriented (n, W) int8: row i = codes (reverse-complemented when
//     rev[i], complement = 3 - code), 0 beyond the row's length
//   dec     (n, W) uint8: "ACGT"[oriented] ('A' = LUT[0] beyond length,
//     matching the NumPy _DECODE_LUT[oriented] construction byte-for-byte)
// Codes are 0..3 by construction (encode LUT); `& 3` keeps the pass
// well-defined regardless (defensive parity, same posture as pack_reads).
void nimble_orient_decode(const int8_t* flat, const int64_t* offs,
                          const uint8_t* rev, int64_t n, int64_t W,
                          int8_t* oriented, uint8_t* dec,
                          int32_t n_threads) {
    static const char LUT[4] = {'A', 'C', 'G', 'T'};
    auto run_rows = [=](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            const int64_t start = offs[i];
            const int64_t len = offs[i + 1] - start;
            const int8_t* src = flat + start;
            int8_t* orow = oriented + i * W;
            uint8_t* drow = dec + i * W;
            if (rev[i]) {
                for (int64_t j = 0; j < len; ++j) {
                    int8_t c = (int8_t)(3 - (src[len - 1 - j] & 3));
                    orow[j] = c;
                    drow[j] = (uint8_t)LUT[c & 3];
                }
            } else {
                for (int64_t j = 0; j < len; ++j) {
                    int8_t c = src[j];
                    orow[j] = c;
                    drow[j] = (uint8_t)LUT[c & 3];
                }
            }
            if (len < W) {
                std::memset(orow + len, 0, (size_t)(W - len));
                std::memset(drow + len, 'A', (size_t)(W - len));
            }
        }
    };
    int64_t nt = std::min<int64_t>(
        std::max<int32_t>(n_threads, 1),
        std::max<int64_t>(1, (int64_t)std::thread::hardware_concurrency()));
    nt = std::min(nt, std::max<int64_t>(1, n / (1 << 13)));
    if (nt <= 1) {
        run_rows(0, n);
        return;
    }
    std::vector<std::thread> workers;
    workers.reserve((size_t)nt);
    for (int64_t t = 0; t < nt; ++t)
        workers.emplace_back(run_rows, n * t / nt, n * (t + 1) / nt);
    for (auto& w : workers) w.join();
}

// Single-pass MAXINFO trimmer over a ragged quality column
// (parity with `maxinfo`, reference src/align.rs:873-925: i64 wrapping
// accumulation of the fixed-point tables, f64 ">="-argmax keeping the
// LAST max, 0 when the max is 0.0).  qp has MAXQUAL+1=61 entries, ls has
// LONGEST_READ=1000 entries; both precomputed (and normalized) in Python.
int32_t nimble_maxinfo(
    int64_t n, const int64_t* offs, const uint8_t* flat,
    const int64_t* ls, const int64_t* qp, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t start = offs[i];
        int64_t len = offs[i + 1] - start;
        if (len <= 0) { out[i] = 0; continue; }
        const uint8_t* q = flat + start;
        uint64_t acc = 0;
        double maxs = -1e308 * 10.0;
        int64_t best = 0;
        for (int64_t j = 0; j < len; ++j) {
            uint8_t qv = q[j] > 60 ? 60 : q[j];
            acc += (uint64_t)qp[qv];                     // wrapping i64 +=
            uint64_t s = acc + (uint64_t)(j < 1000 ? ls[j] : 0);
            double sf = (double)(int64_t)s;
            if (sf >= maxs) { maxs = sf; best = j + 1; } // last max wins
        }
        out[i] = (best < 1 || maxs == 0.0) ? 0 : (best < len ? best : len);
    }
    return 0;
}

void* nimble_dedupe_new() { return new DedupSet(); }

void nimble_dedupe_free(void* handle) { delete static_cast<DedupSet*>(handle); }

int64_t nimble_dedupe_size(void* handle) {
    return (int64_t)static_cast<DedupSet*>(handle)->count;
}

// r1/r2 are the flattened exact-length read bytes; offsets have n+1 entries.
// r2 may be null (single-end).  out_is_new[i]=1 iff the pair was unseen.
// Returns the number of new pairs.
int64_t nimble_dedupe_insert(
    void* handle,
    const int8_t* r1, const int64_t* off1,
    const int8_t* r2, const int64_t* off2,
    int64_t n, uint8_t* out_is_new) {
    auto* set = static_cast<DedupSet*>(handle);
    int64_t n_new = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* a = reinterpret_cast<const uint8_t*>(r1) + off1[i];
        size_t la = (size_t)(off1[i + 1] - off1[i]);
        bool inserted;
        if (r2 != nullptr) {
            // the reference's score-map key is the PLAIN concatenation
            // r1_str + r2_str (`src/align.rs:576-579`): different (r1, r2)
            // splits with an equal concatenation are the SAME key — no
            // separator byte
            const uint8_t* b = reinterpret_cast<const uint8_t*>(r2) + off2[i];
            size_t lb = (size_t)(off2[i + 1] - off2[i]);
            inserted = set->insert2(a, la, b, lb);
        } else {
            inserted = set->insert2(a, la, nullptr, 0);
        }
        out_is_new[i] = inserted ? 1 : 0;
        n_new += inserted;
    }
    return n_new;
}

// ---------------------------------------------------------------------------
// BAM forensic-row assembler: the per-group score-map / zero-row / re-key /
// row-formatting logic of the fast BAM pipeline's host tail
// (`src/process/bam.rs:305-405` + the logger row format `:103-121`),
// byte-identical to pipeline/bam_fast.py's Python loop.
//
// The orientation pipeline itself stays in Python (memoized per distinct
// (content1, content2) combination — few per run); its results arrive here
// as a (combo_key -> kind/callset-id/triage-bytes) table.  combo_key =
// (c1+1)*(n_contents+1)+(c2+1).
//
// Returns 0 ok; -1 output overflow (caller doubles the buffer); -2 invalid
// character under revcomp (caller falls back to the Python path for the
// reference's exact panic message).
// ---------------------------------------------------------------------------
namespace {

struct RowOut {
    uint8_t* buf;
    int64_t pos, cap;
    bool overflow;
    void put(const uint8_t* src, int64_t n) {
        if (pos + n > cap) { overflow = true; return; }
        std::memcpy(buf + pos, src, n);
        pos += n;
    }
    void putc(char c) {
        if (pos + 1 > cap) { overflow = true; return; }
        buf[pos++] = (uint8_t)c;
    }
    void puts(const char* s) { put((const uint8_t*)s, (int64_t)std::strlen(s)); }
    void puti(int64_t v) {
        char tmp[24];
        int n = 0;
        if (v < 0) { putc('-'); v = -v; }
        if (v == 0) tmp[n++] = '0';
        while (v > 0) { tmp[n++] = (char)('0' + v % 10); v /= 10; }
        while (n > 0) putc(tmp[--n]);
    }
};

// revcomp table mirroring utils.revcomp (`src/utils.rs:61-94`): ACGT/U case-
// preserving, N passthrough; 0 = invalid (reference panics)
struct RcTable {
    uint8_t t[256];
    RcTable() {
        std::memset(t, 0, sizeof(t));
        const char* from = "acgtuACGTUnN";
        const char* to = "tgcaaTGCAANN";
        for (int i = 0; from[i]; ++i) t[(uint8_t)from[i]] = (uint8_t)to[i];
    }
};
const RcTable kRc;

}  // namespace

int32_t nimble_bam_rows(
    int64_t n_rec, int64_t W,
    const uint8_t* dec_flat, const int64_t* dlens,
    const int64_t* cid, const int64_t* scid_of,
    const int64_t* score, const int64_t* code,
    const uint8_t* rev,
    const int64_t* group_off, int64_t n_groups,
    int32_t require_pair, int64_t code_not_matching, int64_t n_contents,
    const int64_t* combo_keys, const uint8_t* combo_kind,
    const int64_t* combo_csid,
    const int64_t* combo_tri_off, const uint8_t* combo_tri_flat,
    int64_t n_combos,
    const int64_t* cs_rank, const int64_t* cs_off, const uint8_t* cs_flat,
    const int64_t* qn_off, const uint8_t* qn_flat,
    const int64_t* s15_off, const uint8_t* s15_flat,
    const int64_t* meta_off, const uint8_t* meta_flat,
    const int64_t* skip_off, const uint8_t* skip_flat,
    const int64_t* reason_off, const uint8_t* reason_flat,
    uint8_t* out_buf, int64_t out_cap, int64_t* out_len) {
    (void)n_rec;
    RowOut out{out_buf, 0, out_cap, false};

    std::unordered_map<int64_t, int64_t> combo_map;
    combo_map.reserve((size_t)n_combos * 2 + 8);
    for (int64_t i = 0; i < n_combos; ++i) combo_map.emplace(combo_keys[i], i);

    struct FR { int64_t c1, s1, c2, s2; };
    struct SM { int64_t c1, c2, g1, g2; };
    struct Res { int64_t csid, count, g1, g2; };

    // per-group scratch, reused across groups
    std::unordered_map<std::string, FR> filter_reasons;
    std::unordered_map<std::string, int64_t> score_pos;   // key -> index
    std::vector<std::pair<std::string, SM>> score_vec;    // insertion order
    std::unordered_map<std::string, int64_t> post_triaged;  // key -> combo idx
    std::unordered_map<int64_t, int64_t> res_pos;         // csid -> index
    std::vector<Res> results;
    std::unordered_set<std::string> scored_qnames;
    std::string key, rekey;

    auto put_col = [&](const int64_t* off, const uint8_t* flat, int64_t i) {
        out.put(flat + off[i], off[i + 1] - off[i]);
    };

    for (int64_t gi = 0; gi < n_groups; ++gi) {
        int64_t lo = group_off[gi], hi = group_off[gi + 1];
        int64_t n_pairs = (hi - lo) / 2;
        if (n_pairs == 0) continue;
        filter_reasons.clear();
        score_pos.clear();
        score_vec.clear();
        post_triaged.clear();
        res_pos.clear();
        results.clear();
        scored_qnames.clear();

        for (int64_t p = 0; p < n_pairs; ++p) {
            int64_t i1 = lo + 2 * p, i2 = i1 + 1;
            int64_t c1 = cid[i1], c2 = cid[i2];
            key.assign((const char*)dec_flat + i1 * W, (size_t)dlens[i1]);
            key.append((const char*)dec_flat + i2 * W, (size_t)dlens[i2]);

            if (require_pair &&
                (c1 < 0 || c2 < 0 ||
                 (c1 != c2 && scid_of[c1] != scid_of[c2]))) {
                filter_reasons[key] = FR{code_not_matching, score[i1],
                                         code_not_matching, score[i2]};
                continue;
            }
            filter_reasons[key] = FR{code[i1], score[i1], code[i2], score[i2]};
            if (c1 >= 0 || c2 >= 0) {
                auto it = score_pos.find(key);
                if (it == score_pos.end()) {
                    score_pos.emplace(key, (int64_t)score_vec.size());
                    score_vec.emplace_back(key, SM{c1, c2, i1, i2});
                } else {
                    score_vec[(size_t)it->second].second = SM{c1, c2, i1, i2};
                }
            }
        }

        // orientation results accumulation (`src/align.rs:440-449`)
        for (auto& kv : score_vec) {
            const SM& sm = kv.second;
            int64_t ck = (sm.c1 + 1) * (n_contents + 1) + (sm.c2 + 1);
            auto it = combo_map.find(ck);
            if (it == combo_map.end()) return -3;  // pre-pass bug guard
            int64_t ci = it->second;
            if (combo_kind[ci] == 0) {
                int64_t csid = combo_csid[ci];
                auto rit = res_pos.find(csid);
                if (rit == res_pos.end()) {
                    res_pos.emplace(csid, (int64_t)results.size());
                    results.push_back(Res{csid, 1, sm.g1, sm.g2});
                } else {
                    Res& r = results[(size_t)rit->second];
                    r.count += 1;
                    r.g1 = sm.g1;
                    r.g2 = sm.g2;
                }
            } else {
                post_triaged[kv.first] = ci;
            }
        }

        // sort_score_vector (`src/utils.rs:54-59`): ranks are the global
        // lexicographic order of the interned callsets
        std::sort(results.begin(), results.end(),
                  [&](const Res& a, const Res& b) {
                      return cs_rank[a.csid] < cs_rank[b.csid];
                  });
        if (results.empty()) continue;  // no zero rows either (`bam.rs:315-330`)

        for (const Res& r : results)
            scored_qnames.emplace(
                (const char*)qn_flat + qn_off[r.g1],
                (size_t)(qn_off[r.g1 + 1] - qn_off[r.g1]));

        int64_t n_out = (int64_t)results.size();
        // zero rows: pairs whose qname produced no scored callset
        std::vector<Res> zero_rows;
        for (int64_t p = 0; p < n_pairs; ++p) {
            int64_t g1 = lo + 2 * p, g2 = g1 + 1;
            std::string qn2((const char*)qn_flat + qn_off[g2],
                            (size_t)(qn_off[g2 + 1] - qn_off[g2]));
            if (scored_qnames.count(qn2)) continue;
            zero_rows.push_back(Res{-1, 0, g1, g2});
        }

        for (int64_t ri = 0; ri < n_out + (int64_t)zero_rows.size(); ++ri) {
            const Res& r = ri < n_out ? results[(size_t)ri]
                                      : zero_rows[(size_t)(ri - n_out)];
            // forensic re-key from metadata SEQ/REVERSE
            // (`src/process/bam.rs:355-396`)
            rekey.clear();
            for (int side = 0; side < 2; ++side) {
                int64_t g = side == 0 ? r.g1 : r.g2;
                const uint8_t* s = s15_flat + s15_off[g];
                int64_t L = s15_off[g + 1] - s15_off[g];
                if (rev[g]) {
                    for (int64_t j = L - 1; j >= 0; --j) {
                        uint8_t c = kRc.t[s[j]];
                        if (c == 0) return -2;  // reference panics; Python path
                        rekey.push_back((char)c);
                    }
                } else {
                    rekey.append((const char*)s, (size_t)L);
                }
            }

            if (r.csid >= 0)
                out.put(cs_flat + cs_off[r.csid],
                        cs_off[r.csid + 1] - cs_off[r.csid]);
            out.putc('\t');
            out.puti(r.count);
            out.putc('\t');
            // r1/r2 swap quirk (`src/process/bam.rs:103-120`)
            put_col(meta_off, meta_flat, r.g2); out.putc('\t');
            put_col(skip_off, skip_flat, r.g2); out.putc('\t');
            put_col(meta_off, meta_flat, r.g1); out.putc('\t');
            put_col(skip_off, skip_flat, r.g1); out.putc('\t');

            auto fit = filter_reasons.find(rekey);
            const char* none_pair = "None\t0";
            if (fit != filter_reasons.end()) {
                const FR& v = fit->second;
                auto put_side = [&](int64_t code_i, int64_t s) {
                    out.put(reason_flat + reason_off[code_i],
                            reason_off[code_i + 1] - reason_off[code_i]);
                    out.putc('\t');
                    out.puti(s);
                };
                put_side(v.c2, v.s2); out.putc('\t');     // v1 (R2 record)
                out.puts(none_pair); out.putc('\t');       // v3
                put_side(v.c1, v.s1); out.putc('\t');     // v0 (R1 record)
                out.puts(none_pair); out.putc('\t');       // v2
                auto tit = post_triaged.find(rekey);
                if (tit != post_triaged.end()) {
                    int64_t ci = tit->second;
                    out.put(combo_tri_flat + combo_tri_off[ci],
                            combo_tri_off[ci + 1] - combo_tri_off[ci]);
                } else {
                    out.puts("None\tNone");
                }
            } else {
                out.puts(none_pair); out.putc('\t');
                out.puts(none_pair); out.putc('\t');
                out.puts(none_pair); out.putc('\t');
                out.puts(none_pair); out.putc('\t');
                out.puts("None\tNone");
            }
            out.putc('\n');
            if (out.overflow) return -1;
        }
    }
    *out_len = out.pos;
    return out.overflow ? -1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// BGZF: parallel block inflater.  Fills the role of htslib's multi-threaded
// BGZF decompression (`src/parse/sorted_bam_reader.rs:1` inherits it from C
// htslib): BGZF members are independent gzip blocks <=64KB, so a chunk of
// raw file bytes splits into blocks that inflate concurrently.
// ---------------------------------------------------------------------------

namespace {

struct BgzfBlock {
    int64_t comp_off;   // offset of the DEFLATE payload
    int64_t comp_len;   // payload length (excludes CRC32+ISIZE trailer)
    int64_t out_off;    // offset in the decompressed output
    uint32_t isize;     // expected decompressed size
    uint32_t crc;       // expected CRC32 of the decompressed bytes
};

inline uint16_t le16(const uint8_t* p) {
    return (uint16_t)(p[0] | ((uint16_t)p[1] << 8));
}
inline uint32_t le32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

// Parse complete BGZF members from data[0..n).  Returns 0 and the parsed
// blocks on success; 1 when the stream is gzip-but-not-BGZF at offset 0
// (caller falls back to a plain gzip reader); 2 on a malformed/corrupt
// header past offset 0.  A member extending past `n` is left unconsumed.
int bgzf_parse(const uint8_t* data, int64_t n, std::vector<BgzfBlock>* blocks,
               int64_t* consumed, int64_t* total_isize) {
    int64_t p = 0, out = 0;
    while (n - p >= 28) {  // minimum BGZF block size
        if (!(data[p] == 0x1f && data[p + 1] == 0x8b && data[p + 2] == 8 &&
              (data[p + 3] & 0x04))) {
            if (p == 0) return 1;
            return 2;
        }
        int64_t xlen = le16(data + p + 10);
        if (p + 12 + xlen + 8 > n) break;  // header tail not in buffer yet
        int64_t bsize = -1;
        for (int64_t q = p + 12; q + 4 <= p + 12 + xlen;) {
            uint16_t slen = le16(data + q + 2);
            if (data[q] == 'B' && data[q + 1] == 'C' && slen == 2) {
                bsize = (int64_t)le16(data + q + 4) + 1;
                break;
            }
            q += 4 + slen;
        }
        if (bsize < 0) return p == 0 ? 1 : 2;
        if (bsize < 12 + xlen + 8) return 2;
        if (p + bsize > n) break;  // partial block: wait for more bytes
        BgzfBlock b;
        b.comp_off = p + 12 + xlen;
        b.comp_len = bsize - 12 - xlen - 8;
        b.out_off = out;
        b.crc = le32(data + p + bsize - 8);
        b.isize = le32(data + p + bsize - 4);
        out += b.isize;
        blocks->push_back(b);
        p += bsize;
    }
    *consumed = p;
    *total_isize = out;
    return 0;
}

// Inflate a contiguous range of blocks; returns 0 ok, 3 inflate error,
// 4 CRC mismatch, 5 ISIZE mismatch.
int bgzf_inflate_range(const uint8_t* data, const BgzfBlock* blocks,
                       int64_t lo, int64_t hi, uint8_t* out) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return 3;
    int err = 0;
    for (int64_t i = lo; i < hi && !err; ++i) {
        const BgzfBlock& b = blocks[i];
        if (b.isize == 0) continue;  // EOF-marker block
        zs.next_in = (Bytef*)(data + b.comp_off);
        zs.avail_in = (uInt)b.comp_len;
        zs.next_out = out + b.out_off;
        zs.avail_out = b.isize;
        int rc = inflate(&zs, Z_FINISH);
        if (rc != Z_STREAM_END || zs.avail_out != 0)
            err = (rc == Z_STREAM_END) ? 5 : 3;
        else if (crc32(crc32(0, Z_NULL, 0), out + b.out_off, b.isize) != b.crc)
            err = 4;
        if (!err && inflateReset2(&zs, -15) != Z_OK) err = 3;
    }
    inflateEnd(&zs);
    return err;
}

}  // namespace

extern "C" {

// Content-hash read ownership for the multi-host exchange: FNV-1a over each
// row's EXACT lens[i] bytes (never the padded tail, so hosts holding the
// same read at different pad widths agree), the length mixed in, then the
// mate's bytes+length when paired.  Threaded over row ranges.
void nimble_owner_hash(const int8_t* mat, int64_t n, int64_t w,
                       const int32_t* lens,
                       const int8_t* mate, int64_t mw,
                       const int32_t* mate_lens,
                       int64_t n_hosts, int64_t n_threads,
                       int64_t* owner_out) {
    auto run = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            uint64_t h = 0x811C9DC5ULL;
            const int8_t* r = mat + i * w;
            int64_t L = lens[i] < w ? lens[i] : w;
            for (int64_t j = 0; j < L; ++j)
                h = (h ^ (uint8_t)r[j]) * 0x100000001B3ULL;
            h = (h ^ (uint64_t)lens[i]) * 0x100000001B3ULL;
            if (mate) {
                const int8_t* m = mate + i * mw;
                int64_t ML = mate_lens[i] < mw ? mate_lens[i] : mw;
                for (int64_t j = 0; j < ML; ++j)
                    h = (h ^ (uint8_t)m[j]) * 0x100000001B3ULL;
                h = (h ^ (uint64_t)mate_lens[i]) * 0x100000001B3ULL;
            }
            owner_out[i] = (int64_t)(h % (uint64_t)n_hosts);
        }
    };
    int64_t nt = std::min<int64_t>(
        std::max<int64_t>(n_threads, 1),
        std::max<int64_t>(1, (int64_t)std::thread::hardware_concurrency()));
    if (nt <= 1 || n < (1 << 16)) {
        run(0, n);
        return;
    }
    std::vector<std::thread> workers;
    for (int64_t t = 0; t < nt; ++t) {
        int64_t lo = n * t / nt, hi = n * (t + 1) / nt;
        workers.emplace_back(run, lo, hi);
    }
    for (auto& ww : workers) ww.join();
}

// Scan+inflate one raw chunk.  Writes the decompressed bytes of every
// COMPLETE member into `out` (caller sizes it via nimble_bgzf_sizes).
// Returns 0 ok, 1 not-BGZF-at-0, 2 malformed header, 3 inflate error,
// 4 CRC mismatch, 5 ISIZE mismatch.
int32_t nimble_bgzf_sizes(const uint8_t* data, int64_t n,
                          int64_t* consumed, int64_t* total_isize) {
    std::vector<BgzfBlock> blocks;
    return bgzf_parse(data, n, &blocks, consumed, total_isize);
}

int32_t nimble_bgzf_inflate(const uint8_t* data, int64_t n,
                            uint8_t* out, int64_t out_cap,
                            int32_t n_threads) {
    std::vector<BgzfBlock> blocks;
    int64_t consumed = 0, total = 0;
    int rc = bgzf_parse(data, n, &blocks, &consumed, &total);
    if (rc) return rc;
    if (total > out_cap) return 5;
    int64_t nb = (int64_t)blocks.size();
    if (nb == 0) return 0;
    int64_t nt = std::min<int64_t>(
        std::max<int32_t>(n_threads, 1),
        std::max<int64_t>(1, (int64_t)std::thread::hardware_concurrency()));
    if (nt <= 1 || total < (1 << 20) || nb < 2)
        return bgzf_inflate_range(data, blocks.data(), 0, nb, out);
    nt = std::min(nt, nb);
    std::atomic<int> err{0};
    std::vector<std::thread> workers;
    workers.reserve((size_t)nt);
    for (int64_t t = 0; t < nt; ++t) {
        int64_t lo = nb * t / nt, hi = nb * (t + 1) / nt;
        workers.emplace_back([&, lo, hi] {
            int e = bgzf_inflate_range(data, blocks.data(), lo, hi, out);
            if (e) err.store(e, std::memory_order_relaxed);
        });
    }
    for (auto& w : workers) w.join();
    return err.load(std::memory_order_relaxed);
}

}  // extern "C"

// ===========================================================================
// BamPipe: the BAM producer as a native pipeline stage.
//
// The reference's producer is one htslib C thread streaming UMI groups into
// a bounded channel (`src/process/bam.rs:149,157-180`).  Here the whole
// producer front half — file read, parallel BGZF inflate, record scan,
// metadata derivation, skip filtering and UMI-run/pair/group emission —
// runs on a DEDICATED C++ worker thread that never touches the GIL,
// handing Python fully-formed, emission-ready column batches through a
// bounded slot queue (so inflate/scan of chunk n+1 overlaps consumption of
// chunk n).  Irregular streams (unpaired-qname warnings, which need the
// reference's exact stderr output) hand the raw record columns back to the
// Python fallback and resume from its ack.
//
// Semantics are identical to nimble_tpu/io/bam_columnar.py's
// ColumnarGroupStream (the pure-Python orchestration of these same
// kernels); that class remains the fallback and the parity reference.
// ===========================================================================

namespace bampipe {

static inline double now_s() {
    return std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

struct Ragged {
    std::vector<int64_t> offs{0};
    std::vector<uint8_t> flat;
    int64_t n() const { return (int64_t)offs.size() - 1; }
    void clear() { offs.assign(1, 0); flat.clear(); }
    void push(const uint8_t* p, int64_t len) {
        flat.insert(flat.end(), p, p + len);
        offs.push_back((int64_t)flat.size());
    }
    void push_cstr(const char* s) {
        push((const uint8_t*)s, (int64_t)std::strlen(s));
    }
    void append_row(const Ragged& src, int64_t i) {
        push(src.flat.data() + src.offs[i], src.offs[i + 1] - src.offs[i]);
    }
    const uint8_t* row(int64_t i) const { return flat.data() + offs[i]; }
    int64_t row_len(int64_t i) const { return offs[i + 1] - offs[i]; }
    void drop_front(int64_t k) {
        if (k <= 0) return;
        int64_t cut = offs[k];
        flat.erase(flat.begin(), flat.begin() + cut);
        offs.erase(offs.begin(), offs.begin() + k);
        for (auto& o : offs) o -= cut;
    }
    // append rows of (offs,flat) scratch filtered by a keep mask
    void append_filtered(const int64_t* soffs, const uint8_t* sflat,
                         const uint8_t* keep, int64_t n) {
        for (int64_t i = 0; i < n; ++i)
            if (keep[i]) push(sflat + soffs[i], soffs[i + 1] - soffs[i]);
    }
};

// scanned + filtered records awaiting run emission (the Python _Carry)
struct ColumnSet {
    Ragged meta, meta1, meta15, rev2, qn, sk, cb, umi, qname_raw, seq;
    std::vector<uint8_t> oflags;
    int64_t n() const { return (int64_t)oflags.size(); }
    void clear() {
        meta.clear(); meta1.clear(); meta15.clear(); rev2.clear();
        qn.clear(); sk.clear(); cb.clear(); umi.clear(); qname_raw.clear();
        seq.clear(); oflags.clear();
    }
    void drop_front(int64_t k) {
        if (k <= 0) return;
        meta.drop_front(k); meta1.drop_front(k); meta15.drop_front(k);
        rev2.drop_front(k); qn.drop_front(k); sk.drop_front(k);
        cb.drop_front(k); umi.drop_front(k); qname_raw.drop_front(k);
        seq.drop_front(k);
        oflags.erase(oflags.begin(), oflags.begin() + k);
    }
};

struct Slot {
    int32_t kind = 0;  // 0 emit, 1 irregular carry, 2 terminal
    // --- emit payload (pend-ready columns, already row-taken) ---
    Ragged e_meta, e_skipb, e_qual, e_rev2, e_seq15, e_qn, e_seq;
    std::vector<uint8_t> skip_true;
    std::vector<int64_t> group_starts;
    int32_t truncated = 0;
    // --- irregular payload ---
    ColumnSet carry;
    int32_t at_eof = 0, missing_umi = 0;
    // --- terminal payload / state snapshot ---
    int32_t error_kind = 0;  // 0 clean, 1 truncated BAM, 2 missing UMI,
                             // 3 gzip error, 4 gzip EOF mid-member
    int32_t gz_status = 0;
    int32_t free_pass_used = 0;
    int64_t groups_started_total = 0;
    int64_t entries_since_pass = 0;
    void clear_emit() {
        e_meta.clear(); e_skipb.clear(); e_qual.clear(); e_rev2.clear();
        e_seq15.clear(); e_qn.clear(); e_seq.clear();
        skip_true.clear(); group_starts.clear();
        truncated = 0;
    }
};

struct Pipe {
    static constexpr int kSlots = 4;
    static constexpr int64_t kRawChunk = 4 << 20;

    // stage profile (worker-private; printed at exit when NIMBLE_PIPE_PROF)
    double t_read = 0, t_inflate = 0, t_scan = 0, t_emit = 0, t_slot = 0;
    double t_bscan = 0, t_meta = 0, t_append = 0; int n_meta = 0;

    std::FILE* f = nullptr;
    int32_t force_paired = 0;

    // stream buffers (worker-private)
    std::vector<uint8_t> raw;  // compressed carry
    std::vector<uint8_t> bam;  // inflated, not yet scanned
    ColumnSet carry;
    bool raw_eof = false;
    bool missing_umi = false;
    int gz_err = 0;
    bool gz_eof_mid = false;

    // run state (worker-private; snapshotted into slots)
    int32_t free_pass_used = 0;
    int64_t groups_started_total = 0;
    int64_t entries_since_pass = 0;

    // scan/meta scratch with persistent capacity (worker-private)
    std::vector<int32_t> s_fixed;
    std::vector<int64_t> s_qn_off, s_seq_off, s_qual_off, s_aux_off, s_cig_off;
    std::vector<uint8_t> s_qn, s_seq, s_qual, s_aux;
    std::vector<uint32_t> s_cig;
    std::vector<int64_t> m_offs[9];   // meta,seq2,meta1,meta15,rev2,qn,cb,umi,sk
    std::vector<uint8_t> m_flat[9];
    std::vector<uint8_t> s_oflags, s_keep;
    std::vector<int64_t> r_emit_idx, r_group_off;
    std::vector<int8_t> r_emit_skip;

    // queue
    std::mutex mu;
    std::condition_variable cv;
    std::deque<Slot*> ready;
    std::vector<Slot*> freelist;
    Slot* handed = nullptr;
    bool awaiting_ack = false, got_ack = false, ack_stop = false;
    int64_t ack_consumed = 0;
    int32_t ack_free_pass = 0;
    int64_t ack_groups = 0, ack_entries = 0;
    bool closed = false;
    std::thread worker;

    ~Pipe() {
        if (f) std::fclose(f);
        for (Slot* s : freelist) delete s;
        for (Slot* s : ready) delete s;
        delete handed;
    }
};

// read one raw chunk and inflate complete BGZF members onto pipe->bam.
// Returns false on a sticky gzip error (gz_err / gz_eof_mid set).
bool ingest(Pipe* P) {
    if (!P->raw_eof) {
        double t0 = now_s();
        size_t old = P->raw.size();
        P->raw.resize(old + (size_t)Pipe::kRawChunk);
        size_t got = std::fread(P->raw.data() + old, 1,
                                (size_t)Pipe::kRawChunk, P->f);
        P->raw.resize(old + got);
        if (got < (size_t)Pipe::kRawChunk) P->raw_eof = true;
        P->t_read += now_s() - t0;
    }
    double t1 = now_s();
    if (P->raw.empty()) return true;
    std::vector<BgzfBlock> blocks;
    int64_t consumed = 0, total = 0;
    int rc = bgzf_parse(P->raw.data(), (int64_t)P->raw.size(), &blocks,
                        &consumed, &total);
    if (rc) { P->gz_err = rc; return false; }
    if (consumed == 0) {
        if (P->raw_eof) { P->gz_eof_mid = true; return false; }
        return true;
    }
    size_t old = P->bam.size();
    P->bam.resize(old + (size_t)total);
    int64_t nb = (int64_t)blocks.size();
    int nt = (int)std::min<int64_t>(
        4, std::max<int64_t>(1, (int64_t)std::thread::hardware_concurrency()));
    int err = 0;
    if (nt <= 1 || nb < 4) {
        err = bgzf_inflate_range(P->raw.data(), blocks.data(), 0, nb,
                                 P->bam.data() + old);
    } else {
        std::atomic<int> aerr{0};
        std::vector<std::thread> ws;
        for (int t = 0; t < nt; ++t) {
            int64_t lo = nb * t / nt, hi = nb * (t + 1) / nt;
            ws.emplace_back([&, lo, hi] {
                int e = bgzf_inflate_range(P->raw.data(), blocks.data(), lo,
                                           hi, P->bam.data() + old);
                if (e) aerr.store(e, std::memory_order_relaxed);
            });
        }
        for (auto& w : ws) w.join();
        err = aerr.load(std::memory_order_relaxed);
    }
    if (err) { P->gz_err = err; return false; }
    P->raw.erase(P->raw.begin(), P->raw.begin() + consumed);
    P->t_inflate += now_s() - t1;
    return true;
}

// scan + meta + skip-filter whatever complete records sit in pipe->bam,
// appending survivors to the carry.  Returns records appended (post-filter
// count may be 0 even when records were consumed — reported via *consumed).
int64_t scan_once(Pipe* P, int64_t* scanned) {
    *scanned = 0;
    int64_t nbytes = (int64_t)P->bam.size();
    if (nbytes == 0) return 0;
    int64_t max_rec = nbytes / 36 + 1;
    P->s_fixed.resize((size_t)(max_rec * 8));
    P->s_qn_off.resize((size_t)(max_rec + 1));
    P->s_seq_off.resize((size_t)(max_rec + 1));
    P->s_qual_off.resize((size_t)(max_rec + 1));
    P->s_aux_off.resize((size_t)(max_rec + 1));
    P->s_cig_off.resize((size_t)(max_rec + 1));
    P->s_qn.resize((size_t)nbytes + 16);
    P->s_seq.resize((size_t)(2 * nbytes) + 16);
    P->s_qual.resize((size_t)nbytes + 16);
    P->s_aux.resize((size_t)nbytes + 16);
    P->s_cig.resize((size_t)(nbytes / 4) + 4);
    int64_t consumed = 0;
    double tb = now_s();
    int64_t cnt = nimble_bam_scan(
        P->bam.data(), nbytes, max_rec, P->s_fixed.data(),
        P->s_qn_off.data(), P->s_qn.data(), P->s_seq_off.data(),
        P->s_seq.data(), P->s_qual_off.data(), P->s_qual.data(),
        P->s_aux_off.data(), P->s_aux.data(), P->s_cig_off.data(),
        P->s_cig.data(), &consumed);
    P->t_bscan += now_s() - tb;
    if (cnt == 0) return 0;
    *scanned = cnt;
    P->bam.erase(P->bam.begin(), P->bam.begin() + consumed);

    // meta derivation: analytic per-column caps (the same sizing the
    // Python pool uses, nimble_tpu/native.py bam_meta) so the first call
    // virtually never retries; retry-double remains the safety net
    for (int j = 0; j < 9; ++j) P->m_offs[j].resize((size_t)(cnt + 1));
    {
        int64_t qn_total = P->s_qn_off[(size_t)cnt];
        int64_t seq_total = P->s_seq_off[(size_t)cnt];
        int64_t qual_total = P->s_qual_off[(size_t)cnt];
        int64_t aux_total = P->s_aux_off[(size_t)cnt];
        const int64_t caps[9] = {
            qn_total + aux_total * 16 + 240 * cnt + 64,  // meta
            seq_total + 64,                              // seq2
            qual_total + aux_total + 64,                 // meta1
            seq_total + aux_total + 64,                  // meta15
            5 * cnt + aux_total + 64,                    // rev2
            qn_total + aux_total + 64,                   // qn
            aux_total + 64,                              // cb
            aux_total + 64,                              // umi
            aux_total + 64,                              // sk
        };
        for (int j = 0; j < 9; ++j)
            if (P->m_flat[j].size() < (size_t)caps[j])
                P->m_flat[j].resize((size_t)caps[j]);
    }
    P->s_oflags.resize((size_t)cnt);
    double tm = now_s();
    while (true) {
        P->n_meta++;
        int32_t rc = nimble_bam_meta(
            P->s_fixed.data(), P->s_qn_off.data(), P->s_qn.data(),
            P->s_seq_off.data(), P->s_seq.data(), P->s_qual_off.data(),
            P->s_qual.data(), P->s_aux_off.data(), P->s_aux.data(), cnt,
            P->m_flat[0].data(), P->m_offs[0].data(), (int64_t)P->m_flat[0].size(),
            (int8_t*)P->m_flat[1].data(), P->m_offs[1].data(), (int64_t)P->m_flat[1].size(),
            P->m_flat[2].data(), P->m_offs[2].data(), (int64_t)P->m_flat[2].size(),
            P->m_flat[3].data(), P->m_offs[3].data(), (int64_t)P->m_flat[3].size(),
            P->m_flat[4].data(), P->m_offs[4].data(), (int64_t)P->m_flat[4].size(),
            P->m_flat[5].data(), P->m_offs[5].data(), (int64_t)P->m_flat[5].size(),
            P->m_flat[6].data(), P->m_offs[6].data(), (int64_t)P->m_flat[6].size(),
            P->m_flat[7].data(), P->m_offs[7].data(), (int64_t)P->m_flat[7].size(),
            P->m_flat[8].data(), P->m_offs[8].data(), (int64_t)P->m_flat[8].size(),
            P->s_oflags.data());
        if (rc == 0) break;
        for (int j = 0; j < 9; ++j) P->m_flat[j].resize(P->m_flat[j].size() * 2);
    }
    P->t_meta += now_s() - tm;

    // skip rules, reference order (`sorted_bam_reader.rs:45-68`)
    P->s_keep.assign((size_t)cnt, 1);
    for (int64_t i = 0; i < cnt; ++i) {
        uint8_t fl = P->s_oflags[i];
        if (P->force_paired && !(fl & 1)) P->s_keep[i] = 0;
        if (!(fl & 4)) P->s_keep[i] = 0;  // no CB tag
    }
    // missing UMI on a surviving record: fatal — keep only the prefix
    for (int64_t i = 0; i < cnt; ++i) {
        if (P->s_keep[i] && !(P->s_oflags[i] & 8)) {
            for (int64_t j = i; j < cnt; ++j) P->s_keep[j] = 0;
            P->missing_umi = true;
            break;
        }
    }
    // whitelisted-UMI filter: drop UMI == "AAAAAAAAAA"
    const int64_t* uoff = P->m_offs[7].data();
    const uint8_t* uflat = P->m_flat[7].data();
    for (int64_t i = 0; i < cnt; ++i) {
        if (!P->s_keep[i]) continue;
        int64_t ul = uoff[i + 1] - uoff[i];
        if (ul == 10) {
            bool all_a = true;
            for (int64_t j = 0; j < 10 && all_a; ++j)
                all_a = uflat[uoff[i] + j] == 'A';
            if (all_a) P->s_keep[i] = 0;
        }
    }

    int64_t appended = 0;
    for (int64_t i = 0; i < cnt; ++i) appended += P->s_keep[i];
    if (appended == 0) return 0;
    double ta = now_s();
    const uint8_t* keep = P->s_keep.data();
    ColumnSet& c = P->carry;
    c.meta.append_filtered(P->m_offs[0].data(), P->m_flat[0].data(), keep, cnt);
    c.seq.append_filtered(P->m_offs[1].data(), P->m_flat[1].data(), keep, cnt);
    c.meta1.append_filtered(P->m_offs[2].data(), P->m_flat[2].data(), keep, cnt);
    c.meta15.append_filtered(P->m_offs[3].data(), P->m_flat[3].data(), keep, cnt);
    c.rev2.append_filtered(P->m_offs[4].data(), P->m_flat[4].data(), keep, cnt);
    c.qn.append_filtered(P->m_offs[5].data(), P->m_flat[5].data(), keep, cnt);
    c.cb.append_filtered(P->m_offs[6].data(), P->m_flat[6].data(), keep, cnt);
    c.umi.append_filtered(P->m_offs[7].data(), P->m_flat[7].data(), keep, cnt);
    c.sk.append_filtered(P->m_offs[8].data(), P->m_flat[8].data(), keep, cnt);
    c.qname_raw.append_filtered(P->s_qn_off.data(), P->s_qn.data(), keep, cnt);
    for (int64_t i = 0; i < cnt; ++i)
        if (keep[i]) c.oflags.push_back(P->s_oflags[i]);
    P->t_append += now_s() - ta;
    return appended;
}

// run emission over the carry; fills the slot as an EMIT.  Returns the
// nimble_bam_runs rc (0 ok, 1 truncated, -1 irregular -> caller hands over).
int run_emit(Pipe* P, bool at_eof, Slot* slot) {
    slot->kind = 0;
    slot->clear_emit();
    ColumnSet& c = P->carry;
    int64_t n = c.n();
    if (n == 0) {
        slot->free_pass_used = P->free_pass_used;
        slot->groups_started_total = P->groups_started_total;
        slot->entries_since_pass = P->entries_since_pass;
        return 0;
    }
    P->r_emit_idx.resize((size_t)(2 * n));
    P->r_emit_skip.resize((size_t)(2 * n));
    P->r_group_off.resize((size_t)(2 * n + 2));
    int64_t ec = 0, ng = 0, consumed = 0, ec_at_pass = 0;
    int32_t free_out = 0;
    int32_t is_final = (at_eof && !P->missing_umi) ? 1 : 0;
    int32_t rc = nimble_bam_runs(
        c.umi.offs.data(), c.umi.flat.data(), c.cb.offs.data(),
        c.cb.flat.data(), c.qname_raw.offs.data(), c.qname_raw.flat.data(),
        c.oflags.data(), n, P->force_paired, is_final, P->free_pass_used,
        P->groups_started_total, P->r_emit_idx.data(), P->r_emit_skip.data(),
        &ec, P->r_group_off.data(), &ng, &consumed, &free_out, &ec_at_pass);
    if (rc == -1) return -1;
    // state updates mirror ColumnarGroupStream.batches (bam_columnar.py)
    if (free_out) {
        P->free_pass_used = 1;
        P->entries_since_pass = ec - ec_at_pass;
    } else {
        P->entries_since_pass += ec;
    }
    P->groups_started_total += ng;

    for (int64_t j = 0; j < ec; ++j) {
        int64_t i = P->r_emit_idx[j];
        int8_t code = P->r_emit_skip[j];
        slot->e_meta.append_row(c.meta, i);
        slot->e_qual.append_row(c.meta1, i);
        slot->e_rev2.append_row(c.rev2, i);
        slot->e_seq15.append_row(c.meta15, i);
        slot->e_qn.append_row(c.qn, i);
        slot->e_seq.append_row(c.seq, i);
        if (code == 2) {
            // force_bam_paired: skip column = the BAM's own SK:Z: value
            // verbatim; skip test = exact equality with "TRUE"
            slot->e_skipb.append_row(c.sk, i);
            slot->skip_true.push_back(
                c.sk.row_len(i) == 4 &&
                std::memcmp(c.sk.row(i), "TRUE", 4) == 0);
        } else if (code == 1) {
            slot->e_skipb.push_cstr("TRUE");
            slot->skip_true.push_back(1);
        } else {
            slot->e_skipb.push_cstr("FALSE");
            slot->skip_true.push_back(0);
        }
    }
    slot->group_starts.assign(P->r_group_off.data(),
                              P->r_group_off.data() + ng);
    c.drop_front(consumed);
    slot->truncated = (rc == 1);
    slot->free_pass_used = P->free_pass_used;
    slot->groups_started_total = P->groups_started_total;
    slot->entries_since_pass = P->entries_since_pass;
    return rc;
}

Slot* acquire_slot(Pipe* P) {
    std::unique_lock<std::mutex> lk(P->mu);
    P->cv.wait(lk, [&] { return P->closed || !P->freelist.empty(); });
    if (P->closed) return nullptr;
    Slot* s = P->freelist.back();
    P->freelist.pop_back();
    return s;
}

void push_ready(Pipe* P, Slot* s) {
    std::unique_lock<std::mutex> lk(P->mu);
    P->ready.push_back(s);
    P->cv.notify_all();
}

void push_terminal(Pipe* P, int32_t error_kind, int32_t gz_status) {
    Slot* s = acquire_slot(P);
    if (!s) return;
    s->clear_emit();
    s->kind = 2;
    s->error_kind = error_kind;
    s->gz_status = gz_status;
    s->free_pass_used = P->free_pass_used;
    s->groups_started_total = P->groups_started_total;
    s->entries_since_pass = P->entries_since_pass;
    push_ready(P, s);
}

void worker_main_inner(Pipe* P);

void worker_main(Pipe* P) {
    worker_main_inner(P);
    if (std::getenv("NIMBLE_PIPE_PROF"))
        std::fprintf(stderr,
            "[pipe prof] read %.3f inflate %.3f scan %.3f (bscan %.3f "
            "meta %.3f x%d append %.3f) emit %.3f slot_wait %.3f\n",
            P->t_read, P->t_inflate, P->t_scan, P->t_bscan, P->t_meta,
            P->n_meta, P->t_append, P->t_emit, P->t_slot);
}

void worker_main_inner(Pipe* P) {
    while (true) {
        {
            std::unique_lock<std::mutex> lk(P->mu);
            if (P->closed) return;
        }
        // ---- acquire more records (the Python _scan_chunk loop) ----
        bool at_eof = false;
        while (true) {
            if (P->missing_umi) { at_eof = true; break; }
            int64_t scanned = 0;
            double ts = now_s();
            int64_t appended = scan_once(P, &scanned);
            P->t_scan += now_s() - ts;
            if (appended > 0) break;
            if (scanned > 0) continue;  // all records filtered: scan more
            if (P->raw_eof && P->raw.empty()) {
                if (!P->bam.empty()) {
                    // inflated bytes that do not form a record: the stream
                    // ended mid-record (EOFError("truncated BAM stream"))
                    push_terminal(P, 1, 0);
                    return;
                }
                at_eof = true;
                break;
            }
            if (!ingest(P)) {
                push_terminal(P, P->gz_eof_mid ? 4 : 3, P->gz_err);
                return;
            }
        }

        int64_t n = P->carry.n();
        if (n == 0 && at_eof) {
            push_terminal(P, P->missing_umi ? 2 : 0, 0);
            return;
        }

        double tw = now_s();
        Slot* slot = acquire_slot(P);
        P->t_slot += now_s() - tw;
        if (!slot) return;
        double te = now_s();
        int rc = run_emit(P, at_eof, slot);
        P->t_emit += now_s() - te;
        if (rc == -1) {
            // irregular run: hand the raw carry to the Python fallback and
            // resume from its ack (consumed prefix + updated state)
            slot->kind = 1;
            slot->carry = P->carry;
            slot->at_eof = at_eof ? 1 : 0;
            slot->missing_umi = P->missing_umi ? 1 : 0;
            slot->free_pass_used = P->free_pass_used;
            slot->groups_started_total = P->groups_started_total;
            slot->entries_since_pass = P->entries_since_pass;
            {
                std::unique_lock<std::mutex> lk(P->mu);
                P->awaiting_ack = true;
                P->got_ack = false;
            }
            push_ready(P, slot);
            {
                std::unique_lock<std::mutex> lk(P->mu);
                P->cv.wait(lk, [&] { return P->closed || P->got_ack; });
                if (P->closed) return;
                P->awaiting_ack = false;
            }
            if (P->ack_stop) return;  // fallback ended the stream itself
            P->carry.drop_front(P->ack_consumed);
            P->free_pass_used = P->ack_free_pass;
            P->groups_started_total = P->ack_groups;
            P->entries_since_pass = P->ack_entries;
            if (at_eof) {
                push_terminal(P, P->missing_umi ? 2 : 0, 0);
                return;
            }
            continue;
        }
        bool truncated = slot->truncated != 0;
        slot->at_eof = at_eof ? 1 : 0;
        push_ready(P, slot);
        if (truncated) {
            push_terminal(P, 0, 0);
            return;
        }
        if (at_eof) {
            push_terminal(P, P->missing_umi ? 2 : 0, 0);
            return;
        }
    }
}

// Parse-and-skip the BAM header from the pipe's inflated buffer, ingesting
// more data as needed.  Returns 0 ok, 2 not-BGZF/gzip error, 3 bad header.
int skip_header(Pipe* P) {
    auto need = [&](size_t want) -> bool {
        while (P->bam.size() < want) {
            if (!ingest(P)) return false;
            if (P->raw_eof && P->raw.empty() && P->bam.size() < want)
                return false;
        }
        return true;
    };
    if (!need(12)) return P->gz_err == 1 ? 2 : 3;
    if (std::memcmp(P->bam.data(), "BAM\x01", 4) != 0) return 3;
    int32_t l_text;
    std::memcpy(&l_text, P->bam.data() + 4, 4);
    if (l_text < 0) return 3;
    size_t pos = 8 + (size_t)l_text;
    if (!need(pos + 4)) return 3;
    int32_t n_ref;
    std::memcpy(&n_ref, P->bam.data() + pos, 4);
    if (n_ref < 0) return 3;
    pos += 4;
    for (int32_t r = 0; r < n_ref; ++r) {
        if (!need(pos + 4)) return 3;
        int32_t l_name;
        std::memcpy(&l_name, P->bam.data() + pos, 4);
        if (l_name < 0) return 3;
        pos += 4 + (size_t)l_name;
        if (!need(pos + 4)) return 3;
        pos += 4;  // l_ref
    }
    if (!need(pos)) return 3;
    P->bam.erase(P->bam.begin(), P->bam.begin() + pos);
    return 0;
}

}  // namespace bampipe

extern "C" {

void* nimble_bam_pipe_new(const char* path, int32_t force_paired,
                          int32_t* status) {
    using namespace bampipe;
    Pipe* P = new Pipe();
    P->force_paired = force_paired;
    P->f = std::fopen(path, "rb");
    if (!P->f) { *status = 1; delete P; return nullptr; }
    int rc = skip_header(P);
    if (rc) { *status = rc; delete P; return nullptr; }
    for (int i = 0; i < Pipe::kSlots; ++i) P->freelist.push_back(new Slot());
    P->worker = std::thread(worker_main, P);
    *status = 0;
    return P;
}

// Blocks until the next slot is ready; fills dims[24] and returns the kind
// (0 emit, 1 irregular carry, 2 terminal) or -9 after close.  The previous
// slot (if any) is recycled — Python must fetch before calling next again.
int32_t nimble_bam_pipe_next(void* h, int64_t* dims) {
    using namespace bampipe;
    Pipe* P = (Pipe*)h;
    std::unique_lock<std::mutex> lk(P->mu);
    if (P->handed) {
        P->freelist.push_back(P->handed);
        P->handed = nullptr;
        P->cv.notify_all();
    }
    P->cv.wait(lk, [&] { return P->closed || !P->ready.empty(); });
    if (P->closed && P->ready.empty()) return -9;
    Slot* s = P->ready.front();
    P->ready.pop_front();
    P->handed = s;
    std::memset(dims, 0, 24 * sizeof(int64_t));
    if (s->kind == 0) {
        dims[0] = s->e_meta.n();
        dims[1] = (int64_t)s->group_starts.size();
        dims[2] = (int64_t)s->e_meta.flat.size();
        dims[3] = (int64_t)s->e_skipb.flat.size();
        dims[4] = (int64_t)s->e_qual.flat.size();
        dims[5] = (int64_t)s->e_rev2.flat.size();
        dims[6] = (int64_t)s->e_seq15.flat.size();
        dims[7] = (int64_t)s->e_qn.flat.size();
        dims[8] = (int64_t)s->e_seq.flat.size();
        dims[9] = s->truncated;
        dims[10] = s->free_pass_used;
        dims[11] = s->groups_started_total;
        dims[12] = s->entries_since_pass;
        dims[13] = s->at_eof;
    } else if (s->kind == 1) {
        const ColumnSet& c = s->carry;
        dims[0] = c.n();
        dims[1] = (int64_t)c.meta.flat.size();
        dims[2] = (int64_t)c.meta1.flat.size();
        dims[3] = (int64_t)c.meta15.flat.size();
        dims[4] = (int64_t)c.rev2.flat.size();
        dims[5] = (int64_t)c.qn.flat.size();
        dims[6] = (int64_t)c.sk.flat.size();
        dims[7] = (int64_t)c.cb.flat.size();
        dims[8] = (int64_t)c.umi.flat.size();
        dims[9] = (int64_t)c.qname_raw.flat.size();
        dims[10] = (int64_t)c.seq.flat.size();
        dims[11] = s->at_eof;
        dims[12] = s->missing_umi;
        dims[13] = s->free_pass_used;
        dims[14] = s->groups_started_total;
        dims[15] = s->entries_since_pass;
    } else {
        dims[0] = s->error_kind;
        dims[1] = s->gz_status;
        dims[2] = s->free_pass_used;
        dims[3] = s->groups_started_total;
        dims[4] = s->entries_since_pass;
    }
    return s->kind;
}

static void copy_ragged(const bampipe::Ragged& r, int64_t* offs,
                        uint8_t* flat) {
    std::memcpy(offs, r.offs.data(), r.offs.size() * sizeof(int64_t));
    if (!r.flat.empty()) std::memcpy(flat, r.flat.data(), r.flat.size());
}

int32_t nimble_bam_pipe_fetch_emit(
    void* h,
    int64_t* meta_off, uint8_t* meta_flat,
    int64_t* skipb_off, uint8_t* skipb_flat,
    int64_t* qual_off, uint8_t* qual_flat,
    int64_t* rev2_off, uint8_t* rev2_flat,
    int64_t* seq15_off, uint8_t* seq15_flat,
    int64_t* qn_off, uint8_t* qn_flat,
    int64_t* seq_off, uint8_t* seq_flat,
    uint8_t* skip_true, int64_t* group_starts) {
    using namespace bampipe;
    Pipe* P = (Pipe*)h;
    std::unique_lock<std::mutex> lk(P->mu);
    Slot* s = P->handed;
    if (!s || s->kind != 0) return -1;
    copy_ragged(s->e_meta, meta_off, meta_flat);
    copy_ragged(s->e_skipb, skipb_off, skipb_flat);
    copy_ragged(s->e_qual, qual_off, qual_flat);
    copy_ragged(s->e_rev2, rev2_off, rev2_flat);
    copy_ragged(s->e_seq15, seq15_off, seq15_flat);
    copy_ragged(s->e_qn, qn_off, qn_flat);
    copy_ragged(s->e_seq, seq_off, seq_flat);
    if (!s->skip_true.empty())
        std::memcpy(skip_true, s->skip_true.data(), s->skip_true.size());
    if (!s->group_starts.empty())
        std::memcpy(group_starts, s->group_starts.data(),
                    s->group_starts.size() * sizeof(int64_t));
    return 0;
}

int32_t nimble_bam_pipe_fetch_carry(
    void* h,
    int64_t* meta_off, uint8_t* meta_flat,
    int64_t* meta1_off, uint8_t* meta1_flat,
    int64_t* meta15_off, uint8_t* meta15_flat,
    int64_t* rev2_off, uint8_t* rev2_flat,
    int64_t* qn_off, uint8_t* qn_flat,
    int64_t* sk_off, uint8_t* sk_flat,
    int64_t* cb_off, uint8_t* cb_flat,
    int64_t* umi_off, uint8_t* umi_flat,
    int64_t* qname_off, uint8_t* qname_flat,
    int64_t* seq_off, uint8_t* seq_flat,
    uint8_t* oflags) {
    using namespace bampipe;
    Pipe* P = (Pipe*)h;
    std::unique_lock<std::mutex> lk(P->mu);
    Slot* s = P->handed;
    if (!s || s->kind != 1) return -1;
    const ColumnSet& c = s->carry;
    copy_ragged(c.meta, meta_off, meta_flat);
    copy_ragged(c.meta1, meta1_off, meta1_flat);
    copy_ragged(c.meta15, meta15_off, meta15_flat);
    copy_ragged(c.rev2, rev2_off, rev2_flat);
    copy_ragged(c.qn, qn_off, qn_flat);
    copy_ragged(c.sk, sk_off, sk_flat);
    copy_ragged(c.cb, cb_off, cb_flat);
    copy_ragged(c.umi, umi_off, umi_flat);
    copy_ragged(c.qname_raw, qname_off, qname_flat);
    copy_ragged(c.seq, seq_off, seq_flat);
    if (!c.oflags.empty())
        std::memcpy(oflags, c.oflags.data(), c.oflags.size());
    return 0;
}

void nimble_bam_pipe_ack(void* h, int64_t consumed, int32_t stop,
                         int32_t free_pass_used, int64_t groups_started_total,
                         int64_t entries_since_pass) {
    using namespace bampipe;
    Pipe* P = (Pipe*)h;
    std::unique_lock<std::mutex> lk(P->mu);
    P->ack_consumed = consumed;
    P->ack_stop = stop != 0;
    P->ack_free_pass = free_pass_used;
    P->ack_groups = groups_started_total;
    P->ack_entries = entries_since_pass;
    P->got_ack = true;
    P->cv.notify_all();
}

void nimble_bam_pipe_close(void* h) {
    using namespace bampipe;
    Pipe* P = (Pipe*)h;
    {
        std::unique_lock<std::mutex> lk(P->mu);
        P->closed = true;
        P->cv.notify_all();
    }
    if (P->worker.joinable()) P->worker.join();
    delete P;
}

}  // extern "C"
