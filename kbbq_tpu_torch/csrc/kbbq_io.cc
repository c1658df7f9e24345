// Host IO codec of kbbq_tpu_torch: multithreaded BGZF, the FASTQ record
// walk, padded-array decode and quality write-back, and the BAM record
// index, fixed fields, aux walk, machine-order decode, QUAL write-back and
// OQ append.  A C ABI loaded with ctypes (kbbq_tpu_torch/io/native_lib.py
// builds it with g++ at first use).
//
// Counterpart of these functions of kbbq_tpu/io/native/kbbq_io.cc, with the
// same arithmetic (so the same bytes): kbbq_bgzf_size, kbbq_bgzf_decompress,
// kbbq_bgzf_compress, kbbq_fastq_index, kbbq_fastq_extract,
// kbbq_fastq_write_quals, kbbq_bam_offsets, kbbq_bam_decode,
// kbbq_rans_uncompress and kbbq_rans_compress.  Three
// differences: kbbq_fastq_index and kbbq_bam_offsets return -1 - (byte offset
// of the record that failed) on malformed input instead of a bare -1, and
// kbbq_rans_uncompress refuses a frequency table that sums past 4096.
// kbbq_bam_write_quals and kbbq_bam_append_oq are the port's own: they do
// what loops of kbbq_tpu/io/bam_vec.py::rewrite_quals_chunk do in NumPy.
// kbbq_bam_fields and kbbq_bam_aux_scan are the port's own too: the walk over
// each record's fixed fields and aux chain that io/bam_vec.py's
// bam_fields_plain and aux_scan_plain do in NumPy, and the read-group values
// that rg_ids_plain finds by gathering and comparing rows.
// kbbq_fastq_lines and kbbq_fastq_walk are the port's own: kbbq_fastq_index's
// records and checks on several threads, with each record's second-in-pair
// flag (io/fastq.py's seconds_mask_plain); kbbq_fastq_index stays the serial
// scanner that the tests hold the walk against.  The
// reference's host pass 4, host histogram and tunnel packing functions are
// not part of the port.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

struct BgzfBlock {
  size_t in_off;   // offset of the compressed payload
  size_t in_len;   // compressed payload length
  size_t out_off;  // offset in the decompressed stream
  uint32_t isize;  // uncompressed size
  uint32_t crc;
};

const uint8_t kBgzfEof[28] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                              0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00,
                              0x03, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// The blocks of a BGZF stream (EOF markers skipped); false on a parse error.
bool scan_blocks(const uint8_t* in, size_t n, std::vector<BgzfBlock>& blocks,
                 size_t* total_out) {
  size_t off = 0, out = 0;
  while (off < n) {
    if (n - off >= 28 && memcmp(in + off, kBgzfEof, 28) == 0) {
      off += 28;
      continue;
    }
    if (n - off < 18) return false;
    if (in[off] != 31 || in[off + 1] != 139 || in[off + 2] != 8 ||
        !(in[off + 3] & 4))
      return false;
    uint16_t xlen;
    memcpy(&xlen, in + off + 10, 2);
    size_t xoff = off + 12, xend = xoff + xlen;
    int64_t bsize = -1;
    while (xoff + 4 <= xend) {
      uint16_t slen;
      memcpy(&slen, in + xoff + 2, 2);
      if (in[xoff] == 66 && in[xoff + 1] == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, in + xoff + 4, 2);
        bsize = (int64_t)bs + 1;
      }
      xoff += 4 + slen;
    }
    if (bsize < 0 || off + (size_t)bsize > n ||
        (size_t)bsize < 12u + xlen + 8u)
      return false;
    BgzfBlock b;
    b.in_off = off + 12 + xlen;
    b.in_len = (size_t)bsize - 12 - xlen - 8;
    memcpy(&b.crc, in + off + bsize - 8, 4);
    memcpy(&b.isize, in + off + bsize - 4, 4);
    b.out_off = out;
    out += b.isize;
    blocks.push_back(b);
    off += bsize;
  }
  *total_out = out;
  return true;
}

// Runs work(t) for t in [0, threads) on that many threads (inline for one).
template <class F>
void run_threads(int threads, F work) {
  if (threads <= 1) {
    work(0);
    return;
  }
  std::vector<std::thread> ths;
  for (int t = 0; t < threads; t++) ths.emplace_back(work, t);
  for (auto& th : ths) th.join();
}

// Threads of a walk over n BAM records in contiguous ranges: one for a
// small chunk, where starting threads would cost more than the walk.
int bam_threads(int64_t n, int32_t nthreads) {
  if (nthreads < 1 || n < 4096) return 1;
  return (int)std::min<int64_t>(nthreads, n / 1024);
}

// Value size of a fixed-width aux type (SAM spec 4.2.4), 0 for any other.
int aux_fixed(uint8_t type) {
  switch (type) {
    case 'A': case 'c': case 'C': return 1;
    case 's': case 'S': return 2;
    case 'i': case 'I': case 'f': return 4;
    default: return 0;
  }
}

// Byte range t of T over n bytes (the threaded FASTQ walk's).
void byte_range(size_t n, int32_t T, int32_t t, size_t* a, size_t* b) {
  *a = (size_t)((uint64_t)n * (uint64_t)t / (uint64_t)T);
  *b = (size_t)((uint64_t)n * (uint64_t)(t + 1) / (uint64_t)T);
}

// ASCII whitespace as bytes.split takes it: space and 9-13.
inline bool ascii_ws(uint8_t c) { return c == ' ' || (c >= 9 && c <= 13); }

// Second-in-pair by DECISIONS.md D11 for the name line [s, e): its first
// token (leading whitespace skipped) ends in "/2".
uint8_t second_in_pair(const uint8_t* s, const uint8_t* e) {
  while (s < e && ascii_ws(*s)) s++;
  const uint8_t* t = s;
  while (t < e && !ascii_ws(*t)) t++;
  return t - s >= 2 && t[-2] == '/' && t[-1] == '2';
}

// The line ends (newlines, or n for a last line without one) of the FASTQ
// record at off, by kbbq_fastq_index's checks: false where it is malformed.
bool fastq_record(const uint8_t* buf, size_t n, size_t off, size_t e[4]) {
  if (buf[off] != '@') return false;
  size_t s = off;
  for (int j = 0; j < 4; j++) {
    if (j && s >= n) return false;
    if (j == 2 && buf[s] != '+') return false;
    const uint8_t* q = (const uint8_t*)memchr(buf + s, '\n', n - s);
    if (!q && j < 3) return false;
    e[j] = q ? (size_t)(q - buf) : n;
    s = e[j] + 1;
  }
  return e[3] - (e[2] + 1) == e[1] - (e[0] + 1);
}

}  // namespace

extern "C" {

// Decompressed size of a BGZF stream, -1 on a parse error.
int64_t kbbq_bgzf_size(const uint8_t* in, size_t n) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (!scan_blocks(in, n, blocks, &total)) return -1;
  return (int64_t)total;
}

// Decompress every block into out (kbbq_bgzf_size bytes).  0 on success;
// -1 parse error, 1 inflate init, 2 inflate, 3 CRC mismatch.
int32_t kbbq_bgzf_decompress(const uint8_t* in, size_t n, uint8_t* out,
                             size_t out_len, int32_t nthreads) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (!scan_blocks(in, n, blocks, &total) || total != out_len) return -1;
  if (nthreads < 1) nthreads = 1;
  std::vector<int32_t> errs(nthreads, 0);
  run_threads(nthreads, [&](int t) {
    for (size_t i = t; i < blocks.size(); i += nthreads) {
      const BgzfBlock& b = blocks[i];
      z_stream zs;
      memset(&zs, 0, sizeof zs);
      if (inflateInit2(&zs, -15) != Z_OK) { errs[t] = 1; return; }
      zs.next_in = const_cast<Bytef*>(in + b.in_off);
      zs.avail_in = (uInt)b.in_len;
      zs.next_out = out + b.out_off;
      zs.avail_out = b.isize;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END && !(r == Z_OK && b.isize == 0) &&
          !(r == Z_BUF_ERROR && b.isize == 0)) { errs[t] = 2; return; }
      if (crc32(0, out + b.out_off, b.isize) != b.crc) { errs[t] = 3; return; }
    }
  });
  for (int e : errs)
    if (e) return e;
  return 0;
}

// Compress into BGZF blocks of 0xff00 input bytes each, then the EOF marker.
// Returns the bytes written, -1 if out_cap is too small, -2 on a deflate
// error.
int64_t kbbq_bgzf_compress(const uint8_t* in, size_t n, uint8_t* out,
                           size_t out_cap, int32_t level, int32_t nthreads) {
  const size_t kChunk = 0xff00;
  const size_t nblocks = (n + kChunk - 1) / kChunk;
  if (nthreads < 1) nthreads = 1;
  std::vector<std::vector<uint8_t>> outs(nblocks);
  std::vector<int32_t> errs(nthreads, 0);
  run_threads(nthreads, [&](int t) {
    std::vector<uint8_t> cbuf(0x11000);
    for (size_t i = t; i < nblocks; i += nthreads) {
      const size_t s = i * kChunk;
      const size_t len = s + kChunk <= n ? kChunk : n - s;
      z_stream zs;
      memset(&zs, 0, sizeof zs);
      if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
          Z_OK) { errs[t] = 1; return; }
      zs.next_in = const_cast<Bytef*>(in + s);
      zs.avail_in = (uInt)len;
      zs.next_out = cbuf.data();
      zs.avail_out = (uInt)cbuf.size();
      const int r = deflate(&zs, Z_FINISH);
      const size_t clen = cbuf.size() - zs.avail_out;
      deflateEnd(&zs);
      if (r != Z_STREAM_END) { errs[t] = 2; return; }
      const size_t bsize = clen + 12 + 6 + 8;
      std::vector<uint8_t>& o = outs[i];
      o.resize(bsize);
      uint8_t hdr[18] = {31, 139, 8, 4, 0, 0, 0, 0, 0, 255, 6, 0,
                         66, 67, 2, 0, 0, 0};
      const uint16_t bs16 = (uint16_t)(bsize - 1);
      memcpy(hdr + 16, &bs16, 2);
      memcpy(o.data(), hdr, 18);
      memcpy(o.data() + 18, cbuf.data(), clen);
      const uint32_t crc = crc32(0, in + s, (uInt)len);
      const uint32_t il = (uint32_t)len;
      memcpy(o.data() + 18 + clen, &crc, 4);
      memcpy(o.data() + 18 + clen + 4, &il, 4);
    }
  });
  for (int e : errs)
    if (e) return -2;
  size_t pos = 0;
  for (auto& o : outs) {
    if (pos + o.size() > out_cap) return -1;
    memcpy(out + pos, o.data(), o.size());
    pos += o.size();
  }
  if (pos + 28 > out_cap) return -1;
  memcpy(out + pos, kBgzfEof, 28);
  return (int64_t)(pos + 28);
}

// Record offsets of a FASTQ buffer, 8 int64 per record: name_start, name_end,
// seq_start, seq_end, 0, 0, qual_start, qual_end (ends exclusive, names
// without the '@').  Writes at most cap_records records; returns the record
// count, or -1 - (offset of the first record that is malformed: no '@', a
// line missing, no '+' line, sequence and quality of different lengths).
int64_t kbbq_fastq_index(const uint8_t* buf, size_t n, int64_t* out,
                         size_t cap_records) {
  size_t off = 0;
  int64_t nrec = 0;
  while (off < n) {
    const int64_t bad = -1 - (int64_t)off;
    if (buf[off] != '@') return bad;
    const uint8_t* p1 = (const uint8_t*)memchr(buf + off, '\n', n - off);
    if (!p1) return bad;
    const size_t name_s = off + 1, name_e = p1 - buf;
    const size_t seq_s = name_e + 1;
    if (seq_s >= n) return bad;
    const uint8_t* p2 = (const uint8_t*)memchr(buf + seq_s, '\n', n - seq_s);
    if (!p2) return bad;
    const size_t seq_e = p2 - buf;
    const size_t plus_s = seq_e + 1;
    if (plus_s >= n || buf[plus_s] != '+') return bad;
    const uint8_t* p3 =
        (const uint8_t*)memchr(buf + plus_s, '\n', n - plus_s);
    if (!p3) return bad;
    const size_t qual_s = (p3 - buf) + 1;
    if (qual_s >= n) return bad;
    const uint8_t* p4 = (const uint8_t*)memchr(buf + qual_s, '\n', n - qual_s);
    const size_t qual_e = p4 ? (size_t)(p4 - buf) : n;
    if (qual_e - qual_s != seq_e - seq_s) return bad;
    if ((size_t)nrec < cap_records) {
      int64_t* r = out + nrec * 8;
      r[0] = (int64_t)name_s; r[1] = (int64_t)name_e;
      r[2] = (int64_t)seq_s;  r[3] = (int64_t)seq_e;
      r[4] = 0;               r[5] = 0;
      r[6] = (int64_t)qual_s; r[7] = (int64_t)qual_e;
    }
    nrec++;
    off = qual_e + 1;
  }
  return nrec;
}

// First call of the threaded FASTQ walk: the newlines of each of the T byte
// ranges of buf into counts[T].  Returns the number of lines (a last line
// without its newline counts).
int64_t kbbq_fastq_lines(const uint8_t* buf, size_t n, int64_t* counts,
                         int32_t T) {
  run_threads(T, [&](int t) {
    size_t a, b;
    byte_range(n, T, t, &a, &b);
    int64_t c = 0;
    for (size_t i = a; i < b; i++) c += buf[i] == '\n';
    counts[t] = c;
  });
  int64_t lines = 0;
  for (int32_t t = 0; t < T; t++) lines += counts[t];
  return lines + (n && buf[n - 1] != '\n');
}

// Second call: kbbq_fastq_index's records and checks, on the T threads of
// kbbq_fastq_lines's ranges (counts from it).  Record r is lines 4r..4r+3;
// a thread walks the records whose name line follows a newline in its range
// (record 0 on thread 0), so it learns each one's ordinal from the counts.
// Writes the 8 offsets of each record into out[nrec][8] and its
// second-in-pair flag into seconds[nrec] (nrec = ceil(lines / 4)).  Returns
// nrec, or -1 - (offset of the first malformed record in file order), the
// serial scanner's answer.
int64_t kbbq_fastq_walk(const uint8_t* buf, size_t n, const int64_t* counts,
                        int32_t T, int64_t* out, uint8_t* seconds,
                        int64_t nrec) {
  std::vector<int64_t> bad_rec(T, INT64_MAX), bad_off(T, 0);
  run_threads(T, [&](int t) {
    size_t a, b;
    byte_range(n, T, t, &a, &b);
    int64_t line = 0;          // newlines before a
    for (int32_t u = 0; u < t; u++) line += counts[u];
    // the first record start in the range: a line 4r after a newline here
    size_t off = n;
    if (t == 0 && n) {
      off = 0;
    } else {
      for (size_t p = a; p < b;) {
        const uint8_t* q = (const uint8_t*)memchr(buf + p, '\n', b - p);
        if (!q) break;
        line++;                 // q ends line `line - 1`, line `line` follows
        p = q - buf + 1;
        if (line % 4 == 0) { off = p; break; }
      }
    }
    int64_t r = line / 4;
    while (off < n && r < nrec) {
      size_t e[4];
      if (!fastq_record(buf, n, off, e)) {
        bad_rec[t] = r;
        bad_off[t] = -1 - (int64_t)off;
        return;
      }
      int64_t* o = out + r * 8;
      o[0] = (int64_t)off + 1; o[1] = (int64_t)e[0];
      o[2] = (int64_t)e[0] + 1; o[3] = (int64_t)e[1];
      o[4] = 0; o[5] = 0;
      o[6] = (int64_t)e[2] + 1; o[7] = (int64_t)e[3];
      seconds[r] = second_in_pair(buf + off + 1, buf + e[0]);
      if (e[3] >= b) return;   // the next record follows another range
      off = e[3] + 1;
      r++;
    }
  });
  int32_t first = 0;
  for (int32_t t = 1; t < T; t++)
    if (bad_rec[t] < bad_rec[first]) first = t;
  return bad_rec[first] == INT64_MAX ? nrec : bad_off[first];
}

// Decode records into padded [n, stride] arrays in one pass: codes through
// the caller's 256-entry encode table, quals = byte - 33 clipped to [0, 93],
// mask = j < len; padding is code 4, qual 0, mask 0.
void kbbq_fastq_extract(const uint8_t* buf, const int64_t* seq_starts,
                        const int64_t* qual_starts, const int64_t* lens,
                        int64_t n, int32_t stride, const int8_t* enc_lut,
                        int8_t* codes, int8_t* quals, uint8_t* mask,
                        int32_t nthreads) {
  const int T = (nthreads < 1 || n < 256) ? 1 : nthreads;
  run_threads(T, [&](int t) {
    for (int64_t i = t; i < n; i += T) {
      const uint8_t* s = buf + seq_starts[i];
      const uint8_t* q = buf + qual_starts[i];
      int8_t* oc = codes + i * stride;
      int8_t* oq = quals + i * stride;
      uint8_t* om = mask + i * stride;
      const int32_t L = (int32_t)lens[i];
      for (int32_t j = 0; j < L; j++) {
        oc[j] = enc_lut[s[j]];
        const int v = (int)q[j] - 33;
        oq[j] = (int8_t)(v < 0 ? 0 : (v > 93 ? 93 : v));
        om[j] = 1;
      }
      for (int32_t j = L; j < stride; j++) {
        oc[j] = 4; oq[j] = 0; om[j] = 0;
      }
    }
  });
}

// Overwrite the quality bytes of a FASTQ buffer from padded [n, stride] int8
// phred values (the first lens[i] of row i): the write side of the
// only-qualities-change invariant.
void kbbq_fastq_write_quals(uint8_t* out, const int64_t* qual_starts,
                            const int64_t* lens, const int8_t* new_quals,
                            int64_t n, int32_t stride, int32_t nthreads) {
  const int T = (nthreads < 1 || n < 256) ? 1 : nthreads;
  run_threads(T, [&](int t) {
    for (int64_t i = t; i < n; i += T) {
      uint8_t* o = out + qual_starts[i];
      const int8_t* q = new_quals + i * stride;
      const int32_t L = (int32_t)lens[i];
      for (int32_t j = 0; j < L; j++) o[j] = (uint8_t)(q[j] + 33);
    }
  });
}

// ----------------------------------------------------------------- BAM

// Index complete BAM records in buf[start..n): out_offs[i] = body offset
// (past the 4-byte block_size), out_sizes[i] = body size.  Stops at cap
// records or at the first record that does not fit; *end_out is the offset
// just past the last record indexed.  Returns the count, or -1 - (offset of
// the block_size) when a block_size is not positive.
int64_t kbbq_bam_offsets(const uint8_t* buf, int64_t n, int64_t start,
                         int64_t* out_offs, int64_t* out_sizes, int64_t cap,
                         int64_t* end_out) {
  int64_t off = start, cnt = 0;
  while (off + 4 <= n && cnt < cap) {
    int32_t sz;
    memcpy(&sz, buf + off, 4);
    if (sz <= 0) return -1 - off;
    if (off + 4 + sz > n) break;
    out_offs[cnt] = off + 4;
    out_sizes[cnt] = sz;
    off += 4 + (int64_t)sz;
    cnt++;
  }
  *end_out = off;
  return cnt;
}

// Decode a group of records of one length L into machine order: codes from
// the 4-bit packed SEQ (A=1 C=2 G=4 T=8, anything else N = 4), qualities
// from QUAL clipped to 93 (so 0xff, "*", is 93), or with oq_mode from an OQ
// value (phred + 33) clipped to [0, 93]; reverse-strand records (rev[i])
// reverse-complemented with their qualities reversed.  Rows of out_codes and
// out_quals are out_stride apart; the first L bytes of each are written.
void kbbq_bam_decode(const uint8_t* buf, const int64_t* seq_off,
                     const int64_t* qual_off, const uint8_t* rev,
                     int64_t nrec, int32_t L, int32_t oq_mode,
                     int8_t* out_codes, int8_t* out_quals,
                     int64_t out_stride, int32_t nthreads) {
  static const int8_t nib[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                 3, 4, 4, 4, 4, 4, 4, 4};
  const int T = (nthreads < 1 || nrec < 1024) ? 1 : nthreads;
  run_threads(T, [&](int t) {
    for (int64_t i = t; i < nrec; i += T) {
      const uint8_t* s = buf + seq_off[i];
      int8_t* oc = out_codes + i * out_stride;
      for (int32_t j = 0; j < L; j++) {
        const uint8_t b = s[j >> 1];
        oc[j] = nib[(j & 1) ? (b & 0xF) : (b >> 4)];
      }
      const uint8_t* q = buf + qual_off[i];
      int8_t* oq = out_quals + i * out_stride;
      if (oq_mode) {
        for (int32_t j = 0; j < L; j++) {
          const int v = (int)q[j] - 33;
          oq[j] = (int8_t)(v < 0 ? 0 : (v > 93 ? 93 : v));
        }
      } else {
        for (int32_t j = 0; j < L; j++)
          oq[j] = (int8_t)(q[j] > 93 ? 93 : q[j]);
      }
      if (rev[i]) {
        for (int32_t a = 0, b = L - 1; a < b; a++, b--) {
          int8_t c = oc[a]; oc[a] = oc[b]; oc[b] = c;
          c = oq[a]; oq[a] = oq[b]; oq[b] = c;
        }
        for (int32_t j = 0; j < L; j++)
          if (oc[j] < 4) oc[j] = (int8_t)(3 - oc[j]);
      }
    }
  });
}

// Write machine-order phred rows back into the QUAL fields of BAM records,
// in place: record i's lens[i] bytes from qual_off[i] become the first
// lens[i] bytes of row i of new_quals ([n, stride] int8), reversed where
// rev[i] (a reverse-strand record stores its qualities in alignment order).
void kbbq_bam_write_quals(uint8_t* out, const int64_t* qual_off,
                          const int64_t* lens, const uint8_t* rev,
                          const int8_t* new_quals, int64_t n, int32_t stride,
                          int32_t nthreads) {
  const int T = (nthreads < 1 || n < 1024) ? 1 : nthreads;
  run_threads(T, [&](int t) {
    for (int64_t i = t; i < n; i += T) {
      uint8_t* o = out + qual_off[i];
      const int8_t* q = new_quals + i * stride;
      const int64_t L = lens[i];
      if (rev[i]) {
        for (int64_t j = 0; j < L; j++) o[j] = (uint8_t)q[L - 1 - j];
      } else {
        for (int64_t j = 0; j < L; j++) o[j] = (uint8_t)q[j];
      }
    }
  });
}

// Assemble records that each gain an OQ:Z tag at the end of their aux data.
// Record i (block_size included) is copied from wbuf[offs[i] - 4 ..
// offs[i] + sizes[i]) to out[dst[i]..); where oq_len[i] >= 0 its block_size
// grows by oq_len[i] + 4 and "OQZ", the oq_len[i] bytes from
// orig[qual_off[i]..] plus 33 (wrapping, as uint8) and a NUL follow.  A
// record with oq_len[i] < 0 is copied as it is.
void kbbq_bam_append_oq(const uint8_t* wbuf, const uint8_t* orig,
                        const int64_t* offs, const int64_t* sizes,
                        const int64_t* qual_off, const int64_t* oq_len,
                        const int64_t* dst, uint8_t* out, int64_t n,
                        int32_t nthreads) {
  const int T = (nthreads < 1 || n < 1024) ? 1 : nthreads;
  run_threads(T, [&](int t) {
    for (int64_t i = t; i < n; i += T) {
      uint8_t* o = out + dst[i];
      const int64_t seg = sizes[i] + 4;
      memcpy(o, wbuf + offs[i] - 4, (size_t)seg);
      const int64_t L = oq_len[i];
      if (L < 0) continue;
      const int32_t grown = (int32_t)(sizes[i] + L + 4);
      memcpy(o, &grown, 4);
      uint8_t* tag = o + seg;
      tag[0] = 'O'; tag[1] = 'Q'; tag[2] = 'Z';
      const uint8_t* q = orig + qual_off[i];
      for (int64_t j = 0; j < L; j++) tag[3 + j] = (uint8_t)(q[j] + 33);
      tag[3 + L] = 0;
    }
  });
}

// Fixed fields of the record bodies at offs, as 9 rows of n int64 in out:
// refID, pos, l_read_name, n_cigar_op, flag, l_seq (the int32 fields
// sign-extended), then the offsets of SEQ, QUAL and the aux data
// (off + 32 + l_read_name + 4 * n_cigar_op, + floor((l_seq + 1) / 2),
// + l_seq).  Reads buf[offs[i] .. offs[i] + 20); one contiguous range of
// records per thread.
void kbbq_bam_fields(const uint8_t* buf, const int64_t* offs, int64_t n,
                     int64_t* out, int32_t nthreads) {
  const int T = bam_threads(n, nthreads);
  run_threads(T, [&](int t) {
    for (int64_t i = n * t / T, e = n * (t + 1) / T; i < e; i++) {
      const uint8_t* r = buf + offs[i];
      int32_t refid, pos, l_seq;
      uint16_t n_cig, flag;
      memcpy(&refid, r, 4);
      memcpy(&pos, r + 4, 4);
      memcpy(&n_cig, r + 12, 2);
      memcpy(&flag, r + 14, 2);
      memcpy(&l_seq, r + 16, 4);
      const int64_t seq = offs[i] + 32 + r[8] + 4 * (int64_t)n_cig;
      // >> 1 of a signed value floors (arithmetic shift): a negative l_seq
      // gives NumPy's (l_seq + 1) // 2
      const int64_t qual = seq + (((int64_t)l_seq + 1) >> 1);
      const int64_t row[9] = {refid, pos, r[8], n_cig, flag, l_seq,
                              seq, qual, qual + l_seq};
      for (int f = 0; f < 9; f++) out[f * n + i] = row[f];
    }
  });
}

// Walk the aux chain of each record, aux_off[i] .. rec_end[i], tag by tag.
// tags holds ntags two-byte tags; vs / ve ([ntags, n]) get the value span
// of each tag's first Z value (start, offset of its NUL), -1 where there is
// none.  odd[i] = 1 where the chain cannot be walked: an unknown type, a Z
// or H value with no NUL inside the record, a B array whose subtype is not
// fixed-width or whose header or values overrun, a tag that overruns, a
// non-empty trailing gap under 4 bytes, or a chain still going after 4,096
// tags.  A record's walk stops once every tag is found (so the tags asked
// for decide which records are odd).
//
// With rg_slot >= 0 (the index of RG in tags), rg_index[i] gets the index
// of record i's RG value among the distinct values of the records that
// are not odd, in order of first appearance (-1: odd, or no RG), and
// rg_first[j] the first record holding value j; returns the number of
// distinct values (rg_first holds n).  One contiguous range of records per
// thread; the ranges' values are merged in record order.
int64_t kbbq_bam_aux_scan(const uint8_t* buf, const int64_t* aux_off,
                          const int64_t* rec_end, int64_t n,
                          const uint8_t* tags, int32_t ntags, int64_t* vs,
                          int64_t* ve, uint8_t* odd, int32_t rg_slot,
                          int32_t* rg_index, int64_t* rg_first,
                          int32_t nthreads) {
  const int T = bam_threads(n, nthreads);
  // per thread: its distinct RG values' first records, in order
  std::vector<std::vector<int64_t>> firsts(T);
  run_threads(T, [&](int t) {
    std::unordered_map<std::string_view, int32_t> seen;
    for (int64_t i = n * t / T, e = n * (t + 1) / T; i < e; i++) {
      for (int k = 0; k < ntags; k++) vs[k * n + i] = ve[k * n + i] = -1;
      int64_t cur = aux_off[i];
      const int64_t end = rec_end[i];
      // the smallest tag is 4 bytes (tag, type, a 1-byte value)
      bool active = cur + 4 <= end, bad = !active && cur != end;
      int left = ntags;
      for (int step = 0; active && step < 4096; step++) {
        const uint8_t t0 = buf[cur], t1 = buf[cur + 1], ty = buf[cur + 2];
        const int64_t v = cur + 3;
        int64_t nxt;
        if (const int size = aux_fixed(ty)) {
          nxt = v + size;
        } else if (ty == 'Z' || ty == 'H') {
          const void* z = memchr(buf + v, 0, (size_t)(end - v));
          if (z == nullptr) { bad = true; break; }
          nxt = (const uint8_t*)z - buf + 1;
          for (int k = 0; ty == 'Z' && k < ntags; k++) {
            if (tags[2 * k] == t0 && tags[2 * k + 1] == t1 &&
                vs[k * n + i] < 0) {
              vs[k * n + i] = v;
              ve[k * n + i] = nxt - 1;
              left--;
            }
          }
        } else if (ty == 'B') {
          if (v + 5 > end) { bad = true; break; }
          const int size = aux_fixed(buf[v]);
          if (size == 0) { bad = true; break; }
          uint32_t count;
          memcpy(&count, buf + v + 1, 4);
          nxt = v + 5 + (int64_t)size * count;
        } else {
          bad = true;
          break;
        }
        if (nxt > end) { bad = true; break; }
        active = nxt + 4 <= end && left > 0;
        if (nxt + 4 > end && nxt != end) bad = true;
        cur = nxt;
      }
      bad = bad || active;   // still going after 4,096 tags
      odd[i] = bad;
      if (rg_slot < 0) continue;
      const int64_t s = vs[rg_slot * n + i];
      if (bad || s < 0) {
        rg_index[i] = -1;
        continue;
      }
      const std::string_view val((const char*)buf + s,
                                 (size_t)(ve[rg_slot * n + i] - s));
      auto it = seen.try_emplace(val, (int32_t)firsts[t].size()).first;
      if (it->second == (int32_t)firsts[t].size()) firsts[t].push_back(i);
      rg_index[i] = it->second;
    }
  });
  if (rg_slot < 0) return 0;
  // each range's local indices -> indices in the order of first appearance
  std::unordered_map<std::string_view, int32_t> global;
  std::vector<std::vector<int32_t>> remap(T);
  int64_t d = 0;
  for (int t = 0; t < T; t++) {
    for (const int64_t i : firsts[t]) {
      const int64_t s = vs[rg_slot * n + i];
      const std::string_view val((const char*)buf + s,
                                 (size_t)(ve[rg_slot * n + i] - s));
      auto it = global.try_emplace(val, (int32_t)d).first;
      if (it->second == d) rg_first[d++] = i;
      remap[t].push_back(it->second);
    }
  }
  run_threads(T, [&](int t) {
    for (int64_t i = n * t / T, e = n * (t + 1) / T; i < e; i++)
      if (rg_index[i] >= 0) rg_index[i] = remap[t][rg_index[i]];
  });
  return d;
}

// ------------------------------------------------- rANS 4x8 (CRAM M4)
//
// The htslib rans_static 4x8 wire format, orders 0 and 1, with the same
// arithmetic as io/cram_codecs.py's NumPy coder: decode gives the same bytes,
// and encode the same stream (the normalisation's tie order included), so
// the two are interchangeable.  Decode returns a negative code on a malformed
// blob (-1 short, -2 declared size, -3 table or states overrun, -4 order).

static const uint32_t RANS_L = 1u << 23;
static const int TF_SHIFT = 12;
static const uint32_t TOTFREQ = 1u << TF_SHIFT;

// counts[256] -> F[256] summing exactly TOTFREQ (io/cram_codecs.py::
// _normalize_freqs)
static void rans_normalize(const int64_t* counts, int64_t* F) {
  int64_t total = 0;
  for (int j = 0; j < 256; j++) total += counts[j];
  if (total == 0) { std::memset(F, 0, 256 * sizeof(int64_t)); return; }
  int64_t sum = 0;
  for (int j = 0; j < 256; j++) {
    double f = (double)counts[j] * (double)TOTFREQ / (double)total;
    F[j] = (int64_t)std::floor(f);
    if (counts[j] > 0 && F[j] == 0) F[j] = 1;
    sum += F[j];
  }
  int order[256];
  for (int j = 0; j < 256; j++) order[j] = j;
  std::stable_sort(order, order + 256, [&](int a, int b) {
    return counts[a] > counts[b];   // np.argsort(-counts): stable desc
  });
  int64_t diff = (int64_t)TOTFREQ - sum;
  int64_t i = 0;
  while (diff != 0) {
    int j = order[i % 256];
    if (counts[j] > 0 && (diff > 0 || F[j] > 1)) {
      F[j] += diff > 0 ? 1 : -1;
      diff += diff > 0 ? -1 : 1;
    }
    i++;
  }
}

// io/cram_codecs.py::_write_freq_table; returns bytes written
static int64_t rans_write_ft(const int64_t* F, uint8_t* out) {
  int64_t o = 0;
  int rle = 0;
  for (int j = 0; j < 256; j++) {
    if (!F[j]) continue;
    if (rle) {
      rle--;
    } else {
      out[o++] = (uint8_t)j;
      if (j && F[j - 1]) {
        int r = j + 1;
        while (r < 256 && F[r]) r++;
        rle = r - (j + 1);
        out[o++] = (uint8_t)rle;
      }
    }
    int64_t f = F[j];
    if (f < 128) {
      out[o++] = (uint8_t)f;
    } else {
      out[o++] = (uint8_t)(0x80 | (f >> 8));
      out[o++] = (uint8_t)(f & 0xFF);
    }
  }
  out[o++] = 0;
  return o;
}

// io/cram_codecs.py::_read_freq_table; returns new pos, or -1 on overrun
static int64_t rans_read_ft(const uint8_t* buf, int64_t pos, int64_t n,
                            int64_t* F) {
  std::memset(F, 0, 256 * sizeof(int64_t));
  int rle = 0;
  if (pos >= n) return -1;
  int j = buf[pos++];
  for (;;) {
    if (pos >= n) return -1;
    int64_t f = buf[pos++];
    if (f >= 128) {
      if (pos >= n) return -1;
      f = ((f & 0x7F) << 8) | buf[pos++];
    }
    F[j & 0xFF] = f;
    if (rle) {
      rle--;
      j++;
    } else {
      if (pos >= n) return -1;
      int nj = buf[pos++];
      if (nj == j + 1) {
        j = nj;
        if (pos >= n) return -1;
        rle = buf[pos++];
      } else {
        j = nj;
      }
    }
    if (j == 0 && rle == 0) break;
  }
  return pos;
}

// Whether a decoded table's frequencies sum to at most TOTFREQ (a larger sum
// would write past the symbol lookup table).
static bool rans_table_fits(const int64_t* F) {
  int64_t t = 0;
  for (int s = 0; s < 256; s++) t += F[s];
  return t <= (int64_t)TOTFREQ;
}

static void rans_cumsum(const int64_t* F, int64_t* C) {
  int64_t c = 0;
  for (int s = 0; s < 256; s++) { C[s] = c; c += F[s]; }
}

// Decode an rANS 4x8 blob (order 0 or 1) into out[n_out].
// Returns 0 on success, negative on malformed input.
int32_t kbbq_rans_uncompress(const uint8_t* blob, int64_t blob_len,
                             uint8_t* out, int64_t n_out) {
  if (blob_len < 9) return -1;
  int order = blob[0];
  uint32_t n_declared;
  std::memcpy(&n_declared, blob + 5, 4);
  if ((int64_t)n_declared != n_out) return -2;
  if (n_out == 0) return 0;
  int64_t pos = 9;
  const int64_t n = blob_len;
  if (order == 0) {
    std::vector<int64_t> F(256), C(256);
    pos = rans_read_ft(blob, pos, n, F.data());
    if (pos < 0 || pos + 16 > n) return -3;
    if (!rans_table_fits(F.data())) return -3;
    rans_cumsum(F.data(), C.data());
    std::vector<uint8_t> lut(TOTFREQ);
    std::vector<uint32_t> Fs(256), Cs(256);
    for (int s = 0; s < 256; s++) {
      Fs[s] = (uint32_t)F[s];
      Cs[s] = (uint32_t)C[s];
      for (int64_t k = C[s]; k < C[s] + F[s]; k++) lut[k] = (uint8_t)s;
    }
    uint32_t x[4];
    for (int j = 0; j < 4; j++) { std::memcpy(&x[j], blob + pos, 4); pos += 4; }
    for (int64_t i = 0; i < n_out; i++) {
      int j = (int)(i & 3);
      uint32_t xi = x[j];
      uint32_t m = xi & (TOTFREQ - 1);
      uint8_t s = lut[m];
      out[i] = s;
      xi = Fs[s] * (xi >> TF_SHIFT) + m - Cs[s];
      while (xi < RANS_L && pos < n) xi = (xi << 8) | blob[pos++];
      x[j] = xi;
    }
    return 0;
  }
  if (order != 1) return -4;
  std::vector<int64_t> F2(256 * 256), C2(256 * 256);
  {
    // io/cram_codecs.py::_read_freq_table_o1 (context RLE over nested
    // order-0 tables)
    int rle = 0;
    if (pos >= n) return -3;
    int c = blob[pos++];
    for (;;) {
      pos = rans_read_ft(blob, pos, n, F2.data() + 256 * (c & 0xFF));
      if (pos < 0) return -3;
      if (rle) {
        rle--;
        c++;
      } else {
        if (pos >= n) return -3;
        int nc = blob[pos++];
        if (nc == c + 1) {
          c = nc;
          if (pos >= n) return -3;
          rle = blob[pos++];
        } else {
          c = nc;
        }
      }
      if (c == 0 && rle == 0) break;
    }
  }
  for (int c = 0; c < 256; c++) {
    if (!rans_table_fits(F2.data() + 256 * c)) return -3;
    rans_cumsum(F2.data() + 256 * c, C2.data() + 256 * c);
  }
  if (pos + 16 > n) return -3;
  uint32_t x[4];
  for (int j = 0; j < 4; j++) { std::memcpy(&x[j], blob + pos, 4); pos += 4; }
  std::vector<uint8_t> lut(256 * TOTFREQ);
  bool built[256] = {false};
  auto build = [&](int c) {
    uint8_t* t = lut.data() + (size_t)c * TOTFREQ;
    const int64_t* Fc = F2.data() + 256 * c;
    const int64_t* Cc = C2.data() + 256 * c;
    for (int s = 0; s < 256; s++)
      for (int64_t k = Cc[s]; k < Cc[s] + Fc[s]; k++) t[k] = (uint8_t)s;
    built[c] = true;
  };
  int ctx[4] = {0, 0, 0, 0};
  int64_t q = n_out >> 2;
  int64_t qs[4] = {0, q, 2 * q, 3 * q};
  auto get = [&](int j, int64_t dst) {
    int cc = ctx[j];
    if (!built[cc]) build(cc);
    uint32_t xi = x[j];
    uint32_t m = xi & (TOTFREQ - 1);
    uint8_t s = lut[(size_t)cc * TOTFREQ + m];
    out[dst] = s;
    xi = (uint32_t)F2[256 * cc + s] * (xi >> TF_SHIFT) + m
         - (uint32_t)C2[256 * cc + s];
    while (xi < RANS_L && pos < n) xi = (xi << 8) | blob[pos++];
    x[j] = xi;
    ctx[j] = s;
  };
  for (int64_t i = 0; i < q; i++)
    for (int j = 0; j < 4; j++) get(j, qs[j] + i);
  for (int64_t dst = qs[3] + q; dst < n_out; dst++) get(3, dst);
  return 0;
}

// Encode data[n] as rANS 4x8 (order 0 or 1).  Returns the blob size,
// or -1 if `cap` is too small.  Byte stream identical to the NumPy
// encoder's (tests assert it).
int64_t kbbq_rans_compress(const uint8_t* data, int64_t n, int32_t order,
                           uint8_t* out, int64_t cap) {
  // worst-case: tables (o1 <= 257*(2+3*256)+2) + 16 states + stream
  // (~n * 1.004 + 4*4 renorm tail) + 9 header
  std::vector<uint8_t> body;
  body.reserve((size_t)(n + (n >> 6) + (1 << 20)));
  std::vector<uint8_t> stream;
  stream.reserve((size_t)(n + (n >> 6) + 64));
  uint32_t x[4] = {RANS_L, RANS_L, RANS_L, RANS_L};
  const uint32_t xmax_mul = (RANS_L >> TF_SHIFT) << 8;

  if (order == 0) {
    int64_t counts[256] = {0};
    for (int64_t i = 0; i < n; i++) counts[data[i]]++;
    int64_t F[256], C[256];
    rans_normalize(counts, F);
    rans_cumsum(F, C);
    for (int64_t i = n - 1; i >= 0; i--) {
      uint8_t s = data[i];
      int j = (int)(i & 3);
      uint32_t f = (uint32_t)F[s];
      uint32_t xm = xmax_mul * f;
      while (x[j] >= xm) { stream.push_back(x[j] & 0xFF); x[j] >>= 8; }
      x[j] = ((x[j] / f) << TF_SHIFT) + (x[j] % f) + (uint32_t)C[s];
    }
    uint8_t ft[3 * 256 + 2];
    int64_t ftn = rans_write_ft(F, ft);
    body.insert(body.end(), ft, ft + ftn);
  } else if (order == 1) {
    std::vector<int64_t> counts(256 * 256, 0);
    int64_t q = n >> 2;
    int64_t qa[4] = {0, q, 2 * q, 3 * q};
    int64_t qb[4] = {q, 2 * q, 3 * q, n};
    for (int k = 0; k < 4; k++) {
      int prev = 0;
      for (int64_t i = qa[k]; i < qb[k]; i++) {
        counts[256 * prev + data[i]]++;
        prev = data[i];
      }
    }
    std::vector<int64_t> F2(256 * 256, 0), C2(256 * 256, 0);
    for (int c = 0; c < 256; c++) {
      int64_t tot = 0;
      for (int s = 0; s < 256; s++) tot += counts[256 * c + s];
      if (tot)
        rans_normalize(counts.data() + 256 * c, F2.data() + 256 * c);
      rans_cumsum(F2.data() + 256 * c, C2.data() + 256 * c);
    }
    auto put = [&](int j, int64_t i, int64_t a) {
      uint8_t s = data[i];
      int cc = i > a ? data[i - 1] : 0;
      uint32_t f = (uint32_t)F2[256 * cc + s];
      uint32_t xm = xmax_mul * f;
      while (x[j] >= xm) { stream.push_back(x[j] & 0xFF); x[j] >>= 8; }
      x[j] = ((x[j] / f) << TF_SHIFT) + (x[j] % f)
             + (uint32_t)C2[256 * cc + s];
    };
    for (int64_t i = n - 1; i >= qa[3] + q; i--) put(3, i, qa[3]);
    for (int64_t i = q - 1; i >= 0; i--)
      for (int j = 3; j >= 0; j--) put(j, qa[j] + i, qa[j]);
    // io/cram_codecs.py::_write_freq_table_o1
    int rle = 0;
    uint8_t ft[3 * 256 + 2];
    for (int c = 0; c < 256; c++) {
      int64_t tot = 0;
      for (int s = 0; s < 256; s++) tot += F2[256 * c + s];
      if (!tot) continue;
      if (rle) {
        rle--;
      } else {
        body.push_back((uint8_t)c);
        int64_t ptot = 0;
        if (c)
          for (int s = 0; s < 256; s++) ptot += F2[256 * (c - 1) + s];
        if (c && ptot) {
          int r = c + 1;
          while (r < 256) {
            int64_t rt = 0;
            for (int s = 0; s < 256; s++) rt += F2[256 * r + s];
            if (!rt) break;
            r++;
          }
          rle = r - (c + 1);
          body.push_back((uint8_t)rle);
        }
      }
      int64_t ftn = rans_write_ft(F2.data() + 256 * c, ft);
      body.insert(body.end(), ft, ft + ftn);
    }
    body.push_back(0);
  } else {
    return -2;
  }
  for (int j = 0; j < 4; j++) {
    uint32_t v = x[j];
    body.push_back(v & 0xFF);
    body.push_back((v >> 8) & 0xFF);
    body.push_back((v >> 16) & 0xFF);
    body.push_back((v >> 24) & 0xFF);
  }
  // stream is collected forward but transmitted reversed
  int64_t total = 9 + (int64_t)body.size() + (int64_t)stream.size();
  if (total > cap) return -1;
  out[0] = (uint8_t)order;
  uint32_t csize = (uint32_t)(body.size() + stream.size());
  uint32_t usize = (uint32_t)n;
  std::memcpy(out + 1, &csize, 4);
  std::memcpy(out + 5, &usize, 4);
  std::memcpy(out + 9, body.data(), body.size());
  uint8_t* o = out + 9 + body.size();
  for (int64_t i = (int64_t)stream.size() - 1; i >= 0; i--)
    *o++ = stream[i];
  return total;
}


}  // extern "C"
