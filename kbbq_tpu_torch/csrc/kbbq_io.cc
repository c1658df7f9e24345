// Host IO codec of kbbq_tpu_torch: multithreaded BGZF, the FASTQ record
// scanner, padded-array decode and quality write-back, and the BAM record
// index, machine-order decode, QUAL write-back and OQ append.  A C ABI loaded
// with ctypes (kbbq_tpu_torch/io/native_lib.py builds it with g++ at first
// use).
//
// Counterpart of these functions of kbbq_tpu/io/native/kbbq_io.cc, with the
// same arithmetic (so the same bytes): kbbq_bgzf_size, kbbq_bgzf_decompress,
// kbbq_bgzf_compress, kbbq_fastq_index, kbbq_fastq_extract,
// kbbq_fastq_write_quals, kbbq_bam_offsets and kbbq_bam_decode.  Two
// differences: kbbq_fastq_index and kbbq_bam_offsets return -1 - (byte offset
// of the record that failed) on malformed input instead of a bare -1.
// kbbq_bam_write_quals and kbbq_bam_append_oq are the port's own: they do
// what loops of kbbq_tpu/io/bam_vec.py::rewrite_quals_chunk do in NumPy.  The
// reference's host pass 4, host histogram, tunnel packing and rANS functions
// are not part of the port.

#include <cstdint>
#include <cstring>
#include <thread>
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

}  // extern "C"
