// Hand-written CUDA kernels of kbbq_tpu_torch for NVIDIA Hopper (sm_90a).
//
// Built by kbbq_tpu_torch/kernels/__init__.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  Every
// extern "C" function takes raw device pointers, sizes and the CUDA stream,
// launches on that stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError().
//
// 32-bit unsigned words (filter words, hashes, k-mer lanes) arrive as the
// bit patterns of torch.int32 tensors and are read here as uint32_t.  bool
// tensors are one byte per element, 0 or 1.
//
// The arithmetic is the bit-exact spec of kbbq_tpu/oracle (DECISIONS.md
// D1-D3, D7): fmix32, the (h1, h2) double hash, the blocked probe layout
// (all probes of a k-mer in one 32-bit word) and the correction walk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kFmixC1 = 0x85EBCA6Bu;
constexpr uint32_t kFmixC2 = 0xC2B2AE35u;
constexpr uint32_t kSeedH1 = 0x9E3779B9u;
constexpr uint32_t kSeedH2 = 0x85EBCA77u;

constexpr int kThreads = 256;      // probe / build blocks
constexpr int kWalkThreads = 128;  // walk blocks
constexpr int kMaxBlocks = 132 * 32;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kFmixC1;
  x ^= x >> 13;
  x *= kFmixC2;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t rotr32(uint32_t x, uint32_t s) {
  return (x >> s) | (x << ((32u - s) & 31u));
}

// OR of the num_hashes probe bits rotr32(h2, 5j & 31) & 31 of one k-mer.
__device__ __forceinline__ uint32_t probe_word(uint32_t h2, int num_hashes) {
  uint32_t w = 0;
  for (int j = 0; j < num_hashes; ++j)
    w |= 1u << (rotr32(h2, (5u * (uint32_t)j) & 31u) & 31u);
  return w;
}

// The one device function behind both entry points of the probe and behind
// every probe of the walk: one random 4-byte read of the filter.
__device__ __forceinline__ bool word_test(const uint32_t* __restrict__ packed,
                                          uint32_t block_mask, uint32_t h1,
                                          uint32_t word) {
  return (__ldg(packed + (h1 & block_mask)) & word) == word;
}

__device__ __forceinline__ bool probe_kmer(const uint32_t* __restrict__ packed,
                                           uint32_t block_mask, uint32_t hi,
                                           uint32_t lo, int num_hashes) {
  const uint32_t h1 = fmix32(lo ^ fmix32(hi ^ kSeedH1));
  const uint32_t h2 = fmix32(hi ^ fmix32(lo ^ kSeedH2));
  return word_test(packed, block_mask, h1, probe_word(h2, num_hashes));
}

inline int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

// ---------------------------------------------------------------------------
// K1  bloom_probe
//
// Replaces: kbbq_tpu/ops/pallas_bloom.py::_probe_kernel (reached through
//   bloom_query_rows_pallas), the blocked-Bloom membership test, and the
//   cached word test the resident pipeline runs in XLA
//   (kbbq_tpu/pipeline/resident.py, _pass2_dense_cached / _pass3_walks).
// Bound by: bytes.  Per k-mer the streamed inputs (8 B) and the 1 B answer,
//   plus one random 4-byte read of the filter; at 32 MiB the filter sits
//   largely in the 50 MB L2, so the random read rarely reaches device memory.
// Design: one thread per k-mer, grid-stride, neighbouring threads on
//   neighbouring inputs so the streams coalesce; the filter word comes
//   through the read-only path.  The Pallas kernel's [rows, 128] row gather
//   and lane select exist only because Mosaic lowers 2-D gathers alone: here
//   the word is simply loaded.  The hashed entry point computes fmix32 and the
//   (h1, h2) pair inside the kernel (the TPU version left them to XLA).
// ---------------------------------------------------------------------------

__global__ void bloom_probe_hashed_kernel(const uint32_t* __restrict__ packed,
                                          uint32_t block_mask,
                                          const uint32_t* __restrict__ hi,
                                          const uint32_t* __restrict__ lo,
                                          uint8_t* __restrict__ out, int64_t n,
                                          int num_hashes) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = probe_kmer(packed, block_mask, hi[i], lo[i], num_hashes) ? 1 : 0;
}

__global__ void bloom_probe_words_kernel(const uint32_t* __restrict__ packed,
                                         uint32_t block_mask,
                                         const uint32_t* __restrict__ h1,
                                         const uint32_t* __restrict__ word,
                                         uint8_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t w = word[i];
    // word == 0 marks an invalid window (a probe word is never zero)
    out[i] = (w != 0u && word_test(packed, block_mask, h1[i], w)) ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// K3  bloom_or_words
//
// Replaces: the XLA sort build kbbq_tpu/ops/bloom.py::bloom_rows_dense (sort,
//   segmented OR-scan, compaction sort, unique scatter) and the byte-staging
//   scatter + MXU pack (bloom_insert_rows, bloom_rows), which exist only
//   because TPU scatters serialise.
// Bound by: bytes.  9 B streamed per window (h1, word, keep) plus one atomic
//   read-modify-write of a filter word per KEPT window; the 32 MiB filter is
//   L2-resident, where atomics resolve.
// Design: one thread per window, grid-stride, atomicOr on uint32_t into a
//   zeroed (or partly built) filter.  OR commutes and is idempotent, so the
//   words equal the sort build's word for word whatever the thread order.
// ---------------------------------------------------------------------------

__global__ void bloom_or_words_kernel(uint32_t* __restrict__ packed,
                                      uint32_t block_mask,
                                      const uint32_t* __restrict__ h1,
                                      const uint32_t* __restrict__ word,
                                      const uint8_t* __restrict__ keep,
                                      int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    if (keep[i]) atomicOr(packed + (h1[i] & block_mask), word[i]);
}

// ---------------------------------------------------------------------------
// K2  walk_errors
//
// Replaces: kbbq_tpu/ops/pallas_walk.py::_round_kernel (reached through
//   walk_rounds_pallas) AND the XLA while_loop around it
//   (kbbq_tpu/ops/inference.py::_walk_rounds_pl / _walk_loop): the whole
//   directional correction walk of every read, in ONE launch.  What it
//   computes is kbbq_tpu/oracle/lighter.py::infer_read_errors.
// Bound by: operations, and by latency rather than throughput: per window a
//   rolled 64-bit k-mer, two fmix32 pairs and a dependent random 4-byte read
//   of the L2-resident filter; lanes of a warp run different trip counts.
//   The bytes (codes in, error mask out, initial trust in) are small beside
//   that.
// Design: one thread per (read, direction).  The two directions touch
//   disjoint windows and bases (right: windows > anchor end b, bases >= b+k;
//   left: windows < anchor start a, bases <= a+k-2), so they run as
//   independent lanes on one working copy of the read.  The left walk is the
//   right walk on the reverse complement (canonical k-mers are
//   strand-invariant), read through index arithmetic, with the candidate
//   order reversed so ties still go to the smallest ORIGINAL code.  The
//   forward and RC k-mer are two uint64_t rolled base by base (forward
//   big-endian; hi = bits 32.., lo = bits 0..31); k = 32 fills the word, so
//   the mask is special-cased instead of shifting by 64.  Windows not yet
//   touched by a commit take their trust from `trusted0` (the probe kernel's
//   answer on the original read); windows overlapping a committed base are
//   probed on the working sequence.  None of the TPU version's barrel rolls,
//   pre-rolled planes, fourth candidate, re-verify rounds, chunking or
//   difficulty sort is needed: a thread just loops until its lane is done.
// ---------------------------------------------------------------------------

struct WalkCtx {
  int8_t* w;            // working copy of the read, [L]
  uint8_t* e;           // error marks of the read, [L]
  const uint8_t* tr;    // initial trust of the read's windows, [n]
  const uint32_t* packed;
  uint32_t block_mask;
  int L, n, k, W, num_hashes, dir;
  uint64_t kmask;
  int top;              // bit position of the first base: 2(k-1)

  // base i of the walk's own strand (dir 1: the reverse complement)
  __device__ __forceinline__ int rd(int i) const {
    if (dir == 0) return w[i];
    const int c = w[L - 1 - i];
    return c < 4 ? 3 - c : c;
  }
  __device__ __forceinline__ void wr(int i, int c) const {
    if (dir == 0) w[i] = (int8_t)c; else w[L - 1 - i] = (int8_t)(3 - c);
  }
  __device__ __forceinline__ void mark(int i) const {
    e[dir == 0 ? i : L - 1 - i] = 1;
  }
  __device__ __forceinline__ bool trusted0(int j) const {
    return tr[dir == 0 ? j : n - 1 - j] != 0;
  }
  __device__ __forceinline__ bool probe(uint64_t f, uint64_t rc) const {
    const uint64_t c = f <= rc ? f : rc;  // canonical: (hi, lo) unsigned order
    return probe_kmer(packed, block_mask, (uint32_t)(c >> 32), (uint32_t)c,
                      num_hashes);
  }
  // roll base c (< 4) into the window's forward and RC words
  __device__ __forceinline__ void roll(uint64_t& f, uint64_t& rc, int c) const {
    f = ((f << 2) | (uint64_t)c) & kmask;
    rc = (rc >> 2) | ((uint64_t)(3 - c) << top);
  }
  // replace the LAST base of the window (forward bits 0..1, RC bits top..)
  __device__ __forceinline__ void patch_last(uint64_t& f, uint64_t& rc,
                                             int c) const {
    f = (f & ~3ull) | (uint64_t)c;
    rc = (rc & ~(3ull << top)) | ((uint64_t)(3 - c) << top);
  }
};

__global__ void walk_errors_kernel(int8_t* __restrict__ work,
                                   const uint8_t* __restrict__ trusted0,
                                   const uint32_t* __restrict__ packed,
                                   uint32_t block_mask,
                                   uint8_t* __restrict__ err,
                                   int64_t num_reads, int L, int k, int W,
                                   int num_hashes) {
  const int n = L - k + 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       lane < 2 * num_reads; lane += stride) {
    const int64_t r = lane >> 1;
    WalkCtx cx;
    cx.w = work + r * L;
    cx.e = err + r * L;
    cx.tr = trusted0 + r * n;
    cx.packed = packed;
    cx.block_mask = block_mask;
    cx.L = L; cx.n = n; cx.k = k; cx.W = W; cx.num_hashes = num_hashes;
    cx.dir = (int)(lane & 1);
    cx.kmask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1ull);
    cx.top = 2 * (k - 1);

    // anchor = longest run of initially trusted windows, ties leftmost.  A
    // read with no trusted window has no anchor and is skipped; an
    // all-trusted read walks over no break and marks nothing.
    int best_len = 0, best_s = -1, cur = 0;
    for (int i = 0; i < n; ++i) {
      if (cx.tr[i]) {
        ++cur;
        if (cur > best_len) { best_len = cur; best_s = i - cur + 1; }
      } else {
        cur = 0;
      }
    }
    if (best_len == 0) continue;
    const int a = best_s, b = best_s + best_len - 1;

    // first window of the walk, on its own strand
    int j = cx.dir == 0 ? b + 1 : n - a;
    if (j >= n) continue;

    // (f, rc, run) describe window j of the WORKING sequence; run counts the
    // consecutive non-N bases ending at base j+k-1, the window is valid iff
    // run >= k (k rolls flush whatever an N left behind)
    uint64_t f = 0, rc = 0;
    int run = 0;
    for (int i = j; i < j + k; ++i) {
      const int c = cx.rd(i);
      if (c >= 4) { run = 0; } else { cx.roll(f, rc, c); ++run; }
    }
    int dirty = -1;  // windows <= dirty overlap a committed base

    while (j < n) {
      int adv = 1;
      bool is_break = false;
      if (run >= k)
        is_break = !(j > dirty ? cx.trusted0(j) : cx.probe(f, rc));
      if (is_break) {
        const int p = j + k - 1;  // base newly entering window j
        const int orig = cx.rd(p);
        int best_c = -1, best_ext = 0;
        for (int ci = 0; ci < 4; ++ci) {
          // ascending ORIGINAL code: on the RC strand that is descending
          const int c = cx.dir == 0 ? ci : 3 - ci;
          if (c == orig) continue;
          uint64_t cf = f, crc = rc;
          cx.patch_last(cf, crc, c);
          // extension: leading trusted windows j, j+1, .. on the working
          // sequence with base p = c, at most W and not past the read's end
          int ext = 0;
          while (cx.probe(cf, crc)) {
            ++ext;
            if (ext >= W || j + ext >= n) break;
            const int nb = cx.rd(p + ext);
            if (nb >= 4) break;  // window with an N: never trusted
            cx.roll(cf, crc, nb);
          }
          if (ext > best_ext) { best_ext = ext; best_c = c; }  // strict: ties
        }                                                      // keep first
        cx.mark(p);
        if (best_ext >= 1) {
          cx.wr(p, best_c);
          cx.patch_last(f, rc, best_c);
          dirty = p;
          adv = best_ext;
        }
      }
      for (int s = 0; s < adv; ++s) {
        ++j;
        if (j >= n) break;
        const int c = cx.rd(j + k - 1);
        if (c >= 4) { run = 0; } else { cx.roll(f, rc, c); ++run; }
      }
    }
  }
}

}  // namespace

extern "C" {

int kbbq_bloom_probe_hashed(const void* packed, uint32_t block_mask,
                            const void* hi, const void* lo, void* out,
                            int64_t n, int num_hashes, void* stream) {
  if (n > 0)
    bloom_probe_hashed_kernel<<<grid_for(n, kThreads), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)packed, block_mask, (const uint32_t*)hi,
        (const uint32_t*)lo, (uint8_t*)out, n, num_hashes);
  return (int)cudaGetLastError();
}

int kbbq_bloom_probe_words(const void* packed, uint32_t block_mask,
                           const void* h1, const void* word, void* out,
                           int64_t n, void* stream) {
  if (n > 0)
    bloom_probe_words_kernel<<<grid_for(n, kThreads), kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const uint32_t*)packed, block_mask, (const uint32_t*)h1,
        (const uint32_t*)word, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

int kbbq_bloom_or_words(void* packed, uint32_t block_mask, const void* h1,
                        const void* word, const void* keep, int64_t n,
                        void* stream) {
  if (n > 0)
    bloom_or_words_kernel<<<grid_for(n, kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (uint32_t*)packed, block_mask, (const uint32_t*)h1,
        (const uint32_t*)word, (const uint8_t*)keep, n);
  return (int)cudaGetLastError();
}

// work: int8 [num_reads, L] scratch holding a COPY of the codes (updated in
// place); trusted0: bool [num_reads, L-k+1]; err: bool [num_reads, L], zeroed.
int kbbq_walk_errors(void* work, const void* trusted0, const void* packed,
                     uint32_t block_mask, void* err, int64_t num_reads, int L,
                     int k, int W, int num_hashes, void* stream) {
  if (num_reads > 0 && L - k + 1 > 0)
    walk_errors_kernel<<<grid_for(2 * num_reads, kWalkThreads), kWalkThreads,
                         0, (cudaStream_t)stream>>>(
        (int8_t*)work, (const uint8_t*)trusted0, (const uint32_t*)packed,
        block_mask, (uint8_t*)err, num_reads, L, k, W, num_hashes);
  return (int)cudaGetLastError();
}

}  // extern "C"
