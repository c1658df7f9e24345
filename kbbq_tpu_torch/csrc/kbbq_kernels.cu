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

constexpr uint32_t kSeedSample = 0xC0FFEE01u;
constexpr uint32_t kGolden = 0x9E3779B9u;

constexpr int kThreads = 256;      // probe / build / hash / trust-rule blocks
constexpr int kMaxBlocks = 132 * 32;
constexpr int kDefaultHashes = 7;  // DEFAULT_NUM_HASHES of the spec
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may ask for
constexpr uint32_t kFullWarp = 0xFFFFFFFFu;

constexpr int kTrustUnroll = 4;  // chunks of 32 windows whose filter reads a
                                 // thread starts before it uses any

// A streamed input is read once and a streamed output written once: evict
// first, so that they do not push the filter out of L2.
template <class T>
__device__ __forceinline__ T stream_load(const T* p) {
  return __ldcs(p);
}

template <class T>
__device__ __forceinline__ void stream_store(T* p, T v) {
  __stcs(p, v);
}

// The probe's read of a filter word: read-only path, and the line is marked
// evict-last in L2 (a cache policy made once per thread by filter_policy()),
// because the filter is read once per window and the streams once in all.
// A build for the host has no PTX: there it is a plain read-only load.
__device__ __forceinline__ uint64_t filter_policy() {
#ifdef __CUDA_ARCH__
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
#else
  return 0;
#endif
}

__device__ __forceinline__ uint32_t filter_word(const uint32_t* p,
                                                uint64_t policy) {
#ifdef __CUDA_ARCH__
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
#else
  (void)policy;
  return __ldg(p);
#endif
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= kFmixC1;
  x ^= x >> 13;
  x *= kFmixC2;
  x ^= x >> 16;
  return x;
}

// OR of the num_hashes probe bits 1 << ((h2 rotated right by 5j mod 32) mod
// 32) of one k-mer, each two funnel shifts (a rotation, then 1 << (x & 31)).
// kHashes > 0 fixes the count at compile time, and the loop unrolls whole;
// a count known only at run time keeps a loop test and computed shift
// counts, which made the fused hash kernel 7-18 % slower (PERF.md).
template <int kHashes = 0>
__device__ __forceinline__ uint32_t probe_word(uint32_t h2, int num_hashes) {
  const int count = kHashes > 0 ? kHashes : num_hashes;
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < count; ++j)
    w |= __funnelshift_l(0u, 1u, __funnelshift_r(h2, h2, 5u * (uint32_t)j));
  return w;
}

// block hash and probe word of a canonical k-mer (hi, lo)
template <int kHashes = 0>
__device__ __forceinline__ void kmer_hash(uint32_t hi, uint32_t lo,
                                          int num_hashes, uint32_t& h1,
                                          uint32_t& word) {
  h1 = fmix32(lo ^ fmix32(hi ^ kSeedH1));
  word = probe_word<kHashes>(fmix32(hi ^ fmix32(lo ^ kSeedH2)), num_hashes);
}

inline int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

// One insert of the cached build: packed[h1 & mask] |= word.  The word is
// read first through L2 (__ldcg: the filter is being written, so not the
// read-only path) and the atomic is skipped when every bit is already set:
// the cached build's windows mostly repeat.  A stale read can only miss a
// bit, which the atomic then sets, so the filter is the same with and
// without the test.
__device__ __forceinline__ void or_word(uint32_t* __restrict__ packed,
                                        uint32_t block_mask, uint32_t h1,
                                        uint32_t word) {
  uint32_t* p = packed + (h1 & block_mask);
  if ((__ldcg(p) & word) == word) return;
  atomicOr(p, word);
}

// One insert of the fused build: the atomic at once (testing first measured
// slower there, PERF.md), its line marked evict-last in L2 as the probe's
// filter reads are (`policy` from filter_policy()).  A build for the host has
// no PTX: there it is a plain atomicOr.
__device__ __forceinline__ void or_word_last(uint32_t* p, uint32_t word,
                                             uint64_t policy) {
#ifdef __CUDA_ARCH__
  asm volatile("red.relaxed.gpu.global.or.L2::cache_hint.b32 [%0], %1, %2;"
               :
               : "l"(p), "r"(word), "l"(policy)
               : "memory");
#else
  (void)policy;
  atomicOr(p, word);
#endif
}

// reverse complement of a k-mer held in the low 2k bits
__device__ __forceinline__ uint64_t revcomp_kmer(uint64_t f, int k) {
  uint64_t x = __brevll(~f);  // reverses the bases, and the bits of each
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return x >> (64 - 2 * k);
}

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// Copy of `nbytes` between device memory and shared memory by all `nthreads`
// threads of a block: 16 bytes a thread where dst and src are congruent
// modulo 16 (single bytes before the first and after the last aligned 16),
// else 4 bytes a thread where they are congruent modulo 4, else single
// bytes.  The tiles below are placed in shared memory at a device address's
// offset modulo 16, so that whatever the base pointer and the tile's start,
// the tile's main copy takes the wide path.
// kStream 1: src is a streamed input (stream_load); 2: dst is a streamed
// output (stream_store); 0: plain loads and stores.
template <int kStream, class T>
__device__ __forceinline__ void copy_unit(T* d, const T* s) {
  if (kStream == 1) *d = stream_load(s);
  else if (kStream == 2) stream_store(d, *s);
  else *d = *s;
}

template <int kStream = 0>
__device__ __forceinline__ void tile_copy(uint8_t* dst, const uint8_t* src,
                                          int nbytes, int tid, int nthreads) {
  const uint32_t apart =
      (uint32_t)((uintptr_t)dst ^ (uintptr_t)src);  // low bits that differ
  const uint32_t unit = (apart & 15u) == 0u ? 16u : (apart & 3u) == 0u ? 4u : 1u;
  int head = (int)((unit - (uint32_t)((uintptr_t)src & (unit - 1u))) &
                   (unit - 1u));
  if (head > nbytes) head = nbytes;
  const int body = unit == 1u ? 0 : (nbytes - head) / (int)unit;
  for (int i = tid; i < head; i += nthreads) dst[i] = src[i];
  if (unit == 16u) {
    uint4* d = reinterpret_cast<uint4*>(dst + head);
    const uint4* s = reinterpret_cast<const uint4*>(src + head);
    for (int i = tid; i < body; i += nthreads)
      copy_unit<kStream>(d + i, s + i);
  } else if (unit == 4u) {
    uint32_t* d = reinterpret_cast<uint32_t*>(dst + head);
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src + head);
    for (int i = tid; i < body; i += nthreads)
      copy_unit<kStream>(d + i, s + i);
  }
  for (int i = head + body * (int)unit + tid; i < nbytes; i += nthreads)
    dst[i] = src[i];
}

// ---------------------------------------------------------------------------
// K1  bloom_probe
//
// Replaces: kbbq_tpu/ops/pallas_bloom.py::_probe_kernel (reached through
//   bloom_query_rows_pallas), the blocked-Bloom membership test, and the
//   cached word test the resident pipeline runs in XLA
//   (kbbq_tpu/pipeline/resident.py, _pass2_dense_cached / _pass3_walks); the
//   fused entry point bloom_probe_trust also replaces pass 2's coverage rule
//   (kbbq_tpu/ops/trusted.py::trusted_mask_batch), which has no Pallas kernel.
// Bound by: bytes on paper (8 B in and 1 B out per window, the filter once),
//   in practice by L2 sector traffic: every window makes one random 4-byte
//   read of the filter, which moves a 32-byte sector through L2, 3.5 times
//   the bytes of the streams.
// Design: the filter is the thing to keep in L2 and the random reads are the
//   thing to keep in flight.
//   - A thread takes 4 consecutive windows per step: one 16-byte load of each
//     input, four filter reads started before any is used, the four answers
//     in one 4-byte store (four 1-byte stores where the output does not
//     follow the inputs modulo 4).  Where the two inputs are not congruent
//     modulo 16 every window takes the scalar path; else only the few
//     before the first and after the last aligned group do.
//   - The streams are loaded and stored evict-first (__ldcs / __stcs); the
//     filter word comes through the read-only path with an evict-last L2
//     policy.  Both are per-load hints: no launch inherits anything.
//   - The hashed entry point computes fmix32 and the (h1, h2) pair inside the
//     same body (the TPU version left them to XLA).  The Pallas kernel's
//     [rows, 128] row gather and lane select exist only because Mosaic
//     lowers 2-D gathers alone: here the word is simply loaded.
//   - bloom_probe_trust (pass 2) keeps the answers on the SM.  A block stages
//     a tile of reads' h1 and word rows in shared memory with wide streamed
//     loads; a warp takes a read, thread t the windows t, t+32, ..: it starts
//     kTrustUnroll filter reads back to back, and ballots turn the answers
//     into bit masks (hit, valid).  A count over a sliding window of at most
//     32 positions is then the popcount of a masked 64-bit shift, so the
//     coverage rule needs no prefix sum and no integer plane: per base the
//     hits s and the valid windows x among the windows that overlap it,
//     covered = s >= t[x] (t in shared memory), again a bit mask; per window
//     trusted = valid and at least T of its k bases covered.  Only that byte
//     per window leaves the SM, through a shared-memory tile and wide
//     streamed stores.  The build of filter B from those bytes stays the
//     launch of its own that bloom_or_words is: fused in here it would save
//     about a millisecond and orphan that kernel's cached entry point.
//   - The rule-only entry point (kbbq_trust_rule, pass 2 of the
//     hash-space-sharded layout) takes the hits plane of the collective word
//     test in place of the filter.  With no gather left it is bound by integer
//     issue (33 ALU instructions a window) and close behind by its bytes (1 B +
//     4 B in, 1 B out per window), so it has a body of its own with nothing
//     staged: a warp per read, thread t on windows t, t+32, ..; each 32 windows
//     are one coalesced load of their hit bytes and words, issued a step ahead,
//     and two ballots (hit, valid).  The rule then streams over the read: the
//     covered mask of the 32 bases a chunk of windows starts at needs only that
//     chunk's masks and the one before, and a window's trusted bit only its own
//     bases' covered bits and the next 32, so every mask lives in registers,
//     the table t(x) in a register per lane (read by a shuffle), and each byte
//     is stored by its lane, coalesced.  No shared memory, no __syncthreads,
//     and no length limit.
// ---------------------------------------------------------------------------

// One window of either entry point: (a, b) is the cached (h1, word) pair or
// the canonical k-mer (hi, lo) to hash.  word == 0 marks an invalid window (a
// probe word is never zero).
template <bool kHashed>
__device__ __forceinline__ void probe_args(uint32_t a, uint32_t b,
                                           int num_hashes, uint32_t& h1,
                                           uint32_t& word) {
  if (kHashed) {
    kmer_hash(a, b, num_hashes, h1, word);
  } else {
    h1 = a;
    word = b;
  }
}

__device__ __forceinline__ uint32_t word_test(uint32_t got, uint32_t word) {
  return (word != 0u && (got & word) == word) ? 1u : 0u;
}

template <bool kHashed>
__device__ __forceinline__ void probe_one(const uint32_t* __restrict__ packed,
                                          uint32_t block_mask,
                                          const uint32_t* a, const uint32_t* b,
                                          uint8_t* out, int64_t i,
                                          int num_hashes, uint64_t policy) {
  uint32_t h1, w;
  probe_args<kHashed>(stream_load(a + i), stream_load(b + i), num_hashes, h1,
                      w);
  stream_store(out + i, (uint8_t)word_test(
      filter_word(packed + (h1 & block_mask), policy), w));
}

template <bool kHashed>
__device__ __forceinline__ void bloom_probe_body(
    const uint32_t* __restrict__ packed, uint32_t block_mask,
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    uint8_t* __restrict__ out, int64_t n, int num_hashes) {
  const uint64_t policy = filter_policy();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  // windows before the first group: up to the inputs' first 16-byte
  // boundary where the two are congruent modulo 16, else all of them
  int64_t head = n;
  if ((((uintptr_t)a ^ (uintptr_t)b) & 15u) == 0u) {
    const int64_t h = (int64_t)(((16u - ((uintptr_t)a & 15u)) & 15u) >> 2);
    if (h < n) head = h;
  }
  const int64_t groups = (n - head) / 4;
  const uint4* a4 = reinterpret_cast<const uint4*>(a + head);
  const uint4* b4 = reinterpret_cast<const uint4*>(b + head);
  uint8_t* o1 = out + head;
  uint32_t* o4 = reinterpret_cast<uint32_t*>(o1);
  const bool wide_out = ((uintptr_t)o1 & 3u) == 0u;  // else a byte at a time
  for (int64_t g = tid; g < groups; g += stride) {
    const uint4 va = stream_load(a4 + g), vb = stream_load(b4 + g);
    const uint32_t xa[4] = {va.x, va.y, va.z, va.w};
    const uint32_t xb[4] = {vb.x, vb.y, vb.z, vb.w};
    uint32_t w[4], got[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h1;
      probe_args<kHashed>(xa[e], xb[e], num_hashes, h1, w[e]);
      got[e] = filter_word(packed + (h1 & block_mask), policy);
    }
    uint32_t r = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) r |= word_test(got[e], w[e]) << (8 * e);
    if (wide_out) {
      stream_store(o4 + g, r);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stream_store(o1 + 4 * g + e, (uint8_t)(r >> (8 * e)));
    }
  }
  for (int64_t i = tid; i < head; i += stride)
    probe_one<kHashed>(packed, block_mask, a, b, out, i, num_hashes, policy);
  for (int64_t i = head + 4 * groups + tid; i < n; i += stride)
    probe_one<kHashed>(packed, block_mask, a, b, out, i, num_hashes, policy);
}

__global__ void bloom_probe_hashed_kernel(const uint32_t* __restrict__ packed,
                                          uint32_t block_mask,
                                          const uint32_t* __restrict__ hi,
                                          const uint32_t* __restrict__ lo,
                                          uint8_t* __restrict__ out, int64_t n,
                                          int num_hashes) {
  bloom_probe_body<true>(packed, block_mask, hi, lo, out, n, num_hashes);
}

__global__ void bloom_probe_words_kernel(const uint32_t* __restrict__ packed,
                                         uint32_t block_mask,
                                         const uint32_t* __restrict__ h1,
                                         const uint32_t* __restrict__ word,
                                         uint8_t* __restrict__ out, int64_t n) {
  bloom_probe_body<false>(packed, block_mask, h1, word, out, n, 0);
}

// 32-bit words of a bit mask of x positions, and one more so that a range
// may always read two
__host__ __device__ inline int mask_words(int x) { return (x + 31) / 32 + 1; }

// set bits among positions lo .. lo+len-1 of a bit mask, 1 <= len <= 32
__device__ __forceinline__ int range_count(const uint32_t* bits, int lo,
                                           int len) {
  const int q = lo >> 5;
  const uint64_t two = (uint64_t)bits[q] | ((uint64_t)bits[q + 1] << 32);
  const uint32_t v = (uint32_t)(two >> (lo & 31));
  return __popc(len >= 32 ? v : v & ((1u << len) - 1u));
}

// shared memory of one block of bloom_probe_trust_kernel, in bytes: the h1 and
// word rows of the tile, its trusted bytes, the threshold table, and per
// warp the three bit masks of the read it works on
__host__ __device__ inline int trust_tile_bytes(int n, int k, int rows,
                                                int threads) {
  return 2 * round16(rows * n * 4 + 16) + round16(rows * n + 16) +
         round16((k + 1) * 4) +
         round16((threads / 32) * (2 * mask_words(n) + mask_words(n + k - 1)) *
                 4);
}

__global__ void bloom_probe_trust_kernel(
    const uint32_t* __restrict__ packed, uint32_t block_mask,
    const uint32_t* __restrict__ h1, const uint32_t* __restrict__ word,
    const int32_t* __restrict__ thresholds, uint8_t* __restrict__ out,
    int64_t num_reads, int n, int k, int trust_threshold, int tile_rows) {
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int L = n + k - 1;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int64_t r0 = (int64_t)blockIdx.x * tile_rows;
  const int64_t rest = num_reads - r0;
  const int R = rest < tile_rows ? (int)rest : tile_rows;

  const uint8_t* gh1 = reinterpret_cast<const uint8_t*>(h1 + r0 * n);
  const uint8_t* gword = reinterpret_cast<const uint8_t*>(word + r0 * n);
  uint8_t* gout = out + r0 * n;
  const int plane = round16(tile_rows * n * 4 + 16);
  // each plane at its device address's offset modulo 16 (a multiple of 4)
  uint8_t* sh1 = smem + ((uintptr_t)gh1 & 15u);
  uint8_t* sword = smem + plane + ((uintptr_t)gword & 15u);
  uint8_t* sout = smem + 2 * plane + ((uintptr_t)gout & 15u);
  int32_t* st = reinterpret_cast<int32_t*>(smem + 2 * plane +
                                           round16(tile_rows * n + 16));
  const int nw = mask_words(n), lw = mask_words(L);
  uint32_t* hit = reinterpret_cast<uint32_t*>(st) + round16((k + 1) * 4) / 4 +
                  (tid >> 5) * (2 * nw + lw);
  uint32_t* valid = hit + nw;
  uint32_t* cov = valid + nw;

  tile_copy<1>(sh1, gh1, R * n * 4, tid, nthreads);
  tile_copy<1>(sword, gword, R * n * 4, tid, nthreads);
  for (int i = tid; i <= k; i += nthreads) st[i] = thresholds[i];
  __syncthreads();

  const uint64_t policy = filter_policy();
  const int lane = tid & 31;
  const int nc = (n + 31) >> 5, lc = (L + 31) >> 5;
  if (lane == 0) hit[nc] = valid[nc] = cov[lc] = 0u;  // the words never set
  for (int r = tid >> 5; r < R; r += nthreads >> 5) {
    const uint32_t* rh = reinterpret_cast<const uint32_t*>(sh1) + r * n;
    const uint32_t* rw = reinterpret_cast<const uint32_t*>(sword) + r * n;
    // 1. the probes: hit and valid, a bit per window
    for (int c0 = 0; c0 < nc; c0 += kTrustUnroll) {
      uint32_t w[kTrustUnroll], got[kTrustUnroll];
#pragma unroll
      for (int u = 0; u < kTrustUnroll; ++u) {
        const int j = (c0 + u) * 32 + lane;
        w[u] = got[u] = 0u;
        if (j < n) {
          w[u] = rw[j];
          got[u] = filter_word(packed + (rh[j] & block_mask), policy);
        }
      }
#pragma unroll
      for (int u = 0; u < kTrustUnroll; ++u) {
        const uint32_t vb = __ballot_sync(kFullWarp, w[u] != 0u);
        const uint32_t hb =
            __ballot_sync(kFullWarp, word_test(got[u], w[u]) != 0u);
        if (lane == 0 && c0 + u < nc) {
          valid[c0 + u] = vb;
          hit[c0 + u] = hb;
        }
      }
    }
    __syncwarp();
    // 2. covered, a bit per base: s hits among the x valid windows that
    // overlap base i, windows max(0, i-k+1) .. min(i, n-1)
    for (int c = 0; c < lc; ++c) {
      const int i = c * 32 + lane;
      bool covered = false;
      if (i < L) {
        const int lo = i - k + 1 > 0 ? i - k + 1 : 0;
        const int len = (i < n - 1 ? i : n - 1) - lo + 1;
        covered = range_count(hit, lo, len) >= st[range_count(valid, lo, len)];
      }
      const uint32_t cb = __ballot_sync(kFullWarp, covered);
      if (lane == 0) cov[c] = cb;
    }
    __syncwarp();
    // 3. trusted, a byte per window: valid, and at least trust_threshold of
    // its k bases covered
    for (int j = lane; j < n; j += 32) {
      const bool ok = ((valid[j >> 5] >> (j & 31)) & 1u) != 0u;
      sout[r * n + j] =
          (ok && range_count(cov, j, k) >= trust_threshold) ? 1 : 0;
    }
    __syncwarp();  // the next read's ballots overwrite the masks
  }
  __syncthreads();
  tile_copy<2>(gout, sout, R * n, tid, nthreads);
}

// bits s .. s+31 of the 64-bit word (hi:lo), 0 <= s < 64
__device__ __forceinline__ uint32_t bits_at(uint32_t lo, uint32_t hi, int s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> s);
}

// The coverage rule's covered bits of the 32 bases of one chunk, base i =
// 32q + t, from the hit and valid masks of window chunks q-1 (h0, v0) and q
// (h1, v1): the windows that overlap base i are i-k+1 .. i, bits s0 .. s0+k-1
// of (h1:h0) with s0 = 33 + t - k; windows before 0 or past n have no bit
// set.  tl: t(x) of x = lane (x < 32), t32: t(32).
__device__ __forceinline__ uint32_t covered_bits(uint32_t h0, uint32_t h1,
                                                 uint32_t v0, uint32_t v1,
                                                 int s0, uint32_t kmask,
                                                 int tl, int t32) {
  const int s = __popc(bits_at(h0, h1, s0) & kmask);
  const int x = __popc(bits_at(v0, v1, s0) & kmask);
  const int tx = __shfl_sync(kFullWarp, tl, x & 31);
  return __ballot_sync(kFullWarp, s >= (x == 32 ? t32 : tx));
}

// The hit byte and the word of window c0 + lane of one read, both loads in
// flight at once (0 past n: no hit, not valid).
struct RuleIn {
  uint32_t word;
  uint8_t hit;
};

__device__ __forceinline__ RuleIn rule_load(const uint8_t* hits,
                                            const uint32_t* word, int c0,
                                            int n, int t) {
  const int j = c0 + t;
  RuleIn x{0u, 0};
  if (j < n) {
    x.word = stream_load(word + j);
    x.hit = stream_load(hits + j);
  }
  return x;
}

// The rule-only entry point: trusted bytes of every window from the hits of
// a word test made elsewhere.  A warp per read (grid-stride over reads).
__global__ void trust_rule_kernel(const uint8_t* __restrict__ hits,
                                  const uint32_t* __restrict__ word,
                                  const int32_t* __restrict__ thresholds,
                                  uint8_t* __restrict__ out,
                                  int64_t num_reads, int n, int k,
                                  int trust_threshold) {
  const int t = threadIdx.x & 31;
  const int tl = t <= k ? thresholds[t] : 0;
  const int t32 = k >= 32 ? thresholds[32] : 0;
  const uint32_t kmask = k >= 32 ? kFullWarp : (1u << k) - 1u;
  const int s0 = 33 + t - k;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                   (threadIdx.x >> 5);
       r < num_reads; r += warps) {
    const uint8_t* rh = hits + r * n;
    const uint32_t* rw = word + r * n;
    uint8_t* o = out + r * n;
    // the windows of chunk q (hq, vq) and their bases' covered bits (cq);
    // chunk q+1's loads in flight
    RuleIn x = rule_load(rh, rw, 0, n, t);
    RuleIn ahead = rule_load(rh, rw, 32, n, t);
    uint32_t vq = __ballot_sync(kFullWarp, x.word != 0u);
    uint32_t hq = __ballot_sync(kFullWarp, x.word != 0u && x.hit != 0);
    uint32_t cq = covered_bits(0u, hq, 0u, vq, s0, kmask, tl, t32);
    for (int c0 = 0; c0 < n; c0 += 32) {
      // chunk q+1, and the covered bits of its bases; chunk q+2 in flight
      x = ahead;
      ahead = rule_load(rh, rw, c0 + 64, n, t);
      const uint32_t vn = __ballot_sync(kFullWarp, x.word != 0u);
      const uint32_t hn = __ballot_sync(kFullWarp, x.word != 0u && x.hit != 0);
      const uint32_t cn = covered_bits(hq, hn, vq, vn, s0, kmask, tl, t32);
      // trusted: valid, and at least trust_threshold of its k bases covered
      const int j = c0 + t;
      if (j < n)
        stream_store(o + j, (uint8_t)(((vq >> t) & 1u) != 0u &&
                                      __popc(bits_at(cq, cn, t) & kmask) >=
                                          trust_threshold));
      hq = hn;
      vq = vn;
      cq = cn;
    }
  }
}

// ---------------------------------------------------------------------------
// K3  bloom_or_words
//
// Replaces: the XLA sort build kbbq_tpu/ops/bloom.py::bloom_rows_dense (sort,
//   segmented OR-scan, compaction sort, unique scatter) and the byte-staging
//   scatter + MXU pack (bloom_insert_rows, bloom_rows), which exist only
//   because TPU scatters serialise; the fused entry point also replaces the
//   hash pass in front of it (kbbq_tpu/pipeline/resident.py::
//   _pass1_kmers_slice: k-mer packing, canonical form, both hashes, probe
//   word, sampling decision).
// Bound by: bytes.  Cached entry point: 9 B streamed per window (h1, word,
//   keep) plus one access to a random 4-byte filter word per KEPT window;
//   the 32 MiB filter is L2-resident, where atomics resolve.  Fused entry
//   point: 1 B per base in, 9 B per window out, the same filter traffic
//   (hash-only mode: 1 B per base in, 8 B per window out, no filter) on
//   paper; in practice integer instruction issue (below).
// Design: OR commutes and is idempotent, so the words equal the sort build's
//   word for word whatever the thread order.  Sequencing data repeats (every
//   genomic k-mer arrives once per unit of coverage), so most inserts find
//   their bits already set: there or_word() reads the word first and skips
//   the atomic.
//   Cached entry point (pass 2, filter B from the trusted windows of the hash
//   cache): one thread per window, grid-stride.
//   Fused entry point (pass 1): no [rows, n] intermediate is ever written:
//   the kernel reads 1 B per base, writes the hash cache that passes 2 and 3
//   reuse, and ORs the sampled windows into filter A on the way.  Its bytes
//   are few (0.58 ms of them for config 2's 182 M windows), its instructions
//   many: the spec fixes four fmix32, seven probe bits and, when sampling, a
//   fifth fmix32 per window, so it is bound by integer issue (85-110 ALU
//   instructions a window by mode, 64 ALU lanes an SM), and the design is
//   about spending little on top of the hash:
//   - A warp takes a read (grid-stride over reads), thread t the windows t,
//     t+32, ..; nothing is staged per tile and nothing waits at a barrier.
//   - Each 32 bases are one coalesced byte load, a base a lane, loaded a step
//     ahead.  Two shuffles and two ballots pack them 2 bits a base, first
//     base highest (pack_chunk: lane p votes bit p&1 of the base it reads
//     from lane 15 - p/2, then 31 - p/2), and a third ballot gives their N
//     mask; the words stay in registers, every lane holding the same.
//     walk_start packs the walk's working copy with the same helper.  An N
//     is packed as base 0, so h1 of an invalid window is the plain
//     version's.
//   - A window's forward k-mer is two funnel shifts of the words of its
//     chunk and the next (window_top), its reverse complement a bit reversal
//     (revcomp_kmer, which reads an N as 3 as the complement strand does),
//     its validity no N bit among its k bases (one funnel shift).  No base
//     is rolled and no window's work is done twice.
//   - The probe word is two funnel shifts a bit (probe_word).  With
//     num_hashes = 7, the default, its loop is unrolled whole (kernel
//     instance kHashes = 7); other counts take the loop (kHashes = 0).
//     One loop for every count, unrolled by 7, issued 36-41 more
//     integer-ALU instructions a window at the default and ran 7-18 %
//     slower by mode (PERF.md).
//   - Lane t stores window t of each 32, coalesced streaming stores straight
//     from registers.  Rows of n windows start anywhere in a line, so a
//     warp's 128-byte store splits across two lines; in the build that costs
//     the inserts their L2 hits (the split lines' partial sectors and the
//     filter's random sectors meet in L2: 2.42 ms against 1.47 without the
//     inserts, PERF.md), so there each step's planes leave as the aligned
//     group it completed (realign, a shuffle a plane and a ballot for keep),
//     and each insert marks its line evict-last (or_word_last).  In the
//     other modes the shuffles cost more than the split lines.
//   Keep mode of the fused entry point (kbbq_hash_keep: pass 1 of the
//   hash-space-sharded layout, where no rank holds filter A whole and the
//   kept windows travel to their owners before any insert; it replaces the
//   hash and sampling inside kbbq_tpu/parallel/sharded_bloom.py::step_sample):
//   the same body and sampling hash, writing h1, word and keep, and no
//   atomic.  A one-word stand-in filter would have served too, at the cost of
//   every kept window's atomic landing on that one word.
//   Hash-only mode of the fused entry point (kbbq_hash_only: passes 2 and 3
//   of the windowed engine, where no window's hash cache outlives its pass;
//   it replaces the hash pass inside kbbq_tpu/pipeline/stream_resident.py::
//   _p2_window and kbbq_tpu/pipeline/recalibrate.py::_step_trusted): the same
//   body, writing h1 and word only, 1 B per base in and 8 B per window out.
//   It reads no ordinal and touches no filter: re-running the build against
//   filter A would set no new bit (the keep bits depend only on the global
//   ordinals) but would still cost every sampled window its atomic.
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
    if (keep[i]) or_word(packed, block_mask, h1[i], word[i]);
}

// The three modes of the fused entry point: the hash cache and the sampled
// inserts (pass 1), the hash cache and the keep plane with no filter (pass 1
// of the hash-space-sharded layout, whose inserts travel to the filter's
// owners first), and (h1, word) alone (passes 2 and 3 of the windowed engine).
constexpr int kModeHashOnly = 0, kModeKeep = 1, kModeBuild = 2;

// Lanes to aligned stores (build mode).  A warp that works on windows c0 + t
// of a read whose first window is element R of a flat plane (off = R mod 32)
// stores them as the aligned group of 32 elements each step completes:
// element t of the group is window c0 - off + t, held by lane
// (t - off) mod 32 of this step (t >= off) or of the step before.  Each store
// then fills whole lines (sectors, for bytes) where the plane is 128-byte
// aligned, as torch's allocations are, and no line is written by two steps.
// A lane sends its value of the step its receiver takes, so one shuffle
// moves a plane.
template <class T>
__device__ __forceinline__ T realign(T cur, T prev, int t, int off) {
  return __shfl_sync(kFullWarp, t + off < 32 ? cur : prev, (t - off) & 31);
}

// realign() for a plane of one bit a window, from the ballots of this step
// (cur) and the step before (prev): no shuffle
__device__ __forceinline__ int realign_bit(uint32_t cur, uint32_t prev, int t,
                                           int off) {
  return (int)(bits_at(prev, cur, 32 + t - off) & 1u);
}

// One 32-base chunk of a read as its warp packs it: (hi:lo) the bases 2 bits
// each, first base in the highest bits, an N as base 0; nmask bit t: base t
// is an N.  Every lane holds the same words.
struct Chunk {
  uint32_t hi, lo, nmask;
};

// code: this lane's base t of the chunk (4 where the read has ended)
__device__ __forceinline__ Chunk pack_chunk(int code, int t) {
  const bool is_n = code >= 4;
  const int c = is_n ? 0 : code;
  // lane p votes bit p&1 of base 15 - p/2 (hi) and of base 31 - p/2 (lo)
  const int bit = 1 << (t & 1);
  const int a = __shfl_sync(kFullWarp, c, 15 - (t >> 1));
  const int b = __shfl_sync(kFullWarp, c, 31 - (t >> 1));
  return {__ballot_sync(kFullWarp, (a & bit) != 0),
          __ballot_sync(kFullWarp, (b & bit) != 0),
          __ballot_sync(kFullWarp, is_n)};
}

// The 32 bases that start at base t of chunk x (y the next chunk), 2 bits
// each, first base in the highest bits: a window's forward k-mer is its top
// 2k bits.
__device__ __forceinline__ uint64_t window_top(const Chunk& x, const Chunk& y,
                                               int t) {
  const bool first = t < 16;  // starts in x's high word
  const uint32_t a = first ? x.hi : x.lo;
  const uint32_t b = first ? x.lo : y.hi;
  const uint32_t c = first ? y.hi : y.lo;
  const uint32_t s = 2u * (uint32_t)(t & 15);
  return ((uint64_t)__funnelshift_l(b, a, s) << 32) | __funnelshift_l(c, b, s);
}

// codes int8 [num_reads, L]; h1, word [num_reads, n] and keep (not in
// hash-only mode), every element written; packed: filter A (build mode
// only).  kHashes: the probe count when fixed at compile time, else 0.
template <int kMode, int kHashes>
__global__ void hash_build_kernel(const int8_t* __restrict__ codes,
                                  uint32_t* __restrict__ packed,
                                  uint32_t block_mask,
                                  uint32_t* __restrict__ h1,
                                  uint32_t* __restrict__ word,
                                  uint8_t* __restrict__ keep,
                                  int64_t num_reads, int64_t first_id, int L,
                                  int k, int num_hashes, uint32_t threshold) {
  // the build's planes leave in aligned groups (realign, K3 note); the
  // other modes store lane by lane
  constexpr bool kAligned = kMode == kModeBuild;
  const int n = L - k + 1;
  const int t = threadIdx.x & 31;
  const int down = 64 - 2 * k;  // window_top's k-mer to the low 2k bits
  const uint32_t kmask = k >= 32 ? kFullWarp : (1u << k) - 1u;
  const uint64_t policy = filter_policy();
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) +
                   (threadIdx.x >> 5);
       r < num_reads; r += warps) {
    const int8_t* c = codes + r * L;
    uint32_t* oh1 = h1 + r * n;
    uint32_t* ow = word + r * n;
    uint8_t* ok = kMode != kModeHashOnly ? keep + r * n : nullptr;
    // the sampling hash's per-read half, of the ordinal's low 32 bits
    const uint32_t sr =
        fmix32((uint32_t)(uint64_t)(first_id + r) ^ kSeedSample);
    Chunk x = pack_chunk(t < L ? stream_load(c + t) : 4, t);
    int ahead = 32 + t < L ? stream_load(c + 32 + t) : 4;  // the next chunk
    const int off = (int)((r * n) & 31);
    uint32_t p1 = 0u, pw = 0u, pk = 0u;  // the step before's h1, word, keep
    for (int c0 = 0; c0 < n; c0 += 32) {
      const Chunk y = pack_chunk(ahead, t);
      ahead = c0 + 64 + t < L ? stream_load(c + c0 + 64 + t) : 4;
      const int j = c0 + t;
      uint32_t hh = 0u, w = 0u;
      bool kp = false;
      if (j < n) {
        const uint64_t f = window_top(x, y, t) >> down;
        const uint64_t rc = revcomp_kmer(f, k);
        // canonical: the smaller in (hi, lo) unsigned order
        const uint64_t cn = f <= rc ? f : rc;
        const bool valid =
            (__funnelshift_r(x.nmask, y.nmask, t) & kmask) == 0u;
        kmer_hash<kHashes>((uint32_t)(cn >> 32), (uint32_t)cn, num_hashes, hh,
                           w);
        if (!valid) w = 0u;
        if (kMode != kModeHashOnly)
          kp = valid && fmix32(sr ^ ((uint32_t)j * kGolden)) <= threshold;
        if (kMode == kModeBuild && kp)
          or_word_last(packed + (hh & block_mask), w, policy);
      }
      if (!kAligned) {
        if (j < n) {
          stream_store(oh1 + j, hh);
          stream_store(ow + j, w);
          if (kMode != kModeHashOnly) stream_store(ok + j, (uint8_t)kp);
        }
      } else {
        const uint32_t a1 = realign(hh, p1, t, off);
        const uint32_t aw = realign(w, pw, t, off);
        const uint32_t kb = __ballot_sync(kFullWarp, kp);
        const int wa = c0 - off + t;
        if (wa >= 0 && wa < n) {
          stream_store(oh1 + wa, a1);
          stream_store(ow + wa, aw);
          stream_store(ok + wa, (uint8_t)realign_bit(kb, pk, t, off));
        }
        p1 = hh;
        pw = w;
        pk = kb;
      }
      x = y;
    }
    if (kAligned) {  // the last step's windows past its aligned group
      const uint32_t a1 = realign(0u, p1, t, off);
      const uint32_t aw = realign(0u, pw, t, off);
      const int wa = ((n + 31) & ~31) - off + t;
      if (wa < n) {
        stream_store(oh1 + wa, a1);
        stream_store(ow + wa, aw);
        stream_store(ok + wa, (uint8_t)realign_bit(0u, pk, t, off));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2  walk_errors
//
// Replaces: kbbq_tpu/ops/pallas_walk.py::_round_kernel (reached through
//   walk_rounds_pallas) AND the XLA while_loop around it
//   (kbbq_tpu/ops/inference.py::_walk_rounds_pl / _walk_loop): the whole
//   directional correction walk of every read, in ONE launch.  What it
//   computes is kbbq_tpu/oracle/lighter.py::infer_read_errors.
// Bound by: bytes on paper (codes and initial trust in, error mask out, a few
//   filter words per break).  In practice the launch ends when its slowest
//   lane ends, and a lane is a chain of breaks, each needing ~100 integer
//   instructions of hashing per window probed and a random 4-byte read of
//   the L2-resident filter (several hundred cycles).  The design below is
//   about shortening that chain and about spending no instruction on lanes
//   that have no break.
// Design: a block owns a tile of reads.
//   1. All threads copy the tile's codes and initial trust into shared memory
//      with wide loads.
//   2. A thread per read packs the read into 2-bit codes (the WORKING copy
//      of the read: nothing is cloned in device memory) and zeroes the code
//      bytes behind it, which from then on hold the read's error marks (a
//      third less shared memory than marks of their own).  It finds the anchor
//      (longest run of initially trusted windows, ties leftmost) and
//      rewrites each trust byte as a flag: 1 = trusted, 2 = break (valid
//      window, not trusted), 0 = window with an N.  A (read, direction) with
//      a break beyond the anchor is appended to the block's work list with
//      its first break; the others are done: their marks stay zero.
//   3. WARPS take lanes from the work list.  A lane follows the oracle's
//      sequential recurrence, but each of its steps is done by 32 threads at
//      once.  (A thread per lane, as in the first version of this kernel,
//      spends its time in divergence: a warp pays every lane's ~3,000
//      instructions of hashing per correction one lane after the other, and
//      the launch ends with the read that has the most corrections.)  The
//      two directions read disjoint windows and commit disjoint bases
//      (right: windows > anchor end b, commits at bases >= b+k; left:
//      windows < anchor start a, which end at base a+k-2, commits at bases
//      <= a-1), so they are independent lanes on one working copy; a commit
//      is an atomic flip of the base's own two bits, because both lanes'
//      commits may share a 64-bit word of the packed copy.  The left
//      walk is the right walk on the reverse complement; canonical k-mers
//      are strand-invariant, so both read the ORIGINAL strand's k-mers and
//      differ only in index arithmetic (the left walk's entering base is
//      the first base of the window).  A window's forward k-mer is two
//      shifts of the packed read and its reverse complement a bit reversal,
//      so nothing is rolled base by base.  Windows not yet touched by a
//      commit take their trust from the flags, 32 at a time, so the lane
//      jumps from break to break; windows that overlap a committed base are
//      probed on the working sequence, 32 at a time.  At a break, thread t
//      probes window j+t for all three candidates, three independent loads,
//      and three ballots give the extensions: a correction costs one round
//      trip to L2 instead of W + 3 in a row.
//   4. All threads store the tile's marks with wide stores: every byte of
//      `err` is written by the kernel.
//   None of the TPU version's barrel rolls, pre-rolled planes, fourth
//   candidate, re-verify rounds, chunking or difficulty sort is needed.
// ---------------------------------------------------------------------------

constexpr uint8_t kFlagTrusted = 1, kFlagBreak = 2;

// 64-bit words of a packed read: 32 bases a word, first base in the highest
// bits, and one word more so that a window may always read two
__host__ __device__ inline int packed_words(int L) { return (L + 31) / 32 + 1; }

// forward k-mer of the window that starts at base s of a packed read
__device__ __forceinline__ uint64_t window_kmer(const uint64_t* pk, int s,
                                                int k) {
  const int q = s >> 5, r = s & 31;
  const uint64_t v =
      r ? (pk[q] << (2 * r)) | (pk[q + 1] >> (64 - 2 * r)) : pk[q];
  return v >> (64 - 2 * k);
}

// Step 2 for one read: w its codes [L] (zeroed here: they become the read's
// error marks), pk its packed copy (written here), fl its trust bytes [n]
// (rewritten as flags).  Returns through right/left the first break of each
// walk on the walk's own strand, or -1 when that walk has nothing to do.
__device__ __forceinline__ void walk_scan_read(int8_t* w, uint64_t* pk,
                                               uint8_t* fl, int L, int n,
                                               int k, int& right, int& left) {
  int best_len = 0, best_s = -1, cur = 0, run = 0;
  uint64_t acc = 0;
  for (int i = 0; i < L; ++i) {
    const int c = w[i];
    w[i] = 0;
    run = c >= 4 ? 0 : run + 1;
    acc = (acc << 2) | (uint64_t)(c >= 4 ? 0 : c);
    if ((i & 31) == 31) pk[i >> 5] = acc;
    const int j = i - k + 1;
    if (j < 0) continue;
    const bool t = fl[j] != 0;
    if (t) {
      ++cur;
      if (cur > best_len) { best_len = cur; best_s = j - cur + 1; }
    } else {
      cur = 0;
    }
    fl[j] = run >= k ? (t ? kFlagTrusted : kFlagBreak) : 0;
  }
  if (L & 31) pk[L >> 5] = acc << (2 * (32 - (L & 31)));
  pk[(L + 31) >> 5] = 0;
  right = left = -1;
  // a read with no trusted window has no anchor and is skipped
  if (best_len == 0) return;
  const int a = best_s, b = best_s + best_len - 1;
  for (int j = b + 1; j < n; ++j)
    if (fl[j] == kFlagBreak) { right = j; break; }
  for (int j = a - 1; j >= 0; --j)
    if (fl[j] == kFlagBreak) { left = n - 1 - j; break; }
}

// One lane's view of its read.  Windows are counted on the walk's own
// strand (j = 0 is where the walk's strand begins); ow(j) is the same window
// on the original strand, where all data lives.
struct WalkCtx {
  uint64_t* pk;         // packed working copy of the read
  uint8_t* e;           // error marks of the read, [L]
  const uint8_t* fl;    // flags of the read's windows, [n]
  const uint32_t* packed;
  uint32_t block_mask;
  int n, k, W, num_hashes, dir;

  __device__ __forceinline__ int ow(int j) const {
    return dir == 0 ? j : n - 1 - j;
  }
  __device__ __forceinline__ uint8_t flag(int j) const { return fl[ow(j)]; }
  // The base newly entering a window of the walk, as a position on the
  // original strand, given the window there: its last base (right walk) or
  // its first (left walk).
  __device__ __forceinline__ int entering(int xo) const {
    return dir == 0 ? xo + k - 1 : xo;
  }
  __device__ __forceinline__ int base(int po) const {
    return (int)((pk[po >> 5] >> (2 * (31 - (po & 31)))) & 3);
  }
  // filter word and probe word of a forward k-mer
  __device__ __forceinline__ void hash(uint64_t f, uint32_t& idx,
                                       uint32_t& word) const {
    const uint64_t rc = revcomp_kmer(f, k);
    const uint64_t c = f <= rc ? f : rc;  // canonical: (hi, lo) unsigned order
    kmer_hash((uint32_t)(c >> 32), (uint32_t)c, num_hashes, idx, word);
    idx &= block_mask;
  }
  __device__ __forceinline__ bool probe(uint64_t f) const {
    uint32_t idx, word;
    hash(f, idx, word);
    return (__ldg(packed + idx) & word) == word;
  }
  // the k-mer with its base at window offset d replaced by code c
  __device__ __forceinline__ uint64_t patch(uint64_t f, int d, int c) const {
    const int s = 2 * (k - 1 - d);
    return (f & ~(3ull << s)) | ((uint64_t)c << s);
  }
};

// Step 3 for one lane, by ALL 32 threads of a warp (t: the thread's index in
// the warp): the walk of one direction of one read from its first break `j`
// (on the walk's own strand) to the read's end.  Control flow is uniform
// across the warp: every thread holds the same j and dirty.
__device__ __forceinline__ void walk_lane(const WalkCtx& cx, int j, int t) {
  const int n = cx.n, k = cx.k;
  int dirty = -1;  // windows <= dirty overlap a committed base
  bool failing = false;  // the last break found no candidate
  while (j < n) {
    // the next 32 windows, one a thread: which of them break?  Beyond the
    // last commit the flags say; before it a valid window's trust is
    // whatever the filter says of the working copy
    const int x = j + t;
    bool brk = false;
    if (x < n) {
      const uint8_t fx = cx.flag(x);
      if (x > dirty) brk = fx == kFlagBreak;
      else if (fx != 0) brk = !cx.probe(window_kmer(cx.pk, cx.ow(x), k));
    }
    const uint32_t breaks = __ballot_sync(kFullWarp, brk);
    if (breaks == 0u) { j += 32; continue; }
    if (!failing) {
      j += __ffs((int)breaks) - 1;
    } else {
      // the last break found no candidate.  Such breaks come in runs (a
      // stretch of correct but untrusted windows) and change nothing but
      // their mark, so the run is settled 32 windows at a time: thread t
      // tries the three candidates of window j+t on that window alone; the
      // breaks before the first that has a candidate fail like the last.
      bool any = false;
      int px = 0;
      if (brk) {
        const int xw = cx.ow(x);
        px = cx.entering(xw);
        const uint64_t fw = window_kmer(cx.pk, xw, k);
        const int ox = cx.base(px);
        uint32_t got[3], need[3];
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          uint32_t idx;
          cx.hash(cx.patch(fw, px - xw, u + (u >= ox ? 1 : 0)), idx, need[u]);
          got[u] = __ldg(cx.packed + idx);
        }
#pragma unroll
        for (int u = 0; u < 3; ++u) any |= (got[u] & need[u]) == need[u];
      }
      const uint32_t fixable = __ballot_sync(kFullWarp, any);
      const int first = fixable ? __ffs((int)fixable) - 1 : 32;
      if (brk && t < first) cx.e[px] = 1;
      if (fixable == 0u) { j += 32; continue; }
      j += first;
    }

    // window j breaks: the base newly entering it is wrong
    const int xo = cx.ow(j);
    const int po = cx.entering(xo);
    const int sh = 2 * (31 - (po & 31));
    const int orig = cx.base(po);
    // a candidate's extension = the leading trusted windows j, j+1, .. of the
    // working sequence with base po replaced, at most W and not past the
    // read's end; a window with an N is never trusted.  Every one of those
    // windows is known up front, so thread t probes window j+t for all three
    // candidates at once: one round trip to L2 settles the break.
    const int lim = cx.W < n - j ? cx.W : n - j;
    const bool live = t < lim && cx.flag(j + t) != 0;
    const int xt = cx.ow(live ? j + t : j);
    const uint64_t ft = window_kmer(cx.pk, xt, k);
    uint32_t got[3], need[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      got[u] = 0u;
      need[u] = 1u;  // fails unless probed
      if (live) {
        uint32_t idx;
        cx.hash(cx.patch(ft, po - xt, u + (u >= orig ? 1 : 0)), idx, need[u]);
        got[u] = __ldg(cx.packed + idx);
      }
    }
    int best_c = -1, best_ext = 0;
#pragma unroll
    for (int u = 0; u < 3; ++u) {  // ascending ORIGINAL code
      const uint32_t ok =
          __ballot_sync(kFullWarp, (got[u] & need[u]) == need[u]);
      const int ext = ok == kFullWarp ? 32 : __ffs((int)~ok) - 1;
      if (ext > best_ext) {  // strict: ties keep the first
        best_ext = ext;
        best_c = u + (u >= orig ? 1 : 0);
      }
    }
    // The other direction of this read runs in another warp on the same
    // packed copy.  Its commits lie at least k+1 bases away, which for
    // k < 32 may be in this very word: so the commit flips this base's two
    // bits atomically and leaves the word's other bits to whoever owns them.
    if (t == 0) {
      cx.e[po] = 1;
      if (best_ext >= 1)
        atomicXor(reinterpret_cast<unsigned long long*>(cx.pk + (po >> 5)),
                  (unsigned long long)(orig ^ best_c) << sh);
    }
    __syncwarp();
    failing = best_ext < 1;
    if (failing) {
      ++j;
    } else {
      dirty = j + k - 1;
      j += best_ext;
    }
  }
}

// shared memory of one block of walk_errors_kernel, in bytes
__host__ __device__ inline int walk_tile_bytes(int L, int n, int rows) {
  return round16(rows * L + 16) + round16(rows * n + 16) +
         round16(rows * packed_words(L) * 8) + round16((4 * rows + 1) * 4);
}

__global__ void walk_errors_kernel(const int8_t* __restrict__ codes,
                                   const uint8_t* __restrict__ trusted0,
                                   const uint32_t* __restrict__ packed,
                                   uint32_t block_mask,
                                   uint8_t* __restrict__ err,
                                   int64_t num_reads, int L, int k, int W,
                                   int num_hashes, int tile_rows) {
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int n = L - k + 1;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int64_t r0 = (int64_t)blockIdx.x * tile_rows;
  const int64_t rest = num_reads - r0;
  const int R = rest < tile_rows ? (int)rest : tile_rows;

  const uint8_t* gcodes = reinterpret_cast<const uint8_t*>(codes) + r0 * L;
  const uint8_t* gtrust = trusted0 + r0 * n;
  uint8_t* gerr = err + r0 * L;
  const int cbytes = round16(tile_rows * L + 16);
  const int fbytes = round16(tile_rows * n + 16);
  const int nw = packed_words(L);
  // codes first, error marks after step 2: placed for the marks' wide
  // store; the codes' load is wide too when codes and err are congruent
  // modulo 16 (always, for whole tensors from the allocator)
  uint8_t* se = smem + ((uintptr_t)gerr & 15u);
  uint8_t* sfl = smem + cbytes + ((uintptr_t)gtrust & 15u);
  uint64_t* spk = reinterpret_cast<uint64_t*>(smem + cbytes + fbytes);
  int* list = reinterpret_cast<int*>(smem + cbytes + fbytes +
                                     round16(tile_rows * nw * 8));
  int* start = list + 2 * tile_rows;
  int* count = start + 2 * tile_rows;

  // 1. stage the tile
  tile_copy(se, gcodes, R * L, tid, nthreads);
  tile_copy(sfl, gtrust, R * n, tid, nthreads);
  if (tid == 0) *count = 0;
  __syncthreads();

  // 2. packed copies, anchors, flags, work list
  for (int r = tid; r < R; r += nthreads) {
    int first[2];
    walk_scan_read(reinterpret_cast<int8_t*>(se) + r * L, spk + r * nw,
                   sfl + r * n, L, n, k, first[0], first[1]);
    for (int dir = 0; dir < 2; ++dir) {
      if (first[dir] < 0) continue;
      const int at = atomicAdd(count, 1);
      list[at] = 2 * r + dir;
      start[at] = first[dir];
    }
  }
  __syncthreads();

  // 3. the lanes that have a break, a warp each
  const int lanes = *count;
  for (int i = tid >> 5; i < lanes; i += nthreads >> 5) {
    const int r = list[i] >> 1;
    WalkCtx cx;
    cx.pk = spk + r * nw;
    cx.e = se + r * L;
    cx.fl = sfl + r * n;
    cx.packed = packed;
    cx.block_mask = block_mask;
    cx.n = n; cx.k = k; cx.W = W; cx.num_hashes = num_hashes;
    cx.dir = list[i] & 1;
    walk_lane(cx, start[i], tid & 31);
  }
  __syncthreads();

  // 4. the tile's marks
  tile_copy(gerr, se, R * L, tid, nthreads);
}

// ---------------------------------------------------------------------------
// K4  walk_round
//
// Replaces: kbbq_tpu/ops/pallas_walk.py::_round_kernel where its filter is
//   hash-space sharded (kbbq_tpu/parallel/sharded_bloom.py::step_covariates
//   plugs the collective query _gather_query into
//   kbbq_tpu/ops/inference.py::infer_errors_core): the correction walk
//   against a filter B that no rank holds whole.  What it computes is
//   kbbq_tpu/oracle/lighter.py::infer_read_errors, as walk_errors does.
// Bound by: the exchange first.  Every candidate query leaves the rank, so
//   the walk is cut into ROUNDS, each settling one break per active (read,
//   direction) lane, and a round into lane GROUPS of at most
//   EXCHANGE_CHUNK / (3k) lanes (parallel/sharded_bloom.py).  A group costs
//   one agreement on a count matrix (the host's one read), the pairs'
//   all_to_all and the answers'; the caller walks a rank's rows in blocks of
//   up to 2^21 reads, so the round count is that of the block's slowest
//   lane.  On the card, bytes: each lane's 3k pairs of 8 B out and their
//   answers back, its packed read, flags and cursor.
// Design: the walk's state lives in device memory between rounds (WalkState
//   in kernels/__init__.py):
//     pk    [N, packed_words(L)]  packed working copy of each read (2 bits a
//                                 base, first base in the highest bits)
//     fl    [N, n]   effective trust of each window: 1 trusted, 2 break
//                    (valid, not trusted), 0 a window with an N
//     err   [N, L]   error marks
//     cur   [N, 2]   each lane's break, counted on the walk's own strand
//                    (right: j; left: n-1-j), -1 when the lane is done;
//                    bit kFailing set while the lane is failing (below)
//     lists [2, 2N]  lane ids (2 * read + direction) of the current round
//                    and of the next, and ctl (kCtl* below): which list is
//                    current, the next group's start, the two counts, the
//                    group, the rounds begun and the lanes of each round
//   The lane lists are the kernels' own: nothing on the host or in torch
//   looks for the active lanes.
//   walk_start, a warp per read: the codes and the initial trust are read
//     32 at a time, coalesced, four such loads in flight; a word of the
//     packed copy is the fused hash kernel's pack_chunk (two shuffles and
//     two ballots, K3; lane 0 spreading two ballots' bits into place took a
//     third longer, PERF.md), whose N mask gives a window's validity as its
//     distance from the last N; the anchor (the longest initially trusted
//     run, ties leftmost) is a running maximum over 32 windows at a time,
//     the run ending at each window from a ballot of the untrusted ones;
//     each direction's first break is the first set bit of a ballot over 32
//     flags.  A lane with a break joins the next list.
//   walk_propose, one entry point of three launches:
//     take (one thread): when the current list is used up the next one
//       becomes current (a round begins; its lane count is kept); the group
//       is the next `group` lanes of the current list; the last column of
//       the count row gets every lane the rank still walks.
//     propose, a warp per lane of the group, thread t < k on window j+t: the
//       three 64-bit words of the packed read that the lane's windows touch
//       are read once, by three threads, and passed round by shuffles; each
//       thread patches its window with the 3 candidate codes of the base
//       entering the break window (ascending ORIGINAL code) and hashes each
//       to the cached (h1, word) pair; word 0 where the window lies past the
//       read's end or holds an N (never a hit).  All k windows of all 3
//       candidates at once: the extension needs the first W and the commit
//       the chosen one's k, so one exchange serves both.  A FAILING lane
//       (its last break found no candidate; a bit of its cursor) asks
//       instead each break among its next k windows with that window's
//       own entering base replaced: such breaks come in runs (a stretch of
//       correct but untrusted windows, as walk_errors' note says) and
//       change nothing but their mark, so a run is settled k windows a
//       round, not one: the long tail of rounds was such lanes.  The pairs
//       are counted per owner, (h1 >> shift) & (owners-1), in shared
//       memory (a warp's equal owners added once, by __match_any_sync), and
//       each block adds its counts to the row.
//     route, a thread per pair: the pairs are written grouped by owner (the
//       row gives each owner's offset, a cursor per owner each block's
//       range in it), and each pair's place in that buffer goes to `slot`
//       (-1: not asked).
//   Between the launches the caller agrees on the D rows, sends the pairs
//   to their owners, has them tested and takes the answers back, in the
//   pairs' order.
//   walk_resolve, a warp per lane of the group: each candidate's answers
//     (found through `slot`) over the first min(W, n-j) windows are one
//     ballot (k <= 32), its extension the run of leading ones; the largest
//     wins, ties to the smallest code (the oracle's strict '>'); the base is
//     marked; a winner is committed with an atomic XOR of its two bits (the
//     other direction of the read may commit into the same 64-bit word in
//     the same launch, k+1 bases away) and k threads set its windows'
//     effective trust from its answers; the cursor moves past the extension
//     (one window for a break with no candidate, which makes the lane
//     failing) to the next break, the first set bit of a ballot over 32
//     flags at a time.  A failing lane's breaks before the first that has a
//     candidate (one ballot) are marked; that break is its next, no longer
//     failing, or the search goes on past the k windows.  A lane that still
//     walks joins the next list.
//   The lists grow by one atomicAdd per block (its warps' lanes counted in
//   shared memory first), so the lane order of a round, and with it which
//   lanes share a group, changes from run to run.  The answers come back by
//   position and every commit flips the lane's own bits, so no mark can.
//   The right and left walks touch disjoint windows and bases (see K2): one
//   round serves both directions of a read, in one group or in two.
// ---------------------------------------------------------------------------

constexpr int kRoundThreads = 128;  // threads of a walk_round block
constexpr int kRoundWarps = kRoundThreads / 32;
constexpr int kStartBatch = 4;      // 32-base chunks walk_start loads at once
// fields of ctl; the lane count of round i is at kCtlLanes + i
constexpr int kCtlWhich = 0, kCtlPos = 1, kCtlCount = 2, kCtlGroupStart = 4,
              kCtlGroupSize = 5, kCtlRounds = 6, kCtlLanes = 8;

// index of the highest set bit of x != 0
__device__ __forceinline__ int top_bit(uint32_t x) {
  return 31 - __clz((int)x);
}

// in cur: the lane's last break found no candidate
constexpr int32_t kFailing = 1 << 30;

// one lane of a round's group: its read, direction, break window and state
struct RoundLane {
  int64_t r;
  int dir, j, jo, po;
  bool failing;
  __device__ __forceinline__ RoundLane(int id, const int32_t* cur, int n,
                                       int k) {
    r = id >> 1;
    dir = id & 1;
    failing = (cur[id] & kFailing) != 0;
    j = cur[id] & (kFailing - 1);
    jo = ow(j, n);
    po = entering(jo, k);  // the base entering the break window
  }
  __device__ __forceinline__ int ow(int x, int n) const {
    return dir == 0 ? x : n - 1 - x;
  }
  // the base newly entering window xo of the original strand
  __device__ __forceinline__ int entering(int xo, int k) const {
    return dir == 0 ? xo + k - 1 : xo;
  }
};

// The lanes a block's warps put in ids (count of them) join list `to`:
// one atomicAdd on its count per block.  Every thread of the block calls it.
__device__ __forceinline__ void join_list(int32_t* lists, int32_t* ctl,
                                          int64_t num_reads, int to,
                                          const int* ids, const int* count,
                                          int* base) {
  __syncthreads();
  if (threadIdx.x == 0 && *count)
    *base = atomicAdd(&ctl[kCtlCount + to], *count);
  __syncthreads();
  if ((int)threadIdx.x < *count)
    lists[to * 2 * num_reads + *base + threadIdx.x] = ids[threadIdx.x];
}

__global__ void walk_start_kernel(const int8_t* __restrict__ codes,
                                  const uint8_t* __restrict__ trusted0,
                                  uint64_t* __restrict__ pk,
                                  uint8_t* __restrict__ fl,
                                  uint8_t* __restrict__ err,
                                  int32_t* __restrict__ cur,
                                  int32_t* __restrict__ lists,
                                  int32_t* __restrict__ ctl, int64_t num_reads,
                                  int L, int k) {
  extern __shared__ uint4 smem4[];
  int* s_count = reinterpret_cast<int*>(smem4);
  int* s_base = s_count + 1;
  int* s_ids = s_count + 2;
  if (threadIdx.x == 0) *s_count = 0;
  __syncthreads();
  const int n = L - k + 1, nw = packed_words(L);
  const int t = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kRoundWarps + (threadIdx.x >> 5);
  if (r < num_reads) {
    const int8_t* c = codes + r * L;
    const uint8_t* tr = trusted0 + r * n;
    uint8_t* e = err + r * L;
    uint8_t* f = fl + r * n;
    uint64_t* p = pk + r * nw;
    const uint32_t upto = kFullWarp >> (31 - t);  // lanes 0..t
    int last_n = -1;   // the last base with an N before this chunk
    int run_in = 0;    // trusted windows that end the chunk before
    int best_len = 0, best_end = -1;
    for (int c00 = 0; c00 < nw * 32; c00 += 32 * kStartBatch) {
      // the batch's loads first, all in flight at once
      int codes_in[kStartBatch];
      bool trust_in[kStartBatch];
#pragma unroll
      for (int u = 0; u < kStartBatch; ++u) {
        const int i = c00 + 32 * u + t, j = i - k + 1;
        codes_in[u] = i < L ? c[i] : 4;
        trust_in[u] = j >= 0 && j < n && tr[j] != 0;
      }
#pragma unroll
      for (int u = 0; u < kStartBatch; ++u) {
        const int c0 = c00 + 32 * u;
        if (c0 >= nw * 32) break;
        const int i = c0 + t;
        const int code = codes_in[u];
        if (i < L) e[i] = 0;
        const Chunk ch = pack_chunk(code, t);
        const uint32_t nb = ch.nmask;
        if (t == 0) p[c0 >> 5] = ((uint64_t)ch.hi << 32) | ch.lo;
        const int last_n_i = nb & upto ? c0 + top_bit(nb & upto) : last_n;
        if (nb) last_n = c0 + top_bit(nb);
        // the window that ends at base i: valid with no N in its k bases
        const int j = i - k + 1;
        const bool tru = trust_in[u];
        if (j >= 0 && j < n)
          f[j] = i - last_n_i >= k ? (tru ? kFlagTrusted : kFlagBreak) : 0;
        const uint32_t untrusted = ~__ballot_sync(kFullWarp, tru) & upto;
        const int run = !tru ? 0
                        : untrusted ? t - top_bit(untrusted)
                                    : run_in + t + 1;
        const int top = (int)__reduce_max_sync(kFullWarp, (unsigned)run);
        if (top > best_len) {  // strict: the leftmost of the longest runs
          best_len = top;
          best_end =
              c0 + __ffs((int)__ballot_sync(kFullWarp, run == top)) - k;
        }
        run_in = __shfl_sync(kFullWarp, run, 31);
      }
    }
    __syncwarp();  // the flags are read back by other threads of the warp
    int first[2] = {-1, -1};
    if (best_len > 0) {  // a read with no trusted window has no anchor
      const int a = best_end - best_len + 1, b = best_end;
      for (int x0 = b + 1; x0 < n; x0 += 32) {
        const int x = x0 + t;
        const uint32_t m =
            __ballot_sync(kFullWarp, x < n && f[x] == kFlagBreak);
        if (m) { first[0] = x0 + __ffs((int)m) - 1; break; }
      }
      for (int x0 = a - 1; x0 >= 0; x0 -= 32) {
        const int x = x0 - t;
        const uint32_t m =
            __ballot_sync(kFullWarp, x >= 0 && f[x] == kFlagBreak);
        if (m) { first[1] = n - 1 - (x0 - __ffs((int)m) + 1); break; }
      }
    }
    if (t < 2) {
      cur[2 * r + t] = first[t];
      if (first[t] >= 0) s_ids[atomicAdd(s_count, 1)] = (int)(2 * r + t);
    }
  }
  join_list(lists, ctl, num_reads, ctl[kCtlWhich] ^ 1, s_ids, s_count,
            s_base);
}

__global__ void walk_take_kernel(int32_t* __restrict__ ctl,
                                 int64_t* __restrict__ row,
                                 int32_t* __restrict__ route, int owners,
                                 int group, int round_cap) {
  for (int d = threadIdx.x; d < owners; d += blockDim.x) {
    row[d] = 0;
    route[d] = 0;
  }
  if (threadIdx.x != 0) return;
  int which = ctl[kCtlWhich], pos = ctl[kCtlPos];
  if (pos >= ctl[kCtlCount + which]) {  // this round is done: the next begins
    which ^= 1;
    pos = 0;
    ctl[kCtlWhich] = which;
    ctl[kCtlCount + (which ^ 1)] = 0;
    const int lanes = ctl[kCtlCount + which];
    if (lanes > 0) {
      const int round = ctl[kCtlRounds]++;
      if (round < round_cap) ctl[kCtlLanes + round] = lanes;
    }
  }
  const int count = ctl[kCtlCount + which];
  const int size = count - pos < group ? count - pos : group;
  ctl[kCtlGroupStart] = pos;
  ctl[kCtlGroupSize] = size;
  ctl[kCtlPos] = pos + size;
  row[owners] = count - pos + ctl[kCtlCount + (which ^ 1)];
}

__global__ void walk_propose_kernel(const uint64_t* __restrict__ pk,
                                    const uint8_t* __restrict__ fl,
                                    const int32_t* __restrict__ cur,
                                    const int32_t* __restrict__ lists,
                                    const int32_t* __restrict__ ctl,
                                    int64_t num_reads,
                                    unsigned long long* __restrict__ row,
                                    uint32_t* __restrict__ out_h1,
                                    uint32_t* __restrict__ out_word,
                                    int owners, int shift, int L, int k,
                                    int num_hashes) {
  extern __shared__ uint4 smem4[];
  int* s_count = reinterpret_cast<int*>(smem4);  // pairs per owner
  for (int d = threadIdx.x; d < owners; d += blockDim.x) s_count[d] = 0;
  __syncthreads();
  const int n = L - k + 1, nw = packed_words(L);
  const int t = threadIdx.x & 31;
  const int a = blockIdx.x * kRoundWarps + (threadIdx.x >> 5);
  if (a < ctl[kCtlGroupSize]) {
    const RoundLane ln(
        lists[ctl[kCtlWhich] * 2 * num_reads + ctl[kCtlGroupStart] + a], cur,
        n, k);
    // the lane's windows and its base po lie in bases [lo, lo + 2k - 1):
    // words q0, q0+1, q0+2 of the packed read, read once
    const int lo = ln.dir == 0 ? ln.jo : (ln.jo >= k - 1 ? ln.jo - k + 1 : 0);
    const int q0 = lo >> 5;
    const uint64_t* p = pk + ln.r * nw;
    const unsigned long long mine = t < 3 && q0 + t < nw ? p[q0 + t] : 0ull;
    const int x = ln.j + t;
    const bool inside = t < k && x < n;
    const int xo = inside ? ln.ow(x, n) : ln.jo;
    const uint8_t flag = inside ? fl[ln.r * n + xo] : 0;
    // a lane asks every valid window of the next k with base po replaced;
    // a failing lane asks each break of the next k with its own entering
    // base replaced (the window alone: has that break a candidate?)
    const bool live = ln.failing ? flag == kFlagBreak : flag != 0;
    const int pb = ln.failing ? ln.entering(xo, k) : ln.po;
    const int q = (xo >> 5) - q0, s = xo & 31;
    const uint64_t w0 = __shfl_sync(kFullWarp, mine, q);
    const uint64_t w1 = __shfl_sync(kFullWarp, mine, q + 1);
    const uint64_t fwd =
        (s ? (w0 << (2 * s)) | (w1 >> (64 - 2 * s)) : w0) >> (64 - 2 * k);
    const uint64_t wp = __shfl_sync(kFullWarp, mine, (pb >> 5) - q0);
    const int orig = (int)((wp >> (2 * (31 - (pb & 31)))) & 3ull);
    const int at = 2 * (k - 1 - (pb - xo));  // pb's bits in the k-mer
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      uint32_t h1 = 0u, word = 0u;
      if (live) {
        const uint64_t code = (uint64_t)(u + (u >= orig ? 1 : 0));
        const uint64_t f = (fwd & ~(3ull << at)) | (code << at);
        const uint64_t rc = revcomp_kmer(f, k);
        const uint64_t cn = f <= rc ? f : rc;
        kmer_hash((uint32_t)(cn >> 32), (uint32_t)cn, num_hashes, h1, word);
      }
      if (t < k) {
        const int64_t o = ((int64_t)a * 3 + u) * k + t;
        out_h1[o] = h1;
        out_word[o] = word;
      }
      const int owner = word ? (int)((h1 >> shift) & (uint32_t)(owners - 1))
                             : owners;
      const uint32_t peers = __match_any_sync(kFullWarp, owner);
      if (owner < owners && t == __ffs((int)peers) - 1)
        atomicAdd(&s_count[owner], __popc(peers));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < owners; d += blockDim.x)
    if (s_count[d]) atomicAdd(&row[d], (unsigned long long)s_count[d]);
}

__global__ void walk_route_kernel(const uint32_t* __restrict__ h1,
                                  const uint32_t* __restrict__ word,
                                  const int32_t* __restrict__ ctl,
                                  const int64_t* __restrict__ row,
                                  int32_t* __restrict__ route,
                                  uint32_t* __restrict__ pairs,
                                  int32_t* __restrict__ slot, int owners,
                                  int shift, int k) {
  extern __shared__ uint4 smem4[];
  int* s_count = reinterpret_cast<int*>(smem4);  // the block's pairs per owner
  int* s_at = s_count + owners;  // where they go
  if (threadIdx.x == 0) {  // an owner's part follows the parts of those before
    int at = 0;
    for (int d = 0; d < owners; ++d) {
      s_at[d] = at;
      at += (int)row[d];
      s_count[d] = 0;
    }
  }
  __syncthreads();
  const int t = threadIdx.x & 31;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = e < (int64_t)ctl[kCtlGroupSize] * 3 * k;
  uint32_t hh = 0u, ww = mine ? word[e] : 0u;
  int owner = owners;
  if (ww) {
    hh = h1[e];
    owner = (int)((hh >> shift) & (uint32_t)(owners - 1));
  }
  const uint32_t peers = __match_any_sync(kFullWarp, owner);
  const int leader = __ffs((int)peers) - 1;
  int rank = 0;
  if (owner < owners && t == leader)
    rank = atomicAdd(&s_count[owner], __popc(peers));
  rank = __shfl_sync(kFullWarp, rank, leader) +
         __popc(peers & ((1u << t) - 1u));
  __syncthreads();
  for (int d = threadIdx.x; d < owners; d += blockDim.x)
    if (s_count[d]) s_at[d] += atomicAdd(&route[d], s_count[d]);
  __syncthreads();
  if (!mine) return;
  const int at = owner < owners ? s_at[owner] + rank : -1;
  slot[e] = at;
  if (at >= 0) {
    pairs[2 * (int64_t)at] = hh;
    pairs[2 * (int64_t)at + 1] = ww;
  }
}

__global__ void walk_resolve_kernel(uint64_t* __restrict__ pk,
                                    uint8_t* __restrict__ fl,
                                    uint8_t* __restrict__ err,
                                    int32_t* __restrict__ cur,
                                    int32_t* __restrict__ lists,
                                    int32_t* __restrict__ ctl,
                                    int64_t num_reads,
                                    const int32_t* __restrict__ slot,
                                    const uint8_t* __restrict__ answers, int L,
                                    int k, int W) {
  extern __shared__ uint4 smem4[];
  int* s_count = reinterpret_cast<int*>(smem4);
  int* s_base = s_count + 1;
  int* s_ids = s_count + 2;
  if (threadIdx.x == 0) *s_count = 0;
  __syncthreads();
  const int n = L - k + 1, nw = packed_words(L);
  const int t = threadIdx.x & 31;
  const int a = blockIdx.x * kRoundWarps + (threadIdx.x >> 5);
  const int which = ctl[kCtlWhich];
  if (a < ctl[kCtlGroupSize]) {
    const int id = lists[which * 2 * num_reads + ctl[kCtlGroupStart] + a];
    const RoundLane ln(id, cur, n, k);
    uint64_t* p = pk + ln.r * nw;
    uint8_t* f = fl + ln.r * n;
    bool hit[3];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int s = t < k ? slot[((int64_t)a * 3 + u) * k + t] : -1;
      hit[u] = s >= 0 && answers[s] != 0;
    }
    int from;              // where the search for the next break starts
    bool failing;
    if (ln.failing) {
      // the lane's breaks among windows j..j+k-1 before the first that has
      // a candidate fail like the last (a mark, nothing else); that one is
      // the next round's break, or the search goes on past the k windows
      const int x = ln.j + t;
      const int xo = t < k && x < n ? ln.ow(x, n) : 0;
      const bool brk = t < k && x < n && f[xo] == kFlagBreak;
      const uint32_t fixable =
          __ballot_sync(kFullWarp, brk && (hit[0] || hit[1] || hit[2]));
      const int first = fixable ? __ffs((int)fixable) - 1 : 32;
      if (brk && t < first) err[ln.r * L + ln.entering(xo, k)] = 1;
      failing = fixable == 0u;
      from = ln.j + (failing ? k : first);
    } else {
      const int sh = 2 * (31 - (ln.po & 31));
      // the other direction flips only its own bits of this word
      const int orig = (int)((p[ln.po >> 5] >> sh) & 3ull);
      const int lim = W < n - ln.j ? W : n - ln.j;
      int best_u = -1, best_ext = 0;
#pragma unroll
      for (int u = 0; u < 3; ++u) {  // ascending ORIGINAL code
        const uint32_t ok = __ballot_sync(kFullWarp, t < lim && hit[u]);
        const int ext = ok == kFullWarp ? 32 : __ffs((int)~ok) - 1;
        if (ext > best_ext) {  // strict: ties keep the first
          best_ext = ext;
          best_u = u;
        }
      }
      if (t == 0) {
        err[ln.r * L + ln.po] = 1;
        if (best_ext >= 1)
          atomicXor(reinterpret_cast<unsigned long long*>(p + (ln.po >> 5)),
                    (unsigned long long)(orig ^ (best_u + (best_u >= orig)))
                        << sh);
      }
      if (best_ext >= 1 && t < k && ln.j + t < n) {
        const int xo = ln.ow(ln.j + t, n);
        const bool h = best_u == 0 ? hit[0] : best_u == 1 ? hit[1] : hit[2];
        if (f[xo] != 0) f[xo] = h ? kFlagTrusted : kFlagBreak;
      }
      failing = best_ext < 1;
      from = ln.j + (failing ? 1 : best_ext);
    }
    __syncwarp();  // the flags are read below by other threads
    int next = -1;
    for (int x0 = from; x0 < n; x0 += 32) {
      const int x = x0 + t;
      const uint32_t m =
          __ballot_sync(kFullWarp, x < n && f[ln.ow(x, n)] == kFlagBreak);
      if (m) { next = x0 + __ffs((int)m) - 1; break; }
    }
    if (t == 0) {
      cur[id] = next < 0 ? -1 : next | (failing ? kFailing : 0);
      if (next >= 0) s_ids[atomicAdd(s_count, 1)] = id;
    }
  }
  join_list(lists, ctl, num_reads, which ^ 1, s_ids, s_count, s_base);
}

__global__ void empty_kernel() {}

// blocks of a probe launch: a thread takes 4 windows a step
inline int probe_grid(int64_t n) { return grid_for((n + 3) / 4, kThreads); }

// The fused entry point in mode kMode: a warp a read, grid-stride beyond
// kMaxBlocks blocks; the probe count fixed at compile time where it is the
// default.  Refuses k outside 1..32 and num_hashes < 1.
template <int kMode>
int hash_launch(const void* codes, void* packed, uint32_t block_mask,
                void* h1, void* word, void* keep, int64_t num_reads,
                int64_t first_id, int L, int k, int num_hashes,
                uint32_t threshold, void* stream) {
  if (k < 1 || k > 32 || num_hashes < 1) return (int)cudaErrorInvalidValue;
  if (num_reads <= 0 || L - k + 1 <= 0) return (int)cudaGetLastError();
  const int blocks = grid_for(num_reads * 32, kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (num_hashes == kDefaultHashes)
    hash_build_kernel<kMode, kDefaultHashes><<<blocks, kThreads, 0, s>>>(
        (const int8_t*)codes, (uint32_t*)packed, block_mask, (uint32_t*)h1,
        (uint32_t*)word, (uint8_t*)keep, num_reads, first_id, L, k,
        num_hashes, threshold);
  else
    hash_build_kernel<kMode, 0><<<blocks, kThreads, 0, s>>>(
        (const int8_t*)codes, (uint32_t*)packed, block_mask, (uint32_t*)h1,
        (uint32_t*)word, (uint8_t*)keep, num_reads, first_id, L, k,
        num_hashes, threshold);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int kbbq_bloom_probe_hashed(const void* packed, uint32_t block_mask,
                            const void* hi, const void* lo, void* out,
                            int64_t n, int num_hashes, void* stream) {
  if (n > 0)
    bloom_probe_hashed_kernel<<<probe_grid(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const uint32_t*)packed, block_mask, (const uint32_t*)hi,
        (const uint32_t*)lo, (uint8_t*)out, n, num_hashes);
  return (int)cudaGetLastError();
}

int kbbq_bloom_probe_words(const void* packed, uint32_t block_mask,
                           const void* h1, const void* word, void* out,
                           int64_t n, void* stream) {
  if (n > 0)
    bloom_probe_words_kernel<<<probe_grid(n), kThreads, 0,
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

// Launches refused here (a tile that does not fit shared memory) return
// cudaErrorInvalidValue like any launch that CUDA refuses.
static int set_smem(const void* kernel, int bytes) {
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// codes: int8 [num_reads, L], everything past a read's end code 4; packed:
// the filter, zeroed or partly built; h1, word: int32 [num_reads, L-k+1] and
// keep: bool of that shape, all three written in full.  first_id: the global
// ordinal of read 0.  Any L: nothing is staged.
int kbbq_hash_build(const void* codes, void* packed, uint32_t block_mask,
                    void* h1, void* word, void* keep, int64_t num_reads,
                    int64_t first_id, int L, int k, int num_hashes,
                    uint32_t threshold, void* stream) {
  return hash_launch<kModeBuild>(codes, packed, block_mask, h1, word, keep,
                                 num_reads, first_id, L, k, num_hashes,
                                 threshold, stream);
}

// The hash-only mode of the fused entry point: h1, word int32
// [num_reads, L-k+1] written in full from the codes, nothing else read or
// written (no filter, no keep plane, no ordinal).
int kbbq_hash_only(const void* codes, void* h1, void* word,
                   int64_t num_reads, int L, int k, int num_hashes,
                   void* stream) {
  return hash_launch<kModeHashOnly>(codes, nullptr, 0u, h1, word, nullptr,
                                    num_reads, 0, L, k, num_hashes, 0u,
                                    stream);
}

// The keep mode of the fused entry point (pass 1 of the hash-space-sharded
// layout): h1, word int32 and keep bool [num_reads, L-k+1] written in full,
// as kbbq_hash_build writes them, and no filter touched.
int kbbq_hash_keep(const void* codes, void* h1, void* word, void* keep,
                   int64_t num_reads, int64_t first_id, int L, int k,
                   int num_hashes, uint32_t threshold, void* stream) {
  return hash_launch<kModeKeep>(codes, nullptr, 0u, h1, word, keep,
                                num_reads, first_id, L, k, num_hashes,
                                threshold, stream);
}

// h1, word: int32 [num_reads, n], the hash cache; thresholds: int32 [k+1],
// the coverage rule's table t(x); out: bool [num_reads, n], every byte
// written.  tile_rows: reads per block; threads: threads per block.
int kbbq_bloom_probe_trust(const void* packed, uint32_t block_mask,
                           const void* h1, const void* word,
                           const void* thresholds, void* out,
                           int64_t num_reads, int n, int k,
                           int trust_threshold, int tile_rows, int threads,
                           void* stream) {
  if (num_reads <= 0 || n <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > 32 || tile_rows < 1 || threads < 32 || threads > 1024 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const int smem = trust_tile_bytes(n, k, tile_rows, threads);
  const int rc = set_smem((const void*)bloom_probe_trust_kernel, smem);
  if (rc != 0) return rc;
  const int64_t blocks = (num_reads + tile_rows - 1) / tile_rows;
  bloom_probe_trust_kernel<<<(unsigned)blocks, threads, smem,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)packed, block_mask, (const uint32_t*)h1,
      (const uint32_t*)word, (const int32_t*)thresholds, (uint8_t*)out,
      num_reads, n, k, trust_threshold, tile_rows);
  return (int)cudaGetLastError();
}

// The rule-only entry point: hits bool [num_reads, n], the answers of a word
// test made elsewhere, in place of the filter; word int32 [num_reads, n] (0
// marks an invalid window); thresholds and out as kbbq_bloom_probe_trust.  A
// warp a read, grid-stride beyond kMaxBlocks blocks; any n.
int kbbq_trust_rule(const void* hits, const void* word,
                    const void* thresholds, void* out, int64_t num_reads,
                    int n, int k, int trust_threshold, void* stream) {
  if (k < 1 || k > 32) return (int)cudaErrorInvalidValue;
  if (num_reads <= 0 || n <= 0) return (int)cudaGetLastError();
  trust_rule_kernel<<<grid_for(num_reads * 32, kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)hits, (const uint32_t*)word,
      (const int32_t*)thresholds, (uint8_t*)out, num_reads, n, k,
      trust_threshold);
  return (int)cudaGetLastError();
}

// codes: int8 [num_reads, L], read only; trusted0: bool [num_reads, L-k+1];
// err: bool [num_reads, L], every byte written.  tile_rows: reads per block;
// threads: threads per block.
int kbbq_walk_errors(const void* codes, const void* trusted0,
                     const void* packed, uint32_t block_mask, void* err,
                     int64_t num_reads, int L, int k, int W, int num_hashes,
                     int tile_rows, int threads, void* stream) {
  const int n = L - k + 1;
  if (num_reads <= 0 || n <= 0) return (int)cudaGetLastError();
  if (tile_rows < 1 || threads < 32 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  const int smem = walk_tile_bytes(L, n, tile_rows);
  const int rc = set_smem((const void*)walk_errors_kernel, smem);
  if (rc != 0) return rc;
  const int64_t blocks = (num_reads + tile_rows - 1) / tile_rows;
  walk_errors_kernel<<<(unsigned)blocks, threads, smem,
                       (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const uint8_t*)trusted0, (const uint32_t*)packed,
      block_mask, (uint8_t*)err, num_reads, L, k, W, num_hashes, tile_rows);
  return (int)cudaGetLastError();
}

// The walk_round entry points.  State (see K4): pk int64 [num_reads,
// packed_words(L)], fl and err bool-sized [num_reads, L-k+1] and
// [num_reads, L], cur int32 [num_reads, 2], lists int32 [2, 2 * num_reads],
// ctl int32 [kCtlLanes + L-k+2], zeroed before walk_start, which writes the
// rest from codes int8 [num_reads, L] and trusted0 bool [num_reads, L-k+1].
int kbbq_walk_start(const void* codes, const void* trusted0, void* pk,
                    void* fl, void* err, void* cur, void* lists, void* ctl,
                    int64_t num_reads, int L, int k, void* stream) {
  if (num_reads <= 0 || L - k + 1 <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (num_reads + kRoundWarps - 1) / kRoundWarps;
  walk_start_kernel<<<(unsigned)blocks, kRoundThreads,
                      (2 + 2 * kRoundWarps) * 4, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const uint8_t*)trusted0, (uint64_t*)pk,
      (uint8_t*)fl, (uint8_t*)err, (int32_t*)cur, (int32_t*)lists,
      (int32_t*)ctl, num_reads, L, k);
  return (int)cudaGetLastError();
}

// The next group of at most `group` lanes: row int64 [owners + 1] (its
// pairs per owner, then every lane the rank still walks), h1 and word int32
// [group, 3, k] in lane order (word 0: not asked), pairs int32 [group*3*k,
// 2] grouped by owner, slot int32 [group*3*k] (each pair's place in pairs,
// -1 where not asked), route int32 [owners] (scratch).  bound: a bound on
// the group's size (at most `group`, 0 when the rank walks no lane).
int kbbq_walk_propose(const void* pk, const void* fl, const void* cur,
                      const void* lists, void* ctl, int64_t num_reads,
                      void* row, void* route, void* h1, void* word,
                      void* pairs, void* slot, int bound, int group,
                      int owners, int shift, int L, int k, int num_hashes,
                      void* stream) {
  if (owners < 1 || owners > 4096 || (owners & (owners - 1)) || group < 1 ||
      bound < 0 || bound > group || shift < 0 || shift > 31 || k < 1 ||
      k > 32 || L - k + 1 <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  walk_take_kernel<<<1, 32, 0, s>>>((int32_t*)ctl, (int64_t*)row,
                                    (int32_t*)route, owners, group,
                                    L - k + 2);
  if (bound > 0) {
    walk_propose_kernel<<<(bound + kRoundWarps - 1) / kRoundWarps,
                          kRoundThreads, owners * 4, s>>>(
        (const uint64_t*)pk, (const uint8_t*)fl, (const int32_t*)cur,
        (const int32_t*)lists, (const int32_t*)ctl, num_reads,
        (unsigned long long*)row, (uint32_t*)h1, (uint32_t*)word, owners,
        shift, L, k, num_hashes);
    const int64_t entries = (int64_t)bound * 3 * k;
    walk_route_kernel<<<(unsigned)((entries + kRoundThreads - 1) /
                                   kRoundThreads),
                        kRoundThreads, owners * 8, s>>>(
        (const uint32_t*)h1, (const uint32_t*)word, (const int32_t*)ctl,
        (const int64_t*)row, (int32_t*)route, (uint32_t*)pairs,
        (int32_t*)slot, owners, shift, k);
  }
  return (int)cudaGetLastError();
}

// The rest of the group's round from answers uint8 [pairs sent], the word
// tests of walk_propose's pairs in their order; bound as there.
int kbbq_walk_resolve(void* pk, void* fl, void* err, void* cur, void* lists,
                      void* ctl, int64_t num_reads, const void* slot,
                      const void* answers, int bound, int L, int k, int W,
                      void* stream) {
  if (bound <= 0) return (int)cudaGetLastError();
  if (W < 1 || W > k || k > 32) return (int)cudaErrorInvalidValue;
  walk_resolve_kernel<<<(bound + kRoundWarps - 1) / kRoundWarps,
                        kRoundThreads, (2 + kRoundWarps) * 4,
                        (cudaStream_t)stream>>>(
      (uint64_t*)pk, (uint8_t*)fl, (uint8_t*)err, (int32_t*)cur,
      (int32_t*)lists, (int32_t*)ctl, num_reads, (const int32_t*)slot,
      (const uint8_t*)answers, L, k, W);
  return (int)cudaGetLastError();
}

// shared memory (bytes) a block of the tiled kernels needs, for the
// wrappers that choose tile_rows
int kbbq_walk_tile_bytes(int L, int k, int tile_rows) {
  return walk_tile_bytes(L, L - k + 1, tile_rows);
}
int kbbq_trust_tile_bytes(int L, int k, int tile_rows, int threads) {
  return trust_tile_bytes(L - k + 1, k, tile_rows, threads);
}

// a kernel that does nothing: the floor under every launch's time
int kbbq_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
