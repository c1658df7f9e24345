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

constexpr int kThreads = 256;      // probe / build / hash blocks
constexpr int kMaxBlocks = 132 * 32;
constexpr int kHashSeg = 15;       // windows per thread of the fused build
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

// block hash and probe word of a canonical k-mer (hi, lo)
__device__ __forceinline__ void kmer_hash(uint32_t hi, uint32_t lo,
                                          int num_hashes, uint32_t& h1,
                                          uint32_t& word) {
  h1 = fmix32(lo ^ fmix32(hi ^ kSeedH1));
  word = probe_word(fmix32(hi ^ fmix32(lo ^ kSeedH2)), num_hashes);
}

inline int grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return (int)blocks;
}

// One insert of the build: packed[h1 & mask] |= word.  The word is read first
// through L2 (__ldcg: the filter is being written, so not the read-only
// path) and the atomic is skipped when every bit is already set.  A stale
// read can only miss a bit, which the atomic then sets, so the filter is the
// same with and without the test.  kTestFirst is each entry point's measured
// winner on an H100 (PERF.md): the test for the cached build, whose windows
// mostly repeat, the plain atomic for the fused build's thin sample.
template <bool kTestFirst>
__device__ __forceinline__ void or_word(uint32_t* __restrict__ packed,
                                        uint32_t block_mask, uint32_t h1,
                                        uint32_t word) {
  uint32_t* p = packed + (h1 & block_mask);
  if (kTestFirst && (__ldcg(p) & word) == word) return;
  atomicOr(p, word);
}

// roll base c (< 4) into a window's forward and reverse-complement words;
// forward is big-endian, `top` = 2(k-1) is the bit position of the first base
__device__ __forceinline__ void roll_kmer(uint64_t& f, uint64_t& rc, int c,
                                          uint64_t kmask, int top) {
  f = ((f << 2) | (uint64_t)c) & kmask;
  rc = (rc >> 2) | ((uint64_t)(3 - c) << top);
}

__device__ __forceinline__ uint64_t kmer_mask(int k) {
  return (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1ull);  // no shift by 64
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
//   (hash-only mode: 1 B per base in, 8 B per window out, no filter);
//   about 150 integer operations per window stay under that.
// Design: OR commutes and is idempotent, so the words equal the sort build's
//   word for word whatever the thread order.  Sequencing data repeats (every
//   genomic k-mer arrives once per unit of coverage), so most inserts find
//   their bits already set: there or_word() reads the word first and skips
//   the atomic.
//   Cached entry point (pass 2, filter B from the trusted windows of the hash
//   cache): one thread per window, grid-stride.
//   Fused entry point (pass 1): a block stages a tile of reads' codes in
//   shared memory with wide loads; a thread takes kHashSeg consecutive
//   windows of one read, warms the forward and RC 64-bit words with k rolls
//   and then rolls one base per window, so no [rows, n] intermediate is ever
//   written: the kernel reads 1 B per base and writes the hash cache that
//   passes 2 and 3 reuse, and ORs the sampled windows into filter A on the
//   way.  An N is rolled in as base 0 (the run counter keeps validity), so
//   h1 of an invalid window equals the plain version's.  The three output
//   planes are collected in shared memory and stored by the whole block, so
//   the stores of the flat [N * n] arrays coalesce; kHashSeg is odd, which
//   keeps the threads' shared-memory words on distinct banks.
//   Hash-only mode of the fused entry point (kbbq_hash_only: passes 2 and 3
//   of the windowed engine, where no window's hash cache outlives its pass;
//   it replaces the hash pass inside kbbq_tpu/pipeline/stream_resident.py::
//   _p2_window and kbbq_tpu/pipeline/recalibrate.py::_step_trusted): the same
//   tile and rolls, writing h1 and word only, 1 B per base in and 8 B per
//   window out.  It reads no ordinal and touches no filter: re-running the
//   build against filter A would set no new bit (the keep bits depend only on
//   the global ordinals) but would still cost every sampled window its
//   atomic.
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
    if (keep[i]) or_word<true>(packed, block_mask, h1[i], word[i]);
}

// (h1, word, keep) of windows [j0, j1) of one read, and their inserts; in
// hash-only mode (kInsert false: passes 2 and 3 of the windowed engine) the
// pair (h1, word) alone, with no sampling, keep plane or filter.
// c: the read's codes [L]; oh1, oword, okeep: the read's rows of the output
// planes [n]; rid: the 32-bit pattern of the read's global ordinal.
template <bool kInsert>
__device__ __forceinline__ void hash_segment(
    const int8_t* c, int j0, int j1, int k, int num_hashes, uint32_t rid,
    uint32_t threshold, uint32_t* oh1, uint32_t* oword, uint8_t* okeep,
    uint32_t* __restrict__ packed, uint32_t block_mask) {
  const uint64_t kmask = kmer_mask(k);
  const int top = 2 * (k - 1);
  const uint32_t sr = fmix32(rid ^ kSeedSample);
  uint64_t f = 0, rc = 0;
  int run = 0;  // consecutive non-N bases ending at the last base rolled in
  for (int i = j0; i < j0 + k - 1; ++i) {
    const int b = c[i];
    if (b >= 4) { run = 0; roll_kmer(f, rc, 0, kmask, top); }
    else { ++run; roll_kmer(f, rc, b, kmask, top); }
  }
  for (int j = j0; j < j1; ++j) {
    const int b = c[j + k - 1];
    if (b >= 4) { run = 0; roll_kmer(f, rc, 0, kmask, top); }
    else { ++run; roll_kmer(f, rc, b, kmask, top); }
    const bool valid = run >= k;
    const uint64_t cn = f <= rc ? f : rc;  // canonical: (hi, lo) unsigned order
    uint32_t h1, w;
    kmer_hash((uint32_t)(cn >> 32), (uint32_t)cn, num_hashes, h1, w);
    if (!valid) w = 0u;
    oh1[j] = h1;
    oword[j] = w;
    if (kInsert) {
      const bool kp =
          valid && fmix32(sr ^ ((uint32_t)j * kGolden)) <= threshold;
      okeep[j] = kp ? 1 : 0;
      if (kp) or_word<false>(packed, block_mask, h1, w);
    }
  }
}

// shared memory of one block of hash_build_kernel, in bytes
__host__ __device__ inline int hash_tile_bytes(int L, int n, int rows) {
  return round16(rows * L + 16) + 2 * round16(rows * n * 4) +
         round16(rows * n + 16);
}

template <bool kInsert>
__global__ void hash_build_kernel(const int8_t* __restrict__ codes,
                                  uint32_t* __restrict__ packed,
                                  uint32_t block_mask,
                                  uint32_t* __restrict__ h1,
                                  uint32_t* __restrict__ word,
                                  uint8_t* __restrict__ keep,
                                  int64_t num_reads, int64_t first_id, int L,
                                  int k, int num_hashes, uint32_t threshold,
                                  int tile_rows) {
  extern __shared__ uint4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  const int n = L - k + 1;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int64_t r0 = (int64_t)blockIdx.x * tile_rows;
  const int64_t left = num_reads - r0;
  const int R = left < tile_rows ? (int)left : tile_rows;

  const uint8_t* gcodes = reinterpret_cast<const uint8_t*>(codes) + r0 * L;
  uint8_t* gkeep = kInsert ? keep + r0 * n : nullptr;
  const int plane = round16(tile_rows * n * 4);
  uint8_t* sc = smem + ((uintptr_t)gcodes & 15u);
  uint32_t* sh1 =
      reinterpret_cast<uint32_t*>(smem + round16(tile_rows * L + 16));
  uint32_t* sword = sh1 + plane / 4;
  uint8_t* skeep = reinterpret_cast<uint8_t*>(sword) + plane +
                   ((uintptr_t)gkeep & 15u);

  tile_copy(sc, gcodes, R * L, tid, nthreads);
  __syncthreads();

  const int nseg = (n + kHashSeg - 1) / kHashSeg;
  for (int item = tid; item < R * nseg; item += nthreads) {
    const int r = item / nseg;
    const int j0 = (item - r * nseg) * kHashSeg;
    const int j1 = j0 + kHashSeg < n ? j0 + kHashSeg : n;
    hash_segment<kInsert>(reinterpret_cast<const int8_t*>(sc) + r * L, j0,
                          j1, k, num_hashes,
                          (uint32_t)(uint64_t)(first_id + r0 + r), threshold,
                          sh1 + r * n, sword + r * n, skeep + r * n, packed,
                          block_mask);
  }
  __syncthreads();

  uint32_t* gh1 = h1 + r0 * n;
  uint32_t* gword = word + r0 * n;
  for (int i = tid; i < R * n; i += nthreads) {
    gh1[i] = sh1[i];
    gword[i] = sword[i];
  }
  if (kInsert) tile_copy(gkeep, skeep, R * n, tid, nthreads);
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

// reverse complement of a k-mer held in the low 2k bits
__device__ __forceinline__ uint64_t revcomp_kmer(uint64_t f, int k) {
  uint64_t x = __brevll(~f);  // reverses the bases, and the bits of each
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return x >> (64 - 2 * k);
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

__global__ void empty_kernel() {}

// blocks of a probe launch: a thread takes 4 windows a step
inline int probe_grid(int64_t n) { return grid_for((n + 3) / 4, kThreads); }

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
// ordinal of read 0.  tile_rows: reads per block.
int kbbq_hash_build(const void* codes, void* packed, uint32_t block_mask,
                    void* h1, void* word, void* keep, int64_t num_reads,
                    int64_t first_id, int L, int k, int num_hashes,
                    uint32_t threshold, int tile_rows, void* stream) {
  const int n = L - k + 1;
  if (num_reads <= 0 || n <= 0) return (int)cudaGetLastError();
  if (tile_rows < 1) return (int)cudaErrorInvalidValue;
  const int smem = hash_tile_bytes(L, n, tile_rows);
  const int rc = set_smem((const void*)hash_build_kernel<true>, smem);
  if (rc != 0) return rc;
  const int64_t blocks = (num_reads + tile_rows - 1) / tile_rows;
  hash_build_kernel<true><<<(unsigned)blocks, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const int8_t*)codes, (uint32_t*)packed, block_mask, (uint32_t*)h1,
      (uint32_t*)word, (uint8_t*)keep, num_reads, first_id, L, k, num_hashes,
      threshold, tile_rows);
  return (int)cudaGetLastError();
}

// The hash-only mode of the fused entry point: h1, word int32
// [num_reads, L-k+1] written in full from the codes, nothing else read or
// written (no filter, no keep plane, no ordinal).  tile_rows: reads per block.
int kbbq_hash_only(const void* codes, void* h1, void* word,
                   int64_t num_reads, int L, int k, int num_hashes,
                   int tile_rows, void* stream) {
  const int n = L - k + 1;
  if (num_reads <= 0 || n <= 0) return (int)cudaGetLastError();
  if (tile_rows < 1) return (int)cudaErrorInvalidValue;
  const int smem = hash_tile_bytes(L, n, tile_rows);
  const int rc = set_smem((const void*)hash_build_kernel<false>, smem);
  if (rc != 0) return rc;
  const int64_t blocks = (num_reads + tile_rows - 1) / tile_rows;
  hash_build_kernel<false><<<(unsigned)blocks, kThreads, smem,
                             (cudaStream_t)stream>>>(
      (const int8_t*)codes, nullptr, 0u, (uint32_t*)h1, (uint32_t*)word,
      nullptr, num_reads, 0, L, k, num_hashes, 0u, tile_rows);
  return (int)cudaGetLastError();
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

// shared memory (bytes) a block of the tiled kernels needs, for the
// wrappers that choose tile_rows
int kbbq_walk_tile_bytes(int L, int k, int tile_rows) {
  return walk_tile_bytes(L, L - k + 1, tile_rows);
}
int kbbq_hash_tile_bytes(int L, int k, int tile_rows) {
  return hash_tile_bytes(L, L - k + 1, tile_rows);
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
