// Host stand-in for <cuda_runtime.h>: just enough of CUDA to compile
// ../kbbq_kernels.cu with a host C++ compiler and run the kernels' logic on
// the CPU, so that it can be held against the plain PyTorch versions where
// there is no card (tests/test_torch_kernels_host.py does; it rewrites each
// `kernel<<<grid, threads, shared, stream>>>(args)` to
// `LAUNCH((kernel), grid, threads, args)` first).
//
// One OS thread plays one CUDA thread, one block at a time: __syncthreads is
// a barrier of the block's threads, __syncwarp and the warp functions
// (__ballot_sync, __shfl_sync, __match_any_sync, __reduce_max_sync) one
// barrier of a warp's 32 each, around rotating slots, atomics the
// compiler's builtins.  Nothing here says anything about speed, and nothing
// here is used on the card.
#pragma once
#include <pthread.h>

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__

struct Dim3 { unsigned x = 1, y = 1, z = 1; };
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetLastError() { return 0; }
inline int cudaFuncSetAttribute(const void*, int, int) { return 0; }

inline thread_local Dim3 threadIdx, blockIdx;
inline Dim3 blockDim, gridDim;
inline pthread_barrier_t block_barrier, warp_barrier[32];
// The warp functions cost one barrier each: a ballot ORs into one of three
// rotating words (lane 0 clears the word the call after next will use,
// which every lane has read by the time it reaches this call's barrier),
// a shuffle writes into one of two rotating rows of slots (the row is
// written again two calls later, after a barrier every lane reaches only
// once it has read).  Each lane of a warp calls the same warp functions in
// the same order, so each thread's own call counters agree; LAUNCH clears
// the words before each block.
inline uint32_t warp_ballot[32][3];
inline thread_local unsigned ballot_calls, slot_calls;
// the block's dynamic shared memory (`extern __shared__ uint4 smem4[]`)
namespace { uint4 smem4[232448 / 16]; }

inline void __syncthreads() { pthread_barrier_wait(&block_barrier); }
inline void __syncwarp() { pthread_barrier_wait(&warp_barrier[threadIdx.x / 32]); }
inline uint32_t __ballot_sync(uint32_t, bool pred) {
  const unsigned w = threadIdx.x / 32, t = threadIdx.x % 32;
  const unsigned i = ballot_calls++ % 3;
  if (pred) __atomic_fetch_or(&warp_ballot[w][i], 1u << t, __ATOMIC_SEQ_CST);
  pthread_barrier_wait(&warp_barrier[w]);
  const uint32_t m = __atomic_load_n(&warp_ballot[w][i], __ATOMIC_SEQ_CST);
  if (t == 0)
    __atomic_store_n(&warp_ballot[w][(i + 2) % 3], 0u, __ATOMIC_SEQ_CST);
  return m;
}
// each thread of a warp puts a value in its slot of the call's row; all read
// after the barrier
inline uint64_t warp_slot[32][2][32];
template <class T>
inline const uint64_t* warp_put(T v) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  const unsigned w = threadIdx.x / 32, row = slot_calls++ % 2;
  warp_slot[w][row][threadIdx.x % 32] = bits;
  pthread_barrier_wait(&warp_barrier[w]);
  return warp_slot[w][row];
}
template <class T>
inline T __shfl_sync(uint32_t, T v, int src) {
  const uint64_t* row = warp_put(v);
  T r;
  std::memcpy(&r, &row[src & 31], sizeof(T));
  return r;
}
inline uint32_t __match_any_sync(uint32_t, int v) {
  const uint64_t* row = warp_put((uint64_t)(uint32_t)v);
  uint32_t m = 0;
  for (int t = 0; t < 32; ++t)
    if (row[t] == (uint64_t)(uint32_t)v) m |= 1u << t;
  return m;
}
inline unsigned __reduce_max_sync(uint32_t, unsigned v) {
  const uint64_t* row = warp_put((uint64_t)v);
  unsigned m = 0;
  for (int t = 0; t < 32; ++t) {
    const unsigned x = (unsigned)row[t];
    m = x > m ? x : m;
  }
  return m;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) { r = (r << 1) | (x & 1); x >>= 1; }
  return r;
}
inline uint64_t __brevll(uint64_t x) {
  uint64_t r = 0;
  for (int i = 0; i < 64; ++i) { r = (r << 1) | (x & 1); x >>= 1; }
  return r;
}
// funnel shifts: (hi:lo) shifted by shift & 31, the upper (l) or lower (r)
// 32 bits
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t shift) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (shift & 31)) >> 32);
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t shift) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (shift & 31));
}
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcs(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline uint32_t __ldcg(const uint32_t* p) {
  return __atomic_load_n(p, __ATOMIC_RELAXED);
}
inline uint32_t atomicOr(uint32_t* p, uint32_t v) {
  return __atomic_fetch_or(p, v, __ATOMIC_RELAXED);
}
inline unsigned long long atomicXor(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_xor(p, v, __ATOMIC_RELAXED);
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}

// threads must be a multiple of 32 wherever a kernel uses warp functions;
// `kernel` may be a parenthesised template instance (commas in its brackets)
#define LAUNCH(kernel, grid, threads, ...)                                  \
  do {                                                                      \
    gridDim.x = (unsigned)(grid);                                           \
    blockDim.x = (unsigned)(threads);                                       \
    for (unsigned b_ = 0; b_ < gridDim.x; ++b_) {                           \
      pthread_barrier_init(&block_barrier, nullptr, blockDim.x);            \
      for (unsigned w_ = 0; w_ < blockDim.x / 32; ++w_)                     \
        pthread_barrier_init(&warp_barrier[w_], nullptr, 32);               \
      std::memset(warp_ballot, 0, sizeof warp_ballot);                      \
      std::vector<std::thread> ts_;                                         \
      for (unsigned t_ = 0; t_ < blockDim.x; ++t_)                          \
        ts_.emplace_back([=]() {                                            \
          blockIdx.x = b_;                                                  \
          threadIdx.x = t_;                                                 \
          kernel(__VA_ARGS__);                                              \
        });                                                                 \
      for (auto& th_ : ts_) th_.join();                                     \
    }                                                                       \
  } while (0)
