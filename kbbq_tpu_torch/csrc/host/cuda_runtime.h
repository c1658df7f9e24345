// Host stand-in for <cuda_runtime.h>: just enough of CUDA to compile
// ../kbbq_kernels.cu with a host C++ compiler and run the kernels' logic on
// the CPU, so that it can be held against the plain PyTorch versions where
// there is no card (tests/test_torch_kernels_host.py does; it rewrites each
// `kernel<<<grid, threads, shared, stream>>>(args)` to
// `LAUNCH(kernel, grid, threads, args)` first).
//
// One OS thread plays one CUDA thread, one block at a time: __syncthreads is
// a barrier of the block's threads, __syncwarp and the warp functions
// (__ballot_sync, __shfl_sync, __match_any_sync, __reduce_max_sync) barriers
// of a warp's 32 around a slot each, atomics the compiler's builtins.  Nothing here says anything
// about speed, and nothing here is used on the card.
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
inline uint32_t warp_ballot[32];
// the block's dynamic shared memory (`extern __shared__ uint4 smem4[]`)
namespace { uint4 smem4[232448 / 16]; }

inline void __syncthreads() { pthread_barrier_wait(&block_barrier); }
inline void __syncwarp() { pthread_barrier_wait(&warp_barrier[threadIdx.x / 32]); }
inline uint32_t __ballot_sync(uint32_t, bool pred) {
  const unsigned w = threadIdx.x / 32, t = threadIdx.x % 32;
  if (pred) __atomic_fetch_or(&warp_ballot[w], 1u << t, __ATOMIC_SEQ_CST);
  pthread_barrier_wait(&warp_barrier[w]);
  const uint32_t m = __atomic_load_n(&warp_ballot[w], __ATOMIC_SEQ_CST);
  pthread_barrier_wait(&warp_barrier[w]);
  if (t == 0) warp_ballot[w] = 0;
  pthread_barrier_wait(&warp_barrier[w]);
  return m;
}
// each thread of a warp puts a value in its slot; all read after a barrier
inline uint64_t warp_slot[32][32];
template <class T>
inline void warp_put(T v) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  warp_slot[threadIdx.x / 32][threadIdx.x % 32] = bits;
  pthread_barrier_wait(&warp_barrier[threadIdx.x / 32]);
}
inline void warp_done() { pthread_barrier_wait(&warp_barrier[threadIdx.x / 32]); }
template <class T>
inline T __shfl_sync(uint32_t, T v, int src) {
  warp_put(v);
  T r;
  std::memcpy(&r, &warp_slot[threadIdx.x / 32][src & 31], sizeof(T));
  warp_done();
  return r;
}
inline uint32_t __match_any_sync(uint32_t, int v) {
  warp_put((uint64_t)(uint32_t)v);
  uint32_t m = 0;
  for (int t = 0; t < 32; ++t)
    if (warp_slot[threadIdx.x / 32][t] == (uint64_t)(uint32_t)v) m |= 1u << t;
  warp_done();
  return m;
}
inline unsigned __reduce_max_sync(uint32_t, unsigned v) {
  warp_put((uint64_t)v);
  unsigned m = 0;
  for (int t = 0; t < 32; ++t) {
    const unsigned x = (unsigned)warp_slot[threadIdx.x / 32][t];
    m = x > m ? x : m;
  }
  warp_done();
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

// threads must be a multiple of 32 wherever a kernel uses warp functions
#define LAUNCH(kernel, grid, threads, ...)                                  \
  do {                                                                      \
    gridDim.x = (unsigned)(grid);                                           \
    blockDim.x = (unsigned)(threads);                                       \
    for (unsigned b_ = 0; b_ < gridDim.x; ++b_) {                           \
      pthread_barrier_init(&block_barrier, nullptr, blockDim.x);            \
      for (unsigned w_ = 0; w_ < blockDim.x / 32; ++w_)                     \
        pthread_barrier_init(&warp_barrier[w_], nullptr, 32);               \
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
