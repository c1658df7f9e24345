// Host stand-in for <cuda_runtime.h>: just enough of CUDA to compile
// ../kbbq_kernels.cu with a host C++ compiler and run the kernels' logic on
// the CPU, so that it can be held against the plain PyTorch versions where
// there is no card (tests/test_torch_kernels_host.py does; it rewrites each
// `kernel<<<grid, threads, shared, stream>>>(args)` to
// `LAUNCH(kernel, grid, threads, args)` first).
//
// One OS thread plays one CUDA thread, one block at a time: __syncthreads is
// a barrier of the block's threads, __ballot_sync and __syncwarp barriers of
// a warp's 32, atomics the compiler's builtins.  Nothing here says anything
// about speed, and nothing here is used on the card.
#pragma once
#include <pthread.h>

#include <cstdint>
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
inline int __ffs(int x) { return __builtin_ffs(x); }
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
