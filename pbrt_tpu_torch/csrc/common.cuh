// Helpers shared by the port's kernels (csrc/*.cu): cp.async copies, the
// 64-bit merge keys of the t-passes, and the size of a persistent grid.
#pragma once
#include <cuda_runtime.h>

namespace pbrt_cuda {

constexpr float BIG = 1e30f;
// A ray's key before any candidate (cudaMemset 0x7F); above every
// candidate's key, whose t is below 1e30.
constexpr long long KEY_EMPTY = 0x7F7F7F7F7F7F7F7FLL;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The t part of a merge key: the bits of t, made to order as signed
// integers in the order of t (-0.0 taken as +0.0), in the high 32 bits,
// and in bit 0 whether t was -0.0. Each t-pass puts its tie-break in
// bits 1-31; the least key is then the least t, first in that order.
__device__ __forceinline__ long long key_of_t(float t) {
  const int bits = __float_as_int(t);
  const int neg_zero = bits == static_cast<int>(0x80000000u);
  const int i = neg_zero ? 0 : bits;
  const unsigned hi = static_cast<unsigned>(i ^ ((i >> 31) & 0x7FFFFFFF));
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) |
                                static_cast<unsigned>(neg_zero));
}

// The inverse of key_of_t: t, every bit of it, from a key.
__device__ __forceinline__ float t_of_key(long long key) {
  const int hi = static_cast<int>(static_cast<unsigned long long>(key) >> 32);
  const int i = hi ^ ((hi >> 31) & 0x7FFFFFFF);
  return (key & 1) ? -0.0f : __int_as_float(i);
}

// Blocks of Kernel (at `threads` threads, no dynamic shared memory) that
// are resident at once on the current device: SMs x blocks per SM,
// cached per device. 0 on a CUDA error.
template <auto Kernel>
int resident_grid(int threads) {
  static int grid[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, threads, 0) !=
            cudaSuccess)
      return 0;
    grid[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return grid[dev];
}

}  // namespace pbrt_cuda
