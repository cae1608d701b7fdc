// K1: flat closest-hit t-pass, every live ray against every triangle.
//
// Replaces the Pallas TPU kernel pbrt_tpu/ops/intersect_pallas.py:35
// _tri_kernel (pallas_call at :98 in _tri_t_pass, wrapper
// tri_t_pass_pallas). It computes the same thing: Moller-Trumbore with
// |det| > 1e-12, b1, b2 >= 0, b1 + b2 <= 1, tmin < t < tmax; per ray the
// least t, at the lowest triangle index on ties (what a strict '<' fold
// in index order keeps); a miss returns (1e30, -1). The result must equal
// tri_t_pass_plain (ops/intersect_cuda.py) bit for bit.
//
// What bounds it: arithmetic. One test is 46 flops (pv 9, det 5, one
// division, tv 3, b1 6, qv 9, b2 6, t 6, b1+b2 1) on 36 bytes of triangle
// that every ray shares: 65,536 live rays x 7,424 triangles have a floor
// of 0.33 ms at 67 TFLOP/s. The kernels are built with -fmad=false and
// IEEE division, so every multiply and add is its own instruction and
// rounds like the plain torch twin. The issue rate (one warp instruction
// per scheduler per cycle, 33.5 T lane-instructions/s) then caps a kernel
// at 46 / (2 x instructions per test) of the FLOP bound. chip_smoke.py [2]
// counts the inner loop of the sm_90a build: 66.2 instructions per test
// on the division's fast path (48 FP32, 1 MUFU, 10 compares and selects,
// 1.1 shared loads, 6 other), so the ceiling under this contract is
// 46 / (2 x 66.2) = 34.7% of the FLOP bound (K2's loop: 75.9, 30.3%).
//
// Design on Hopper. The TPU carried each ray tile's accumulator along a
// sequential grid over triangle blocks. One thread per ray over all
// triangles (the first port) gave 256 blocks of 256 threads for a
// 65,536-ray launch, one dependent chain per thread, 9 scalar shared
// loads per test, no copy overlap, and dead rays tested like live ones.
// Here:
//
// 1. Dead rays are not issued. k1_live_kernel lists the rays with
//    tmin < tmax (false for NaN) by a warp-aggregated atomicAdd and sets
//    every ray's key to empty; a dead ray can hit nothing, so it keeps
//    the empty key and the finish writes (1e30, -1). No host sync: the
//    live count stays on the device.
// 2. Items over the whole card. An item is (slice of 256 live rays,
//    chunk of 256-triangle stages). The sweep kernel sizes the chunk from
//    the live count so that there are about 8 items per resident block,
//    and a persistent grid (every SM, as many blocks as fit) pulls items
//    from a device counter.
// 3. Merge. Each ray's best candidate of an item goes into one 64-bit
//    atomicMin on a key: the order-preserving bits of t (-0.0 taken as
//    +0.0), then (prim << 1) | the -0.0 bit. The least key is the least t
//    at the lowest index, whatever order the items run in.
//    k1_finish_kernel decodes it and applies the miss rule.
//    ops/intersect_cuda.py (pack_keys, tri_t_pass_chunked) states the
//    same rule in torch and the CPU tests hold it against the fold.
// 4. Feeding the FP32 pipes. Two rays per thread; each thread reads 4
//    triangles of one component as one float4 (9 shared loads per 8
//    independent tests). Stages are copied by cp.async into two buffers,
//    the next stage's copy in flight during the current stage's tests.
//    A ray's running bound is min(tmax, best t), so one compare stands
//    for t < tmax and t < best (equal for the non-NaN bounds of a live
//    ray). The reciprocal is a select, not an `if (ok_det)`: without the
//    divergent region around it a test is 66.2 instructions instead of
//    70.4. Nothing that rounds is changed.
#include "common.cuh"

namespace {

using namespace pbrt_cuda;

constexpr int K1_THREADS = 128;                 // threads per sweep block
constexpr int K1_RPT = 2;                       // rays per thread
constexpr int K1_SLICE = K1_THREADS * K1_RPT;   // live rays per item
constexpr int K1_TB = 256;                      // triangles per stage (intersect_cuda.TB)
constexpr int K1_ITEMS_PER_BLOCK = 8;           // items aimed at per resident block
constexpr int K1_ROW_THREADS = 256;             // threads of the per-ray kernels

// K1's merge key: t, then the triangle index (intersect_cuda.pack_keys).
__device__ __forceinline__ long long pack_key(float t, int prim) {
  return key_of_t(t) | (static_cast<long long>(prim) << 1);
}

struct K1Ray {
  float ox, oy, oz, dx, dy, dz, tmin;
  float lim;  // min(tmax, best t so far): a candidate must lie below it
  int best;   // index of the best hit so far, -1 for none
};

// One Moller-Trumbore test in the arithmetic order of mt_t; a hit below
// the running bound becomes the ray's best (strict '<', index order).
__device__ __forceinline__ void mt_test(float v0x, float v0y, float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y, float e2z, K1Ray& r,
                                        int idx) {
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok_det = fabsf(det) > 1e-12f;
  // 1 / det where it is used, 0 elsewhere; dividing by 1 elsewhere keeps
  // the division out of a divergent branch (same values)
  const float rcp = 1.0f / (ok_det ? det : 1.0f);
  const float inv_det = ok_det ? rcp : 0.0f;
  const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  const float b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float b2 = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  if (ok_det && b1 >= 0.f && b2 >= 0.f && b1 + b2 <= 1.f && t > r.tmin && t < r.lim) {
    r.lim = t;
    r.best = idx;
  }
}

// Lists the live rays (tmin < tmax) in live_idx, counts them in *n_live
// (zeroed before), and sets every ray's key to empty.
__global__ void __launch_bounds__(K1_ROW_THREADS)
k1_live_kernel(const float* __restrict__ rays8, int n_rays, int* __restrict__ live_idx,
               int* __restrict__ n_live, long long* __restrict__ keys) {
  const int r = blockIdx.x * K1_ROW_THREADS + threadIdx.x;
  bool live = false;
  if (r < n_rays) {
    const float2 span = reinterpret_cast<const float2*>(rays8)[4 * static_cast<size_t>(r) + 3];
    live = span.x < span.y;
    keys[r] = KEY_EMPTY;
  }
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && mask) base = atomicAdd(n_live, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (live) live_idx[base + __popc(mask & ((1u << lane) - 1u))] = r;
}

// Persistent sweep: each block takes (slice, chunk) items from *counter
// until all are done and posts each ray's best candidate with atomicMin.
__global__ void __launch_bounds__(K1_THREADS, 4)
k1_sweep_kernel(const float* __restrict__ rays8, const float* __restrict__ tris9, int t_pad,
                const int* __restrict__ live_idx, const int* __restrict__ n_live_p,
                int* __restrict__ counter, int target_items, long long* __restrict__ keys) {
  __shared__ __align__(16) float s_tri[2][9][K1_TB];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int n_live = *n_live_p;
  const int n_stages = t_pad / K1_TB;
  if (n_live == 0 || n_stages == 0) return;  // uniform
  const int n_slices = (n_live + K1_SLICE - 1) / K1_SLICE;
  const int want = min(max((target_items + n_slices - 1) / n_slices, 1), n_stages);
  const int chunk = (n_stages + want - 1) / want;  // stages per item
  const int n_chunks = (n_stages + chunk - 1) / chunk;
  const int n_items = n_slices * n_chunks;

  auto stage = [&](int buf, int s) {
    const float* src = tris9 + static_cast<size_t>(s) * K1_TB;
    for (int i = tid; i < 9 * K1_TB / 4; i += K1_THREADS) {
      const int c = i / (K1_TB / 4), q = (i % (K1_TB / 4)) * 4;
      cp_async16(&s_tri[buf][c][q], src + static_cast<size_t>(c) * t_pad + q);
    }
    cp_async_commit();
  };

  if (tid == 0) s_item = atomicAdd(counter, 1);
  __syncthreads();
  int item = s_item;
  __syncthreads();

  while (item < n_items) {
    int next = 0;
    if (tid == 0) next = atomicAdd(counter, 1);  // waited on only at the end
    const int slice = item / n_chunks;
    const int s0 = (item % n_chunks) * chunk;
    const int s1 = min(s0 + chunk, n_stages);
    stage(0, s0);  // in flight while the rays load

    K1Ray ray[K1_RPT];
    int rid[K1_RPT];
#pragma unroll
    for (int k = 0; k < K1_RPT; ++k) {
      const int i = slice * K1_SLICE + k * K1_THREADS + tid;
      rid[k] = i < n_live ? live_idx[i] : -1;
      K1Ray& r = ray[k];
      r.best = -1;
      if (rid[k] >= 0) {
        const float4 a = reinterpret_cast<const float4*>(rays8)[2 * static_cast<size_t>(rid[k])];
        const float4 b =
            reinterpret_cast<const float4*>(rays8)[2 * static_cast<size_t>(rid[k]) + 1];
        r.ox = a.x; r.oy = a.y; r.oz = a.z; r.dx = a.w; r.dy = b.x; r.dz = b.y;
        r.tmin = b.z;
        r.lim = fminf(b.w, BIG);  // a candidate must also lie below 1e30
      } else {  // no ray: an empty interval, never hit
        r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = 0.f;
        r.tmin = 0.f;
        r.lim = -1.f;
      }
    }
    const bool warp_busy = __any_sync(0xffffffffu, rid[0] >= 0);

    int buf = 0;
    for (int s = s0; s < s1; ++s) {
      if (s + 1 < s1) {
        stage(buf ^ 1, s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (warp_busy) {
        const float4* s4 = reinterpret_cast<const float4*>(&s_tri[buf][0][0]);
        constexpr int Q = K1_TB / 4;
        const int base = s * K1_TB;
#pragma unroll 2
        for (int g = 0; g < Q; ++g) {
          const float4 a0 = s4[0 * Q + g], a1 = s4[1 * Q + g], a2 = s4[2 * Q + g];
          const float4 a3 = s4[3 * Q + g], a4 = s4[4 * Q + g], a5 = s4[5 * Q + g];
          const float4 a6 = s4[6 * Q + g], a7 = s4[7 * Q + g], a8 = s4[8 * Q + g];
          const int j = base + 4 * g;
#pragma unroll
          for (int k = 0; k < K1_RPT; ++k) {
            mt_test(a0.x, a1.x, a2.x, a3.x, a4.x, a5.x, a6.x, a7.x, a8.x, ray[k], j);
            mt_test(a0.y, a1.y, a2.y, a3.y, a4.y, a5.y, a6.y, a7.y, a8.y, ray[k], j + 1);
            mt_test(a0.z, a1.z, a2.z, a3.z, a4.z, a5.z, a6.z, a7.z, a8.z, ray[k], j + 2);
            mt_test(a0.w, a1.w, a2.w, a3.w, a4.w, a5.w, a6.w, a7.w, a8.w, ray[k], j + 3);
          }
        }
      }
      __syncthreads();  // every thread is done with buf before it is restaged
      buf ^= 1;
    }

#pragma unroll
    for (int k = 0; k < K1_RPT; ++k) {
      if (ray[k].best >= 0) {
        long long* key_at = keys + rid[k];
        const long long key = pack_key(ray[k].lim, ray[k].best);
        if (key < __ldcg(key_at)) atomicMin(key_at, key);
      }
    }

    if (tid == 0) s_item = next;
    __syncthreads();
    item = s_item;
    __syncthreads();
  }
}

// Decodes each ray's least key and applies the miss rule.
__global__ void __launch_bounds__(K1_ROW_THREADS)
k1_finish_kernel(const long long* __restrict__ keys, int n_rays, int n_tris,
                 float* __restrict__ t_out, int* __restrict__ p_out) {
  const int r = blockIdx.x * K1_ROW_THREADS + threadIdx.x;
  if (r >= n_rays) return;
  const long long key = keys[r];
  float t = BIG;
  int p = -1;
  if (key != KEY_EMPTY) {
    const float tk = t_of_key(key);
    const int pk = static_cast<int>(static_cast<unsigned>(key) >> 1);
    if (pk < n_tris && tk < BIG) {
      t = tk;
      p = pk;
    }
  }
  t_out[r] = t;
  p_out[r] = p;
}

}  // namespace

// Bytes of scratch pbrt_tri_t_pass needs for n_rays rays.
extern "C" long long pbrt_tri_t_pass_scratch_bytes(int n_rays) {
  return static_cast<long long>(n_rays) * (8 + 4) + 16;
}

// rays8 [n_rays, 8] (o, d, tmin, tmax with inf replaced by 1e30);
// tris9 [9, t_pad] component-major v0/e1/e2, t_pad a multiple of 256,
// padded columns all zero (degenerate, never hit); both 16-byte aligned.
// scratch: pbrt_tri_t_pass_scratch_bytes, 8-byte aligned. Four
// operations on the stream, no host sync. Returns the first CUDA error.
extern "C" int pbrt_tri_t_pass(const float* rays8, int n_rays, const float* tris9, int t_pad,
                               int n_tris, float* t_out, int* p_out, void* scratch,
                               void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* keys = static_cast<long long*>(scratch);
  int* live_idx = reinterpret_cast<int*>(keys + n_rays);
  int* counters = live_idx + n_rays;  // [0] live rays, [1] items taken
  const int grid = resident_grid<k1_sweep_kernel>(K1_THREADS);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int row_blocks = (n_rays + K1_ROW_THREADS - 1) / K1_ROW_THREADS;
  cudaError_t err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_live_kernel<<<row_blocks, K1_ROW_THREADS, 0, s>>>(rays8, n_rays, live_idx, counters, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k1_sweep_kernel<<<grid, K1_THREADS, 0, s>>>(rays8, tris9, t_pad, live_idx, counters,
                                              counters + 1, grid * K1_ITEMS_PER_BLOCK, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k1_finish_kernel<<<row_blocks, K1_ROW_THREADS, 0, s>>>(keys, n_rays, n_tris, t_out, p_out);
  return static_cast<int>(cudaGetLastError());
}
