// K2: wide-leaf pair sweep of the packet BVH t-pass.
//
// Replaces the Pallas TPU kernel pbrt_tpu/ops/bvh_pallas.py
// _make_sweep_kernel (launched by _sweep_pairs, driven by wide_t_pass).
// For each (ray tile, leaf block) pair it runs Moller-Trumbore for the
// tile's 1024 rays against the block's 128 triangles and folds the
// per-ray (min t, slot) into the tile's accumulators: the block minimum
// (lowest slot on ties) replaces the accumulator only when strictly
// smaller, pairs taken in list order. Sentinel blocks are skipped.
//
// Design on Hopper: the TPU walks one sequential grid over tile-sorted
// pairs and carries a tile's accumulator from step to step. Here each
// ray tile gets one thread block that loops over its own contiguous
// run of pairs [tile_start, tile_start + tile_count) in list order, so
// the accumulators live in registers for the whole run: no atomics and
// no traffic between blocks. The leaf block (9 x 128 floats, 4.5 KB) is
// staged in shared memory and read back as broadcasts; each thread
// keeps 4 rays so every staged triangle is reused 4 times from
// registers.
//
// What bounds it: arithmetic (~40 flops per ray-triangle test against
// 36 bytes of triangle per 1024 rays), plus the load imbalance between
// tiles with long and short pair runs; tiles with no pairs exit at once.
//
// Built with -fmad=false and without fast math, so every multiply and
// add rounds like the plain torch version in ops/bvh_cuda.py.
#include <cuda_runtime.h>

namespace {

constexpr int K2_TILE = 1024;   // rays per tile (wide_bvh.TILE)
constexpr int K2_LEAF = 128;    // triangles per leaf block (wide_bvh.LEAF_W)
constexpr int K2_THREADS = 256;
constexpr int K2_RPT = K2_TILE / K2_THREADS;  // rays per thread
constexpr float K2_BIG = 1e30f;

__global__ void __launch_bounds__(K2_THREADS)
wide_sweep_kernel(const int* __restrict__ pair_block,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count,
                  const float* __restrict__ rays8,
                  const float* __restrict__ tris16, int n_cols,
                  int sentinel_block,
                  float* __restrict__ t_acc, int* __restrict__ p_acc) {
  __shared__ float s_tri[9][K2_LEAF];
  const int tile = blockIdx.x;
  const int count = tile_count[tile];
  if (count <= 0) return;  // uniform across the block
  const int start = tile_start[tile];

  float ox[K2_RPT], oy[K2_RPT], oz[K2_RPT], dx[K2_RPT], dy[K2_RPT], dz[K2_RPT];
  float tmin[K2_RPT], tmax[K2_RPT], acc_t[K2_RPT];
  int acc_p[K2_RPT];
#pragma unroll
  for (int k = 0; k < K2_RPT; ++k) {
    const size_t r = static_cast<size_t>(tile) * K2_TILE + threadIdx.x + k * K2_THREADS;
    const float* ray = rays8 + r * 8;
    ox[k] = ray[0]; oy[k] = ray[1]; oz[k] = ray[2];
    dx[k] = ray[3]; dy[k] = ray[4]; dz[k] = ray[5];
    tmin[k] = ray[6]; tmax[k] = ray[7];
    acc_t[k] = t_acc[r];
    acc_p[k] = p_acc[r];
  }

  for (int j = 0; j < count; ++j) {
    const int b = pair_block[start + j];
    if (b == sentinel_block) continue;  // uniform across the block
    __syncthreads();
    for (int i = threadIdx.x; i < 9 * K2_LEAF; i += K2_THREADS) {
      const int c = i / K2_LEAF, s = i % K2_LEAF;
      s_tri[c][s] = tris16[static_cast<size_t>(c) * n_cols +
                           static_cast<size_t>(b) * K2_LEAF + s];
    }
    __syncthreads();

    float bt[K2_RPT];
    int bi[K2_RPT];
#pragma unroll
    for (int k = 0; k < K2_RPT; ++k) { bt[k] = K2_BIG; bi[k] = 0; }
    for (int s = 0; s < K2_LEAF; ++s) {
      const float v0x = s_tri[0][s], v0y = s_tri[1][s], v0z = s_tri[2][s];
      const float e1x = s_tri[3][s], e1y = s_tri[4][s], e1z = s_tri[5][s];
      const float e2x = s_tri[6][s], e2y = s_tri[7][s], e2z = s_tri[8][s];
#pragma unroll
      for (int k = 0; k < K2_RPT; ++k) {
        const float pvx = dy[k] * e2z - dz[k] * e2y;
        const float pvy = dz[k] * e2x - dx[k] * e2z;
        const float pvz = dx[k] * e2y - dy[k] * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const bool ok_det = fabsf(det) > 1e-12f;
        const float inv_det = ok_det ? 1.0f / det : 0.0f;
        const float tvx = ox[k] - v0x, tvy = oy[k] - v0y, tvz = oz[k] - v0z;
        const float b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float b2 = (dx[k] * qvx + dy[k] * qvy + dz[k] * qvz) * inv_det;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        const bool valid = ok_det && b1 >= 0.f && b2 >= 0.f && b1 + b2 <= 1.f &&
                           t > tmin[k] && t < tmax[k];
        if (valid && t < bt[k]) {
          bt[k] = t;
          bi[k] = s;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K2_RPT; ++k) {
      if (bt[k] < acc_t[k]) {
        acc_t[k] = bt[k];
        acc_p[k] = b * K2_LEAF + bi[k];
      }
    }
  }

#pragma unroll
  for (int k = 0; k < K2_RPT; ++k) {
    const size_t r = static_cast<size_t>(tile) * K2_TILE + threadIdx.x + k * K2_THREADS;
    t_acc[r] = acc_t[k];
    p_acc[r] = acc_p[k];
  }
}

}  // namespace

// pair_block [n_pairs] leaf-block ids, grouped by tile in list order;
// tile_start/tile_count [n_tiles] each tile's run in pair_block;
// rays8 [n_tiles * 1024, 8]; tris16 [16, n_cols] component-major
// (rows 0-8 = v0, e1, e2); t_acc/p_acc [n_tiles * 1024] read and
// updated in place. Returns cudaGetLastError() after the launch.
extern "C" int pbrt_wide_sweep(const int* pair_block, const int* tile_start,
                               const int* tile_count, int n_tiles,
                               const float* rays8, const float* tris16, int n_cols,
                               int sentinel_block, float* t_acc, int* p_acc,
                               void* stream) {
  if (n_tiles > 0) {
    wide_sweep_kernel<<<n_tiles, K2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        pair_block, tile_start, tile_count, rays8, tris16, n_cols, sentinel_block,
        t_acc, p_acc);
  }
  return static_cast<int>(cudaGetLastError());
}
