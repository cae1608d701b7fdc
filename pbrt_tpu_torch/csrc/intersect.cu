// K1: flat closest-hit t-pass, every ray against every triangle.
//
// Replaces the Pallas TPU kernel pbrt_tpu/ops/intersect_pallas.py
// _tri_kernel (launched by _tri_t_pass, wrapper tri_t_pass_pallas).
// It computes the same thing: Moller-Trumbore with |det| > 1e-12,
// b1, b2 >= 0, b1 + b2 <= 1, tmin < t < tmax, and a running per-ray
// (min t, argmin prim). A strict '<' in triangle-index order gives the
// lowest index on ties, as the Pallas block-min-then-fold does. A miss
// returns (1e30, -1).
//
// What bounds it on an H100: arithmetic. Each ray-triangle test is
// ~40 flops on 9 triangle floats that every ray of the block shares, so
// the triangle table is staged once per 256-triangle block in shared
// memory (9 KB) and read back as warp-wide broadcasts; a ray's state
// (8 floats + best t/prim) stays in registers for the whole scan. The
// TPU kernel's sequential grid axis over triangle blocks becomes the
// loop inside each thread block; nothing is carried between blocks.
//
// Built with -fmad=false and without fast math, so every multiply and
// add rounds like the plain torch version in ops/intersect_cuda.py.
#include <cuda_runtime.h>

namespace {

constexpr int K1_THREADS = 256;  // rays per thread block
constexpr int K1_TB = 256;       // triangles per shared-memory stage
constexpr float K1_BIG = 1e30f;

__global__ void __launch_bounds__(K1_THREADS)
tri_t_pass_kernel(const float* __restrict__ rays8, int n_rays,
                  const float* __restrict__ tris9, int t_pad, int n_tris,
                  float* __restrict__ t_out, int* __restrict__ p_out) {
  __shared__ float s_tri[9][K1_TB];
  const int r = blockIdx.x * K1_THREADS + threadIdx.x;
  const bool live = r < n_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tmax = 0.f;
  if (live) {
    const float* ray = rays8 + static_cast<size_t>(r) * 8;
    ox = ray[0]; oy = ray[1]; oz = ray[2];
    dx = ray[3]; dy = ray[4]; dz = ray[5];
    tmin = ray[6]; tmax = ray[7];
  }
  float best = K1_BIG;
  int best_i = -1;
  for (int base = 0; base < t_pad; base += K1_TB) {
    __syncthreads();
    for (int k = threadIdx.x; k < 9 * K1_TB; k += K1_THREADS) {
      const int c = k / K1_TB, j = k % K1_TB;
      s_tri[c][j] = tris9[static_cast<size_t>(c) * t_pad + base + j];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < K1_TB; ++j) {
      const float v0x = s_tri[0][j], v0y = s_tri[1][j], v0z = s_tri[2][j];
      const float e1x = s_tri[3][j], e1y = s_tri[4][j], e1z = s_tri[5][j];
      const float e2x = s_tri[6][j], e2y = s_tri[7][j], e2z = s_tri[8][j];
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool ok_det = fabsf(det) > 1e-12f;
      const float inv_det = ok_det ? 1.0f / det : 0.0f;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float b2 = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
      const bool valid = ok_det && b1 >= 0.f && b2 >= 0.f && b1 + b2 <= 1.f &&
                         t > tmin && t < tmax;
      if (valid && t < best) {
        best = t;
        best_i = base + j;
      }
    }
  }
  if (live) {
    const bool miss = best_i < 0 || best_i >= n_tris || best >= K1_BIG;
    t_out[r] = miss ? K1_BIG : best;
    p_out[r] = miss ? -1 : best_i;
  }
}

}  // namespace

// rays8 [n_rays, 8] (o, d, tmin, tmax with inf replaced by 1e30);
// tris9 [9, t_pad] component-major v0/e1/e2, t_pad a multiple of 256,
// padded columns all zero (degenerate, never hit). Returns
// cudaGetLastError() after the launch.
extern "C" int pbrt_tri_t_pass(const float* rays8, int n_rays, const float* tris9,
                               int t_pad, int n_tris, float* t_out, int* p_out,
                               void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + K1_THREADS - 1) / K1_THREADS;
    tri_t_pass_kernel<<<blocks, K1_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        rays8, n_rays, tris9, t_pad, n_tris, t_out, p_out);
  }
  return static_cast<int>(cudaGetLastError());
}
