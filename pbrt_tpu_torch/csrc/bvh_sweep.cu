// K2: wide-leaf pair sweep of the packet BVH t-pass.
//
// Replaces the Pallas TPU kernel pbrt_tpu/ops/bvh_pallas.py:54
// _make_sweep_kernel (pallas_call at :154 in _sweep_pairs, driven by
// wide_t_pass). For each (ray tile, leaf block) pair it runs
// Moller-Trumbore for the tile's 1024 rays against the block's 128
// triangles; per ray, the block minimum (lowest slot on ties) replaces
// the accumulator only when strictly smaller, pairs taken in the tile's
// list order. Sentinel blocks are skipped. The result must equal the
// sequential fold of wide_sweep_plain (ops/bvh_cuda.py) bit for bit.
//
// What bounds it: one test is 46 flops (pv 9, det 5, one division, tv 3,
// b1 6, qv 9, b2 6, t 6, b1+b2 1) against 36 bytes of triangle shared by
// 1024 rays, so operations: a pair of 1024 x 128 tests has a floor of
// 90 ns at 67 TFLOP/s. The kernels are built with -fmad=false and IEEE
// division, so the flops are separate instructions that round like the
// plain torch twin. At one warp instruction per scheduler per cycle that
// caps the kernel at 46 / (2 x instructions per test) of the FLOP bound:
// chip_smoke.py [2] counts 75.9 instructions per test on the division's
// fast path in this inner loop (79.4 with the slow-path call), so the
// ceiling under the contract is 30.3%.
//
// Design on Hopper. The TPU walks one sequential grid over tile-sorted
// pairs and carries each tile's accumulator from step to step. One block
// per tile looping over its run (the first port) left most SMs idle: a
// 65,536-ray traversal has 64 tiles, and a wave lasted as long as the
// longest run. Here the work is cut three ways and spread over the card:
//
// 1. Items. A work item is (tile, ray slice of 128, chunk of K2_CHUNK
//    pairs of the tile's run): 8 slices x ceil(count / 2) items per tile.
//    k2_items_kernel turns the per-tile counts into item offsets on the
//    device (no host sync), and a persistent grid of blocks (every SM,
//    as many as fit) pulls items from a device counter, fetching the
//    next item's index while it works on the current one.
// 2. Merge. Each ray's candidates from different items are merged in
//    any order through one 64-bit atomicMin on a packed key: the
//    order-preserving bits of t (-0.0 made +0.0), then the pair's
//    position in the tile's run, then the slot, then one bit that keeps
//    a -0.0. The least key is the first minimum in list order, which is
//    what the sequential strict '<' fold keeps. k2_merge_kernel then
//    replaces the accumulator when the winner's t is strictly smaller.
//    ops/bvh_cuda.py (pack_keys, merge_keys) states the same rule in
//    torch and the CPU tests hold it against the sequential fold.
// 3. Overlap. Leaf blocks (9 x 128 floats) are staged in shared memory
//    by cp.async into two buffers, the next pair's copy in flight during
//    the current pair's tests. Each thread reads 4 triangles' components
//    as one float4 (9 shared loads per 4 x 46 flops), so shared loads
//    stay far under the FP32 pipes. Warps whose rays cannot improve
//    (dead rays, t_acc = -1e30) skip the tests.
#include "common.cuh"

namespace {

using namespace pbrt_cuda;

constexpr int K2_TILE = 1024;     // rays per tile (wide_bvh.TILE)
constexpr int K2_LEAF = 128;      // triangles per leaf block (wide_bvh.LEAF_W)
constexpr int K2_THREADS = 128;   // one ray per thread
constexpr int K2_SLICES = K2_TILE / K2_THREADS;
constexpr int K2_CHUNK = 2;       // pairs per item (bvh_cuda.SWEEP_CHUNK)
constexpr int K2_SHARED_TILES = 2048;  // item offsets cached in shared memory up to this
constexpr int K2_ITEMS_THREADS = 1024;

// K2's merge key: t, then the pair's position in the run, then the slot
// (bvh_cuda.pack_keys).
__device__ __forceinline__ long long pack_key(float t, int pos, int slot) {
  return key_of_t(t) | (static_cast<long long>(pos) << 8) | (static_cast<long long>(slot) << 1);
}

// One Moller-Trumbore test, folded into the block minimum (bt, bi) with
// a strict '<': the same arithmetic, in the same order, as mt_t.
__device__ __forceinline__ void mt_fold(float v0x, float v0y, float v0z, float e1x, float e1y,
                                        float e1z, float e2x, float e2y, float e2z,
                                        const float (&ray)[8], int s, float& bt, int& bi) {
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
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
  const bool valid = ok_det && b1 >= 0.f && b2 >= 0.f && b1 + b2 <= 1.f && t > ray[6] &&
                     t < ray[7];
  if (valid && t < bt) {
    bt = t;
    bi = s;
  }
}

// item_start[t] = first item of tile t (exclusive scan of 8 * ceil(count
// / K2_CHUNK)), item_start[n_tiles] = total; zeroes the item counter.
__global__ void __launch_bounds__(K2_ITEMS_THREADS)
k2_items_kernel(const int* __restrict__ tile_count, int n_tiles, int* __restrict__ item_start,
                int* __restrict__ counter) {
  __shared__ int s_warp[K2_ITEMS_THREADS / 32];
  __shared__ int s_carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_carry = 0;
    *counter = 0;
  }
  __syncthreads();
  for (int base = 0; base < n_tiles; base += K2_ITEMS_THREADS) {
    const int t = base + tid;
    const int c = t < n_tiles ? max(tile_count[t], 0) : 0;
    const int v = K2_SLICES * ((c + K2_CHUNK - 1) / K2_CHUNK);
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    const int incl = x + (warp ? s_warp[warp - 1] : 0) + s_carry;
    if (t < n_tiles) item_start[t] = incl - v;
    __syncthreads();
    if (tid == K2_ITEMS_THREADS - 1) s_carry = incl;
    __syncthreads();
  }
  if (tid == 0) item_start[n_tiles] = s_carry;
}

// Persistent sweep: each block takes items from *counter until all are
// done and posts each ray's best candidate key with atomicMin.
__global__ void __launch_bounds__(K2_THREADS)
k2_sweep_kernel(const int* __restrict__ pair_block, const int* __restrict__ tile_start,
                const int* __restrict__ tile_count, int n_tiles,
                const float* __restrict__ rays8, const float* __restrict__ tris16, int n_cols,
                int sentinel_block, const float* __restrict__ t_acc,
                const int* __restrict__ item_start, int* __restrict__ counter,
                long long* __restrict__ keys) {
  __shared__ __align__(16) float s_tri[2][9][K2_LEAF];
  __shared__ int s_starts[K2_SHARED_TILES + 1];
  __shared__ int s_item;
  const int tid = threadIdx.x;
  const int total = item_start[n_tiles];
  if (total == 0) return;  // uniform
  const bool cached = n_tiles <= K2_SHARED_TILES;
  if (cached) {
    for (int i = tid; i <= n_tiles; i += K2_THREADS) s_starts[i] = item_start[i];
  }
  const int* starts = cached ? s_starts : item_start;
  if (tid == 0) s_item = atomicAdd(counter, 1);
  __syncthreads();
  int item = s_item;
  __syncthreads();

  while (item < total) {
    int next = 0;
    if (tid == 0) next = atomicAdd(counter, 1);  // waited on only at the end

    // tile = the last t with starts[t] <= item (tiles without items have
    // starts[t] == starts[t + 1])
    int lo = 0, hi = n_tiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (starts[mid] <= item) lo = mid; else hi = mid - 1;
    }
    const int tile = lo;
    const int local = item - starts[tile];
    const int slice = local % K2_SLICES;
    const int j0 = (local / K2_SLICES) * K2_CHUNK;
    const int start = tile_start[tile];
    const int j1 = min(j0 + K2_CHUNK, tile_count[tile]);
    auto next_real = [&](int j) {
      while (j < j1 && pair_block[start + j] == sentinel_block) ++j;
      return j;
    };
    auto stage = [&](int buf, int b) {
      const float* src = tris16 + static_cast<size_t>(b) * K2_LEAF;
      for (int i = tid; i < 9 * K2_LEAF / 4; i += K2_THREADS) {
        const int c = i / (K2_LEAF / 4), q = (i % (K2_LEAF / 4)) * 4;
        cp_async16(&s_tri[buf][c][q], src + static_cast<size_t>(c) * n_cols + q);
      }
      cp_async_commit();
    };

    int j = next_real(j0);
    if (j < j1) stage(0, pair_block[start + j]);

    const size_t r = static_cast<size_t>(tile) * K2_TILE + slice * K2_THREADS + tid;
    const float4 ra = reinterpret_cast<const float4*>(rays8)[2 * r];
    const float4 rb = reinterpret_cast<const float4*>(rays8)[2 * r + 1];
    const float ray[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
    const float acc0 = t_acc[r];
    // a candidate is a hit in (tmin, tmax) below 1e30, or 1e30 itself;
    // it can win only if its t < acc0 (false for NaN and dead rays)
    const bool live = acc0 > ray[6] || acc0 > BIG;
    if (!__syncthreads_or(live)) {  // uniform: nothing in this slice can change
      cp_async_wait<0>();           // the staged copy lands before buf 0 is reused
      j = j1;
    }

    float best_t = 0.f;
    int best_pos = -1, best_slot = 0;
    int buf = 0;
    while (j < j1) {
      const int jn = next_real(j + 1);
      if (jn < j1) {
        stage(buf ^ 1, pair_block[start + jn]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float bt = BIG;
      int bi = 0;
      if (__any_sync(0xffffffffu, live)) {
        const float4* s4 = reinterpret_cast<const float4*>(&s_tri[buf][0][0]);
        constexpr int Q = K2_LEAF / 4;
#pragma unroll 2
        for (int g = 0; g < Q; ++g) {
          const float4 a0 = s4[0 * Q + g], a1 = s4[1 * Q + g], a2 = s4[2 * Q + g];
          const float4 a3 = s4[3 * Q + g], a4 = s4[4 * Q + g], a5 = s4[5 * Q + g];
          const float4 a6 = s4[6 * Q + g], a7 = s4[7 * Q + g], a8 = s4[8 * Q + g];
          const int s = 4 * g;
          mt_fold(a0.x, a1.x, a2.x, a3.x, a4.x, a5.x, a6.x, a7.x, a8.x, ray, s, bt, bi);
          mt_fold(a0.y, a1.y, a2.y, a3.y, a4.y, a5.y, a6.y, a7.y, a8.y, ray, s + 1, bt, bi);
          mt_fold(a0.z, a1.z, a2.z, a3.z, a4.z, a5.z, a6.z, a7.z, a8.z, ray, s + 2, bt, bi);
          mt_fold(a0.w, a1.w, a2.w, a3.w, a4.w, a5.w, a6.w, a7.w, a8.w, ray, s + 3, bt, bi);
        }
      }
      // within the item, pairs fold in list order with a strict '<'
      if (best_pos < 0 || bt < best_t) {
        best_t = bt;
        best_pos = j;
        best_slot = bi;
      }
      __syncthreads();  // every thread is done with buf before it is restaged
      buf ^= 1;
      j = jn;
    }

    if (best_pos >= 0 && live && best_t < acc0) {
      const long long key = pack_key(best_t, best_pos, best_slot);
      if (key < __ldcg(keys + r)) atomicMin(keys + r, key);
    }

    if (tid == 0) s_item = next;
    __syncthreads();
    item = s_item;
    __syncthreads();
  }
}

// The merge rule: the least key's candidate replaces the accumulator
// when its t is strictly smaller (ops/bvh_cuda.py merge_keys).
__global__ void k2_merge_kernel(const long long* __restrict__ keys,
                                const int* __restrict__ pair_block,
                                const int* __restrict__ tile_start, int n_rays,
                                float* __restrict__ t_acc, int* __restrict__ p_acc) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const long long key = keys[r];
  if (key == KEY_EMPTY) return;
  const float t = t_of_key(key);
  const unsigned lo = static_cast<unsigned>(key);
  if (t < t_acc[r]) {
    const int pos = static_cast<int>(lo >> 8), slot = static_cast<int>((lo >> 1) & 127u);
    t_acc[r] = t;
    p_acc[r] = pair_block[tile_start[r / K2_TILE] + pos] * K2_LEAF + slot;
  }
}

}  // namespace

// Bytes of scratch pbrt_wide_sweep needs for n_tiles tiles.
extern "C" long long pbrt_wide_sweep_scratch_bytes(int n_tiles) {
  return static_cast<long long>(n_tiles) * K2_TILE * 8 + (static_cast<long long>(n_tiles) + 2) * 4;
}

// pair_block [n_pairs] leaf-block ids, grouped by tile in list order;
// tile_start/tile_count [n_tiles] each tile's run in pair_block (runs of
// fewer than 2^24 pairs); rays8 [n_tiles * 1024, 8]; tris16 [16, n_cols]
// component-major (rows 0-8 = v0, e1, e2); t_acc/p_acc [n_tiles * 1024]
// read and updated in place; scratch: pbrt_wide_sweep_scratch_bytes,
// 16-byte aligned. Four operations on the stream, no host sync. Returns
// the first CUDA error.
extern "C" int pbrt_wide_sweep(const int* pair_block, const int* tile_start,
                               const int* tile_count, int n_tiles,
                               const float* rays8, const float* tris16, int n_cols,
                               int sentinel_block, float* t_acc, int* p_acc, void* scratch,
                               void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rays = n_tiles * K2_TILE;
  long long* keys = static_cast<long long*>(scratch);
  int* item_start = reinterpret_cast<int*>(keys + n_rays);
  int* counter = item_start + n_tiles + 1;
  const int grid = resident_grid<k2_sweep_kernel>(K2_THREADS);
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaMemsetAsync(keys, 0x7F, static_cast<size_t>(n_rays) * 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2_items_kernel<<<1, K2_ITEMS_THREADS, 0, s>>>(tile_count, n_tiles, item_start, counter);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k2_sweep_kernel<<<grid, K2_THREADS, 0, s>>>(pair_block, tile_start, tile_count, n_tiles, rays8,
                                               tris16, n_cols, sentinel_block, t_acc,
                                               item_start, counter, keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  k2_merge_kernel<<<(n_rays + 255) / 256, 256, 0, s>>>(keys, pair_block, tile_start, n_rays,
                                                      t_acc, p_acc);
  return static_cast<int>(cudaGetLastError());
}
