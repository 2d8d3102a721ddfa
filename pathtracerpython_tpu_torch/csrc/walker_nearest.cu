// K8: walker nearest hit: each warp walks its ray block's front-to-back
// candidate clusters and stops on its own rays.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/walker_pallas.py
// _nearest_chunk (the pallas_call over _make_walker_kernel(any_hit=False)).
//
// Input: blocks of r_blk rays, and per block the clusters (128 triangles
// each) any of its rays can touch, sorted by a conservative block-level
// entry bound (kernels/walker.py: nearest_lists). Row b of ids/keys (n_cols
// wide) holds block b's list, ncand[b] entries long; the lists are
// complete, so there is no overflow and no fallback.
//
// Design: what it computes is K5's function (sparse_nearest.cu) on the
// walker's lists: the lexicographic (t, global index) minimum, ties to the
// smaller index, t = 0 and index -1 on a miss. The TPU kernel walks one
// list per 1280-ray block, every lane paying for every visited cluster,
// and stops the whole block's walk in 19-bit key words. Here a warp of 32
// consecutive (sorted, hence coherent) rays walks the block's list by
// itself: no shared memory, no barrier, and the stop is per warp, on the
// worst best-t of its own 32 rays, compared in floats (exact, see
// cluster.cuh), so a warp that has found its hits leaves the list long
// before the block's least coherent rays do. Per slot each ray runs its
// own slab test; the rays that need the cluster (box hit, entry < best t +
// SLAB_EPS) read its 128 packed rows straight from global memory, 48 bytes
// a row as three 16-byte loads at an address the whole warp shares (one
// broadcast transaction, served by L1 and L2: neighbouring warps walk the
// same list), and run Möller–Trumbore (mt.cuh) on them. The gate follows
// _slab_rows_inv term for term and is conservative, and the merge does not
// depend on the visiting order, so the winner is the dense K1's.
//
// What bounds it on an H100: arithmetic on the visited clusters plus the
// row loads, which no shared-memory staging amortizes over a CTA here;
// against that stands the shorter walk of each warp.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

__global__ void __launch_bounds__(ptt::kThreads)
walker_nearest_kernel(const float* __restrict__ o3,
                      const float* __restrict__ d3, int n,
                      const float* __restrict__ tripack,
                      const float* __restrict__ aabb8,
                      const int* __restrict__ ids,
                      const float* __restrict__ keys,
                      const int* __restrict__ ncand, int n_cols, int r_blk,
                      float* __restrict__ t_out, int* __restrict__ idx_out) {
  // every thread of a CTA, hence of a warp, is in the same ray block
  const ptt::BlockSlice me = ptt::block_slice(r_blk, n);
  const size_t stride = static_cast<size_t>(n);
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (me.live) {
    ox = o3[me.lane];
    oy = o3[stride + me.lane];
    oz = o3[2 * stride + me.lane];
    dx = d3[me.lane];
    dy = d3[stride + me.lane];
    dz = d3[2 * stride + me.lane];
  }
  const ptt::SlabRay ray = ptt::make_slab_ray(ox, oy, oz, dx, dy, dz);
  float best_t = ptt::kBig;
  int best_idx = -1;

  const int count = ncand[me.block];
  const size_t row = static_cast<size_t>(me.block) * n_cols;
  const float4* pack4 = reinterpret_cast<const float4*>(tripack);
  for (int s = 0; s < count; ++s) {
    // the warp's stop: no ray of it can use this or any later cluster
    if (!__any_sync(kFullWarp,
                    me.live && keys[row + s] <= best_t + ptt::kSlabEps))
      break;
    const int cl = ids[row + s];
    float enter;
    if (me.live && ptt::slab_hit(aabb8 + cl * ptt::kAabbCols, ray, enter) &&
        enter < best_t + ptt::kSlabEps) {
      const int base = cl * ptt::kClusterTris;
      const float4* rows = pack4 + static_cast<size_t>(base) * 3;
      for (int j = 0; j < ptt::kClusterTris; ++j) {
        // v0.xyz v1.x | v1.yz v2.xy | v2.z valid occluder 0
        const float4 a = __ldg(rows + 3 * j);
        const float4 b = __ldg(rows + 3 * j + 1);
        const float4 c = __ldg(rows + 3 * j + 2);
        float t;
        if (c.y > 0.5f &&
            ptt::mt_core(a.x, a.y, a.z, a.w - a.x, b.x - a.y, b.y - a.z,
                         b.z - a.x, b.w - a.y, c.x - a.z, ox, oy, oz, dx, dy,
                         dz, t) &&
            (t < best_t || (t == best_t && base + j < best_idx))) {
          best_t = t;
          best_idx = base + j;
        }
      }
    }
  }
  if (me.live) {
    t_out[me.lane] = best_idx >= 0 ? best_t : 0.0f;
    idx_out[me.lane] = best_idx;
  }
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); tripack: float32 [C * 128, 12],
// 16-byte aligned; aabb8: float32 [C, 8]; ids: int32 [ceil(n / r_blk),
// n_cols] and keys: float32 [ceil(n / r_blk), n_cols], row b holding block
// b's clusters and their entry bounds front to back; ncand: int32
// [ceil(n / r_blk)]; t_out: float32 [n]; idx_out: int32 [n]. Launches on
// ``stream`` of CUDA device ``device`` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int ptt_walker_nearest(const float* o3, const float* d3, int n,
                                  const float* tripack, const float* aabb8,
                                  const int* ids, const float* keys,
                                  const int* ncand, int n_cols, int r_blk,
                                  float* t_out, int* idx_out, int device,
                                  void* stream) {
  if (n <= 0 || n_cols < 1 || r_blk < 1 ||
      reinterpret_cast<size_t>(tripack) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  walker_nearest_kernel<<<ptt::slice_ctas(n, r_blk), ptt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      o3, d3, n, tripack, aabb8, ids, keys, ncand, n_cols, r_blk, t_out,
      idx_out);
  return static_cast<int>(cudaGetLastError());
}
