// K6 and K3's cluster-sparse any-hit: shadow any-hit over each ray block's
// candidate clusters, in the classic form (K6) and in the Plücker form (K3,
// plucker.cuh: the staged rows are the 36-column Plücker pack's); the form
// is the kernel's template parameter, the walk is the same.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/sparse_pallas.py
// _any_hit_chunk (the pallas_call over _make_grouped_any_hit_kernel, and the
// ungrouped _sparse_any_hit_kernel; under MT_IMPL = "plucker" over
// _make_grouped_any_hit_kernel_plucker).
//
// Input: blocks of r_blk shadow rays, each with its maximum distance maxd,
// and per block the clusters any of its rays can touch within the block's
// largest maxd, sorted by a conservative block-level entry bound
// (kernels/sparse.py: window_lists). Row b of ids/keys (n_cols wide) holds
// block b's list, ncand[b] entries long. The lists are complete: no
// overflow, no fallback.
//
// Design: the split any-hit walk with the in-cluster box cull
// (any_hit_walk.cuh, shared with K9 and K7): units of kAnyHitSegment list
// slots on many CTAs, merged per lane by its occlusion mark, each visited
// cluster's rows culled by span, mid and group boxes on warp votes. The TPU
// kernel is one sequential grid over (ray block, cluster group) work items
// and tests every row of a cluster it visits.
//
// What bounds it on an H100: the box tests and pair tests on the visited
// clusters, and a 6 KB (18 KB Plücker) copy of rows plus 2.7 KB of boxes
// from L2 per visited cluster and CTA, shared by its 256 rays.
#include <cuda_runtime.h>

#include "any_hit_walk.cuh"
#include "cluster.cuh"
#include "mt.cuh"
#include "plucker.cuh"

namespace {

template <class Form, bool kCount>
__global__ void __launch_bounds__(ptt::kThreads)
sparse_any_hit_kernel(const float* __restrict__ o3,
                      const float* __restrict__ d3,
                      const float* __restrict__ maxd, int n,
                      const float* __restrict__ pack,
                      const float* __restrict__ aabb8,
                      const float* __restrict__ cull,
                      const int* __restrict__ ids,
                      const float* __restrict__ keys,
                      const int* __restrict__ ncand, int n_cols, int r_blk,
                      unsigned char* occ,
                      unsigned long long* __restrict__ stats) {
  __shared__ ptt::AnyHitStage<Form> stage;
  ptt::split_any_hit<Form, kCount>(stage, o3, d3, maxd, n, pack, aabb8, cull,
                                   ids, keys, ncand, n_cols, r_blk,
                                   ptt::OcclusionMarks{occ}, stats);
}

template <class Form>
int launch_sparse_any_hit(const float* o3, const float* d3, const float* maxd,
                          int n, const float* pack, const float* aabb8,
                          const float* cull, const int* ids, const float* keys,
                          const int* ncand, int n_cols, int r_blk,
                          unsigned char* occ, unsigned long long* stats,
                          int device, void* stream) {
  if (n <= 0 || n_cols < 1 || r_blk < 1 || cull == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid = ptt::walk_grid(n, r_blk, n_cols, ptt::kAnyHitSegment);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats == nullptr)
    sparse_any_hit_kernel<Form, false><<<grid, ptt::kThreads, 0, st>>>(
        o3, d3, maxd, n, pack, aabb8, cull, ids, keys, ncand, n_cols, r_blk,
        occ, stats);
  else
    sparse_any_hit_kernel<Form, true><<<grid, ptt::kThreads, 0, st>>>(
        o3, d3, maxd, n, pack, aabb8, cull, ids, keys, ncand, n_cols, r_blk,
        occ, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); maxd: float32 [n];
// tripack: float32 [C * 128, 12]; aabb8: float32 [C, 8]; cull: float32
// [C, 84, 8], each cluster's span, mid and group boxes (kernels/sparse.py:
// cluster_cull_boxes; null is refused); ids: int32 [ceil(n / r_blk),
// n_cols] and keys: float32 [ceil(n / r_blk), n_cols], row b holding block
// b's clusters and their entry bounds front to back; ncand: int32
// [ceil(n / r_blk)]; occ: bool (one byte) [n], zeroed by the caller; stats:
// null, or seven 64-bit counters (cluster.cuh: WalkCounter, then
// any_hit_walk.cuh: AnyHitCounter) that the launch adds to. Launches on
// ``stream`` of CUDA device ``device`` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int ptt_sparse_any_hit(const float* o3, const float* d3,
                                  const float* maxd, int n,
                                  const float* tripack, const float* aabb8,
                                  const float* cull, const int* ids,
                                  const float* keys, const int* ncand,
                                  int n_cols, int r_blk, unsigned char* occ,
                                  unsigned long long* stats, int device,
                                  void* stream) {
  return launch_sparse_any_hit<ptt::ClassicForm>(
      o3, d3, maxd, n, tripack, aabb8, cull, ids, keys, ncand, n_cols, r_blk,
      occ, stats, device, stream);
}

// The same in the Plücker form; pack36: float32 [C * 128, 36], 16-byte
// aligned (kernels/intersect.py: plucker_pack of the padded pack). The
// clusters, their boxes and the lists are the classic pack's.
extern "C" int ptt_plucker_sparse_any_hit(
    const float* o3, const float* d3, const float* maxd, int n,
    const float* pack36, const float* aabb8, const float* cull,
    const int* ids, const float* keys, const int* ncand, int n_cols,
    int r_blk, unsigned char* occ, unsigned long long* stats, int device,
    void* stream) {
  return launch_sparse_any_hit<ptt::PluckerForm>(
      o3, d3, maxd, n, pack36, aabb8, cull, ids, keys, ncand, n_cols, r_blk,
      occ, stats, device, stream);
}
