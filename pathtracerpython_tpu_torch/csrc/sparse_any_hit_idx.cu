// K7: cluster-sparse shadow any-hit that also reports, per lane, the first
// blocking cluster in visit order: the producer of the occluder cache.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/sparse_pallas.py
// _any_hit_idx_chunk (the pallas_call over
// _make_grouped_any_hit_idx_kernel).
//
// Input: as K6 (sparse_any_hit.cu), over one of two kinds of lists
// (kernels/sparse.py): pass 1 of the cache protocol gives each block its
// at most 8 most voted cached clusters in vote order with every bound 0
// (guess_lists); pass 2 gives the complete front-to-back lists
// (window_lists). Row b of ids/keys is n_cols wide, ncand[b] entries long.
//
// Design: K6's walk (any_hit_walk.cuh): units of kAnyHitSegment list slots
// on many CTAs, each visited cluster's rows culled by span, mid and group
// boxes on warp votes. Only the merge differs. The TPU kernel runs a
// block's slots one after the other and writes the cluster at which a lane
// first became occluded. Whether slot s blocks a lane does not depend on
// the other slots, so that cluster is the one of the smallest slot whose
// cluster passes the lane's gate and holds a blocking row. The units find
// it with atomicMin on the slot into a scratch first_slot[n] (2^31 - 1 =
// none, set by the caller): the merge FirstBlockingSlot, whose argument is
// at the top of any_hit_walk.cuh. A unit drops a lane at slot s only when
// the lane's word is below s (K6 drops it on any mark, which would let a
// later slot win here). A second small kernel on the same stream then
// turns slots into outputs: occ = a slot was found, cl = ids[block, slot]
// or -1. The result is the same in every run, and equal to the serial
// culled walk's in list order (kernels/sparse.py: any_hit_walk(...,
// cull=)); where no pair test is ill-conditioned, to the un-culled one's.
// The guess lists of pass 1 fit one unit a block slice, so there the cull
// is the whole change from a serial walk.
//
// What bounds it on an H100: as K6, the box tests and pair tests on the
// visited clusters and the copy of each visited cluster's rows and boxes
// from L2; pass 1 visits at most 8 clusters a block.
#include <cuda_runtime.h>

#include "any_hit_walk.cuh"
#include "cluster.cuh"
#include "mt.cuh"

namespace {

template <bool kCount>
__global__ void __launch_bounds__(ptt::kThreads)
sparse_any_hit_idx_kernel(const float* __restrict__ o3,
                          const float* __restrict__ d3,
                          const float* __restrict__ maxd, int n,
                          const float* __restrict__ tripack,
                          const float* __restrict__ aabb8,
                          const float* __restrict__ cull,
                          const int* __restrict__ ids,
                          const float* __restrict__ keys,
                          const int* __restrict__ ncand, int n_cols,
                          int r_blk, int* first_slot,
                          unsigned long long* __restrict__ stats) {
  __shared__ ptt::AnyHitStage<ptt::ClassicForm> stage;
  ptt::split_any_hit<ptt::ClassicForm, kCount>(
      stage, o3, d3, maxd, n, tripack, aabb8, cull, ids, keys, ncand, n_cols,
      r_blk, ptt::FirstBlockingSlot{first_slot}, stats);
}

// One thread per lane: the outputs from the lane's first blocking slot.
__global__ void __launch_bounds__(ptt::kThreads)
blocking_cluster_kernel(const int* __restrict__ first_slot, int n,
                        const int* __restrict__ ids, int n_cols, int r_blk,
                        unsigned char* __restrict__ occ_out,
                        int* __restrict__ cl_out) {
  const int lane = blockIdx.x * ptt::kThreads + threadIdx.x;
  if (lane >= n) return;
  const int slot = first_slot[lane];
  const bool blocked = slot != ptt::kNoSlot;
  occ_out[lane] = blocked;
  cl_out[lane] =
      blocked ? ids[static_cast<size_t>(lane / r_blk) * n_cols + slot] : -1;
}

}  // namespace

// o3, d3, maxd, tripack, aabb8, cull, ids, keys, ncand, n_cols, r_blk: as
// ptt_sparse_any_hit (cull: null is refused). first_slot: int32 [n]
// scratch, every element 2^31 - 1 on entry; occ_out: bool (one byte) [n];
// cl_out: int32 [n], the first blocking cluster in list order, -1 where not
// occluded; stats: null, or seven 64-bit counters (cluster.cuh:
// WalkCounter, then any_hit_walk.cuh: AnyHitCounter) that the walk adds
// to. Launches both kernels on ``stream`` of CUDA device ``device`` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_sparse_any_hit_idx(const float* o3, const float* d3,
                                      const float* maxd, int n,
                                      const float* tripack,
                                      const float* aabb8, const float* cull,
                                      const int* ids, const float* keys,
                                      const int* ncand, int n_cols, int r_blk,
                                      int* first_slot, unsigned char* occ_out,
                                      int* cl_out, unsigned long long* stats,
                                      int device, void* stream) {
  if (n <= 0 || n_cols < 1 || r_blk < 1 || cull == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = ptt::walk_grid(n, r_blk, n_cols, ptt::kAnyHitSegment);
  if (stats == nullptr)
    sparse_any_hit_idx_kernel<false><<<grid, ptt::kThreads, 0, s>>>(
        o3, d3, maxd, n, tripack, aabb8, cull, ids, keys, ncand, n_cols,
        r_blk, first_slot, stats);
  else
    sparse_any_hit_idx_kernel<true><<<grid, ptt::kThreads, 0, s>>>(
        o3, d3, maxd, n, tripack, aabb8, cull, ids, keys, ncand, n_cols,
        r_blk, first_slot, stats);
  const cudaError_t walked = cudaGetLastError();
  if (walked != cudaSuccess) return static_cast<int>(walked);
  blocking_cluster_kernel<<<(n + ptt::kThreads - 1) / ptt::kThreads,
                            ptt::kThreads, 0, s>>>(first_slot, n, ids, n_cols,
                                                   r_blk, occ_out, cl_out);
  return static_cast<int>(cudaGetLastError());
}
