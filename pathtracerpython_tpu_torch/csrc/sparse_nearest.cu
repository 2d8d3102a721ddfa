// K5 and K3's cluster-sparse nearest sweep: nearest hit over each ray
// block's front-to-back candidate clusters, in the classic form (K5) and in
// the Plücker form (K3, plucker.cuh: the staged rows are the 36-column
// Plücker pack's, 18 KB a cluster and buffer); the form is the kernel's
// template parameter, the walk and the merge are the same, so the Plücker
// walk gives the dense Plücker sweep's bits.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/sparse_pallas.py
// _nearest_chunk (the pallas_call over _make_grouped_nearest_kernel, and
// the ungrouped _sparse_nearest_kernel; under MT_IMPL = "plucker" over
// _make_grouped_nearest_kernel_plucker).
//
// Input: a ray block of r_blk rays shares one list of clusters (128
// triangles each), the clusters any ray of the block can touch, sorted by a
// conservative block-level entry bound (kernels/sparse.py builds it in
// PyTorch): row b of ids/keys holds block b's list, ncand[b] entries long.
// The lists are complete, so there is no overflow and no fallback.
//
// Design: one CTA of 256 threads owns a slice of one block, one ray per
// thread, its running (t, index) in registers. The CTA walks the block's
// list front to back with the clusters' packed rows double-buffered in
// shared memory: while the threads test cluster s, cp.async brings cluster
// s+1. For each cluster a thread runs the slab test of its own ray against
// the cluster's AABB; the ray needs the cluster when the box is hit and its
// entry is below the ray's best t + SLAB_EPS, and only then runs
// Möller–Trumbore (mt.cuh) over the 128 rows. The walk stops once no ray of
// the CTA can use the next cluster: its block bound exceeds every ray's
// best t + SLAB_EPS (exact, see cluster.cuh). The merge is the
// lexicographic (t, global index) minimum, so the order in which clusters
// are visited cannot change the winner, which is the dense K1's (strict <
// in ascending index). A block with no candidates writes a miss: t = 0,
// index -1.
//
// What bounds it on an H100: arithmetic, as for K1, but only on the
// clusters a ray's own slab test lets through, plus one 6 KB copy from L2
// per visited cluster and CTA, shared by its 256 rays. The per-lane gate is
// conservative (SLAB_EPS), which is what keeps the result equal to K1's.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"
#include "plucker.cuh"

namespace {

template <class Form>
__global__ void __launch_bounds__(ptt::kThreads)
sparse_nearest_kernel(const float* __restrict__ o3,
                      const float* __restrict__ d3, int n,
                      const float* __restrict__ tripack,
                      const float* __restrict__ aabb8, int n_clusters,
                      const int* __restrict__ ids,
                      const float* __restrict__ keys,
                      const int* __restrict__ ncand, int r_blk,
                      float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ __align__(16) float buf[2][ptt::kClusterTris * Form::kCols];
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
  const typename Form::Ray pair_ray = Form::make_ray(ox, oy, oz, dx, dy, dz);
  float best_t = ptt::kBig;
  int best_idx = -1;

  const int count = ncand[me.block];
  const size_t row = static_cast<size_t>(me.block) * n_clusters;
  if (count > 0) ptt::stage_cluster<Form::kCols>(buf[0], tripack, ids[row]);
  int cur = 0;
  for (int s = 0; s < count; ++s) {
    const int cl = ids[row + s];
    ptt::wait_staged();
    // whole-walk stop; the barrier also completes buf[cur] and frees
    // buf[cur ^ 1], read in the previous step
    if (!__syncthreads_or(me.live && keys[row + s] <= best_t + ptt::kSlabEps))
      break;
    if (s + 1 < count)
      ptt::stage_cluster<Form::kCols>(buf[cur ^ 1], tripack,
                                      ids[row + s + 1]);
    float enter;
    if (me.live && ptt::slab_hit(aabb8 + cl * ptt::kAabbCols, ray, enter) &&
        enter < best_t + ptt::kSlabEps) {
      const int base = cl * ptt::kClusterTris;
      const float* tile = buf[cur];
      for (int j = 0; j < ptt::kClusterTris; ++j) {
        const float* p = tile + j * Form::kCols;
        float t;
        if (p[Form::kValid] > 0.5f && Form::hit_row(p, pair_ray, t) &&
            (t < best_t || (t == best_t && base + j < best_idx))) {
          best_t = t;
          best_idx = base + j;
        }
      }
    }
    cur ^= 1;
  }
  ptt::wait_staged();  // no copy left in flight
  if (me.live) {
    t_out[me.lane] = best_idx >= 0 ? best_t : 0.0f;
    idx_out[me.lane] = best_idx;
  }
}

template <class Form>
int launch_sparse_nearest(const float* o3, const float* d3, int n,
                          const float* pack, const float* aabb8,
                          int n_clusters, const int* ids, const float* keys,
                          const int* ncand, int r_blk, float* t_out,
                          int* idx_out, int device, void* stream) {
  if (n <= 0 || n_clusters < 1 || r_blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  sparse_nearest_kernel<Form><<<ptt::slice_ctas(n, r_blk), ptt::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      o3, d3, n, pack, aabb8, n_clusters, ids, keys, ncand, r_blk, t_out,
      idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); tripack: float32 [C * 128, 12];
// aabb8: float32 [C, 8]; ids: int32 [ceil(n / r_blk), C] and keys: float32
// [ceil(n / r_blk), C], row b holding block b's clusters and their entry
// bounds front to back; ncand: int32 [ceil(n / r_blk)]; t_out: float32 [n];
// idx_out: int32 [n]. Launches on ``stream`` of CUDA device ``device`` and
// returns cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_sparse_nearest(const float* o3, const float* d3, int n,
                                  const float* tripack, const float* aabb8,
                                  int n_clusters, const int* ids,
                                  const float* keys, const int* ncand,
                                  int r_blk, float* t_out, int* idx_out,
                                  int device, void* stream) {
  return launch_sparse_nearest<ptt::ClassicForm>(
      o3, d3, n, tripack, aabb8, n_clusters, ids, keys, ncand, r_blk, t_out,
      idx_out, device, stream);
}

// The same in the Plücker form; pack36: float32 [C * 128, 36], 16-byte
// aligned (kernels/intersect.py: plucker_pack of the padded pack). The
// clusters, their AABBs and the lists are the classic pack's.
extern "C" int ptt_plucker_sparse_nearest(
    const float* o3, const float* d3, int n, const float* pack36,
    const float* aabb8, int n_clusters, const int* ids, const float* keys,
    const int* ncand, int r_blk, float* t_out, int* idx_out, int device,
    void* stream) {
  return launch_sparse_nearest<ptt::PluckerForm>(
      o3, d3, n, pack36, aabb8, n_clusters, ids, keys, ncand, r_blk, t_out,
      idx_out, device, stream);
}
