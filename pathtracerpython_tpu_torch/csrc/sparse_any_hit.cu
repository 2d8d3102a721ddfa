// K6 and K3's cluster-sparse any-hit: shadow any-hit over each ray block's
// candidate clusters, the slots of a block's list taken in parallel, in the
// classic form (K6) and in the Plücker form (K3, plucker.cuh: the staged
// rows are the 36-column Plücker pack's); the form is the kernel's template
// parameter, the walk is the same.
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
// overflow, no fallback. A ray is occluded by a valid occluder triangle
// (pack column 10) with a forward hit at t < maxd - 1e-4.
//
// Design: the TPU kernel is one sequential grid over (ray block, cluster
// group) work items. Occlusion is an OR over the items of a block, so on
// this card they run in parallel: the grid is (slices of ray blocks) x
// kSlotLanes, and CTA (slice, y) of 256 threads, one ray per thread, takes
// the list slots y, y + kSlotLanes, y + 2 kSlotLanes, ... of its block,
// with the clusters' packed rows double-buffered in shared memory by
// cp.async as in K5 and K9. A block with a 782-cluster list is so spread
// over kSlotLanes CTAs per slice instead of one serial walk, and every CTA
// starts near the front of the list, where most shadow rays are occluded.
// A thread that finds a blocking hit stores 1 into occ; before each slot a
// thread whose lane is already marked, by itself or by another CTA, drops
// out. The marks only ever go from 0 to 1 (occ must be zeroed before the
// launch), so neither the order of the CTAs nor a stale read changes a
// result. A CTA stops once none of its rays is open with a window that
// reaches the next slot's bound; the bounds only grow along the list.
// Per slot, each open thread runs its own slab test and, when the box is
// hit with entry < maxd + SLAB_EPS, Möller–Trumbore (mt.cuh) over the 128
// rows until its first blocking hit. The gate follows _slab_rows_inv term
// for term (cluster.cuh) and is conservative, so the bits equal the dense
// K4's. Parked rays (maxd = 0) never ask for a cluster.
//
// What bounds it on an H100: arithmetic on the visited clusters; the
// parallel slots trade some of K9's early termination (a CTA cannot know
// what a concurrent CTA is about to find) for an even spread of the long
// lists over the SMs.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"
#include "plucker.cuh"

namespace {

constexpr int kSlotLanes = 8;  // CTAs that share one slice's list

template <class Form>
__global__ void __launch_bounds__(ptt::kThreads)
sparse_any_hit_kernel(const float* __restrict__ o3,
                      const float* __restrict__ d3,
                      const float* __restrict__ maxd, int n,
                      const float* __restrict__ tripack,
                      const float* __restrict__ aabb8,
                      const int* __restrict__ ids,
                      const float* __restrict__ keys,
                      const int* __restrict__ ncand, int n_cols, int r_blk,
                      unsigned char* occ) {
  __shared__ __align__(16) float buf[2][ptt::kClusterTris * Form::kCols];
  const ptt::BlockSlice me = ptt::block_slice(r_blk, n);
  const int count = ncand[me.block];
  const int first = blockIdx.y;
  const int step = gridDim.y;
  if (first >= count) return;  // the same for every thread of the CTA

  const size_t stride = static_cast<size_t>(n);
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float md = 0.f;
  if (me.live) {
    ox = o3[me.lane];
    oy = o3[stride + me.lane];
    oz = o3[2 * stride + me.lane];
    dx = d3[me.lane];
    dy = d3[stride + me.lane];
    dz = d3[2 * stride + me.lane];
    md = maxd[me.lane];
  }
  const ptt::SlabRay ray = ptt::make_slab_ray(ox, oy, oz, dx, dy, dz);
  const typename Form::Ray pair_ray = Form::make_ray(ox, oy, oz, dx, dy, dz);
  // t > T_MIN and t < md - T_MIN cannot both hold unless md - T_MIN > T_MIN
  const float t_cut = md - ptt::kTMin;
  bool open = me.live && t_cut > ptt::kTMin;  // not occluded, can still be
  const volatile unsigned char* marks = occ;

  const size_t row = static_cast<size_t>(me.block) * n_cols;
  ptt::stage_cluster<Form::kCols>(buf[0], tripack, ids[row + first]);
  int cur = 0;
  for (int s = first; s < count; s += step) {
    const int cl = ids[row + s];
    ptt::wait_staged();
    if (open && marks[me.lane]) open = false;  // another CTA found a blocker
    // the CTA's stop; the barrier also completes buf[cur] and frees
    // buf[cur ^ 1], read in the previous step
    if (!__syncthreads_or(open && keys[row + s] <= md + ptt::kSlabEps)) break;
    if (s + step < count)
      ptt::stage_cluster<Form::kCols>(buf[cur ^ 1], tripack,
                                      ids[row + s + step]);
    float enter;
    if (open && ptt::slab_hit(aabb8 + cl * ptt::kAabbCols, ray, enter) &&
        enter < md + ptt::kSlabEps) {
      const float* tile = buf[cur];
      for (int j = 0; j < ptt::kClusterTris; ++j) {
        const float* p = tile + j * Form::kCols;
        float t;
        if (p[Form::kValid] > 0.5f && p[Form::kOccluder] > 0.5f &&
            Form::hit_row(p, pair_ray, t) && t < t_cut) {
          open = false;
          occ[me.lane] = 1;
          break;
        }
      }
    }
    cur ^= 1;
  }
  ptt::wait_staged();  // no copy left in flight
}

template <class Form>
int launch_sparse_any_hit(const float* o3, const float* d3, const float* maxd,
                          int n, const float* pack, const float* aabb8,
                          const int* ids, const float* keys, const int* ncand,
                          int n_cols, int r_blk, unsigned char* occ,
                          int device, void* stream) {
  if (n <= 0 || n_cols < 1 || r_blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(ptt::slice_ctas(n, r_blk), kSlotLanes);
  sparse_any_hit_kernel<Form><<<grid, ptt::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      o3, d3, maxd, n, pack, aabb8, ids, keys, ncand, n_cols, r_blk, occ);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); maxd: float32 [n];
// tripack: float32 [C * 128, 12]; aabb8: float32 [C, 8]; ids: int32
// [ceil(n / r_blk), n_cols] and keys: float32 [ceil(n / r_blk), n_cols], row
// b holding block b's clusters and their entry bounds front to back; ncand:
// int32 [ceil(n / r_blk)]; occ: bool (one byte) [n], zeroed by the caller.
// Launches on ``stream`` of CUDA device ``device`` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_sparse_any_hit(const float* o3, const float* d3,
                                  const float* maxd, int n,
                                  const float* tripack, const float* aabb8,
                                  const int* ids, const float* keys,
                                  const int* ncand, int n_cols, int r_blk,
                                  unsigned char* occ, int device,
                                  void* stream) {
  return launch_sparse_any_hit<ptt::ClassicForm>(
      o3, d3, maxd, n, tripack, aabb8, ids, keys, ncand, n_cols, r_blk, occ,
      device, stream);
}

// The same in the Plücker form; pack36: float32 [C * 128, 36], 16-byte
// aligned (kernels/intersect.py: plucker_pack of the padded pack).
extern "C" int ptt_plucker_sparse_any_hit(
    const float* o3, const float* d3, const float* maxd, int n,
    const float* pack36, const float* aabb8, const int* ids,
    const float* keys, const int* ncand, int n_cols, int r_blk,
    unsigned char* occ, int device, void* stream) {
  return launch_sparse_any_hit<ptt::PluckerForm>(
      o3, d3, maxd, n, pack36, aabb8, ids, keys, ncand, n_cols, r_blk, occ,
      device, stream);
}
