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
// Design: the split walk of cluster.cuh. A unit is one CTA of 256 threads,
// one ray per thread, over a slice of one block and one segment of
// kSegment slots of the block's list; a block's list of 782 clusters is so
// walked by 49 units on as many SMs at once, where one CTA walked it alone
// before, and a list that fits one segment is walked as before. A unit
// walks its slots front to back with the clusters' packed rows
// double-buffered in shared memory: while the threads test cluster s,
// cp.async brings cluster s+1. For each cluster a thread runs the slab test
// of its own ray against the cluster's AABB; the ray needs the cluster when
// the box is hit and its entry is below the ray's bound t + SLAB_EPS, and
// only then runs the pair test (mt.cuh or plucker.cuh) over the 128 rows.
// The unit stops once no ray of the CTA can use the next cluster: its block
// bound exceeds every ray's bound t + SLAB_EPS; a unit whose first slot is
// already beyond every bound stages nothing. A ray's bound is its own best
// and the best any unit has merged into its scratch word, read once per
// slot; a better best is merged by a 64-bit atomicMin on (t bits, index).
// A small second kernel writes t and index from the words (t = 0, index
// -1 on a miss).
//
// Why the winner is the serial walk's, and the dense K1's (cluster.cuh
// gives it in full): the word order is the lexicographic (t, index) order
// that the serial walk's strict t <, ties to the smaller index, realises,
// and a minimum does not depend on the order of the atomics; every bound
// any unit reads is a real hit or "none", never below the winner w, so the
// gate and the stop never drop w's cluster in the unit that owns its slot.
// Which clusters are visited depends on timing; the winner does not.
//
// What bounds it on an H100: arithmetic, as for K1, but only on the
// clusters a ray's own slab test lets through, plus one 6 KB (18 KB) copy
// from L2 per visited cluster and CTA, shared by its 256 rays. Before the
// split, the few blocks whose lists span the scene (an octant edge or the
// parked tail, with a lane that misses and so never lets its block stop)
// set the time: one SM walked 782 slots while the rest idled. Now the
// longest walk is kSegment slots, and the price is a wider bound: a unit
// that starts while the units before it in its list still run knows less
// than the serial walk knew at that slot. The per-lane gate is conservative
// (SLAB_EPS), which is what keeps the result equal to K1's. A second
// instance of each form counts units launched, units stopped before their
// first slot, and (ray, cluster) visits through the gate.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"
#include "plucker.cuh"

namespace {

template <class Form, bool kCount>
__global__ void __launch_bounds__(ptt::kThreads)
sparse_nearest_kernel(const float* __restrict__ o3,
                      const float* __restrict__ d3, int n,
                      const float* __restrict__ tripack,
                      const float* __restrict__ aabb8, int n_cols,
                      const int* __restrict__ ids,
                      const float* __restrict__ keys,
                      const int* __restrict__ ncand, int r_blk,
                      unsigned long long* words,
                      unsigned long long* __restrict__ stats) {
  __shared__ __align__(16) float buf[2][ptt::kClusterTris * Form::kCols];
  const ptt::WalkUnit unit = ptt::walk_unit(r_blk, n, ncand);
  if (unit.first >= unit.count) return;  // the same for every thread
  const ptt::BlockSlice& me = unit.me;
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
  const bool reads = me.live && unit.shared;  // other units merge into it
  unsigned long long best = ptt::start_word();
  // the word as read for the next slot, read one slot ahead
  unsigned long long seen =
      reads ? ptt::read_word(words, me.lane) : ptt::kNoHitWord;
  unsigned long long visits = 0;

  const size_t row = static_cast<size_t>(me.block) * n_cols;
  // the unit's stop at its first slot, before anything is staged
  best = ptt::word_min(best, seen);
  if (!__syncthreads_or(me.live && keys[row + unit.first] <=
                                       ptt::word_t(best) + ptt::kSlabEps)) {
    if (kCount && threadIdx.x == 0) {
      atomicAdd(stats + ptt::kUnitsLaunched, 1ull);
      atomicAdd(stats + ptt::kUnitsStoppedAtOnce, 1ull);
    }
    return;
  }
  ptt::stage_cluster<Form::kCols>(buf[0], tripack, ids[row + unit.first]);
  int cur = 0;
  for (int s = unit.first; s < unit.end; ++s) {
    const int cl = ids[row + s];
    best = ptt::word_min(best, seen);
    const float bound = ptt::word_t(best);
    ptt::wait_staged();
    // the unit's stop (decided above for the first slot); the barrier also
    // completes buf[cur] and frees buf[cur ^ 1], read in the previous step
    if (!__syncthreads_or(s == unit.first ||
                          (me.live && keys[row + s] <= bound + ptt::kSlabEps)))
      break;
    if (s + 1 < unit.end)
      ptt::stage_cluster<Form::kCols>(buf[cur ^ 1], tripack,
                                      ids[row + s + 1]);
    if (reads) seen = ptt::read_word(words, me.lane);
    float enter;
    if (me.live && ptt::slab_hit(aabb8 + cl * ptt::kAabbCols, ray, enter) &&
        enter < bound + ptt::kSlabEps) {
      if (kCount) ++visits;
      const int base = cl * ptt::kClusterTris;
      const float* tile = buf[cur];
      const unsigned long long before = best;
      for (int j = 0; j < ptt::kClusterTris; ++j) {
        const float* p = tile + j * Form::kCols;
        float t;
        if (p[Form::kValid] > 0.5f && Form::hit_row(p, pair_ray, t))
          best = ptt::word_min(best, ptt::hit_word(t, base + j));
      }
      if (best < before) ptt::publish_word(words, me.lane, best);
    }
    cur ^= 1;
  }
  ptt::wait_staged();  // no copy left in flight
  if (kCount) {
    if (threadIdx.x == 0) atomicAdd(stats + ptt::kUnitsLaunched, 1ull);
    ptt::add_warp_count(stats + ptt::kVisits, visits);
  }
}

__global__ void __launch_bounds__(ptt::kThreads)
finish_kernel(const unsigned long long* __restrict__ words, int n,
              float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int lane = blockIdx.x * ptt::kThreads + threadIdx.x;
  if (lane < n) ptt::finish_lane(words, lane, t_out, idx_out);
}

template <class Form>
int launch_sparse_nearest(const float* o3, const float* d3, int n,
                          const float* pack, const float* aabb8,
                          int n_cols, const int* ids, const float* keys,
                          const int* ncand, int r_blk,
                          unsigned long long* words, float* t_out,
                          int* idx_out, unsigned long long* stats, int device,
                          void* stream) {
  if (n <= 0 || n_cols < 1 || r_blk < 1 || words == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = ptt::walk_grid(n, r_blk, n_cols);
  if (stats == nullptr)
    sparse_nearest_kernel<Form, false><<<grid, ptt::kThreads, 0, st>>>(
        o3, d3, n, pack, aabb8, n_cols, ids, keys, ncand, r_blk, words,
        stats);
  else
    sparse_nearest_kernel<Form, true><<<grid, ptt::kThreads, 0, st>>>(
        o3, d3, n, pack, aabb8, n_cols, ids, keys, ncand, r_blk, words,
        stats);
  const cudaError_t walked = cudaGetLastError();
  if (walked != cudaSuccess) return static_cast<int>(walked);
  finish_kernel<<<(n + ptt::kThreads - 1) / ptt::kThreads, ptt::kThreads, 0,
                  st>>>(words, n, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); tripack: float32 [C * 128, 12];
// aabb8: float32 [C, 8]; ids: int32 [ceil(n / r_blk), n_cols] and keys:
// float32 [ceil(n / r_blk), n_cols], row b holding block b's clusters and
// their entry bounds front to back (n_cols: C for the full lists, fewer for
// the two-pass protocol's truncated ones, whose grid is then as short);
// ncand: int32 [ceil(n / r_blk)]; words: uint64 [n]
// scratch, every bit set on entry (null is refused); t_out: float32 [n];
// idx_out: int32 [n]; stats: null, or three 64-bit counters
// (cluster.cuh: WalkCounter) that the launch adds to. Launches the walk
// and the kernel that writes the outputs on ``stream`` of CUDA device
// ``device`` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_sparse_nearest(const float* o3, const float* d3, int n,
                                  const float* tripack, const float* aabb8,
                                  int n_cols, const int* ids,
                                  const float* keys, const int* ncand,
                                  int r_blk, unsigned long long* words,
                                  float* t_out, int* idx_out,
                                  unsigned long long* stats, int device,
                                  void* stream) {
  return launch_sparse_nearest<ptt::ClassicForm>(
      o3, d3, n, tripack, aabb8, n_cols, ids, keys, ncand, r_blk, words,
      t_out, idx_out, stats, device, stream);
}

// The same in the Plücker form; pack36: float32 [C * 128, 36], 16-byte
// aligned (kernels/intersect.py: plucker_pack of the padded pack). The
// clusters, their AABBs and the lists are the classic pack's.
extern "C" int ptt_plucker_sparse_nearest(
    const float* o3, const float* d3, int n, const float* pack36,
    const float* aabb8, int n_cols, const int* ids, const float* keys,
    const int* ncand, int r_blk, unsigned long long* words, float* t_out,
    int* idx_out, unsigned long long* stats, int device, void* stream) {
  return launch_sparse_nearest<ptt::PluckerForm>(
      o3, d3, n, pack36, aabb8, n_cols, ids, keys, ncand, r_blk, words,
      t_out, idx_out, stats, device, stream);
}
