// K1 and K3's dense nearest sweep: dense nearest hit, one thread per ray,
// in the classic Möller–Trumbore form (K1) and in the Plücker form (K3,
// plucker.cuh); the form is the kernel's template parameter, the sweep, the
// cull and the merge are the same.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/intersect_pallas.py
// _nearest_t_idx (the pallas_call over _nearest_kernel_plain /
// _nearest_kernel_cull, with _mt_rows and _merge_nearest_tile; under
// MT_IMPL = "plucker" over _nearest_kernel_plucker_plain / _cull with
// _plucker_block).
//
// Each thread owns one ray; a block of 256 rays stages the packed triangles
// in shared memory 256 rows at a time (e1/e2 formed once at load) and every
// thread walks the tile as a broadcast read, keeping its running (t, index)
// minimum in registers. Rays are not padded: the ragged edge is masked.
//
// What bounds it on an H100: the schedulers' slots, as in any_hit.cu: a
// pair test is about 75 of them under -fmad=false, so the way down is to
// test fewer pairs. The sweep culls by boxes (aabb.cuh) over every valid
// row (the light's rows too: a camera or bounce ray must find them), and
// the bound is the lane's running best t times kCullReach. It starts at
// kBig (kBig * kCullReach = 3.003e38 stays finite), so a lane with no hit
// yet tests every box its whole ray meets, and it shrinks as hits are found;
// every box test uses the lane's bound at the moment it runs. The levels
// are any_hit.cu's: the tile for the CTA in the barrier that guards it (the
// level of _nearest_kernel_cull, whose bound is the block's running t_out),
// then per warp spans of 32 rows, mids of 8 and groups of kGroup = 2 rows,
// each skipped on a vote; a lane that does not meet a group's box sits it
// out. No lane ever closes: every live lane walks to the end of the pack.
// It culls one-tile packs too, where _use_cull sweeps whole. A second
// instance of each form also counts what it staged, walked and tested.
//
// Winner rule: triangles are walked in increasing global index and a hit
// replaces the best only when its t is strictly smaller, so the smallest
// index wins among equal t — the same winner as the TPU kernel's per-tile
// first minimum followed by a strict < across tiles. A miss gives t = 0 and
// index -1.
//
// Why the cull changes no winner. Let w be the un-culled sweep's winner at
// t_w. Before w's group a lane has tested only rows of smaller index, so
// its best t is above t_w (a hit at or below t_w there would be the winner
// itself). Its bound is therefore at least t_w * kCullReach, and wherever
// the pair test is conditioned, |det| >= 1e-3 |e1||e2|, an accepted hit
// meets its own grown box, and so its group's, within t * kCullReach
// (tests/test_torch_cull.py holds that at the bound t itself). So w's group
// is walked, w becomes the best, and no later row has a smaller t. A
// skipped row could only have won with a t below the bound. A group whose
// box a lane meets is met by its mid, span and tile too, which hold it and
// were tested at a bound no smaller, so the pairs tested are fixed by the
// group boxes alone (kernels/intersect.py: nearest_t_idx_plain with cull=
// models them). The limit is the JAX package's: where |det| < 1e-3
// |e1||e2| an accepted t is noise, and a culled sweep can pass over such a
// "hit" that the un-culled sweep takes as the winner; _nearest_kernel_cull
// can too.
#include <cuda_runtime.h>

#include "aabb.cuh"
#include "mt.cuh"
#include "plucker.cuh"

namespace {

// Five CTAs an SM: the classic instance would take 53 registers and fit
// four; held to 48 it is 8-12% faster on the box field (PERF.md).
template <class Form, bool kCount>
__global__ void __launch_bounds__(ptt::kThreads, 5)
nearest_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
               int n, const float* __restrict__ tripack, int t_count,
               const float* __restrict__ tile_boxes,
               const float* __restrict__ group_boxes,
               float* __restrict__ t_out, int* __restrict__ idx_out,
               unsigned long long* __restrict__ stats) {
  __shared__ typename Form::Tile tile;
  __shared__ ptt::TileBoxes boxes;
  const size_t stride = static_cast<size_t>(n);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = o3[i];
    oy = o3[stride + i];
    oz = o3[2 * stride + i];
    dx = d3[i];
    dy = d3[stride + i];
    dz = d3[2 * stride + i];
  }
  const typename Form::Ray ray = Form::make_ray(ox, oy, oz, dx, dy, dz);
  // the direction's reciprocal, once per ray
  const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy);
  const float iz = ptt::safe_inv(dz);
  float best_t = ptt::kBig;
  int best_idx = -1;
  // whether the ray meets the box before its running best t, stretched
  auto meets = [&](const float* box) {
    return ptt::box_meets(ptt::box_from(box, ox, oy, oz), ix, iy, iz,
                          best_t * ptt::kCullReach);
  };
  unsigned long long staged = 0, walked = 0, tested = 0;
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const bool in_tile =
        live && meets(tile_boxes + (base / ptt::kTile) * ptt::kAabbCols);
    // barrier before the tile is overwritten; the block skips a tile that
    // no live ray of its threads meets
    if (!__syncthreads_or(in_tile)) continue;
    const int rows = min(ptt::kTile, t_count - base);
    Form::load(tile, tripack, base, rows, -1);
    ptt::load_tile_boxes(boxes, group_boxes, base, rows);
    __syncthreads();
    if (kCount) staged += threadIdx.x == 0;
    // the warp skips what lies under a box that no lane of it meets: a
    // span, inside it a mid, inside it a group
    for (int s0 = 0; s0 < rows; s0 += ptt::kSpanRows) {
      const bool in_span =
          in_tile &&
          meets(boxes.span + (s0 / ptt::kSpanRows) * ptt::kAabbCols);
      if (!__any_sync(0xffffffffu, in_span)) continue;
      const int s1 = min(s0 + ptt::kSpanRows, rows);
      for (int m0 = s0; m0 < s1; m0 += ptt::kMidRows) {
        const bool in_mid =
            in_span &&
            meets(boxes.mid + (m0 / ptt::kMidRows) * ptt::kAabbCols);
        if (!__any_sync(0xffffffffu, in_mid)) continue;
        const int m1 = min(m0 + ptt::kMidRows, s1);
        for (int j0 = m0; j0 < m1; j0 += ptt::kGroup) {
          const bool need =
              in_mid &&
              meets(boxes.group + (j0 / ptt::kGroup) * ptt::kAabbCols);
          if (!__any_sync(0xffffffffu, need)) continue;
          if (kCount) walked += (threadIdx.x & 31) == 0;
          // a lane that does not meet the group's box sits it out
          if (!need) continue;
          const int j1 = min(j0 + ptt::kGroup, m1);
          for (int j = j0; j < j1; ++j) {
            if (!Form::use(tile, j)) continue;
            if (kCount) ++tested;
            float t;
            if (Form::hit(tile, j, ray, t) && t < best_t) {
              best_t = t;
              best_idx = base + j;
            }
          }
        }
      }
    }
  }
  if (live) {
    t_out[i] = best_idx >= 0 ? best_t : 0.0f;
    idx_out[i] = best_idx;
  }
  if (kCount) {
    if (threadIdx.x == 0) atomicAdd(stats + ptt::kTilesStaged, staged);
    ptt::add_warp_count(stats + ptt::kGroupsWalked, walked);
    ptt::add_warp_count(stats + ptt::kPairsTested, tested);
  }
}

template <class Form>
int launch_nearest(const float* o3, const float* d3, int n, const float* pack,
                   int t_count, const float* tile_boxes,
                   const float* group_boxes, float* t_out, int* idx_out,
                   unsigned long long* stats, int device, void* stream) {
  if (n <= 0 || t_count < 0 ||
      (t_count > 0 && (tile_boxes == nullptr || group_boxes == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + ptt::kThreads - 1) / ptt::kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats == nullptr)
    nearest_kernel<Form, false><<<blocks, ptt::kThreads, 0, st>>>(
        o3, d3, n, pack, t_count, tile_boxes, group_boxes, t_out, idx_out,
        stats);
  else
    nearest_kernel<Form, true><<<blocks, ptt::kThreads, 0, st>>>(
        o3, d3, n, pack, t_count, tile_boxes, group_boxes, t_out, idx_out,
        stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); tripack: float32 [t_count, 12];
// t_out: float32 [n]; idx_out: int32 [n].
// tile_boxes: float32 [ceil(t_count / 256), 8] and group_boxes: float32
// [ceil(t_count / 2), 8], min.xyz | max.xyz | 0 | 0 over the valid rows of
// each tile and of each group of kGroup = 2 rows (kernels/intersect.py:
// nearest_cull_boxes); null only when t_count is 0.
// stats: null, or three 64-bit counters (aabb.cuh: CullCounter) that the
// launch adds to. Launches on ``stream`` of CUDA device ``device`` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_nearest_t_idx(const float* o3, const float* d3, int n,
                                 const float* tripack, int t_count,
                                 const float* tile_boxes,
                                 const float* group_boxes, float* t_out,
                                 int* idx_out, unsigned long long* stats,
                                 int device, void* stream) {
  return launch_nearest<ptt::ClassicForm>(o3, d3, n, tripack, t_count,
                                          tile_boxes, group_boxes, t_out,
                                          idx_out, stats, device, stream);
}

// The same in the Plücker form; pack36: float32 [t_count, 36], 16-byte
// aligned (kernels/intersect.py: plucker_pack). The boxes are those of the
// [t_count, 12] pack it was derived from.
extern "C" int ptt_plucker_nearest_t_idx(const float* o3, const float* d3,
                                         int n, const float* pack36,
                                         int t_count,
                                         const float* tile_boxes,
                                         const float* group_boxes,
                                         float* t_out, int* idx_out,
                                         unsigned long long* stats,
                                         int device, void* stream) {
  return launch_nearest<ptt::PluckerForm>(o3, d3, n, pack36, t_count,
                                          tile_boxes, group_boxes, t_out,
                                          idx_out, stats, device, stream);
}
