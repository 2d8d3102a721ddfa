// K4 and K3's dense any-hit: dense shadow any-hit, one thread per ray, in
// the classic Möller–Trumbore form (K4) and in the Plücker form (K3,
// plucker.cuh); the form is the kernel's template parameter, the sweep and
// the merge are the same.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/intersect_pallas.py
// _any_hit_call (the pallas_call over _any_hit_kernel_plain /
// _any_hit_kernel_cull, with _mt_rows and _merge_any_tile; under MT_IMPL =
// "plucker" over _any_hit_kernel_plucker_plain / _cull with
// _plucker_block).
//
// A ray is occluded by a valid occluder triangle (pack column 10) with a
// forward hit at t < maxd - 1e-4. Each thread owns one ray; a block of 256
// rays stages the pack in shared memory 256 rows at a time (the tile of
// K1, e1/e2 formed once at load, occluders only) and each thread walks the
// tile as a broadcast read until its first blocking hit. Rays whose window
// is empty (maxd - 1e-4 <= 1e-4: parked lanes, maxd = 0) are never occluded
// and sweep nothing.
//
// What bounds it on an H100: the schedulers' slots. The library is built
// with -fmad=false, so the 46 float operations of a pair test are 46 machine
// operations (the 67 TFLOP/s of the data sheet count a fused multiply-add as
// two), and with the shared-memory loads, the reciprocal, the compares and
// the loop a pair costs about 75 scheduler slots: about 450 G pairs/s for
// the card. The un-culled sweep ran at 375 G pairs/s, so the inner loop has
// little left to give, and neither the tensor cores nor bf16 help
// (probe_plucker.cu, probe_bf16.cu). What the design does about it is to
// test fewer pairs: it culls by boxes (aabb.cuh) up to maxd * kCullReach, the
// tile for the CTA (the _cull body's level) and, inside a staged tile, spans,
// mids and groups of rows for the warp and the lane; on a pack of one tile
// too, where _use_cull sweeps whole and the group level still pays here.
// With the pairs culled, the box tests set the time. The pack is re-read
// from L2 by every block that stages it, never the rays. A second instance
// of each form also counts what it staged, walked and tested.
#include <cuda_runtime.h>

#include "aabb.cuh"
#include "mt.cuh"
#include "plucker.cuh"

namespace {

template <class Form, bool kCount>
__global__ void __launch_bounds__(ptt::kThreads)
any_hit_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
               const float* __restrict__ maxd, int n,
               const float* __restrict__ tripack, int t_count,
               const float* __restrict__ tile_boxes,
               const float* __restrict__ group_boxes,
               unsigned char* __restrict__ occ_out,
               unsigned long long* __restrict__ stats) {
  __shared__ typename Form::Tile tile;
  __shared__ ptt::TileBoxes boxes;
  const size_t stride = static_cast<size_t>(n);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float md = 0.f;
  if (live) {
    ox = o3[i];
    oy = o3[stride + i];
    oz = o3[2 * stride + i];
    dx = d3[i];
    dy = d3[stride + i];
    dz = d3[2 * stride + i];
    md = maxd[i];
  }
  const typename Form::Ray ray = Form::make_ray(ox, oy, oz, dx, dy, dz);
  // the direction's reciprocal, once per ray
  const float ix = ptt::safe_inv(dx), iy = ptt::safe_inv(dy);
  const float iz = ptt::safe_inv(dz);
  const float reach = md * ptt::kCullReach;
  auto meets = [&](const float* box) {
    return ptt::box_meets(ptt::box_from(box, ox, oy, oz), ix, iy, iz, reach);
  };
  const float t_cut = md - ptt::kTMin;
  bool open = live && t_cut > ptt::kTMin;  // not occluded, can still be
  unsigned long long staged = 0, walked = 0, tested = 0;
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const bool in_tile =
        open && meets(tile_boxes + (base / ptt::kTile) * ptt::kAabbCols);
    // barrier before the tile is overwritten; the block skips a tile that
    // no open ray of its threads meets
    if (!__syncthreads_or(in_tile)) continue;
    const int rows = min(ptt::kTile, t_count - base);
    Form::load(tile, tripack, base, rows, Form::kOccluder);
    ptt::load_tile_boxes(boxes, group_boxes, base, rows);
    __syncthreads();
    if (kCount) staged += threadIdx.x == 0;
    // the warp skips what lies under a box that no open lane of it meets:
    // a span, inside it a mid, inside it a group
    for (int s0 = 0; s0 < rows; s0 += ptt::kSpanRows) {
      const bool in_span =
          in_tile && open &&
          meets(boxes.span + (s0 / ptt::kSpanRows) * ptt::kAabbCols);
      if (!__any_sync(0xffffffffu, in_span)) continue;
      const int s1 = min(s0 + ptt::kSpanRows, rows);
      for (int m0 = s0; m0 < s1; m0 += ptt::kMidRows) {
        const bool in_mid =
            in_span && open &&
            meets(boxes.mid + (m0 / ptt::kMidRows) * ptt::kAabbCols);
        if (!__any_sync(0xffffffffu, in_mid)) continue;
        const int m1 = min(m0 + ptt::kMidRows, s1);
        for (int j0 = m0; j0 < m1; j0 += ptt::kGroup) {
          bool need = in_mid && open &&
                      meets(boxes.group + (j0 / ptt::kGroup) * ptt::kAabbCols);
          if (!__any_sync(0xffffffffu, need)) continue;
          if (kCount) walked += (threadIdx.x & 31) == 0;
          // a lane that does not meet the group's box sits it out
          const int j1 = min(j0 + ptt::kGroup, m1);
          for (int j = j0; j < j1 && need; ++j) {
            if (!Form::use(tile, j)) continue;
            if (kCount) ++tested;
            float t;
            if (Form::hit(tile, j, ray, t) && t < t_cut) need = open = false;
          }
        }
      }
    }
  }
  if (live) occ_out[i] = !open && t_cut > ptt::kTMin;
  if (kCount) {
    if (threadIdx.x == 0) atomicAdd(stats + ptt::kTilesStaged, staged);
    ptt::add_warp_count(stats + ptt::kGroupsWalked, walked);
    ptt::add_warp_count(stats + ptt::kPairsTested, tested);
  }
}

template <class Form>
int launch_any_hit(const float* o3, const float* d3, const float* maxd, int n,
                   const float* pack, int t_count, const float* tile_boxes,
                   const float* group_boxes, unsigned char* occ_out,
                   unsigned long long* stats,
                   int device, void* stream) {
  if (n <= 0 || t_count < 0 ||
      (t_count > 0 && (tile_boxes == nullptr || group_boxes == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + ptt::kThreads - 1) / ptt::kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats == nullptr)
    any_hit_kernel<Form, false><<<blocks, ptt::kThreads, 0, st>>>(
        o3, d3, maxd, n, pack, t_count, tile_boxes, group_boxes, occ_out,
        stats);
  else
    any_hit_kernel<Form, true><<<blocks, ptt::kThreads, 0, st>>>(
        o3, d3, maxd, n, pack, t_count, tile_boxes, group_boxes, occ_out,
        stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); maxd: float32 [n];
// tripack: float32 [t_count, 12]; occ_out: bool (one byte) [n].
// tile_boxes: float32 [ceil(t_count / 256), 8] and group_boxes: float32
// [ceil(t_count / 2), 8], min.xyz | max.xyz | 0 | 0 over the valid occluder
// rows of each tile and of each group of kGroup = 2 rows
// (kernels/intersect.py: cull_boxes).
// stats: null, or three 64-bit counters (aabb.cuh: CullCounter) that the
// launch adds to. Launches on ``stream`` of CUDA device ``device`` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_any_hit(const float* o3, const float* d3, const float* maxd,
                           int n, const float* tripack, int t_count,
                           const float* tile_boxes, const float* group_boxes,
                           unsigned char* occ_out, unsigned long long* stats,
                           int device, void* stream) {
  return launch_any_hit<ptt::ClassicForm>(o3, d3, maxd, n, tripack, t_count,
                                          tile_boxes, group_boxes, occ_out,
                                          stats, device, stream);
}

// The same in the Plücker form; pack36: float32 [t_count, 36], 16-byte
// aligned (kernels/intersect.py: plucker_pack). The boxes are those of the
// [t_count, 12] pack it was derived from.
extern "C" int ptt_plucker_any_hit(const float* o3, const float* d3,
                                   const float* maxd, int n,
                                   const float* pack36, int t_count,
                                   const float* tile_boxes,
                                   const float* group_boxes,
                                   unsigned char* occ_out,
                                   unsigned long long* stats, int device,
                                   void* stream) {
  return launch_any_hit<ptt::PluckerForm>(o3, d3, maxd, n, pack36, t_count,
                                          tile_boxes, group_boxes, occ_out,
                                          stats, device, stream);
}
