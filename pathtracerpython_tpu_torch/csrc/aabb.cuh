// The AABB cull of the dense sweeps: the occluder sweeps K2 (nee.cu), K4
// and K3's dense any-hit (any_hit.cu), and the nearest sweeps K1 and K3's
// dense nearest (nearest.cu), each in both forms.
//
// Replaces pathtracerpython_tpu/kernels/intersect_pallas.py _aabb_cull_rows
// (with _block_aabbs on the PyTorch side, kernels/intersect.py: cull_boxes,
// nearest_cull_boxes) as _any_hit_kernel_cull, nee_pallas.py _nee_body and
// _nearest_kernel_cull use it: a block of rows is swept only where an open
// ray's segment meets the block's box. The slab arithmetic follows
// _aabb_cull_rows term for term: the direction's reciprocal with |d|
// clamped to 1e-12 (sign kept), per axis (box - o) * inv, the entry as the
// max of the three near times and the exit as the min of the three far
// times, and an overlap when
//     exit >= max(entry, 0) - 1e-3   and   entry <= bound + 1e-3,
// where bound is the ray's limit (maxd in K4, a sample's distance in K2,
// the running best t in K1) times kCullReach: the pair test's t carries an
// error that grows with t, which an absolute slack alone does not cover for
// far origins. A box with min > max holds no row and is never met.
//
// The TPU kernel decides per (ray block, triangle block of 512 rows): it has
// no control flow per lane, and a predicate around its triangle loop stalls
// its load pipeline. Here the cull has two levels. The tile (kTile rows) is
// the TPU kernel's level: a CTA stages a tile only if one of its threads
// has an open ray that meets the tile's box, decided in the barrier that
// guards the tile anyway. Below it, a warp walks the tile in groups of
// kGroup = 2 rows (a quad of a box; of 2, 4, 8 and 16 rows, 2 measured
// fastest on the card, PERF.md): each lane tests its ray against the group's
// box, staged in shared memory beside the tile, the warp skips the group on
// a vote, and a lane that does not meet the box sits the group out. A slab
// test is about 40 scheduler slots, the group it can skip 75 a row. Once
// the pairs are culled the group tests themselves set the time, so inside a
// tile the boxes form a small hierarchy: a warp first tests the union of
// the groups of every kSpanRows rows, then of every kMidRows rows, and
// skips what lies below a box that no open lane meets, on a vote. The unions are formed from the group boxes while the
// tile is staged; they hold their groups' boxes, so the pairs tested are
// the same as with the group boxes alone.
//
// The cull never changes a result: it skips pairs that the pair test
// rejects or whose hit lies at or beyond the limit. The boxes are grown at
// build time (kernels/intersect.py: grow_boxes) and the bound is stretched
// by kCullReach, by more than the pair test's own rounding can carry an
// accepted hit past a triangle's edge or short of its true t, wherever that
// test is conditioned: |det| >= 1e-3 |e1||e2|. Below that the pair test's u,
// v and t are rounding noise over rounding noise and no box can follow
// them; the TPU kernels' cull has the same limit (tests/test_torch_cull.py
// holds both statements).
#pragma once

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"

namespace ptt {

constexpr float kCullSlack = 1e-3f;             // absolute, in t
constexpr float kCullReach = 1.001f;            // bound = limit * kCullReach
constexpr int kGroup = 2;                       // rows under one group box
constexpr int kGroups = kTile / kGroup;         // group boxes of one tile
constexpr int kSpanRows = 32;                   // rows under one span box
constexpr int kSpans = kTile / kSpanRows;       // span boxes of one tile
constexpr int kMidRows = 8;                     // rows under one mid box
constexpr int kMids = kTile / kMidRows;         // mid boxes of one tile

static_assert(kMidRows % kGroup == 0 && kSpanRows % kMidRows == 0 &&
                  kTile % kSpanRows == 0,
              "each level's boxes are unions of the level below");

// The boxes a tile is culled by, in shared memory.
struct TileBoxes {
  __align__(16) float group[kGroups * kAabbCols];
  __align__(16) float mid[kMids * kAabbCols];
  __align__(16) float span[kSpans * kAabbCols];
};

// The counters a counting kernel instance adds to, in this order.
enum CullCounter { kTilesStaged = 0, kGroupsWalked = 1, kPairsTested = 2 };

// A box relative to a ray origin; every ray from that origin shares it.
struct BoxFrom {
  float lx, ly, lz, hx, hy, hz;
  bool nonempty;
};

// box[0:8] = min.xyz | max.xyz | 0 | 0, 16-byte aligned.
__device__ __forceinline__ BoxFrom box_from(const float* box, float ox,
                                            float oy, float oz) {
  const float4 a = *reinterpret_cast<const float4*>(box);      // min, max.x
  const float4 b = *reinterpret_cast<const float4*>(box + 4);  // max.yz
  return BoxFrom{a.x - ox, a.y - oy, a.z - oz, a.w - ox,
                 b.x - oy, b.y - oz, a.x <= a.w};
}

// Whether the ray with reciprocal direction (ix, iy, iz) meets the box
// within [0, bound], by the slab test above.
__device__ __forceinline__ bool box_meets(const BoxFrom& f, float ix, float iy,
                                          float iz, float bound) {
  const float lox = f.lx * ix, hix = f.hx * ix;
  const float loy = f.ly * iy, hiy = f.hy * iy;
  const float loz = f.lz * iz, hiz = f.hz * iz;
  const float enter =
      fmaxf(fmaxf(fminf(lox, hix), fminf(loy, hiy)), fminf(loz, hiz));
  const float exit =
      fminf(fminf(fmaxf(lox, hix), fmaxf(loy, hiy)), fmaxf(loz, hiz));
  return f.nonempty && exit >= fmaxf(enter, 0.0f) - kCullSlack &&
         enter <= bound + kCullSlack;
}

// Cooperative union of boxes: dst box k is the union of src boxes
// [k * per, (k + 1) * per) below n_src, one thread per (box, column): the
// min of a min column, the max of a max column, 0 in the two pad columns.
// An empty box (inverted) changes no union, and a union of empty boxes is
// inverted itself.
__device__ __forceinline__ void union_boxes(float* dst, int n_dst,
                                            const float* __restrict__ src,
                                            int per, int n_src) {
  for (int k = threadIdx.x; k < n_dst * kAabbCols; k += blockDim.x) {
    const int box = k / kAabbCols, col = k % kAabbCols;
    const int g1 = min((box + 1) * per, n_src);
    float v = col < 3 ? kBig : (col < 6 ? -kBig : 0.0f);
    for (int g = box * per; g < g1; ++g) {
      const float x = src[g * kAabbCols + col];
      v = col < 3 ? fminf(v, x) : (col < 6 ? fmaxf(v, x) : 0.0f);
    }
    dst[k] = v;
  }
}

// Cooperative load of the boxes of pack rows [base, base + rows): the group
// boxes copied from ``group_boxes`` (kGroup rows a box; ``base`` is a
// multiple of kTile and so of kGroup), the mid and span boxes as unions of
// them.
__device__ __forceinline__ void load_tile_boxes(
    TileBoxes& boxes, const float* __restrict__ group_boxes, int base,
    int rows) {
  const int n_groups = (rows + kGroup - 1) / kGroup;
  const float* src =
      group_boxes + static_cast<size_t>(base / kGroup) * kAabbCols;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  float4* out = reinterpret_cast<float4*>(boxes.group);
  for (int k = threadIdx.x; k < 2 * n_groups; k += blockDim.x) out[k] = src4[k];
  union_boxes(boxes.mid, kMids, src, kMidRows / kGroup, n_groups);
  union_boxes(boxes.span, kSpans, src, kSpanRows / kGroup, n_groups);
}

}  // namespace ptt
