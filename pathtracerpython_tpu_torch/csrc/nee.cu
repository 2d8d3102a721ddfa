// K2: fused fast-mode next-event estimation, one thread per shading point.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/nee_pallas.py
// _nee_call (the pallas_call over _nee_body).
//
// Per shading point and light sample s < S: pick a light triangle by
// area-CDF compare-and-count on the cumulative areas, place a point with
// sqrt-trick barycentrics from uniform rows 5s+1 and 5s+2, form the shadow
// direction (rsqrt(max(sq, 1e-30))) and distance (sqrt(sq + 1e-24)) — two
// formulas on purpose, as in the TPU kernel — and the clamped cosine. Then
// sweep the occluder triangles: a sample is occluded by a forward hit with
// t < dist - 1e-4. Output the mean of the unoccluded cosines and the 0/1
// occlusion of every sample.
//
// What bounds it on an H100: the schedulers' slots, as for K4 (any_hit.cu): a
// (sample, occluder) pair costs about 75 of them under -fmad=false, and
// the un-culled sweep already ran near what that allows, so the design
// tests fewer pairs. It keeps all S samples' rays in registers (S is a
// template parameter, at most 8), the light table (at most 64 rows) in
// shared memory, and stages the occluders through the same shared tile as
// K1. It culls the sweep by boxes (aabb.cuh), per sample, up to the sample's
// distance times kCullReach, as _nee_body does under cull=True per triangle
// block: a CTA stages a tile only if an unoccluded sample of one of its
// threads meets the tile's box, and inside the tile a warp skips every
// span, mid and group of rows that no such sample of its lanes meets; a
// thread tests a group's rows only for the samples that meet its box. The
// three reciprocals of a sample's direction are taken once and kept in
// registers (114 at S = 8, no spill). The TPU kernel culls only packs of
// more than one triangle block; here the group level pays on one tile too.
// A thread stops testing once all its samples are occluded but still meets
// every barrier. Nothing but the inputs and the [1, n] and [S, n] outputs
// touches device memory. A second instance of each S also counts what it
// staged, walked and tested.
#include <cuda_runtime.h>

#include "aabb.cuh"
#include "mt.cuh"

namespace {

constexpr int kMaxLight = 64;
constexpr int kMaxSamples = 8;

// The samples of ``among`` (bit s: sample s) whose segment from (px, py,
// pz), with reciprocal direction (ix, iy, iz)[s] and length dist[s], meets
// ``box``.
template <int S>
__device__ __forceinline__ unsigned meeting(
    const float* box, unsigned among, float px, float py, float pz,
    const float (&ix)[S], const float (&iy)[S], const float (&iz)[S],
    const float (&dist)[S]) {
  if (among == 0) return 0;
  const ptt::BoxFrom from = ptt::box_from(box, px, py, pz);
  unsigned meets = 0;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if ((among >> s & 1u) &&
        ptt::box_meets(from, ix[s], iy[s], iz[s],
                       dist[s] * ptt::kCullReach))
      meets |= 1u << s;
  return meets;
}

template <int S, bool kCount>
__global__ void __launch_bounds__(ptt::kThreads)
nee_kernel(const float* __restrict__ point3, const float* __restrict__ normal3,
           const float* __restrict__ u, int n,
           const float* __restrict__ tripack, int t_count,
           const float* __restrict__ lightpack, int l_count,
           const float* __restrict__ tile_boxes,
           const float* __restrict__ group_boxes,
           float* __restrict__ mc_out, float* __restrict__ occ_out,
           unsigned long long* __restrict__ stats) {
  __shared__ ptt::TriTile tile;
  __shared__ ptt::TileBoxes boxes;
  __shared__ float light[kMaxLight][10];  // v0.xyz | v1.xyz | v2.xyz | cum area
  for (int k = threadIdx.x; k < l_count * 10; k += blockDim.x) {
    const int row = k / 10, col = k % 10;
    light[row][col] = lightpack[row * ptt::kPackCols + col];
  }
  __syncthreads();

  const size_t stride = static_cast<size_t>(n);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float px = 0.f, py = 0.f, pz = 0.f;
  float sx[S], sy[S], sz[S], dist[S], cosv[S];
  float ix[S], iy[S], iz[S];  // reciprocal directions, for the box tests
  unsigned open = 0;                   // bit s: sample s is not occluded
  if (live) {
    px = point3[i];
    py = point3[stride + i];
    pz = point3[2 * stride + i];
    const float nx = normal3[i], ny = normal3[stride + i];
    const float nz = normal3[2 * stride + i];
    const float total = light[l_count - 1][9];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float u_pick = u[(5 * s) * stride + i];
      const float u1 = u[(5 * s + 1) * stride + i];
      const float u2 = u[(5 * s + 2) * stride + i];
      const float x = u_pick * total;
      int l = 0;
      for (int k = 0; k < l_count - 1; ++k) l += x >= light[k][9];
      const float* v = light[l];
      const float su = sqrtf(u1);
      const float b0 = 1.0f - su;
      const float b1 = su * (1.0f - u2);
      const float b2 = su * u2;
      const float vx = (b0 * v[0] + b1 * v[3] + b2 * v[6]) - px;
      const float vy = (b0 * v[1] + b1 * v[4] + b2 * v[7]) - py;
      const float vz = (b0 * v[2] + b1 * v[5] + b2 * v[8]) - pz;
      const float sq = vx * vx + vy * vy + vz * vz;
      dist[s] = sqrtf(sq + 1e-24f);
      const float inv = rsqrtf(fmaxf(sq, 1e-30f));
      sx[s] = vx * inv;
      sy[s] = vy * inv;
      sz[s] = vz * inv;
      cosv[s] = fmaxf(sx[s] * nx + sy[s] * ny + sz[s] * nz, 0.0f);
      ix[s] = ptt::safe_inv(sx[s]);
      iy[s] = ptt::safe_inv(sy[s]);
      iz[s] = ptt::safe_inv(sz[s]);
    }
    open = (1u << S) - 1u;
  }

// the samples of ``among`` that meet ``box``
#define PTT_MEET(box, among) \
  meeting<S>(box, among, px, py, pz, ix, iy, iz, dist)
  unsigned long long staged = 0, walked = 0, tested = 0;
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const unsigned in_tile =
        PTT_MEET(tile_boxes + (base / ptt::kTile) * ptt::kAabbCols, open);
    // barrier before the tile is overwritten; the block skips a tile that
    // no unoccluded sample of its threads meets
    if (!__syncthreads_or(in_tile != 0)) continue;
    const int rows = min(ptt::kTile, t_count - base);
    ptt::load_tile(tile, tripack, base, rows, ptt::kOccluderCol);
    ptt::load_tile_boxes(boxes, group_boxes, base, rows);
    __syncthreads();
    if (kCount) staged += threadIdx.x == 0;
    // the warp skips what lies under a box that no unoccluded sample of its
    // lanes meets: a span, inside it a mid, inside it a group
    for (int s0 = 0; s0 < rows; s0 += ptt::kSpanRows) {
      const unsigned in_span =
          PTT_MEET(boxes.span + (s0 / ptt::kSpanRows) * ptt::kAabbCols,
                   in_tile & open);
      if (!__any_sync(0xffffffffu, in_span != 0)) continue;
      const int s1 = min(s0 + ptt::kSpanRows, rows);
      for (int m0 = s0; m0 < s1; m0 += ptt::kMidRows) {
        const unsigned in_mid = PTT_MEET(
            boxes.mid + (m0 / ptt::kMidRows) * ptt::kAabbCols, in_span & open);
        if (!__any_sync(0xffffffffu, in_mid != 0)) continue;
        const int m1 = min(m0 + ptt::kMidRows, s1);
        for (int j0 = m0; j0 < m1; j0 += ptt::kGroup) {
          unsigned need =
              PTT_MEET(boxes.group + (j0 / ptt::kGroup) * ptt::kAabbCols,
                       in_mid & open);
          if (!__any_sync(0xffffffffu, need != 0)) continue;
          if (kCount) walked += (threadIdx.x & 31) == 0;
          // a thread tests the rows for the samples that meet the box
          const int j1 = min(j0 + ptt::kGroup, m1);
          for (int j = j0; j < j1 && need; ++j) {
            if (!tile.use[j]) continue;
#pragma unroll
            for (int s = 0; s < S; ++s) {
              if (!(need >> s & 1u)) continue;
              if (kCount) ++tested;
              float t;
              if (ptt::mt_hit(tile, j, px, py, pz, sx[s], sy[s], sz[s], t) &&
                  t < dist[s] - ptt::kTMin) {
                need &= ~(1u << s);
                open &= ~(1u << s);
              }
            }
          }
        }
      }
    }
  }

#undef PTT_MEET

  if (live) {
    float acc = (open & 1u) ? cosv[0] : 0.0f;
#pragma unroll
    for (int s = 1; s < S; ++s) acc = acc + ((open >> s & 1u) ? cosv[s] : 0.0f);
    mc_out[i] = acc / static_cast<float>(S);
#pragma unroll
    for (int s = 0; s < S; ++s)
      occ_out[s * stride + i] = (open >> s & 1u) ? 0.0f : 1.0f;
  }
  if (kCount) {
    if (threadIdx.x == 0)
      atomicAdd(stats + ptt::kTilesStaged, staged);
    ptt::add_warp_count(stats + ptt::kGroupsWalked, walked);
    ptt::add_warp_count(stats + ptt::kPairsTested, tested);
  }
}

template <int S>
void launch(const float* point3, const float* normal3, const float* u, int n,
            const float* tripack, int t_count, const float* lightpack,
            int l_count, const float* tile_boxes, const float* group_boxes,
            float* mc_out, float* occ_out, unsigned long long* stats,
            cudaStream_t stream) {
  const int blocks = (n + ptt::kThreads - 1) / ptt::kThreads;
  if (stats == nullptr)
    nee_kernel<S, false><<<blocks, ptt::kThreads, 0, stream>>>(
        point3, normal3, u, n, tripack, t_count, lightpack, l_count,
        tile_boxes, group_boxes, mc_out, occ_out, stats);
  else
    nee_kernel<S, true><<<blocks, ptt::kThreads, 0, stream>>>(
        point3, normal3, u, n, tripack, t_count, lightpack, l_count,
        tile_boxes, group_boxes, mc_out, occ_out, stats);
}

}  // namespace

// point3, normal3: float32 [3, n]; u: float32 [5 * s_samples, n];
// tripack: float32 [t_count, 12]; lightpack: float32 [l_count, 12] with the
// cumulative light area in column 9; mc_out: float32 [n];
// occ_out: float32 [s_samples, n]. tile_boxes, group_boxes and stats as for
// ptt_any_hit (any_hit.cu). Launches on ``stream`` of CUDA device
// ``device`` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_nee_mean_cos(const float* point3, const float* normal3,
                                const float* u, int n, int s_samples,
                                const float* tripack, int t_count,
                                const float* lightpack, int l_count,
                                const float* tile_boxes,
                                const float* group_boxes, float* mc_out,
                                float* occ_out,
                                unsigned long long* stats, int device,
                                void* stream) {
  if (n <= 0 || t_count < 0 || l_count < 1 || l_count > kMaxLight)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t_count > 0 && (tile_boxes == nullptr || group_boxes == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s_samples) {
#define PTT_NEE_CASE(S)                                                    \
  case S:                                                                  \
    launch<S>(point3, normal3, u, n, tripack, t_count, lightpack, l_count, \
              tile_boxes, group_boxes, mc_out, occ_out, stats, st);        \
    break;
    PTT_NEE_CASE(1)
    PTT_NEE_CASE(2)
    PTT_NEE_CASE(3)
    PTT_NEE_CASE(4)
    PTT_NEE_CASE(5)
    PTT_NEE_CASE(6)
    PTT_NEE_CASE(7)
    PTT_NEE_CASE(8)
#undef PTT_NEE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxSamples == 8, "one case per sample count");
  return static_cast<int>(cudaGetLastError());
}
