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
// What bounds it on an H100: arithmetic, as for K1 — about 60 flops per
// (sample, occluder) pair against a scene of a few KB. The design keeps all
// S samples' rays in registers (S is a template parameter, at most 8), the
// light table (at most 64 rows) in shared memory, and stages the occluders
// through the same shared tile as K1. A thread stops testing once all its
// samples are occluded but still meets every barrier, and a block stops
// sweeping once all its threads are done. Nothing but the inputs and the
// [1, n] and [S, n] outputs touches device memory.
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kMaxLight = 64;
constexpr int kMaxSamples = 8;

template <int S>
__global__ void __launch_bounds__(ptt::kThreads)
nee_kernel(const float* __restrict__ point3, const float* __restrict__ normal3,
           const float* __restrict__ u, int n,
           const float* __restrict__ tripack, int t_count,
           const float* __restrict__ lightpack, int l_count,
           float* __restrict__ mc_out, float* __restrict__ occ_out) {
  __shared__ ptt::TriTile tile;
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
  bool occ[S];
  int pending = 0;
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
      occ[s] = false;
    }
    pending = S;
  }

  for (int base = 0; base < t_count; base += ptt::kTile) {
    // barrier before the tile is overwritten; the block stops once no
    // thread has an unoccluded sample left
    if (!__syncthreads_or(pending > 0)) break;
    const int rows = min(ptt::kTile, t_count - base);
    ptt::load_tile(tile, tripack, base, rows, ptt::kOccluderCol);
    __syncthreads();
    for (int j = 0; j < rows && pending > 0; ++j) {
      if (!tile.use[j]) continue;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (occ[s]) continue;
        float t;
        if (ptt::mt_hit(tile, j, px, py, pz, sx[s], sy[s], sz[s], t) &&
            t < dist[s] - ptt::kTMin) {
          occ[s] = true;
          --pending;
        }
      }
    }
  }

  if (live) {
    float acc = occ[0] ? 0.0f : cosv[0];
#pragma unroll
    for (int s = 1; s < S; ++s) acc = acc + (occ[s] ? 0.0f : cosv[s]);
    mc_out[i] = acc / static_cast<float>(S);
#pragma unroll
    for (int s = 0; s < S; ++s) occ_out[s * stride + i] = occ[s] ? 1.0f : 0.0f;
  }
}

template <int S>
void launch(const float* point3, const float* normal3, const float* u, int n,
            const float* tripack, int t_count, const float* lightpack,
            int l_count, float* mc_out, float* occ_out, cudaStream_t stream) {
  const int blocks = (n + ptt::kThreads - 1) / ptt::kThreads;
  nee_kernel<S><<<blocks, ptt::kThreads, 0, stream>>>(
      point3, normal3, u, n, tripack, t_count, lightpack, l_count, mc_out,
      occ_out);
}

}  // namespace

// point3, normal3: float32 [3, n]; u: float32 [5 * s_samples, n];
// tripack: float32 [t_count, 12]; lightpack: float32 [l_count, 12] with the
// cumulative light area in column 9; mc_out: float32 [n];
// occ_out: float32 [s_samples, n]. Launches on ``stream`` of CUDA device
// ``device`` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_nee_mean_cos(const float* point3, const float* normal3,
                                const float* u, int n, int s_samples,
                                const float* tripack, int t_count,
                                const float* lightpack, int l_count,
                                float* mc_out, float* occ_out, int device,
                                void* stream) {
  if (n <= 0 || t_count < 0 || l_count < 1 || l_count > kMaxLight)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s_samples) {
#define PTT_NEE_CASE(S)                                                    \
  case S:                                                                  \
    launch<S>(point3, normal3, u, n, tripack, t_count, lightpack, l_count, \
              mc_out, occ_out, st);                                        \
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
