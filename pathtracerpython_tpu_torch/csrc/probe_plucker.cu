// P1: what the Plücker side products cost on this card's CUDA cores and on
// its tensor cores, beside the classic Möller–Trumbore test.
//
// Replaces the TPU probe scripts/mxu_probe.py (plucker_kernel on the matrix
// unit, mt_kernel on the vector unit): one tile of triangles against a
// wavefront of rays, per-ray (t, index) of the nearest hit, t = 3e38 and
// index = 2^31 - 1 on a miss. Four variants on the same inputs:
//
//   0  classic Möller–Trumbore (mt.cuh), float32 on the CUDA cores;
//   1  Plücker (plucker.cuh), side products as float32 multiplies and adds
//      on the CUDA cores: the production form of K3;
//   2  Plücker with the three side products as
//      mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on the tensor
//      cores, one pass: 16 triangles x 8 rays x K = 8, the K of the TPU
//      pack (edge direction | edge moment | 0 0) . (o x d | d | 0 0);
//   3  the same with the 3xTF32 split: each operand x = hi + lo, both TF32,
//      and side = hi.lo + lo.hi + hi.hi, which recovers about 21 mantissa
//      bits for three times the matrix work.
//
// The plane-t epilogue and the (t, index) merge are in the kernel in every
// variant, so the times compare whole sweeps. What the probe answers: a
// TF32 operand keeps 10 mantissa bits, and a side product is a difference
// of moment terms far larger than the side itself, so variant 2's winners
// differ from the classic form's on rays nowhere near an edge; variant 3
// buys the precision back, and its time says whether tensor cores are worth
// a redesign of K3.
//
// Variants 0 and 1: one thread per ray, the tile staged in shared memory 256
// rows at a time, as K1 and K3's dense sweep. Variants 2 and 3: a warp owns
// 32 rays as four 8-ray B fragments that stay in registers for the whole
// sweep; per 16 triangles it loads three A fragments (one per edge) from the
// staged 36-column rows, runs the mma for each of its four ray groups, and
// each thread finishes the four (triangle, ray) pairs of its accumulator
// registers: sign test, plane t, lexicographic (t, index) merge. A final
// shuffle reduction over the eight lanes that share a ray pair gives the
// per-ray winner. The merge is lexicographic because a thread does not see
// triangles in ascending order.
#include <cuda_runtime.h>

#include "mt.cuh"
#include "plucker.cuh"

namespace {

constexpr int kMiss = 2147483647;
constexpr int kMmaThreads = 128;   // 4 warps
constexpr int kRayGroups = 4;      // 8-ray B fragments per warp
constexpr int kWarpRays = 8 * kRayGroups;

template <class Form>
__global__ void __launch_bounds__(ptt::kThreads)
probe_cores_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                   int n, const float* __restrict__ pack, int t_count,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ typename Form::Tile tile;
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
  float best_t = ptt::kBig;
  int best_idx = kMiss;
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    __syncthreads();
    Form::load(tile, pack, base, rows, -1);
    __syncthreads();
    if (live) {
      for (int j = 0; j < rows; ++j) {
        float t;
        if (Form::use(tile, j) && Form::hit(tile, j, ray, t) && t < best_t) {
          best_t = t;
          best_idx = base + j;
        }
      }
    }
  }
  if (live) {
    t_out[i] = best_t;
    idx_out[i] = best_idx;
  }
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row major) . b (8 x 8, column major), TF32 operands,
// float32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void keep_smaller(float& best_t, int& best_idx,
                                             float t, int idx) {
  if (t < best_t || (t == best_t && idx < best_idx)) {
    best_t = t;
    best_idx = idx;
  }
}

template <bool Split>
__global__ void __launch_bounds__(kMmaThreads)
probe_mma_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                 int n, const float* __restrict__ pack36, int t_count,
                 float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ __align__(16) float tile[ptt::kTile * ptt::kPluckerCols];
  const size_t stride = static_cast<size_t>(n);
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // the fragment's group: A row, B column
  const int tg = lane & 3;   // thread in group: A and B k index, C column pair
  const int warp_base =
      (blockIdx.x * (kMmaThreads / 32) + (threadIdx.x >> 5)) * kWarpRays;

  // B fragments: ray (group q, column g), k = tg and tg + 4 of
  // (m.x, m.y, m.z, d.x, d.y, d.z, 0, 0)
  unsigned b_hi[kRayGroups][2], b_lo[kRayGroups][2];
#pragma unroll
  for (int q = 0; q < kRayGroups; ++q) {
    const int r = warp_base + q * 8 + g;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
    if (r < n) {
      ox = o3[r];
      oy = o3[stride + r];
      oz = o3[2 * stride + r];
      dx = d3[r];
      dy = d3[stride + r];
      dz = d3[2 * stride + r];
    }
    const float mx = oy * dz - oz * dy;
    const float my = oz * dx - ox * dz;
    const float mz = ox * dy - oy * dx;
    const float k0 = tg == 0 ? mx : tg == 1 ? my : tg == 2 ? mz : dx;
    const float k1 = tg == 0 ? dy : tg == 1 ? dz : 0.0f;
    split_tf32(k0, b_hi[q][0], b_lo[q][0]);
    split_tf32(k1, b_hi[q][1], b_lo[q][1]);
  }

  // the rays of this thread's accumulator columns: group q, columns
  // 2 tg and 2 tg + 1
  float rox[kRayGroups][2], roy[kRayGroups][2], roz[kRayGroups][2];
  float rdx[kRayGroups][2], rdy[kRayGroups][2], rdz[kRayGroups][2];
  float best_t[kRayGroups][2];
  int best_idx[kRayGroups][2];
#pragma unroll
  for (int q = 0; q < kRayGroups; ++q) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = warp_base + q * 8 + tg * 2 + c;
      const bool live = r < n;
      rox[q][c] = live ? o3[r] : 0.f;
      roy[q][c] = live ? o3[stride + r] : 0.f;
      roz[q][c] = live ? o3[2 * stride + r] : 0.f;
      rdx[q][c] = live ? d3[r] : 0.f;
      rdy[q][c] = live ? d3[stride + r] : 0.f;
      rdz[q][c] = live ? d3[2 * stride + r] : 0.f;
      best_t[q][c] = ptt::kBig;
      best_idx[q][c] = kMiss;
    }
  }

  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    const int rows16 = (rows + 15) & ~15;
    __syncthreads();
    {
      // stage the rows; zero rows (inside, but parallel and not valid) fill
      // the last 16-row chunk
      const float4* src = reinterpret_cast<const float4*>(
          pack36 + static_cast<size_t>(base) * ptt::kPluckerCols);
      float4* dst = reinterpret_cast<float4*>(tile);
      const int real = rows * (ptt::kPluckerCols / 4);
      for (int k = threadIdx.x; k < rows16 * (ptt::kPluckerCols / 4);
           k += blockDim.x)
        dst[k] = k < real ? src[k] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int chunk = 0; chunk < rows16; chunk += 16) {
      const float* row_a = tile + (chunk + g) * ptt::kPluckerCols;
      const float* row_b = row_a + 8 * ptt::kPluckerCols;
      // A fragments, one per edge: rows g and g + 8, k = tg and tg + 4
      unsigned a_hi[3][4], a_lo[3][4];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        split_tf32(row_a[e * 8 + tg], a_hi[e][0], a_lo[e][0]);
        split_tf32(row_b[e * 8 + tg], a_hi[e][1], a_lo[e][1]);
        split_tf32(row_a[e * 8 + tg + 4], a_hi[e][2], a_lo[e][2]);
        split_tf32(row_b[e * 8 + tg + 4], a_hi[e][3], a_lo[e][3]);
      }
      const float4 pa6 = *reinterpret_cast<const float4*>(row_a + 24);
      const float4 pa7 = *reinterpret_cast<const float4*>(row_a + 28);
      const float4 pb6 = *reinterpret_cast<const float4*>(row_b + 24);
      const float4 pb7 = *reinterpret_cast<const float4*>(row_b + 28);
      const int idx_a = base + chunk + g;
      const int idx_b = idx_a + 8;
#pragma unroll
      for (int q = 0; q < kRayGroups; ++q) {
        float s[3][4];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          s[e][0] = s[e][1] = s[e][2] = s[e][3] = 0.0f;
          if (Split) {
            // the small terms first
            mma_tf32(s[e], a_hi[e], b_lo[q][0], b_lo[q][1]);
            mma_tf32(s[e], a_lo[e], b_hi[q][0], b_hi[q][1]);
          }
          mma_tf32(s[e], a_hi[e], b_hi[q][0], b_hi[q][1]);
        }
        // accumulator i: triangle row g (i < 2) or g + 8, ray column
        // 2 tg + (i & 1)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = i & 1;
          const float4 q6 = i < 2 ? pa6 : pb6;
          const float4 q7 = i < 2 ? pa7 : pb7;
          float t;
          const bool plane =
              ptt::plucker_plane(q6, q7, rox[q][c], roy[q][c], roz[q][c],
                                 rdx[q][c], rdy[q][c], rdz[q][c], t);
          if (plane && q7.z > 0.5f &&
              ptt::plucker_inside(s[0][i], s[1][i], s[2][i]))
            keep_smaller(best_t[q][c], best_idx[q][c], t,
                         i < 2 ? idx_a : idx_b);
        }
      }
    }
  }

  // the eight lanes with this tg hold the same ray pairs over different
  // triangles
#pragma unroll
  for (int q = 0; q < kRayGroups; ++q) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float t = best_t[q][c];
      int idx = best_idx[q][c];
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        const float t_o = __shfl_xor_sync(0xffffffffu, t, m);
        const int idx_o = __shfl_xor_sync(0xffffffffu, idx, m);
        keep_smaller(t, idx, t_o, idx_o);
      }
      const int r = warp_base + q * 8 + tg * 2 + c;
      if (g == 0 && r < n) {
        t_out[r] = t;
        idx_out[r] = idx;
      }
    }
  }
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); tripack: float32 [t_count, 12];
// pack36: float32 [t_count, 36], 16-byte aligned, the Plücker pack of
// tripack; variant: 0 to 3 as above; t_out: float32 [n]; idx_out: int32 [n].
// Launches on ``stream`` of CUDA device ``device`` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_probe_plucker(const float* o3, const float* d3, int n,
                                 const float* tripack, const float* pack36,
                                 int t_count, int variant, float* t_out,
                                 int* idx_out, int device, void* stream) {
  if (n <= 0 || t_count < 0 || variant < 0 || variant > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n + ptt::kThreads - 1) / ptt::kThreads;
  const int mma_rays = (kMmaThreads / 32) * kWarpRays;
  const int mma_blocks = (n + mma_rays - 1) / mma_rays;
  switch (variant) {
    case 0:
      probe_cores_kernel<ptt::ClassicForm><<<blocks, ptt::kThreads, 0, s>>>(
          o3, d3, n, tripack, t_count, t_out, idx_out);
      break;
    case 1:
      probe_cores_kernel<ptt::PluckerForm><<<blocks, ptt::kThreads, 0, s>>>(
          o3, d3, n, pack36, t_count, t_out, idx_out);
      break;
    case 2:
      probe_mma_kernel<false><<<mma_blocks, kMmaThreads, 0, s>>>(
          o3, d3, n, pack36, t_count, t_out, idx_out);
      break;
    default:
      probe_mma_kernel<true><<<mma_blocks, kMmaThreads, 0, s>>>(
          o3, d3, n, pack36, t_count, t_out, idx_out);
  }
  return static_cast<int>(cudaGetLastError());
}
