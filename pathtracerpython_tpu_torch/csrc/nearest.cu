// K1 and K3's dense nearest sweep: dense nearest hit, one thread per ray,
// in the classic Möller–Trumbore form (K1) and in the Plücker form (K3,
// plucker.cuh); the form is the kernel's template parameter, the sweep and
// the merge are the same.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/intersect_pallas.py
// _nearest_t_idx (the pallas_call over _nearest_kernel_plain /
// _nearest_kernel_cull, with _mt_rows and _merge_nearest_tile; under
// MT_IMPL = "plucker" over _nearest_kernel_plucker_plain / _cull with
// _plucker_block). The TPU's block cull changes no result and is not
// carried over.
//
// What bounds it on an H100: arithmetic. Each ray-triangle pair costs about
// 60 flops (one of them an IEEE division), while the triangle data is tiny
// (a few KB for the Cornell box) and is re-read by every ray. The design
// keeps that re-read on chip: a block of 256 rays stages the packed
// triangles in shared memory, 256 rows at a time with e1/e2 formed once at
// load, and every thread walks the tile as a broadcast read, keeping its
// running (t, index) minimum in registers. No [rays x triangles] buffer
// exists anywhere. Rays are not padded: the ragged edge is masked (i < n).
//
// Winner rule: triangles are walked in increasing global index and a hit
// replaces the best only when its t is strictly smaller, so the smallest
// index wins among equal t — the same winner as the TPU kernel's per-tile
// first minimum followed by a strict < across tiles. A miss gives t = 0 and
// index -1.
#include <cuda_runtime.h>

#include "mt.cuh"
#include "plucker.cuh"

namespace {

template <class Form>
__global__ void __launch_bounds__(ptt::kThreads)
nearest_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
               int n, const float* __restrict__ tripack, int t_count,
               float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ typename Form::Tile tile;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = o3[i];
    oy = o3[n + i];
    oz = o3[2 * static_cast<size_t>(n) + i];
    dx = d3[i];
    dy = d3[n + i];
    dz = d3[2 * static_cast<size_t>(n) + i];
  }
  const typename Form::Ray ray = Form::make_ray(ox, oy, oz, dx, dy, dz);
  float best_t = ptt::kBig;
  int best_idx = -1;
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    __syncthreads();  // the previous tile is no longer read
    Form::load(tile, tripack, base, rows, -1);
    __syncthreads();
    if (live) {
      for (int j = 0; j < rows; ++j) {
        if (!Form::use(tile, j)) continue;
        float t;
        if (Form::hit(tile, j, ray, t) && t < best_t) {
          best_t = t;
          best_idx = base + j;
        }
      }
    }
  }
  if (live) {
    t_out[i] = best_idx >= 0 ? best_t : 0.0f;
    idx_out[i] = best_idx;
  }
}

template <class Form>
int launch_nearest(const float* o3, const float* d3, int n, const float* pack,
                   int t_count, float* t_out, int* idx_out, int device,
                   void* stream) {
  if (n <= 0 || t_count < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + ptt::kThreads - 1) / ptt::kThreads;
  nearest_kernel<Form><<<blocks, ptt::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      o3, d3, n, pack, t_count, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); tripack: float32 [t_count, 12];
// t_out: float32 [n]; idx_out: int32 [n]. Launches on ``stream`` of CUDA
// device ``device`` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_nearest_t_idx(const float* o3, const float* d3, int n,
                                 const float* tripack, int t_count,
                                 float* t_out, int* idx_out, int device,
                                 void* stream) {
  return launch_nearest<ptt::ClassicForm>(o3, d3, n, tripack, t_count, t_out,
                                          idx_out, device, stream);
}

// The same in the Plücker form; pack36: float32 [t_count, 36], 16-byte
// aligned (kernels/intersect.py: plucker_pack).
extern "C" int ptt_plucker_nearest_t_idx(const float* o3, const float* d3,
                                         int n, const float* pack36,
                                         int t_count, float* t_out,
                                         int* idx_out, int device,
                                         void* stream) {
  return launch_nearest<ptt::PluckerForm>(o3, d3, n, pack36, t_count, t_out,
                                          idx_out, device, stream);
}
