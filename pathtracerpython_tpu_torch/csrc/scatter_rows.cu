// scatter_rows: the adjoint of a row gather. values [N, C] summed into
// rows[i] of a zero [n_rows, C] table, in an order fixed by the inputs
// alone, so that the same inputs give the same bits on every launch, stream
// and run. Every table gradient of the port goes through it (ops/gather.py:
// the backwards of the nearest sweeps, of the fused NEE and of cm_take /
// take_rows).
//
// Replaces no TPU kernel: the JAX package's table gradients are XLA's
// scatter-add, the transpose of a gather (pathtracerpython_tpu/ops/
// gather.py:50 take_rows; the jax.vjp of the sweeps' gathers in
// kernels/intersect_pallas.py:512-528 _nearest_bwd and kernels/
// nee_pallas.py:315-325 _nee_vjp_bwd), which XLA sums in a fixed order. On
// the card PyTorch's own candidates, a weighted bincount and index_add_,
// add with float atomics, whose order (and so whose last bits) follows the
// schedule; the weighted bincount also reads its bins' range back to the
// host.
//
// Order. The wrapper sorts the rows stably (torch.sort(stable=True) of int32
// keys: a permutation fixed by the rows, a row's lanes in ascending lane
// order). Level 1 (runs_kernel): thread w takes the sorted positions
// [w * kRun, (w + 1) * kRun) and adds each run of equal keys in it serially,
// in ascending position order, writing the run's sum at the run's first
// position of a scratch [N, C]; the threads that hold a row's first and last
// positions write its bounds. Level 2 (rows_kernel): a row's partials sit at
// its first position and at every multiple of kRun inside it. Up to 32
// partials: lane j of one warp takes partial j, then a shuffle-down tree.
// More: partial j goes to thread j mod T of the block, each thread adds its
// share in ascending order, then a shuffle-down tree in each warp and one
// over the warps. T (the block's width) follows from n_rows. No atomics and
// no host read: the grids follow from N, C and n_rows.
//
// Bound: bytes. The function reads each lane's C floats and its row once and
// writes the table once (~44 bytes a lane at C = 9 with int64 rows). The
// sort, the gathers through the permutation and the scratch are this
// design's own traffic on top; a simple kernel that is right comes first.
// Its time is latency: a level-1 thread's loads hang on the permutation,
// so it issues a batch of kBatch positions' loads before their adds, and it
// takes the values row-major, each lane's C floats in one line (the wrapper
// copies a component-major [N, C] view, as a backward often hands over: a
// strided gather of C lines a lane cost more than the copy).
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 32;         // sorted positions a level-1 thread sums
constexpr int kBatch = 4;        // of them loaded together
constexpr int kMaxCols = 16;     // columns a thread carries at once
constexpr int kRunThreads = 256;
constexpr int kTinyRows = 256;   // up to here a block of kTinyThreads a row
constexpr int kTinyThreads = 1024;
constexpr int kRowThreads = 256; // beyond: a block of 8 warps, a warp a row
constexpr int kRowBlocks = 2048;

__device__ __forceinline__ void store_cols(float* dst, const float* acc,
                                           int nc) {
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j)
    if (j < nc) dst[j] = acc[j];
}

__device__ __forceinline__ void zero_cols(float* acc) {
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) acc[j] = 0.0f;
}

// lane 0 ends with the sum of the warp's 32 values, in a fixed tree
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kRunThreads)
runs_kernel(const float* __restrict__ values, int n, int c,
            const int* __restrict__ keys,
            const long long* __restrict__ perm, int n_rows,
            float* __restrict__ partial, int* __restrict__ bounds) {
  const long long w = static_cast<long long>(blockIdx.x) * kRunThreads +
                      threadIdx.x;
  if (w * kRun >= n) return;
  const int lo = static_cast<int>(w * kRun);
  const int hi = min(lo + kRun, n);
  // each row's first and last position has one owner; a key outside the
  // table (no caller passes one) is summed nowhere
  for (int p = lo; p < hi; ++p) {
    const int k = keys[p];
    if (k < 0 || k >= n_rows) continue;
    if (p == 0 || keys[p - 1] != k) bounds[2 * k] = p;
    if (p == n - 1 || keys[p + 1] != k) bounds[2 * k + 1] = p + 1;
  }
  for (int c0 = 0; c0 < c; c0 += kMaxCols) {
    const int nc = min(kMaxCols, c - c0);
    float acc[kMaxCols];
    zero_cols(acc);
    int start = lo;
    int key = keys[lo];
    for (int p0 = lo; p0 < hi; p0 += kBatch) {
      // the batch's loads first, all in flight together; then its adds in
      // position order
      int k[kBatch];
      float v[kBatch][kMaxCols];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int p = p0 + q;
        k[q] = p < hi ? keys[p] : key;
        const float* src = values + (p < hi ? perm[p] : perm[lo]) * c + c0;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j) v[q][j] = j < nc ? src[j] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (p0 + q >= hi) break;
        if (k[q] != key) {
          store_cols(partial + static_cast<size_t>(start) * c + c0, acc, nc);
          zero_cols(acc);
          start = p0 + q;
          key = k[q];
        }
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (j < nc) acc[j] += v[q][j];
      }
    }
    store_cols(partial + static_cast<size_t>(start) * c + c0, acc, nc);
  }
}

// the position of a row's partial j: its first position, then the
// multiples of kRun inside it
__device__ __forceinline__ size_t partial_at(int s, int j) {
  return j == 0 ? static_cast<size_t>(s)
                : static_cast<size_t>(s / kRun + j) * kRun;
}

__device__ __forceinline__ int partial_count(int s, int e) {
  return s < e ? (e - 1) / kRun - s / kRun + 1 : 0;
}

// a row of at most 32 partials, by one warp
__device__ void warp_row(const float* __restrict__ partial, int c, int s,
                         int count, int lane, float* __restrict__ out_row) {
  for (int c0 = 0; c0 < c; c0 += kMaxCols) {
    const int nc = min(kMaxCols, c - c0);
    float acc[kMaxCols];
    zero_cols(acc);
    if (lane < count) {
      const float* src = partial + partial_at(s, lane) * c + c0;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < nc) acc[j] = src[j];
    }
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[j] = warp_tree(acc[j]);
    if (lane == 0) store_cols(out_row + c0, acc, nc);
  }
}

// a row of more than 32 partials, by the whole block (every thread calls)
__device__ void block_row(const float* __restrict__ partial, int c, int s,
                          int count, float (*warp_sums)[kMaxCols],
                          float* __restrict__ out_row) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int c0 = 0; c0 < c; c0 += kMaxCols) {
    const int nc = min(kMaxCols, c - c0);
    float acc[kMaxCols];
    zero_cols(acc);
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const float* src = partial + partial_at(s, i) * c + c0;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < nc) acc[j] += src[j];
    }
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) acc[j] = warp_tree(acc[j]);
    if (lane == 0) store_cols(warp_sums[warp], acc, nc);
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        acc[j] = warp_tree(lane < warps && j < nc ? warp_sums[lane][j]
                                                  : 0.0f);
      if (lane == 0) store_cols(out_row + c0, acc, nc);
    }
    __syncthreads();
  }
}

// ``group`` rows per block and step: warp w < group takes row base + w if it
// has at most 32 partials; then the block takes the group's longer rows in
// order
__global__ void __launch_bounds__(kTinyThreads)
rows_kernel(const float* __restrict__ partial, int c,
            const int* __restrict__ bounds, int n_rows, int group,
            float* __restrict__ out) {
  __shared__ float warp_sums[kTinyThreads / 32][kMaxCols];
  __shared__ unsigned char long_row[kTinyThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long base = static_cast<long long>(blockIdx.x) * group;
       base < n_rows; base += static_cast<long long>(gridDim.x) * group) {
    if (warp < group) {
      const long long r = base + warp;
      bool is_long = false;
      if (r < n_rows) {
        const int s = bounds[2 * r];
        const int count = partial_count(s, bounds[2 * r + 1]);
        is_long = count > 32;
        if (!is_long) warp_row(partial, c, s, count, lane, out + r * c);
      }
      if (lane == 0) long_row[warp] = is_long;
    }
    __syncthreads();
    for (int g = 0; g < group; ++g) {
      if (!long_row[g]) continue;
      const long long r = base + g;
      const int s = bounds[2 * r];
      block_row(partial, c, s, partial_count(s, bounds[2 * r + 1]),
                warp_sums, out + r * c);
    }
    __syncthreads();
  }
}

}  // namespace

// values: float32 [n, c], row-major; keys: int32 [n],
// the lanes' rows sorted stably, and perm: int64 [n], the sort's permutation
// (keys[p] = rows[perm[p]]); partial: float32 [n, c] scratch; bounds: int32
// [n_rows, 2] scratch; out: float32 [n_rows, c], every entry written. n >= 1,
// 1 <= c, n_rows >= 1. Launches on ``stream`` of CUDA device ``device`` and
// returns the first CUDA error as an int (0 = launched).
extern "C" int ptt_scatter_rows(const float* values, int n, int c,
                                const int* keys, const long long* perm,
                                int n_rows, float* partial, int* bounds,
                                float* out, int device, void* stream) {
  if (n < 1 || c < 1 || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(bounds, 0, sizeof(int) * 2 * static_cast<size_t>(
                                       n_rows), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long windows = (static_cast<long long>(n) + kRun - 1) / kRun;
  runs_kernel<<<static_cast<unsigned>((windows + kRunThreads - 1) /
                                      kRunThreads),
                kRunThreads, 0, s>>>(values, n, c, keys, perm, n_rows,
                                     partial, bounds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows <= kTinyRows) {
    rows_kernel<<<n_rows, kTinyThreads, 0, s>>>(partial, c, bounds, n_rows,
                                                1, out);
  } else {
    const int group = kRowThreads / 32;
    const int blocks = min(kRowBlocks, (n_rows + group - 1) / group);
    rows_kernel<<<blocks, kRowThreads, 0, s>>>(partial, c, bounds, n_rows,
                                               group, out);
  }
  return static_cast<int>(cudaGetLastError());
}
