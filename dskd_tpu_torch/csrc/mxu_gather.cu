// Row gather and its scatter-add backward.
//
// Replaces: dskd_tpu/ops/mxu_gather.py `mxu_gather`, forward `_fwd_kernel`
// and backward `_bwd_kernel`, the Pallas one-hot kernels that sample levels
// 1-3 of multi-scale deformable attention on the TPU when the weighted
// variant is switched off (DSKD_WGATHER=0, dskd_tpu/ops/msda.py).
//
//   forward:  out[b, q, hd, p, :] = table[b, idx[b,q,hd,p], hd, :]
//   backward: dtable[b, idx[b,q,hd,p], hd, :] += g[b, q, hd, p, :]
//
// The (N, S, D) layout of the TPU kernel is the case H = 1, P = 1. An index
// outside [0, S) gives a zero row and adds nothing, as its one-hot row
// matches no table row on the TPU; here it is never read or written. The
// forward is a copy, so it moves the elements' bits: f32 and bf16 alike,
// bit for bit equal to the one-hot product. dtable is summed in an f32
// buffer (the wrapper zeroes it and casts it once to the table's type); the
// TPU kernel summed it in the table's type.
//
// What bounds it on the H100: bytes. The forward reads one D-element row
// per (b, q, hd, p) at a random address (the flagship's small tables, 1.0
// to 11 MB at B=2 in f32, stay in the 50 MB L2) and writes it once, D = 4 *
// 32 elements (512 B in f32); no arithmetic. The backward reads g once and
// issues one f32 atomic add per element of it; on a small level thousands
// of rows add into the same hundred table rows, so the adds to one address
// serialize in L2.
//
// Design: one warp per (b, q, hd, p) row; lane l copies elements l, l+32,
// ... so each warp-wide load or store touches one contiguous segment. The
// table is addressed through explicit batch, row and head strides
// (elements; a row itself is contiguous), so the (B, S', H, 4D) output of
// pack_corners is read in place as (B*H, S', 4D) with no transpose. idx is
// contiguous (B, Q, H, P), out and g contiguous (B, Q, H, P, D), dtable
// contiguous (B, S, H, D) f32.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// U is the unsigned integer of the element's width: the copy moves bits,
// and an all-zero pattern is 0.0 in f32 and bf16.
template <typename U>
__global__ void mxu_gather_kernel(const U* __restrict__ table,
                                  const int* __restrict__ idx,
                                  U* __restrict__ out, int64_t rows,
                                  int64_t per_batch, int heads, int points,
                                  int64_t table_rows, int d,
                                  int64_t stride_b, int64_t stride_s,
                                  int64_t stride_h) {
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const int hd = static_cast<int>((warp / points) % heads);
  const int64_t b = warp / per_batch;
  const int64_t r = __ldg(idx + warp);
  U* op = out + warp * d;
  if (r < 0 || r >= table_rows) {
    for (int e = lane; e < d; e += 32) op[e] = 0;
    return;
  }
  const U* row = table + b * stride_b + r * stride_s + hd * stride_h;
  for (int e = lane; e < d; e += 32) op[e] = __ldg(row + e);
}

template <typename T>
__global__ void mxu_gather_bwd_kernel(const int* __restrict__ idx,
                                      const T* __restrict__ g,
                                      float* __restrict__ dtable,
                                      int64_t rows, int64_t per_batch,
                                      int heads, int points,
                                      int64_t table_rows, int d) {
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const int64_t r = __ldg(idx + warp);
  if (r < 0 || r >= table_rows) return;
  const int hd = static_cast<int>((warp / points) % heads);
  const int64_t b = warp / per_batch;
  float* drow = dtable + ((b * table_rows + r) * heads + hd) * d;
  const T* gp = g + warp * d;
  for (int e = lane; e < d; e += 32) atomicAdd(drow + e, to_f32(gp[e]));
}

constexpr int kThreads = 256;               // 8 warps, 8 rows per block

unsigned blocks_for(int64_t rows) {
  return static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
}

template <typename U>
int launch_fwd(const void* table, const void* idx, void* out, int64_t batch,
               int64_t queries, int64_t heads, int64_t points,
               int64_t table_rows, int64_t d, int64_t stride_b,
               int64_t stride_s, int64_t stride_h, void* stream) {
  const int64_t per_batch = queries * heads * points;
  const int64_t rows = batch * per_batch;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  mxu_gather_kernel<U><<<blocks_for(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(table), static_cast<const int*>(idx),
      static_cast<U*>(out), rows, per_batch, static_cast<int>(heads),
      static_cast<int>(points), table_rows, static_cast<int>(d), stride_b,
      stride_s, stride_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* idx, const void* g, void* dtable, int64_t batch,
               int64_t queries, int64_t heads, int64_t points,
               int64_t table_rows, int64_t d, void* stream) {
  const int64_t per_batch = queries * heads * points;
  const int64_t rows = batch * per_batch;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  mxu_gather_bwd_kernel<T><<<blocks_for(rows), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const T*>(g),
      static_cast<float*>(dtable), rows, per_batch, static_cast<int>(heads),
      static_cast<int>(points), table_rows, static_cast<int>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points, one per table type. Strides are the table's, in elements.
// Each returns cudaGetLastError() after its launch.
extern "C" int mxu_gather_f32(const void* table, const void* idx, void* out,
                              int64_t batch, int64_t queries, int64_t heads,
                              int64_t points, int64_t table_rows, int64_t d,
                              int64_t stride_b, int64_t stride_s,
                              int64_t stride_h, void* stream) {
  return launch_fwd<uint32_t>(table, idx, out, batch, queries, heads, points,
                              table_rows, d, stride_b, stride_s, stride_h,
                              stream);
}

extern "C" int mxu_gather_bf16(const void* table, const void* idx, void* out,
                               int64_t batch, int64_t queries, int64_t heads,
                               int64_t points, int64_t table_rows, int64_t d,
                               int64_t stride_b, int64_t stride_s,
                               int64_t stride_h, void* stream) {
  return launch_fwd<uint16_t>(table, idx, out, batch, queries, heads, points,
                              table_rows, d, stride_b, stride_s, stride_h,
                              stream);
}

// g has the table's type; dtable is f32.
extern "C" int mxu_gather_bwd_f32(const void* idx, const void* g,
                                  void* dtable, int64_t batch,
                                  int64_t queries, int64_t heads,
                                  int64_t points, int64_t table_rows,
                                  int64_t d, void* stream) {
  return launch_bwd<float>(idx, g, dtable, batch, queries, heads, points,
                           table_rows, d, stream);
}

extern "C" int mxu_gather_bwd_bf16(const void* idx, const void* g,
                                   void* dtable, int64_t batch,
                                   int64_t queries, int64_t heads,
                                   int64_t points, int64_t table_rows,
                                   int64_t d, void* stream) {
  return launch_bwd<__nv_bfloat16>(idx, g, dtable, batch, queries, heads,
                                   points, table_rows, d, stream);
}
