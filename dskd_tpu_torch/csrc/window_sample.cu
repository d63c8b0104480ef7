// The windowed row gather of multi-scale deformable attention and its
// backward, each in f32 and bf16.
//
// Replaces:
//   1. dskd_tpu/ops/window_gather.py `window_gather` forward (`fwd_kernel`,
//      pallas_call at :115): window_gather_{f32,bf16};
//   2. its backward (`bwd_kernel`, :138): window_gather_bwd_{f32,bf16}.
// The family's weighted kernels compute gather_weighted's function and its
// backward with an escape count, so they are those kernels' windowed entry
// points: the forward of dskd_tpu/ops/fused_window.py `fused_window_sample`
// in gather_weighted.cu, the weighted backward of `fused_window_sample` and
// of dskd_tpu/ops/window_bwd.py `windowed_bwd_sample` in
// gather_weighted_bwd.cu.
//
// Every sample (b, q, hd, p) reads or adds the packed corner row
// r = idx[b, q, hd, p]; query q lies in tile t = q / tile_q, whose window is
// the rows [starts[t], starts[t] + window) of the table.
//   1. out[b, q, hd, p, :]  = table[b, r, hd, :]
//   2. dtable[b, r, hd, :] += g[b, q, hd, p, :]
// An index outside [0, S) reads nothing and adds nothing, as in
// gather_weighted.cu and mxu_gather.cu. Sums run in f32; dtable is an f32
// buffer the wrapper zeroes (and casts once to the table's type).
//
// Escapes. On the TPU a sample outside its tile's window got zero from the
// one-hot window product, and the caller sent the whole segment to the plain
// path through a lax.cond when any sample escaped. Here an escaped row is
// read from, or added (f32 atomic) into, the table in device memory
// directly, so each kernel computes its plain gather's function for any
// input, and no host sync decides a branch. Each kernel adds the number of
// samples outside their window to the device int32 `escapes`.
//
// What bounds them on the H100. The forward reads P rows of 4D elements
// (512 B in f32) per (b, q, hd) at data-dependent addresses and does no
// matmul: the TPU needed the window to make a one-hot matmul affordable,
// while Hopper gathers rows directly. So 1 is bound by bytes and reads the
// rows straight from device memory (a level-0 table is 27.5 MB per image at
// 640x640 in f32, beside a 50 MB L2) with mxu_gather.cu's design: one warp
// per row. The backward 2 reads g once and adds every element of it
// into dtable: 52 M f32 adds at level 0 of 640x640 (409,600 sample rows of
// 128) against 210 MB of g and 55 MB of dtable at B=2. The L2 performs
// every device atomic, so the adds set the pace: by the atomic instructions
// issued, and by how many share a line.
//
// Design of 2: a direct scatter, as in gather_weighted_bwd.cu. One warp per
// (b, q, hd) loads the P indices, then its P sample rows of g (four in
// flight), then adds them: lane l adds elements 4l..4l+3 of each 128-element
// piece with one 16-byte vector f32 atomic (atomicAdd(float4*), global
// memory, compute capability 9.x), so one warp-wide instruction covers a
// whole 512-byte row. The window is left only in the escape count: lane p
// compares sample p's row with its tile's window, the warp sums the count,
// and each block adds its total to `escapes` once. Summing each tile in a
// shared-memory window took 3.7-4.0x this scatter's time at level 0 of
// 640x640 on an H100 and lost to torch's index_add there (PERF.md).
//
// Layouts: the table is addressed through explicit batch, row and head
// strides (elements; a row is contiguous), so pack_corners' (B, S, H, 4D)
// output is read in place; the JAX (N, S, 4D) layout is the case H = 1. idx
// (B, Q, H, P) int32, g (B, Q, H, P, D), out (B, Q, H, P, D) and the f32
// dtable (B, S, H, D) are contiguous; starts holds ceil(Q / tile_q)
// int32. For 2 the wrapper checks that g and dtable are 16-byte aligned and
// the row width D a multiple of 4, as its vector loads and atomics need.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // 8 warps

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ bool in_window(int64_t r, int start, int window) {
  const int64_t local = r - start;
  return local >= 0 && local < window;
}

// 1. Row copy, one warp per sample row (b, q, hd, p). U is the unsigned
// integer of the element's width: the copy moves bits, so it equals the
// one-hot product bit for bit in f32 and bf16.
template <typename U>
__global__ void window_gather_kernel(
    const U* __restrict__ table, const int* __restrict__ idx,
    const int* __restrict__ starts, U* __restrict__ out,
    int* __restrict__ escapes, int64_t rows, int64_t queries, int heads,
    int points, int tile_q, int window, int64_t table_rows, int d,
    int64_t stride_b, int64_t stride_s, int64_t stride_h) {
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const int64_t bqh = warp / points;
  const int hd = static_cast<int>(bqh % heads);
  const int64_t q = (bqh / heads) % queries;
  const int64_t b = bqh / heads / queries;
  const int64_t r = __ldg(idx + warp);
  if (lane == 0 && !in_window(r, __ldg(starts + q / tile_q), window))
    atomicAdd(escapes, 1);
  U* op = out + warp * d;
  if (r < 0 || r >= table_rows) {
    for (int e = lane; e < d; e += 32) op[e] = 0;
    return;
  }
  const U* row = table + b * stride_b + r * stride_s + hd * stride_h;
  for (int e = lane; e < d; e += 32) op[e] = __ldg(row + e);
}

// 2. Scatter-add of sample rows, one warp per (b, q, hd) with its points'
// rows in flight; see the header for the design.
constexpr int kGroup = 4;                   // sample rows in flight per warp

template <typename T>
__global__ void window_gather_bwd_kernel(
    const int* __restrict__ idx, const T* __restrict__ g,
    const int* __restrict__ starts, float* __restrict__ dtable,
    int* __restrict__ escapes, int64_t rows, int64_t queries, int heads,
    int points, int tile_q, int window, int64_t table_rows, int d) {
  __shared__ int block_escapes;
  if (threadIdx.x == 0) block_escapes = 0;
  __syncthreads();
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < rows) {                        // uniform in the warp
    const int hd = static_cast<int>(warp % heads);
    const int64_t q = (warp / heads) % queries;
    const int64_t b = warp / heads / queries;
    const int* ip = idx + warp * points;
    const int start = __ldg(starts + q / tile_q);
    int esc = 0;
    for (int p = lane; p < points; p += 32)
      esc += !in_window(__ldg(ip + p), start, window);
    esc = __reduce_add_sync(0xffffffffu, esc);
    if (lane == 0 && esc) atomicAdd(&block_escapes, esc);
    const int64_t row_stride = static_cast<int64_t>(heads) * d;
    float* dbase = dtable + b * table_rows * row_stride + hd * d;
    const T* gp = g + warp * points * d;
    for (int p0 = 0; p0 < points; p0 += kGroup) {
      int64_t r[kGroup];
      bool ok[kGroup];                      // uniform in the warp
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        r[j] = p0 + j < points ? __ldg(ip + p0 + j) : -1;
        ok[j] = r[j] >= 0 && r[j] < table_rows;
      }
      for (int e = lane * 4; e < d; e += 128) {
        float v[kGroup][4];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)    // every row load before an add
          if (ok[j]) load4(gp + static_cast<int64_t>(p0 + j) * d + e, v[j]);
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          if (ok[j])
            atomicAdd(reinterpret_cast<float4*>(dbase + r[j] * row_stride + e),
                      make_float4(v[j][0], v[j][1], v[j][2], v[j][3]));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_escapes) atomicAdd(escapes, block_escapes);
}

unsigned warp_blocks(int64_t warps) {
  return static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
}

template <typename U>
int launch_gather(const void* table, const void* idx, const void* starts,
                  void* out, void* escapes, int64_t batch, int64_t queries,
                  int64_t heads, int64_t points, int64_t tile_q,
                  int64_t window, int64_t table_rows, int64_t d,
                  int64_t stride_b, int64_t stride_s, int64_t stride_h,
                  void* stream) {
  const int64_t rows = batch * queries * heads * points;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  window_gather_kernel<U><<<warp_blocks(rows), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const U*>(table), static_cast<const int*>(idx),
      static_cast<const int*>(starts), static_cast<U*>(out),
      static_cast<int*>(escapes), rows, queries, static_cast<int>(heads),
      static_cast<int>(points), static_cast<int>(tile_q),
      static_cast<int>(window), table_rows, static_cast<int>(d), stride_b,
      stride_s, stride_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gather_bwd(const void* idx, const void* g, const void* starts,
                      void* dtable, void* escapes, int64_t batch,
                      int64_t queries, int64_t heads, int64_t points,
                      int64_t tile_q, int64_t window, int64_t table_rows,
                      int64_t d, void* stream) {
  const int64_t rows = batch * queries * heads;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  window_gather_bwd_kernel<T><<<warp_blocks(rows), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const T*>(g),
      static_cast<const int*>(starts), static_cast<float*>(dtable),
      static_cast<int*>(escapes), rows, queries, static_cast<int>(heads),
      static_cast<int>(points), static_cast<int>(tile_q),
      static_cast<int>(window), table_rows, static_cast<int>(d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points, one per table type. Strides are the table's, in elements;
// `escapes` is one device int32. Each returns cudaGetLastError() after its
// launch.

// 1. out (B, Q, H, P, d) in the table's type.
extern "C" int window_gather_f32(
    const void* table, const void* idx, const void* starts, void* out,
    void* escapes, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t tile_q, int64_t window, int64_t table_rows,
    int64_t d, int64_t stride_b, int64_t stride_s, int64_t stride_h,
    void* stream) {
  return launch_gather<uint32_t>(table, idx, starts, out, escapes, batch,
                                 queries, heads, points, tile_q, window,
                                 table_rows, d, stride_b, stride_s, stride_h,
                                 stream);
}

extern "C" int window_gather_bf16(
    const void* table, const void* idx, const void* starts, void* out,
    void* escapes, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t tile_q, int64_t window, int64_t table_rows,
    int64_t d, int64_t stride_b, int64_t stride_s, int64_t stride_h,
    void* stream) {
  return launch_gather<uint16_t>(table, idx, starts, out, escapes, batch,
                                 queries, heads, points, tile_q, window,
                                 table_rows, d, stride_b, stride_s, stride_h,
                                 stream);
}

// 2. g (B, Q, H, P, d) in the table's type; dtable (B, S, H, d) f32.
extern "C" int window_gather_bwd_f32(
    const void* idx, const void* g, const void* starts, void* dtable,
    void* escapes, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t tile_q, int64_t window, int64_t table_rows,
    int64_t d, void* stream) {
  return launch_gather_bwd<float>(idx, g, starts, dtable, escapes, batch,
                                  queries, heads, points, tile_q, window,
                                  table_rows, d, stream);
}

extern "C" int window_gather_bwd_bf16(
    const void* idx, const void* g, const void* starts, void* dtable,
    void* escapes, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t tile_q, int64_t window, int64_t table_rows,
    int64_t d, void* stream) {
  return launch_gather_bwd<__nv_bfloat16>(idx, g, starts, dtable, escapes,
                                          batch, queries, heads, points,
                                          tile_q, window, table_rows, d,
                                          stream);
}
