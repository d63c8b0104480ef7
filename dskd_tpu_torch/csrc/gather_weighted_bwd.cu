// Backward of the weighted row gather of packed corner rows for multi-scale
// deformable attention, plain and windowed.
//
// Replaces: dskd_tpu/ops/mxu_gather.py `mxu_gather_weighted` backward
// (`_bwd_w_kernel`), the Pallas one-hot kernel that computes the table and
// weight cotangents of levels 1-3 on the TPU, and the XLA scatter-add that
// computes level 0's there (dskd_tpu/ops/msda.py `ms_deform_attn_core`):
// gather_weighted_bwd_{f32,bf16}. And the windowed backwards of
// dskd_tpu/ops/fused_window.py `fused_window_sample` (`bwd_kernel`,
// pallas_call at :170) and dskd_tpu/ops/window_bwd.py `windowed_bwd_sample`
// (`bwd_kernel`, :113), which compute the same function per query tile of
// `tile_q` inside a window of table rows: window_weighted_bwd_{f32,bf16}.
//
//   dtable[b, idx[b,q,hd,p], hd, e] += w[b,q,hd,p, e/D] * dout[b,q,hd,e]
//   dw[b,q,hd,p,c] = sum_{e in chunk c} dout[b,q,hd,e]
//                                       * table[b, idx[b,q,hd,p], hd, e]
//
// An index outside [0, S) adds nothing to dtable, gets dw = 0 and is never
// read, as in the forward. dtable is accumulated in an f32 buffer whatever
// the table's type (the wrapper zeroes it and casts it once at the end);
// the TPU kernel accumulated it in the table's type.
//
// Windows. Query q lies in tile t = q / tile_q, whose window is the rows
// [starts[t], starts[t] + window). On the TPU the window made the one-hot
// product affordable, and a sample outside it (an escape) sent the whole
// segment to the plain path. Here the windowed entry point runs this same
// direct scatter, which adds an escaped row into dtable like any other, and
// keeps the window only in a count: lane p compares sample p's row with its
// tile's window, the warp sums the count, and each block adds its total to
// the device int32 `escapes` once. (An earlier design summed each tile in
// a shared-memory window and flushed it with device atomics; at the 640x480
// segments it took ~4.6x this scatter's time on an H100, PERF.md.)
//
// What bounds it on the H100: per (b, q, hd) it reads P rows of 4D elements
// and one dout row, and adds P * 4D f32 products into dtable at
// data-dependent rows. The bytes (table, dout, dtable, once each) take
// ~0.11 ms for the four levels of a 640x480 canvas at B=2; the adds, 52 M
// per level, are what set the pace: the L2 performs every atomic, so the
// time goes by atomic instructions issued and by how many of them share an
// address (on the 10x8 level all 6,380 encoder queries x 4 points add into
// the same 120 packed rows of each (b, head)). Scalar atomics, four per lane
// and point, spread each warp-wide instruction over four 128-byte lines at
// a 16-byte stride and reach ~160 G adds/s on the H100, ~0.33 ms per level
// whatever its size; the level's size, and so the contention, barely
// matters (PERF.md).
//
// Design: one warp per (b, q, hd); lane l owns 4 consecutive elements of
// each 128-element piece of the row (one 16-byte f32 or 8-byte bf16 load of
// dout and of each table row). The warp takes the points in groups of four:
// it loads their indices and weights, then issues the four table-row loads
// (and the dout row's) before any add, so four rows are in flight. Each
// lane then adds its 4 products with one 16-byte vector atomic
// (atomicAdd(float4*), global memory, compute capability 9.x), so one
// warp-wide instruction covers a whole 512-byte f32 row: four times fewer
// atomic instructions, each on whole lines. The corner dots of a point are
// summed over the warp by a transposing butterfly (6 shuffles for the 4
// corners) and written by the lanes of each corner's group. The sum order of
// the atomics changes from run to run, so the result is compared with a
// tolerance, not bit for bit. The table is addressed through explicit batch,
// row and head strides (elements), so the (B, S', H, 4D) output of
// pack_corners is read in place. idx, w (f32), dout, dtable (f32) and dw
// (f32) are contiguous: (B, Q, H, P), (B, Q, H, P, 4), (B, Q, H, 4D),
// (B, S, H, 4D) and (B, Q, H, P, 4); starts holds ceil(Q / tile_q) int32.
// The wrapper checks that the table, dout and dtable are 16-byte aligned
// with strides and a row width that are multiples of 4 elements, as the
// vector loads and atomics need.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 4;                   // points with rows in flight

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

// The sum over the warp of v[c] for c = lane >> 3: halve the four values
// across lanes 16 apart, then the two across lanes 8 apart, then sum the
// one left over the 8 lanes of its group.
__device__ __forceinline__ float warp_sum4(const float (&v)[4], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const float a = (hi16 ? v[2] : v[0])
                + __shfl_xor_sync(0xffffffffu, hi16 ? v[0] : v[2], 16);
  const float b = (hi16 ? v[3] : v[1])
                + __shfl_xor_sync(0xffffffffu, hi16 ? v[1] : v[3], 16);
  float s = (hi8 ? b : a) + __shfl_xor_sync(0xffffffffu, hi8 ? a : b, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

struct Window {
  const int* starts;                        // one row per tile of tile_q
  int* escapes;                             // device int32 count
  int tile_q, rows;
};

// The scatter and the dots of the (b, q, hd) of warp `warp`; see the header.
template <typename T>
__device__ __forceinline__ void scatter_row(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, const T* __restrict__ dout,
    float* __restrict__ dtable, float* __restrict__ dw, int64_t warp,
    int lane, int64_t queries, int heads, int points, int64_t table_rows,
    int d4, int d, int64_t stride_b, int64_t stride_s, int64_t stride_h) {
  const int hd = static_cast<int>(warp % heads);
  const int64_t b = warp / heads / queries;
  const int* ip = idx + warp * points;
  const float* wp = w + warp * points * 4;
  const T* base = table + b * stride_b + hd * stride_h;
  const int64_t drow = static_cast<int64_t>(heads) * d4;
  float* dbase = dtable + b * table_rows * drow + hd * d4;
  const T* gp = dout + warp * d4;
  float* dwp = dw + warp * points * 4;
  for (int p0 = 0; p0 < points; p0 += kGroup) {
    int64_t r[kGroup];
    bool ok[kGroup];                        // uniform in the warp
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      r[j] = p0 + j < points ? __ldg(ip + p0 + j) : -1;
      ok[j] = r[j] >= 0 && r[j] < table_rows;
    }
    float part[kGroup][4] = {};
    for (int e = lane * 4; e < d4; e += 128) {
      const int c = e / d;                  // corner of this lane's chunk
      float g[4], f[kGroup][4], wt[kGroup];
      load4(gp + e, g);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {    // every row load before an add
        wt[j] = 0.f;
        f[j][0] = f[j][1] = f[j][2] = f[j][3] = 0.f;
        if (ok[j]) {
          wt[j] = __ldg(wp + (p0 + j) * 4 + c);
          load4(base + r[j] * stride_s + e, f[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (!ok[j]) continue;
        atomicAdd(reinterpret_cast<float4*>(dbase + r[j] * drow + e),
                  make_float4(wt[j] * g[0], wt[j] * g[1], wt[j] * g[2],
                              wt[j] * g[3]));
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dot = fmaf(g[i], f[j][i], dot);
#pragma unroll
        for (int k = 0; k < 4; ++k) part[j][k] += (k == c) ? dot : 0.f;
      }
    }
    // lane 8k + j holds dw[p0 + j, k]
    float mine = 0.f;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const float s = warp_sum4(part[j], lane);
      if ((lane & 7) == j) mine = s;
    }
    const int j = lane & 7;
    if (j < kGroup && p0 + j < points) dwp[(p0 + j) * 4 + (lane >> 3)] = mine;
  }
}

// One warp per (b, q, hd). kCountEscapes: also count the samples outside
// their tile's window into win.escapes, one device atomic per block.
template <typename T, bool kCountEscapes>
__global__ void gather_weighted_bwd_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, const T* __restrict__ dout,
    float* __restrict__ dtable, float* __restrict__ dw, int64_t rows,
    int64_t queries, int heads, int points, int64_t table_rows, int d4, int d,
    int64_t stride_b, int64_t stride_s, int64_t stride_h, Window win) {
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if constexpr (!kCountEscapes) {
    if (warp >= rows) return;               // whole warps leave together
    scatter_row(table, idx, w, dout, dtable, dw, warp, lane, queries, heads,
                points, table_rows, d4, d, stride_b, stride_s, stride_h);
  } else {
    __shared__ int block_escapes;
    if (threadIdx.x == 0) block_escapes = 0;
    __syncthreads();
    if (warp < rows) {                      // uniform in the warp
      const int64_t q = (warp / heads) % queries;
      const int start = __ldg(win.starts + q / win.tile_q);
      int esc = 0;
      for (int p = lane; p < points; p += 32) {
        const int64_t local = __ldg(idx + warp * points + p) - start;
        esc += local < 0 || local >= win.rows;
      }
      esc = __reduce_add_sync(0xffffffffu, esc);
      if (lane == 0 && esc) atomicAdd(&block_escapes, esc);
      scatter_row(table, idx, w, dout, dtable, dw, warp, lane, queries,
                  heads, points, table_rows, d4, d, stride_b, stride_s,
                  stride_h);
    }
    __syncthreads();
    if (threadIdx.x == 0 && block_escapes)
      atomicAdd(win.escapes, block_escapes);
  }
}

template <typename T, bool kCountEscapes>
int launch(const void* table, const void* idx, const void* w,
           const void* dout, void* dtable, void* dw, int64_t batch,
           int64_t queries, int64_t heads, int64_t points, int64_t table_rows,
           int64_t d4, int64_t stride_b, int64_t stride_s, int64_t stride_h,
           Window win, void* stream) {
  const int64_t rows = batch * queries * heads;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;                  // 8 warps, 8 (b, q, hd) rows
  const int64_t blocks = (rows * 32 + threads - 1) / threads;
  gather_weighted_bwd_kernel<T, kCountEscapes>
      <<<static_cast<unsigned>(blocks), threads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(table), static_cast<const int*>(idx),
          static_cast<const float*>(w), static_cast<const T*>(dout),
          static_cast<float*>(dtable), static_cast<float*>(dw), rows, queries,
          static_cast<int>(heads), static_cast<int>(points), table_rows,
          static_cast<int>(d4), static_cast<int>(d4 / 4), stride_b, stride_s,
          stride_h, win);
  return static_cast<int>(cudaGetLastError());
}

Window window_of(const void* starts, void* escapes, int64_t tile_q,
                 int64_t window) {
  return Window{static_cast<const int*>(starts), static_cast<int*>(escapes),
                static_cast<int>(tile_q), static_cast<int>(window)};
}

}  // namespace

// Entry points, one per table type (dout has the table's type; w, dtable and
// dw are f32). Strides are the table's, in elements. Each returns
// cudaGetLastError() after its launch.
extern "C" int gather_weighted_bwd_f32(
    const void* table, const void* idx, const void* w, const void* dout,
    void* dtable, void* dw, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t table_rows, int64_t d4, int64_t stride_b,
    int64_t stride_s, int64_t stride_h, void* stream) {
  return launch<float, false>(table, idx, w, dout, dtable, dw, batch, queries,
                              heads, points, table_rows, d4, stride_b,
                              stride_s, stride_h, Window{}, stream);
}

extern "C" int gather_weighted_bwd_bf16(
    const void* table, const void* idx, const void* w, const void* dout,
    void* dtable, void* dw, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t table_rows, int64_t d4, int64_t stride_b,
    int64_t stride_s, int64_t stride_h, void* stream) {
  return launch<__nv_bfloat16, false>(table, idx, w, dout, dtable, dw, batch,
                                      queries, heads, points, table_rows, d4,
                                      stride_b, stride_s, stride_h, Window{},
                                      stream);
}

// The windowed backward: the same scatter, and the samples outside their
// tile's window [starts[q / tile_q], + window) added to `escapes` (one
// device int32).
extern "C" int window_weighted_bwd_f32(
    const void* table, const void* idx, const void* w, const void* dout,
    const void* starts, void* dtable, void* dw, void* escapes, int64_t batch,
    int64_t queries, int64_t heads, int64_t points, int64_t tile_q,
    int64_t window, int64_t table_rows, int64_t d4, int64_t stride_b,
    int64_t stride_s, int64_t stride_h, void* stream) {
  return launch<float, true>(table, idx, w, dout, dtable, dw, batch, queries,
                             heads, points, table_rows, d4, stride_b,
                             stride_s, stride_h,
                             window_of(starts, escapes, tile_q, window),
                             stream);
}

extern "C" int window_weighted_bwd_bf16(
    const void* table, const void* idx, const void* w, const void* dout,
    const void* starts, void* dtable, void* dw, void* escapes, int64_t batch,
    int64_t queries, int64_t heads, int64_t points, int64_t tile_q,
    int64_t window, int64_t table_rows, int64_t d4, int64_t stride_b,
    int64_t stride_s, int64_t stride_h, void* stream) {
  return launch<__nv_bfloat16, true>(table, idx, w, dout, dtable, dw, batch,
                                     queries, heads, points, table_rows, d4,
                                     stride_b, stride_s, stride_h,
                                     window_of(starts, escapes, tile_q,
                                               window),
                                     stream);
}
