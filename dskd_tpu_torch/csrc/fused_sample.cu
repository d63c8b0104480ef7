// Fused bilinear sampling of the raw level table for multi-scale deformable
// attention, forward and backward.
//
// Replaces: dskd_tpu/ops/fused_sample.py `fused_msda_sample`, forward
// `_fwd_kernel` and backward `_bwd_kernel`, the Pallas kernels that build a
// one-hot row with four weighted taps per sampling point and contract it
// with the unpacked (h*w, D) level table on the TPU (DSKD_FUSED_ROWS,
// dskd_tpu/ops/msda.py).
//
//   row(p, c) = idx[b,q,hd,p] + off[c],  off = (0, 1, W, W + 1)
//   out[b,q,hd,:] = sum_{p,c} w[b,q,hd,p,c] * table[b, row(p,c), hd, :]
//   dtable[b, row(p,c), hd, :] += w[b,q,hd,p,c] * g[b,q,hd,:]
//   dw[b,q,hd,p,c] = <g[b,q,hd,:], table[b, row(p,c), hd, :]>
//
// idx is the UNCLIPPED top-left corner y0*W + x0, so it can be negative or
// past the table, and c00+1 can wrap into the next image row. Each of the
// four taps is checked against [0, S) on its own: a tap outside adds
// nothing, is never read, and gets dw = 0 (its one-hot column matches no
// table row on the TPU). A tap inside with weight 0 (a wrapped or gated
// corner) still gets dw = <g, table[row]>, as the Pallas backward gives it.
// Sums run in f32 registers; out has the table's type; dtable is summed in
// an f32 buffer (the wrapper zeroes it and casts it once); dw is f32.
//
// What bounds it on the H100: the forward reads 4 * P rows of D elements
// (128 B each for D = 32 in f32) per (b, q, hd) at random addresses in a
// table of at most a few MB (L2-resident) and writes one row: bytes, at 2
// flops per element read. The backward adds w * g into dtable, 4 * P * D
// f32 adds per (b, q, hd); the L2 performs every atomic, so the atomic
// instructions issued, and how many of them share an address, set its pace
// (on the 10x8 level all 6,380 encoder queries of an image land on 80 rows
// of each (b, head)).
//
// Forward design: one warp per (b, q, hd); lane l owns elements l, l+32, ...
// of the row, so every tap is one coalesced warp load.
//
// Backward design (D a multiple of 4): one warp per (b, q, hd) holds the
// four taps of a point at once. Lane l serves tap c = l >> 3 and elements
// 4 * (l & 7) .. +3 of each 32-element piece of the row, so one warp-wide
// load reads the four taps' rows (4 x 128 B in f32, 4 x 64 B in bf16) and
// one warp-wide 16-byte vector atomic (atomicAdd(float4*), global memory,
// compute capability 9.x) adds all four. The range check is a predicate of
// each 8-lane group. g's row is loaded once per piece, not once per tap.
// The warp takes the points in groups of four (P = 4 is a template
// instantiation): their indices and weights, then all 16 taps' row loads,
// then the adds, so 16 rows are in flight. The four points' dw dots are
// summed over each 8-lane group by a transposing butterfly (4 shuffles)
// and written by the group's even lanes. The atomics' sum order changes
// from run to run: results are compared with a tolerance. The first design,
// kept for D not a multiple of 4, walks the 16 taps one after another with
// one row in flight, scalar atomics and a 5-shuffle dot per tap: ~230 G
// in-range adds/s on an H100 over levels 1-3 of 640x480, against ~508 for
// this one (PERF.md).
//
// The table is addressed through explicit batch, row and head strides
// (elements), so a level slice of the (B, S, H, D) value is read in place.
// idx (B, Q, H, P) int32, w (B, Q, H, P, 4) f32, out and g (B, Q, H, D),
// dtable (B, S, H, D) f32 and dw (B, Q, H, P, 4) f32 are contiguous. For
// the vector backward the wrapper checks that the table, g and dtable are
// 16-byte aligned and the table's strides whole vectors of 4 elements.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void fused_sample_kernel(const T* __restrict__ table,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ w,
                                    T* __restrict__ out, int64_t rows,
                                    int64_t queries, int heads, int points,
                                    int64_t table_rows, int level_w, int d,
                                    int64_t stride_b, int64_t stride_s,
                                    int64_t stride_h) {
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const int hd = static_cast<int>(warp % heads);
  const int64_t b = warp / heads / queries;
  const int* ip = idx + warp * points;
  const float* wp = w + warp * points * 4;
  const T* base = table + b * stride_b + hd * stride_h;
  const int64_t off[4] = {0, 1, level_w, level_w + 1};
  for (int e = lane; e < d; e += 32) {
    float acc = 0.f;
    for (int p = 0; p < points; ++p) {
      const int64_t c00 = __ldg(ip + p);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t r = c00 + off[c];
        if (r < 0 || r >= table_rows) continue;
        acc = fmaf(__ldg(wp + p * 4 + c), to_f32(base[r * stride_s + e]),
                   acc);
      }
    }
    store(out + warp * d + e, acc);
  }
}

// The first backward design, kept for D not a multiple of 4: the taps one
// after another, scalar atomics.
template <typename T>
__global__ void fused_sample_bwd_generic_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, const T* __restrict__ g,
    float* __restrict__ dtable, float* __restrict__ dw, int64_t rows,
    int64_t queries, int heads, int points, int64_t table_rows, int level_w,
    int d, int64_t stride_b, int64_t stride_s, int64_t stride_h) {
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;                 // whole warps leave together
  const int hd = static_cast<int>(warp % heads);
  const int64_t b = warp / heads / queries;
  const int* ip = idx + warp * points;
  const float* wp = w + warp * points * 4;
  const T* base = table + b * stride_b + hd * stride_h;
  float* dbase = dtable + b * table_rows * heads * d + hd * d;
  const int64_t drow = static_cast<int64_t>(heads) * d;
  const T* gp = g + warp * d;
  float* dwp = dw + warp * points * 4;
  const int64_t off[4] = {0, 1, level_w, level_w + 1};
  for (int p = 0; p < points; ++p) {
    const int64_t c00 = __ldg(ip + p);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t r = c00 + off[c];
      const bool in_range = r >= 0 && r < table_rows;  // uniform in the warp
      float dot = 0.f;
      if (in_range) {
        const float wt = __ldg(wp + p * 4 + c);
        const T* row = base + r * stride_s;
        float* drow_p = dbase + r * drow;
        for (int e = lane; e < d; e += 32) {
          const float gv = to_f32(gp[e]);
          atomicAdd(drow_p + e, wt * gv);
          dot = fmaf(gv, to_f32(row[e]), dot);
        }
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, s);
      if (lane == 0) dwp[p * 4 + c] = dot;
    }
  }
}

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

// The sum over the 8 lanes of the lane's group of v[k], k = (lane >> 1) & 3:
// halve the four values across lanes 4 apart, then the two across lanes 2
// apart, then sum the one left with the lane 1 apart.
__device__ __forceinline__ float group_sum4(const float (&v)[4], int lane) {
  const bool hi4 = lane & 4, hi2 = lane & 2;
  const float a = (hi4 ? v[2] : v[0])
                + __shfl_xor_sync(0xffffffffu, hi4 ? v[0] : v[2], 4);
  const float b = (hi4 ? v[3] : v[1])
                + __shfl_xor_sync(0xffffffffu, hi4 ? v[1] : v[3], 4);
  const float s = (hi2 ? b : a) + __shfl_xor_sync(0xffffffffu, hi2 ? a : b, 2);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

constexpr int kGroup = 4;                   // points whose taps fly together

// The backward for D a multiple of 4: one warp per (b, q, hd), one 8-lane
// group per tap, kP points (0: `points` at run time) in groups of kGroup;
// see the header.
template <typename T, int kP>
__global__ void fused_sample_bwd_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, const T* __restrict__ g,
    float* __restrict__ dtable, float* __restrict__ dw, int64_t rows,
    int64_t queries, int heads, int points, int64_t table_rows, int level_w,
    int d, int64_t stride_b, int64_t stride_s, int64_t stride_h) {
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;                 // whole warps leave together
  const int n = kP ? kP : points;
  const int hd = static_cast<int>(warp % heads);
  const int64_t b = warp / heads / queries;
  const int c = lane >> 3;                  // this lane's tap
  const int64_t off = (c & 1) + (c >> 1) * static_cast<int64_t>(level_w);
  const int* ip = idx + warp * n;
  const float* wp = w + warp * n * 4;
  const T* base = table + b * stride_b + hd * stride_h;
  const int64_t drow = static_cast<int64_t>(heads) * d;
  float* dbase = dtable + b * table_rows * drow + hd * d;
  const T* gp = g + warp * d;
  float* dwp = dw + warp * n * 4;
  for (int p0 = 0; p0 < n; p0 += kGroup) {
    int64_t r[kGroup];
    bool ok[kGroup];                        // uniform in the lane group
    float wt[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      r[k] = p0 + k < n ? __ldg(ip + p0 + k) + off : -1;
      ok[k] = r[k] >= 0 && r[k] < table_rows;
      wt[k] = ok[k] ? __ldg(wp + (p0 + k) * 4 + c) : 0.f;
    }
    float dot[kGroup] = {};
    for (int e = (lane & 7) * 4; e < d; e += 32) {
      float gv[4], f[kGroup][4];
      load4(gp + e, gv);
#pragma unroll
      for (int k = 0; k < kGroup; ++k)      // every row load before an add
        if (ok[k]) load4(base + r[k] * stride_s + e, f[k]);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (!ok[k]) continue;
        atomicAdd(reinterpret_cast<float4*>(dbase + r[k] * drow + e),
                  make_float4(wt[k] * gv[0], wt[k] * gv[1], wt[k] * gv[2],
                              wt[k] * gv[3]));
#pragma unroll
        for (int i = 0; i < 4; ++i) dot[k] = fmaf(gv[i], f[k][i], dot[k]);
      }
    }
    // lane 8c + 2k (+1) holds dw[p0 + k, c]
    const float s = group_sum4(dot, lane);
    const int k = (lane >> 1) & 3;
    if (!(lane & 1) && p0 + k < n) dwp[(p0 + k) * 4 + c] = s;
  }
}

constexpr int kThreads = 256;               // 8 warps, 8 (b, q, hd) rows

unsigned blocks_for(int64_t rows) {
  return static_cast<unsigned>((rows * 32 + kThreads - 1) / kThreads);
}

template <typename T>
int launch_fwd(const void* table, const void* idx, const void* w, void* out,
               int64_t batch, int64_t queries, int64_t heads, int64_t points,
               int64_t table_rows, int64_t level_w, int64_t d,
               int64_t stride_b, int64_t stride_s, int64_t stride_h,
               void* stream) {
  const int64_t rows = batch * queries * heads;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  fused_sample_kernel<T><<<blocks_for(rows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), rows, queries,
      static_cast<int>(heads), static_cast<int>(points), table_rows,
      static_cast<int>(level_w), static_cast<int>(d), stride_b, stride_s,
      stride_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* table, const void* idx, const void* w,
               const void* g, void* dtable, void* dw, int64_t batch,
               int64_t queries, int64_t heads, int64_t points,
               int64_t table_rows, int64_t level_w, int64_t d,
               int64_t stride_b, int64_t stride_s, int64_t stride_h,
               void* stream) {
  const int64_t rows = batch * queries * heads;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  auto kernel = d % 4 ? fused_sample_bwd_generic_kernel<T>
              : points == 4 ? fused_sample_bwd_kernel<T, 4>
                            : fused_sample_bwd_kernel<T, 0>;
  kernel<<<blocks_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const T*>(g),
      static_cast<float*>(dtable), static_cast<float*>(dw), rows, queries,
      static_cast<int>(heads), static_cast<int>(points), table_rows,
      static_cast<int>(level_w), static_cast<int>(d), stride_b, stride_s,
      stride_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points, one per table type (w, dtable and dw are f32; out and g
// have the table's type). Strides are the table's, in elements. Each
// returns cudaGetLastError() after its launch.
extern "C" int fused_sample_f32(const void* table, const void* idx,
                                const void* w, void* out, int64_t batch,
                                int64_t queries, int64_t heads,
                                int64_t points, int64_t table_rows,
                                int64_t level_w, int64_t d, int64_t stride_b,
                                int64_t stride_s, int64_t stride_h,
                                void* stream) {
  return launch_fwd<float>(table, idx, w, out, batch, queries, heads, points,
                           table_rows, level_w, d, stride_b, stride_s,
                           stride_h, stream);
}

extern "C" int fused_sample_bf16(const void* table, const void* idx,
                                 const void* w, void* out, int64_t batch,
                                 int64_t queries, int64_t heads,
                                 int64_t points, int64_t table_rows,
                                 int64_t level_w, int64_t d,
                                 int64_t stride_b, int64_t stride_s,
                                 int64_t stride_h, void* stream) {
  return launch_fwd<__nv_bfloat16>(table, idx, w, out, batch, queries, heads,
                                   points, table_rows, level_w, d, stride_b,
                                   stride_s, stride_h, stream);
}

extern "C" int fused_sample_bwd_f32(
    const void* table, const void* idx, const void* w, const void* g,
    void* dtable, void* dw, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t table_rows, int64_t level_w, int64_t d,
    int64_t stride_b, int64_t stride_s, int64_t stride_h, void* stream) {
  return launch_bwd<float>(table, idx, w, g, dtable, dw, batch, queries,
                           heads, points, table_rows, level_w, d, stride_b,
                           stride_s, stride_h, stream);
}

extern "C" int fused_sample_bwd_bf16(
    const void* table, const void* idx, const void* w, const void* g,
    void* dtable, void* dw, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t table_rows, int64_t level_w, int64_t d,
    int64_t stride_b, int64_t stride_s, int64_t stride_h, void* stream) {
  return launch_bwd<__nv_bfloat16>(table, idx, w, g, dtable, dw, batch,
                                   queries, heads, points, table_rows,
                                   level_w, d, stride_b, stride_s, stride_h,
                                   stream);
}
