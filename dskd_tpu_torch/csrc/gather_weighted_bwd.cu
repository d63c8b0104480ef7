// Backward of the weighted row gather of packed corner rows for multi-scale
// deformable attention.
//
// Replaces: dskd_tpu/ops/mxu_gather.py `mxu_gather_weighted` backward
// (`_bwd_w_kernel`), the Pallas one-hot kernel that computes the table and
// weight cotangents of levels 1-3 on the TPU, and the XLA scatter-add that
// computes level 0's there (dskd_tpu/ops/msda.py `ms_deform_attn_core`).
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
// What bounds it on the H100: per (b, q, hd) it reads P rows of 4D elements
// and one dout row, and issues P * 4D f32 atomic adds into dtable. The
// atomics are the cost: on a small level thousands of queries land on the
// same hundred rows (the 10x8 level of a 640x480 canvas packs 120 rows and
// takes all 6,380 encoder queries x 8 heads x 4 points), so the adds to one
// address serialize in L2. The sum order of the atomics changes from run to
// run, so the result is compared with a tolerance, not bit for bit.
//
// Design: one warp per (b, q, hd), as in the forward; lane l owns 4
// consecutive elements of the row (one 16-byte f32 or 8-byte bf16 load of
// dout and of the table row). For each point p the lane adds its 4 products
// into dtable with scalar atomics and forms its part of the corner dot; a
// butterfly of warp shuffles sums the four corner dots over the warp, and
// lanes 0-3 write dw[p, 0:4]. The table is addressed through explicit batch,
// row and head strides (elements), so the (B, S', H, 4D) output of
// pack_corners is read in place. idx, w (f32), dout, dtable (f32) and dw
// (f32) are contiguous: (B, Q, H, P), (B, Q, H, P, 4), (B, Q, H, 4D),
// (B, S, H, 4D) and (B, Q, H, P, 4).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T>
__global__ void gather_weighted_bwd_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, const T* __restrict__ dout,
    float* __restrict__ dtable, float* __restrict__ dw, int64_t rows,
    int64_t queries, int heads, int points, int64_t table_rows, int d4, int d,
    int64_t stride_b, int64_t stride_s, int64_t stride_h) {
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;                 // whole warps leave together
  const int hd = static_cast<int>(warp % heads);
  const int64_t b = warp / heads / queries;
  const int* ip = idx + warp * points;
  const float* wp = w + warp * points * 4;
  const T* base = table + b * stride_b + hd * stride_h;
  const int64_t drow = static_cast<int64_t>(heads) * d4;
  float* dbase = dtable + b * table_rows * drow + hd * d4;
  const T* gp = dout + warp * d4;
  float* dwp = dw + warp * points * 4;
  for (int p = 0; p < points; ++p) {
    const int r = __ldg(ip + p);
    const bool in_range = r >= 0 && r < table_rows;   // uniform in the warp
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    if (in_range) {
      const T* row = base + r * stride_s;
      float* drow_p = dbase + r * drow;
      for (int e = lane * 4; e < d4; e += 128) {
        const int c = e / d;                // corner of this lane's chunk
        const float wt = __ldg(wp + p * 4 + c);
        float g[4], f[4];
        load4(gp + e, g);
        load4(row + e, f);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          atomicAdd(drow_p + e + i, wt * g[i]);
          dot = fmaf(g[i], f[i], dot);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) part[k] += (k == c) ? dot : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
    }
    if (lane < 4) {
      const float v = lane == 0 ? part[0]
                    : lane == 1 ? part[1]
                    : lane == 2 ? part[2] : part[3];
      dwp[p * 4 + lane] = v;
    }
  }
}

template <typename T>
int launch(const void* table, const void* idx, const void* w,
           const void* dout, void* dtable, void* dw, int64_t batch,
           int64_t queries, int64_t heads, int64_t points, int64_t table_rows,
           int64_t d4, int64_t stride_b, int64_t stride_s, int64_t stride_h,
           void* stream) {
  const int64_t rows = batch * queries * heads;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;                  // 8 warps, 8 (b, q, hd) rows
  const int64_t blocks = (rows * 32 + threads - 1) / threads;
  gather_weighted_bwd_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<const T*>(dout),
      static_cast<float*>(dtable), static_cast<float*>(dw), rows, queries,
      static_cast<int>(heads), static_cast<int>(points), table_rows,
      static_cast<int>(d4), static_cast<int>(d4 / 4), stride_b, stride_s,
      stride_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points, one per table type (dout has the table's type; w, dtable and
// dw are f32). Strides are the table's, in elements. Returns
// cudaGetLastError() after the launch.
extern "C" int gather_weighted_bwd_f32(
    const void* table, const void* idx, const void* w, const void* dout,
    void* dtable, void* dw, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t table_rows, int64_t d4, int64_t stride_b,
    int64_t stride_s, int64_t stride_h, void* stream) {
  return launch<float>(table, idx, w, dout, dtable, dw, batch, queries, heads,
                       points, table_rows, d4, stride_b, stride_s, stride_h,
                       stream);
}

extern "C" int gather_weighted_bwd_bf16(
    const void* table, const void* idx, const void* w, const void* dout,
    void* dtable, void* dw, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t table_rows, int64_t d4, int64_t stride_b,
    int64_t stride_s, int64_t stride_h, void* stream) {
  return launch<__nv_bfloat16>(table, idx, w, dout, dtable, dw, batch,
                               queries, heads, points, table_rows, d4,
                               stride_b, stride_s, stride_h, stream);
}
