// Weighted row gather of packed corner rows for multi-scale deformable
// attention.
//
// Replaces: dskd_tpu/ops/mxu_gather.py `mxu_gather_weighted` forward
// (`_fwd_w_kernel`), the Pallas one-hot kernel that samples levels 1-3 on the
// TPU, and the XLA gather loop that samples level 0 there
// (dskd_tpu/ops/msda.py `ms_deform_attn_core`).
//
//   out[b, q, hd, e] = sum_p table[b, idx[b,q,hd,p], hd, e] * w[b,q,hd,p, e/D]
//
// Each corner weight spans its D-lane chunk of the 4D-wide packed row. Sums
// run in f32 registers; the result is written in the table's type. An index
// outside [0, S) contributes nothing and is never read: on the TPU the
// one-hot row of such an index matches no table row, on the GPU it would be a
// read out of bounds.
//
// What bounds it on the H100: bytes, at random row addresses. Per (b, q, hd)
// it reads P rows of 4D elements (512 B each in f32, 256 B in bf16) and
// writes one; it does 2 flops per byte read. The TPU needed the one-hot
// matmul because its gather is a scalar loop; Hopper gathers rows directly,
// so this kernel does no matmul and its cost is the row reads. In f32 the
// flagship's four level tables hold 27.5, 7.2, 2.0 and 0.6 MB per image, so
// the three small ones stay in the 50 MB L2 while they are sampled.
//
// Design: one warp per (b, q, hd); lane l owns 4 consecutive elements of the
// row, so each row read is one coalesced 16-byte (f32) or 8-byte (bf16) load
// per lane. The table is addressed through explicit batch, row and head
// strides (elements; the row itself is contiguous), so the (B, S', H, 4D)
// output of pack_corners is read in place with no head-major transpose. idx
// and w are contiguous (B, Q, H, P) and (B, Q, H, P, 4) with w in f32; out is
// contiguous (B, Q, H, 4D).
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

__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  uint2 q;
  q.x = *reinterpret_cast<const unsigned*>(&a);
  q.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

template <typename T>
__global__ void gather_weighted_kernel(const T* __restrict__ table,
                                       const int* __restrict__ idx,
                                       const float* __restrict__ w,
                                       T* __restrict__ out, int64_t rows,
                                       int64_t queries, int heads, int points,
                                       int64_t table_rows, int d4, int d,
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
  T* op = out + warp * d4;
  for (int e = lane * 4; e < d4; e += 128) {
    const int c = e / d;                    // corner of this lane's chunk
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < points; ++p) {
      const int r = __ldg(ip + p);
      if (r < 0 || r >= table_rows) continue;
      const float wt = __ldg(wp + p * 4 + c);
      float f[4];
      load4(base + r * stride_s + e, f);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(wt, f[i], acc[i]);
    }
    store4(op + e, acc);
  }
}

template <typename T>
int launch(const void* table, const void* idx, const void* w, void* out,
           int64_t batch, int64_t queries, int64_t heads, int64_t points,
           int64_t table_rows, int64_t d4, int64_t stride_b,
           int64_t stride_s, int64_t stride_h, void* stream) {
  const int64_t rows = batch * queries * heads;
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;                  // 8 warps, 8 (b, q, hd) rows
  const int64_t blocks = (rows * 32 + threads - 1) / threads;
  gather_weighted_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), rows, queries,
      static_cast<int>(heads), static_cast<int>(points), table_rows,
      static_cast<int>(d4), static_cast<int>(d4 / 4), stride_b, stride_s,
      stride_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points, one per table type. Strides are in elements. Returns
// cudaGetLastError() after the launch.
extern "C" int gather_weighted_f32(const void* table, const void* idx,
                                   const void* w, void* out, int64_t batch,
                                   int64_t queries, int64_t heads,
                                   int64_t points, int64_t table_rows,
                                   int64_t d4, int64_t stride_b,
                                   int64_t stride_s, int64_t stride_h,
                                   void* stream) {
  return launch<float>(table, idx, w, out, batch, queries, heads, points,
                       table_rows, d4, stride_b, stride_s, stride_h, stream);
}

extern "C" int gather_weighted_bf16(const void* table, const void* idx,
                                    const void* w, void* out, int64_t batch,
                                    int64_t queries, int64_t heads,
                                    int64_t points, int64_t table_rows,
                                    int64_t d4, int64_t stride_b,
                                    int64_t stride_s, int64_t stride_h,
                                    void* stream) {
  return launch<__nv_bfloat16>(table, idx, w, out, batch, queries, heads,
                               points, table_rows, d4, stride_b, stride_s,
                               stride_h, stream);
}
