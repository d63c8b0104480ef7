// The design steps of dskd_tpu_torch/csrc/gather_weighted.cu, one kernel
// with a flag per step, for tools/torch_kernel_steps.py to time on the card.
// Fixed to the flagship's P = 4 points and rows of 4D = 128 elements; the
// sums are the production kernel's, bit for bit. Steps 1-5 add one change
// each; 3 and 5 measured slower and were dropped, so step 6 is step 4
// without them, the production kernel with f32 weights.
//
//   step 1: P rows in flight: all four indices and weights, then all four
//           row loads, then the multiply-adds; one sample per warp, a grid
//           over all samples, (b, q, hd) order; bf16 lanes load 8 bytes
//   step 2: + 16-byte bf16 lanes: a half-warp per bf16 row
//   step 3: + persistent blocks that load the next sample's indices and
//           weights before the current one's multiply-adds
//   step 4: + streaming (evict-first) stores
//   step 5: + (b, hd, q) order: a block's samples are consecutive queries of
//           one head
//   step 6: steps 1, 2 and 4
// The production kernel, which reads the weights in their own type, is
// timed beside them.
#include "../dskd_tpu_torch/csrc/gather_weighted.cu"

namespace {

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = bf2(q.x), b = bf2(q.y);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

template <bool kStream>
__device__ __forceinline__ void put(float* p, const float (&f)[4]) {
  if (kStream) {
    store_vec(p, f);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

template <bool kStream>
__device__ __forceinline__ void put(__nv_bfloat16* p, const float (&f)[4]) {
  const uint2 q = make_uint2(pack_bf2(f[0], f[1]), pack_bf2(f[2], f[3]));
  if (kStream) {
    __stcs(reinterpret_cast<uint2*>(p), q);
  } else {
    *reinterpret_cast<uint2*>(p) = q;
  }
}

template <bool kStream>
__device__ __forceinline__ void put(__nv_bfloat16* p, const float (&f)[8]) {
  if (kStream) {
    store_vec(p, f);
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf2(f[0], f[1]), pack_bf2(f[2], f[3]),
                   pack_bf2(f[4], f[5]), pack_bf2(f[6], f[7]));
  }
}

// Sample `it` of the walk -> its (b, q, hd) index `row` and the offset of
// its (b, hd) in the table; in (b, hd, q) order when kQueryMajor.
template <bool kQueryMajor>
__device__ __forceinline__ void where(int it, const Shape& s, int64_t& row,
                                      int64_t& base) {
  int b, q, hd;
  if (kQueryMajor) {
    const int bh = it / s.queries;
    q = it - bh * s.queries;
    b = bh / s.heads;
    hd = bh - b * s.heads;
  } else {
    const int bq = it / s.heads;
    hd = it - bq * s.heads;
    b = bq / s.queries;
    q = bq - b * s.queries;
  }
  row = (static_cast<int64_t>(b) * s.queries + q) * s.heads + hd;
  base = b * s.stride_b + hd * s.stride_h;
}

int multiprocessors() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// kV elements per lane load (4, or 8 for 16-byte bf16 lanes).
template <typename T, int kV, bool kPersist, bool kStream, bool kQueryMajor>
__global__ void __launch_bounds__(kThreads)
step_kernel(const T* __restrict__ table, const int* __restrict__ idx,
            const float* __restrict__ w, T* __restrict__ out, Shape s) {
  constexpr int kP = 4, kD4 = 128;
  constexpr int kG = kD4 / kV;              // lanes per row
  constexpr int kRows = 32 / kG;
  const int lane = threadIdx.x & 31;
  const int e = (lane % kG) * kV;
  const int corner = e / (kD4 / 4);
  const int step = kPersist ? gridDim.x * (kThreads / 32) * kRows : 0;
  int it = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kRows +
           lane / kG;
  if (it >= s.items) return;
  int64_t row, base;
  int r[kP];
  float wt[kP];
  auto fetch = [&](int i, int64_t& rw, int64_t& bs, int (&rr)[kP],
                   float (&ww)[kP]) {
    where<kQueryMajor>(i, s, rw, bs);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int x = __ldg(idx + rw * kP + p);
      const float y = __ldg(w + (rw * kP + p) * 4 + corner);
      const bool ok = static_cast<unsigned>(x) <
                      static_cast<unsigned>(s.table_rows);
      rr[p] = ok ? x : -1;
      ww[p] = ok ? y : 0.f;
    }
  };
  fetch(it, row, base, r, wt);
  while (true) {
    float f[kP][kV];
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (r[p] >= 0) {
        load_vec(table + base + static_cast<int64_t>(r[p]) * s.stride_s + e,
                 f[p]);
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) f[p][i] = 0.f;
      }
    }
    const int next = it + step;
    const bool more = kPersist && next < s.items;
    int64_t nrow = 0, nbase = 0;
    int nr[kP];
    float nwt[kP];
    if (more) fetch(next, nrow, nbase, nr, nwt);
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = fmaf(wt[p], f[p][i], acc[i]);
    }
    put<kStream>(out + row * kD4 + e, acc);
    if (!more) break;
    it = next;
    row = nrow;
    base = nbase;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      r[p] = nr[p];
      wt[p] = nwt[p];
    }
  }
}

template <typename T, int kV, bool kPersist, bool kStream, bool kQueryMajor>
cudaError_t run_step(const void* table, const void* idx, const void* w,
                     void* out, const Shape& s, cudaStream_t stream) {
  auto kernel = step_kernel<T, kV, kPersist, kStream, kQueryMajor>;
  const int rows_per_block = kThreads / 32 * (32 / (128 / kV));
  int64_t blocks = (static_cast<int64_t>(s.items) + rows_per_block - 1) /
                   rows_per_block;
  if (kPersist) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    const int64_t cap = static_cast<int64_t>(multiprocessors()) * per_sm;
    if (blocks > cap) blocks = cap;
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx),
      static_cast<const float*>(w), static_cast<T*>(out), s);
  return cudaGetLastError();
}

template <typename T, int kWide>
cudaError_t by_step(int step, const void* table, const void* idx,
                    const void* w, void* out, const Shape& s,
                    cudaStream_t st) {
  switch (step) {
    case 1: return run_step<T, 4, false, false, false>(table, idx, w, out, s,
                                                       st);
    case 2: return run_step<T, kWide, false, false, false>(table, idx, w, out,
                                                           s, st);
    case 3: return run_step<T, kWide, true, false, false>(table, idx, w, out,
                                                          s, st);
    case 4: return run_step<T, kWide, true, true, false>(table, idx, w, out,
                                                         s, st);
    case 5: return run_step<T, kWide, true, true, true>(table, idx, w, out, s,
                                                        st);
    case 6: return run_step<T, kWide, false, true, false>(table, idx, w, out,
                                                          s, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One design step (1-6) on a contiguous-row (B, S, H, 128) table with
// (B, Q, H, 4) int32 indices and (B, Q, H, 4, 4) f32 weights; strides in
// elements. Returns cudaGetLastError() after the launch.
extern "C" int gather_weighted_step(int64_t step, int64_t table_bf16,
                                    const void* table, const void* idx,
                                    const void* w, void* out, int64_t batch,
                                    int64_t queries, int64_t heads,
                                    int64_t table_rows, int64_t stride_b,
                                    int64_t stride_s, int64_t stride_h,
                                    void* stream) {
  const Shape s{static_cast<int>(batch * queries * heads),
                static_cast<int>(queries), static_cast<int>(heads), 4,
                static_cast<int>(table_rows), 0, 0, stride_b, stride_s,
                stride_h};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k = static_cast<int>(step);
  return static_cast<int>(
      table_bf16 ? by_step<__nv_bfloat16, 8>(k, table, idx, w, out, s, st)
                 : by_step<float, 4>(k, table, idx, w, out, s, st));
}
