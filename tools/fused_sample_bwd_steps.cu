// The design steps of the vector backward of
// dskd_tpu_torch/csrc/fused_sample.cu, one kernel with a flag per step, for
// tools/torch_kernel_steps.py to time on the card. Fixed to the flagship's
// P = 4 points; the row width D is a multiple of 4. Each step adds one
// change to the one before it:
//
//   step 0: the first design (the source's generic kernel): one warp per
//           (b, q, hd), the 16 taps one after another, lane l on elements
//           l, l+32, ..., scalar atomics, a 5-shuffle dot per tap
//   step 1: one point's four taps per warp instruction: lane l serves tap
//           l >> 3 and elements 4 * (l & 7) .. +3, one 16-byte vector atomic
//           per lane, g's row loaded once; the points one after another, a
//           3-shuffle dot per point and lane group
//   step 2: + the four points' 16 rows in flight before any add, their dots
//           summed by one transposing butterfly (the source's kernel)
//   step 3: + each point's four weights read as one float4
// The atomics' order changes from run to run, so the steps are held against
// the source's kernel with a tolerance.
#include "../dskd_tpu_torch/csrc/fused_sample.cu"

namespace {

template <typename T, int kG, bool kW4>
__global__ void fused_sample_bwd_step_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, const T* __restrict__ g,
    float* __restrict__ dtable, float* __restrict__ dw, int64_t rows,
    int64_t queries, int heads, int64_t table_rows, int level_w, int d,
    int64_t stride_b, int64_t stride_s, int64_t stride_h) {
  constexpr int n = 4;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const int hd = static_cast<int>(warp % heads);
  const int64_t b = warp / heads / queries;
  const int c = lane >> 3;
  const int64_t off = (c & 1) + (c >> 1) * static_cast<int64_t>(level_w);
  const int* ip = idx + warp * n;
  const float* wp = w + warp * n * 4;
  const T* base = table + b * stride_b + hd * stride_h;
  const int64_t drow = static_cast<int64_t>(heads) * d;
  float* dbase = dtable + b * table_rows * drow + hd * d;
  const T* gp = g + warp * d;
  float* dwp = dw + warp * n * 4;
#pragma unroll
  for (int p0 = 0; p0 < n; p0 += kG) {
    int64_t r[kG];
    bool ok[kG];
    float wt[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      r[k] = __ldg(ip + p0 + k) + off;
      ok[k] = r[k] >= 0 && r[k] < table_rows;
      if (kW4) {
        const float4 q =
            __ldg(reinterpret_cast<const float4*>(wp + (p0 + k) * 4));
        const float v = c == 0 ? q.x : c == 1 ? q.y : c == 2 ? q.z : q.w;
        wt[k] = ok[k] ? v : 0.f;
      } else {
        wt[k] = ok[k] ? __ldg(wp + (p0 + k) * 4 + c) : 0.f;
      }
    }
    float dot[kG] = {};
    for (int e = (lane & 7) * 4; e < d; e += 32) {
      float gv[4], f[kG][4];
      load4(gp + e, gv);
#pragma unroll
      for (int k = 0; k < kG; ++k)
        if (ok[k]) load4(base + r[k] * stride_s + e, f[k]);
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        if (!ok[k]) continue;
        atomicAdd(reinterpret_cast<float4*>(dbase + r[k] * drow + e),
                  make_float4(wt[k] * gv[0], wt[k] * gv[1], wt[k] * gv[2],
                              wt[k] * gv[3]));
#pragma unroll
        for (int i = 0; i < 4; ++i) dot[k] = fmaf(gv[i], f[k][i], dot[k]);
      }
    }
    if constexpr (kG == 4) {
      const float s = group_sum4(dot, lane);
      const int k = (lane >> 1) & 3;
      if (!(lane & 1)) dwp[(p0 + k) * 4 + c] = s;
    } else {
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        float s = dot[k];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (!(lane & 7)) dwp[(p0 + k) * 4 + c] = s;
      }
    }
  }
}

template <typename T>
int launch_step(int step, const void* table, const void* idx, const void* w,
                const void* g, void* dtable, void* dw, int64_t batch,
                int64_t queries, int64_t heads, int64_t table_rows,
                int64_t level_w, int64_t d, int64_t stride_b,
                int64_t stride_s, int64_t stride_h, void* stream) {
  const int64_t rows = batch * queries * heads;
  const auto s = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(table);
  const int* i = static_cast<const int*>(idx);
  const float* wf = static_cast<const float*>(w);
  const T* gt = static_cast<const T*>(g);
  float* dt = static_cast<float*>(dtable);
  float* dwf = static_cast<float*>(dw);
  const int hh = static_cast<int>(heads), lw = static_cast<int>(level_w),
            dd = static_cast<int>(d);
  if (step == 0) {
    fused_sample_bwd_generic_kernel<T><<<blocks_for(rows), kThreads, 0, s>>>(
        t, i, wf, gt, dt, dwf, rows, queries, hh, 4, table_rows, lw, dd,
        stride_b, stride_s, stride_h);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = step == 1 ? fused_sample_bwd_step_kernel<T, 1, false>
              : step == 2 ? fused_sample_bwd_step_kernel<T, 4, false>
                          : fused_sample_bwd_step_kernel<T, 4, true>;
  kernel<<<blocks_for(rows), kThreads, 0, s>>>(
      t, i, wf, gt, dt, dwf, rows, queries, hh, table_rows, lw, dd, stride_b,
      stride_s, stride_h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step's backward (P = 4), f32 or bf16 table and g.
extern "C" int fused_sample_bwd_step(
    int64_t step, int64_t bf16, const void* table, const void* idx,
    const void* w, const void* g, void* dtable, void* dw, int64_t batch,
    int64_t queries, int64_t heads, int64_t table_rows, int64_t level_w,
    int64_t d, int64_t stride_b, int64_t stride_s, int64_t stride_h,
    void* stream) {
  return bf16 ? launch_step<__nv_bfloat16>(
                    static_cast<int>(step), table, idx, w, g, dtable, dw,
                    batch, queries, heads, table_rows, level_w, d, stride_b,
                    stride_s, stride_h, stream)
              : launch_step<float>(static_cast<int>(step), table, idx, w, g,
                                   dtable, dw, batch, queries, heads,
                                   table_rows, level_w, d, stride_b, stride_s,
                                   stride_h, stream);
}
