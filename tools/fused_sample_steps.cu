// The design steps of the forward of dskd_tpu_torch/csrc/fused_sample.cu,
// one flag per step, for tools/torch_kernel_steps.py to time on the card.
// Fixed to the flagship's P = 4 points; the row width D is a multiple of 8.
// Steps 1-4 take B4''s lane layout (the backward's), as the redesign began;
// steps 5 and 6 are the source's kernels, lanes over elements:
//
//   step 0: the first design (the source's generic kernel): one warp per
//           (b, q, hd), lane l on elements l, l+32, ..., the points in a
//           runtime loop, each index loaded before its four taps
//   step 1: B4''s lane layout: lane l serves tap l >> 3 and elements
//           4 * (l & 7) .. +3, the four points' indices and weights, then
//           their 16 rows in flight, then the multiply-adds; a transposing
//           butterfly over the four taps, streaming stores; bf16 lanes load
//           8 bytes
//   step 2: + 16-byte bf16 lanes: four lanes per tap, two samples per warp
//           (f32: step 1)
//   step 3: + taps from shared memory: blocks over (query tile, b * H + hd)
//           stage the (b, hd) slice with cp.async
//   step 4: + batches: a warp loads the indices and weights of 8 queries
//           with five instructions, the next batch's before this one's
//           taps, and hands them to each sample's lanes by shuffles
//   step 5: the source's staged kernel: lanes over elements, kG lanes (8 in
//           f32, 4 in bf16) span a sample's row, one 16-byte vector each,
//           32 / kG samples share a warp; each lane loads its sample's
//           indices (an int4) and weights (four float4) and sums all 16
//           taps of its elements, the four taps of a point in flight: no
//           shuffles, the first design's order
//   step 6: the source's streamed kernel: step 5's lanes, the taps from
//           device memory
// Steps 3-5 stage the slice whatever its reuse (the source stages where a
// slice fits and each staged row serves kStageReuse taps on average). Steps
// 1-4 sum per tap over the points, then across the taps; steps 0, 5 and 6
// in the first design's order. Each is held against the source's kernel
// with chip_smoke.py's tolerances.
#include "../dskd_tpu_torch/csrc/fused_sample.cu"

namespace {

// Write a lane's n sums of the output row (streaming: written once).
__device__ __forceinline__ void put(float* p, const float (&v)[1]) {
  __stcs(p, v[0]);
}
__device__ __forceinline__ void put(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void put(__nv_bfloat16* p, const float (&v)[2]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
  __stcs(reinterpret_cast<unsigned*>(p),
         *reinterpret_cast<const unsigned*>(&h));
}

// The sum of v over the four tap groups of a sample (lanes kL and 2 kL
// apart) by a transposing butterfly: halve the kV values across the groups
// 2 kL apart, then the halves across those kL apart. The lane of tap c keeps
// elements c * kV / 4 .. + kV / 4 - 1 of its vector.
template <int kV, int kL>
__device__ __forceinline__ void tap_sum(const float (&v)[kV],
                                        float (&s)[kV / 4], int lane) {
  const bool hi = lane & (2 * kL), lo = lane & kL;
  float h[kV / 2];
#pragma unroll
  for (int i = 0; i < kV / 2; ++i)
    h[i] = (hi ? v[kV / 2 + i] : v[i])
         + __shfl_xor_sync(0xffffffffu, hi ? v[i] : v[kV / 2 + i], 2 * kL);
#pragma unroll
  for (int i = 0; i < kV / 4; ++i)
    s[i] = (lo ? h[kV / 4 + i] : h[i])
         + __shfl_xor_sync(0xffffffffu, lo ? h[i] : h[kV / 4 + i], kL);
}

// Steps 1-4: one sample's output row in B4''s layout, on all 32 lanes of
// the warp (the shuffles need them; `valid` is false on the lanes of a
// sample past the end). `rows` is the (b, hd) table in device memory
// (kStaged false) or its slice in shared memory, rows `stride_s` elements
// apart.
template <typename T, int kP, int kV, int kL, bool kStaged>
__device__ __forceinline__ void tap_row(
    const T* __restrict__ rows, int64_t stride_s, const int* __restrict__ ip,
    const float* __restrict__ wp, T* __restrict__ op, bool valid, int points,
    int64_t table_rows, int level_w, int d, int lane) {
  using L = Lane<T, kV>;
  const int n = kP ? kP : points;
  const int c = (lane / kL) & 3;            // this lane's tap
  const int64_t off = (c & 1) + (c >> 1) * static_cast<int64_t>(level_w);
  for (int e0 = 0; e0 < d; e0 += kL * kV) { // uniform in the warp
    const int e = e0 + (lane % kL) * kV;
    const bool on = valid && e < d;
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
    for (int p0 = 0; p0 < n; p0 += kGroup) {
      int64_t r[kGroup];
      bool ok[kGroup];                      // uniform in the lane group
      float wt[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        r[k] = on && p0 + k < n ? __ldg(ip + p0 + k) + off : -1;
        ok[k] = r[k] >= 0 && r[k] < table_rows;
        wt[k] = ok[k] ? __ldg(wp + (p0 + k) * 4 + c) : 0.f;
      }
      typename L::Raw raw[kGroup];          // every row load before an add
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (!ok[k]) {
          raw[k] = typename L::Raw{};
        } else if constexpr (kStaged) {
          raw[k] = *reinterpret_cast<const typename L::Raw*>(
              rows + r[k] * stride_s + e);
        } else {
          raw[k] = __ldg(reinterpret_cast<const typename L::Raw*>(
              rows + r[k] * stride_s + e));
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        float f[kV];
        L::unpack(raw[k], f);
#pragma unroll
        for (int i = 0; i < kV; ++i) acc[i] = fmaf(wt[k], f[i], acc[i]);
      }
    }
    float s[kV / 4];
    tap_sum<kV, kL>(acc, s, lane);
    if (on) put(op + e + c * (kV / 4), s);
  }
}

// Samples straight from the table in device memory: 32 / (4 kL) samples
// per warp on a grid over all samples, in (b, q, hd) order.
template <typename T, int kP, int kV, int kL>
__global__ void __launch_bounds__(256)
tap_streamed_kernel(const T* __restrict__ table,
                        const int* __restrict__ idx,
                        const float* __restrict__ w, T* __restrict__ out,
                        FwdShape s) {
  constexpr int kS = 32 / (4 * kL);         // samples per warp
  const int lane = threadIdx.x & 31;
  const int64_t first =
      ((blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5)
      * kS;
  if (first >= s.rows) return;              // whole warps leave together
  const int64_t it = first + lane / (4 * kL);
  const bool valid = it < s.rows;
  const int64_t at = valid ? it : first;    // a sample in range to address
  const int n = kP ? kP : s.points;
  const int hd = static_cast<int>(at % s.heads);
  const int64_t b = at / s.heads / s.queries;
  tap_row<T, kP, kV, kL, false>(
      table + b * s.stride_b + hd * s.stride_h, s.stride_s, idx + at * n,
      w + at * n * 4, out + at * s.d, valid, s.points, s.table_rows,
      s.level_w, s.d, lane);
}

constexpr int kBatch = 8;                   // samples whose indices and
                                            // weights load together
constexpr int kNoRow = INT_MIN / 2;         // a corner whose taps all miss

// The indices and weights of kBatch samples (`count` of them; the rest
// read nothing), one load instruction for the indices and four for the
// weights: lane l holds the index of point l % 4 of sample l / 4 and, in
// w[k], weight w[s][p][c] of sample s = 2k + l / 16, p = (l / 4) % 4,
// c = l % 4. at(s) is sample s's (b, q, hd) position. P = 4.
struct Batch {
  int idx;
  float w[4];
};

template <typename At>
__device__ __forceinline__ Batch load_batch(const int* __restrict__ idx,
                                            const float* __restrict__ w,
                                            At at, int64_t count, int lane) {
  Batch t;
  const int s = lane >> 2;
  t.idx = s < count ? __ldg(idx + at(s) * 4 + (lane & 3)) : kNoRow;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int sk = 2 * k + (lane >> 4);
    t.w[k] = sk < count ? __ldg(w + at(sk) * 16 + (lane & 15)) : 0.f;
  }
  return t;
}

// Sample s = step * kS + lane / (4 kL) of a batch, its indices and weights
// taken from the batch's lanes by shuffles, its taps from the slice in
// shared memory (rows d elements apart); otherwise as tap_row.
template <typename T, int kV, int kL>
__device__ __forceinline__ void batch_row(const T* __restrict__ slice,
                                          const Batch& t, int step,
                                          T* __restrict__ op, bool valid,
                                          int table_rows, int level_w, int d,
                                          int lane) {
  using L = Lane<T, kV>;
  constexpr int kS = 32 / (4 * kL);
  const int s = step * kS + lane / (4 * kL);
  const int c = (lane / kL) & 3;
  const int off = (c & 1) + (c >> 1) * level_w;
  const float wk = t.w[step * kS / 2];      // the register of sample s
  int r[4];
  float wt[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int64_t row =
        static_cast<int64_t>(__shfl_sync(0xffffffffu, t.idx, 4 * s + p)) +
        off;
    const float y =
        __shfl_sync(0xffffffffu, wk, (s & 1) * 16 + p * 4 + c);
    const bool ok = valid && row >= 0 && row < table_rows;
    r[p] = ok ? static_cast<int>(row) : -1;
    wt[p] = ok ? y : 0.f;
  }
  for (int e0 = 0; e0 < d; e0 += kL * kV) { // uniform in the warp
    const int e = e0 + (lane % kL) * kV;
    const bool on = e < d;
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
    typename L::Raw raw[4];                 // every row load before an add
#pragma unroll
    for (int p = 0; p < 4; ++p)
      raw[p] = on && r[p] >= 0 ? *reinterpret_cast<const typename L::Raw*>(
                                     slice + r[p] * d + e)
                               : typename L::Raw{};
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float f[kV];
      L::unpack(raw[p], f);
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = fmaf(wt[p], f[i], acc[i]);
    }
    float sum[kV / 4];
    tap_sum<kV, kL>(acc, sum, lane);
    if (valid && on) put(op + e + c * (kV / 4), sum);
  }
}

// Samples from the (b, hd) slice staged in shared memory: block
// (tile, b * H + hd) copies the slice's rows (whole 16-byte vectors), then
// serves the queries of its tile, 32 / (4 kL) samples per warp at a time.
// kBatched (P = 4): each warp takes kBatch consecutive queries at a time,
// their indices and weights loaded together, the next batch's loads issued
// before this batch's taps.
template <typename T, int kP, int kV, int kL, bool kBatched>
__global__ void __launch_bounds__(kStageThreads)
tap_staged_kernel(const T* __restrict__ table,
                           const int* __restrict__ idx,
                           const float* __restrict__ w, T* __restrict__ out,
                           FwdShape s) {
  extern __shared__ uint4 stage[];
  T* slice = reinterpret_cast<T*>(stage);
  constexpr int kS = 32 / (4 * kL);
  constexpr int kE = 16 / sizeof(T);        // elements per 16-byte vector
  constexpr int kWarps = kStageThreads / 32;
  const int lane = threadIdx.x & 31;
  const int hd = static_cast<int>(blockIdx.y % s.heads);
  const int64_t b = blockIdx.y / s.heads;
  const T* src = table + b * s.stride_b + hd * s.stride_h;
  const int vpr = s.d / kE;                 // vectors per row
  const int n_vec = static_cast<int>(s.table_rows) * vpr;
  for (int i = threadIdx.x; i < n_vec; i += kStageThreads)
    copy16(slice + static_cast<int64_t>(i) * kE,
           src + (i / vpr) * s.stride_s + (i % vpr) * kE);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int64_t per = (s.queries + gridDim.x - 1) / gridDim.x;
  const int64_t q0 = blockIdx.x * per;
  const int64_t q1 = q0 + per < s.queries ? q0 + per : s.queries;
  if constexpr (kBatched) {
    static_assert(kP == 4, "a batch holds four points per sample");
    auto at_of = [&](int64_t qb) {
      return [=](int j) { return (b * s.queries + qb + j) * s.heads + hd; };
    };
    auto count = [&](int64_t qb) {
      return qb >= q1 ? int64_t{0} : q1 - qb < kBatch ? q1 - qb : kBatch;
    };
    int64_t qb = q0 + (threadIdx.x >> 5) * kBatch;
    Batch cur = load_batch(idx, w, at_of(qb), count(qb), lane);
    for (; qb < q1; qb += kWarps * kBatch) {  // uniform in the warp
      const int64_t qn = qb + kWarps * kBatch;
      const Batch next = load_batch(idx, w, at_of(qn), count(qn), lane);
      const auto at = at_of(qb);
#pragma unroll
      for (int step = 0; step < kBatch / kS; ++step) {
        const int j = step * kS + lane / (4 * kL);
        batch_row<T, kV, kL>(slice, cur, step, out + at(j) * s.d,
                             qb + j < q1, static_cast<int>(s.table_rows),
                             s.level_w, s.d, lane);
      }
      cur = next;
    }
  } else {
    const int n = kP ? kP : s.points;
    for (int64_t qw = q0 + (threadIdx.x >> 5) * kS; qw < q1;
         qw += kWarps * kS) {               // uniform in the warp
      const int64_t q = qw + lane / (4 * kL);
      const bool valid = q < q1;
      const int64_t at = (b * s.queries + (valid ? q : qw)) * s.heads + hd;
      tap_row<T, kP, kV, kL, true>(slice, s.d, idx + at * n,
                                      w + at * n * 4, out + at * s.d, valid,
                                      s.points, s.table_rows, s.level_w, s.d,
                                      lane);
    }
  }
}

// Opt a staged kernel in to kMaxStage bytes of shared memory, and its grid.
template <typename Kernel>
dim3 staged_grid(Kernel kernel, const FwdShape& s, int element_size,
                 int* smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kMaxStage)) != cudaSuccess)
    return dim3(0);
  return stage_grid(kernel, s, element_size, smem);
}

template <typename T>
int launch_step(int step, const void* table, const void* idx, const void* w,
                void* out, int64_t batch, int64_t queries, int64_t heads,
                int64_t table_rows, int64_t level_w, int64_t d,
                int64_t stride_b, int64_t stride_s, int64_t stride_h,
                void* stream) {
  const int64_t rows = batch * queries * heads;
  const auto st = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(table);
  const int* i = static_cast<const int*>(idx);
  const float* wf = static_cast<const float*>(w);
  T* o = static_cast<T*>(out);
  if (step == 0) {
    fused_sample_kernel<T><<<blocks_for(rows), kThreads, 0, st>>>(
        t, i, wf, o, rows, queries, static_cast<int>(heads), 4, table_rows,
        static_cast<int>(level_w), static_cast<int>(d), stride_b, stride_s,
        stride_h);
    return static_cast<int>(cudaGetLastError());
  }
  const FwdShape s{rows, queries, static_cast<int>(heads), 4, table_rows,
                   static_cast<int>(level_w), static_cast<int>(d), stride_b,
                   stride_s, stride_h};
  constexpr int kV = 16 / sizeof(T);        // 16-byte lanes
  constexpr int kL = 32 / kV;               // B4''s lanes per tap row
  constexpr int kG = 32 / kV;               // lanes per 32-element piece
  auto warp_blocks = [&](int kS) {
    return static_cast<unsigned>(((rows + kS - 1) / kS * 32 + 255) / 256);
  };
  int smem = 0;
  dim3 grid(0);
  if (step == 1) {
    tap_streamed_kernel<T, 4, 4, 8><<<warp_blocks(1), 256, 0, st>>>(
        t, i, wf, o, s);
  } else if (step == 2) {
    tap_streamed_kernel<T, 4, kV, kL>
        <<<warp_blocks(32 / (4 * kL)), 256, 0, st>>>(t, i, wf, o, s);
  } else if (step == 3 || step == 4) {
    auto kernel = step == 3 ? tap_staged_kernel<T, 4, kV, kL, false>
                            : tap_staged_kernel<T, 4, kV, kL, true>;
    grid = staged_grid(kernel, s, sizeof(T), &smem);
    if (!grid.x) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<grid, kStageThreads, smem, st>>>(t, i, wf, o, s);
  } else if (step == 5) {
    auto kernel = fused_sample_staged_kernel<T, 4, kV, kG>;
    grid = staged_grid(kernel, s, sizeof(T), &smem);
    if (!grid.x) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<grid, kStageThreads, smem, st>>>(t, i, wf, o, s);
  } else {
    fused_sample_vec_kernel<T, 4, kV, kG>
        <<<static_cast<unsigned>((rows * kG + 255) / 256), 256, 0, st>>>(
            t, i, wf, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step's forward (P = 4), f32 or bf16 table and out.
extern "C" int fused_sample_step(int64_t step, int64_t bf16,
                                 const void* table, const void* idx,
                                 const void* w, void* out, int64_t batch,
                                 int64_t queries, int64_t heads,
                                 int64_t table_rows, int64_t level_w,
                                 int64_t d, int64_t stride_b,
                                 int64_t stride_s, int64_t stride_h,
                                 void* stream) {
  return bf16 ? launch_step<__nv_bfloat16>(
                    static_cast<int>(step), table, idx, w, out, batch,
                    queries, heads, table_rows, level_w, d, stride_b,
                    stride_s, stride_h, stream)
              : launch_step<float>(static_cast<int>(step), table, idx, w, out,
                                   batch, queries, heads, table_rows, level_w,
                                   d, stride_b, stride_s, stride_h, stream);
}
