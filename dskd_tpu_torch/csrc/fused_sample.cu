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
// What held the first forward design back (one warp per (b, q, hd), lane l
// on elements l, l+32, ..., kept as the generic kernel for D not a multiple
// of 4): latency. Each point loaded its index, then walked its four taps
// behind a branch, one 128-byte row per warp load, so a warp had one row in
// flight and paid the index latency once per point, in series.
//
// Forward design (D a multiple of 4): lanes over elements, B1's layout. kG
// lanes span a 32-element piece of a sample's row, one 16-byte vector each
// (kV = 4 elements in f32, kG = 8; kV = 8 in bf16, kG = 4; 8-byte bf16
// lanes, kV = 4, where D is not a multiple of 8), so 32 / kG samples share
// a warp. Each lane loads its sample's indices (one int4 at P = 4; other P
// run in groups of four) and weights (a float4 per point), and sums all the
// taps of its elements itself, point after point and tap after tap, in the
// first design's order: the four taps of a point in flight, no shuffles,
// results bit for bit the first design's, and the output written once with
// one streaming vector store per lane. (B4''s layout, lane l on tap l >> 3,
// serves the backward, whose adds and dots are per tap; for the forward it
// needs a butterfly of shuffles over the four taps per sample and measured
// slower, tools/fused_sample_steps.cu.)
//
// Taps from shared memory. The rows still cross from L2 to the SMs 4P times
// per sample (2 KB in f32), whatever the level's size. A (b, hd) slice of
// levels 1-3 of a 640x480 canvas is 80, 300 or 1200 rows of 128 B in f32,
// 10-154 KB, so where a slice fits in shared memory (kMaxStage) and its
// samples read it often enough (kStageReuse), blocks run over (query tile,
// b * H + hd): each stages its slice once with 16-byte cp.async copies, one
// per 16 bytes of a row (the rows are H * D elements apart), then reads the
// taps from shared memory. That costs tiles x slice bytes of L2 traffic
// instead of 2 KB per sample; the tiles are as many as fill the card once.
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
// the vector kernels (D a multiple of 4) the wrapper checks that the table,
// g and dtable are 16-byte aligned and the table's strides whole vectors of
// 4 elements; the forward takes 16-byte bf16 lanes and stages slices only
// where the rows and strides are whole 16-byte vectors.
#include <climits>
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

// --- the forward for D a multiple of 4; see the header ---------------------

__device__ __forceinline__ float2 bf2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// kV elements of a row as one vector: its bytes (loaded through the
// read-only path from device memory, or from shared memory), unpacked to
// f32, and kV f32 sums stored in the row's type (streaming: written once).
template <typename T, int kV> struct Lane;

template <> struct Lane<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& q, float (&f)[4]) {
    f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  }
};

template <> struct Lane<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& q, float (&f)[8]) {
    const float2 a = bf2(q.x), b = bf2(q.y), c = bf2(q.z), d = bf2(q.w);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
    f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(pack_bf2(f[0], f[1]), pack_bf2(f[2], f[3]),
                      pack_bf2(f[4], f[5]), pack_bf2(f[6], f[7])));
  }
};

template <> struct Lane<__nv_bfloat16, 4> {
  using Raw = uint2;
  static __device__ __forceinline__ void unpack(const Raw& q, float (&f)[4]) {
    const float2 a = bf2(q.x), b = bf2(q.y);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[4]) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(pack_bf2(f[0], f[1]), pack_bf2(f[2], f[3])));
  }
};

struct FwdShape {
  int64_t rows;                             // B * Q * H samples
  int64_t queries;
  int heads, points;
  int64_t table_rows;
  int level_w, d;
  int64_t stride_b, stride_s, stride_h;
};

// One sample's output row on its kG lanes; see the header. `rows` is the
// (b, hd) table in device memory (kStaged false) or its slice in shared
// memory, rows `stride_s` elements apart; ip and wp the sample's indices
// and weights (16-byte aligned).
template <typename T, int kP, int kV, int kG, bool kStaged>
__device__ __forceinline__ void sample_row(
    const T* __restrict__ rows, int64_t stride_s, const int* __restrict__ ip,
    const float* __restrict__ wp, T* __restrict__ op, int points,
    int64_t table_rows, int level_w, int d, int lane) {
  using L = Lane<T, kV>;
  const int n = kP ? kP : points;
  for (int e = (lane % kG) * kV; e < d; e += kG * kV) {
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
    for (int p0 = 0; p0 < n; p0 += kGroup) {
      int c00[kGroup];
      if constexpr (kP == kGroup) {
        const int4 c = __ldg(reinterpret_cast<const int4*>(ip));
        c00[0] = c.x; c00[1] = c.y; c00[2] = c.z; c00[3] = c.w;
      } else {
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
          c00[k] = p0 + k < n ? __ldg(ip + p0 + k) : 0;
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (p0 + k >= n) break;
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wp) + p0 + k);
        const float wt[4] = {w4.x, w4.y, w4.z, w4.w};
        typename L::Raw raw[4];             // the point's four taps in flight
        bool ok[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int64_t r = static_cast<int64_t>(c00[k]) + (c & 1) +
                            (c >> 1) * static_cast<int64_t>(level_w);
          ok[c] = r >= 0 && r < table_rows;
          const auto* src = reinterpret_cast<const typename L::Raw*>(
              rows + r * stride_s + e);
          if (!ok[c]) {
            raw[c] = typename L::Raw{};
          } else if constexpr (kStaged) {
            raw[c] = *src;
          } else {
            raw[c] = __ldg(src);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!ok[c]) continue;
          float f[kV];
          L::unpack(raw[c], f);
#pragma unroll
          for (int i = 0; i < kV; ++i) acc[i] = fmaf(wt[c], f[i], acc[i]);
        }
      }
    }
    L::store(op + e, acc);
  }
}

// Samples straight from the table in device memory: kG lanes per sample,
// a grid over all samples in (b, q, hd) order.
template <typename T, int kP, int kV, int kG>
__global__ void __launch_bounds__(256)
fused_sample_vec_kernel(const T* __restrict__ table,
                        const int* __restrict__ idx,
                        const float* __restrict__ w, T* __restrict__ out,
                        FwdShape s) {
  const int64_t it =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / kG;
  if (it >= s.rows) return;
  const int n = kP ? kP : s.points;
  const int hd = static_cast<int>(it % s.heads);
  const int64_t b = it / s.heads / s.queries;
  sample_row<T, kP, kV, kG, false>(
      table + b * s.stride_b + hd * s.stride_h, s.stride_s, idx + it * n,
      w + it * n * 4, out + it * s.d, s.points, s.table_rows, s.level_w,
      s.d, threadIdx.x & 31);
}

constexpr int kStageThreads = 1024;         // 32 warps: one block per SM
                                            // still keeps 32 in flight

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Block (tile, b * H + hd) copies the (b, hd) slice's rows into shared
// memory with cp.async (whole 16-byte vectors) and returns the range
// [q0, q1) of its tile's queries.
template <typename T>
__device__ __forceinline__ void stage_slice(T* slice,
                                            const T* __restrict__ table,
                                            const FwdShape& s, int64_t b,
                                            int hd, int64_t& q0,
                                            int64_t& q1) {
  constexpr int kE = 16 / sizeof(T);        // elements per 16-byte vector
  const T* src = table + b * s.stride_b + hd * s.stride_h;
  const int vpr = s.d / kE;                 // vectors per row
  const int n_vec = static_cast<int>(s.table_rows) * vpr;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    copy16(slice + static_cast<int64_t>(i) * kE,
           src + (i / vpr) * s.stride_s + (i % vpr) * kE);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int64_t per = (s.queries + gridDim.x - 1) / gridDim.x;
  q0 = blockIdx.x * per;
  q1 = q0 + per < s.queries ? q0 + per : s.queries;
}

// Samples from the (b, hd) slice staged in shared memory: block
// (tile, b * H + hd) serves the queries of its tile, kG lanes per sample.
template <typename T, int kP, int kV, int kG>
__global__ void __launch_bounds__(kStageThreads)
fused_sample_staged_kernel(const T* __restrict__ table,
                           const int* __restrict__ idx,
                           const float* __restrict__ w, T* __restrict__ out,
                           FwdShape s) {
  extern __shared__ uint4 stage[];
  T* slice = reinterpret_cast<T*>(stage);
  const int hd = static_cast<int>(blockIdx.y % s.heads);
  const int64_t b = blockIdx.y / s.heads;
  int64_t q0, q1;
  stage_slice(slice, table, s, b, hd, q0, q1);
  const int n = kP ? kP : s.points;
  const int lane = threadIdx.x & 31;
  for (int64_t q = q0 + static_cast<int64_t>(threadIdx.x / kG); q < q1;
       q += kStageThreads / kG) {
    const int64_t at = (b * s.queries + q) * s.heads + hd;
    sample_row<T, kP, kV, kG, true>(slice, s.d, idx + at * n,
                                    w + at * n * 4, out + at * s.d,
                                    s.points, s.table_rows, s.level_w, s.d,
                                    lane);
  }
}

// The largest slice staged (the shared memory a block may take on an H100,
// 227 KB), and how many taps each staged row must serve on average: a slice
// staged for fewer samples than that measured slower than the taps
// streamed from device memory (the decoder's 300 queries on levels 1 and 2
// of 640x480, tools/torch_kernel_steps.py).
constexpr int64_t kMaxStage = 232448;
constexpr int64_t kStageReuse = 4;

// The grid of a staged kernel for these shapes: as many query tiles per
// (b, hd) as fill the card once; dim3(0) where the slice does not fit. The
// kernel must have opted in to kMaxStage bytes of shared memory.
template <typename Kernel>
dim3 stage_grid(Kernel kernel, const FwdShape& s, int element_size,
                int* smem) {
  const int64_t bytes = s.table_rows * s.d * element_size;
  const int64_t slices = s.rows / s.queries;          // B * H
  *smem = static_cast<int>(bytes);
  if (bytes == 0 || bytes > kMaxStage || slices > 65535) return dim3(0);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kStageThreads, *smem);
  if (per_sm == 0) return dim3(0);
  int64_t tiles = static_cast<int64_t>(sms) * per_sm / slices;
  if (tiles > s.queries) tiles = s.queries;
  if (tiles < 1) tiles = 1;
  return dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(slices));
}

// Staged where the rows are whole 16-byte vectors, a slice fits and its
// rows serve kStageReuse taps each on average, else streamed from device
// memory.
template <typename T, int kP, int kV, int kG>
cudaError_t run_fwd(const T* table, const int* idx, const float* w, T* out,
                    const FwdShape& s, bool whole_vectors,
                    cudaStream_t stream) {
  if constexpr (kV * sizeof(T) == 16) {
    auto staged = fused_sample_staged_kernel<T, kP, kV, kG>;
    static bool opted_in = false;           // once per instantiation
    if (whole_vectors && !opted_in) {
      const cudaError_t err = cudaFuncSetAttribute(
          staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxStage));
      if (err != cudaSuccess) return err;
      opted_in = true;
    }
    int smem = 0;
    const dim3 grid =
        whole_vectors ? stage_grid(staged, s, sizeof(T), &smem) : dim3(0);
    const int n = kP ? kP : s.points;
    if (grid.x && static_cast<int64_t>(grid.x) * s.table_rows * kStageReuse <=
                      s.queries * n * 4) {
      staged<<<grid, kStageThreads, smem, stream>>>(table, idx, w, out, s);
      return cudaGetLastError();
    }
  }
  fused_sample_vec_kernel<T, kP, kV, kG>
      <<<static_cast<unsigned>((s.rows * kG + 255) / 256), 256, 0, stream>>>(
          table, idx, w, out, s);
  return cudaGetLastError();
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
  const auto st = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(table);
  const int* i = static_cast<const int*>(idx);
  const float* wf = static_cast<const float*>(w);
  T* o = static_cast<T*>(out);
  if (d % 4) {                              // the first design
    fused_sample_kernel<T><<<blocks_for(rows), kThreads, 0, st>>>(
        t, i, wf, o, rows, queries, static_cast<int>(heads),
        static_cast<int>(points), table_rows, static_cast<int>(level_w),
        static_cast<int>(d), stride_b, stride_s, stride_h);
    return static_cast<int>(cudaGetLastError());
  }
  if (table_rows > INT_MAX || points > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdShape s{rows, queries, static_cast<int>(heads),
                   static_cast<int>(points), table_rows,
                   static_cast<int>(level_w), static_cast<int>(d), stride_b,
                   stride_s, stride_h};
  // rows and strides of whole 16-byte vectors: 16-byte lanes, and a slice
  // that cp.async can stage
  constexpr int kE = 16 / sizeof(T);
  const bool whole = d % kE == 0 && stride_b % kE == 0 &&
                     stride_s % kE == 0 && stride_h % kE == 0;
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    err = points == 4 ? run_fwd<T, 4, 4, 8>(t, i, wf, o, s, whole, st)
                      : run_fwd<T, 0, 4, 8>(t, i, wf, o, s, whole, st);
  } else if (whole) {                       // bf16: 16-byte lanes
    err = points == 4 ? run_fwd<T, 4, 8, 4>(t, i, wf, o, s, true, st)
                      : run_fwd<T, 0, 8, 4>(t, i, wf, o, s, true, st);
  } else {                                  // bf16: 8-byte lanes, streamed
    err = points == 4 ? run_fwd<T, 4, 4, 8>(t, i, wf, o, s, false, st)
                      : run_fwd<T, 0, 4, 8>(t, i, wf, o, s, false, st);
  }
  return static_cast<int>(err);
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
