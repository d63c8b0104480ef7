// Weighted row gather of packed corner rows for multi-scale deformable
// attention.
//
// Replaces: dskd_tpu/ops/mxu_gather.py `mxu_gather_weighted` forward
// (`_fwd_w_kernel`), the Pallas one-hot kernel that samples levels 1-3 on the
// TPU, and the XLA gather loop that samples level 0 there
// (dskd_tpu/ops/msda.py `ms_deform_attn_core`): gather_weighted_{f32,bf16}.
// And dskd_tpu/ops/fused_window.py `fused_window_sample` forward
// (`fwd_kernel`, pallas_call at :146), which computes the same function per
// query tile of `tile_q` inside a window of table rows:
// fused_window_{f32,bf16}.
//
//   out[b, q, hd, e] = sum_p table[b, idx[b,q,hd,p], hd, e] * w[b,q,hd,p, e/D]
//
// Each corner weight spans its D-lane chunk of the 4D-wide packed row. Sums
// run in f32 registers, point after point with one fused multiply-add each
// (the order the windowed kernels and branches repeat); the result is
// written in the table's type. w is read as f32 or bf16 (bf16 to f32 is
// exact). An index outside [0, S) contributes nothing and is never read: on
// the TPU the one-hot row of such an index matches no table row, on the GPU
// it would be a read out of bounds.
//
// What bounds it on the H100: memory, at random row addresses; it is a
// gather, not a product, so the tensor cores have no part in it. Per
// (b, q, hd) it reads P rows of 4D elements (512 B each in f32, 256 B in
// bf16) and writes one. The bound counts each table byte once, but the rows
// themselves cross from L2 to the SMs P times per sample (1.1 GB in f32 for
// the four levels of a 640x640 canvas at B=2, Q=8500), four times the
// output; only reuse in L1 cuts that.
//
// What held the first design back (one warp per (b, q, hd), a runtime loop
// over the points): latency. Each point loaded its index, then its weight
// and row, one after the other, so a lane had one row load in flight and
// eight memory latencies in series per sample; bf16 lanes moved 8 bytes,
// not 16, so bf16 was no faster than f32.
//
// Design:
//   * P is a template parameter (4, the flagship's; a generic kernel takes
//     any other P and row widths other than 16 and 32 vectors). A sample's
//     P indices and its lanes' weights load together, an index outside
//     [0, S) turns into a zero weight and a predicated row load, and all P
//     row loads are issued before the first multiply-add: P rows in flight
//     per lane.
//   * kG lanes span one row, one 16-byte vector each, and 32 / kG rows
//     share a warp: a warp per f32 row of 128 elements, a half-warp per
//     bf16 row.
//   * Stores stream (evict-first): the output is written once, and must not
//     push the table, which the next samples read, out of L2.
//   * One sample per lane group and a grid over all samples, in (b, q, hd)
//     order. Persistent blocks that load the next sample's indices before
//     the current one's multiply-adds, and a (b, hd, q) order that gives a
//     block consecutive raster queries of one head, both measured slower on
//     the H100 (tools/torch_kernel_steps.py).
// With the index latency exposed once per sample and P rows in flight, the
// f32 kernel moves the rows from L2 at about the rate L2 serves random
// 512-byte rows (PERF.md).
//
// Windows. Query q lies in tile t = q / tile_q, whose window is the rows
// [starts[t], starts[t] + window). On the TPU the window made the one-hot
// product affordable, and a sample outside it (an escape) sent the whole
// segment to the plain path. Here the windowed entry point runs this same
// gather (kCountEscapes), which reads an escaped row like any other, so its
// output is gather_weighted's bit for bit, and keeps the window only in a
// count: lane p < P of a sample's lane group compares the row p it loaded
// for the gather with its tile's window after the sample's store, the warp
// sums the count, and a warp with escapes adds it to the device int32
// `escapes` (where every sample keeps to its window, no atomic at all). The
// gather is latency-bound, so the count must not cost it occupancy: in f32
// it keeps the default kernel's 32 registers. (Counting before the gather,
// behind a warp reduction that waits for the indices, cost 1.16x
// gather_weighted's time on the same inputs on an H100; summing the warps'
// counts per block behind a barrier 1.08x; a start per query, or the tile
// by a multiply and shift, 34 registers and 1.10x; PERF.md.)
//
// The table is addressed through explicit batch, row and head strides
// (elements; each row contiguous), so the (B, S', H, 4D) output of
// pack_corners is read in place. idx (int32) and w are contiguous
// (B, Q, H, P) and (B, Q, H, P, 4); out is contiguous (B, Q, H, 4D). The
// wrapper checks that the table is 16-byte aligned and that its strides and
// corner chunks are whole 16-byte vectors.
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // 8 warps

struct Shape {
  int items;                                // B * Q * H samples
  int queries, heads, points, table_rows;
  int nv;                                   // 16-byte vectors per row
  int vpc;                                  // vectors per corner chunk
  int64_t stride_b, stride_s, stride_h;
};

struct Window {
  const int* starts;                        // one row per tile of tile_q
  int* escapes;                             // device int32 count
  int tile_q, rows;
};

__device__ __forceinline__ bool escaped(int row, int start, int rows) {
  const int64_t local = static_cast<int64_t>(row) - start;
  return local < 0 || local >= rows;
}

// A warp's escapes: each lane's count summed over the warp, and one device
// atomic from a warp with escapes (none where every sample keeps to its
// window). All 32 lanes call it.
__device__ __forceinline__ void add_escapes(const Window& win, int esc) {
  esc = __reduce_add_sync(0xffffffffu, esc);
  if ((threadIdx.x & 31) == 0 && esc) atomicAdd(win.escapes, esc);
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
}

__device__ __forceinline__ float2 bf2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&f)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const float2 a = bf2(q.x), b = bf2(q.y), c = bf2(q.z), d = bf2(q.w);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
}

__device__ __forceinline__ void store_vec(float* p, const float (&f)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
}

__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&f)[8]) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(pack_bf2(f[0], f[1]), pack_bf2(f[2], f[3]),
                    pack_bf2(f[4], f[5]), pack_bf2(f[6], f[7])));
}

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Sample `it` on its lane group; see the header. kCountEscapes: returns 1
// on lane p < P of the group if row p lies outside the sample's window,
// else 0.
template <typename T, typename WT, int kP, int kG, bool kCountEscapes>
__device__ __forceinline__ int gather_sample(
    const T* __restrict__ table, const int* __restrict__ idx,
    const WT* __restrict__ w, T* __restrict__ out, const Shape& s, int it,
    int lane, const Window& win) {
  constexpr int kV = 16 / sizeof(T);        // elements per vector
  const int e = (lane % kG) * kV;           // this lane's elements of a row
  const int corner = (lane % kG) / s.vpc;
  const int b = it / (s.queries * s.heads);
  const int64_t base = b * s.stride_b + (it % s.heads) * s.stride_h;
  const int* ip = idx + static_cast<int64_t>(it) * kP;
  const WT* wp = w + static_cast<int64_t>(it) * kP * 4;
  // the indices and this lane's corner weights; outside [0, S): row -1,
  // weight 0
  int r[kP], x[kP];
  float wt[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    x[p] = __ldg(ip + p);
    const float y = load_w(wp + p * 4 + corner);
    const bool ok = static_cast<unsigned>(x[p]) <
                    static_cast<unsigned>(s.table_rows);
    r[p] = ok ? x[p] : -1;
    wt[p] = ok ? y : 0.f;
  }
  int start = 0;                            // the window's first row
  if constexpr (kCountEscapes)
    start = __ldg(win.starts + (it / s.heads - b * s.queries) / win.tile_q);
  // all P rows in flight before the first multiply-add
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
  float acc[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) acc[i] = 0.f;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = fmaf(wt[p], f[p][i], acc[i]);
  }
  store_vec(out + static_cast<int64_t>(it) * s.nv * kV + e, acc);
  int esc = 0;
  if constexpr (kCountEscapes) {
#pragma unroll
    for (int p = 0; p < kP; ++p)
      esc += lane % kG == p && escaped(x[p], start, win.rows);
  }
  return esc;
}

// kP points per sample; kG lanes per row, one 16-byte vector each (16 or
// 32, so that 32 / kG rows share a warp). kCountEscapes: also count the
// samples outside their tile's window (the header).
template <typename T, typename WT, int kP, int kG, bool kCountEscapes>
__global__ void __launch_bounds__(kThreads)
gather_weighted_kernel(const T* __restrict__ table,
                       const int* __restrict__ idx, const WT* __restrict__ w,
                       T* __restrict__ out, Shape s, Window win) {
  constexpr int kV = 16 / sizeof(T);        // elements per vector
  constexpr int kRows = 32 / kG;            // samples per warp
  const int lane = threadIdx.x & 31;
  const int it =                            // the (b, q, hd) sample
      (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kRows + lane / kG;
  if constexpr (!kCountEscapes) {
    if (it >= s.items) return;
    gather_sample<T, WT, kP, kG, false>(table, idx, w, out, s, it, lane,
                                        win);
  } else {                                  // every lane to the reduction
    add_escapes(win, it < s.items
                         ? gather_sample<T, WT, kP, kG, true>(
                               table, idx, w, out, s, it, lane, win)
                         : 0);
  }
}

// Any P and any row of whole 16-byte vectors: a warp per sample, its lanes
// over the row's vectors, the points in a runtime loop.
template <typename T, typename WT>
__device__ __forceinline__ void generic_sample(
    const T* __restrict__ table, const int* __restrict__ idx,
    const WT* __restrict__ w, T* __restrict__ out, const Shape& s, int it,
    int lane) {
  constexpr int kV = 16 / sizeof(T);
  const int b = it / (s.queries * s.heads);
  const int64_t base = b * s.stride_b + (it % s.heads) * s.stride_h;
  const int* ip = idx + static_cast<int64_t>(it) * s.points;
  const WT* wp = w + static_cast<int64_t>(it) * s.points * 4;
  for (int j = lane; j < s.nv; j += 32) {
    const int c = j / s.vpc;
    float acc[kV];
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[i] = 0.f;
    for (int p = 0; p < s.points; ++p) {
      const int r = __ldg(ip + p);
      if (static_cast<unsigned>(r) >= static_cast<unsigned>(s.table_rows))
        continue;
      const float wt = load_w(wp + p * 4 + c);
      float f[kV];
      load_vec(table + base + static_cast<int64_t>(r) * s.stride_s + j * kV,
               f);
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[i] = fmaf(wt, f[i], acc[i]);
    }
    store_vec(out + static_cast<int64_t>(it) * s.nv * kV + j * kV, acc);
  }
}

template <typename T, typename WT, bool kCountEscapes>
__global__ void __launch_bounds__(kThreads)
gather_weighted_generic(const T* __restrict__ table,
                        const int* __restrict__ idx, const WT* __restrict__ w,
                        T* __restrict__ out, Shape s, Window win) {
  const int lane = threadIdx.x & 31;
  const int it = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if constexpr (!kCountEscapes) {
    if (it >= s.items) return;
    generic_sample<T, WT>(table, idx, w, out, s, it, lane);
  } else {                                  // every lane to the reduction
    int esc = 0;
    if (it < s.items) {
      generic_sample<T, WT>(table, idx, w, out, s, it, lane);
      const int start = __ldg(win.starts + (it / s.heads) % s.queries /
                                               win.tile_q);
      for (int p = lane; p < s.points; p += 32)
        esc += escaped(__ldg(idx + static_cast<int64_t>(it) * s.points + p),
                       start, win.rows);
    }
    add_escapes(win, esc);
  }
}

// One kernel over the samples; kP == 0: the generic kernel.
template <typename T, typename WT, int kP, int kG, bool kCountEscapes>
cudaError_t run(const T* table, const int* idx, const WT* w, T* out,
                const Shape& s, const Window& win, cudaStream_t stream) {
  void (*kernel)(const T*, const int*, const WT*, T*, Shape, Window);
  int rows_per_block = kThreads / 32;
  if constexpr (kP == 0) {
    kernel = gather_weighted_generic<T, WT, kCountEscapes>;
  } else {
    kernel = gather_weighted_kernel<T, WT, kP, kG, kCountEscapes>;
    rows_per_block *= 32 / kG;
  }
  const int blocks = (s.items + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, kThreads, 0, stream>>>(table, idx, w, out, s, win);
  return cudaGetLastError();
}

template <typename T, typename WT, bool kCountEscapes>
cudaError_t dispatch(const void* table, const void* idx, const void* w,
                     void* out, const Shape& s, const Window& win,
                     cudaStream_t stream) {
  const T* t = static_cast<const T*>(table);
  const int* i = static_cast<const int*>(idx);
  const WT* wt = static_cast<const WT*>(w);
  T* o = static_cast<T*>(out);
  // the flagship's rows (D = 32: 32 f32 or 16 bf16 vectors) and P = 4
  if (s.points == 4 && s.nv == 32)
    return run<T, WT, 4, 32, kCountEscapes>(t, i, wt, o, s, win, stream);
  if (s.points == 4 && s.nv == 16)
    return run<T, WT, 4, 16, kCountEscapes>(t, i, wt, o, s, win, stream);
  return run<T, WT, 0, 32, kCountEscapes>(t, i, wt, o, s, win, stream);
}

template <typename T, bool kCountEscapes>
int entry(const void* table, const void* idx, const void* w, void* out,
          int64_t batch, int64_t queries, int64_t heads, int64_t points,
          int64_t table_rows, int64_t d4, int64_t stride_b, int64_t stride_s,
          int64_t stride_h, int64_t w_bf16, const Window& win, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  const int64_t items = batch * queries * heads;
  if (items == 0) return static_cast<int>(cudaSuccess);
  if (items > INT_MAX / 2 || table_rows > INT_MAX || points > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{static_cast<int>(items), static_cast<int>(queries),
                static_cast<int>(heads), static_cast<int>(points),
                static_cast<int>(table_rows), static_cast<int>(d4 / kV),
                static_cast<int>(d4 / 4 / kV), stride_b, stride_s, stride_h};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      w_bf16 ? dispatch<T, __nv_bfloat16, kCountEscapes>(table, idx, w, out,
                                                         s, win, st)
             : dispatch<T, float, kCountEscapes>(table, idx, w, out, s, win,
                                                 st));
}

Window window_of(const void* starts, void* escapes, int64_t tile_q,
                 int64_t window) {
  return Window{static_cast<const int*>(starts), static_cast<int*>(escapes),
                static_cast<int>(tile_q), static_cast<int>(window)};
}

}  // namespace

// Entry points, one per table type; w_bf16 says whether w is bf16 (else
// f32). Strides are in elements. Each returns cudaGetLastError() after its
// launch.
extern "C" int gather_weighted_f32(const void* table, const void* idx,
                                   const void* w, void* out, int64_t batch,
                                   int64_t queries, int64_t heads,
                                   int64_t points, int64_t table_rows,
                                   int64_t d4, int64_t stride_b,
                                   int64_t stride_s, int64_t stride_h,
                                   int64_t w_bf16, void* stream) {
  return entry<float, false>(table, idx, w, out, batch, queries, heads,
                             points, table_rows, d4, stride_b, stride_s,
                             stride_h, w_bf16, Window{}, stream);
}

extern "C" int gather_weighted_bf16(const void* table, const void* idx,
                                    const void* w, void* out, int64_t batch,
                                    int64_t queries, int64_t heads,
                                    int64_t points, int64_t table_rows,
                                    int64_t d4, int64_t stride_b,
                                    int64_t stride_s, int64_t stride_h,
                                    int64_t w_bf16, void* stream) {
  return entry<__nv_bfloat16, false>(table, idx, w, out, batch, queries,
                                     heads, points, table_rows, d4, stride_b,
                                     stride_s, stride_h, w_bf16, Window{},
                                     stream);
}

// The windowed gather: the same function, and the samples outside their
// tile's window [starts[q / tile_q], + window) added to `escapes` (one
// device int32).
extern "C" int fused_window_f32(
    const void* table, const void* idx, const void* w, const void* starts,
    void* out, void* escapes, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t tile_q, int64_t window, int64_t table_rows,
    int64_t d4, int64_t stride_b, int64_t stride_s, int64_t stride_h,
    int64_t w_bf16, void* stream) {
  return entry<float, true>(table, idx, w, out, batch, queries, heads, points,
                            table_rows, d4, stride_b, stride_s, stride_h,
                            w_bf16, window_of(starts, escapes, tile_q, window),
                            stream);
}

extern "C" int fused_window_bf16(
    const void* table, const void* idx, const void* w, const void* starts,
    void* out, void* escapes, int64_t batch, int64_t queries, int64_t heads,
    int64_t points, int64_t tile_q, int64_t window, int64_t table_rows,
    int64_t d4, int64_t stride_b, int64_t stride_s, int64_t stride_h,
    int64_t w_bf16, void* stream) {
  return entry<__nv_bfloat16, true>(table, idx, w, out, batch, queries, heads,
                                    points, table_rows, d4, stride_b,
                                    stride_s, stride_h, w_bf16,
                                    window_of(starts, escapes, tile_q,
                                              window),
                                    stream);
}
