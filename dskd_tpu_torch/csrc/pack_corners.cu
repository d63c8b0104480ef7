// Packed bilinear-corner table for multi-scale deformable attention.
//
// Replaces: dskd_tpu/ops/pack_kernel.py `pack_corners_fused` (`_kernel`),
// the Pallas kernel that builds the level-0 corner table on the TPU.
//
//   out[b, yp*(w+2)+xp, hd, c*D:(c+1)*D] = v[b, (yp+dy-1)*w + (xp+dx-1), hd, :]
//   for corners c = (dy, dx) in ((0,0), (0,1), (1,0), (1,1)); zero where the
//   source pixel lies outside the h x w map.
//
// What bounds it on the H100: bytes. It computes nothing; it reads the level
// features once and writes a table of (h+2)(w+2)/(h*w) * 4 times their size
// (at the flagship's 80x80 level, B=2, H=8, D=32, f32: 13 MB read, 55 MB
// written, about 20 us at 3.35 TB/s). The 4x read amplification lands in L1
// and L2, since neighbouring output rows read the same source rows.
//
// What held the first design back: integer work. One thread per 16-byte
// output vector over the whole table found its place with eight 64-bit
// divisions and remainders by runtime values, as many instructions as the
// level's bytes take to move.
//
// Design: a grid over padded output lines, blockIdx.z = b and blockIdx.y =
// yp; the threads of blockIdx.x cover the line's (w+2) * H * 4 * d_vecs
// vectors, consecutive threads on consecutive output addresses, so every warp
// writes 512 contiguous bytes. d_vecs (16-byte vectors in a D-chunk: 8 for
// f32 D=32, 4 for bf16; any other width takes it at run time) is a template
// parameter, so the corner and the vector inside it are a shift and a mask;
// the one runtime division left is by H, once per thread, in 32 bits. The
// kernel never looks at the element type: a D-chunk is a whole number of
// 16-byte vectors (the wrapper checks this), so f32 and bf16 run the same
// code on `uint4`s. The batch stride of `v` is an argument, so a level sliced
// out of the (B, S, H, D) value tensor is read in place. Stores keep the
// default caching: the gather that follows reads the table from L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// kDV: vectors per D-chunk, 0 when given at run time (d_vecs).
template <int kDV>
__global__ void __launch_bounds__(kThreads)
pack_corners_kernel(const uint4* __restrict__ v, uint4* __restrict__ out,
                    int64_t v_batch_vecs, int h, int w, int heads,
                    int d_vecs) {
  const int dv = kDV ? kDV : d_vecs;
  const int row_vecs = 4 * dv;              // one (pixel, head) row of 4D
  const int line_vecs = (w + 2) * heads * row_vecs;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= line_vecs) return;
  const int yp = blockIdx.y;
  const int b = blockIdx.z;
  const int j = t % row_vecs;               // shifts when kDV is given
  const int ph = t / row_vecs;              // (xp, hd)
  const int xp = ph / heads;
  const int hd = ph - xp * heads;
  const int c = j / dv;                     // corner 0..3
  const int k = j - c * dv;                 // vector inside the D-chunk
  const int y = yp + (c >> 1) - 1;
  const int x = xp + (c & 1) - 1;
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (y >= 0 && y < h && x >= 0 && x < w)
    val = __ldg(v + b * v_batch_vecs + ((y * w + x) * heads + hd) * dv + k);
  out[(static_cast<int64_t>(b) * (h + 2) + yp) * line_vecs + t] = val;
}

template <int kDV>
void launch(const uint4* v, uint4* out, int batch, int64_t v_batch_vecs,
            int h, int w, int heads, int d_vecs, cudaStream_t stream) {
  const int line_vecs = (w + 2) * heads * 4 * d_vecs;
  const dim3 grid((line_vecs + kThreads - 1) / kThreads, h + 2, batch);
  pack_corners_kernel<kDV><<<grid, kThreads, 0, stream>>>(
      v, out, v_batch_vecs, h, w, heads, d_vecs);
}

}  // namespace

// v: level features, (batch, h*w, heads, D) with the inner three dims
// contiguous and batch stride `v_batch_vecs` (in 16-byte vectors).
// out: contiguous (batch, (h+2)*(w+2), heads, 4*D).
// d_vecs: 16-byte vectors in one D-chunk (D * element size / 16).
// The wrapper keeps batch and h + 2 within the grid's limits and one line's
// and one image's vectors within 32 bits. Returns cudaGetLastError() after
// the launch.
extern "C" int pack_corners(const void* v, void* out, int64_t batch,
                            int64_t v_batch_vecs, int h, int w, int heads,
                            int d_vecs, void* stream) {
  if (batch == 0 || heads == 0 || d_vecs == 0)
    return static_cast<int>(cudaSuccess);
  const uint4* src = static_cast<const uint4*>(v);
  uint4* dst = static_cast<uint4*>(out);
  const int n = static_cast<int>(batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the flagship's D = 32: 8 vectors in f32, 4 in bf16
  if (d_vecs == 8) {
    launch<8>(src, dst, n, v_batch_vecs, h, w, heads, d_vecs, st);
  } else if (d_vecs == 4) {
    launch<4>(src, dst, n, v_batch_vecs, h, w, heads, d_vecs, st);
  } else {
    launch<0>(src, dst, n, v_batch_vecs, h, w, heads, d_vecs, st);
  }
  return static_cast<int>(cudaGetLastError());
}
