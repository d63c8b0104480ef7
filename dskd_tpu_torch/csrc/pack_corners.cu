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
// (at the flagship's 80x80 level, B=4, H=8, D=32, f32: 26 MB read, 110 MB
// written, so about 41 us at 3.35 TB/s).
//
// Design: one thread per 16-byte output vector, consecutive threads on
// consecutive output addresses, so every warp writes 512 contiguous bytes.
// The kernel never looks at the element type: a D-chunk is a whole number of
// 16-byte vectors (the wrapper checks this), so f32 and bf16 run the same
// code on `uint4`s. The source vector of each output vector is a static
// re-indexing; the 4x read amplification lands in L1/L2, since the four
// corners of neighbouring rows read the same source rows. The batch stride of
// `v` is an argument, so a level sliced out of the (B, S, H, D) value tensor
// is read in place.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pack_corners_kernel(const uint4* __restrict__ v,
                                    uint4* __restrict__ out, int64_t total,
                                    int64_t v_batch_vecs, int h, int w,
                                    int heads, int d_vecs) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= total) return;
  const int row_vecs = 4 * d_vecs;          // one (pixel, head) row of 4D
  const int j = static_cast<int>(t % row_vecs);
  int64_t rest = t / row_vecs;
  const int hd = static_cast<int>(rest % heads);
  rest /= heads;
  const int wp = w + 2;
  const int64_t sp = static_cast<int64_t>(h + 2) * wp;
  const int64_t r = rest % sp;
  const int64_t b = rest / sp;
  const int yp = static_cast<int>(r / wp);
  const int xp = static_cast<int>(r % wp);
  const int c = j / d_vecs;                 // corner 0..3
  const int k = j - c * d_vecs;             // vector inside the D-chunk
  const int y = yp + (c >> 1) - 1;
  const int x = xp + (c & 1) - 1;
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (y >= 0 && y < h && x >= 0 && x < w) {
    val = __ldg(v + b * v_batch_vecs +
                ((static_cast<int64_t>(y) * w + x) * heads + hd) * d_vecs + k);
  }
  out[t] = val;
}

}  // namespace

// v: level features, (batch, h*w, heads, D) with the inner three dims
// contiguous and batch stride `v_batch_vecs` (in 16-byte vectors).
// out: contiguous (batch, (h+2)*(w+2), heads, 4*D).
// d_vecs: 16-byte vectors in one D-chunk (D * element size / 16).
// Returns cudaGetLastError() after the launch.
extern "C" int pack_corners(const void* v, void* out, int64_t batch,
                            int64_t v_batch_vecs, int h, int w, int heads,
                            int d_vecs, void* stream) {
  const int64_t total = batch * static_cast<int64_t>(h + 2) * (w + 2) * heads *
                        4 * d_vecs;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pack_corners_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(v), static_cast<uint4*>(out), total,
      v_batch_vecs, h, w, heads, d_vecs);
  return static_cast<int>(cudaGetLastError());
}
