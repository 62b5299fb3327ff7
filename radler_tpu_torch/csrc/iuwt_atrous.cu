// One scale of the à-trous IUWT decomposition for Hopper (sm_90a).
//
// Replaces radler_tpu/ops/pallas/iuwt_atrous.py::_atrous_kernel (reached
// through atrous_decompose_lo), which runs scales 0..n_lo-1 in one pass;
// here the wrapper (kernels/iuwt_atrous.py) launches this kernel once per
// scale, each launch reading the carried smooth plane of the scale before.
//
// What one launch computes, for scale s with dilation d = 2^(s+1) - 1 and
// the B3-spline taps h = [1, 4, 6, 4, 1] / 16 (iuwt_decomposition.h:243-261,
// 100-119):
//   C(x)    = the vertical pass of the horizontal pass of x, each pass
//             out[p] = h2*x[p] + h0*x[p-2d] + h1*x[p-d] + h3*x[p+d] + h4*x[p+2d]
//             with zero outside the image (the reference's dropped taps);
//   smooth  = C(in)              (the next scale's input),
//   w       = in - C(smooth)     (this scale's wavelet plane),
// for every plane of a [B, H, W] batch.
//
// Design: at dilation d every tap of both convolutions of a pixel lies on
// the pixel's own lattice {(y + i*d, x + j*d)}, so the image splits into d*d
// polyphase sub-images, and on each the scale is an undilated 5-tap cascade.
// A block owns a 32 x 32 tile of one sub-image.  It loads the tile with a
// halo of 4 lattice steps (40 x 40 values; outside the image, zero), runs the
// horizontal and vertical passes of C(in) on the 36 x 36 region the second
// convolution needs, zeroes it outside the image (the zero boundary of
// every convolution), runs the second pair of passes on the 32 x 32 tile and
// writes w and smooth.  All intermediates stay in 17 KB of shared memory,
// whatever the dilation, so one kernel serves every scale.  Neighbouring
// blocks take neighbouring phases, so a warp's strided loads at d > 1 fall
// on lines that the blocks beside it read too, mostly from L2.
//
// Fusing scales into one launch, as the TPU kernel does, needs a halo of the
// whole cascade's reach (the TPU kernel's cascade_reach: 36 pixels at 3
// scales, 82 at 4, 176 at 5) around a two-dimensional tile; at 4 scales and
// more that exceeds the 227 KB a block may hold even for a one-pixel tile.
// So the launches are per scale, and the carried planes go through device
// memory.
//
// What bounds it: device-memory bytes.  The function atrous_decompose_lo
// reads one plane and writes n_lo + 1; at 4096^2 and n_lo = 3 that is 335.5
// MB, 100.2 us at 3.35 TB/s.  These per-scale launches read one plane and
// write two each, 3 * n_lo planes in all (9 at n_lo = 3).  Arithmetic is
// about 40 flops per pixel per scale, far below the card's rate.
//
// Rounding: every product and sum uses the _rn intrinsics (never contracted
// into a fused multiply-add), in the order of the plain PyTorch version in
// kernels/iuwt_atrous.py (h2*x first, then the taps at -2d, -d, +d, +2d;
// horizontal before vertical; then in - C(smooth)), so the two agree bit for
// bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see kernels/_build.py).  Plain C entry point for
// ctypes; it returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;             // output tile, in lattice steps
constexpr int kIn = kTile + 8;        // input tile with a halo of 4
constexpr int kMid = kTile + 4;       // the smooth plane with a halo of 2
constexpr int kThreads = 256;

constexpr float kH0 = 1.0f / 16.0f;   // taps at -2d and +2d
constexpr float kH1 = 4.0f / 16.0f;   // taps at -d and +d
constexpr float kH2 = 6.0f / 16.0f;   // the centre tap

// h2*c, then + h0*m2, + h1*m1, + h1*p1, + h0*p2, one rounding each.
__device__ __forceinline__ float taps(float m2, float m1, float c, float p1,
                                      float p2) {
  float s = __fmul_rn(kH2, c);
  s = __fadd_rn(s, __fmul_rn(kH0, m2));
  s = __fadd_rn(s, __fmul_rn(kH1, m1));
  s = __fadd_rn(s, __fmul_rn(kH1, p1));
  s = __fadd_rn(s, __fmul_rn(kH0, p2));
  return s;
}

__global__ void __launch_bounds__(kThreads)
    atrous_scale_kernel(const float* __restrict__ in, float* __restrict__ w,
                        float* __restrict__ smooth, int height, int width,
                        int dilation, int phases_x, int phases_y) {
  __shared__ float s_in[kIn][kIn];
  __shared__ float s_tmp[kIn][kMid];   // horizontal passes
  __shared__ float s_mid[kMid][kMid];  // C(in) around the tile

  const int d = dilation;
  const int px = blockIdx.x % phases_x;  // phase of this sub-image
  const int py = blockIdx.y % phases_y;
  const int x0 = (blockIdx.x / phases_x) * kTile;  // tile origin, lattice
  const int y0 = (blockIdx.y / phases_y) * kTile;  // steps
  const size_t plane = static_cast<size_t>(height) * width;
  in += blockIdx.z * plane;
  w += blockIdx.z * plane;
  smooth += blockIdx.z * plane;

  // Lattice coordinates (i, j) relative to the tile origin map to image
  // pixel (py + (y0 + i) * d, px + (x0 + j) * d).
  auto gy = [&](int i) { return py + (y0 + i) * d; };
  auto gx = [&](int j) { return px + (x0 + j) * d; };

  for (int k = threadIdx.x; k < kIn * kIn; k += kThreads) {
    const int r = k / kIn, c = k % kIn;
    const int y = gy(r - 4), x = gx(c - 4);
    s_in[r][c] = (y >= 0 && y < height && x >= 0 && x < width)
                     ? in[static_cast<size_t>(y) * width + x]
                     : 0.0f;
  }
  __syncthreads();

  // C(in) = vertical(horizontal(in)) on lattice rows and columns -2..kTile+1.
  for (int k = threadIdx.x; k < kIn * kMid; k += kThreads) {
    const int r = k / kMid, c = k % kMid;
    const float* row = s_in[r] + c;
    s_tmp[r][c] = taps(row[0], row[1], row[2], row[3], row[4]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kMid * kMid; k += kThreads) {
    const int r = k / kMid, c = k % kMid;
    const int y = gy(r - 2), x = gx(c - 2);
    const float v = taps(s_tmp[r][c], s_tmp[r + 1][c], s_tmp[r + 2][c],
                         s_tmp[r + 3][c], s_tmp[r + 4][c]);
    s_mid[r][c] = (y >= 0 && y < height && x >= 0 && x < width) ? v : 0.0f;
  }
  __syncthreads();

  // C(smooth) on the tile: the horizontal pass on rows -2..kTile+1, then
  // the vertical pass, then w = in - C(smooth).
  for (int k = threadIdx.x; k < kMid * kTile; k += kThreads) {
    const int r = k / kTile, c = k % kTile;
    const float* row = s_mid[r] + c;
    s_tmp[r][c] = taps(row[0], row[1], row[2], row[3], row[4]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kTile * kTile; k += kThreads) {
    const int r = k / kTile, c = k % kTile;
    const int y = gy(r), x = gx(c);
    if (y >= height || x >= width) continue;
    const float v = taps(s_tmp[r][c], s_tmp[r + 1][c], s_tmp[r + 2][c],
                         s_tmp[r + 3][c], s_tmp[r + 4][c]);
    const size_t at = static_cast<size_t>(y) * width + x;
    w[at] = __fsub_rn(s_in[r + 4][c + 4], v);
    smooth[at] = s_mid[r + 2][c + 2];
  }
}

}  // namespace

extern "C" int atrous_scale(const float* in, float* w, float* smooth,
                            int batch, int height, int width, int dilation,
                            cudaStream_t stream) {
  // Lattice points per phase, at most; each phase gets the same tile grid.
  // Phases at or past the image's edge hold no pixel and get no block.
  const int lattice_y = (height + dilation - 1) / dilation;
  const int lattice_x = (width + dilation - 1) / dilation;
  const int tiles_y = (lattice_y + kTile - 1) / kTile;
  const int tiles_x = (lattice_x + kTile - 1) / kTile;
  const int phases_y = dilation < height ? dilation : height;
  const int phases_x = dilation < width ? dilation : width;
  const dim3 grid(tiles_x * phases_x, tiles_y * phases_y, batch);
  atrous_scale_kernel<<<grid, kThreads, 0, stream>>>(
      in, w, smooth, height, width, dilation, phases_x, phases_y);
  return static_cast<int>(cudaGetLastError());
}
