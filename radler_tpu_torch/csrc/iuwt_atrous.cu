// The à-trous IUWT decomposition for Hopper (sm_90a): the lowest scales
// fused into one launch, and one launch per scale above them, on tiles of
// the scale's lattice.
//
// Replaces radler_tpu/ops/pallas/iuwt_atrous.py::_atrous_kernel (reached
// through atrous_decompose_lo), which runs scales 0..n_lo-1 in one pass.
//
// What scale s computes, with dilation d = 2^(s+1) - 1 and the B3-spline
// taps h = [1, 4, 6, 4, 1] / 16 (iuwt_decomposition.h:243-261, 100-119):
//   C(x)    = the vertical pass of the horizontal pass of x, each pass
//             out[p] = h2*x[p] + h0*x[p-2d] + h1*x[p-d] + h3*x[p+d] + h4*x[p+2d]
//             with zero outside the image (the reference's dropped taps);
//   next    = C(cur)             (the next scale's input; the last one is
//                                 the smooth plane),
//   w[s]    = cur - C(next)      (this scale's wavelet plane),
// for every plane of a [B, H, W] batch, starting from cur = the image.
//
// Design.  A block owns a core of pixels, loads it with the halo that its
// scales reach, keeps three buffers of that size in shared memory, runs
// each scale as four passes (horizontal, vertical with the zero boundary,
// horizontal, vertical) that rotate through the three buffers, and writes
// each w[s] and, at its last scale, the smooth plane.  All buffers share
// one coordinate system (the loaded tile's), so a pass is a region and a
// spacing.
//
//   * Contiguous tiles for the fused low scales (atrous_fused_kernel): a
//     core of 64 x 64 pixels with a halo of the cascade's reach (4 at one
//     scale, 14 at two: cascade_reach of the TPU kernel).  Two scales read
//     one plane and write three, the function's bound, where a launch per
//     scale moves six; 103 KB of shared memory, two blocks per SM.  A
//     third scale (halo 36, 224 KB, one block per SM) was slower on the
//     card than two and a lattice launch, so two is the most.  A tile
//     inside the image whose rows are 16-byte aligned loads them with
//     16-byte loads (load_rows16).
//   * Lattice tiles for a single scale at dilation d >= 7: every tap of a
//     pixel lies on its own lattice {(y + i d, x + j d)}, so on the lattice
//     the scale is an undilated cascade with a halo of 4 steps, whatever d.
//     A block takes rows x cols lattice points of one y-phase and of px
//     neighbouring x-phases: a buffer row holds lattice column j's px
//     phases at columns j px .. j px + px - 1, so a warp's loads and stores
//     are runs of px neighbouring pixels (the whole row is contiguous when
//     px = d, at d = 7 and 15; runs of 64 or 128 bytes above), and the
//     horizontal pass has spacing px.  The wrapper's plan picks px and the
//     tile from d and the lattice's size (kernels/iuwt_atrous.py::
//     lattice_tile), so that at d = 511 on a 4096^2 image a block is a
//     9 x 9 lattice tile and not mostly padding.
//   * A pass gives each thread a segment of a chain of outputs of one row
//     (or column) at the pass's spacing and slides a window of five values
//     along it: one shared-memory load and one store per output, and each
//     value's three products with the taps computed once, as it enters the
//     window (7 operations per output where taps() of every output alone
//     takes 9; the same products and sums, so the same bits).  Rows have an
//     odd stride, so a warp's accesses fall in distinct banks along rows
//     and along columns.
//   * Every tile's geometry is fixed at compile time (Fused, LatticeTile;
//     four lattice tiles serve every dilation): the segments unroll, the
//     window moves through registers without copies and every address is a
//     constant offset.  With the same code on run-time bounds the fused
//     pair took 0.39 ms at 4096^2, more than the launch per scale it
//     replaced; unrolled, 0.17 ms.  A lattice shorter than its tile pads
//     it (the pixels beyond the image are zero and are not written).
//   * A tile that lies inside the image with its halo (nearly all of them
//     at 4096^2 and low dilations) checks nothing (kInterior).
//
// What bounds it: device-memory bytes by the count (the function reads one
// plane and writes n_lo + 1; at 4096^2 and n_lo = 2 that is 268.4 MB, 80.1
// us at 3.35 TB/s; the fused launch moves exactly those, a lattice launch
// reads one plane and writes two), but on the card the fused pair runs at
// about twice that bound and the lattice launches at 2 to 5 times theirs:
// they are bound by the SM's dispatch rate and the barriers between
// passes.  The arithmetic is 28 additions and multiplications per pixel and
// scale (no fused multiply-add: the plain version rounds each), the halo's
// recomputation multiplies the first passes by 1.4 to 3.6, and every
// output costs a shared-memory load and a store beside them.
//
// Rounding: every product and sum uses the _rn intrinsics (never contracted
// into a fused multiply-add), in the order of the plain PyTorch version in
// kernels/iuwt_atrous.py (h2*x first, then the taps at -2d, -d, +d, +2d;
// horizontal before vertical; then cur - C(next)), so the two agree bit for
// bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (see
// kernels/_build.py).  Plain C entry point for ctypes; it returns the first
// CUDA error of its set-up and launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

constexpr float kH0 = 1.0f / 16.0f;   // taps at -2d and +2d
constexpr float kH1 = 4.0f / 16.0f;   // taps at -d and +d
constexpr float kH2 = 6.0f / 16.0f;   // the centre tap

// The three products of one value with the taps, each rounded once: a value
// is the centre of one output and the -2d, -d, +d, +2d neighbour of four
// others, so a chain computes them once as the value enters its window.
struct Products {
  float by_h0, by_h1, by_h2;
};

__device__ __forceinline__ Products products(float v) {
  return Products{__fmul_rn(kH0, v), __fmul_rn(kH1, v), __fmul_rn(kH2, v)};
}

// h2*c, then + h0*m2, + h1*m1, + h1*p1, + h0*p2, one rounding each.
__device__ __forceinline__ float taps(const Products& m2, const Products& m1,
                                      const Products& c, const Products& p1,
                                      const Products& p2) {
  float s = c.by_h2;
  s = __fadd_rn(s, m2.by_h0);
  s = __fadd_rn(s, m1.by_h1);
  s = __fadd_rn(s, p1.by_h1);
  s = __fadd_rn(s, p2.by_h0);
  return s;
}

// Where a block's buffer coordinates lie in the image.  Row r is image row
// y0 + r * ystep.  Column c is image column x0 + c on a contiguous tile; on
// a lattice tile, whose columns come in groups of px phases per lattice
// step, it is x0 + (c / px) * xstep + c % px, and only the first pvalid
// phases of a group exist.  Only rows [out0, out1) are written, row y at
// row y - out0 of the outputs: the whole image, or in row-block mode the
// rows a block of the image owns (its input holds them with the halo that
// the launch's scales reach, and the zero boundary lies at its edges).
struct Map {
  int y0, ystep;
  int x0, xstep;
  int px, pvalid;
  int height, width;
  int out0, out1;
};

// The image pixel (y, x) of buffer position (r, c); false outside the image.
template <bool kLattice>
__device__ __forceinline__ bool locate(const Map& m, int r, int c, int& y,
                                       int& x) {
  y = m.y0 + r * m.ystep;
  bool ok = y >= 0 && y < m.height;
  if (kLattice) {
    const int j = c / m.px;
    const int p = c - j * m.px;
    x = m.x0 + j * m.xstep + p;
    ok = ok && p < m.pvalid;
  } else {
    x = m.x0 + c;
  }
  return ok && x >= 0 && x < m.width;
}

// A pass is a 5-tap filter at spacing d, along x or along y, over a region
// of a buffer.  It splits into chains: the outputs o, o + d, o + 2 d, ... of
// one row (or column).  A thread takes a segment of a chain and slides a
// window of five values along it, so an output costs one shared-memory
// load and one store.  This chooses the segments per chain that let the
// block's threads finish soonest: rounds of kThreads segments, times the
// outputs of a segment and the four loads that fill its window.
__host__ __device__ constexpr int choose_segments(int chains, int per_chain) {
  int best = 1, best_cost = 1 << 30;
  for (int n = 1; n <= per_chain; ++n) {
    const int seg = (per_chain + n - 1) / n;
    const int items = chains * ((per_chain + seg - 1) / seg);
    const int cost = ((items + kThreads - 1) / kThreads) * (seg + 4);
    if (cost < best_cost) {
      best_cost = cost;
      best = n;
    }
  }
  return best;
}

// One segment: at most `count` outputs from o on, every d, below o_end.
// p points at the source value of output o; step is d in elements.  Called
// with constants for count, d and step, so the loop unrolls.
template <typename Store>
__device__ __forceinline__ void slide(const float* __restrict__ p, int step,
                                      int count, int o, int d, int o_end,
                                      Store store) {
  if (o >= o_end) return;
  Products m2 = products(p[-2 * step]), m1 = products(p[-step]);
  Products c = products(p[0]), p1 = products(p[step]);
#pragma unroll
  for (int t = 0; t < count; ++t) {
    if (o + t * d >= o_end) break;
    const Products p2 = products(p[(t + 2) * step]);
    store(o + t * d, taps(m2, m1, c, p1, p2));
    m2 = m1;
    m1 = c;
    c = p1;
    p1 = p2;
  }
}

// A pass, its geometry fixed at compile time: the region [kA0, kA1) across
// the pass and [kO0, kO1) along it, in buffer coordinates;
// store(o, a, value) receives every output.  The segments
// unroll, so the window stays in registers without moves and every address
// is a constant offset.  Neighbouring lanes take neighbouring rows (whose
// stride is odd) or columns, or with kPhaseFirst neighbouring phases of a
// pass along x (neighbouring columns): distinct banks in every case.
template <bool kAlongX, bool kPhaseFirst, int kD, int kA0, int kA1, int kO0,
          int kO1, int kStride, typename Store>
__device__ __forceinline__ void pass_fixed(const float* __restrict__ src,
                                           Store store) {
  constexpr int n_across = kA1 - kA0;
  constexpr int per_chain = (kO1 - kO0 + kD - 1) / kD;
  constexpr int wanted = choose_segments(n_across * kD, per_chain);
  constexpr int seg = (per_chain + wanted - 1) / wanted;
  constexpr int n_seg = (per_chain + seg - 1) / seg;
  constexpr int n_items = n_across * kD * n_seg;
  constexpr int step = (kAlongX ? 1 : kStride) * kD;
  for (int item = threadIdx.x; item < n_items; item += kThreads) {
    int a, o;
    if (kPhaseFirst) {
      const int rest = item / kD;
      a = kA0 + rest % n_across;
      o = kO0 + item % kD + (rest / n_across) * (seg * kD);
    } else {
      const int rest = item / n_across;
      a = kA0 + item % n_across;
      o = kO0 + rest % kD + (rest / kD) * (seg * kD);
    }
    slide(src + (kAlongX ? a * kStride + o : o * kStride + a), step, seg, o,
          kD, kO1, [&](int at, float v) { store(at, a, v); });
  }
}

// ---------------------------------------------------------------------------
// Tiles whose geometry is fixed at compile time
// ---------------------------------------------------------------------------

// A launch of scales 0..kScales-1 (one or two) on contiguous tiles: cores
// of kRows x kCols pixels (kernels/iuwt_atrous.py::FUSED_CORE) in buffers
// with the halo of the whole cascade.
template <int kCount>
struct Fused {
  static constexpr bool kLattice = false;
  static constexpr int kScales = kCount;
  static constexpr int kRows = 64;
  static constexpr int kCols = 64;
  // Scale t's spacing along x and y, in buffer units.
  __host__ __device__ static constexpr int dx(int t) { return (2 << t) - 1; }
  __host__ __device__ static constexpr int dy(int t) { return dx(t); }
  // How far beyond the core scale t's `next` is needed: by the scales after
  // it, or by its own second convolution.
  __host__ __device__ static constexpr int ex(int t) {
    return t == kScales - 1 ? 2 * dx(t) : ex(t + 1) + 2 * dx(t + 1);
  }
  __host__ __device__ static constexpr int ey(int t) { return ex(t); }
};

// One scale on a lattice tile of kSide x kSide points and kPx phases
// (kernels/iuwt_atrous.py::LATTICE_TILES): on the lattice the spacing is kPx
// columns along x and one row along y.
template <int kPx, int kSide>
struct LatticeTile {
  static constexpr bool kLattice = true;
  static constexpr int kScales = 1;
  static constexpr int kRows = kSide;
  static constexpr int kCols = kSide * kPx;
  __host__ __device__ static constexpr int dx(int) { return kPx; }
  __host__ __device__ static constexpr int dy(int) { return 1; }
  __host__ __device__ static constexpr int ex(int) { return 2 * kPx; }
  __host__ __device__ static constexpr int ey(int) { return 2; }
};

// The buffers of a tile of geometry G: the core with the halo of scale 0's
// input, rows of an odd stride.
template <typename G>
struct Buffers {
  static constexpr int kHaloX = G::ex(0) + 2 * G::dx(0);
  static constexpr int kHaloY = G::ey(0) + 2 * G::dy(0);
  static constexpr int kBufRows = G::kRows + 2 * kHaloY;
  static constexpr int kBufCols = G::kCols + 2 * kHaloX;
  static constexpr int kStride = kBufCols | 1;
  static constexpr int kBytes = 3 * kBufRows * kStride * sizeof(float);
};

// Scale kT of a tile, then the scales after it.  cur holds this scale's
// input with its halo; tmp and nxt are free.  With kInterior the tile and
// its halo lie inside the image, and nothing is checked.
template <typename G, int kT, bool kInterior>
__device__ __forceinline__ void tile_scales(float* __restrict__ cur,
                                            float* __restrict__ tmp,
                                            float* __restrict__ nxt,
                                            const Map& map,
                                            float* __restrict__ w,
                                            float* __restrict__ smooth,
                                            int64_t scale_stride) {
  using B = Buffers<G>;
  constexpr bool lattice = G::kLattice;
  constexpr int dx = G::dx(kT), dy = G::dy(kT);
  constexpr int ex = G::ex(kT), ey = G::ey(kT);
  constexpr int reach_x = ex + 2 * dx;  // cur's halo at this scale
  constexpr int reach_y = ey + 2 * dy;
  constexpr int r0 = B::kHaloY, r1 = r0 + G::kRows;  // the core
  constexpr int c0 = B::kHaloX, c1 = c0 + G::kCols;
  constexpr int stride = B::kStride;
  // next = C(cur): horizontal, then vertical with zero outside the image.
  pass_fixed<true, lattice, dx, r0 - reach_y, r1 + reach_y, c0 - ex, c1 + ex,
             stride>(
      cur, [&](int o, int a, float v) { tmp[a * stride + o] = v; });
  __syncthreads();
  pass_fixed<false, false, dy, c0 - ex, c1 + ex, r0 - ey, r1 + ey, stride>(
      tmp, [&](int o, int a, float v) {
        int y, x;
        nxt[o * stride + a] =
            kInterior || locate<lattice>(map, o, a, y, x) ? v : 0.0f;
      });
  __syncthreads();
  // w = cur - C(next) on the core; the last scale's next is the smooth
  // plane.
  pass_fixed<true, lattice, dx, r0 - 2 * dy, r1 + 2 * dy, c0, c1, stride>(
      nxt, [&](int o, int a, float v) { tmp[a * stride + o] = v; });
  __syncthreads();
  pass_fixed<false, false, dy, c0, c1, r0, r1, stride>(
      tmp, [&](int o, int a, float v) {
        int y, x;
        if (!locate<lattice>(map, o, a, y, x) && !kInterior) return;
        if (!kInterior && (y < map.out0 || y >= map.out1)) return;
        const size_t at = static_cast<size_t>(y - map.out0) * map.width + x;
        w[at] = __fsub_rn(cur[o * stride + a], v);
        if (kT == G::kScales - 1) smooth[at] = nxt[o * stride + a];
      });
  if constexpr (kT + 1 < G::kScales) {
    __syncthreads();
    tile_scales<G, kT + 1, kInterior>(nxt, cur, tmp, map, w + scale_stride,
                                      smooth, scale_stride);
  }
}

// A contiguous tile's rows with 16-byte loads, for a tile that lies inside
// an image whose rows start on 16-byte boundaries.  The tile's first column
// is kLead floats past such a boundary (a core starts on one), so a row is
// kQuads aligned quads, of which the first and last may hold columns outside
// the buffer.  Lanes 8 apart store different members of their quads at a
// time, so that a warp's 32 stores fall in distinct banks.
template <typename G>
__device__ __forceinline__ void load_rows16(const Map& map,
                                            const float* __restrict__ in,
                                            float* __restrict__ cur) {
  using B = Buffers<G>;
  static_assert(G::kCols % 4 == 0, "a core starts on a 16-byte boundary");
  constexpr int kLead = (4 - B::kHaloX % 4) % 4;
  constexpr int kQuads = (kLead + B::kBufCols + 3) / 4;
  const int turn = (threadIdx.x >> 3) & 3;
  for (int i = threadIdx.x; i < B::kBufRows * kQuads; i += kThreads) {
    const int r = i / kQuads;
    const int q = i - r * kQuads;
    const float4 v = *reinterpret_cast<const float4*>(
        in + static_cast<size_t>(map.y0 + r) * map.width +
        (map.x0 - kLead + 4 * q));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = (j + turn) & 3;
      const int c = 4 * q - kLead + e;
      const float part = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
      if (c >= 0 && c < B::kBufCols) cur[r * B::kStride + c] = part;
    }
  }
}

// Load the tile with its halo (zero outside the image) and run its scales.
template <typename G>
__device__ __forceinline__ void run_tile(const Map& map, bool interior,
                                         const float* __restrict__ in,
                                         float* __restrict__ w,
                                         float* __restrict__ smooth,
                                         int64_t scale_stride) {
  using B = Buffers<G>;
  extern __shared__ float buffers[];
  float* const cur = buffers;
  float* const tmp = cur + B::kBufRows * B::kStride;
  float* const nxt = tmp + B::kBufRows * B::kStride;
  bool rows16 = false;
  if constexpr (!G::kLattice)
    rows16 = interior && map.width % 4 == 0 &&
             reinterpret_cast<uintptr_t>(in) % 16 == 0;
  if (rows16) {
    if constexpr (!G::kLattice) load_rows16<G>(map, in, cur);
  } else {
    for (int i = threadIdx.x; i < B::kBufRows * B::kBufCols; i += kThreads) {
      const int r = i / B::kBufCols;
      const int c = i - r * B::kBufCols;
      int y, x;
      const bool inside = locate<G::kLattice>(map, r, c, y, x);
      cur[r * B::kStride + c] =
          interior || inside ? in[static_cast<size_t>(y) * map.width + x]
                             : 0.0f;
    }
  }
  __syncthreads();
  if (interior)
    tile_scales<G, 0, true>(cur, tmp, nxt, map, w, smooth, scale_stride);
  else
    tile_scales<G, 0, false>(cur, tmp, nxt, map, w, smooth, scale_stride);
}

// ---------------------------------------------------------------------------
// The fused low scales, on contiguous tiles
// ---------------------------------------------------------------------------

// blockIdx.x and .y count cores (from row out0 on), blockIdx.z the planes.
template <int kScales>
__global__ void __launch_bounds__(kThreads, 2)
    atrous_fused_kernel(const float* __restrict__ in, float* __restrict__ w,
                        float* __restrict__ smooth, int height, int width,
                        int64_t scale_stride, int out0, int out_rows) {
  using G = Fused<kScales>;
  using B = Buffers<G>;
  Map map;
  map.height = height;
  map.width = width;
  map.out0 = out0;
  map.out1 = out0 + out_rows;
  map.ystep = 1;
  map.y0 = out0 + blockIdx.y * G::kRows - B::kHaloY;
  map.xstep = 0;
  map.x0 = blockIdx.x * G::kCols - B::kHaloX;
  map.px = map.pvalid = B::kBufCols;
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t out_plane = static_cast<size_t>(out_rows) * width;
  const bool interior = map.y0 >= 0 && map.x0 >= 0 &&
                        map.y0 + B::kBufRows <= height &&
                        map.x0 + B::kBufCols <= width &&
                        map.y0 + B::kHaloY + G::kRows <= map.out1;
  run_tile<G>(map, interior, in + blockIdx.z * plane,
              w + blockIdx.z * out_plane, smooth + blockIdx.z * out_plane,
              scale_stride);
}

template <int kScales>
int launch_fused(const float* in, float* w, float* smooth, int batch,
                 int height, int width, int64_t scale_stride, int out0,
                 int out_rows, cudaStream_t stream) {
  using G = Fused<kScales>;
  const int shared_bytes = Buffers<G>::kBytes;
  const dim3 grid((width + G::kCols - 1) / G::kCols,
                  (out_rows + G::kRows - 1) / G::kRows, batch);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      atrous_fused_kernel<kScales>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  atrous_fused_kernel<kScales><<<grid, kThreads, shared_bytes, stream>>>(
      in, w, smooth, height, width, scale_stride, out0, out_rows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// One scale on lattice tiles
// ---------------------------------------------------------------------------

// A tile of kSide x kSide lattice points and kPx x-phases of the scale at
// dilation d.  blockIdx.x counts groups of kPx phases fastest (groups_x of
// them hold a pixel), then tiles of lattice columns; blockIdx.y counts
// y-phases fastest (phases_y of them hold a pixel), then tiles of lattice
// rows, so neighbouring blocks read neighbouring pixels; blockIdx.z is the
// plane.
template <int kPx, int kSide>
__global__ void __launch_bounds__(kThreads, 2)
    atrous_lattice_kernel(const float* __restrict__ in, float* __restrict__ w,
                          float* __restrict__ smooth, int height, int width,
                          int d, int groups_x, int phases_y, int out0,
                          int out_rows) {
  const int group = blockIdx.x % groups_x;
  const int tile_x = blockIdx.x / groups_x;
  const int phase_y = blockIdx.y % phases_y;
  const int tile_y = blockIdx.y / phases_y;
  Map map;
  map.height = height;
  map.width = width;
  map.out0 = out0;
  map.out1 = out0 + out_rows;
  map.ystep = d;
  map.y0 = phase_y + (tile_y * kSide - 4) * d;
  map.xstep = d;
  map.x0 = group * kPx + (tile_x * kSide - 4) * d;
  map.px = kPx;
  map.pvalid = min(kPx, d - group * kPx);
  // A core that starts beyond the image, or whose rows all lie outside
  // [out0, out1), writes no pixel.
  const int core_y0 = map.y0 + 4 * d;
  const int core_y1 = core_y0 + (kSide - 1) * d;  // its last row
  if (core_y0 >= height || map.x0 + 4 * d >= width || core_y1 < map.out0 ||
      core_y0 >= map.out1)
    return;
  // Whether the last pixel of the buffer's last row, lattice column and
  // phase, and so the whole tile with its halo, lies inside the image, and
  // the core inside the rows written.
  const bool interior = map.pvalid == kPx && map.y0 >= 0 && map.x0 >= 0 &&
                        map.y0 + (kSide + 7) * d < height &&
                        map.x0 + (kSide + 7) * d + kPx - 1 < width &&
                        core_y0 >= map.out0 && core_y1 < map.out1;
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t out_plane = static_cast<size_t>(out_rows) * width;
  run_tile<LatticeTile<kPx, kSide>>(map, interior, in + blockIdx.z * plane,
                                    w + blockIdx.z * out_plane,
                                    smooth + blockIdx.z * out_plane, 0);
}

template <int kPx, int kSide>
int launch_lattice(const float* in, float* w, float* smooth, int batch,
                   int height, int width, int d, int out0, int out_rows,
                   cudaStream_t stream) {
  // Phases at or past the image's edge hold no pixel and get no block.
  const int phases_y = d < height ? d : height;
  const int groups_x = ((d < width ? d : width) + kPx - 1) / kPx;
  const int tiles_y = ((height + d - 1) / d + kSide - 1) / kSide;
  const int tiles_x = ((width + d - 1) / d + kSide - 1) / kSide;
  const int64_t grid_y = static_cast<int64_t>(tiles_y) * phases_y;
  if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles_x * groups_x, static_cast<unsigned>(grid_y), batch);
  const int shared_bytes = Buffers<LatticeTile<kPx, kSide>>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      atrous_lattice_kernel<kPx, kSide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  atrous_lattice_kernel<kPx, kSide><<<grid, kThreads, shared_bytes, stream>>>(
      in, w, smooth, height, width, d, groups_x, phases_y, out0, out_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Scales 0..n_scales-1 of `in` (batch planes of height x width) in one
// launch on contiguous tiles: rows [out0, out0 + out_rows) of w[t] at
// w + t * scale_stride and of the carried plane into `smooth`, each plane
// of the batch out_rows x width.  The whole image is out0 = 0, out_rows =
// height; a row block passes its rows with their halo as the image.
int atrous_fused(const float* in, float* w, float* smooth, int batch,
                 int height, int width, int64_t scale_stride, int n_scales,
                 int out0, int out_rows, cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || height < 1 || width < 1 || out0 < 0 ||
      out_rows < 1 || out0 + out_rows > height)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (n_scales) {
    case 1:
      return launch_fused<1>(in, w, smooth, batch, height, width,
                             scale_stride, out0, out_rows, stream);
    case 2:
      return launch_fused<2>(in, w, smooth, batch, height, width,
                             scale_stride, out0, out_rows, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One scale at dilation d on lattice tiles of side x side points and px
// neighbouring x-phases (one of kernels/iuwt_atrous.py::LATTICE_TILES),
// writing rows [out0, out0 + out_rows) as atrous_fused does.
int atrous_scale(const float* in, float* w, float* smooth, int batch,
                 int height, int width, int d, int px, int side, int out0,
                 int out_rows, cudaStream_t stream) {
  if (d < 1 || px > d || batch < 1 || batch > 65535 || height < 1 ||
      width < 1 || out0 < 0 || out_rows < 1 || out0 + out_rows > height)
    return static_cast<int>(cudaErrorInvalidValue);
#define RADLER_LATTICE(PX, SIDE)                                         \
  if (px == PX && side == SIDE)                                          \
    return launch_lattice<PX, SIDE>(in, w, smooth, batch, height, width, \
                                    d, out0, out_rows, stream);
  RADLER_LATTICE(7, 28)
  RADLER_LATTICE(15, 17)
  RADLER_LATTICE(16, 16)
  RADLER_LATTICE(32, 9)
#undef RADLER_LATTICE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
