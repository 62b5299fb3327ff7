// One Högbom CLEAN minor iteration for Hopper (sm_90a), as two launches.
//
// Replaces radler_tpu/ops/pallas/hogbom_step.py::_step_kernel (reached
// through fused_clean_step and the device loop hogbom_loop_pallas).
//
// What it computes, per iteration, with the peak (y, x) and the component
// values read from a small device state buffer:
//   hogbom_step    model[n, y, x] += values[n]; then for every pixel p:
//                  res[n, p] -= values[n] * psf[n / P] shifted to (y, x)
//                  (zero outside the PSF, the clipping of
//                  simple_clean.cc:61-96), the joined integration of the N
//                  new values in one of four modes, times the peak-search
//                  weight, abs() when negatives are allowed.  Each block
//                  reduces its pixels to one partial (max, smallest flat
//                  index, signed integrated value).
//   hogbom_select  one block reduces the partials with the same tie-break
//                  (the smallest flat index among equal maxima, as the TPU
//                  kernel's block-ordered running max gives), then runs the
//                  loop body's epilogue: the signed, rms-weighted value at
//                  the new peak, found = cmp > FLT_MIN, the divergence test,
//                  the stop test of the loop condition, and the next
//                  iteration's gain-scaled component values.
//
// What bounds it: device-memory bytes.  One iteration reads the residual
// and the shifted PSF and writes the residual back, about 3 * N * H * W * 4
// bytes, plus H * W * 4 bytes when a weight plane is read; at 4096^2 with
// N = 1 that is 201 MB, or 60 us at the H100's 3.35 TB/s.  Arithmetic is a
// few flops per byte.  The design streams each plane once, in contiguous
// runs of flat pixels per block so that neighbouring threads touch
// neighbouring addresses in the residual, the PSF and the weight, and keeps
// the integration in registers.  The cross-block argmax needs a second
// launch because blocks run in no order; its work is a few thousand
// partials.  TPU-only machinery (the padded PSF canvas, tile-aligned
// over-fetch, DMA double buffer and rotate) is not carried: the PSF is read
// un-padded with a bounds check.
//
// Rounding: every multiply, add, subtract and square root uses the _rn
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fsqrt_rn), which nvcc never
// contracts into a fused multiply-add.  The plain PyTorch version in
// kernels/hogbom_step.py performs the same operations in the same order
// with no contraction, so the two agree bit for bit and pick the same peak
// on near-ties.
//
// Row shards: a shard of a taller image (the mesh loop, chan == 1) passes
// its first image row as row_offset and the PSFs at the image's full height
// psf_height; the peak (y, x) is in image rows, the model update happens on
// the shard that holds row y, and partial indices are shard-local.  Row
// shards run their own instantiation of the kernel: in the single-device
// one the offset and the PSF height fold away, which keeps its registers
// (the PSF's own plane stride cost a spill and 1% of config 1's time).
//
// Facets: the batched facet route runs F facets' loops in lockstep, each
// facet's cube, weight plane, state, component values and partials one
// after another in memory (the PSFs shared or one stack a facet).  The step
// takes the facet from blockIdx.y and the select runs one block a facet;
// each facet's blocks read its state and return at once when it is done.
// Both are further instantiations of the same templates, so the
// single-cube kernels' code is unchanged, and one facet gives their bits.
// One facet's step launches the single-cube instantiation itself: the
// facet offsets cost the signed mode 40 registers against B1's 32, and
// 14% of its time at config 1.
//
// Loop control stays on the device: both kernels return at once when the
// state's `active` flag is 0, so iterations enqueued after the stop leave
// every tensor unchanged, and the host reads the state only every few
// iterations.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see kernels/_build.py).  Plain C entry points for
// ctypes; each returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// Integration modes and state layout, shared with kernels/hogbom_step.py.
enum Mode { kSigned = 0, kLinear = 1, kNormal = 2, kSquared = 3 };
enum StateSlot {
  kY = 0,
  kX = 1,
  kFound = 2,
  kDiverging = 3,
  kIteration = 4,
  kActive = 5,
  kIndex = 6,
};
constexpr int kStateSize = 8;

constexpr int kStepThreads = 256;
constexpr int kSelectThreads = 1024;

struct Best {
  float cmp;
  int idx;
  float integ;
};

__device__ __forceinline__ bool better(float cmp, int idx, const Best& b) {
  return cmp > b.cmp || (cmp == b.cmp && idx < b.idx);
}

__device__ __forceinline__ Best no_peak() {
  return Best{-INFINITY, INT_MAX, 0.0f};
}

__device__ __forceinline__ void warp_reduce(Best& b) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float cmp = __shfl_down_sync(0xffffffffu, b.cmp, offset);
    const int idx = __shfl_down_sync(0xffffffffu, b.idx, offset);
    const float integ = __shfl_down_sync(0xffffffffu, b.integ, offset);
    if (better(cmp, idx, b)) b = Best{cmp, idx, integ};
  }
}

// The block's best (cmp, idx, integ); valid in thread 0.
template <int kThreads>
__device__ Best block_reduce(Best b) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float s_cmp[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_integ[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_reduce(b);
  if (lane == 0) {
    s_cmp[warp] = b.cmp;
    s_idx[warp] = b.idx;
    s_integ[warp] = b.integ;
  }
  __syncthreads();
  if (warp == 0) {
    b = lane < kWarps ? Best{s_cmp[lane], s_idx[lane], s_integ[lane]}
                      : no_peak();
    warp_reduce(b);
  }
  return b;
}

// max(x, 0) that keeps a NaN, as jnp.maximum and torch.clamp_min do.
__device__ __forceinline__ float clamp_min0(float x) {
  return x < 0.0f ? 0.0f : x;
}

// coefs: [N] per-plane coefficients (signed: the single coefficient; linear:
// one per plane; normal: the polarization coefficient of the plane; squared:
// channel x polarization coefficient), then [C] channel coefficients
// (normal mode only).
// With kFacets, every pointer but psf and coefs advances by blockIdx.y
// facets (psf by psf_facet_stride floats, 0 for shared PSFs).
template <int kMode, bool kRowShard, bool kFacets>
__global__ void __launch_bounds__(kStepThreads)
    hogbom_step_kernel(float* __restrict__ res, float* __restrict__ model,
                       const float* __restrict__ psf,
                       const float* __restrict__ weight,
                       const float* __restrict__ coefs,
                       const float* __restrict__ values,
                       const int* __restrict__ state,
                       float* __restrict__ part_cmp,
                       int* __restrict__ part_idx,
                       float* __restrict__ part_integ, int n_images,
                       int n_pols, int height, int width,
                       int shard_psf_height, int shard_row_offset,
                       int pixels_per_block, int allow_negative,
                       int64_t psf_facet_stride) {
  if (kFacets) {
    const int64_t f = blockIdx.y;
    const int64_t facet_plane = static_cast<int64_t>(height) * width;
    const int64_t cube = n_images * facet_plane;
    res += f * cube;
    model += f * cube;
    psf += f * psf_facet_stride;
    if (weight) weight += f * facet_plane;
    values += f * n_images;
    state += f * kStateSize;
    part_cmp += f * gridDim.x;
    part_idx += f * gridDim.x;
    part_integ += f * gridDim.x;
  }
  if (state[kActive] == 0) return;
  const int y = state[kY];
  const int x = state[kX];
  const int psf_height = kRowShard ? shard_psf_height : height;
  const int row_offset = kRowShard ? shard_row_offset : 0;
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t psf_plane =
      kRowShard ? static_cast<int64_t>(psf_height) * width : plane;

  const int local_y = y - row_offset;
  if (blockIdx.x == 0 && local_y >= 0 && local_y < height) {
    for (int n = threadIdx.x; n < n_images; n += blockDim.x) {
      float* m = model + n * plane + static_cast<int64_t>(local_y) * width + x;
      *m = __fadd_rn(*m, values[n]);
    }
  }

  const float* chan_coefs = coefs + n_images;
  // Local row py is image row py + row_offset, and reads PSF row py + oy.
  const int oy = row_offset + psf_height / 2 - y;
  const int ox = width / 2 - x;
  const int begin = blockIdx.x * pixels_per_block;
  const int end = min(begin + pixels_per_block, static_cast<int>(plane));
  Best best = no_peak();
  for (int p = begin + threadIdx.x; p < end; p += kStepThreads) {
    const int py = p / width;
    const int px = p - py * width;
    const int sy = py + oy;
    const int sx = px + ox;
    const bool inside = sy >= 0 && sy < psf_height && sx >= 0 && sx < width;
    const int64_t src = static_cast<int64_t>(sy) * width + sx;
    float integ = 0.0f;
    float sq = 0.0f;
    for (int n = 0; n < n_images; ++n) {
      const int c = n / n_pols;
      const int pol = n - c * n_pols;
      const float shifted = inside ? psf[c * psf_plane + src] : 0.0f;
      float* r = res + n * plane + p;
      const float v = __fsub_rn(*r, __fmul_rn(values[n], shifted));
      *r = v;
      if (kMode == kSigned) {
        integ = __fmul_rn(v, coefs[0]);
      } else if (kMode == kLinear) {
        const float term = __fmul_rn(v, coefs[n]);
        integ = n == 0 ? term : __fadd_rn(integ, term);
      } else if (kMode == kSquared) {
        const float term = __fmul_rn(__fmul_rn(v, v), coefs[n]);
        sq = n == 0 ? term : __fadd_rn(sq, term);
      } else {  // normal
        float per_chan;
        bool chan_done;
        if (n_pols == 1) {
          per_chan = v;
          chan_done = true;
        } else {
          const float term = __fmul_rn(__fmul_rn(v, v), coefs[n]);
          sq = pol == 0 ? term : __fadd_rn(sq, term);
          chan_done = pol == n_pols - 1;
          per_chan = chan_done ? __fsqrt_rn(clamp_min0(sq)) : 0.0f;
        }
        if (chan_done) {
          const float term = __fmul_rn(per_chan, chan_coefs[c]);
          integ = c == 0 ? term : __fadd_rn(integ, term);
        }
      }
    }
    if (kMode == kSquared) integ = __fsqrt_rn(clamp_min0(sq));
    const float weighted = weight ? __fmul_rn(integ, weight[p]) : integ;
    const float cmp = allow_negative ? fabsf(weighted) : weighted;
    // p grows within a thread, so a strict > keeps the first of equal maxima.
    if (cmp > best.cmp) best = Best{cmp, p, integ};
  }
  best = block_reduce<kStepThreads>(best);
  if (threadIdx.x == 0) {
    part_cmp[blockIdx.x] = best.cmp;
    part_idx[blockIdx.x] = best.idx;
    part_integ[blockIdx.x] = best.integ;
  }
}

// With kFacets, block f reduces facet f's partials and advances its state;
// its first threshold, initial |peak| and iteration limit come from
// facet_limits[2f], facet_limits[2f + 1] and facet_max_iterations[f].
template <bool kFacets>
__global__ void __launch_bounds__(kSelectThreads)
    hogbom_select_kernel(const float* __restrict__ part_cmp,
                         const int* __restrict__ part_idx,
                         const float* __restrict__ part_integ, int n_parts,
                         const float* __restrict__ res,
                         const float* __restrict__ rms, int n_images,
                         int height, int width, int* __restrict__ state,
                         float* __restrict__ value, float* __restrict__ peak,
                         float* __restrict__ values, float gain,
                         float first_threshold, float initial_abs_peak,
                         float divergence_limit, int max_iterations,
                         int stop_on_negative,
                         const float* __restrict__ facet_limits,
                         const int* __restrict__ facet_max_iterations) {
  if (kFacets) {
    const int f = blockIdx.x;
    const int64_t cube = static_cast<int64_t>(n_images) * height * width;
    part_cmp += f * n_parts;
    part_idx += f * n_parts;
    part_integ += f * n_parts;
    res += f * cube;
    if (rms) rms += f * static_cast<int64_t>(height) * width;
    state += f * kStateSize;
    value += f;
    peak += f * n_images;
    values += f * n_images;
  }
  if (state[kActive] == 0) return;
  if (kFacets) {
    first_threshold = facet_limits[2 * blockIdx.x];
    initial_abs_peak = facet_limits[2 * blockIdx.x + 1];
    max_iterations = facet_max_iterations[blockIdx.x];
  }
  Best best = no_peak();
  for (int i = threadIdx.x; i < n_parts; i += kSelectThreads) {
    if (better(part_cmp[i], part_idx[i], best))
      best = Best{part_cmp[i], part_idx[i], part_integ[i]};
  }
  best = block_reduce<kSelectThreads>(best);
  __shared__ int s_idx;
  if (threadIdx.x == 0) {
    const int idx = best.idx == INT_MAX ? 0 : best.idx;
    const bool found = best.cmp > FLT_MIN;
    const float v = rms ? __fmul_rn(best.integ, rms[idx]) : best.integ;
    const bool diverging =
        divergence_limit != 0.0f && found &&
        fabsf(v) > __fmul_rn(initial_abs_peak, divergence_limit);
    const int iteration = state[kIteration] + 1;
    bool active = found && fabsf(v) > first_threshold &&
                  iteration < max_iterations && !diverging;
    if (stop_on_negative) active = active && v >= 0.0f;
    state[kY] = idx / width;
    state[kX] = idx % width;
    state[kFound] = found;
    state[kDiverging] = diverging;
    state[kIteration] = iteration;
    state[kActive] = active;
    state[kIndex] = idx;
    *value = v;
    s_idx = idx;
  }
  __syncthreads();
  const int64_t plane = static_cast<int64_t>(height) * width;
  for (int n = threadIdx.x; n < n_images; n += kSelectThreads) {
    const float r = res[n * plane + s_idx];
    peak[n] = r;
    values[n] = __fmul_rn(r, gain);
  }
}

}  // namespace

extern "C" {

int hogbom_step(float* res, float* model, const float* psf,
                const float* weight, const float* coefs, const float* values,
                const int* state, float* part_cmp, int* part_idx,
                float* part_integ, int n_parts, int n_images, int n_pols,
                int height, int width, int psf_height, int row_offset,
                int pixels_per_block, int mode, int allow_negative,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool row_shard = row_offset != 0 || psf_height != height;
#define RADLER_STEP_ARGS                                                  \
  res, model, psf, weight, coefs, values, state, part_cmp, part_idx,      \
      part_integ, n_images, n_pols, height, width, psf_height,            \
      row_offset, pixels_per_block, allow_negative, 0
#define RADLER_STEP_LAUNCH(MODE)                                          \
  if (row_shard)                                                          \
    hogbom_step_kernel<MODE, true, false>                                 \
        <<<n_parts, kStepThreads, 0, s>>>(RADLER_STEP_ARGS);              \
  else                                                                    \
    hogbom_step_kernel<MODE, false, false>                                \
        <<<n_parts, kStepThreads, 0, s>>>(RADLER_STEP_ARGS)
  switch (mode) {
    case kSigned:
      RADLER_STEP_LAUNCH(kSigned);
      break;
    case kLinear:
      RADLER_STEP_LAUNCH(kLinear);
      break;
    case kNormal:
      RADLER_STEP_LAUNCH(kNormal);
      break;
    case kSquared:
      RADLER_STEP_LAUNCH(kSquared);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RADLER_STEP_LAUNCH
#undef RADLER_STEP_ARGS
  return static_cast<int>(cudaGetLastError());
}

int hogbom_select(const float* part_cmp, const int* part_idx,
                  const float* part_integ, int n_parts, const float* res,
                  const float* rms, int n_images, int height, int width,
                  int* state, float* value, float* peak, float* values,
                  float gain, float first_threshold, float initial_abs_peak,
                  float divergence_limit, int max_iterations,
                  int stop_on_negative, void* stream) {
  hogbom_select_kernel<false><<<1, kSelectThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      part_cmp, part_idx, part_integ, n_parts, res, rms, n_images, height,
      width, state, value, peak, values, gain, first_threshold,
      initial_abs_peak, divergence_limit, max_iterations, stop_on_negative,
      nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The facet-batched pair: n_facets cubes [N, H, W] one after another,
// psf_facet_stride floats between facets' PSF stacks (0: shared), partials
// [n_facets, n_parts], state [n_facets, 8], value [n_facets], peak and
// values [n_facets, N], limits [n_facets, 2] (first threshold, initial
// |peak|), max_iterations [n_facets].
int hogbom_step_facets(float* res, float* model, const float* psf,
                       long long psf_facet_stride, const float* weight,
                       const float* coefs, const float* values,
                       const int* state, float* part_cmp, int* part_idx,
                       float* part_integ, int n_parts, int n_facets,
                       int n_images, int n_pols, int height, int width,
                       int pixels_per_block, int mode, int allow_negative,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_parts, n_facets);
#define RADLER_FACET_ARGS                                                 \
  res, model, psf, weight, coefs, values, state, part_cmp, part_idx,      \
      part_integ, n_images, n_pols, height, width, height, 0,             \
      pixels_per_block, allow_negative
#define RADLER_FACET_LAUNCH(MODE)                                         \
  if (n_facets == 1)                                                      \
    hogbom_step_kernel<MODE, false, false>                                \
        <<<n_parts, kStepThreads, 0, s>>>(RADLER_FACET_ARGS, 0);          \
  else                                                                    \
    hogbom_step_kernel<MODE, false, true><<<grid, kStepThreads, 0, s>>>(  \
        RADLER_FACET_ARGS, psf_facet_stride)
  switch (mode) {
    case kSigned:
      RADLER_FACET_LAUNCH(kSigned);
      break;
    case kLinear:
      RADLER_FACET_LAUNCH(kLinear);
      break;
    case kNormal:
      RADLER_FACET_LAUNCH(kNormal);
      break;
    case kSquared:
      RADLER_FACET_LAUNCH(kSquared);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RADLER_FACET_LAUNCH
#undef RADLER_FACET_ARGS
  return static_cast<int>(cudaGetLastError());
}

int hogbom_select_facets(const float* part_cmp, const int* part_idx,
                         const float* part_integ, int n_parts, int n_facets,
                         const float* res, const float* rms, int n_images,
                         int height, int width, int* state, float* value,
                         float* peak, float* values, const float* limits,
                         const int* max_iterations, float gain,
                         float divergence_limit, int stop_on_negative,
                         void* stream) {
  hogbom_select_kernel<true><<<n_facets, kSelectThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      part_cmp, part_idx, part_integ, n_parts, res, rms, n_images, height,
      width, state, value, peak, values, gain, 0.0f, 0.0f, divergence_limit,
      0, stop_on_negative, limits, max_iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
