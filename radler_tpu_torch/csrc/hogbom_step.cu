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
// after another in memory (the PSFs shared or one stack a facet), each
// facet's true box at the top left of the common box.  Its step is a kernel
// of its own, hogbom_facet_step_kernel: the grid covers only the true boxes
// (a block is a run of pixels_per_block pixels of one facet's box in
// row-major order, so padding pixels are neither read nor written).  Its
// threads stage their own next pixels' residual, PSF and weight values in
// shared memory with cp.async, three tasks (a pixel and up to 8 of its
// planes) ahead of the one they compute, which keeps more bytes in flight
// than registers could hold, and a channel's PSF value is copied once for
// its P planes.  Addresses and partial indices stay flat indices in the common
// box, which row-major order in a box keeps monotone, so the select, the
// state and the partials' tie-break are unchanged; a facet's partials past
// its own box's blocks hold no peak.  The select runs one block a facet; a
// stopped facet's blocks read its state and return.  One facet whose box
// is the whole common box launches the single-cube step itself.  What
// bounds the facet step is device-memory bytes too, those of the true
// boxes: each facet's N residual planes read and written, its weight plane
// read, and the PSF pixels that the windows shifted to the facets' peaks
// reach, each read once.
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
template <int kMode, bool kRowShard>
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
                       int pixels_per_block, int allow_negative) {
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

// The facets of one facet-step launch: where each facet's blocks start in
// the grid (a prefix sum of their counts) and each facet's true box (rows,
// columns).  Passed by value, so a launch takes at most kMaxFacets facets;
// the entry point launches larger grids of facets in turns.
constexpr int kMaxFacets = 256;
struct FacetBoxes {
  int block_start[kMaxFacets + 1];
  int rows[kMaxFacets];
  int cols[kMaxFacets];
};

// The facet that owns grid block `block`: the last f with
// block_start[f] <= block.
__device__ __forceinline__ int facet_of(const FacetBoxes& boxes, int n_facets,
                                        int block) {
  int lo = 0;
  int hi = n_facets - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (boxes.block_start[mid] <= block) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The facet step's planes go in chunks of kChunk; a thread's copies run
// kFacetStages - 1 tasks ahead of the task it computes.
constexpr int kChunk = 8;
constexpr int kFacetStages = 4;
constexpr int kSlots = 2 * kChunk + 1;  // residuals, PSF values, weight
constexpr int kFacetSmem =
    kFacetStages * kSlots * kStepThreads * static_cast<int>(sizeof(float));

// An asynchronous 4-byte copy from global to shared memory: `bytes` is 4,
// or 0 to write a zero without reading.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int bytes) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Bits k of *first, *last: plane chunk * kChunk + k (below n_images) starts,
// ends its channel.
__device__ __forceinline__ void chunk_pols(int chunk, int n_images,
                                           int n_pols, unsigned* first,
                                           unsigned* last) {
  *first = *last = 0;
  const int n0 = chunk * kChunk;
  int pol = n0 % n_pols;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (n0 + k < n_images) {
      if (pol == 0) *first |= 1u << k;
      if (pol == n_pols - 1) *last |= 1u << k;
    }
    pol = pol == n_pols - 1 ? 0 : pol + 1;
  }
}

// B1's step for F facets over their true boxes.  Block b is run
// b - block_start[f] of facet f: pixels_per_block consecutive pixels of the
// box in row-major order, read at their common-box flat index
// row * width + col; thread t takes the run's pixels t, t + kStepThreads,
// ..., moving its row and column by a fixed step (no division per pixel).
// A pixel's planes go in chunks of kChunk, and each (pixel, chunk) is a
// task.  A thread copies a task's residual values, the PSF value of each
// channel that starts in the chunk and (in the first chunk) the weight
// into its own slots of shared memory with cp.async, kFacetStages - 1
// tasks ahead of the task it computes, so that many copies are in flight
// without holding registers; it reads back only its own slots, so no
// barrier is needed.  It then subtracts, stores the residual and
// integrates with the single-cube step's arithmetic, operation for
// operation and in its order.  Every pointer but coefs advances by the
// block's facet (psf by psf_facet_stride floats, 0 for shared PSFs);
// partials are [F, n_parts], and the last run of each facet marks the
// facet's partials past its own runs as no peak.
template <int kMode>
__global__ void __launch_bounds__(kStepThreads)
    hogbom_facet_step_kernel(float* __restrict__ res,
                             float* __restrict__ model,
                             const float* __restrict__ psf,
                             const float* __restrict__ weight,
                             const float* __restrict__ coefs,
                             const float* __restrict__ values,
                             const int* __restrict__ state,
                             float* __restrict__ part_cmp,
                             int* __restrict__ part_idx,
                             float* __restrict__ part_integ, int n_parts,
                             int n_facets, int n_images, int n_pols,
                             int height, int width, int pixels_per_block,
                             int allow_negative, int64_t psf_facet_stride,
                             const __grid_constant__ FacetBoxes boxes) {
  extern __shared__ float staged[];  // [kFacetStages][kSlots][kStepThreads]
  const int f = facet_of(boxes, n_facets, blockIdx.x);
  const int run = blockIdx.x - boxes.block_start[f];
  const int64_t plane = static_cast<int64_t>(height) * width;
  res += f * n_images * plane;
  model += f * n_images * plane;
  psf += f * psf_facet_stride;
  if (weight) weight += f * plane;
  values += f * n_images;
  state += f * kStateSize;
  part_cmp += static_cast<int64_t>(f) * n_parts;
  part_idx += static_cast<int64_t>(f) * n_parts;
  part_integ += static_cast<int64_t>(f) * n_parts;
  if (state[kActive] == 0) return;
  const int y = state[kY];
  const int x = state[kX];

  if (run == 0) {
    for (int n = threadIdx.x; n < n_images; n += blockDim.x) {
      float* m = model + n * plane + static_cast<int64_t>(y) * width + x;
      *m = __fadd_rn(*m, values[n]);
    }
  }
  const int n_runs = boxes.block_start[f + 1] - boxes.block_start[f];
  if (run == n_runs - 1) {
    for (int i = n_runs + threadIdx.x; i < n_parts; i += kStepThreads) {
      part_cmp[i] = -INFINITY;
      part_idx[i] = INT_MAX;
      part_integ[i] = 0.0f;
    }
  }

  // The computing side's chunk: each plane's coefficient, component value
  // and channel coefficient (normal mode), and which planes start and end
  // their channel; loaded once when the planes fit one chunk.
  const int n_chunks = (n_images + kChunk - 1) / kChunk;
  const bool one_chunk = n_chunks == 1;
  float plane_coef[kChunk];
  float plane_value[kChunk];
  float chan_coef[kChunk];
  unsigned first_pol = 0;
  unsigned last_pol = 0;
  const float* chan_coefs = coefs + n_images;
  const auto load_chunk = [&](int chunk) {
    chunk_pols(chunk, n_images, n_pols, &first_pol, &last_pol);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int n = min(chunk * kChunk + k, n_images - 1);
      plane_coef[k] = coefs[n];
      plane_value[k] = values[n];
      chan_coef[k] = kMode == kNormal ? chan_coefs[n / n_pols] : 0.0f;
    }
  };
  load_chunk(0);

  const int oy = height / 2 - y;
  const int ox = width / 2 - x;
  const int cols = boxes.cols[f];
  const int begin = run * pixels_per_block;
  const int end = min(begin + pixels_per_block, boxes.rows[f] * cols);
  const int step_rows = kStepThreads / cols;
  const int step_cols = kStepThreads - step_rows * cols;
  const int n_tasks =
      (end - begin + kStepThreads - 1) / kStepThreads * n_chunks;
  float* const mine = staged + threadIdx.x;

  // The copying side: its task's pixel (in_q, in_row, in_col), chunk and
  // stage.
  int in_q = begin + threadIdx.x;
  int in_row = in_q / cols;
  int in_col = in_q - in_row * cols;
  int in_chunk = 0;
  int in_stage = 0;
  const auto copy_task = [&]() {
    float* slot = mine + in_stage * kSlots * kStepThreads;
    const bool valid = in_q < end;
    const int p = in_row * width + in_col;
    const int sy = in_row + oy;
    const int sx = in_col + ox;
    const bool inside =
        valid && static_cast<unsigned>(sy) < static_cast<unsigned>(height) &&
        static_cast<unsigned>(sx) < static_cast<unsigned>(width);
    const int src = sy * width + sx;
    unsigned first = first_pol;
    unsigned last = 0;
    if (!one_chunk) chunk_pols(in_chunk, n_images, n_pols, &first, &last);
    const int n0 = in_chunk * kChunk;
    int chan = n0 / n_pols;  // the channel of plane n0, then of plane n0 + k
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (n0 + k < n_images) {
        copy_async(slot + k * kStepThreads,
                   valid ? res + (n0 + k) * plane + p : res, valid ? 4 : 0);
      }
      if (first & (1u << k)) {
        if (k > 0) ++chan;
        copy_async(slot + (kChunk + k) * kStepThreads,
                   inside ? psf + chan * plane + src : psf, inside ? 4 : 0);
      }
    }
    if (weight && in_chunk == 0) {
      copy_async(slot + 2 * kChunk * kStepThreads, valid ? weight + p : weight,
                 valid ? 4 : 0);
    }
    if (++in_chunk == n_chunks) {
      in_chunk = 0;
      in_q += kStepThreads;
      in_col += step_cols;
      in_row += step_rows;
      if (in_col >= cols) {
        in_col -= cols;
        ++in_row;
      }
    }
    if (++in_stage == kFacetStages) in_stage = 0;
  };

  // The computing side: its task's pixel (q, row, col), chunk and stage.
  int q = begin + threadIdx.x;
  int row = q / cols;
  int col = q - row * cols;
  int chunk = 0;
  int stage = 0;
  float integ = 0.0f;
  float sq = 0.0f;
  float shifted = 0.0f;
  float w = 1.0f;
  Best best = no_peak();
  for (int task = 0; task < kFacetStages - 1; ++task) {
    if (task < n_tasks) copy_task();
    copy_commit();
  }
  for (int task = 0; task < n_tasks; ++task) {
    if (task + kFacetStages - 1 < n_tasks) copy_task();
    copy_commit();
    copy_wait<kFacetStages - 1>();
    const float* slot = mine + stage * kSlots * kStepThreads;
    const bool valid = q < end;
    const int p = row * width + col;
    if (!one_chunk) load_chunk(chunk);
    const int n0 = chunk * kChunk;
    if (chunk == 0 && weight) w = slot[2 * kChunk * kStepThreads];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int n = n0 + k;
      if (n >= n_images) break;
      if (first_pol & (1u << k)) shifted = slot[(kChunk + k) * kStepThreads];
      const float v = __fsub_rn(slot[k * kStepThreads],
                                __fmul_rn(plane_value[k], shifted));
      if (valid) res[n * plane + p] = v;
      if (kMode == kSigned) {
        integ = __fmul_rn(v, plane_coef[0]);
      } else if (kMode == kLinear) {
        const float term = __fmul_rn(v, plane_coef[k]);
        integ = n == 0 ? term : __fadd_rn(integ, term);
      } else if (kMode == kSquared) {
        const float term = __fmul_rn(__fmul_rn(v, v), plane_coef[k]);
        sq = n == 0 ? term : __fadd_rn(sq, term);
      } else {  // normal
        float per_chan;
        bool chan_done;
        if (n_pols == 1) {
          per_chan = v;
          chan_done = true;
        } else {
          const float term = __fmul_rn(__fmul_rn(v, v), plane_coef[k]);
          sq = (first_pol & (1u << k)) ? term : __fadd_rn(sq, term);
          chan_done = (last_pol & (1u << k)) != 0;
          per_chan = chan_done ? __fsqrt_rn(clamp_min0(sq)) : 0.0f;
        }
        if (chan_done) {
          const float term = __fmul_rn(per_chan, chan_coef[k]);
          integ = n == n_pols - 1 ? term : __fadd_rn(integ, term);
        }
      }
    }
    if (++stage == kFacetStages) stage = 0;
    if (++chunk < n_chunks) continue;
    chunk = 0;
    if (valid) {
      if (kMode == kSquared) integ = __fsqrt_rn(clamp_min0(sq));
      const float weighted = weight ? __fmul_rn(integ, w) : integ;
      const float cmp = allow_negative ? fabsf(weighted) : weighted;
      // p grows within a thread, so a strict > keeps the first of equal
      // maxima.
      if (cmp > best.cmp) best = Best{cmp, p, integ};
    }
    q += kStepThreads;
    col += step_cols;
    row += step_rows;
    if (col >= cols) {
      col -= cols;
      ++row;
    }
  }
  copy_wait<0>();
  best = block_reduce<kStepThreads>(best);
  if (threadIdx.x == 0) {
    part_cmp[run] = best.cmp;
    part_idx[run] = best.idx;
    part_integ[run] = best.integ;
  }
}

// Launches the facet step with its shared memory, more than the 48 KB a
// block gets by default, and the carveout that fits three blocks a
// multiprocessor.
template <int kMode, typename... Args>
cudaError_t launch_facet_step(int n_blocks, cudaStream_t s, Args... args) {
  const auto kernel = hogbom_facet_step_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFacetSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks, kStepThreads, kFacetSmem, s>>>(args...);
  return cudaGetLastError();
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
      row_offset, pixels_per_block, allow_negative
#define RADLER_STEP_LAUNCH(MODE)                                          \
  if (row_shard)                                                          \
    hogbom_step_kernel<MODE, true>                                        \
        <<<n_parts, kStepThreads, 0, s>>>(RADLER_STEP_ARGS);              \
  else                                                                    \
    hogbom_step_kernel<MODE, false>                                       \
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
// psf_facet_stride floats between facets' PSF stacks (0: shared), boxes
// [n_facets, 2] on the host (each facet's true box, rows and columns, at
// the top left), partials [n_facets, n_parts], state [n_facets, 8], value
// [n_facets], peak and values [n_facets, N], limits [n_facets, 2] (first
// threshold, initial |peak|), max_iterations [n_facets].  The step launches
// once for every kMaxFacets facets.
int hogbom_step_facets(float* res, float* model, const float* psf,
                       long long psf_facet_stride, const float* weight,
                       const float* coefs, const float* values,
                       const int* state, float* part_cmp, int* part_idx,
                       float* part_integ, const int* boxes, int n_parts,
                       int n_facets, int n_images, int n_pols, int height,
                       int width, int pixels_per_block, int mode,
                       int allow_negative, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_facets == 1 && boxes[0] == height && boxes[1] == width) {
    return hogbom_step(res, model, psf, weight, coefs, values, state,
                       part_cmp, part_idx, part_integ, n_parts, n_images,
                       n_pols, height, width, height, 0, pixels_per_block,
                       mode, allow_negative, stream);
  }
  const int64_t plane = static_cast<int64_t>(height) * width;
  for (int f0 = 0; f0 < n_facets; f0 += kMaxFacets) {
    const int count = n_facets - f0 < kMaxFacets ? n_facets - f0 : kMaxFacets;
    FacetBoxes table;
    table.block_start[0] = 0;
    for (int i = 0; i < count; ++i) {
      const int rows = boxes[2 * (f0 + i)];
      const int cols = boxes[2 * (f0 + i) + 1];
      table.rows[i] = rows;
      table.cols[i] = cols;
      table.block_start[i + 1] =
          table.block_start[i] +
          (rows * cols + pixels_per_block - 1) / pixels_per_block;
    }
    const int n_blocks = table.block_start[count];
    const int64_t at = static_cast<int64_t>(f0);
#define RADLER_FACET_ARGS                                                 \
  res + at * n_images * plane, model + at * n_images * plane,             \
      psf + at * psf_facet_stride, weight ? weight + at * plane : nullptr, \
      coefs, values + at * n_images, state + at * kStateSize,             \
      part_cmp + at * n_parts, part_idx + at * n_parts,                   \
      part_integ + at * n_parts, n_parts, count, n_images, n_pols,        \
      height, width, pixels_per_block, allow_negative, psf_facet_stride,  \
      table
    cudaError_t err;
    switch (mode) {
      case kSigned:
        err = launch_facet_step<kSigned>(n_blocks, s, RADLER_FACET_ARGS);
        break;
      case kLinear:
        err = launch_facet_step<kLinear>(n_blocks, s, RADLER_FACET_ARGS);
        break;
      case kNormal:
        err = launch_facet_step<kNormal>(n_blocks, s, RADLER_FACET_ARGS);
        break;
      case kSquared:
        err = launch_facet_step<kSquared>(n_blocks, s, RADLER_FACET_ARGS);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
#undef RADLER_FACET_ARGS
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
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
