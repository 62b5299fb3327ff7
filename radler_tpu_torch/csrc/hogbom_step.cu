// One Högbom CLEAN minor iteration for Hopper (sm_90a), in one launch.
//
// Replaces radler_tpu/ops/pallas/hogbom_step.py::_step_kernel (reached
// through fused_clean_step and the device loop hogbom_loop_pallas).
//
// What it computes, per iteration, with the peak (y, x) and the component
// values read from a small device state buffer:
//   the step      model[n, y, x] += values[n]; then for every pixel p:
//                 res[n, p] -= values[n] * psf[n / P] shifted to (y, x)
//                 (zero outside the PSF, the clipping of
//                 simple_clean.cc:61-96), the joined integration of the N
//                 new values in one of four modes, times the peak-search
//                 weight, abs() when negatives are allowed.  Each block
//                 reduces its pixels to one partial (max, smallest flat
//                 index, signed integrated value).
//   the select    the last block to finish reduces the partials with the
//                 same tie-break (the smallest flat index among equal
//                 maxima, as the TPU kernel's block-ordered running max
//                 gives), then runs the loop body's epilogue: the signed,
//                 rms-weighted value at the new peak, found = cmp > FLT_MIN,
//                 the divergence test, the stop test of the loop condition,
//                 and the next iteration's gain-scaled component values.
//
// What bounds it: device-memory bytes.  One iteration reads the residual
// and the shifted PSF and writes the residual back, about 3 * N * H * W * 4
// bytes, plus H * W * 4 bytes when a weight plane is read; at 4096^2 with
// N = 1 that is 201 MB, or 60 us at the H100's 3.35 TB/s.  Arithmetic is a
// few flops per byte.  The design streams each plane once, in contiguous
// runs of flat pixels per block so that neighbouring threads touch
// neighbouring addresses in the residual, the PSF and the weight, and keeps
// the integration in registers.  TPU-only machinery (the padded PSF canvas,
// tile-aligned over-fetch, DMA double buffer and rotate) is not carried:
// the PSF is read un-padded with a bounds check.
//
// The cross-block argmax: the TPU kernel carries a running max across its
// sequential grid steps; here blocks run in no order, so each block writes
// its partial, fences and takes a ticket from a counter in device memory
// (one int a loop, or a facet), and the block that takes the last ticket
// reads every partial and runs the select, then sets the counter back to
// 0 for the next launch.  Its work is a few thousand partials (49 KB at
// 4096^2) and N residual values, read through L2 (ld.global.cg): L1 is not
// coherent across multiprocessors.  Every block reads the state and the
// component values before its ticket and the last block writes them after
// every ticket, so no block sees the next iteration's; a step that selects
// does not read them through the read-only (non-coherent) path, so it reads
// signed mode's one component value once, before its pixels (the compiler
// reloads a plain pointer after every residual store).  The select's code
// is a function of its own (noinline), out of the pixel loop's registers,
// and the selecting kernel is held to 8 blocks a multiprocessor (32
// registers), as many as the step alone reaches in signed mode.  A launch
// whose state is inactive returns in every block and leaves the counter
// at 0.
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
// A shard's step writes its partials and does not select: the mesh loop
// combines the shards' partials itself.
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
// its P planes.  Addresses and partial indices stay flat indices in the
// common box, which row-major order in a box keeps monotone, so the select, the
// state and the partials' tie-break are unchanged; a facet's partials past
// its own box's blocks hold no peak.  Each facet has its own counter, and
// the last of its blocks to finish runs its select with its own limits; a
// stopped facet's blocks read its state and return.  One facet whose box
// is the whole common box launches the single-cube step itself, with the
// facet's limits.  What bounds the facet step is device-memory bytes too,
// those of the true boxes: each facet's N residual planes read and
// written, its weight plane read, and the PSF pixels that the windows
// shifted to the facets' peaks reach, each read once.
//
// Loop control stays on the device: the kernels return at once when the
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

// What a step that selects writes besides its state and component values,
// and the loop's scalars.  counters: one int a launch (facets: one a
// facet), 0 before and after every launch.  rms ([H, W], facets [F, H, W])
// may be null.  value [1] / [F], peak [N] / [F, N].  facet_limits ([F, 2]:
// first threshold, initial |peak|) and facet_max_iterations ([F]), when
// set, replace first_threshold, initial_abs_peak and max_iterations.
struct Select {
  int* counters;
  const float* rms;
  float* value;
  float* peak;
  const float* facet_limits;
  const int* facet_max_iterations;
  float gain;
  float first_threshold;
  float initial_abs_peak;
  float divergence_limit;
  int max_iterations;
  int stop_on_negative;
};

// Loads through L2 (ld.global.cg) of what another block of this launch
// wrote: L1 is not coherent across multiprocessors.  Volatile with a memory
// clobber, so the compiler keeps them after the fence that orders them.
__device__ __forceinline__ float load_l2(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ int load_l2(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Called by every thread of a block after block_reduce and after thread 0
// has written the block's partial: true in the last of n_blocks blocks to
// take a ticket from *counter, which that block sets back to 0.  The fence
// before the ticket orders the block's stores (the residual, the model and
// the partial; block_reduce's barrier puts the other threads' stores before
// thread 0's fence) before it; the fence after the last ticket orders the
// last block's later loads after every block's stores.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n_blocks) {
  __shared__ int s_last;
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == n_blocks - 1;
    if (last) {
      __threadfence();
      *counter = 0;
    }
    s_last = last;
  }
  __syncthreads();
  return s_last != 0;
}

// The select, run by every thread of the last block: the n_runs partials
// reduce to the new peak with better() (a total order on (cmp, idx) that
// never takes a NaN, so the order of the reduction cannot change the
// winner), then the loop body's epilogue writes state, *value, peak[n]
// and values[n], operation for operation as the plain version
// (hogbom_select_reference).  rms, value and peak are this cube's.
__device__ __noinline__ void select_peak(
    const float* part_cmp, const int* part_idx, const float* part_integ,
    int n_runs, const float* res, int n_images, int64_t plane, int width,
    int* state, float* values, const float* rms, float* value, float* peak,
    float gain, float first_threshold, float initial_abs_peak,
    float divergence_limit, int max_iterations, int stop_on_negative) {
  Best best = no_peak();
#pragma unroll 4
  for (int i = threadIdx.x; i < n_runs; i += kStepThreads) {
    const float cmp = load_l2(part_cmp + i);
    const int idx = load_l2(part_idx + i);
    const float integ = load_l2(part_integ + i);
    if (better(cmp, idx, best)) best = Best{cmp, idx, integ};
  }
  best = block_reduce<kStepThreads>(best);
  __shared__ int s_idx;
  if (threadIdx.x == 0) s_idx = best.idx == INT_MAX ? 0 : best.idx;
  __syncthreads();
  const int idx = s_idx;
  if (threadIdx.x == 0) {
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
  }
  // The other warps read the residual at the peak meanwhile.
  if (threadIdx.x >= 32) {
    for (int n = threadIdx.x - 32; n < n_images; n += kStepThreads - 32) {
      const float r = load_l2(res + n * plane + idx);
      peak[n] = r;
      values[n] = __fmul_rn(r, gain);
    }
  }
}

// How a step reads the component values and the state: read-only (and
// not aliased) when it only writes partials; plain pointers when its last
// block writes both.
template <bool kSelect>
struct StepIo {
  using Values = const float* __restrict__;
  using State = const int* __restrict__;
};
template <>
struct StepIo<true> {
  using Values = float*;
  using State = int*;
};

// coefs: [N] per-plane coefficients (signed: the single coefficient; linear:
// one per plane; normal: the polarization coefficient of the plane; squared:
// channel x polarization coefficient), then [C] channel coefficients
// (normal mode only).
// With kSelect the last block to finish runs the select (sel).
template <int kMode, bool kRowShard, bool kSelect>
__device__ __forceinline__ void step_body(
    float* __restrict__ res, float* __restrict__ model,
    const float* __restrict__ psf, const float* __restrict__ weight,
    const float* __restrict__ coefs, typename StepIo<kSelect>::Values values,
    typename StepIo<kSelect>::State state, float* __restrict__ part_cmp,
    int* __restrict__ part_idx, float* __restrict__ part_integ, int n_images,
    int n_pols, int height, int width, int shard_psf_height,
    int shard_row_offset, int pixels_per_block, int allow_negative,
    const Select& sel) {
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
  // A step that selects reads values through a plain pointer, which the
  // compiler reloads after every residual store; signed mode's one value is
  // read once.
  const float value0 = kSelect && kMode == kSigned ? values[0] : 0.0f;
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
      const float value = kSelect && kMode == kSigned
                              ? value0
                              : static_cast<float>(values[n]);
      const float v = __fsub_rn(*r, __fmul_rn(value, shifted));
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
  if constexpr (kSelect) {
    if (!last_to_arrive(sel.counters, gridDim.x)) return;
    const bool limits = sel.facet_limits != nullptr;
    select_peak(part_cmp, part_idx, part_integ, gridDim.x, res, n_images,
                plane, width, state, values, sel.rms, sel.value, sel.peak,
                sel.gain,
                limits ? sel.facet_limits[0] : sel.first_threshold,
                limits ? sel.facet_limits[1] : sel.initial_abs_peak,
                sel.divergence_limit,
                limits ? sel.facet_max_iterations[0] : sel.max_iterations,
                sel.stop_on_negative);
  }
}

// The step that writes its partials only (row shards, and the step timed
// alone).
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
  step_body<kMode, kRowShard, false>(
      res, model, psf, weight, coefs, values, state, part_cmp, part_idx,
      part_integ, n_images, n_pols, height, width, shard_psf_height,
      shard_row_offset, pixels_per_block, allow_negative, Select{});
}

// The step with its select, held to 8 blocks a multiprocessor (2048
// threads, 32 registers each): linear, squared and normal mode ran faster
// so than at the registers the compiler picks for them (PERF.md, the
// kernel table); signed mode gets 32 either way.
template <int kMode>
__global__ void __launch_bounds__(kStepThreads, 8)
    hogbom_select_step_kernel(float* __restrict__ res,
                              float* __restrict__ model,
                              const float* __restrict__ psf,
                              const float* __restrict__ weight,
                              const float* __restrict__ coefs, float* values,
                              int* state, float* __restrict__ part_cmp,
                              int* __restrict__ part_idx,
                              float* __restrict__ part_integ, int n_images,
                              int n_pols, int height, int width,
                              int pixels_per_block, int allow_negative,
                              const Select sel) {
  step_body<kMode, false, true>(res, model, psf, weight, coefs, values, state,
                                part_cmp, part_idx, part_integ, n_images,
                                n_pols, height, width, height, 0,
                                pixels_per_block, allow_negative, sel);
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
// facet's partials past its own runs as no peak.  The last of a facet's
// runs to finish runs the facet's select (sel, with its counter and
// limits).
template <int kMode>
__global__ void __launch_bounds__(kStepThreads)
    hogbom_facet_step_kernel(float* __restrict__ res,
                             float* __restrict__ model,
                             const float* __restrict__ psf,
                             const float* __restrict__ weight,
                             const float* __restrict__ coefs, float* values,
                             int* state, float* __restrict__ part_cmp,
                             int* __restrict__ part_idx,
                             float* __restrict__ part_integ, int n_parts,
                             int n_facets, int n_images, int n_pols,
                             int height, int width, int pixels_per_block,
                             int allow_negative, int64_t psf_facet_stride,
                             const Select sel,
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
  if (!last_to_arrive(sel.counters + f, n_runs)) return;
  select_peak(part_cmp, part_idx, part_integ, n_runs, res, n_images, plane,
              width, state, values, sel.rms ? sel.rms + f * plane : nullptr,
              sel.value + f, sel.peak + f * n_images, sel.gain,
              sel.facet_limits[2 * f], sel.facet_limits[2 * f + 1],
              sel.divergence_limit, sel.facet_max_iterations[f],
              sel.stop_on_negative);
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

}  // namespace

extern "C" {

// The single-cube step: partials [n_parts].  With a counter it selects
// too (counter [1], 0 on entry; rms [H, W] or null, value [1], peak and
// values [N]; facet_limits [2] and facet_max_iterations [1], when set,
// replace first_threshold, initial_abs_peak and max_iterations); without
// one it writes its partials only.  A row shard (row_offset != 0 or
// psf_height != height) does not select.
int hogbom_step(float* res, float* model, const float* psf,
                const float* weight, const float* coefs, float* values,
                int* state, float* part_cmp, int* part_idx, float* part_integ,
                int n_parts, int n_images, int n_pols, int height, int width,
                int psf_height, int row_offset, int pixels_per_block,
                int mode, int allow_negative, int* counter, const float* rms,
                float* value, float* peak, float gain, float first_threshold,
                float initial_abs_peak, float divergence_limit,
                int max_iterations, int stop_on_negative,
                const float* facet_limits, const int* facet_max_iterations,
                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool row_shard = row_offset != 0 || psf_height != height;
  if (row_shard && counter) return static_cast<int>(cudaErrorInvalidValue);
  const Select sel{counter,          rms,
                   value,            peak,
                   facet_limits,     facet_max_iterations,
                   gain,             first_threshold,
                   initial_abs_peak, divergence_limit,
                   max_iterations,   stop_on_negative};
#define RADLER_STEP_ARGS                                                  \
  res, model, psf, weight, coefs, values, state, part_cmp, part_idx,      \
      part_integ, n_images, n_pols, height, width
#define RADLER_STEP_LAUNCH(MODE)                                          \
  if (row_shard)                                                          \
    hogbom_step_kernel<MODE, true><<<n_parts, kStepThreads, 0, s>>>(      \
        RADLER_STEP_ARGS, psf_height, row_offset, pixels_per_block,       \
        allow_negative);                                                  \
  else if (counter)                                                       \
    hogbom_select_step_kernel<MODE><<<n_parts, kStepThreads, 0, s>>>(     \
        RADLER_STEP_ARGS, pixels_per_block, allow_negative, sel);         \
  else                                                                    \
    hogbom_step_kernel<MODE, false><<<n_parts, kStepThreads, 0, s>>>(     \
        RADLER_STEP_ARGS, psf_height, row_offset, pixels_per_block,       \
        allow_negative)
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

// The facet-batched step, which always selects: n_facets cubes [N, H, W]
// one after another, psf_facet_stride floats between facets' PSF stacks
// (0: shared), boxes [n_facets, 2] on the host (each facet's true box,
// rows and columns, at the top left), partials [n_facets, n_parts], state
// [n_facets, 8], counters [n_facets] (0 on entry), rms [n_facets, H, W] or
// null, value [n_facets], peak and values [n_facets, N], limits
// [n_facets, 2] (first threshold, initial |peak|), max_iterations
// [n_facets].  The step launches once for every kMaxFacets facets.
int hogbom_step_facets(float* res, float* model, const float* psf,
                       long long psf_facet_stride, const float* weight,
                       const float* coefs, float* values, int* state,
                       float* part_cmp, int* part_idx, float* part_integ,
                       const int* boxes, int n_parts, int n_facets,
                       int n_images, int n_pols, int height, int width,
                       int pixels_per_block, int mode, int allow_negative,
                       int* counters, const float* rms, float* value,
                       float* peak, const float* limits,
                       const int* max_iterations, float gain,
                       float divergence_limit, int stop_on_negative,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_facets == 1 && boxes[0] == height && boxes[1] == width) {
    return hogbom_step(res, model, psf, weight, coefs, values, state,
                       part_cmp, part_idx, part_integ, n_parts, n_images,
                       n_pols, height, width, height, 0, pixels_per_block,
                       mode, allow_negative, counters, rms, value, peak, gain,
                       0.0f, 0.0f, divergence_limit, 0, stop_on_negative,
                       limits, max_iterations, stream);
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
    const Select sel{counters + at,
                     rms ? rms + at * plane : nullptr,
                     value + at,
                     peak + at * n_images,
                     limits + 2 * at,
                     max_iterations + at,
                     gain,
                     0.0f,
                     0.0f,
                     divergence_limit,
                     0,
                     stop_on_negative};
#define RADLER_FACET_ARGS                                                 \
  res + at * n_images * plane, model + at * n_images * plane,             \
      psf + at * psf_facet_stride, weight ? weight + at * plane : nullptr, \
      coefs, values + at * n_images, state + at * kStateSize,             \
      part_cmp + at * n_parts, part_idx + at * n_parts,                   \
      part_integ + at * n_parts, n_parts, count, n_images, n_pols,        \
      height, width, pixels_per_block, allow_negative, psf_facet_stride,  \
      sel, table
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

}  // extern "C"
