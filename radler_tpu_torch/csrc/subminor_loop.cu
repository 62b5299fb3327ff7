// The Clark subminor loop for Hopper (sm_90a), in one launch of one
// thread-block cluster.
//
// Replaces radler_tpu/ops/pallas/subminor_fused.py::_loop_kernel (reached
// through subminor_loop_fused): the whole SubMinorLoop::Run while-loop
// (subminor_loop.cc:38-117) over a fixed set of K candidate pixels.
//
// State: residual and model values of the N planes at the K candidates,
// [N, K] each, updated in place.  Per iteration:
//   1. s[j] = sum_i res[i, j] * coef[i], in plane order; times rms[j] when
//      an rms factor is given (subminor_loop.cc:13-36).
//   2. cmp[j] = |s[j]| when negatives are allowed, else s[j].  The argmax m
//      takes the smallest j among equal maxima, as the TPU kernel's
//      min-index reduce and jnp.argmax do.  Every candidate is valid: K is
//      the exact count, where the TPU kernel masked padding entries.
//   3. The stop tests of the loop condition: |s[m]| > threshold, iteration <
//      max_iterations, not diverging, and s[m] >= 0 when stopping on
//      negative components.
//   4. The component values cv[i] = res[i, m] * gain, then the optional
//      polynomial spectral fit: a constant [C, C] projection applied per
//      polarization, summed in channel order (subminor_fused.py:169-182).
//   5. model[i, m] += cv[i].
//   6. res[i, j] -= psf[i / P, ys[j] - ys[m] + H/2, xs[j] - xs[m] + W/2] *
//      cv[i] for every j; the PSF value is 0 outside the PSF
//      (subminor_loop.cc:91-105).
//   7. The next argmax (steps 1-2, fused into the pass of step 6), then the
//      divergence test |s[m]| > |s[m0]| * divergence_limit.
// The result (iteration, diverging, the last s[m] as its bits) goes to a
// small device buffer that the host reads once per run.
//
// The TPU kernel read one row of a prebuilt [C, K, K] interaction matrix
// per iteration, because it could not gather inside the kernel.  Here the
// PSF is read directly at image size: its [C, H, W] float32 planes (16.8 MB
// at 2048^2) stay in the 50 MB L2, so there is no O(K^2) table to build and
// no memory budget that bounds K.
//
// Design.  The launch is one cluster of R blocks (R a power of two up to
// 16, chosen by kernels/subminor_loop.py::cluster_plan from N and K: one
// block for few candidates, 16 otherwise; 16 is a non-portable cluster
// size, which the entry point allows explicitly) of up to 1024 threads each
// (the plan gives a thread two or three candidates: fewer warps make the
// block's barrier and reduction cheaper, more hide the gathers' latency).
// Block r owns the contiguous candidates [r * slice, (r + 1) * slice).
// R = 1 is the same kernel: the cluster barrier of one block is a block
// barrier (cluster_barrier).
//
//   * The slice's state (res[:, slice], xs, ys, rms: 4 N + 12 bytes per
//     candidate) is loaded into dynamic shared memory once, before the first
//     iteration, and the residual is written back once after the last
//     (kOnChip).  Capacity rule: 12 N bytes of per-plane scalars plus
//     slice * (4 N + 12) bytes must fit beside the static shared memory in
//     the 232,448 bytes a block may hold; cluster_plan reserves 4096 bytes
//     for the static part.  Where N * K does not fit at R = 16, the same
//     kernel keeps the state in global memory (L2), still spread over the
//     cluster (kOnChip false), so every (N, K) is taken.
//   * The pass over the candidates (steps 6, 1, 2) gives thread t the
//     candidates t, t + threads, ...; four of them are in flight together, so
//     a thread's PSF gathers from L2 overlap, and neighbouring threads
//     gather neighbouring PSF pixels where candidates are neighbours.
//   * The block reduces its argmax with the warp-wide integer reductions
//     (warp_best: the largest ordered bits of cmp, then the smallest index)
//     and one round through shared memory; warp 0 then writes the block's
//     best (cmp, idx, val)
//     into slot [parity][r] of EVERY block's shared memory through
//     distributed shared memory.  After cluster.sync() every block holds
//     the same R slots, reduces them to the same winner and makes the same
//     stop decision, so no decision is ever broadcast.
//   * Small N (kShipRaw, N <= 8): the slot also carries the position of the
//     block's best and its N raw residual values.  Every warp of every block
//     then reduces the slots and computes cv itself (the same operations on
//     the same values, so the same bits), and the block that owns the
//     winner adds cv to the model.  One cluster barrier and one block
//     barrier per iteration.
//   * Any N (kShipRaw false): warp 0 of the block that owns the winner
//     computes cv (gain, then the projection), adds it to the model and
//     writes cv and the winner's position into every block's shared memory;
//     a second cluster.sync() publishes them.
//
// Why the slots have no write-after-read hazard: the slot written in
// iteration t (before its barrier) is read only between the barriers of t
// and t + 1.  The next write into the same slot is that of iteration t + 2
// (the slots alternate by parity), made after a block has passed the
// barrier of t + 1, which no block passes before every block has finished
// reading iteration t.  The pushed cv is written between the two barriers
// of an iteration and read after the second, before the first barrier of
// the next.  A cluster.sync() before the loop keeps any block from writing
// into a block that has not started; after a block's last barrier it
// touches no other block's memory, so blocks may exit in any order.
//
// What bounds it: not bytes (the bound over device memory is the state and
// the PSF once, microseconds for the whole run) but latency per iteration:
// one or two cluster barriers (about 0.3 us each on an H100), one block
// barrier, three warp reductions and one round of L2 gathers, about 2.3 us
// in all; and, per block, L2 sector throughput for the gathers (one 32-byte
// sector per candidate and PSF plane at worst), about 0.35 us per 1000
// candidates of a block.
//
// Rounding: every operation is an explicit _rn intrinsic, so nvcc neither
// contracts nor reorders anything.  The multiply-adds are explicit fused
// multiply-adds (__fmaf_rn): the running sum of the integration
// (s = fma(res[i, j], coef[i], s) after s = res[0, j] * coef[0]), the
// subtraction (res = fma(-psf, cv, res)) and the projection's sum.  That is
// what the JAX package's loop computes on its CPU backend, where XLA
// contracts each multiply-add (and its einsum and matrix product sum in
// this order); with separate roundings the port's Clark run of the
// point-source contract took 749 iterations where the JAX package took 783.
// The plain PyTorch version in kernels/subminor_loop.py performs the same
// operations in the same order, emulating each fused multiply-add exactly,
// so it agrees with the kernel bit for bit; the argmax's tie-break (largest
// value, then smallest index) is associative, so neither the partition
// over blocks nor the order of a reduction changes the winner.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (see
// kernels/_build.py).  Plain C entry point for ctypes; it returns the first
// CUDA error of its set-up and launch, and does not fall back: a cluster
// the card cannot schedule is an error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
// Candidates of one thread whose gathers are in flight together.
constexpr int kUnroll = 4;
// Planes the kernel takes: three floats of dynamic shared memory each;
// kernels/subminor_loop.py::MAX_IMAGES.
constexpr int kMaxImages = 4000;
// Planes whose raw values travel in a slot;
// kernels/subminor_loop.py::SHIP_RAW_MAX_IMAGES.
constexpr int kShipMax = 8;

// Output slots, shared with kernels/subminor_loop.py.
enum OutSlot { kIteration = 0, kDiverging = 1, kValueBits = 2 };

struct Best {
  float cmp;  // comparison value
  int idx;    // candidate index
  float val;  // signed (rms-weighted) integrated value
};

__device__ __forceinline__ bool better(float cmp, int idx, const Best& b) {
  return cmp > b.cmp || (cmp == b.cmp && idx < b.idx);
}

// Bits of a float as an unsigned integer of the same order; -0 counts as
// +0, as the comparison of floats has it.  No NaN reaches it: better()
// never takes one.
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The best of a warp, in every lane: the largest cmp, then the smallest
// idx, with the hardware's warp-wide integer reductions.
__device__ __forceinline__ Best warp_best(const Best& b) {
  const unsigned key = ordered_bits(b.cmp);
  const unsigned key_max = __reduce_max_sync(0xffffffffu, key);
  const int idx = __reduce_min_sync(0xffffffffu,
                                    key == key_max ? b.idx : INT_MAX);
  const unsigned holds =
      __ballot_sync(0xffffffffu, key == key_max && b.idx == idx);
  const int from = __ffs(holds) - 1;
  return Best{__shfl_sync(0xffffffffu, b.cmp, from), idx,
              __shfl_sync(0xffffffffu, b.val, from)};
}

// One block's best of one iteration, as every block of the cluster holds
// it.  x, y and raw are filled only when the raw values travel (kShipRaw).
struct Slot {
  float cmp;
  int idx;
  float val;
  int x;
  int y;
  float raw[kShipMax];
};

struct Shared {
  float warp_cmp[kWarps];
  int warp_idx[kWarps];
  float warp_val[kWarps];
  Slot slots[2][kMaxCluster];        // by iteration parity, by block rank
  float warp_cv[kWarps][kShipMax];   // kShipRaw: each warp's component
  int x, y;                          // otherwise: the component's position,
  int go;                            // and whether the loop goes on
};

// The loop's scalars, kept identically by every thread that decides.
struct Loop {
  int iteration;
  bool diverging;
  bool first;
  float max_at_start;
  float value;
};

// Step 3 (and the divergence test of step 7) for the new peak value.
__device__ __forceinline__ bool decide(Loop& lp, float value, float threshold,
                                       int max_iterations,
                                       float divergence_limit,
                                       int stop_on_negative) {
  lp.value = value;
  if (lp.first) {
    lp.max_at_start = fabsf(value);
    lp.first = false;
  } else {
    ++lp.iteration;
    lp.diverging =
        divergence_limit != 0.0f &&
        fabsf(value) > __fmul_rn(lp.max_at_start, divergence_limit);
  }
  bool go = fabsf(value) > threshold && lp.iteration < max_iterations &&
            !lp.diverging;
  if (stop_on_negative) go = go && value >= 0.0f;
  return go;
}

// Step 4 for plane i: scaled(q) is res[q, m] * gain.
template <typename Scaled>
__device__ __forceinline__ float component_value(int i, Scaled scaled,
                                                 const float* __restrict__ proj,
                                                 int n_pols, int n_chan) {
  if (!proj) return scaled(i);
  const int c = i / n_pols;
  const int p = i - c * n_pols;
  const float* row = proj + c * n_chan;
  float cv = __fmul_rn(row[0], scaled(p));
  for (int c2 = 1; c2 < n_chan; ++c2)
    cv = __fmaf_rn(row[c2], scaled(c2 * n_pols + p), cv);
  return cv;
}

// The slice's state: in shared memory (stride = slice) or in place in
// global memory (stride = K), indexed by the candidate's place in the slice.
struct State {
  float* res;
  const int* xs;
  const int* ys;
  const float* rms;  // null without an rms factor
  int64_t stride;
  int first;  // the slice's first candidate
  int len;    // candidates in the slice
};

// One pass over the slice: with kSubtract step 6, then steps 1-2 for every
// candidate; returns this thread's best.  (oy, ox) is the PSF centre minus
// the component's position.
template <bool kSubtract>
__device__ __forceinline__ Best sweep(const State& st,
                                      const float* __restrict__ psf,
                                      int64_t plane,
                                      const float* __restrict__ s_coef,
                                      const float* __restrict__ cv,
                                      int n_images, int n_pols, int oy, int ox,
                                      int height, int width,
                                      int allow_negative) {
  Best best{-INFINITY, INT_MAX, 0.0f};
  const int n_threads = blockDim.x;
  for (int base = threadIdx.x; base < st.len; base += kUnroll * n_threads) {
    bool live[kUnroll];
    bool inside[kUnroll];
    int64_t src[kUnroll];
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int jj = base + u * n_threads;
      live[u] = jj < st.len;
      inside[u] = false;
      src[u] = 0;
      s[u] = 0.0f;
      if (kSubtract && live[u]) {
        const int sy = st.ys[jj] + oy;
        const int sx = st.xs[jj] + ox;
        inside[u] = sy >= 0 && sy < height && sx >= 0 && sx < width;
        src[u] = static_cast<int64_t>(sy) * width + sx;
      }
    }
    for (int i = 0; i < n_images; ++i) {
      float p[kUnroll];
      if (kSubtract) {
        const float* psf_plane = psf + (i / n_pols) * plane;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          p[u] = inside[u] ? psf_plane[src[u]] : 0.0f;
      }
      const float c = s_coef[i];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!live[u]) continue;
        float* r = st.res + i * st.stride + (base + u * n_threads);
        float v = *r;
        if (kSubtract) {
          v = __fmaf_rn(-p[u], cv[i], v);
          *r = v;
        }
        s[u] = i == 0 ? __fmul_rn(v, c) : __fmaf_rn(v, c, s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      const int jj = base + u * n_threads;
      const float v = st.rms ? __fmul_rn(s[u], st.rms[jj]) : s[u];
      const float cmp = allow_negative ? fabsf(v) : v;
      if (better(cmp, st.first + jj, best)) best = Best{cmp, st.first + jj, v};
    }
  }
  return best;
}

// The cluster's barrier; that of one block is the block's.
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster,
                                                int n_ranks) {
  if (n_ranks == 1)
    __syncthreads();
  else
    cluster.sync();
}

template <bool kOnChip, bool kShipRaw>
__global__ void __launch_bounds__(kMaxThreads)
    subminor_loop_kernel(float* __restrict__ res, float* __restrict__ model,
                         const float* __restrict__ rms,
                         const int* __restrict__ xs,
                         const int* __restrict__ ys,
                         const float* __restrict__ psf,
                         const float* __restrict__ coef,
                         const float* __restrict__ proj,
                         int* __restrict__ out, int n_images, int n_pols,
                         int k, int slice, int height, int width,
                         float threshold, float gain, int start_iteration,
                         int max_iterations, float divergence_limit,
                         int allow_negative, int stop_on_negative) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  __shared__ Shared sh;
  // Per plane: the integration coefficient, the gain-scaled residual value
  // at the component and the component value after the spectral fit; then,
  // with kOnChip, the slice's residual [N, slice], xs, ys and rms.
  extern __shared__ float dyn[];
  float* const s_coef = dyn;
  float* const s_raw = dyn + n_images;
  float* const s_cv = dyn + 2 * n_images;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = n_threads >> 5;
  const int n_chan = n_images / n_pols;
  const int64_t plane = static_cast<int64_t>(height) * width;

  State st;
  st.first = rank * slice;
  st.len = min(slice, k - st.first);
  if (st.len < 0) st.len = 0;
  if constexpr (kOnChip) {
    float* const c_res = dyn + 3 * n_images;
    int* const c_xs = reinterpret_cast<int*>(
        c_res + static_cast<int64_t>(n_images) * slice);
    int* const c_ys = c_xs + slice;
    float* const c_rms = reinterpret_cast<float*>(c_ys + slice);
    for (int jj = tid; jj < st.len; jj += n_threads) {
      const int j = st.first + jj;
      c_xs[jj] = xs[j];
      c_ys[jj] = ys[j];
      if (rms) c_rms[jj] = rms[j];
      for (int i = 0; i < n_images; ++i)
        c_res[static_cast<int64_t>(i) * slice + jj] =
            res[static_cast<int64_t>(i) * k + j];
    }
    st.res = c_res;
    st.xs = c_xs;
    st.ys = c_ys;
    st.rms = rms ? c_rms : nullptr;
    st.stride = slice;
  } else {
    st.res = res + st.first;
    st.xs = xs + st.first;
    st.ys = ys + st.first;
    st.rms = rms ? rms + st.first : nullptr;
    st.stride = k;
  }
  for (int i = tid; i < n_images; i += n_threads) s_coef[i] = coef[i];
  // Every block of the cluster runs before any writes into another.
  cluster_barrier(cluster, n_ranks);

  // The first argmax, over the unchanged state.
  Best best = sweep<false>(st, psf, plane, s_coef, nullptr, n_images, n_pols,
                           0, 0, height, width, allow_negative);
  Loop lp{start_iteration, false, true, 0.0f, 0.0f};
  for (int parity = 0;; parity ^= 1) {
    // This block's argmax: each warp's, then warp 0 over the warps.
    best = warp_best(best);
    if (lane == 0) {
      sh.warp_cmp[warp] = best.cmp;
      sh.warp_idx[warp] = best.idx;
      sh.warp_val[warp] = best.val;
    }
    __syncthreads();
    if (warp == 0) {
      best = Best{-INFINITY, INT_MAX, 0.0f};
      if (lane < n_warps)
        best = Best{sh.warp_cmp[lane], sh.warp_idx[lane], sh.warp_val[lane]};
      best = warp_best(best);
      // Lane r writes it into block r's slot for this block.
      if (lane < n_ranks) {
        Slot* slot = cluster.map_shared_rank(&sh.slots[parity][rank], lane);
        slot->cmp = best.cmp;
        slot->idx = best.idx;
        slot->val = best.val;
        if (kShipRaw && st.len > 0) {
          const int at = best.idx == INT_MAX ? 0 : best.idx - st.first;
          slot->x = st.xs[at];
          slot->y = st.ys[at];
          for (int i = 0; i < n_images; ++i)
            slot->raw[i] = st.res[i * st.stride + at];
        }
      }
    }
    cluster_barrier(cluster, n_ranks);

    // The cluster's argmax from the R slots; the same in every block.
    const float* cv;
    int wx, wy;
    if (kShipRaw || warp == 0) {
      Best win{-INFINITY, INT_MAX, 0.0f};
      if (lane < n_ranks) {
        const Slot& s = sh.slots[parity][lane];
        win = Best{s.cmp, s.idx, s.val};
      }
      win = warp_best(win);
      const float value = win.val;
      const int m = win.idx == INT_MAX ? 0 : win.idx;
      const bool go = decide(lp, value, threshold, max_iterations,
                             divergence_limit, stop_on_negative);
      const int owner = m / slice;
      if constexpr (kShipRaw) {
        if (!go) break;
        const Slot& ws = sh.slots[parity][owner];
        if (lane < n_images) {
          const float v = component_value(
              lane, [&](int q) { return __fmul_rn(ws.raw[q], gain); }, proj,
              n_pols, n_chan);
          sh.warp_cv[warp][lane] = v;
          // The last warp has the fewest candidates to pass over.
          if (warp == n_warps - 1 && rank == owner) {
            float* mo = model + static_cast<int64_t>(lane) * k + m;
            *mo = __fadd_rn(*mo, v);
          }
        }
        __syncwarp();
        cv = sh.warp_cv[warp];
        wx = ws.x;
        wy = ws.y;
      } else {
        if (go && rank == owner) {
          const int at = m - st.first;
          for (int i = lane; i < n_images; i += 32)
            s_raw[i] = __fmul_rn(st.res[i * st.stride + at], gain);
          __syncwarp();
          for (int i = lane; i < n_images; i += 32) {
            const float v = component_value(
                i, [&](int q) { return s_raw[q]; }, proj, n_pols, n_chan);
            float* mo = model + static_cast<int64_t>(i) * k + m;
            *mo = __fadd_rn(*mo, v);
            for (int r = 0; r < n_ranks; ++r)
              cluster.map_shared_rank(s_cv, r)[i] = v;
          }
          if (lane < n_ranks) {
            Shared* other = cluster.map_shared_rank(&sh, lane);
            other->x = st.xs[at];
            other->y = st.ys[at];
          }
        }
        if (lane == 0) sh.go = go;
      }
    }
    if constexpr (!kShipRaw) {
      cluster_barrier(cluster, n_ranks);
      if (!sh.go) break;
      cv = s_cv;
      wx = sh.x;
      wy = sh.y;
    }

    // Steps 6 and 1-2: subtract the component's PSF at every candidate of
    // the slice and integrate the new values.
    best = sweep<true>(st, psf, plane, s_coef, cv, n_images, n_pols,
                       height / 2 - wy, width / 2 - wx, height, width,
                       allow_negative);
  }

  if constexpr (kOnChip) {
    for (int jj = tid; jj < st.len; jj += n_threads)
      for (int i = 0; i < n_images; ++i)
        res[static_cast<int64_t>(i) * k + st.first + jj] =
            st.res[static_cast<int64_t>(i) * slice + jj];
  }
  if (rank == 0 && tid == 0) {
    out[kIteration] = lp.iteration;
    out[kDiverging] = lp.diverging;
    out[kValueBits] = __float_as_int(lp.value);
  }
}

}  // namespace

extern "C" {

// cluster_size, threads, slice, on_chip, ship_raw and shared_bytes are the
// plan of kernels/subminor_loop.py::cluster_plan.
int subminor_loop(float* res, float* model, const float* rms, const int* xs,
                  const int* ys, const float* psf, const float* coef,
                  const float* proj, int* out, int n_images, int n_pols,
                  int k, int height, int width, float threshold, float gain,
                  int start_iteration, int max_iterations,
                  float divergence_limit, int allow_negative,
                  int stop_on_negative, int cluster_size, int threads,
                  int slice, int on_chip, int ship_raw, int shared_bytes,
                  void* stream) {
  const int64_t needed =
      4 * (3 * static_cast<int64_t>(n_images) +
           (on_chip ? static_cast<int64_t>(slice) * (n_images + 3) : 0));
  if (n_images < 1 || n_images > kMaxImages || n_pols < 1 ||
      n_images % n_pols != 0 || k < 1 || cluster_size < 1 ||
      cluster_size > kMaxCluster || (cluster_size & (cluster_size - 1)) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      slice < 1 || static_cast<int64_t>(slice) * cluster_size < k ||
      (ship_raw && n_images > kShipMax) || shared_bytes < needed)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel =
      on_chip ? (ship_raw
                     ? reinterpret_cast<const void*>(
                           &subminor_loop_kernel<true, true>)
                     : reinterpret_cast<const void*>(
                           &subminor_loop_kernel<true, false>))
              : (ship_raw
                     ? reinterpret_cast<const void*>(
                           &subminor_loop_kernel<false, true>)
                     : reinterpret_cast<const void*>(
                           &subminor_loop_kernel<false, false>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      cluster_size > 8 ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = cluster_size;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster_size);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attribute;
  config.numAttrs = 1;
  // The card must be able to run the whole cluster at once.
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);

  void* args[] = {&res,        &model,
                  &rms,        &xs,
                  &ys,         &psf,
                  &coef,       &proj,
                  &out,        &n_images,
                  &n_pols,     &k,
                  &slice,      &height,
                  &width,      &threshold,
                  &gain,       &start_iteration,
                  &max_iterations, &divergence_limit,
                  &allow_negative, &stop_on_negative};
  err = cudaLaunchKernelExC(&config, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
