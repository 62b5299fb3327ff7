// The Clark subminor loop for Hopper (sm_90a), in one launch.
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
// Design and what bounds it: one persistent block of 1024 threads runs every
// iteration.  Each thread strides over K; the [N, K] state lives in global
// memory, where it stays in L2 (N * K * 4 = 241 KB per array at K = 60218).
// A block-wide reduction (warp shuffles, then one warp over the per-warp
// partials) finds the argmax with the smallest-index tie-break; warp 0 then
// runs the epilogue (stop tests, component values, model update) and
// publishes the next component through shared memory.  Two barriers per
// iteration and no grid sync.  So the loop runs on one SM: it is bounded by
// that SM's share of L2 bandwidth and latency (per iteration it streams
// about K * (8 N + 12) bytes of state and positions and gathers K * C PSF
// values) and by the two barriers.  Spreading the state over a thread-block
// cluster's distributed shared memory, or over a cooperative grid, is the
// way to make it faster; that is later work.
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
// so it agrees with the kernel bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (see
// kernels/_build.py).  Plain C entry point for ctypes; it returns
// cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Planes the kernel takes: three floats of dynamic shared memory each,
// within the default 48 KB; kernels/subminor_loop.py::MAX_IMAGES.
constexpr int kMaxImages = 4000;

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

__device__ __forceinline__ void warp_reduce(Best& b) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    const float cmp = __shfl_down_sync(0xffffffffu, b.cmp, offset);
    const int idx = __shfl_down_sync(0xffffffffu, b.idx, offset);
    const float val = __shfl_down_sync(0xffffffffu, b.val, offset);
    if (better(cmp, idx, b)) b = Best{cmp, idx, val};
  }
}

struct Shared {
  float warp_cmp[kWarps];
  int warp_idx[kWarps];
  float warp_val[kWarps];
  int m;   // the component's candidate index
  int go;  // whether the loop runs another iteration
};

// Steps 1-2 for candidate j, given its integrated value s.
__device__ __forceinline__ void consider(Best& best, float s, int j,
                                         const float* __restrict__ rms,
                                         int allow_negative) {
  const float v = rms ? __fmul_rn(s, rms[j]) : s;
  const float cmp = allow_negative ? fabsf(v) : v;
  if (better(cmp, j, best)) best = Best{cmp, j, v};
}

__global__ void __launch_bounds__(kThreads)
    subminor_loop_kernel(float* __restrict__ res, float* __restrict__ model,
                         const float* __restrict__ rms,
                         const int* __restrict__ xs,
                         const int* __restrict__ ys,
                         const float* __restrict__ psf,
                         const float* __restrict__ coef,
                         const float* __restrict__ proj,
                         int* __restrict__ out, int n_images, int n_pols,
                         int k, int height, int width, float threshold,
                         float gain, int start_iteration, int max_iterations,
                         float divergence_limit, int allow_negative,
                         int stop_on_negative) {
  __shared__ Shared sh;
  // Per plane: the integration coefficient, the gain-scaled residual value
  // at the component and the component value after the spectral fit.
  extern __shared__ float per_plane[];
  float* const s_coef = per_plane;
  float* const s_raw = per_plane + n_images;
  float* const s_cv = per_plane + 2 * n_images;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chan = n_images / n_pols;
  const int64_t plane = static_cast<int64_t>(height) * width;
  for (int i = tid; i < n_images; i += kThreads) s_coef[i] = coef[i];
  __syncthreads();

  // The first argmax, over the unchanged state.
  Best best{-INFINITY, INT_MAX, 0.0f};
  for (int j = tid; j < k; j += kThreads) {
    float s = 0.0f;
    for (int i = 0; i < n_images; ++i) {
      const float r = res[static_cast<int64_t>(i) * k + j];
      s = i == 0 ? __fmul_rn(r, s_coef[i]) : __fmaf_rn(r, s_coef[i], s);
    }
    consider(best, s, j, rms, allow_negative);
  }

  // Loop scalars, kept (identically) by every lane of warp 0.
  int iteration = start_iteration;
  bool diverging = false;
  bool first = true;
  float max_at_start = 0.0f;
  float value = 0.0f;
  for (;;) {
    // Block-wide argmax: warp shuffles, then warp 0 over the warps.
    warp_reduce(best);
    if (lane == 0) {
      sh.warp_cmp[warp] = best.cmp;
      sh.warp_idx[warp] = best.idx;
      sh.warp_val[warp] = best.val;
    }
    __syncthreads();
    if (warp == 0) {
      best = Best{sh.warp_cmp[lane], sh.warp_idx[lane], sh.warp_val[lane]};
      warp_reduce(best);
      const int m_raw = __shfl_sync(0xffffffffu, best.idx, 0);
      value = __shfl_sync(0xffffffffu, best.val, 0);
      const int m = m_raw == INT_MAX ? 0 : m_raw;
      if (first) {
        max_at_start = fabsf(value);
        first = false;
      } else {
        ++iteration;
        diverging = divergence_limit != 0.0f &&
                    fabsf(value) > __fmul_rn(max_at_start, divergence_limit);
      }
      bool go = fabsf(value) > threshold && iteration < max_iterations &&
                !diverging;
      if (stop_on_negative) go = go && value >= 0.0f;
      if (go) {
        for (int i = lane; i < n_images; i += 32)
          s_raw[i] = __fmul_rn(res[static_cast<int64_t>(i) * k + m], gain);
        __syncwarp();
        for (int i = lane; i < n_images; i += 32) {
          float cv = s_raw[i];
          if (proj) {
            const int c = i / n_pols;
            const int p = i - c * n_pols;
            const float* row = proj + c * n_chan;
            cv = __fmul_rn(row[0], s_raw[p]);
            for (int c2 = 1; c2 < n_chan; ++c2)
              cv = __fmaf_rn(row[c2], s_raw[c2 * n_pols + p], cv);
          }
          s_cv[i] = cv;
          float* mo = model + static_cast<int64_t>(i) * k + m;
          *mo = __fadd_rn(*mo, cv);
        }
      }
      if (lane == 0) {
        sh.m = m;
        sh.go = go;
      }
    }
    __syncthreads();
    if (!sh.go) break;

    // Steps 6 and 1-2: subtract the component's PSF at every candidate and
    // integrate the new values.
    const int m = sh.m;
    const int oy = height / 2 - ys[m];
    const int ox = width / 2 - xs[m];
    best = Best{-INFINITY, INT_MAX, 0.0f};
    for (int j = tid; j < k; j += kThreads) {
      const int sy = ys[j] + oy;
      const int sx = xs[j] + ox;
      const bool inside = sy >= 0 && sy < height && sx >= 0 && sx < width;
      const int64_t src = static_cast<int64_t>(sy) * width + sx;
      float s = 0.0f;
      for (int i = 0; i < n_images; ++i) {
        const float p = inside ? psf[(i / n_pols) * plane + src] : 0.0f;
        float* r = res + static_cast<int64_t>(i) * k + j;
        const float v = __fmaf_rn(-p, s_cv[i], *r);
        *r = v;
        s = i == 0 ? __fmul_rn(v, s_coef[i]) : __fmaf_rn(v, s_coef[i], s);
      }
      consider(best, s, j, rms, allow_negative);
    }
  }
  if (tid == 0) {
    out[kIteration] = iteration;
    out[kDiverging] = diverging;
    out[kValueBits] = __float_as_int(value);
  }
}

}  // namespace

extern "C" {

int subminor_loop(float* res, float* model, const float* rms, const int* xs,
                  const int* ys, const float* psf, const float* coef,
                  const float* proj, int* out, int n_images, int n_pols,
                  int k, int height, int width, float threshold, float gain, int start_iteration,
                  int max_iterations, float divergence_limit,
                  int allow_negative, int stop_on_negative, void* stream) {
  if (n_images < 1 || n_images > kMaxImages || n_pols < 1 ||
      n_images % n_pols != 0 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared_bytes = 3 * sizeof(float) * n_images;
  subminor_loop_kernel<<<1, kThreads, shared_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      res, model, rms, xs, ys, psf, coef, proj, out, n_images, n_pols,
      k, height, width, threshold, gain, start_iteration, max_iterations,
      divergence_limit, allow_negative, stop_on_negative);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
