// The shard-local Högbom step of the mesh loop for Hopper (sm_90a).
//
// Replaces radler_tpu/ops/pallas/hogbom_step.py::_subtract_integrate_kernel
// (reached through fused_subtract_integrate from
// parallel/mesh.py::mesh_hogbom_loop when the mesh splits the planes over
// its "chan" axis).
//
// What it computes, with the peak (y, x) in image rows and the component
// values read from the device loop state, for one shard that holds N_loc
// planes of the image rows row_offset .. row_offset + H_loc - 1:
//   model[n, y - row_offset, x] += values[n] when the shard holds row y;
//   for every local pixel p and plane n:
//     res[n, p] -= values[n] * psf[n / P] shifted to (y, x)
//   (zero outside the PSF, the clipping of simple_clean.cc:61-96), then the
//   shard's ADDITIVE part of the joined integration of its N_loc planes,
//   for a sum over the mesh's "chan" axis outside the kernel:
//     signed, linear  sum_n v[n] * coef[n]
//     normal          sum_c per_chan(c) * coef[c*P], per_chan the plane
//                     itself when P == 1, else
//                     sqrt(max(sum_p (v*v) * pol[p], 0))
//     squared         sum_n ((v*v) * coef[c*P]) * pol[p], no sqrt: the
//                     caller compares the summed part times weight^2.
//   coef holds the shard's per-plane channel coefficients, pol the
//   polarization coefficients.  The squared-mode order is the TPU kernel's
//   (hogbom_step.py:430-443), not B1's, whose squared mode multiplies by
//   the float32 rounding of the product coef * pol.
//
// What bounds it: device-memory bytes.  It reads the shard's residual and
// the PSF window under it and writes the residual and the integration
// part: (3 * N_loc + 1) * H_loc * W * 4 bytes, 134.2 MB for the mesh
// configuration's [1, 2048, 4096] shard, 40.1 us at the H100's 3.35 TB/s.
// Arithmetic is a few flops per byte.  The design is B1's without the
// argmax: one thread per local pixel, neighbouring threads on neighbouring
// addresses of the residual, the PSF and the part, all planes of a pixel in
// registers; no reduction, so no second launch.  The PSF is read un-padded
// at the full image size with a bounds test, in place of the TPU's padded
// canvas, aligned over-fetch and rotate; the peak stays in image rows, in
// place of the TPU's local-row frame.
//
// Rounding: _rn intrinsics, which nvcc never contracts into a fused
// multiply-add, in the TPU kernel's order; the plain PyTorch version in
// kernels/subtract_integrate.py performs the same operations, so the two
// agree bit for bit.  The kernel returns at once when the state's `active`
// flag is 0, so the loop may enqueue iterations past its stop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (see kernels/_build.py).  Plain C entry point for
// ctypes; it returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Integration modes and state slots, shared with kernels/hogbom_step.py.
enum Mode { kSigned = 0, kLinear = 1, kNormal = 2, kSquared = 3 };
enum StateSlot { kY = 0, kX = 1, kActive = 5 };

constexpr int kThreads = 256;

// max(x, 0) that keeps a NaN, as jnp.maximum and torch.clamp_min do.
__device__ __forceinline__ float clamp_min0(float x) {
  return x < 0.0f ? 0.0f : x;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    subtract_integrate_kernel(float* __restrict__ res,
                              float* __restrict__ model,
                              const float* __restrict__ psf,
                              const float* __restrict__ values,
                              const float* __restrict__ coefs,
                              const float* __restrict__ pol,
                              const int* __restrict__ state,
                              float* __restrict__ integ, int n_images,
                              int n_pols, int height_local, int width,
                              int height, int row_offset) {
  if (state[kActive] == 0) return;
  const int y = state[kY];
  const int x = state[kX];
  const int plane = height_local * width;
  const int64_t psf_plane = static_cast<int64_t>(height) * width;

  const int local_y = y - row_offset;
  if (blockIdx.x == 0 && local_y >= 0 && local_y < height_local) {
    for (int n = threadIdx.x; n < n_images; n += kThreads) {
      float* m = model + static_cast<int64_t>(n) * plane + local_y * width + x;
      *m = __fadd_rn(*m, values[n]);
    }
  }

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= plane) return;
  const int py = p / width;
  const int px = p - py * width;
  const int sy = py + row_offset + height / 2 - y;
  const int sx = px + width / 2 - x;
  const bool inside = sy >= 0 && sy < height && sx >= 0 && sx < width;
  const int64_t src = static_cast<int64_t>(sy) * width + sx;
  float acc = 0.0f;
  float sq = 0.0f;
  for (int n = 0; n < n_images; ++n) {
    const int c = n / n_pols;
    const int q = n - c * n_pols;
    const float shifted = inside ? psf[c * psf_plane + src] : 0.0f;
    float* r = res + static_cast<int64_t>(n) * plane + p;
    const float v = __fsub_rn(*r, __fmul_rn(values[n], shifted));
    *r = v;
    if (kMode == kSigned || kMode == kLinear) {
      const float term = __fmul_rn(v, coefs[n]);
      acc = n == 0 ? term : __fadd_rn(acc, term);
    } else if (kMode == kSquared) {
      const float term =
          __fmul_rn(__fmul_rn(__fmul_rn(v, v), coefs[c * n_pols]), pol[q]);
      acc = n == 0 ? term : __fadd_rn(acc, term);
    } else {  // normal
      if (n_pols == 1) {
        const float term = __fmul_rn(v, coefs[c]);
        acc = c == 0 ? term : __fadd_rn(acc, term);
      } else {
        const float term = __fmul_rn(__fmul_rn(v, v), pol[q]);
        sq = q == 0 ? term : __fadd_rn(sq, term);
        if (q == n_pols - 1) {
          const float chan =
              __fmul_rn(__fsqrt_rn(clamp_min0(sq)), coefs[c * n_pols]);
          acc = c == 0 ? chan : __fadd_rn(acc, chan);
        }
      }
    }
  }
  integ[p] = acc;
}

}  // namespace

extern "C" {

int subtract_integrate(float* res, float* model, const float* psf,
                       const float* values, const float* coefs,
                       const float* pol, const int* state, float* integ,
                       int n_images, int n_pols, int height_local, int width,
                       int height, int row_offset, int mode, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (height_local * width + kThreads - 1) / kThreads;
#define RADLER_SI_ARGS                                                      \
  res, model, psf, values, coefs, pol, state, integ, n_images, n_pols,      \
      height_local, width, height, row_offset
  switch (mode) {
    case kSigned:
      subtract_integrate_kernel<kSigned><<<blocks, kThreads, 0, s>>>(
          RADLER_SI_ARGS);
      break;
    case kLinear:
      subtract_integrate_kernel<kLinear><<<blocks, kThreads, 0, s>>>(
          RADLER_SI_ARGS);
      break;
    case kNormal:
      subtract_integrate_kernel<kNormal><<<blocks, kThreads, 0, s>>>(
          RADLER_SI_ARGS);
      break;
    case kSquared:
      subtract_integrate_kernel<kSquared><<<blocks, kThreads, 0, s>>>(
          RADLER_SI_ARGS);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RADLER_SI_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
