// The Clark subminor loop for Hopper (sm_90a), in one launch: one
// thread-block cluster, or a cooperative grid of one block a multiprocessor
// where one cluster cannot hold the candidates (the grid route, below).
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
//      spectral fit, each polarization on its own (FitMode): the polynomial
//      fit's constant [C, C] projection, summed in channel order
//      (subminor_fused.py:169-182); or, as the JAX package's XLA loop
//      (radler_tpu/models/subminor.py:162-167, ops/spectral_fitting.py:
//      156-190) applies them, the log-polynomial fit (the sign of the
//      weighted mean, then exp(D F log max(|v|, 1e-36))) or the forced-term
//      fit (the amplitude against exp(sum_k terms_k[m] lx^(k+1))), whose
//      term vectors ride in the slice's state beside x and y.
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
// PSF is read directly at image size, so there is no O(K^2) table to build
// and no memory budget that bounds K.  At 2048^2 its [C, H, W] float32
// planes (16.8 MB a plane) stay in the 50 MB L2; at 8192^2 x 4 (1.07 GB)
// they do not, and every iteration gathers its K x C values mostly from
// HBM.
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
//     With a log-polynomial or forced-term fit each lane recomputes its
//     polarization's sums (mean, logs, coefficients; curve, amplitude) from
//     the slot's raw values (and forced terms, which travel in the slot
//     too) in the same order, so every warp of every block holds the same
//     bits without a broadcast.
//   * Any N (kShipRaw false): warp 0 of the block that owns the winner
//     computes cv (gain, then the fit), adds it to the model and writes cv
//     and the winner's position into every block's shared memory; a second
//     cluster.sync() publishes them.  A log-polynomial or forced-term fit
//     computes each plane's logs (each channel's curve), then each
//     polarization's sign and coefficients (amplitude) once into shared
//     memory, then every plane's value from them: the same operations in
//     the same order as the ship-raw lanes.
//
// The fit is a template parameter (kFit): no fit and the projection share
// one instantiation (proj null or not), and the two other fits have their
// own, so that neither adds registers or shared memory to the others.
// Their constants (F, D and the normalised weights; the weights and the
// abscissa powers) are loaded into shared memory beside the integration
// coefficients, with the scratch of the owner's computation.
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
// Grid route (kGrid; kernels/subminor_loop.py::cluster_plan takes it where
// N * K is above GRID_VALUES).  A cluster is at most 16 blocks, so at K =
// 168,945 (the 8192^2 x 4 spectral-fit performs) 16 multiprocessors gather
// every iteration's K x C PSF values from HBM and the state (4.7 MB) does
// not fit in their shared memory.  The grid route launches G blocks, one a
// multiprocessor (G is the plan's: the card's multiprocessor count; the
// entry point checks with cudaOccupancyMaxActiveBlocksPerMultiprocessor
// that the card holds them all, and launches with
// cudaLaunchAttributeCooperative, which fails rather than start a grid
// whose blocks could not all be resident).  Block b owns [b * slice,
// (b + 1) * slice), its state in shared memory where the capacity rule
// holds at G blocks (a slice of K / G candidates beside the copy of G
// slots), else in global memory.  Per iteration:
//   1. The block reduces its best as above; the lanes of warp 0 write its
//      slot (cmp, idx, val, and with kShipRaw x, y, the N raw values and the
//      forced terms) as words [parity][field][b] of a global slot array in
//      the launch's workspace, where the cluster route writes into every
//      block's shared memory.
//   2. One grid barrier, cooperative groups' this_grid().sync(): each
//      block's thread 0 fences (__threadfence()) and arrives on a word of
//      the cooperative launch's own, so every slot written before the
//      barrier is visible after it; the slots are then read with
//      ld.global.cg (L1 is not coherent across multiprocessors).
//   3. Every block copies the iteration's G slots into shared memory in one
//      coalesced round and every warp reduces them with warp_best to the same
//      winner (the largest ordered bits, then the smallest index); with
//      kShipRaw each warp then computes cv from the winner's raw values with
//      the code and order of the cluster route, so every block holds the
//      same bits without a broadcast, and the block that owns the winner
//      adds cv to the model.
//   4. Without raw values (N > 8, or more than 4 forced terms) the owner
//      writes cv and the position to the workspace, and a second grid
//      barrier publishes them.
// The parity argument above holds word for word with "grid barrier" in
// place of "cluster barrier"; no block writes into another's memory, so no
// barrier is needed before the loop.  Three other barriers gave the same
// bits and were slower on an H100 (PERF.md): an arrival count and a
// generation word of the kernel's own; the same in two levels (clusters of
// 2 or 4 blocks meeting at the cluster barrier, their first blocks on the
// count; the card also refuses clusters of 4 at one 928-thread block a
// multiprocessor); and a stamp beside each slot that every block polls.
// The pass gathers the PSF values of four planes at once
// (kPlanes): at one block a multiprocessor a thread has one or two
// candidates, and a plane at a time would pay a round trip to HBM per
// plane.
//
// What bounds it: not bytes (the bound over device memory is the state and
// the PSF once, microseconds for the whole run, or, where fewer, the PSF
// values the iterations gather) but latency per iteration.  On the cluster
// route: one or two cluster barriers (about 0.3 us each on an H100), one
// block barrier, three warp reductions and one round of L2 gathers, about
// 2.3 us in all; and, per block, L2 sector throughput for the gathers (one
// 32-byte sector per candidate and PSF plane at worst), about 0.35 us per
// 1000 candidates of a block.  On the grid route: one grid barrier, four
// block barriers, the slots' round trip through L2 and the reductions, a
// floor of about 4 us at a few candidates a block, then the round of
// gathers, mostly from HBM at 8192^2 (PERF.md).
//
// Tile axis (the device mesh's Clark subminor, parallel/mesh.py::
// mesh_subminor_clean; radler_tpu/parallel/mesh.py:488-676 in the JAX
// package).  The mesh's tiles clean their own candidate sets to a shared
// threshold from a shared iteration start; a tile that has stopped is gated
// off, so the lockstep of the JAX program decides nothing, and the program
// is T independent subminor loops.  One launch runs them all: gridDim.x =
// T * R with cluster dims R, and cluster c takes the candidate segment
// [offsets[c], offsets[c + 1]) of the concatenated [N, sum K] state, xs, ys
// and rms (the state's row stride is the total), and writes its result to
// out[c] ([T, 3]).  The slice comes from the largest segment, so a block of
// a shorter one may own no candidate (its best is -inf, index INT_MAX) and
// an empty segment stops at its first decision with the value 0.  The
// clusters share nothing, neither memory nor a barrier, so T clusters that
// do not all fit on the card at once still finish.  Without offsets (T = 1)
// the single segment is [0, k), today's launch.
//
// Rounding: every operation is an explicit _rn intrinsic, so nvcc neither
// contracts nor reorders anything.  The multiply-adds are explicit fused
// multiply-adds (__fmaf_rn): the running sum of the integration
// (s = fma(res[i, j], coef[i], s) after s = res[0, j] * coef[0]), the
// subtraction (res = fma(-psf, cv, res)), the projection's sum and every
// sum of the two other fits.  logf and expf are the CUDA math library's
// full-precision functions (no fast-math flag), which PyTorch's float32
// log and exp on the card call too.  That is
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
// or a grid the card cannot schedule is an error.

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

// Forced terms that travel in a slot;
// kernels/subminor_loop.py::SHIP_RAW_MAX_TERMS.
constexpr int kShipTerms = 4;
// Planes whose PSF values a thread of the grid route gathers at once.
constexpr int kGridPlanes = 4;

// Output slots, shared with kernels/subminor_loop.py.
enum OutSlot { kIteration = 0, kDiverging = 1, kValueBits = 2 };

// Step 4's spectral fit, shared with kernels/subminor_loop.py (FIT_*): 0 is
// no fit, which runs in the projection's instantiation with proj null.
enum FitMode {
  kFitNone = 0,
  kFitProjection = 1,
  kFitLogPolynomial = 2,
  kFitForced = 3
};

constexpr float kTiny = 1e-36f;

// Floats of a fit's constants in shared memory: F [T, C], D [C, T] and the
// normalised weights [C]; or the weights [C] and the powers [T-1, C].
__host__ __device__ inline int fit_constant_floats(int mode, int n_chan,
                                                   int n_terms) {
  if (mode == kFitLogPolynomial) return 2 * n_terms * n_chan + n_chan;
  if (mode == kFitForced) return n_terms * n_chan;
  return 0;
}

// Floats of a fit's constants and of the owner's scratch (the logs of the
// N values, then a sign and T coefficients per polarization; the curve
// [C], then an amplitude per polarization), N bounding the polarizations;
// kernels/subminor_loop.py::SubminorFit.shared_floats.
__host__ __device__ inline int fit_shared_floats(int mode, int n_images,
                                                 int n_chan, int n_terms) {
  if (mode == kFitLogPolynomial)
    return fit_constant_floats(mode, n_chan, n_terms) +
           n_images * (n_terms + 2);
  if (mode == kFitForced)
    return fit_constant_floats(mode, n_chan, n_terms) + n_chan + n_images;
  return 0;
}

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
  float terms[kShipTerms];  // the best's forced terms (kFitForced)
};

// Words of a slot; kernels/subminor_loop.py::SLOT_WORDS.
constexpr int kSlotWords = sizeof(Slot) / 4;
static_assert(kSlotWords == 5 + kShipMax + kShipTerms, "Slot is packed");

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

// The log-polynomial fit of plane i (channel c, polarization p) from the
// gain-scaled values alone, as each lane of the ship-raw exchange computes
// it: mean = sum_c wbar_c v_cp, l_c = logf(max(|v_cp|, 1e-36)), coef_t =
// sum_c F_tc l_c, e = sum_t D_ct coef_t, cv = sign(mean) expf(e).  C is at
// most kShipMax, so the logs stay in registers.
template <typename Scaled>
__device__ __forceinline__ float log_polynomial_value(
    int i, Scaled scaled, const float* __restrict__ fit, int n_pols,
    int n_chan, int n_terms) {
  const float* fit_m = fit;                          // [T, C]
  const float* design = fit + n_terms * n_chan;      // [C, T]
  const float* wbar = design + n_chan * n_terms;     // [C]
  const int c_own = i / n_pols;
  const int p = i - c_own * n_pols;
  float logs[kShipMax];
  float mean = 0.0f;
#pragma unroll
  for (int c = 0; c < kShipMax; ++c) {
    if (c < n_chan) {
      const float v = scaled(c * n_pols + p);
      mean = c == 0 ? __fmul_rn(wbar[0], v) : __fmaf_rn(wbar[c], v, mean);
      logs[c] = logf(fmaxf(fabsf(v), kTiny));
    }
  }
  float e = 0.0f;
  for (int t = 0; t < n_terms; ++t) {
    const float* row = fit_m + t * n_chan;
    float coef = __fmul_rn(row[0], logs[0]);
#pragma unroll
    for (int c = 1; c < kShipMax; ++c)
      if (c < n_chan) coef = __fmaf_rn(row[c], logs[c], coef);
    const float d = design[c_own * n_terms + t];
    e = t == 0 ? __fmul_rn(d, coef) : __fmaf_rn(d, coef, e);
  }
  return __fmul_rn(mean < 0.0f ? -1.0f : 1.0f, expf(e));
}

// The forced curve at channel c: expf(sum_k terms[k * stride] powers[k,
// c]), summed in term order.
__device__ __forceinline__ float forced_curve(int c,
                                              const float* __restrict__ terms,
                                              int64_t stride,
                                              const float* __restrict__ powers,
                                              int n_chan, int n_forced) {
  float q = 0.0f;
  for (int t = 0; t < n_forced; ++t)
    q = t == 0 ? __fmul_rn(terms[0], powers[c])
               : __fmaf_rn(terms[t * stride], powers[t * n_chan + c], q);
  return expf(q);
}

// The forced-term fit of plane i from the gain-scaled values and the
// winner's terms alone, as each lane of the ship-raw exchange computes it:
// wc_c = w_c curve_c, amp = (sum_c wc_c v_cp) / max(sum_c wc_c curve_c,
// 1e-36), cv = curve_c amp.
template <typename Scaled>
__device__ __forceinline__ float forced_value(int i, Scaled scaled,
                                              const float* __restrict__ terms,
                                              const float* __restrict__ fit,
                                              int n_pols, int n_chan,
                                              int n_terms) {
  const float* w = fit;                 // [C]
  const float* powers = fit + n_chan;   // [T-1, C]
  const int c_own = i / n_pols;
  const int p = i - c_own * n_pols;
  float num = 0.0f, den = 0.0f;
  for (int c = 0; c < n_chan; ++c) {
    const float curve = forced_curve(c, terms, 1, powers, n_chan, n_terms - 1);
    const float wc = __fmul_rn(w[c], curve);
    const float v = scaled(c * n_pols + p);
    num = c == 0 ? __fmul_rn(wc, v) : __fmaf_rn(wc, v, num);
    den = c == 0 ? __fmul_rn(wc, curve) : __fmaf_rn(wc, curve, den);
  }
  const float amp = __fdiv_rn(num, fmaxf(den, kTiny));
  return __fmul_rn(
      forced_curve(c_own, terms, 1, powers, n_chan, n_terms - 1), amp);
}

// The slice's state: in shared memory (stride = slice) or in place in
// global memory (stride = K), indexed by the candidate's place in the slice.
struct State {
  float* res;
  const int* xs;
  const int* ys;
  const float* rms;    // null without an rms factor
  const float* terms;  // kFitForced: [T-1] rows, else null
  int64_t stride;
  int first;  // the slice's first candidate
  int len;    // candidates in the slice
};

// One pass over the slice: with kSubtract step 6, then steps 1-2 for every
// candidate; returns this thread's best.  (oy, ox) is the PSF centre minus
// the component's position.  The PSF values of kPlanes planes are gathered
// before any of them is used; each candidate's planes are still taken in
// plane order.  The cluster route (kPlanes 1) keeps a loop of its own: in
// the general form its tile axis ran 4-5% slower (PERF.md).
template <bool kSubtract, int kPlanes>
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
    if constexpr (kPlanes == 1) {
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
    } else {
      for (int i0 = 0; i0 < n_images; i0 += kPlanes) {
        float p[kPlanes][kUnroll];
        if (kSubtract) {
#pragma unroll
          for (int q = 0; q < kPlanes; ++q) {
            if (i0 + q >= n_images) break;
            const float* psf_plane = psf + ((i0 + q) / n_pols) * plane;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
              p[q][u] = inside[u] ? psf_plane[src[u]] : 0.0f;
          }
        }
#pragma unroll
        for (int q = 0; q < kPlanes; ++q) {
          const int i = i0 + q;
          if (i >= n_images) break;
          const float c = s_coef[i];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (!live[u]) continue;
            float* r = st.res + i * st.stride + (base + u * n_threads);
            float v = *r;
            if (kSubtract) {
              v = __fmaf_rn(-p[q][u], cv[i], v);
              *r = v;
            }
            s[u] = i == 0 ? __fmul_rn(v, c) : __fmaf_rn(v, c, s[u]);
          }
        }
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

template <bool kGrid, bool kOnChip, bool kShipRaw, int kFit>
__global__ void __launch_bounds__(kMaxThreads)
    subminor_loop_kernel(float* __restrict__ res, float* __restrict__ model,
                         const float* __restrict__ rms,
                         const int* __restrict__ xs,
                         const int* __restrict__ ys,
                         const float* __restrict__ psf,
                         const float* __restrict__ coef,
                         const float* __restrict__ fit_consts,
                         int n_terms,
                         const float* __restrict__ terms,
                         const int* __restrict__ offsets,
                         int* __restrict__ workspace,
                         int* __restrict__ out, int n_images, int n_pols,
                         int k, int slice, int height, int width,
                         float threshold, float gain, int start_iteration,
                         int max_iterations, float divergence_limit,
                         int allow_negative, int stop_on_negative) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  // The block's slice and the slices of the loop: the cluster's ranks, or
  // on the grid route every block of the launch.
  const int rank = kGrid ? static_cast<int>(blockIdx.x)
                         : static_cast<int>(cluster.block_rank());
  const int n_slices = kGrid ? static_cast<int>(gridDim.x) : n_ranks;
  constexpr int kPlanes = kGrid ? kGridPlanes : 1;
  __shared__ Shared sh;
  // Per plane: the integration coefficient, the gain-scaled residual value
  // at the component and the component value after the spectral fit; the
  // fit's constants and the owner's scratch; with kGrid the copy of an
  // iteration's G slots; then, with kOnChip, the slice's residual [N,
  // slice], xs, ys, rms and forced terms [T-1, slice].
  extern __shared__ float dyn[];
  const int n_chan = n_images / n_pols;
  const int n_forced = kFit == kFitForced ? n_terms - 1 : 0;
  float* const s_coef = dyn;
  float* const s_raw = dyn + n_images;
  float* const s_cv = dyn + 2 * n_images;
  // kFit above the projection: the constants, then the scratch.
  float* const s_fit = dyn + 3 * n_images;
  float* const s_scratch = s_fit + fit_constant_floats(kFit, n_chan, n_terms);
  Slot* const s_slots = reinterpret_cast<Slot*>(
      s_fit + fit_shared_floats(kFit, n_images, n_chan, n_terms));
  // The projection, read from global memory, or null.
  const float* const proj = kFit == kFitProjection ? fit_consts : nullptr;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = n_threads >> 5;
  const int64_t plane = static_cast<int64_t>(height) * width;
  // The grid route's workspace (kernels/subminor_loop.py::
  // grid_workspace_words): the slots [2][kSlotWords][G], the owner's cv [N]
  // and the winner's (x, y); and the words of a slot that travel.
  int* const g_slots = workspace;
  float* const g_cv =
      reinterpret_cast<float*>(g_slots + 2 * kSlotWords * n_slices);
  int* const g_pos = reinterpret_cast<int*>(g_cv + n_images);
  const int slot_words = kShipRaw ? 5 + n_images + n_forced : 3;

  // This cluster's segment of the tile axis: k stays the state's row
  // stride, seg its candidate count.
  int seg = k;
  if (offsets) {
    const int tile = blockIdx.x / n_ranks;
    const int begin = offsets[tile];
    seg = offsets[tile + 1] - begin;
    res += begin;
    model += begin;
    xs += begin;
    ys += begin;
    if (rms) rms += begin;
    if (terms) terms += begin;
    out += 3 * tile;
  }

  State st;
  st.first = rank * slice;
  st.len = min(slice, seg - st.first);
  if (st.len < 0) st.len = 0;
  if constexpr (kOnChip) {
    float* const c_res = reinterpret_cast<float*>(s_slots) +
                         (kGrid ? kSlotWords * n_slices : 0);
    int* const c_xs = reinterpret_cast<int*>(
        c_res + static_cast<int64_t>(n_images) * slice);
    int* const c_ys = c_xs + slice;
    float* const c_rms = reinterpret_cast<float*>(c_ys + slice);
    float* const c_terms = c_rms + slice;
    for (int jj = tid; jj < st.len; jj += n_threads) {
      const int j = st.first + jj;
      c_xs[jj] = xs[j];
      c_ys[jj] = ys[j];
      if (rms) c_rms[jj] = rms[j];
      for (int i = 0; i < n_images; ++i)
        c_res[static_cast<int64_t>(i) * slice + jj] =
            res[static_cast<int64_t>(i) * k + j];
      for (int t = 0; t < n_forced; ++t)
        c_terms[static_cast<int64_t>(t) * slice + jj] =
            terms[static_cast<int64_t>(t) * k + j];
    }
    st.res = c_res;
    st.xs = c_xs;
    st.ys = c_ys;
    st.rms = rms ? c_rms : nullptr;
    st.terms = n_forced ? c_terms : nullptr;
    st.stride = slice;
  } else {
    st.res = res + st.first;
    st.xs = xs + st.first;
    st.ys = ys + st.first;
    st.rms = rms ? rms + st.first : nullptr;
    st.terms = n_forced ? terms + st.first : nullptr;
    st.stride = k;
  }
  for (int i = tid; i < n_images; i += n_threads) s_coef[i] = coef[i];
  if constexpr (kFit != kFitProjection) {
    const int n_consts = fit_constant_floats(kFit, n_chan, n_terms);
    for (int i = tid; i < n_consts; i += n_threads) s_fit[i] = fit_consts[i];
  }
  // Every block of the cluster runs before any writes into another; the
  // grid route writes into no other block.
  if constexpr (kGrid)
    __syncthreads();
  else
    cluster_barrier(cluster, n_ranks);

  // The first argmax, over the unchanged state.
  Best best = sweep<false, kPlanes>(st, psf, plane, s_coef, nullptr,
                                    n_images, n_pols, 0, 0, height, width,
                                    allow_negative);
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
      if constexpr (kGrid) {
        // Lane f writes word f of this block's slot into the workspace:
        // cmp, idx, val, then x, y, the raw values and the forced terms.
        if (lane < slot_words) {
          int word = 0;
          if (lane == 0) {
            word = __float_as_int(best.cmp);
          } else if (lane == 1) {
            word = best.idx;
          } else if (lane == 2) {
            word = __float_as_int(best.val);
          } else if (st.len > 0) {
            const int at = best.idx == INT_MAX ? 0 : best.idx - st.first;
            if (lane == 3)
              word = st.xs[at];
            else if (lane == 4)
              word = st.ys[at];
            else if (lane < 5 + n_images)
              word = __float_as_int(st.res[(lane - 5) * st.stride + at]);
            else
              word = __float_as_int(
                  st.terms[(lane - 5 - n_images) * st.stride + at]);
          }
          g_slots[(parity * kSlotWords + lane) * n_slices + rank] = word;
        }
      } else if (lane < n_ranks) {
        // Lane r writes it into block r's slot for this block.
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
          for (int t = 0; t < n_forced; ++t)
            slot->terms[t] = st.terms[t * st.stride + at];
        }
      }
    }
    const Slot* slots;
    if constexpr (kGrid) {
      cg::this_grid().sync();
      // The iteration's G slots into this block's copy, in one coalesced
      // round of L2 reads: word f of slot g to its place in Slot g.
      const int* from = g_slots + parity * kSlotWords * n_slices;
      int* const to = reinterpret_cast<int*>(s_slots);
      for (int w = tid; w < slot_words * n_slices; w += n_threads) {
        const int f = w / n_slices;
        const int g = w - f * n_slices;
        const int field =
            f < 5 + n_images ? f : f - n_images + kShipMax;
        to[g * kSlotWords + field] = __ldcg(from + f * n_slices + g);
      }
      __syncthreads();
      slots = s_slots;
    } else {
      cluster_barrier(cluster, n_ranks);
      slots = sh.slots[parity];
    }

    // The loop's argmax from the slots; the same in every block.
    const float* cv;
    int wx, wy;
    if (kShipRaw || warp == 0) {
      Best win{-INFINITY, INT_MAX, 0.0f};
      if constexpr (kGrid) {
        for (int r = lane; r < n_slices; r += 32) {
          const Slot& s = slots[r];
          if (better(s.cmp, s.idx, win)) win = Best{s.cmp, s.idx, s.val};
        }
      } else if (lane < n_ranks) {
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
        const Slot& ws = kGrid ? slots[owner] : sh.slots[parity][owner];
        if (lane < n_images) {
          const auto scaled = [&](int q) { return __fmul_rn(ws.raw[q], gain); };
          float v;
          if constexpr (kFit == kFitProjection)
            v = component_value(lane, scaled, proj, n_pols, n_chan);
          else if constexpr (kFit == kFitLogPolynomial)
            v = log_polynomial_value(lane, scaled, s_fit, n_pols, n_chan,
                                     n_terms);
          else
            v = forced_value(lane, scaled, ws.terms, s_fit, n_pols, n_chan,
                             n_terms);
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
          for (int i = lane; i < n_images; i += 32) {
            const float v = __fmul_rn(st.res[i * st.stride + at], gain);
            s_raw[i] = v;
            if constexpr (kFit == kFitLogPolynomial)
              s_scratch[i] = logf(fmaxf(fabsf(v), kTiny));
          }
          if constexpr (kFit == kFitForced) {
            const float* own = n_forced ? st.terms + at : nullptr;
            for (int c = lane; c < n_chan; c += 32)
              s_scratch[c] = forced_curve(c, own, st.stride, s_fit + n_chan,
                                          n_chan, n_forced);
          }
          __syncwarp();
          // Each polarization's sign and coefficients, or its amplitude.
          if constexpr (kFit == kFitLogPolynomial) {
            const float* fit_m = s_fit;
            const float* wbar = s_fit + 2 * n_terms * n_chan;
            const float* logs = s_scratch;
            for (int p = lane; p < n_pols; p += 32) {
              float* pol = s_scratch + n_images + p * (n_terms + 1);
              float mean = __fmul_rn(wbar[0], s_raw[p]);
              for (int c = 1; c < n_chan; ++c)
                mean = __fmaf_rn(wbar[c], s_raw[c * n_pols + p], mean);
              pol[0] = mean < 0.0f ? -1.0f : 1.0f;
              for (int t = 0; t < n_terms; ++t) {
                const float* row = fit_m + t * n_chan;
                float cf = __fmul_rn(row[0], logs[p]);
                for (int c = 1; c < n_chan; ++c)
                  cf = __fmaf_rn(row[c], logs[c * n_pols + p], cf);
                pol[1 + t] = cf;
              }
            }
          } else if constexpr (kFit == kFitForced) {
            const float* w = s_fit;
            const float* curve = s_scratch;
            for (int p = lane; p < n_pols; p += 32) {
              float num = 0.0f, den = 0.0f;
              for (int c = 0; c < n_chan; ++c) {
                const float wc = __fmul_rn(w[c], curve[c]);
                const float v = s_raw[c * n_pols + p];
                num = c == 0 ? __fmul_rn(wc, v) : __fmaf_rn(wc, v, num);
                den = c == 0 ? __fmul_rn(wc, curve[c])
                             : __fmaf_rn(wc, curve[c], den);
              }
              s_scratch[n_chan + p] = __fdiv_rn(num, fmaxf(den, kTiny));
            }
          }
          if constexpr (kFit != kFitProjection) __syncwarp();
          for (int i = lane; i < n_images; i += 32) {
            float v;
            if constexpr (kFit == kFitProjection) {
              v = component_value(i, [&](int q) { return s_raw[q]; }, proj,
                                  n_pols, n_chan);
            } else {
              const int c = i / n_pols;
              const int p = i - c * n_pols;
              if constexpr (kFit == kFitLogPolynomial) {
                const float* design = s_fit + n_terms * n_chan;
                const float* pol = s_scratch + n_images + p * (n_terms + 1);
                float e = __fmul_rn(design[c * n_terms], pol[1]);
                for (int t = 1; t < n_terms; ++t)
                  e = __fmaf_rn(design[c * n_terms + t], pol[1 + t], e);
                v = __fmul_rn(pol[0], expf(e));
              } else {
                v = __fmul_rn(s_scratch[c], s_scratch[n_chan + p]);
              }
            }
            float* mo = model + static_cast<int64_t>(i) * k + m;
            *mo = __fadd_rn(*mo, v);
            if constexpr (kGrid) {
              g_cv[i] = v;
            } else {
              for (int r = 0; r < n_ranks; ++r)
                cluster.map_shared_rank(s_cv, r)[i] = v;
            }
          }
          if constexpr (kGrid) {
            if (lane == 0) {
              g_pos[0] = st.xs[at];
              g_pos[1] = st.ys[at];
            }
          } else if (lane < n_ranks) {
            Shared* other = cluster.map_shared_rank(&sh, lane);
            other->x = st.xs[at];
            other->y = st.ys[at];
          }
        }
        if (lane == 0) sh.go = go;
      }
    }
    if constexpr (!kShipRaw) {
      if constexpr (kGrid) {
        cg::this_grid().sync();
        if (!sh.go) break;
        for (int i = tid; i < n_images; i += n_threads)
          s_cv[i] = __ldcg(g_cv + i);
        if (tid == 0) {
          sh.x = __ldcg(g_pos);
          sh.y = __ldcg(g_pos + 1);
        }
        __syncthreads();
      } else {
        cluster_barrier(cluster, n_ranks);
        if (!sh.go) break;
      }
      cv = s_cv;
      wx = sh.x;
      wy = sh.y;
    }

    // Steps 6 and 1-2: subtract the component's PSF at every candidate of
    // the slice and integrate the new values.
    best = sweep<true, kPlanes>(st, psf, plane, s_coef, cv, n_images, n_pols,
                                height / 2 - wy, width / 2 - wx, height,
                                width, allow_negative);
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

// The instantiation for a launch's route, state place, exchange and fit.
template <bool kGrid, bool kOnChip, bool kShipRaw>
const void* kernel_for(int fit_mode) {
  switch (fit_mode) {
    case kFitLogPolynomial:
      return reinterpret_cast<const void*>(
          &subminor_loop_kernel<kGrid, kOnChip, kShipRaw, kFitLogPolynomial>);
    case kFitForced:
      return reinterpret_cast<const void*>(
          &subminor_loop_kernel<kGrid, kOnChip, kShipRaw, kFitForced>);
    default:
      return reinterpret_cast<const void*>(
          &subminor_loop_kernel<kGrid, kOnChip, kShipRaw, kFitProjection>);
  }
}

template <bool kGrid>
const void* kernel_for(bool on_chip, bool ship_raw, int fit_mode) {
  return on_chip ? (ship_raw ? kernel_for<kGrid, true, true>(fit_mode)
                             : kernel_for<kGrid, true, false>(fit_mode))
                 : (ship_raw ? kernel_for<kGrid, false, true>(fit_mode)
                             : kernel_for<kGrid, false, false>(fit_mode));
}

}  // namespace

extern "C" {

// cluster_size, threads, slice, on_chip, ship_raw, shared_bytes and
// grid_blocks are the plan of kernels/subminor_loop.py::cluster_plan.
// fit_mode is a FitMode; fit_consts is the projection [C, C] (or null: no
// fit) or the other fits' packed constants, n_terms their T, and terms the
// forced terms [T-1, k] of the candidates.  offsets, null for one segment
// of k candidates, holds the n_tiles + 1 segment bounds of the tile axis; k
// is then their total, and out holds n_tiles results.  grid_blocks > 0
// takes the grid route: that many blocks (cluster_size 1) in one
// cooperative launch, with workspace the grid's words (2 * kSlotWords *
// grid_blocks + n_images + 2 ints).
int subminor_loop(float* res, float* model, const float* rms, const int* xs,
                  const int* ys, const float* psf, const float* coef,
                  int fit_mode, const float* fit_consts, int n_terms,
                  const float* terms, const int* offsets, int n_tiles,
                  int* out, int n_images, int n_pols,
                  int k, int height, int width, float threshold, float gain,
                  int start_iteration, int max_iterations,
                  float divergence_limit, int allow_negative,
                  int stop_on_negative, int cluster_size, int threads,
                  int slice, int on_chip, int ship_raw, int shared_bytes,
                  int grid_blocks, int* workspace, void* stream) {
  const bool grid = grid_blocks > 0;
  const bool fitted = fit_mode == kFitLogPolynomial || fit_mode == kFitForced;
  const int n_forced = fit_mode == kFitForced ? n_terms - 1 : 0;
  const int n_chan = n_pols > 0 ? n_images / n_pols : 0;
  const int64_t needed =
      4 * (3 * static_cast<int64_t>(n_images) +
           fit_shared_floats(fit_mode, n_images, n_chan, n_terms) +
           (grid ? static_cast<int64_t>(kSlotWords) * grid_blocks : 0) +
           (on_chip ? static_cast<int64_t>(slice) *
                          (n_images + 3 + n_forced)
                    : 0));
  const int blocks = grid ? grid_blocks : cluster_size;
  if (n_images < 1 || n_images > kMaxImages || n_pols < 1 ||
      n_images % n_pols != 0 || k < 1 || cluster_size < 1 ||
      cluster_size > kMaxCluster || (cluster_size & (cluster_size - 1)) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      slice < 1 ||
      (!offsets && static_cast<int64_t>(slice) * blocks < k) ||
      fit_mode < kFitNone || fit_mode > kFitForced ||
      (fit_mode == kFitNone && fit_consts) ||
      (fitted && (n_terms < 1 || !fit_consts)) ||
      (n_forced > 0 && !terms) ||
      (ship_raw && (n_images > kShipMax || n_forced > kShipTerms)) ||
      shared_bytes < needed ||
      n_tiles < 1 || (!offsets && n_tiles != 1) ||
      static_cast<int64_t>(n_tiles) * cluster_size > INT_MAX ||
      grid_blocks < 0 ||
      (grid && (offsets || !workspace || cluster_size != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = grid ? kernel_for<true>(on_chip, ship_raw, fit_mode)
                            : kernel_for<false>(on_chip, ship_raw, fit_mode);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      cluster_size > 8 ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attribute;
  if (grid) {
    // Every block of the grid resident at once, or the launch fails: the
    // multiprocessors times the blocks each holds at this shared memory
    // and these threads.
    int per_sm = 0, device = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (static_cast<int64_t>(per_sm) * sms < grid_blocks)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    attribute.id = cudaLaunchAttributeCooperative;
    attribute.val.cooperative = 1;
  } else {
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = cluster_size;
    attribute.val.clusterDim.y = 1;
    attribute.val.clusterDim.z = 1;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid ? grid_blocks : cluster_size * n_tiles);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attribute;
  config.numAttrs = 1;
  if (!grid) {
    // The card must be able to run a whole cluster at once (not every
    // cluster of the tile axis: they wait for one another in nothing).
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }

  void* args[] = {&res,        &model,
                  &rms,        &xs,
                  &ys,         &psf,
                  &coef,       &fit_consts,
                  &n_terms,    &terms,
                  &offsets,    &workspace,
                  &out,
                  &n_images,
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
