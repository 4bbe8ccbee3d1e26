// Fused closed-loop MPC: T receding-horizon steps for a batch of plants in
// one launch, box constraints, fixed rho.
//
// Replaces the TPU kernel tinympc_tpu/kernels/closed_loop_pallas.py:_kernel
// (launched by closed_loop_fused). For every plant and every step: a
// warm-started ADMM solve on the window Xref_total[step : step+N] (the
// iteration of admm_group.cuh), then the applied input u0 -- the raw
// forward-pass u[0] of the converging iteration, or of the last one for a
// plant that ran out of iterations -- steps the plant x+ = A x + B u0 + f.
// Options: reset_duals zeroes g and y before each solve; shift_warm drops
// row 0 of every carried array and repeats the last row after each solve.
//
// What bounds it on an H100: operations. The serving loop (nx=12, nu=4,
// N=10, B=16384 plants, T=50, ~14.9 mean iterations a step) does ~4.5k FMA
// a plant and iteration, 1.9868 ms at the FP32 peak of 67 TFLOP/s; its
// bytes (x0, the reference, the outputs) take ~0.06 ms. The first design
// (one thread a plant, 32 a block, trajectories lane-last in device memory)
// took 41.3163 ms on an NVIDIA H100 80GB HBM3 at 700 W: ~4 warps an SM,
// each thread running every iteration's serial chain of 16-row matvecs
// alone, latency-bound.
//
// Design (admm_group.cuh, as the resident solve in admm_group.cu):
//   * One plant a group of G threads (16 at (12, 4): a thread a row), P
//     plants a block (8 for the serving loop: 128 threads, 2048 blocks at
//     B=16384). Each thread keeps its rows of the matrices in registers.
//   * A plant's trajectories stay in shared memory for all T steps: the
//     slack, dual and stale (saved) columns and the feedforward. Iteration
//     0 of a step compares against the stale slack (closed_loop_pallas.py:
//     216-217); a later check iteration saves the slack it overwrites, so
//     after the step the saved column holds what the next step's iteration
//     0 compares against: the previous slack of the converging iteration,
//     unchanged if that was iteration 0, or -- copied from the slack -- the
//     last slack of a plant that ran out (:255-290). One copy of each
//     slack, no ping-pong, no end-of-step copy but that one.
//   * The packed table (the matrices, the bounds) and the reference
//     trajectory sit in shared memory beside the arena when they fit (the
//     serving loop's N=10, T=50 with room to spare); past that, both are
//     read from device memory, and past N = 1117 the saved columns too
//     (Place, admm_group.cuh), as in admm_group.cu. Plants are at
//     different iterations, so the per-step terms -(Xref .* Q) and
//     -Pinf^T Xref[step+N-1] are formed per row from the trajectory. The
//     plant step takes u0 from the input rows through the group's
//     exchange slot.
//   * The groups of a warp keep to one step and one iteration: a converged
//     plant skips the iteration, and the warp leaves the step's loop on a
//     check iteration once all of its plants have converged (a vote). A
//     plant's result never depends on its neighbours.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6): the
// serving loop 14.4464-14.7915 ms in turns with the first design's
// 38.3238-39.2950 (chip_compare.py time), bitwise the first design's.
//
// C interface (loaded with ctypes): tinympc_closed_loop_fused_box returns
// the cudaError_t of the launch; it launches on the given stream and never
// synchronises.
#include "admm_group.cuh"

namespace {

using tinympc::GroupArena;
using tinympc::GroupSweep;
using tinympc::Layout;
using tinympc::Residuals;

using tinympc::Place;

constexpr int kGroup = 16;         // threads a plant: a row each at (12, 4)
constexpr int kMaxThreads = 128;   // P * kGroup
// Blocks an SM must hold: the register budget (5: at most 102 registers a
// thread; at 6, 85, ptxas spills).
constexpr int kMinBlocks = 5;
constexpr size_t kMaxSmem = 232448;

// PLACE (tinympc::Place): kShared copies the packed table and the
// reference trajectory into shared memory (their reads are then
// shared-memory loads); kTableGlobal reads both in device memory;
// kSavedGlobal also keeps the saved columns in `saved`, (grid, N,
// P * (NX + NU)).
template <int NX, int NU, int PLACE>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) closed_loop_group_kernel(
    const float* __restrict__ tables, const float* __restrict__ xref_total,
    const float* __restrict__ x0, float* __restrict__ out_xs,
    float* __restrict__ out_us, int* __restrict__ out_iters,
    unsigned char* __restrict__ out_solved, int N, int B, int T,
    int max_iter, int check_termination, float rho, float tol_pri,
    float tol_dua, bool reset_duals, bool shift_warm, int P,
    float* __restrict__ saved) {
  constexpr int G = kGroup;
  using Sweep = GroupSweep<NX, NU, G>;
  constexpr int R = Sweep::R;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Layout L(NX, NU, N);
  const float* tab = tables;
  const float* xtot = xref_total;
  float* arena = sm;
  if constexpr (PLACE == Place::kShared) {
    const int nref = (T + N - 1) * NX;
    for (int k = threadIdx.x; k < L.total; k += blockDim.x) sm[k] = tables[k];
    for (int k = threadIdx.x; k < nref; k += blockDim.x)
      sm[L.total + k] = xref_total[k];
    tab = sm;
    xtot = sm + L.total;
    arena = sm + tinympc::align4(L.total + nref);
  }
  float* vg = nullptr;
  if constexpr (PLACE == Place::kSavedGlobal)
    vg = saved + blockIdx.x * GroupArena<NX, NU>::saved_floats(N, P);
  __syncthreads();
  const int p = threadIdx.x / G, g = threadIdx.x % G;
  const int b = blockIdx.x * P + p;
  const bool plant = b < B;
  Sweep sw(tab, L, arena, N, P, p, g, PLACE != Place::kSavedGlobal, vg);
  const size_t sB = static_cast<size_t>(B);
  // The lanes of this thread's warp: the vote below needs all of them.
  const int wbase = threadIdx.x & ~31;
  const int wsize = min(32, static_cast<int>(blockDim.x) - wbase);
  const unsigned warp = wsize == 32 ? 0xffffffffu : (1u << wsize) - 1;

  // Cold start (closed_loop_pallas.py:135-138): slacks, duals and the
  // stale slacks zero.
  float x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x[r] = (plant && sw.state(r)) ? x0[static_cast<size_t>(b) * NX + sw.feat[r]]
                               : 0.f;
    if (plant)
      for (int i = 0; i < sw.rows(r, N); ++i)
        sw.slack(r, i) = sw.dual(r, i) = sw.saved(r, i) = 0.f;
  }

  for (int step = 0; step < T; ++step) {
    // Per-step set-up (closed_loop_pallas.py:140-156): the window, the
    // terminal reference term, and the optional dual reset before the
    // terminal carry term is formed.
    const float* xwin = xtot + static_cast<size_t>(step) * NX;
    float pt0[R], dvgN[R], u0[R];
    if (plant) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (sw.state(r)) sw.ref[r] = xwin + sw.feat[r];
        pt0[r] = sw.state(r) ? sw.pnref(r, tab + L.pinft, xwin + (N - 1) * NX)
                          : 0.f;
        if (reset_duals)
          for (int i = 0; i < sw.rows(r, N); ++i) sw.dual(r, i) = 0.f;
        dvgN[r] = sw.state(r) ? sw.slack(r, N - 1) - sw.dual(r, N - 1) : 0.f;
      }
    }
    bool done = !plant;
    int iters = 0;
    for (int it = 0; it < max_iter; ++it) {
      const bool checking = ((it + 1) % check_termination) == 0;
      if (!done) {
        float pt[R];
#pragma unroll
        for (int r = 0; r < R; ++r) pt[r] = pt0[r] - rho * dvgN[r];
        sw.backward(N, rho, pt);
        const Residuals rr =
            sw.template forward<true>(N, x, dvgN, checking, it == 0, u0);
        iters = it + 1;
        if (checking)
          done = (rr.pri_s < tol_pri) && (rr.pri_i < tol_pri) &&
                 (rr.dua_s * rho < tol_dua) && (rr.dua_i * rho < tol_dua);
      }
      if (checking && !__any_sync(warp, !done)) break;
    }
    if (!plant) continue;

    // End-of-step merge (closed_loop_pallas.py:255-290): a plant that ran
    // out hands its last slack to the next step's iteration 0; then the
    // optional shift of every carried column.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = sw.rows(r, N);
      if (!done)
        for (int i = 0; i < n; ++i) sw.saved(r, i) = sw.slack(r, i);
      if (shift_warm)
        for (int i = 0; i + 1 < n; ++i) {
          sw.slack(r, i) = sw.slack(r, i + 1);
          sw.dual(r, i) = sw.dual(r, i + 1);
          sw.saved(r, i) = sw.saved(r, i + 1);
        }
    }

    // Record (:292-296), then step the plant with the applied input:
    // x+ = (A x + B u0) + f, its rows from the state threads' registers.
    const size_t o = static_cast<size_t>(step) * sB + b;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (sw.state(r)) {
        out_xs[o * NX + sw.feat[r]] = x[r];
        sw.X[sw.feat[r]] = x[r];
      } else {
        out_us[o * NU + sw.feat[r]] = u0[r];
        sw.X[NX + sw.feat[r]] = u0[r];
      }
    }
    if (g == 0) {
      out_iters[o] = iters;
      out_solved[o] = done ? 1 : 0;
    }
    sw.sync();
    float xv[NX], uv[NU];
    Sweep::load(xv, sw.X);
    Sweep::load(uv, sw.X + NX);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (sw.state(r)) x[r] = Sweep::dot(sw.f1[r], xv) + Sweep::dot(sw.bm[r], uv)
                           + sw.fv[r];
    sw.sync();
  }
}

// Shared memory of a launch: the table and the reference (kShared) and the
// arena of P plants, with the saved columns but at kSavedGlobal.
template <int NX, int NU>
size_t smem_bytes(int N, int T, int P, int place) {
  const int table = place == Place::kShared
                        ? tinympc::align4(Layout(NX, NU, N).total +
                                          (T + N - 1) * NX)
                        : 0;
  return (table + GroupArena<NX, NU>::floats(
                      N, P, place != Place::kSavedGlobal)) *
         sizeof(float);
}

template <int NX, int NU>
cudaError_t launch(const float* tables, const float* xref_total,
                   const float* x0, float* out_xs, float* out_us,
                   int* out_iters, unsigned char* out_solved, int N, int B,
                   int T, int max_iter, int ct, float rho, float tol_pri,
                   float tol_dua, bool reset_duals, bool shift_warm, int P,
                   int place, float* saved, cudaStream_t stream) {
  if (P < 1 || P * kGroup > kMaxThreads) return cudaErrorInvalidValue;
  if (place == Place::kSavedGlobal ? !saved
                                   : place != Place::kShared &&
                                         place != Place::kTableGlobal)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<NX, NU>(N, T, P, place);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel =
      place == Place::kShared
          ? closed_loop_group_kernel<NX, NU, Place::kShared>
          : place == Place::kTableGlobal
                ? closed_loop_group_kernel<NX, NU, Place::kTableGlobal>
                : closed_loop_group_kernel<NX, NU, Place::kSavedGlobal>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + P - 1) / P);
  kernel<<<grid, P * kGroup, smem, stream>>>(
      tables, xref_total, x0, out_xs, out_us, out_iters, out_solved, N, B,
      T, max_iter, ct, rho, tol_pri, tol_dua, reset_duals, shift_warm, P,
      saved);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tinympc_closed_loop_fused_max_threads() { return kMaxThreads; }
extern "C" int tinympc_closed_loop_fused_width() { return kGroup; }
// Bytes of shared memory of a launch at (N, T, P, place) at (12, 4); the
// wrapper holds its own geometry against it.
extern "C" long long tinympc_closed_loop_fused_smem(int N, int T, int P,
                                                    int place) {
  return static_cast<long long>(smem_bytes<12, 4>(N, T, P, place));
}

// Returns 0 on success, a cudaError_t otherwise; cudaErrorInvalidValue for
// an (nx, nu) this file does not instantiate or a bad size or geometry.
// problems: P, plants a block (P * 16 <= 128); place: a tinympc::Place,
// with `saved` a (ceil(B / P), N, P * (nx + nu)) float buffer at
// kSavedGlobal (else unused). xref_total is (T + N - 1, nx); x0 (B, nx);
// outputs xs (T, B, nx), us (T, B, nu), iters (T, B) int32, solved (T, B)
// uint8.
extern "C" int tinympc_closed_loop_fused_box(
    int nx, int nu, int problems, int place, int N, int B, int T,
    int max_iter, int check_termination, float rho, float tol_pri,
    float tol_dua, int reset_duals, int shift_warm, const void* tables,
    const void* xref_total, const void* x0, void* out_xs, void* out_us,
    void* out_iters, void* out_solved, void* saved, void* stream) {
  if (N < 2 || B < 1 || T < 1 || max_iter < 1 || check_termination < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nx != 12 || nu != 4)   // the quadrotor of the serving loop
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<12, 4>(
      static_cast<const float*>(tables),
      static_cast<const float*>(xref_total), static_cast<const float*>(x0),
      static_cast<float*>(out_xs), static_cast<float*>(out_us),
      static_cast<int*>(out_iters), static_cast<unsigned char*>(out_solved),
      N, B, T, max_iter, check_termination, rho, tol_pri, tol_dua,
      reset_duals != 0, shift_warm != 0, problems, place,
      static_cast<float*>(saved), static_cast<cudaStream_t>(stream)));
}
