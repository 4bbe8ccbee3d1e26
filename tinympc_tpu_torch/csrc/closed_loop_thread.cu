// Fused closed-loop MPC on one thread a plant: T receding-horizon steps for
// a batch of plants in one launch, box constraints, fixed rho, at the
// (nx, nu) pairs that have no thread-group loop: the rocket's (6, 3),
// cartpole's (4, 1) and the degenerate (2, 2), (2, 1), (3, 3), (1, 1).
// (12, 4) is instantiated too, only to hold this design against the group
// loop of closed_loop_fused.cu on one card; no user call reaches it.
//
// Replaces the TPU kernel tinympc_tpu/kernels/closed_loop_pallas.py:_kernel
// (launched by closed_loop_fused) at those pairs. For every plant and every
// step: a warm-started ADMM solve on the window Xref_total[step : step+N]
// (the iteration of admm_sweep.cuh), then the applied input u0 -- the raw
// forward-pass u[0] of the converging iteration, or of the last one for a
// lane that ran out of iterations -- steps the plant x+ = A x + B u0 + f.
// Options: reset_duals zeroes g and y before each solve; shift_warm drops
// row 0 of every carried array and repeats the last row after each solve.
//
// Design (the closed loop's first design, kept for the small pairs):
//   * One thread per plant runs all T steps, and inside each step its own
//     ADMM loop until it converges or reaches max_iter. A lane's result
//     never depends on its neighbours (the TPU kernel freezes converged
//     lanes by snapshot), so no block-wide exit or barrier is needed after
//     the tables are loaded.
//   * The shared matrices, the bounds and the reference trajectory (when it
//     fits) sit in shared memory. Threads are at different steps, so the
//     per-step terms -(Xref .* Q) and -Pinf^T Xref[step+N-1] are formed per
//     thread from the trajectory (NegRefWindow), never as one block-wide
//     table per step.
//   * The plant state x, the applied input u0, the terminal term
//     vnew[N-1] - g[N-1] and -Pinf^T Xref[step+N-1] live in registers.
//   * Per-lane trajectories live lane-last in device memory: vnew
//     (2, N, nx, B), znew (2, N-1, nu, B), g, y, vstale, zstale, d. A
//     per-thread parity `c` names the half that holds the carried slack;
//     iteration `it` of a step writes half c^1^(it&1), so iteration 0 reads
//     the carried slack as "previous" and no end-of-step copy is needed.
//     vstale/zstale hold what iteration 0's dual residual compares against
//     (closed_loop_pallas.py:216-217): after a step, the previous slack of
//     the converging iteration, or the last half for a max-iter lane
//     (:255-290).
//   * 32 threads a block, so that B=16384 plants (512 warps) spread over
//     all 132 SMs.
//
// What bounds it on an H100: operations, by chip_smoke.loop_work's count
// (~1.4k FMA a plant and iteration at (6, 3), N=10; ~0.4k at (4, 1)): the
// rocket's serving loop (B=16384, T=90, 43.8 mean iterations a step) 3.65
// ms, cartpole's (T=50, 73.6 mean iterations) 1.32 ms. The kernel sits
// 15-25x above that: at B=16384 an SM holds ~4 warps of 32-thread blocks,
// too few to hide the serial chain of each iteration, and every iteration
// streams the lane's trajectories through L2. Measured on an NVIDIA H100
// 80GB HBM3 at 700.00 W (PERF.md, section 6): the rocket loop 57.3-109.7
// ms from process to process, cartpole 21.6-29.1 ms; the (12, 4) instance
// 34.0-36.9 ms in turns with the group loop's 14.6-14.9
// (closed_loop_fused.cu), bitwise its output.
//
// C interface (loaded with ctypes): tinympc_closed_loop_thread_box returns
// the cudaError_t of the launch; it launches on the given stream and never
// synchronises.
#include "admm_sweep.cuh"

namespace {

using tinympc::Layout;
using tinympc::NegRefWindow;
using tinympc::Residuals;
using tinympc::Tables;

constexpr int kBlock = 32;
constexpr size_t kMaxSmem = 232448;
// __launch_bounds__(kBlock, 1): with the block size alone ptxas held the
// (2, 2) instance to 96 registers and spilled 32 bytes; with one block an
// SM promised it takes what it needs (122-217 registers, no spill at any
// pair). 32-thread blocks leave registers for ~10 blocks an SM, more than
// the ~4 that B=16384 brings.

// Drop row 0 of lane b of a (rows, F, B) array and repeat the last row.
template <int F>
__device__ __forceinline__ void shift_lane(float* a, int rows, size_t sB,
                                           int b) {
  for (int i = 0; i + 1 < rows; ++i) {
#pragma unroll
    for (int k = 0; k < F; ++k)
      a[(static_cast<size_t>(i) * F + k) * sB + b] =
          a[(static_cast<size_t>(i + 1) * F + k) * sB + b];
  }
}

__device__ __forceinline__ void zero_lane(float* a, int n, size_t sB, int b) {
  for (int k = 0; k < n; ++k) a[static_cast<size_t>(k) * sB + b] = 0.f;
}

template <int NX, int NU>
__global__ void __launch_bounds__(kBlock, 1) closed_loop_thread_kernel(
    const float* __restrict__ tables, const float* __restrict__ xref_total,
    const float* __restrict__ x0, float* __restrict__ vnew,
    float* __restrict__ znew, float* __restrict__ g, float* __restrict__ y,
    float* __restrict__ vstale, float* __restrict__ zstale,
    float* __restrict__ d, float* __restrict__ out_xs,
    float* __restrict__ out_us, int* __restrict__ out_iters,
    unsigned char* __restrict__ out_solved, int N, int B, int T,
    int max_iter, int check_termination, float rho, float tol_pri,
    float tol_dua, bool reset_duals, bool shift_warm, bool xref_in_smem) {
  extern __shared__ float sm[];
  const Layout L(NX, NU, N);
  const int nref = (T + N - 1) * NX;
  for (int k = threadIdx.x; k < L.total; k += blockDim.x) sm[k] = tables[k];
  if (xref_in_smem)
    for (int k = threadIdx.x; k < nref; k += blockDim.x)
      sm[L.total + k] = xref_total[k];
  __syncthreads();
  // -(Uref .* R) in place (closed_loop_pallas.py:133).
  for (int k = threadIdx.x; k < (N - 1) * NU; k += blockDim.x)
    sm[L.uref + k] = -(sm[L.uref + k] * sm[L.rd + k % NU]);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;   // no barrier follows

  const Tables t(sm, L);
  const float* xtot = xref_in_smem ? sm + L.total : xref_total;
  const float* qd = sm + L.qd;
  const float* PinfT = sm + L.pinft;
  const float* A = t.Mfwd + NU * NX;     // rows NU.. of [Kinf; A]
  const size_t sB = static_cast<size_t>(B);
  const size_t half_x = static_cast<size_t>(N) * NX * sB;
  const size_t half_u = static_cast<size_t>(N - 1) * NU * sB;
  const int nvx = N * NX, nvu = (N - 1) * NU;

  // Cold start (closed_loop_pallas.py:135-138): the carried half 1, g, y
  // and the stale slacks are zero.
  int c = 1;
  zero_lane(vnew + half_x, nvx, sB, b);
  zero_lane(znew + half_u, nvu, sB, b);
  zero_lane(g, nvx, sB, b);
  zero_lane(y, nvu, sB, b);
  zero_lane(vstale, nvx, sB, b);
  zero_lane(zstale, nvu, sB, b);
  float x[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) x[k] = x0[static_cast<size_t>(b) * NX + k];

  for (int step = 0; step < T; ++step) {
    // Per-step set-up (closed_loop_pallas.py:140-156): the window, the
    // terminal reference term, done/iters, and the optional dual reset
    // before the terminal carry term is formed.
    const float* xwin = xtot + static_cast<size_t>(step) * NX;
    float pnref[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < NX; ++j)
        acc = fmaf(PinfT[k * NX + j], xwin[(N - 1) * NX + j], acc);
      pnref[k] = -acc;
    }
    if (reset_duals) {
      zero_lane(g, nvx, sB, b);
      zero_lane(y, nvu, sB, b);
    }
    float dvgN[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const size_t a = (static_cast<size_t>(N - 1) * NX + k) * sB + b;
      dvgN[k] = vnew[c * half_x + a] - g[a];
    }
    const NegRefWindow<NX> negxq{xwin, qd};
    bool done = false;
    int iters = 0;
    float u0[NU];
    for (int it = 0; it < max_iter; ++it) {
      const int cur = c ^ 1 ^ (it & 1);
      const bool checking = ((it + 1) % check_termination) == 0;
      const float* vprev = vnew + (cur ^ 1) * half_x;
      const float* zprev = znew + (cur ^ 1) * half_u;
      const Residuals r = tinympc::admm_iteration<NX, NU>(
          t, negxq, pnref, x, dvgN, vnew + cur * half_x, znew + cur * half_u,
          vprev, zprev, it == 0 ? vstale : vprev, it == 0 ? zstale : zprev,
          g, y, d, N, sB, b, rho, checking, u0);
      iters = it + 1;
      if (checking) {
        done = (r.pri_s < tol_pri) && (r.pri_i < tol_pri) &&
               (r.dua_s * rho < tol_dua) && (r.dua_i * rho < tol_dua);
        if (done) break;
      }
    }

    // End-of-step merge (closed_loop_pallas.py:255-290). The last-written
    // half becomes the carried slack. The stale slacks become the previous
    // slack of the converging iteration (unchanged if that was iteration
    // 0), or the last half for a max-iter lane.
    const int last = c ^ 1 ^ ((iters - 1) & 1);
    if (!done || iters > 1) {
      const int src = done ? last ^ 1 : last;
      tinympc::copy_lane(vstale, vnew + src * half_x, nvx, sB, b);
      tinympc::copy_lane(zstale, znew + src * half_u, nvu, sB, b);
    }
    c = last;
    if (shift_warm) {
      shift_lane<NX>(vnew + c * half_x, N, sB, b);
      shift_lane<NU>(znew + c * half_u, N - 1, sB, b);
      shift_lane<NX>(g, N, sB, b);
      shift_lane<NU>(y, N - 1, sB, b);
      shift_lane<NX>(vstale, N, sB, b);
      shift_lane<NU>(zstale, N - 1, sB, b);
    }

    // Record (:292-296), then step the plant with the applied input:
    // x+ = (A x + B u0) + f.
    const size_t o = static_cast<size_t>(step) * sB + b;
#pragma unroll
    for (int k = 0; k < NX; ++k) out_xs[o * NX + k] = x[k];
#pragma unroll
    for (int k = 0; k < NU; ++k) out_us[o * NU + k] = u0[k];
    out_iters[o] = iters;
    out_solved[o] = done ? 1 : 0;
    float xn[NX];
#pragma unroll
    for (int row = 0; row < NX; ++row) {
      float ax = 0.f, bu = 0.f;
#pragma unroll
      for (int cc = 0; cc < NX; ++cc) ax = fmaf(A[row * NX + cc], x[cc], ax);
#pragma unroll
      for (int cc = 0; cc < NU; ++cc) bu = fmaf(t.Bm[row * NU + cc], u0[cc], bu);
      xn[row] = ax + bu + t.fv[row];
    }
#pragma unroll
    for (int k = 0; k < NX; ++k) x[k] = xn[k];
  }
}

// Shared memory of a launch: the packed table, and the reference trajectory
// beside it where both fit (else the reference is read in device memory).
template <int NX, int NU>
size_t smem_bytes(int N, int T, bool* xref_in_smem) {
  const size_t base = Layout(NX, NU, N).total * sizeof(float);
  const size_t with_ref =
      base + static_cast<size_t>(T + N - 1) * NX * sizeof(float);
  *xref_in_smem = with_ref <= kMaxSmem;
  return *xref_in_smem ? with_ref : base;
}

template <int NX, int NU>
cudaError_t launch(const float* tables, const float* xref_total,
                   const float* x0, float* vnew, float* znew, float* g,
                   float* y, float* vstale, float* zstale, float* d,
                   float* out_xs, float* out_us, int* out_iters,
                   unsigned char* out_solved, int N, int B, int T,
                   int max_iter, int ct, float rho, float tol_pri,
                   float tol_dua, bool reset_duals, bool shift_warm,
                   cudaStream_t stream) {
  bool xref_in_smem = false;
  const size_t smem = smem_bytes<NX, NU>(N, T, &xref_in_smem);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = closed_loop_thread_kernel<NX, NU>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, smem, stream>>>(
      tables, xref_total, x0, vnew, znew, g, y, vstale, zstale, d, out_xs,
      out_us, out_iters, out_solved, N, B, T, max_iter, ct, rho, tol_pri,
      tol_dua, reset_duals, shift_warm, xref_in_smem);
  return cudaGetLastError();
}

// The (nx, nu) pairs this file instantiates, each as one line of X(NX, NU).
#define TINYMPC_LOOP_PAIRS(X)                                                 \
  X(6, 3)   /* the rocket (rocket_landing_mpc.cpp) */                         \
  X(4, 1)   /* cartpole (cartpole_example.cpp) */                             \
  X(2, 2)                                                                     \
  X(2, 1)                                                                     \
  X(3, 3)                                                                     \
  X(1, 1)   /* the degenerate pairs of tests/test_degenerate_dims.py */       \
  X(12, 4)  /* the A/B against the group loop only */

}  // namespace

extern "C" int tinympc_closed_loop_thread_block() { return kBlock; }

// 1 if this file instantiates (nx, nu), else 0; the wrapper holds its pair
// list against it.
extern "C" int tinympc_closed_loop_thread_has(int nx, int nu) {
#define TINYMPC_HAS(NX_, NU_) \
  if (nx == NX_ && nu == NU_) return 1;
  TINYMPC_LOOP_PAIRS(TINYMPC_HAS)
#undef TINYMPC_HAS
  return 0;
}

// Returns 0 on success, a cudaError_t otherwise; cudaErrorInvalidValue for
// an (nx, nu) pair this file does not instantiate or a bad size.
// xref_total is (T + N - 1, nx); x0 (B, nx); scratch vnew (2, N, nx, B),
// znew (2, N-1, nu, B), g/vstale (N, nx, B), y/zstale/d (N-1, nu, B);
// outputs xs (T, B, nx), us (T, B, nu), iters (T, B) int32, solved (T, B)
// uint8.
extern "C" int tinympc_closed_loop_thread_box(
    int nx, int nu, int N, int B, int T, int max_iter, int check_termination,
    float rho, float tol_pri, float tol_dua, int reset_duals, int shift_warm,
    const void* tables, const void* xref_total, const void* x0, void* vnew,
    void* znew, void* g, void* y, void* vstale, void* zstale, void* d,
    void* out_xs, void* out_us, void* out_iters, void* out_solved,
    void* stream) {
  if (N < 2 || B < 1 || T < 1 || max_iter < 1 || check_termination < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define TINYMPC_LAUNCH(NX_, NU_)                                              \
  if (nx == NX_ && nu == NU_)                                                 \
    return static_cast<int>(launch<NX_, NU_>(                                 \
        static_cast<const float*>(tables),                                    \
        static_cast<const float*>(xref_total),                                \
        static_cast<const float*>(x0), static_cast<float*>(vnew),             \
        static_cast<float*>(znew), static_cast<float*>(g),                    \
        static_cast<float*>(y), static_cast<float*>(vstale),                  \
        static_cast<float*>(zstale), static_cast<float*>(d),                  \
        static_cast<float*>(out_xs), static_cast<float*>(out_us),             \
        static_cast<int*>(out_iters),                                         \
        static_cast<unsigned char*>(out_solved), N, B, T, max_iter,           \
        check_termination, rho, tol_pri, tol_dua, reset_duals != 0,           \
        shift_warm != 0, static_cast<cudaStream_t>(stream)));
  TINYMPC_LOOP_PAIRS(TINYMPC_LAUNCH)
#undef TINYMPC_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
