// Adaptive rho inside the fused solve: the hooks of admm_iteration
// (admm_sweep.cuh) and the per-lane adaptation. They replace the adaptive
// part of the TPU kernel tinympc_tpu/kernels/admm_pallas.py:_make_kernel
// (adaptive / apply_c / rho_tol; :424-441, :861-920, :1079-1142,
// :1268-1271), with or without the other constraint families (whose
// linear-cost terms take the lane's rho from the sweep), and the adaptive
// part of the streamed kernels of tinympc_tpu/kernels/admm_stream.py
// (_backward_kernel and _forward_kernel with `adaptive`; admm_stream.cu),
// where the same hooks and the same adaptation pass run in the backward and
// forward launches and the lane's rho waits in device memory in between.
//
// Each lane keeps its own rho, and the guard's virtual rho, in registers.
// The Taylor update never builds per-lane matrices: it is linear in rho, so
// after any number of adaptations M_lane = M + drho * dM/drho with
// drho = rho_lane - rho, and each product of a matrix it moves is the base
// product plus drho times the sensitivity product, summed apart and added
// last (o + drho * (dM v), as the plain version and the TPU kernel form
// it): Kinf x in the forward sweep, Kinf^T r in the backward sweep, the
// terminal reference term -Pinf^T Xref[N-1], and under apply_c Quu_inv w
// and AmBKt p too.
//
// Every ADAPTIVE_RHO_PERIOD-th iteration (it > 0) of an active lane runs
// the OSQP residuals of rho_adapt.osqp_residuals. The forward sweep of that
// iteration stores the rows x_i, u_i and the dynamics rows
// (A x_i + B u_i) - x_{i+1} from its own products (exactly 0 when f = 0,
// as the TPU kernel's are) into scratch; the new slacks and duals are
// already in device memory. A second pass over the rows then forms the
// residuals, A^T g[i+1] and B^T g[i+1] included, and the new rho. It reads
// what its own thread wrote, so it needs no synchronisation, and it keeps
// only one row in registers. Quotients and the root are IEEE's correctly
// rounded ones (div_rn, sqrt_rn), as PyTorch's in the plain version. (The
// TPU's streamed forward kernel carries "pending" cross-row terms from one
// horizon chunk to the next; here one thread walks every row of its lane in
// one launch, so the streamed forward launch runs this same second pass.)
#pragma once

#include "admm_families.cuh"
#include "admm_sweep.cuh"

namespace tinympc {

constexpr int kAdaptivePeriod = 5;   // admm.cpp:405
constexpr float kRhoEps = 1e-10f;    // rho_benchmark.cpp:183

// Per-launch adaptive-rho arguments (kernels/admm_fused.py:_AdaptArgs):
// settings, the carried rho in (null on a cold solve), the final rho out,
// the lane-last scratch of an adaptation iteration: xs (N, nx, B), us
// (N-1, nu, B), axd (N-1, nx, B); and, for the streamed solve
// (admm_stream.cu), which keeps each lane's rho in device memory between
// its launches (rho_in and rho_out the same (B,) array there), the guard's
// virtual rho, (B,) (null in the resident solve, which keeps it in a
// register).
struct AdaptArgs {
  int apply_c, clip;
  float rho_min, rho_max, rho_tol;
  const float* rho_in;
  float *rho_out, *xs, *us, *axd, *rho_v;
};

// Float offsets of the adaptive tables, which follow the box tables of
// Layout (and the empty family tables) in the packed table
// (kernels/admm_fused.py:_table_layout): A^T, Pinf, dKinf, dKinf^T, dPinf,
// dPinf^T, then dC1 and dC2 under apply_c.
struct AdaptiveLayout {
  int at, pinf, dk, dkt, dp, dpt, dc1, dc2, total;
  __host__ __device__ AdaptiveLayout(int nx, int nu, bool apply_c) {
    int o = 0;
    at = o;   o += nx * nx;
    pinf = o; o += nx * nx;
    dk = o;   o += nu * nx;
    dkt = o;  o += nx * nu;
    dp = o;   o += nx * nx;
    dpt = o;  o += nx * nx;
    dc1 = o;  o += apply_c ? nu * nu : 0;
    dc2 = o;  o += apply_c ? nx * nx : 0;
    total = o;
  }
};

__device__ __forceinline__ float maxabs(float m, float a) {
  return max_nan(m, fabsf(a));
}

// The new rho of a lane from the maxima of its OSQP residuals and norms
// (admm_pallas.py:1127-1142): rho * sqrt(normalised primal / normalised
// dual), clipped, committed directly or, with rho_tol > 1, through the
// virtual rho (the guard).
__device__ __forceinline__ void rho_update(const AdaptArgs& a, float pri_res,
                                           float pri_norm, float dual_res,
                                           float dual_norm, float& rho_lane,
                                           float& rho_v) {
  const float ratio = div_rn(div_rn(pri_res, pri_norm + kRhoEps),
                             div_rn(dual_res, dual_norm + kRhoEps) +
                                 kRhoEps);
  const float factor = sqrt_rn(ratio);
  if (a.rho_tol > 1.f) {
    float nv = rho_v * factor;
    if (a.clip) nv = clamp_nan(nv, a.rho_min, a.rho_max);
    const bool commit =
        (nv >= a.rho_tol * rho_lane) || (nv * a.rho_tol <= rho_lane);
    rho_v = nv;
    if (commit) rho_lane = nv;
  } else {
    float nr = rho_lane * factor;
    if (a.clip) nr = clamp_nan(nr, a.rho_min, a.rho_max);
    rho_lane = nr;
  }
}

template <int NX, int NU, bool APPLY_C>
struct AdaptiveRho {
  using Args = AdaptArgs;
  static constexpr bool kAdaptive = true;
  static constexpr bool kApplyC = APPLY_C;
  // Above ~100 registers ptxas spills without a minimum of blocks (as the
  // families kernel did); one block an SM is all a large batch gets anyway.
  static constexpr int kMinBlocks = 1;
  static constexpr int kTerminalRows = 1;   // -dPinf^T Xref[N-1]
  AdaptArgs a;
  const float* t;        // the adaptive tables in shared memory
  const float* pdp;      // -dPinf^T Xref[N-1], (NX,) in shared memory
  AdaptiveLayout L;
  size_t sB;
  int b;
  float rho0;            // the problem's rho, the base of drho
  float rho_lane, rho_v, drho;
  bool adapt_now;

  __device__ AdaptiveRho(const AdaptArgs& args, const float* asm_,
                         const float* pdp_, float rho, size_t sB_, int b_)
      : a(args), t(asm_), pdp(pdp_), L(NX, NU, APPLY_C), sB(sB_), b(b_),
        rho0(rho), rho_lane(rho), rho_v(rho), drho(0.f), adapt_now(false) {}

  static __host__ __device__ int table_floats(const AdaptArgs&, int nx,
                                              int nu) {
    return AdaptiveLayout(nx, nu, APPLY_C).total;
  }

  // Thread k < NX of the block: -dPinf^T Xref[N-1] row k into out[k]
  // (admm_pallas.py:832-837), summed as the kernel sums -Pinf^T Xref[N-1].
  static __device__ void prologue(const AdaptArgs&, const float* asm_,
                                  const float* xref_last, float* out, int k) {
    const AdaptiveLayout L(NX, NU, APPLY_C);
    float acc = 0.f;
    for (int j = 0; j < NX; ++j)
      acc = fmaf(asm_[L.dpt + k * NX + j], xref_last[j], acc);
    out[k] = -acc;
  }

  // The lane's rho: the carry's on a warm solve, else the problem's; the
  // virtual rho restarts from it every solve (admm_pallas.py:665-669).
  template <bool WARM>
  __device__ __forceinline__ void init() {
    if constexpr (WARM) rho_lane = a.rho_in[b];
    rho_v = rho_lane;
  }

  // The streamed solve's launches: the lane's rho (and, for the forward
  // launch, which adapts it, the virtual rho) from device memory, where the
  // previous launch left them; the solve seeds them as init does.
  __device__ __forceinline__ void resume(bool virt) {
    rho_lane = a.rho_in[b];
    rho_v = virt ? a.rho_v[b] : rho_lane;
  }
  __device__ __forceinline__ void suspend() const {
    a.rho_out[b] = rho_lane;
    a.rho_v[b] = rho_v;
  }

  __device__ __forceinline__ float rho() const { return rho_lane; }

  __device__ __forceinline__ void begin(int it) {
    drho = rho_lane - rho0;
    adapt_now = it > 0 && it % kAdaptivePeriod == 0;
  }

  __device__ __forceinline__ bool adapting() const { return adapt_now; }

  __device__ __forceinline__ float pterm(int k, float base) const {
    return base + drho * pdp[k];
  }

  // AmBKt p + drho dC2 p under apply_c.
  __device__ __forceinline__ float ap(int row, float acc,
                                      const float* p) const {
    if constexpr (APPLY_C) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NX; ++c) s = fmaf(t[L.dc2 + row * NX + c], p[c], s);
      return acc + drho * s;
    }
    return acc;
  }

  // Quu_inv w + drho dC1 w under apply_c.
  __device__ __forceinline__ float quu(int row, float acc,
                                       const float* w) const {
    if constexpr (APPLY_C) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) s = fmaf(t[L.dc1 + row * NU + c], w[c], s);
      return acc + drho * s;
    }
    return acc;
  }

  // Kinf^T r + drho dKinf^T r.
  __device__ __forceinline__ float kr(int row, float acc,
                                      const float* r) const {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NU; ++c) s = fmaf(t[L.dkt + row * NU + c], r[c], s);
    return acc + drho * s;
  }

  // Kinf x + drho dKinf x.
  __device__ __forceinline__ float kx(int row, float acc,
                                      const float* x) const {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < NX; ++c) s = fmaf(t[L.dk + row * NX + c], x[c], s);
    return acc + drho * s;
  }

  __device__ __forceinline__ size_t xa(int i, int k) const {
    return (static_cast<size_t>(i) * NX + k) * sB + b;
  }
  __device__ __forceinline__ size_t ua(int i, int k) const {
    return (static_cast<size_t>(i) * NU + k) * sB + b;
  }

  // The rows an adaptation iteration's residual pass reads.
  __device__ __forceinline__ void state_row(int i, const float* x) const {
    if (adapt_now) {
#pragma unroll
      for (int k = 0; k < NX; ++k) a.xs[xa(i, k)] = x[k];
    }
  }
  __device__ __forceinline__ void input_row(int i, const float* u) const {
    if (adapt_now) {
#pragma unroll
      for (int k = 0; k < NU; ++k) a.us[ua(i, k)] = u[k];
    }
  }
  __device__ __forceinline__ void dyn(int i, int row, float v) const {
    if (adapt_now) a.axd[xa(i, row)] = v;
  }

  // The adaptation (admm_pallas.py:1086-1142): the OSQP residuals and
  // norms of rho_adapt.osqp_residuals over the rows of this iteration --
  // vn, zn the new slacks, g, y the new duals -- with the terminal Pinf
  // telescoped by drho dPinf; then rho * sqrt(normalised primal /
  // normalised dual), clipped, committed directly or, with rho_tol > 1,
  // through the virtual rho (the guard).
  __device__ void adapt(const Tables& tb, const float* qd, const float* rd,
                        const float* vn, const float* zn, const float* g,
                        const float* y, int N) {
    float pri_res = 0.f, pri_norm = 0.f, dual_res = 0.f, dual_norm = 0.f;
    for (int i = 0; i < N; ++i) {
      const bool last = i == N - 1;
      float xr[NX], gn[NX];     // x[i], and g[i+1]: the dual of dynamics row i
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        xr[k] = a.xs[xa(i, k)];
        gn[k] = last ? 0.f : g[xa(i + 1, k)];
      }
      // State rows: P x (Q on the stages, the telescoped Pinf on the
      // last), q = Q x, and A^T g[i+1] - g[i].
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const float qx = qd[k] * xr[k];
        float px = qx;
        if (last) {
          float pp = 0.f, dp = 0.f;
#pragma unroll
          for (int c = 0; c < NX; ++c) {
            pp = fmaf(t[L.pinf + k * NX + c], xr[c], pp);
            dp = fmaf(t[L.dp + k * NX + c], xr[c], dp);
          }
          px = pp + drho * dp;
        }
        float atg = 0.f;
        if (!last) {
#pragma unroll
          for (int c = 0; c < NX; ++c) atg = fmaf(t[L.at + k * NX + c], gn[c],
                                                  atg);
        }
        const float aty = atg - (i >= 1 ? g[xa(i, k)] : 0.f);
        dual_res = maxabs(dual_res, px + qx + aty);
        dual_norm = maxabs(maxabs(maxabs(dual_norm, px), aty), qx);
        if (i >= 1) {
          // Dynamics row i-1 against the slack of state row i.
          const float ad = a.axd[xa(i - 1, k)];
          const float v = vn[xa(i, k)];
          pri_res = maxabs(pri_res, ad - v);
          pri_norm = maxabs(maxabs(pri_norm, ad), v);
        }
      }
      if (last) break;
      // Input rows: R u (P x and q alike) and y + B^T g[i+1].
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        float btg = 0.f;
#pragma unroll
        for (int c = 0; c < NX; ++c) btg = fmaf(tb.Mback[k * NX + c], gn[c],
                                                btg);
        const float u = a.us[ua(i, k)];
        const float z = zn[ua(i, k)];
        const float ru = rd[k] * u;
        const float aty = y[ua(i, k)] + btg;
        dual_res = maxabs(dual_res, 2.f * ru + aty);
        dual_norm = maxabs(maxabs(dual_norm, ru), aty);
        pri_res = maxabs(pri_res, u - z);
        pri_norm = maxabs(maxabs(pri_norm, u), z);
      }
    }
    rho_update(a, pri_res, pri_norm, dual_res, dual_norm, rho_lane, rho_v);
  }

  // Converged lanes froze their rho: the final rho of the lane.
  __device__ __forceinline__ void finish() const { a.rho_out[b] = rho_lane; }
};

}  // namespace tinympc
