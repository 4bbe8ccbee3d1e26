// The constraint families beyond the box -- second-order cones,
// hyperplanes and time-varying hyperplanes -- as the hooks admm_iteration
// (admm_sweep.cuh) calls. They replace the family parts of the TPU kernel
// tinympc_tpu/kernels/admm_pallas.py:_make_kernel: the projections
// _project_soc_rows / _apply_cones / _apply_hyperplanes /
// _apply_tv_hyperplanes (:283-351), their seeds (:670-692), their
// linear-cost terms (:896-927) and their slack and dual updates
// (:1009-1046).
//
// Every family acts within one time row, so each projects row i as soon as
// the forward sweep has formed x[i] (or u[i]) in registers: the candidate
// x + dual from the dual before its update, the projection, the slack and
// the new dual written back. The slacks are one array a family (the
// linear cost of the next iteration reads them), lane-last like the box's.
// Cone bounds and hyperplane rows are run-time data: every loop runs over
// the full feature range 0..F-1 with static register indices and masks by
// the run-time bounds, so no register array is indexed at run time (which
// would put it in local memory). Sums run in feature order from zero and
// every product and quotient rounds on its own (the build has
// -fmad=false), as the plain version in kernels/admm_fused.py computes
// them; the quotients and square roots are IEEE's correctly rounded ones
// (div_rn, sqrt_rn below).
#pragma once

#include "admm_sweep.cuh"

namespace tinympc {

// Per-launch family arguments. Counts are the kernel's run-time family
// sizes; a family that is off has count 0 and null arrays. The working
// arrays are lane-last, (N, nx, B) for the state side and (N-1, nu, B) for
// the input side; the duals are the warm carry out. The *_in arrays are
// the warm carry in, x_out/u_out the carried primal trajectories (null on
// a cold solve).
struct FamilyArgs {
  int ncx, ncu, nlx, nlu, ntx, ntu;
  float *vc, *gc, *zc, *yc, *vl, *gl, *zl, *yl, *vtv, *gtv, *ztv, *ytv;
  const float *gc_in, *yc_in, *gl_in, *yl_in, *gtv_in, *ytv_in, *x_in,
      *u_in;
  float *x_out, *u_out;
};

// Float offsets of the family tables, which follow the box tables of
// Layout in the packed table (kernels/admm_fused.py:_table_layout). Cones
// are rows (start, dim, mu); hyperplanes rows of A, then the b column, then
// the column of ||a||^2 (summed in feature order from zero when the table
// is packed: it is the same for every lane and iteration).
struct FamilyLayout {
  int xcones, ucones, alx, blx, aqx, alu, blu, aqu, tvax, tvbx, tvqx, tvau,
      tvbu, tvqu, total;
  __host__ __device__ FamilyLayout(const FamilyArgs& a, int nx, int nu,
                                   int N) {
    int o = 0;
    xcones = o; o += 3 * a.ncx;
    ucones = o; o += 3 * a.ncu;
    alx = o;    o += a.nlx * nx;
    blx = o;    o += a.nlx;
    aqx = o;    o += a.nlx;
    alu = o;    o += a.nlu * nu;
    blu = o;    o += a.nlu;
    aqu = o;    o += a.nlu;
    tvax = o;   o += N * a.ntx * nx;
    tvbx = o;   o += N * a.ntx;
    tvqx = o;   o += N * a.ntx;
    tvau = o;   o += (N - 1) * a.ntu * nu;
    tvbu = o;   o += (N - 1) * a.ntu;
    tvqu = o;   o += (N - 1) * a.ntu;
    total = o;
  }
};

// Correctly rounded float division and square root without the calls of
// div.rn.f32 / sqrt.rn.f32: ptxas gives those a slow-path subroutine, and
// its calling convention spills live registers to local memory. Here the
// result is formed in double from the hardware's approximate reciprocal
// (or reciprocal square root), two Newton steps and a residual correction
// -- all inline FMA -- to within an ulp of double, and rounded once to
// float. That single rounding gives the correctly rounded float result:
// the exact quotient or root of floats lies at least 2^-51 (relative) from
// the midpoint between two floats, more than the double error. Zero,
// infinite and NaN operands take IEEE's results by multiplication.
__device__ __forceinline__ double rcp_approx(double d) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(d));
  return r;
}

__device__ __forceinline__ double rsqrt_approx(double x) {
  double r;
  asm("rsqrt.approx.f64 %0, %1;" : "=d"(r) : "d"(x));
  return r;
}

__device__ __forceinline__ float div_rn(float n, float d) {
  if (n != 0.f && isfinite(n) && d != 0.f && isfinite(d)) {
    const double dn = n, dd = d;
    double r = rcp_approx(dd);
    r = fma(r, fma(-dd, r, 1.0), r);
    r = fma(r, fma(-dd, r, 1.0), r);
    const double q = dn * r;
    return __double2float_rn(fma(fma(-dd, q, dn), r, q));
  }
  // n / d for a zero, infinite or NaN operand, as n times 1 / d.
  const float inv = isnan(d) ? d
                    : d == 0.f ? copysignf(__int_as_float(0x7f800000), d)
                    : isinf(d) ? copysignf(0.f, d)
                               : copysignf(1.f, d);
  return n * inv;
}

__device__ __forceinline__ float sqrt_rn(float x) {
  if (x > 0.f && isfinite(x)) {
    const double dx = x;
    double y = rsqrt_approx(dx);
    y = fma(0.5 * y, fma(-dx * y, y, 1.0), y);
    y = fma(0.5 * y, fma(-dx * y, y, 1.0), y);
    const double r = dx * y;
    return __double2float_rn(fma(fma(-r, r, dx), 0.5 * y, r));
  }
  // sqrt(+-0) = +-0, sqrt(inf) = inf, NaN stays NaN, x < 0 gives NaN.
  return x < 0.f ? __int_as_float(0x7fc00000) : x;
}

// SOC projections of c (F features) applied in turn, cone k seeing cone
// k-1's result (admm.cpp:39-60, :112-135): u0 = mu c[e], a = ||c[s..e-1]||
// with e = s + dim - 1; below (a <= -u0) -> 0, inside (a <= u0) -> c,
// outside -> 0.5 (1 + u0 / a) [c[s..e-1]; a / mu], with a taken as 1 where
// it is 0 (the apex gives no NaN).
template <int F>
__device__ __forceinline__ void project_cones(float* c, const float* cones,
                                              int n) {
  for (int k = 0; k < n; ++k) {
    const int s = static_cast<int>(cones[3 * k]);
    const int e = s + static_cast<int>(cones[3 * k + 1]) - 1;
    const float mu = cones[3 * k + 2];
    float a2 = 0.f, last = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      if (j >= s && j < e) a2 = a2 + c[j] * c[j];
      if (j == e) last = c[j];
    }
    const float u0 = last * mu;
    const float a = sqrt_rn(a2);
    const bool below = a <= -u0;
    if (below || !(a <= u0)) {
      const float safe_a = a > 0.f ? a : 1.f;
      const float scale = 0.5f * (1.f + div_rn(u0, safe_a));
      const float top = scale * div_rn(a, mu);
#pragma unroll
      for (int j = 0; j < F; ++j) {
        if (j >= s && j < e) c[j] = below ? 0.f : scale * c[j];
        if (j == e) c[j] = below ? 0.f : top;
      }
    }
  }
}

// One violated-only hyperplane projection of c onto {c : a.c = b}
// (admm.cpp:70-73, :148-211); asq = ||a||^2, from the table.
template <int F>
__device__ __forceinline__ void project_hyperplane(float* c, const float* a,
                                                   float b, float asq) {
  float val = 0.f;
#pragma unroll
  for (int j = 0; j < F; ++j) val = val + c[j] * a[j];
  if (val > b) {
    const float dist = div_rn(val - b, asq);
#pragma unroll
    for (int j = 0; j < F; ++j) c[j] = c[j] - dist * a[j];
  }
}

// Every hook is forced inline: a row's candidate lives in registers, and a
// call would have to pass it through local memory.
template <int NX, int NU>
struct Families {
  using Args = FamilyArgs;
  // One block an SM is enough (a launch has ~1 block an SM at B=16384), so
  // ptxas may give the families' longer live state the registers it needs
  // rather than spill it.
  static constexpr int kMinBlocks = 1;
  FamilyArgs a;
  const float* t;        // the family tables, from the cones on
  const float* tv;       // the same, for the time-varying hyperplanes
  FamilyLayout L;        // their offsets, from t (or tv)
  int N;
  size_t sB;
  int b;

  // fsm: the family tables in shared memory, right after the box tables;
  // frows: where the time-varying hyperplane tables are read, the same
  // copy (the fused solve) or the packed table in device memory (the
  // streamed solve, whose shared memory holds only the tables that do not
  // grow with N: the first static_floats of them).
  __device__ Families(const FamilyArgs& args, const float* fsm,
                      const float* frows, int N_, size_t sB_, int b_)
      : a(args), t(fsm), tv(frows), L(args, NX, NU, N_), N(N_), sB(sB_),
        b(b_) {}

  static __host__ __device__ int table_floats(const FamilyArgs& args, int nx,
                                              int nu, int N) {
    return FamilyLayout(args, nx, nu, N).total;
  }
  // The cone and static hyperplane tables, which come first.
  static __host__ __device__ int static_floats(const FamilyArgs& args,
                                               int nx, int nu) {
    return FamilyLayout(args, nx, nu, 1).tvax;
  }

  __device__ __forceinline__ size_t xa(int i, int k) const {
    return (static_cast<size_t>(i) * NX + k) * sB + b;
  }
  __device__ __forceinline__ size_t ua(int i, int k) const {
    return (static_cast<size_t>(i) * NU + k) * sB + b;
  }

  // Seeds (admm_pallas.py:670-692, admm.cpp:352-376): state-side slacks
  // start from x0 in row 0 and, in the other rows, zeros on a cold solve or
  // the carried x on a warm one; input-side slacks from zeros or the
  // carried u. Duals start at zero or from the carry. A warm solve also
  // starts its carried x/u there, which is what it hands back when it runs
  // no iteration.
  template <bool WARM>
  __device__ __forceinline__ void seed(const float* x0r) const {
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const size_t o = xa(i, k);
        const float s = i == 0 ? x0r[k] : WARM ? a.x_in[o] : 0.f;
        if (a.ncx) { a.vc[o] = s; a.gc[o] = WARM ? a.gc_in[o] : 0.f; }
        if (a.nlx) { a.vl[o] = s; a.gl[o] = WARM ? a.gl_in[o] : 0.f; }
        if (a.ntx) { a.vtv[o] = s; a.gtv[o] = WARM ? a.gtv_in[o] : 0.f; }
        if (WARM) a.x_out[o] = s;
      }
    }
    for (int i = 0; i < N - 1; ++i) {
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        const size_t o = ua(i, k);
        const float s = WARM ? a.u_in[o] : 0.f;
        if (a.ncu) { a.zc[o] = s; a.yc[o] = WARM ? a.yc_in[o] : 0.f; }
        if (a.nlu) { a.zl[o] = s; a.yl[o] = WARM ? a.yl_in[o] : 0.f; }
        if (a.ntu) { a.ztv[o] = s; a.ytv[o] = WARM ? a.ytv_in[o] : 0.f; }
        if (WARM) a.u_out[o] = s;
      }
    }
  }

  // Linear-cost terms of the previous iterate's slacks and duals, after the
  // box's, in the order SOC, hyperplane, time-varying hyperplane
  // (admm_pallas.py:896-927), each scaled by the lane's rho, which the
  // sweep hands in (under adaptive rho it moves between iterations; the
  // TPU kernel's form_q / form_r use its per-lane rho_b).
  // (One loop a family: interleaved, ptxas keeps every family's loads of a
  // row in flight at once and runs out of registers on the warm (12, 4)
  // kernel.)
  __device__ __forceinline__ void q_terms(int i, float* q, float rho) const {
    if (a.ncx) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const size_t o = xa(i, k);
        q[k] = q[k] - rho * (a.vc[o] - a.gc[o]);
      }
    }
    if (a.nlx) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const size_t o = xa(i, k);
        q[k] = q[k] - rho * (a.vl[o] - a.gl[o]);
      }
    }
    if (a.ntx) {
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const size_t o = xa(i, k);
        q[k] = q[k] - rho * (a.vtv[o] - a.gtv[o]);
      }
    }
  }
  __device__ __forceinline__ void p_terminal(float* p, float rho) const {
    q_terms(N - 1, p, rho);
  }
  __device__ __forceinline__ void r_terms(int i, float* r, float rho) const {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const size_t o = ua(i, k);
      if (a.ncu) r[k] = r[k] - rho * (a.zc[o] - a.yc[o]);
      if (a.nlu) r[k] = r[k] - rho * (a.zl[o] - a.yl[o]);
      if (a.ntu) r[k] = r[k] - rho * (a.ztv[o] - a.ytv[o]);
    }
  }

  // Row i of the state side: each family's slack and dual.
  __device__ __forceinline__ void state_row(int i, const float* x) const {
    if (a.ncx) {
      float c[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) c[k] = x[k] + a.gc[xa(i, k)];
      project_cones<NX>(c, t + L.xcones, a.ncx);
      store(a.vc, a.gc, c, x, i);
    }
    if (a.nlx) {
      float c[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) c[k] = x[k] + a.gl[xa(i, k)];
      for (int s = 0; s < a.nlx; ++s)
        project_hyperplane<NX>(c, t + L.alx + s * NX, t[L.blx + s],
                               t[L.aqx + s]);
      store(a.vl, a.gl, c, x, i);
    }
    if (a.ntx) {
      float c[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) c[k] = x[k] + a.gtv[xa(i, k)];
      for (int s = 0; s < a.ntx; ++s)
        project_hyperplane<NX>(c, tv + L.tvax + (i * a.ntx + s) * NX,
                               tv[L.tvbx + i * a.ntx + s],
                               tv[L.tvqx + i * a.ntx + s]);
      store(a.vtv, a.gtv, c, x, i);
    }
  }

  __device__ __forceinline__ void input_row(int i, const float* u) const {
    if (a.ncu) {
      float c[NU];
#pragma unroll
      for (int k = 0; k < NU; ++k) c[k] = u[k] + a.yc[ua(i, k)];
      project_cones<NU>(c, t + L.ucones, a.ncu);
      store_u(a.zc, a.yc, c, u, i);
    }
    if (a.nlu) {
      float c[NU];
#pragma unroll
      for (int k = 0; k < NU; ++k) c[k] = u[k] + a.yl[ua(i, k)];
      for (int s = 0; s < a.nlu; ++s)
        project_hyperplane<NU>(c, t + L.alu + s * NU, t[L.blu + s],
                               t[L.aqu + s]);
      store_u(a.zl, a.yl, c, u, i);
    }
    if (a.ntu) {
      float c[NU];
#pragma unroll
      for (int k = 0; k < NU; ++k) c[k] = u[k] + a.ytv[ua(i, k)];
      for (int s = 0; s < a.ntu; ++s)
        project_hyperplane<NU>(c, tv + L.tvau + (i * a.ntu + s) * NU,
                               tv[L.tvbu + i * a.ntu + s],
                               tv[L.tvqu + i * a.ntu + s]);
      store_u(a.ztv, a.ytv, c, u, i);
    }
  }

  // The warm carry's x/u: the iterate of the last iteration this lane ran
  // (admm_pallas.py:1001-1003). The lane's last feedforward d is still in
  // d, so its forward rollout is run once more from x0 with the
  // arithmetic of admm_iteration's, which gives the iterate's bits --
  // rather than storing x/u on every iteration; `kinf0` is the Kinf rows
  // of step 0 (Mfwd's, or consensus's Kinf0), and `rh` the rho policy,
  // whose kx hook telescopes the gain with the drho of that iteration
  // under adaptive rho. With no iteration run, the seeded x/u stand.
  template <bool WARM, class Rho>
  __device__ __forceinline__ void finish(const Tables& tab,
                                         const float* kinf0,
                                         const float* x0r, const float* d,
                                         int iters, const Rho& rh) const {
    if (!WARM || iters == 0) return;
    float x[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) x[k] = x0r[k];
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < NX; ++k) a.x_out[xa(i, k)] = x[k];
      if (i == N - 1) break;
      float kx[NU], ax[NX], u[NU];
      const float* kinf = i == 0 ? kinf0 : tab.Mfwd;
#pragma unroll
      for (int row = 0; row < NU; ++row) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < NX; ++c) acc = fmaf(kinf[row * NX + c], x[c], acc);
        kx[row] = rh.kx(row, acc, x);
      }
#pragma unroll
      for (int row = 0; row < NX; ++row) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < NX; ++c)
          acc = fmaf(tab.Mfwd[(NU + row) * NX + c], x[c], acc);
        ax[row] = acc;
      }
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        u[k] = -kx[k] - d[ua(i, k)];
        a.u_out[ua(i, k)] = u[k];
      }
#pragma unroll
      for (int row = 0; row < NX; ++row) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < NU; ++c)
          acc = fmaf(tab.Bm[row * NU + c], u[c], acc);
        x[row] = ax[row] + acc + tab.fv[row];
      }
    }
  }

  // slack <- c; dual <- dual + x - c, from the dual before the update.
  __device__ __forceinline__ void store(float* v, float* g, const float* c,
                                        const float* x, int i) const {
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const size_t o = xa(i, k);
      g[o] = g[o] + x[k] - c[k];
      v[o] = c[k];
    }
  }
  __device__ __forceinline__ void store_u(float* z, float* y,
                                          const float* c, const float* u,
                                          int i) const {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const size_t o = ua(i, k);
      y[o] = y[o] + u[k] - c[k];
      z[o] = c[k];
    }
  }
};

}  // namespace tinympc
