// One ADMM iteration of one lane, shared by the fused solve
// (admm_fused.cu) and the fused closed loop (closed_loop_fused.cu).
//
// The iteration is the body of the TPU kernels' ADMM loop
// (tinympc_tpu/kernels/admm_pallas.py:894-1046 and
// closed_loop_pallas.py:159-198): linear cost fused into the backward
// Riccati sweep, then the forward rollout fused row by row with the box
// projection, the dual update (both from the pre-update duals) and the
// four max-abs residuals. One thread runs one lane; per-lane trajectories
// are lane-last in device memory ((rows, features, B): thread b touches
// address b of every row, so a warp's access is one coalesced line), and
// the small shared matrices are read from shared memory as broadcasts.
// Float32 FMA on the CUDA cores only, each matvec summed in a fixed column
// order. Built with -fmad=false (kernels/_build.py): only the explicit
// fmaf calls fuse, so an elementwise term such as q - rho * (v - g) rounds
// twice, as the plain versions' separate PyTorch operations round it.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace tinympc {

// Float offsets into the packed table the wrappers build (row-major);
// kernels/admm_fused.py:_pack_tables writes the same order.
struct Layout {
  int mback, mfwd, quu, kinft, bm, apf, bpf, f, qd, rd, pinft, xref, uref,
      xmin, xmax, umin, umax, total;
  __host__ __device__ Layout(int nx, int nu, int N) {
    int o = 0;
    mback = o; o += (nu + nx) * nx;
    mfwd = o;  o += (nu + nx) * nx;
    quu = o;   o += nu * nu;
    kinft = o; o += nx * nu;
    bm = o;    o += nx * nu;
    apf = o;   o += nx;
    bpf = o;   o += nu;
    f = o;     o += nx;
    qd = o;    o += nx;
    rd = o;    o += nu;
    pinft = o; o += nx * nx;
    xref = o;  o += N * nx;
    uref = o;  o += (N - 1) * nu;
    xmin = o;  o += N * nx;
    xmax = o;  o += N * nx;
    umin = o;  o += (N - 1) * nu;
    umax = o;  o += (N - 1) * nu;
    total = o;
  }
};

// Box projection min(hi, max(lo, s)) with NaN propagating like
// jnp.minimum/jnp.maximum (fminf/fmaxf would drop it).
__device__ __forceinline__ float clamp_nan(float s, float lo, float hi) {
  s = (s < lo) ? lo : s;
  return (s > hi) ? hi : s;
}

// max that keeps a NaN once seen, like jnp.max.
__device__ __forceinline__ float max_nan(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// Pointers into the shared-memory copy of the packed table. `negur` is
// -(Uref .* R), formed in place by the kernel before the loop.
struct Tables {
  const float *Mback, *Mfwd, *Quu, *KinfT, *Bm, *APf, *BPf, *fv, *negur,
      *xmin, *xmax, *umin, *umax;
  __device__ Tables(const float* sm, const Layout& L)
      : Mback(sm + L.mback), Mfwd(sm + L.mfwd), Quu(sm + L.quu),
        KinfT(sm + L.kinft), Bm(sm + L.bm), APf(sm + L.apf),
        BPf(sm + L.bpf), fv(sm + L.f), negur(sm + L.uref),
        xmin(sm + L.xmin), xmax(sm + L.xmax), umin(sm + L.umin),
        umax(sm + L.umax) {}
};

// -(Xref .* Q) row i, feature k, read from a table formed before the loop
// (the fused solve: one reference for the whole launch).
template <int NX>
struct NegXQTable {
  const float* t;
  __device__ float operator()(int i, int k) const { return t[i * NX + k]; }
};

// -(Xref .* Q) formed on the fly from a window of the reference
// trajectory (the closed loop: each thread is at its own step).
template <int NX>
struct NegXQWindow {
  const float* xref;
  const float* qd;
  __device__ float operator()(int i, int k) const {
    return -(xref[i * NX + k] * qd[k]);
  }
};

struct Residuals {
  float pri_s, pri_i, dua_s, dua_i;   // dual rows not yet scaled by rho
};

// The constraint families beyond the box, as hooks into the iteration
// (admm_families.cuh implements them). The box-only solve and the closed
// loop take this empty set, whose hooks compile to nothing.
struct NoFamilies {
  struct Args {};
  static constexpr int kMinBlocks = 0;   // no minimum: __launch_bounds__(B)
  NoFamilies() = default;
  __device__ NoFamilies(const Args&, const float*, int, size_t, int, float) {}
  static __host__ __device__ int table_floats(const Args&, int, int, int) {
    return 0;
  }
  template <bool WARM>
  __device__ __forceinline__ void seed(const float*) const {}
  __device__ __forceinline__ void p_terminal(float*) const {}
  __device__ __forceinline__ void q_terms(int, float*) const {}
  __device__ __forceinline__ void r_terms(int, float*) const {}
  __device__ __forceinline__ void state_row(int, const float*) const {}
  __device__ __forceinline__ void input_row(int, const float*) const {}
  template <bool WARM>
  __device__ __forceinline__ void finish(const Tables&, const float*,
                                         const float*, int) const {}
};

// Fixed rho: one rho for every lane. Adaptive rho (admm_adaptive.cuh)
// carries one a lane and fills these hooks in: each product of a matrix the
// Taylor update moves gains its drho-scaled sensitivity product, and an
// adaptation iteration keeps the rows its residual pass reads. Here every
// hook returns its base value or does nothing, and compiles to nothing.
struct FixedRho {
  struct Args {};
  static constexpr bool kAdaptive = false;
  static constexpr int kMinBlocks = 0;
  static constexpr int kTerminalRows = 0;   // shared rows after -Pinf^T Xref
  float rho0 = 0.f;
  FixedRho() = default;
  __device__ FixedRho(const Args&, const float*, const float*, float rho,
                      size_t, int)
      : rho0(rho) {}
  static __host__ __device__ int table_floats(const Args&, int, int) {
    return 0;
  }
  static __device__ void prologue(const Args&, const float*, const float*,
                                  float*, int) {}
  template <bool WARM>
  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ float rho() const { return rho0; }
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ bool adapting() const { return false; }
  __device__ __forceinline__ float pterm(int, float base) const {
    return base;
  }
  __device__ __forceinline__ float ap(int, float acc, const float*) const {
    return acc;
  }
  __device__ __forceinline__ float quu(int, float acc, const float*) const {
    return acc;
  }
  __device__ __forceinline__ float kr(int, float acc, const float*) const {
    return acc;
  }
  __device__ __forceinline__ float kx(int, float acc, const float*) const {
    return acc;
  }
  __device__ __forceinline__ void state_row(int, const float*) const {}
  __device__ __forceinline__ void input_row(int, const float*) const {}
  __device__ __forceinline__ void dyn(int, int, float) const {}
  __device__ __forceinline__ void finish() const {}
};

// One ADMM iteration of lane b.
//   pnref      -Pinf^T Xref[N-1], (NX,)
//   x0r        the lane's initial state, (NX,) in registers
//   dvgN       in: vnew[N-1] - g[N-1] of the previous iterate; out: of this one
//   vcur/zcur  ping-pong half written by this iteration
//   vprev/zprev the previous slacks the linear cost reads
//   vdprev/zdprev the previous slacks of the dual residual (vprev/zprev,
//              except at iteration 0 of a warm solve: the carried v/z)
//   g, y       duals, updated in place; d the feedforward scratch
//   u0         out: the raw forward-pass u[0] of this iteration
//   fam        the other constraint families: their terms join the linear
//              cost after the box's, and each projects row i once the
//              forward sweep has formed it
//   rh         fixed or adaptive rho (its hooks move the products of the
//              matrices the Taylor update moves); rho is the lane's rho
// Residuals are accumulated only when `checking`.
template <int NX, int NU, class NegXQ, class Fam = NoFamilies,
          class Rho = FixedRho>
__device__ __forceinline__ Residuals admm_iteration(
    const Tables& t, NegXQ negxq, const float* pnref, const float* x0r,
    float* dvgN, float* vcur, float* zcur, const float* vprev,
    const float* zprev, const float* vdprev, const float* zdprev, float* g,
    float* y, float* d, int N, size_t sB, int b, float rho, bool checking,
    float* u0, const Fam& fam = Fam(), const Rho& rh = Rho()) {
  // 1+2. Linear cost fused into the backward sweep
  // (admm_pallas.py:894-968): q/r rows from the previous iterate.
  float p[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) p[k] = rh.pterm(k, pnref[k]) - rho * dvgN[k];
  fam.p_terminal(p);
  for (int i = N - 2; i >= 0; --i) {
    float r[NU], q[NX];
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const size_t a = (static_cast<size_t>(i) * NU + k) * sB + b;
      r[k] = t.negur[i * NU + k] - rho * (zprev[a] - y[a]);
    }
    fam.r_terms(i, r);
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const size_t a = (static_cast<size_t>(i) * NX + k) * sB + b;
      q[k] = negxq(i, k) - rho * (vprev[a] - g[a]);
    }
    fam.q_terms(i, q);
    // [B^T; AmBKt] p
    float bp[NU], ap[NX];
#pragma unroll
    for (int row = 0; row < NU; ++row) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NX; ++c) acc = fmaf(t.Mback[row * NX + c], p[c], acc);
      bp[row] = acc;
    }
#pragma unroll
    for (int row = 0; row < NX; ++row) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NX; ++c)
        acc = fmaf(t.Mback[(NU + row) * NX + c], p[c], acc);
      ap[row] = rh.ap(row, acc, p);
    }
    // d[i] = Quu_inv (B^T p + r + BPf)
    float w[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) w[k] = bp[k] + r[k] + t.BPf[k];
#pragma unroll
    for (int row = 0; row < NU; ++row) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc = fmaf(t.Quu[row * NU + c], w[c], acc);
      d[(static_cast<size_t>(i) * NU + row) * sB + b] = rh.quu(row, acc, w);
    }
    // p[i] = q + AmBKt p - Kinf^T r + APf
#pragma unroll
    for (int row = 0; row < NX; ++row) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc = fmaf(t.KinfT[row * NU + c], r[c], acc);
      p[row] = q[row] + ap[row] - rh.kr(row, acc, r) + t.APf[row];
    }
  }

  // 3-6. Forward rollout (admm_pallas.py:971-988) fused row by row with the
  // box projection, the dual update (both from the pre-update duals,
  // :1004-1046) and the residual maxima (:1165-1168).
  float x[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) x[k] = x0r[k];
  Residuals res = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const size_t a = (static_cast<size_t>(i) * NX + k) * sB + b;
      const float gi = g[a];
      const float vn =
          clamp_nan(x[k] + gi, t.xmin[i * NX + k], t.xmax[i * NX + k]);
      const float gn = gi + x[k] - vn;
      g[a] = gn;
      vcur[a] = vn;
      if (checking) {
        res.pri_s = max_nan(res.pri_s, fabsf(x[k] - vn));
        res.dua_s = max_nan(res.dua_s, fabsf(vdprev[a] - vn));
      }
      if (i == N - 1) dvgN[k] = vn - gn;
    }
    fam.state_row(i, x);
    rh.state_row(i, x);
    if (i == N - 1) break;
    // [Kinf; A] x, then u = -Kinf x - d as an exact subtract
    float kx[NU], ax[NX];
#pragma unroll
    for (int row = 0; row < NU; ++row) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NX; ++c) acc = fmaf(t.Mfwd[row * NX + c], x[c], acc);
      kx[row] = rh.kx(row, acc, x);
    }
#pragma unroll
    for (int row = 0; row < NX; ++row) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NX; ++c)
        acc = fmaf(t.Mfwd[(NU + row) * NX + c], x[c], acc);
      ax[row] = acc;
    }
    float u[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const size_t a = (static_cast<size_t>(i) * NU + k) * sB + b;
      u[k] = -kx[k] - d[a];
      if (i == 0) u0[k] = u[k];
      const float yi = y[a];
      const float zn =
          clamp_nan(u[k] + yi, t.umin[i * NU + k], t.umax[i * NU + k]);
      y[a] = yi + u[k] - zn;
      zcur[a] = zn;
      if (checking) {
        res.pri_i = max_nan(res.pri_i, fabsf(u[k] - zn));
        res.dua_i = max_nan(res.dua_i, fabsf(zdprev[a] - zn));
      }
    }
    fam.input_row(i, u);
    rh.input_row(i, u);
    // x+ = A x + B u + f; (A x + B u) - x+ is the dynamics row of the
    // OSQP residuals of adaptive rho (exactly 0 when f = 0)
#pragma unroll
    for (int row = 0; row < NX; ++row) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc = fmaf(t.Bm[row * NU + c], u[c], acc);
      const float s = ax[row] + acc;
      x[row] = s + t.fv[row];
      rh.dyn(i, row, s - x[row]);
    }
  }
  return res;
}

// Copy (rows, F, B) lane b of src into dst.
__device__ __forceinline__ void copy_lane(float* dst, const float* src,
                                          int rows_x_f, size_t sB, int b) {
  for (int k = 0; k < rows_x_f; ++k) {
    const size_t a = static_cast<size_t>(k) * sB + b;
    dst[a] = src[a];
  }
}

}  // namespace tinympc
