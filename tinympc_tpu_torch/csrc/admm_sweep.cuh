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
  __device__ Tables(const float* sm, const Layout& L) : Tables(sm, sm, L) {
    negur = sm + L.uref;
  }
  // The small matrices and vectors (Layout's prefix, up to xref) from
  // `sm`, and the per-step bound tables from `rows`, the packed table in
  // device memory: the streamed solve (admm_stream.cu) keeps nothing whose
  // size grows with N in shared memory. It forms -(Uref .* R) on the fly,
  // so `negur` is null here.
  __device__ Tables(const float* sm, const float* rows, const Layout& L)
      : Mback(sm + L.mback), Mfwd(sm + L.mfwd), Quu(sm + L.quu),
        KinfT(sm + L.kinft), Bm(sm + L.bm), APf(sm + L.apf),
        BPf(sm + L.bpf), fv(sm + L.f), negur(nullptr),
        xmin(rows + L.xmin), xmax(rows + L.xmax), umin(rows + L.umin),
        umax(rows + L.umax) {}
};

// -(Xref .* Q) or -(Uref .* R), row i, feature k (F features a row), read
// from a table formed before the loop (the fused solve: one reference for
// the whole launch).
template <int F>
struct NegRefTable {
  const float* t;
  __device__ float operator()(int i, int k) const { return t[i * F + k]; }
};

// The same formed on the fly from a reference trajectory and its weights
// (the closed loop: each thread is at its own step; the streamed solve:
// the reference stays in device memory).
template <int F>
struct NegRefWindow {
  const float* ref;
  const float* w;
  __device__ float operator()(int i, int k) const {
    return -(ref[i * F + k] * w[k]);
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
  __device__ NoFamilies(const Args&, const float*, const float*, int, size_t,
                        int) {}
  static __host__ __device__ int table_floats(const Args&, int, int, int) {
    return 0;
  }
  static __host__ __device__ int static_floats(const Args&, int, int) {
    return 0;
  }
  template <bool WARM>
  __device__ __forceinline__ void seed(const float*) const {}
  __device__ __forceinline__ void p_terminal(float*, float) const {}
  __device__ __forceinline__ void q_terms(int, float*, float) const {}
  __device__ __forceinline__ void r_terms(int, float*, float) const {}
  __device__ __forceinline__ void state_row(int, const float*) const {}
  __device__ __forceinline__ void input_row(int, const float*) const {}
  template <bool WARM, class Rho>
  __device__ __forceinline__ void finish(const Tables&, const float*,
                                         const float*, const float*, int,
                                         const Rho&) const {}
};

// Scenario-tree consensus on u[0] (admm_consensus.cuh implements it for
// an instantiation of the families kernel): the row-0 hooks of the sweeps.
// Every other kernel takes this empty set, whose hooks compile to nothing.
struct NoConsensus {
  struct Args {};
  static constexpr bool kHooks = false;
  NoConsensus() = default;
  __device__ NoConsensus(const Args&, const float*, float*) {}
  static __host__ __device__ int table_floats(const Args&, int, int) {
    return 0;
  }
  static __host__ __device__ int lane_floats(const Args&, int) { return 0; }
  __device__ __forceinline__ void r_terms(int, float*) const {}
  __device__ __forceinline__ const float* quu(int, const float* q) const {
    return q;
  }
  __device__ __forceinline__ const float* kinf(int,
                                               const float* k) const {
    return k;
  }
  template <bool WARM>
  __device__ __forceinline__ void seed(size_t, int, bool) const {}
  template <bool WARM>
  __device__ __forceinline__ void finish(size_t, int) const {}
};

// Fixed rho: one rho for every lane. Adaptive rho (admm_adaptive.cuh)
// carries one a lane and fills these hooks in: each product of a matrix the
// Taylor update moves gains its drho-scaled sensitivity product, and an
// adaptation iteration keeps the rows its residual pass reads. Here every
// hook returns its base value or does nothing, and compiles to nothing.
struct FixedRho {
  struct Args {};
  static constexpr bool kAdaptive = false;
  static constexpr bool kApplyC = false;
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

// 1+2. The backward sweep of lane b: the linear cost fused into the
// backward Riccati recursion (admm_pallas.py:894-968), q/r rows from the
// previous iterate, the feedforward d written row by row.
//   pnref      -Pinf^T Xref[N-1], (NX,)
//   dvgN       vnew[N-1] - g[N-1] of the previous iterate, (NX,)
//   vprev/zprev the previous slacks; g, y the duals; d out, (N-1, NU, B)
//   negxq/negur -(Xref .* Q) and -(Uref .* R), row i, feature k
//   fam        the other constraint families: their terms join the linear
//              cost after the box's, scaled by the lane's rho
//   rh         fixed or adaptive rho (its hooks move the products of the
//              matrices the Taylor update moves); rho is the lane's rho
//   cons       consensus on u[0]: row 0's r term after the families', and
//              its gain Quu0_inv
template <int NX, int NU, class NegXQ, class NegUR, class Fam = NoFamilies,
          class Rho = FixedRho, class Cons = NoConsensus>
__device__ __forceinline__ void backward_sweep(
    const Tables& t, NegXQ negxq, NegUR negur, const float* pnref,
    const float* dvgN, const float* vprev, const float* zprev,
    const float* g, const float* y, float* d, int N, size_t sB, int b,
    float rho, const Fam& fam = Fam(), const Rho& rh = Rho(),
    const Cons& cons = Cons()) {
  float p[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) p[k] = rh.pterm(k, pnref[k]) - rho * dvgN[k];
  fam.p_terminal(p, rho);
  for (int i = N - 2; i >= 0; --i) {
    float r[NU], q[NX];
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const size_t a = (static_cast<size_t>(i) * NU + k) * sB + b;
      r[k] = negur(i, k) - rho * (zprev[a] - y[a]);
    }
    fam.r_terms(i, r, rho);
    cons.r_terms(i, r);
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      const size_t a = (static_cast<size_t>(i) * NX + k) * sB + b;
      q[k] = negxq(i, k) - rho * (vprev[a] - g[a]);
    }
    fam.q_terms(i, q, rho);
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
    const float* quu = cons.quu(i, t.Quu);
#pragma unroll
    for (int row = 0; row < NU; ++row) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc = fmaf(quu[row * NU + c], w[c], acc);
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
}

// 3-6. The forward sweep of lane b: the rollout (admm_pallas.py:971-988)
// fused row by row with the box projection, the dual update (both from the
// pre-update duals, :1004-1046) and the residual maxima (:1165-1168).
//   x0r        the lane's initial state, (NX,) in registers
//   dvgN       out: vnew[N-1] - g[N-1] of this iterate
//   vcur/zcur  the slacks this iteration writes
//   vdprev/zdprev the previous slacks of the dual residual
//   g, y       duals, updated in place; d the feedforward of this iteration
//   u0         out: the raw forward-pass u[0] of this iteration
//   fam        the other constraint families: each projects row i once the
//              sweep has formed it
//   cons       consensus on u[0]: row 0's gain Kinf0
// Residuals are accumulated only when `checking`.
template <int NX, int NU, class Fam = NoFamilies, class Rho = FixedRho,
          class Cons = NoConsensus>
__device__ __forceinline__ Residuals forward_sweep(
    const Tables& t, const float* x0r, float* dvgN, float* vcur, float* zcur,
    const float* vdprev, const float* zdprev, float* g, float* y,
    const float* d, int N, size_t sB, int b, bool checking, float* u0,
    const Fam& fam = Fam(), const Rho& rh = Rho(),
    const Cons& cons = Cons()) {
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
    const float* kinf = cons.kinf(i, t.Mfwd);
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

// One ADMM iteration of lane b: the backward sweep, then the forward sweep,
// as the resident kernels run it.
//   dvgN       in: vnew[N-1] - g[N-1] of the previous iterate; out: of this one
//   vprev/zprev the previous slacks the linear cost reads
//   vdprev/zdprev the previous slacks of the dual residual (vprev/zprev,
//              except at iteration 0 of a warm solve: the carried v/z)
// and the other arguments as the sweeps take them; the reference's
// -(Uref .* R) is t.negur.
template <int NX, int NU, class NegXQ, class Fam = NoFamilies,
          class Rho = FixedRho, class Cons = NoConsensus>
__device__ __forceinline__ Residuals admm_iteration(
    const Tables& t, NegXQ negxq, const float* pnref, const float* x0r,
    float* dvgN, float* vcur, float* zcur, const float* vprev,
    const float* zprev, const float* vdprev, const float* zdprev, float* g,
    float* y, float* d, int N, size_t sB, int b, float rho, bool checking,
    float* u0, const Fam& fam = Fam(), const Rho& rh = Rho(),
    const Cons& cons = Cons()) {
  backward_sweep<NX, NU>(t, negxq, NegRefTable<NU>{t.negur}, pnref, dvgN,
                         vprev, zprev, g, y, d, N, sB, b, rho, fam, rh,
                         cons);
  return forward_sweep<NX, NU>(t, x0r, dvgN, vcur, zcur, vdprev, zdprev, g,
                               y, d, N, sB, b, checking, u0, fam, rh, cons);
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
