// One ADMM iteration of one problem spread over a group of G threads, its
// trajectories in shared memory for the whole solve: the iteration of the
// box-only, fixed-rho resident solve (admm_group.cu) and of the fused
// closed loop (closed_loop_fused.cu).
//
// The arithmetic is admm_sweep.cuh's backward_sweep / forward_sweep with
// NoFamilies, FixedRho and NoConsensus, term for term: every row's dot
// product is summed from zero in the same column order with explicit
// fmaf, and every elementwise term rounds as there (built with
// -fmad=false). Only who computes a row, and where its operands live,
// changes:
//   * A problem has NX + NU rows: state rows 0..NX-1 and input rows
//     NX..NX+NU-1. Thread g of the group owns the R = (NX + NU) / G rows
//     g, g + G, g + 2G, ... and keeps that row of every matrix the sweeps
//     multiply in registers: a state row k holds row k of AmBKt (Mback),
//     KinfT, A (Mfwd) and B; an input row j row j of B^T (Mback), Quu_inv
//     and Kinf (Mfwd).
//   * Each owned row keeps its trajectory -- the slack (v or z) and the
//     dual (g or y) of every step, and, where the caller keeps it, a saved
//     slack (the carried or stale v/z, or the previous slack of a check
//     iteration) -- in its own column of shared memory ((rows, columns):
//     thread after thread, so a warp's access is conflict-free). An input
//     row also keeps its feedforward d. One copy of each slack: the
//     forward sweep reads the old value for the dual residual before it
//     overwrites it. Past the horizon where one problem's columns fill a
//     block's shared memory, the saved columns (read on iteration 0 and
//     written on check iterations only) move to a device-memory buffer of
//     the same layout, a block's slice each (Place below).
//   * The vector a matvec multiplies (p and r, w in the backward sweep; x
//     and u in the forward sweep) passes through the problem's exchange
//     slot in shared memory: each owner writes its entry, the group meets
//     at __syncwarp (a group lies inside one warp), and every thread reads
//     the whole vector back (broadcast) for its own rows' dot products.
//   * The four residual maxima of a check iteration are each thread's
//     maxima of its own rows, then reduced over the group by shuffles;
//     max_nan is order-free (a NaN sticks whichever order it comes in).
// Both sweeps give both roles the same instruction stream (a dot product
// of length NX, an exchange, one of length NU, an exchange); only the
// short tails differ.
#pragma once

#include "admm_sweep.cuh"

namespace tinympc {

// Shared-memory layout of a block's problems, in floats from the arena's
// start (16-byte aligned): the exchange slots (P, kSlot), then the slack
// and dual of every column side by side ((N, P * (NX + NU)) float2s: one
// 8-byte access reads or writes both), the saved-slack columns when the
// arena holds them (N, P * (NX + NU)), then the input rows' feedforward
// (N - 1, P * NU). kernels/admm_fused.py:group_arena_floats sums the same;
// the wrappers check it against tinympc_*_smem when they load a library.
template <int NX, int NU>
struct GroupArena {
  static constexpr int kRows = NX + NU;
  static constexpr int kSlot = ((NX + 2 * NU + 3) / 4) * 4;
  static __host__ __device__ int floats(int N, int P, bool saved) {
    return P * kSlot + (saved ? 3 : 2) * N * P * kRows + (N - 1) * P * NU;
  }
  // Floats of a block's saved columns in device memory (kSavedGlobal).
  static __host__ __device__ size_t saved_floats(int N, int P) {
    return static_cast<size_t>(N) * P * kRows;
  }
};

// Where a block keeps what it reads, from the most in shared memory to the
// least; a launch takes the first that fits (admm_fused.py:group_geometry).
enum Place : int {
  kShared = 0,        // the packed table (the closed loop: and its
                      // reference trajectory) and the arena
  kTableGlobal = 1,   // the arena; the table read from device memory
  kSavedGlobal = 2,   // the arena but the saved columns, which sit in a
                      // device-memory buffer; the table in device memory
};

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

template <int NX, int NU, int G>
struct GroupSweep {
  static_assert((NX + NU) % G == 0, "the group's threads split the rows");
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a group is a power of two inside one warp");
  static_assert(NX % 4 == 0 && NU % 4 == 0,
                "the exchange reads whole float4s");
  static constexpr int R = (NX + NU) / G;   // rows a thread owns
  using Arena = GroupArena<NX, NU>;

  float m1[R][NX];   // backward, length NX: AmBKt row k / B^T row j
  float m2[R][NU];   // backward, length NU: KinfT row k / Quu_inv row j
  float f1[R][NX];   // forward, length NX: A row k / Kinf row j
  float bm[R][NU];   // forward, length NU: B row k (input rows: unused)
  float add[R];      // APf[k] / BPf[j]
  float fv[R];       // f[k]
  float wt[R];       // Qd[k] / Rd[j]
  bool st[R];        // a state row
  int feat[R];       // k or j
  int tstr[R];       // NX or NU: the table stride of a step
  int col[R];        // column of the slack / dual / saved columns
  int fcol[R];       // column of the feedforward (input rows)
  const float* ref[R];   // reference row: Xref[., k] / Uref[., j]
  const float* lo[R];    // bounds: xmin / umin
  const float* hi[R];    // xmax / umax
  float2* SU;        // (slack, dual) of each row and step
  float *V, *F, *X;
  int C, PU;
  unsigned mask;     // the group's lanes in its warp

  // Thread g of problem p (of P in the block, G threads each) reading the
  // packed table `tab` (Layout L; shared or device memory) and the arena.
  // saved_in_arena: the arena holds the saved columns; else they are at
  // `saved` (the block's slice of a device-memory buffer), or there are
  // none (null).
  __device__ GroupSweep(const float* tab, const Layout& L, float* arena,
                        int N, int P, int p, int g, bool saved_in_arena,
                        float* saved = nullptr) {
    C = P * Arena::kRows;
    PU = P * NU;
    X = arena + p * Arena::kSlot;
    SU = reinterpret_cast<float2*>(arena + P * Arena::kSlot);
    V = saved_in_arena ? arena + P * Arena::kSlot + 2 * N * C : saved;
    F = arena + P * Arena::kSlot + (saved_in_arena ? 3 : 2) * N * C;
    const int lane = threadIdx.x & 31;
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = g + r * G;
      st[r] = row < NX;
      const int k = st[r] ? row : row - NX;
      feat[r] = k;
      tstr[r] = st[r] ? NX : NU;
      col[r] = r * (P * G) + p * G + g;
      fcol[r] = p * NU + k;
      const int mrow = st[r] ? NU + k : k;   // row of [B^T; AmBKt], [Kinf; A]
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        m1[r][c] = tab[L.mback + mrow * NX + c];
        f1[r][c] = tab[L.mfwd + mrow * NX + c];
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        m2[r][c] = st[r] ? tab[L.kinft + k * NU + c] : tab[L.quu + k * NU + c];
        bm[r][c] = st[r] ? tab[L.bm + k * NU + c] : 0.f;
      }
      add[r] = st[r] ? tab[L.apf + k] : tab[L.bpf + k];
      fv[r] = st[r] ? tab[L.f + k] : 0.f;
      wt[r] = st[r] ? tab[L.qd + k] : tab[L.rd + k];
      ref[r] = st[r] ? tab + L.xref + k : tab + L.uref + k;
      lo[r] = st[r] ? tab + L.xmin + k : tab + L.umin + k;
      hi[r] = st[r] ? tab + L.xmax + k : tab + L.umax + k;
    }
  }

  // Whether owned row r is a state row: known at compile time where every
  // thread's row r has the same role ((r + 1) G <= NX, or r G >= NX; the
  // loops over r are unrolled), so such rows take no branch on it.
  __device__ __forceinline__ bool state(int r) const {
    if ((r + 1) * G <= NX) return true;
    if (r * G >= NX) return false;
    return st[r];
  }

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }

  // The rows a thread's column holds for its role: N state, N - 1 input.
  __device__ __forceinline__ int rows(int r, int N) const {
    return state(r) ? N : N - 1;
  }

  template <int n>
  static __device__ __forceinline__ void load(float (&v)[n], const float* s) {
#pragma unroll
    for (int q = 0; q < n / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(s)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }

  template <int n>
  static __device__ __forceinline__ float dot(const float (&m)[n],
                                              const float (&v)[n]) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < n; ++c) acc = fmaf(m[c], v[c], acc);
    return acc;
  }

  // -Pinf^T xN of a state row (admm_pallas.py:823): its row of PinfT
  // against the reference's last row, from zero in column order.
  __device__ __forceinline__ float pnref(int r, const float* pinft,
                                         const float* xN) const {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) acc = fmaf(pinft[feat[r] * NX + j], xN[j], acc);
    return -acc;
  }

  // The backward sweep (admm_sweep.cuh:backward_sweep): the state rows
  // start p from pterm = -Pinf^T Xref[N-1] - rho (vnew[N-1] - g[N-1]);
  // rows N-2 .. 0 of the linear cost from the slacks and duals, the input
  // rows' d into F.
  __device__ void backward(int N, float rho, const float (&pterm)[R]) const {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (state(r)) X[feat[r]] = pterm[r];
    sync();
    for (int i = N - 2; i >= 0; --i) {
      float p[NX];
      load(p, X);
      float lin[R], a1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 su = SU[i * C + col[r]];
        // q = -(Xref .* Q) - rho (v - g), r = -(Uref .* R) - rho (z - y)
        lin[r] = -(ref[r][i * tstr[r]] * wt[r]) - rho * (su.x - su.y);
        a1[r] = dot(m1[r], p);                  // AmBKt p  /  B^T p
        if (!state(r)) {
          X[NX + feat[r]] = lin[r];
          X[NX + NU + feat[r]] = a1[r] + lin[r] + add[r];   // w
        }
      }
      sync();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v[NU];
        load(v, X + NX + (state(r) ? 0 : NU));      // r  /  w
        const float a2 = dot(m2[r], v);         // Kinf^T r  /  Quu_inv w
        if (state(r))
          X[feat[r]] = lin[r] + a1[r] - a2 + add[r];   // p[i]
        else
          F[i * PU + fcol[r]] = a2;             // d[i]
      }
      sync();
    }
  }

  // The forward sweep (admm_sweep.cuh:forward_sweep): the rollout from
  // the state rows' x0, each row projected onto its box and its dual
  // updated from the pre-update dual, the four residual maxima on check
  // iterations, reduced over the group. `stale`: the dual residual
  // compares against the saved slack, which stays (iteration 0 of a warm
  // solve or a closed-loop step); else with SAVE a check iteration saves
  // the slack it overwrites. dvgN (state rows) <- v[N-1] - g[N-1]; u0
  // (input rows) <- the raw u[0].
  template <bool SAVE>
  __device__ Residuals forward(int N, const float (&x0)[R], float (&dvgN)[R],
                               bool checking, bool stale,
                               float (&u0)[R]) const {
    float xo[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xo[r] = x0[r];
      if (state(r)) X[feat[r]] = xo[r];
    }
    sync();
    float ps = 0.f, pi = 0.f, ds = 0.f, di = 0.f;
    for (int i = 0; i < N; ++i) {
      const bool last = i == N - 1;
      float a1[R];
      if (!last) {
        float x[NX];
        load(x, X);
#pragma unroll
        for (int r = 0; r < R; ++r) a1[r] = dot(f1[r], x);   // A x / Kinf x
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!state(r) && last) continue;
        // u = -Kinf x - d as an exact subtract
        const float val = state(r) ? xo[r] : -a1[r] - F[i * PU + fcol[r]];
        const int a = i * C + col[r];
        const int o = i * tstr[r];
        const float2 su = SU[a];
        const float du = su.y;
        const float old = su.x;
        const float sn = clamp_nan(val + du, lo[r][o], hi[r][o]);
        const float dn = du + val - sn;
        SU[a] = make_float2(sn, dn);
        if (checking) {
          const float prev = (SAVE && stale) ? V[a] : old;
          if (SAVE && !stale) V[a] = old;
          const float pr = fabsf(val - sn), du_ = fabsf(prev - sn);
          if (state(r)) {
            ps = max_nan(ps, pr);
            ds = max_nan(ds, du_);
          } else {
            pi = max_nan(pi, pr);
            di = max_nan(di, du_);
          }
        }
        if (state(r)) {
          if (last) dvgN[r] = sn - dn;
        } else {
          X[NX + feat[r]] = val;
          if (i == 0) u0[r] = val;
        }
      }
      if (last) break;
      sync();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!state(r)) continue;
        float u[NU];
        load(u, X + NX);
        // x+ = (A x + B u) + f
        xo[r] = a1[r] + dot(bm[r], u) + fv[r];
        X[feat[r]] = xo[r];
      }
      sync();
    }
    if (checking) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        ps = max_nan(ps, __shfl_xor_sync(mask, ps, off, G));
        pi = max_nan(pi, __shfl_xor_sync(mask, pi, off, G));
        ds = max_nan(ds, __shfl_xor_sync(mask, ds, off, G));
        di = max_nan(di, __shfl_xor_sync(mask, di, off, G));
      }
    }
    return {ps, pi, ds, di};
  }

  // The slack, dual and saved column of owned row r at step i.
  __device__ __forceinline__ float& slack(int r, int i) const {
    return SU[i * C + col[r]].x;
  }
  __device__ __forceinline__ float& dual(int r, int i) const {
    return SU[i * C + col[r]].y;
  }
  __device__ __forceinline__ float& saved(int r, int i) const {
    return V[i * C + col[r]];
  }
};

}  // namespace tinympc
