// One ADMM iteration of one problem spread over a group of G threads, its
// trajectories in shared memory for the whole solve: the iteration of the
// resident solve (admm_group.cu: box at fixed rho, consensus within the
// batch, adaptive rho; the constraint families beyond the box at fixed and
// adaptive rho) and of the fused closed loop (closed_loop_fused.cu).
//
// The arithmetic is admm_sweep.cuh's backward_sweep / forward_sweep (with
// admm_families.cuh's hooks), term for term: every row's dot product is
// summed from zero
// in the same column order with explicit fmaf, and every elementwise term
// rounds as there (built with -fmad=false). Only who computes a row, and
// where its operands live, changes:
//   * A problem has NX + NU rows: state rows 0..NX-1 and input rows
//     NX..NX+NU-1. Thread g of the group owns the R = ceil((NX + NU) / G)
//     rows g, g + G, g + 2G, ... (rows past NX + NU are idle: at (6, 3) a
//     group of 8, thread 0 owning rows 0 and 8, the others' second row
//     idle) and keeps that row of every matrix the sweeps
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
//     slot in shared memory, each part padded to whole float4s (x at 0, r /
//     u at align4(NX), w after align4(NU) more): each owner writes its entry, the group meets
//     at __syncwarp (a group lies inside one warp), and every thread reads
//     the whole vector back (broadcast) for its own rows' dot products.
//   * The four residual maxima of a check iteration are each thread's
//     maxima of its own rows, then reduced over the group by shuffles;
//     max_nan is order-free (a NaN sticks whichever order it comes in).
// Both sweeps give both roles the same instruction stream (a dot product
// of length NX, an exchange, one of length NU, an exchange); only the
// short tails differ.
//
// Policies (template parameters of GroupSweep, as admm_sweep.cuh takes
// FixedRho / NoConsensus): GroupFixedRho and GroupNoConsensus compile to
// the box solve's code. GroupConsensus (admm_consensus.cuh's hooks) gives
// each input row its row of Kinf0 and Quu0_inv, in registers, for step 0
// of the sweeps, and its consensus slack zc0 and dual yc0, also in
// registers; r[0] gains -rho_c (zc0 - yc0). The exchange of offers between
// a scenario group's problems runs in the kernel (admm_group.cu).
// GroupAdaptiveRho (admm_adaptive.cuh's hooks) keeps the problem's rho,
// the guard's virtual rho and drho on every thread of the group (the same
// values on each); each row reads its rows of the sensitivities from the
// table (shared memory where the table is), which leaves the adaptive
// kinds the fixed-rho budget of registers: every product the Taylor update
// moves is the base product plus drho times the sensitivity product,
// summed apart and added last.
// On an adaptation iteration the forward sweep folds the OSQP residuals
// in, as admm_stream_team.cuh's team forward does: the state rows leave
// their new dual g[i] in the problem's g slot before the step's first
// exchange, and after it every row folds in row i-1's terms (A^T g[i] or
// B^T g[i], its own x / u, new slack and dual, and a state row's dynamics
// row i-2); the terminal row's Pinf x[N-1] reads x[N-1] from the slot.
// The four maxima reduce over the group with max_nan; no scratch array.
// GroupFamilies (admm_families.cuh's hooks) gives each family that is on a
// (slack, dual) column pair a row of its side and step in the arena. Each
// row subtracts its families' rho (slack - dual) from its linear cost after
// the box's (SOC, hyperplane, time-varying hyperplane; the terminal state
// row too). The projections are off the sweeps' chain (nothing of the
// rollout or the residuals reads a family's slack): the forward sweep
// leaves each row's x[i] or u[i] in the slack of its side's first family,
// which the backward sweep has already read, and after the sweep thread t
// of the group projects steps t, t + G, ...: each side's whole candidate
// (x + dual, from the dual before its update) with admm_families.cuh's
// projections in feature order, then every feature's slack and dual.
#pragma once

#include "admm_adaptive.cuh"
#include "admm_families.cuh"
#include "admm_sweep.cuh"

namespace tinympc {

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// Shared-memory layout of a block's problems, in floats from the arena's
// start (16-byte aligned): the exchange slots (P, kSlot) -- x, r / u and w,
// each padded to whole float4s, and under adaptive rho (XSLOT floats) the
// g slot --, then the slack and dual of every column side by side ((N,
// P * (NX + NU)) float2s: one 8-byte access reads or writes both), the
// saved-slack columns when the arena holds them (N, P * (NX + NU)), then
// the input rows' feedforward (N - 1, P * NU), then under consensus
// (LANES floats a problem) the offers (LANES, P) and the cluster's exit
// vote (4 floats); then, from a 16-byte boundary, the (slack, dual)
// float2 columns of the families that are on: fx state families (N,
// P * NX) each, then fu input families (N - 1, P * NU) each.
// kernels/admm_fused.py:group_arena_floats sums the same; the wrappers
// check it against tinympc_*_smem when they load a library.
template <int NX, int NU, int XSLOT = 0, int LANES = 0>
struct GroupArena {
  static constexpr int kRows = NX + NU;
  static constexpr int kUO = align4(NX);              // r / u in the slot
  static constexpr int kWO = kUO + align4(NU);        // w in the slot
  static constexpr int kXSlot = kWO + align4(NU);
  static constexpr int kSlot = kXSlot + XSLOT;
  // Floats before the consensus lane arrays.
  static __host__ __device__ int lanes_at(int N, int P, bool saved) {
    return P * kSlot + (saved ? 3 : 2) * N * P * kRows + (N - 1) * P * NU;
  }
  // Floats before the family columns.
  static __host__ __device__ int fams_at(int N, int P, bool saved) {
    return align4(lanes_at(N, P, saved) + (LANES ? LANES * P + 4 : 0));
  }
  static __host__ __device__ int floats(int N, int P, bool saved, int fx = 0,
                                        int fu = 0) {
    if (!fx && !fu)
      return lanes_at(N, P, saved) + (LANES ? LANES * P + 4 : 0);
    return fams_at(N, P, saved) +
           2 * P * (N * NX * fx + (N - 1) * NU * fu);
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

// Fixed rho: one rho for every problem; no hook, no table.
struct GroupFixedRho {
  struct Args {};
  static constexpr bool kAdaptive = false;
  static constexpr bool kApplyC = false;
  static constexpr int kSlotExtra = 0;
  static __host__ __device__ int table_floats(int, int) { return 0; }
};

// No consensus: no hook, no table, no lane array.
struct GroupNoConsensus {
  struct Args {};
  static constexpr bool kHooks = false;
  static constexpr int kLaneFloats = 0;
  static __host__ __device__ int table_floats(int, int) { return 0; }
};

// Per-launch consensus arguments of the group kernel: the scenario group
// size G (a power of two) and the blocks of a cluster (1 when a group lies
// in one block, else G / P), rho_c; on a warm solve the carried u (its row
// 0 seeds the slack; the x/u handed back when no iteration runs) and x,
// and the carried dual in, (N-1, nu, B), (N, nx, B) and (nu, B); the
// slack and dual out, (nu, B), and the x/u of the last iteration each
// problem ran. All pointers null on a cold solve.
struct GroupConsensusArgs {
  int group, cluster;
  float rho_c;
  const float *u_in, *x_in, *yc0_in;
  float *zc0_out, *yc0_out, *x_out, *u_out;
};

// Scenario-tree consensus on u[0] (admm_consensus.cuh's hooks, one row a
// thread): an input row's rows of Kinf0 and Quu0_inv (step 0's gains), its
// consensus slack zc0 and dual yc0, and rho_c.
template <int NX, int NU, int R>
struct GroupConsensus {
  using Args = GroupConsensusArgs;
  static constexpr bool kHooks = true;
  static constexpr int kLaneFloats = NU;   // the offers, (NU, P)
  float k0[R][NX];
  float q0[R][NU];
  float zc[R], yc[R];
  float rho_c;
  // Kinf0 (NU, NX) and Quu0_inv (NU, NU) after the box tables.
  static __host__ __device__ int table_floats(int nx, int nu) {
    return nu * nx + nu * nu;
  }
};

// Adaptive rho: the problem's rho (the carry's on a warm solve) and the
// guard's virtual rho, drho = rho - rho0 of the iteration, and `t`, the
// adaptive tables after the box tables (and the family tables), from which
// each owned row reads its sensitivity rows -- dKinf (an input row),
// dKinf^T (a state row), under apply_c dC1 (an input row) and dC2 (a state
// row) -- and a state row its rows of A^T, Pinf and dPinf (the
// adaptation's).
template <int NX, int NU, int R, bool APPLY_C>
struct GroupAdaptiveRho {
  using Args = AdaptArgs;
  static constexpr bool kAdaptive = true;
  static constexpr bool kApplyC = APPLY_C;
  static constexpr int kSlotExtra = align4(NX);   // the g slot
  float pdp[R];       // -dPinf^T Xref[N-1] (a state row)
  float rho0, rho, rho_v, drho;
  const float* t;
  static __host__ __device__ int table_floats(int nx, int nu) {
    return AdaptiveLayout(nx, nu, APPLY_C).total;
  }
};

// Per-launch family arguments of the group kernel: the six family sizes
// (state and input cones, hyperplanes, time-varying hyperplanes; 0 for a
// family that is off); on a warm solve the carried duals of the families
// that are on, (N, nx, B) or (N-1, nu, B), and the carried x and u, whose
// rows seed the slacks; the duals out and the x/u of the last iteration
// each problem ran. Pointers of families that are off, and all of a cold
// solve, are null; x/u are null too where no family is on (a box-only
// problem at (6, 3)).
struct GroupFamilyArgs {
  int ncx, ncu, nlx, nlu, ntx, ntu;
  const float *gc_in, *yc_in, *gl_in, *yl_in, *gtv_in, *ytv_in;
  const float *x_in, *u_in;
  float *gc_out, *yc_out, *gl_out, *yl_out, *gtv_out, *ytv_out;
  float *x_out, *u_out;
};

__host__ __device__ inline FamilyLayout family_layout(
    const GroupFamilyArgs& a, int nx, int nu, int N) {
  FamilyArgs f = {};
  f.ncx = a.ncx;
  f.ncu = a.ncu;
  f.nlx = a.nlx;
  f.nlu = a.nlu;
  f.ntx = a.ntx;
  f.ntu = a.ntu;
  return FamilyLayout(f, nx, nu, N);
}

// No families: no hook, no table, no column.
struct GroupNoFamilies {
  struct Args {};
  static constexpr bool kOn = false;
};

// The families beyond the box (admm_families.cuh's hooks). Family f of a
// side (in the order SOC, hyperplane, time-varying hyperplane, counting
// only those that are on) keeps row k's (slack, dual) of step i at
// xs[f * N * P * NX + i * P * NX + k] (a state row) or us[f * (N - 1) *
// P * NU + i * P * NU + k] (an input row), where xs and us are problem
// p's first state and input columns after the feedforward (from a 16-byte
// boundary). Each owned row keeps only its own column of its side's first
// family at step 0; the counts and strides are read from the launch's
// arguments where they are needed, so that the families add two registers
// a row to the sweeps.
template <int NX, int NU, int R>
struct GroupFamilies {
  using Args = GroupFamilyArgs;
  static constexpr bool kOn = true;
  float2* col[R];   // owned row r's column, side's family 0, step 0
  static __host__ __device__ int table_floats(const Args& a, int nx, int nu,
                                              int N) {
    return family_layout(a, nx, nu, N).total;
  }
  static __host__ __device__ int state_sides(const Args& a) {
    return (a.ncx > 0) + (a.nlx > 0) + (a.ntx > 0);
  }
  static __host__ __device__ int input_sides(const Args& a) {
    return (a.ncu > 0) + (a.nlu > 0) + (a.ntu > 0);
  }
  // The first family column of the block: the feedforward's end, F +
  // (N - 1) P NU, rounded up to 16 bytes (the arena starts on 16 bytes).
  static __device__ __forceinline__ float2* base(const float* F, int N,
                                                 int P) {
    const size_t a = reinterpret_cast<size_t>(F + (N - 1) * P * NU);
    return reinterpret_cast<float2*>((a + 15) & ~size_t(15));
  }
  // Problem p's first state column and first input column.
  static __device__ __forceinline__ float2* xs(float2* b, int p) {
    return b + p * NX;
  }
  static __device__ __forceinline__ float2* us(const Args& a, float2* b,
                                               int N, int P, int p) {
    return b + state_sides(a) * N * P * NX + p * NU;
  }
  // A side's families, step stride and family stride.
  static __device__ __forceinline__ int sides(const Args& a, bool st) {
    return st ? state_sides(a) : input_sides(a);
  }
  static __device__ __forceinline__ int step(bool st, int P) {
    return st ? P * NX : P * NU;
  }
  static __device__ __forceinline__ int gap(bool st, int N, int P) {
    return st ? N * P * NX : (N - 1) * P * NU;
  }

  // Owned row r (state or input, feature k) of problem p.
  __device__ __forceinline__ void init(int r, const Args& a, const float* F,
                                       int N, int P, int p, bool st, int k) {
    float2* b = base(F, N, P);
    col[r] = (st ? xs(b, p) : us(a, b, N, P, p)) + k;
  }

  // Family f of row r's side at step i.
  __device__ __forceinline__ float2& at(int r, bool st, int i, int f,
                                        int N, int P) const {
    return col[r][i * step(st, P) + f * gap(st, N, P)];
  }

  // The row's linear-cost terms after the box's: acc - rho (slack - dual)
  // of each family of its side, in order (admm_families.cuh's q_terms /
  // r_terms / p_terminal).
  __device__ __forceinline__ float terms(int r, bool st, int i, float acc,
                                         float rho, const Args& a, int N,
                                         int P) const {
    const int n = sides(a, st);
    const float2* c = col[r] + i * step(st, P);
    const int gs = gap(st, N, P);
    for (int f = 0; f < n; ++f) {
      const float2 v = c[f * gs];
      acc = acc - rho * (v.x - v.y);
    }
    return acc;
  }

  // The row's x[i] / u[i] into the slack of its side's first family, whose
  // slack the backward sweep of this iteration has read.
  __device__ __forceinline__ void keep(int r, bool st, int i, float val,
                                       const Args& a, int P) const {
    if (sides(a, st))
      reinterpret_cast<float*>(col[r] + i * step(st, P))[0] = val;
  }

  // One family of a side at a step: its candidate x + dual from the kept
  // x[i] / u[i] (`c`, family 0's slacks) and the dual before the update,
  // projected by `proj`, then the slack and the dual written back
  // (admm_families.cuh's state_row / input_row and store).
  template <int F, class Proj>
  static __device__ __forceinline__ void one(const float2* c, float2* s,
                                             Proj proj) {
    float z[F];
#pragma unroll
    for (int k = 0; k < F; ++k) z[k] = c[k].x + s[k].y;
    proj(z);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      const float v = c[k].x, d = s[k].y;
      s[k] = make_float2(z[k], d + v - z[k]);
    }
  }

  // One side of step i, each family that is on from the same kept x[i] /
  // u[i]; family 0 last, since its slack holds them. The tables: cones,
  // hyperplane rows, b, ||a||^2; the time-varying ones at step i.
  template <int F>
  static __device__ __forceinline__ void side(
      float2* c, int gs, int nc, int nl, int nt, const float* cones,
      const float* al, const float* bl, const float* aq, const float* tva,
      const float* tvb, const float* tvq) {
    int f = (nc > 0) + (nl > 0) + (nt > 0);
    if (nt)
      one<F>(c, c + --f * gs, [&](float (&z)[F]) {
        for (int q = 0; q < nt; ++q)
          project_hyperplane<F>(z, tva + q * F, tvb[q], tvq[q]);
      });
    if (nl)
      one<F>(c, c + --f * gs, [&](float (&z)[F]) {
        for (int q = 0; q < nl; ++q)
          project_hyperplane<F>(z, al + q * F, bl[q], aq[q]);
      });
    if (nc)
      one<F>(c, c + --f * gs, [&](float (&z)[F]) {
        project_cones<F>(z, cones, nc);
      });
  }

  // The projections of an iteration, after its forward sweep: thread g of
  // problem p's group (G threads) takes steps g, g + G, ...; `ft` the
  // family tables (FamilyLayout's, after the box tables), F the block's
  // feedforward.
  static __device__ void project(const Args& a, const float* ft,
                                 const float* F, int N, int P, int p, int g,
                                 int G) {
    const FamilyLayout L = family_layout(a, NX, NU, N);
    float2* b = base(F, N, P);
    float2* x = xs(b, p);
    float2* u = us(a, b, N, P, p);
    const bool fx = state_sides(a) > 0, fu = input_sides(a) > 0;
    for (int i = g; i < N; i += G) {
      if (fx)
        side<NX>(x + i * P * NX, N * P * NX, a.ncx, a.nlx, a.ntx,
                 ft + L.xcones, ft + L.alx, ft + L.blx, ft + L.aqx,
                 ft + L.tvax + i * a.ntx * NX, ft + L.tvbx + i * a.ntx,
                 ft + L.tvqx + i * a.ntx);
      if (fu && i < N - 1)
        side<NU>(u + i * P * NU, (N - 1) * P * NU, a.ncu, a.nlu, a.ntu,
                 ft + L.ucones, ft + L.alu, ft + L.blu, ft + L.aqu,
                 ft + L.tvau + i * a.ntu * NU, ft + L.tvbu + i * a.ntu,
                 ft + L.tvqu + i * a.ntu);
    }
  }
};

// The four maxima of the OSQP residuals of an adaptation iteration
// (admm_adaptive.cuh's adapt), reduced over the group.
struct AdaptMaxima {
  float pri_res, pri_norm, dual_res, dual_norm;
};

template <int NX, int NU, int G, class Rho = GroupFixedRho,
          class Cons = GroupNoConsensus, class Fam = GroupNoFamilies>
struct GroupSweep {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0,
                "a group is a power of two inside one warp");
  static constexpr int kRows = NX + NU;
  static constexpr int R = (kRows + G - 1) / G;   // rows a thread owns
  static constexpr int kNX4 = align4(NX), kNU4 = align4(NU);
  using Arena =
      GroupArena<NX, NU, Rho::kSlotExtra, Cons::kLaneFloats>;

  float m1[R][NX];   // backward, length NX: AmBKt row k / B^T row j
  float m2[R][NU];   // backward, length NU: KinfT row k / Quu_inv row j
  float f1[R][NX];   // forward, length NX: A row k / Kinf row j
  float bm[R][NU];   // forward, length NU: B row k (input rows: unused)
  float add[R];      // APf[k] / BPf[j]
  float fv[R];       // f[k]
  float wt[R];       // Qd[k] / Rd[j]
  bool st[R];        // a state row
  bool on[R];        // a row of the problem (else idle)
  int feat[R];       // k or j
  int tstr[R];       // NX or NU: the table stride of a step
  int col[R];        // column of the slack / dual / saved columns
  int fcol[R];       // column of the feedforward (input rows)
  const float* ref[R];   // reference row: Xref[., k] / Uref[., j]
  const float* lo[R];    // bounds: xmin / umin
  const float* hi[R];    // xmax / umax
  float2* SU;        // (slack, dual) of each row and step
  float *V, *F, *X;
  int C, PU, NP;     // columns, feedforward columns, problems a block
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
    NP = P;
    X = arena + p * Arena::kSlot;
    SU = reinterpret_cast<float2*>(arena + P * Arena::kSlot);
    V = saved_in_arena ? arena + P * Arena::kSlot + 2 * N * C : saved;
    F = arena + P * Arena::kSlot + (saved_in_arena ? 3 : 2) * N * C;
    const int lane = threadIdx.x & 31;
    mask = G == 32 ? 0xffffffffu : ((1u << G) - 1) << (lane & ~(G - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = g + r * G;
      on[r] = row < kRows;
      st[r] = row < NX;
      // An idle row reads input row 0's tables and is skipped everywhere.
      const int k = st[r] ? row : on[r] ? row - NX : 0;
      feat[r] = k;
      tstr[r] = st[r] ? NX : NU;
      // Rows split exactly: thread after thread, row r of every thread
      // after row r - 1's; else each problem's rows side by side.
      col[r] = kRows == R * G ? r * (P * G) + p * G + g : p * kRows + row;
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

  // Whether owned row r is a row of the problem: known at compile time
  // where every thread's row r is ((r + 1) G <= NX + NU).
  __device__ __forceinline__ bool active(int r) const {
    if ((r + 1) * G <= kRows) return true;
    return on[r];
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

  // n floats (a multiple of 4) of the slot at s.
  template <int n>
  static __device__ __forceinline__ void load(float (&v)[n], const float* s) {
    static_assert(n % 4 == 0, "whole float4s");
#pragma unroll
    for (int q = 0; q < n / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(s)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }

  // The n entries of a matrix row against the first n of v, from zero in
  // column order.
  template <int n, int nv>
  static __device__ __forceinline__ float dot(const float (&m)[n],
                                              const float (&v)[nv]) {
    static_assert(nv >= n, "the vector holds the row's columns");
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < n; ++c) acc = fmaf(m[c], v[c], acc);
    return acc;
  }

  // A row of n columns of a table in shared or device memory against v,
  // from zero in column order.
  template <int n, int nv>
  static __device__ __forceinline__ float dotp(const float* m,
                                               const float (&v)[nv]) {
    static_assert(nv >= n, "the vector holds the row's columns");
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < n; ++c) acc = fmaf(m[c], v[c], acc);
    return acc;
  }

  // -Pinf^T xN of a state row (admm_pallas.py:823): its row of PinfT
  // against the reference's last row, from zero in column order. (Under
  // adaptive rho the same with dPinf^T gives the sensitivity.)
  __device__ __forceinline__ float pnref(int r, const float* pinft,
                                         const float* xN) const {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < NX; ++j) acc = fmaf(pinft[feat[r] * NX + j], xN[j], acc);
    return -acc;
  }

  // The backward sweep (admm_sweep.cuh:backward_sweep): the state rows
  // start p from pterm = -Pinf^T Xref[N-1] - rho (vnew[N-1] - g[N-1]) (and
  // the families' terminal terms); rows N-2 .. 0 of the linear cost from
  // the slacks and duals, the families' terms after the box's, the input
  // rows' d into F. Under consensus an input row's r[0] gains
  // -rho_c (zc0 - yc0) and d[0] takes Quu0_inv; under adaptive rho (rho
  // the problem's) Kinf^T r and, under apply_c, AmBKt p and Quu_inv w gain
  // their drho-scaled sensitivity products.
  __device__ void backward(int N, float rho, const float (&pterm)[R],
                           const Rho& rh = Rho(),
                           const Cons& cs = Cons(),
                           const Fam& fm = Fam(),
                           const typename Fam::Args& fa = {}) const {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (state(r)) X[feat[r]] = pterm[r];
    sync();
    for (int i = N - 2; i >= 0; --i) {
      float p[kNX4];
      load(p, X);
      float lin[R], a1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!active(r)) continue;
        const float2 su = SU[i * C + col[r]];
        // q = -(Xref .* Q) - rho (v - g), r = -(Uref .* R) - rho (z - y)
        lin[r] = -(ref[r][i * tstr[r]] * wt[r]) - rho * (su.x - su.y);
        if constexpr (Fam::kOn)
          lin[r] = fm.terms(r, state(r), i, lin[r], rho, fa, N, NP);
        if constexpr (Cons::kHooks) {
          if (i == 0 && !state(r))
            lin[r] = lin[r] - cs.rho_c * (cs.zc[r] - cs.yc[r]);
        }
        a1[r] = dot(m1[r], p);                  // AmBKt p  /  B^T p
        if constexpr (Rho::kApplyC) {
          if (state(r)) {
            const AdaptiveLayout AL(NX, NU, Rho::kApplyC);
            a1[r] = a1[r] +
                    rh.drho * dotp<NX>(rh.t + AL.dc2 + feat[r] * NX, p);
          }
        }
        if (!state(r)) {
          X[Arena::kUO + feat[r]] = lin[r];
          X[Arena::kWO + feat[r]] = a1[r] + lin[r] + add[r];   // w
        }
      }
      sync();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!active(r)) continue;
        float v[kNU4];
        load(v, X + (state(r) ? Arena::kUO : Arena::kWO));   // r  /  w
        float a2;                               // Kinf^T r  /  Quu_inv w
        if constexpr (Cons::kHooks) {
          a2 = (i == 0 && !state(r)) ? dot(cs.q0[r], v) : dot(m2[r], v);
        } else {
          a2 = dot(m2[r], v);
        }
        if constexpr (Rho::kAdaptive) {
          if (state(r) || Rho::kApplyC) {
            const AdaptiveLayout AL(NX, NU, Rho::kApplyC);
            a2 = a2 + rh.drho * dotp<NU>(rh.t + (state(r) ? AL.dkt : AL.dc1) +
                                             feat[r] * NU, v);
          }
        }
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
  // (input rows) <- the raw u[0]. Under consensus an input row's u[0]
  // takes Kinf0; under adaptive rho Kinf x gains drho dKinf x, and with
  // `adapting` the OSQP residuals of the iteration are folded in and their
  // maxima, reduced over the group, written to *am. With families (fm, the
  // launch's family arguments fa) each row keeps its x[i] / u[i] for the
  // projections (GroupFamilies::keep).
  template <bool SAVE>
  __device__ Residuals forward(int N, const float (&x0)[R], float (&dvgN)[R],
                               bool checking, bool stale,
                               float (&u0)[R], const Rho& rh = Rho(),
                               const Cons& cs = Cons(),
                               bool adapting = false,
                               AdaptMaxima* am = nullptr,
                               const Fam& fm = Fam(),
                               const typename Fam::Args& fa = {}) const {
    float xo[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xo[r] = x0[r];
      if (state(r)) X[feat[r]] = xo[r];
    }
    sync();
    float ps = 0.f, pi = 0.f, ds = 0.f, di = 0.f;
    // Under adaptive rho: the adaptation's maxima; the step's x_i / u_i,
    // new slack and dual of each row (vl, sl, dl); what row i's terms keep
    // until g[i+1] is in the g slot (pa, pb, pc), and a state row's
    // dynamics rows i-1 (ad1) and i-2 (ad2) at step i.
    float pres = 0.f, pnorm = 0.f, dres = 0.f, dnorm = 0.f;
    float vl[R], sl[R], dl[R], pa[R], pb[R], pc[R], ad1[R], ad2[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      vl[r] = sl[r] = dl[r] = pa[r] = pb[r] = pc[r] = ad1[r] = ad2[r] = 0.f;
    float* const GS = X + Arena::kXSlot;   // the g slot (adaptive rho)
    // Row j's OSQP terms (admm_adaptive.cuh's adapt), g[j+1] in the g
    // slot; ad2 is then the dynamics row j-1.
    auto terms = [&](int j) {
      if constexpr (Rho::kAdaptive) {
      const AdaptiveLayout AL(NX, NU, Rho::kApplyC);
      float gv[kNX4];
      load(gv, GS);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!active(r)) continue;
        if (state(r)) {
          // P x = Q x on the stages; A^T g[j+1] - g[j]; the dynamics row
          // j-1 against the slack of state row j.
          const float atg = dotp<NX>(rh.t + AL.at + feat[r] * NX, gv);
          const float qx = wt[r] * pa[r];
          const float px = qx;
          const float aty = atg - (j >= 1 ? pb[r] : 0.f);
          dres = maxabs(dres, px + qx + aty);
          dnorm = maxabs(maxabs(maxabs(dnorm, px), aty), qx);
          if (j >= 1) {
            pres = maxabs(pres, ad2[r] - pc[r]);
            pnorm = maxabs(maxabs(pnorm, ad2[r]), pc[r]);
          }
        } else {
          // R u and y + B^T g[j+1]
          const float btg = dot(m1[r], gv);
          const float ru = wt[r] * pa[r];
          const float aty = pb[r] + btg;
          dres = maxabs(dres, 2.f * ru + aty);
          dnorm = maxabs(maxabs(dnorm, ru), aty);
          pres = maxabs(pres, pa[r] - pc[r]);
          pnorm = maxabs(maxabs(pnorm, pa[r]), pc[r]);
        }
      }
      }
    };
    for (int i = 0; i < N; ++i) {
      const bool last = i == N - 1;
      float a1[R];
      if (!last) {
        float x[kNX4];
        load(x, X);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // A x / Kinf x (Kinf0 at step 0 under consensus; under adaptive
          // rho + drho dKinf x)
          if constexpr (Cons::kHooks) {
            a1[r] = (i == 0 && !state(r)) ? dot(cs.k0[r], x) : dot(f1[r], x);
          } else {
            a1[r] = dot(f1[r], x);
          }
          if constexpr (Rho::kAdaptive) {
            if (!state(r)) {
              const AdaptiveLayout AL(NX, NU, Rho::kApplyC);
              a1[r] = a1[r] + rh.drho * dotp<NX>(rh.t + AL.dk + feat[r] * NX, x);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!active(r)) continue;
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
        if constexpr (Fam::kOn) fm.keep(r, state(r), i, val, fa, NP);
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
          X[Arena::kUO + feat[r]] = val;
          if (i == 0) u0[r] = val;
        }
        if constexpr (Rho::kAdaptive) {
          if (adapting) {
            if (state(r)) GS[feat[r]] = dn;   // g[i], for row i-1's terms
            vl[r] = val;
            sl[r] = sn;
            dl[r] = dn;
          }
        }
      }
      if (last) break;
      sync();
      float axd[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        axd[r] = 0.f;
        if (!state(r)) continue;
        float u[kNU4];
        load(u, X + Arena::kUO);
        // x+ = (A x + B u) + f; (A x + B u) - x+ is the dynamics row of
        // the OSQP residuals of adaptive rho (exactly 0 when f = 0)
        const float s = a1[r] + dot(bm[r], u);
        xo[r] = s + fv[r];
        X[feat[r]] = xo[r];
        if constexpr (Rho::kAdaptive) axd[r] = s - xo[r];
      }
      if constexpr (Rho::kAdaptive) {
        if (adapting) {
          if (i >= 1) terms(i - 1);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            pa[r] = vl[r];
            pb[r] = dl[r];
            pc[r] = sl[r];
            ad2[r] = ad1[r];
            ad1[r] = axd[r];
          }
        }
      }
      sync();
    }
    if constexpr (Rho::kAdaptive) {
      if (adapting) {
        sync();   // g[N-1] in the g slot; x[N-1] is in the x slot
        terms(N - 2);
        float x[kNX4];
        load(x, X);
        const AdaptiveLayout AL(NX, NU, Rho::kApplyC);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (!state(r)) continue;
          // Row N-1: P x the terminal Pinf telescoped by drho dPinf, no
          // A^T g term, and the dynamics row N-2 against the slack of
          // row N-1.
          const float pp = dotp<NX>(rh.t + AL.pinf + feat[r] * NX, x);
          const float dp = dotp<NX>(rh.t + AL.dp + feat[r] * NX, x);
          const float px = pp + rh.drho * dp;
          const float qx = wt[r] * vl[r];
          const float aty = 0.f - dl[r];
          dres = maxabs(dres, px + qx + aty);
          dnorm = maxabs(maxabs(maxabs(dnorm, px), aty), qx);
          pres = maxabs(pres, ad1[r] - sl[r]);
          pnorm = maxabs(maxabs(pnorm, ad1[r]), sl[r]);
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
          pres = max_nan(pres, __shfl_xor_sync(mask, pres, off, G));
          pnorm = max_nan(pnorm, __shfl_xor_sync(mask, pnorm, off, G));
          dres = max_nan(dres, __shfl_xor_sync(mask, dres, off, G));
          dnorm = max_nan(dnorm, __shfl_xor_sync(mask, dnorm, off, G));
        }
        *am = {pres, pnorm, dres, dnorm};
      }
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
