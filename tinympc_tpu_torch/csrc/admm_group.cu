// Fused batched ADMM solve, cold or warm start: of box-constrained
// problems at fixed rho, one system or a fleet (a system a 128-lane tile)
// -- the main path's kernel --; with consensus on u[0] within scenario
// groups of the batch; and at adaptive rho, one system or a fleet; and of
// problems with the constraint families beyond the box (second-order
// cones, hyperplanes, time-varying hyperplanes, in any mix) and of every
// problem at (6, 3), at fixed and at adaptive rho.
//
// Replaces those variants of the TPU kernel
// tinympc_tpu/kernels/admm_pallas.py:_make_kernel (launched by _fused_call;
// the multi_tps variant, :532-575): the cold solve (solve_fused), the warm
// solve with its carry (solve_fused_warm, FusedCarry; final=True too, which
// keeps no snapshots here), and solve_fused_multi / the fleet solver; and,
// for box problems at (12, 4), its consensus variant (`consensus`, `group`,
// `rho_c`) and its adaptive-rho variant (`adaptive`, `apply_c`, `rho_tol`;
// multi_tps too), and, at (12, 4) and (6, 3), its family parts
// (_project_soc_rows, _apply_cones, _apply_hyperplanes,
// _apply_tv_hyperplanes, :283-351; their seeds :670-692, linear-cost terms
// :896-927 and slack and dual updates :1009-1046), at fixed and adaptive
// rho (:861-925). One launch runs the whole ADMM loop for every problem of
// the batch, termination every check_termination iterations, and a
// per-block exit once every problem of the block (of the cluster, under
// consensus across blocks) has converged. Consensus with a family or at
// (6, 3), group 0, a consensus group whose cluster cannot be formed, the
// multi-system launch with a family or at (6, 3), and a families horizon
// whose arena does not fit one problem a block run csrc/admm_fused.cu.
//
// What bounds it on an H100: operations. The main path (nx=12, nu=4,
// N=20, B=32768, ~97.7 mean iterations) does ~9.4k FMA a problem and
// iteration, 1.1025 ms at the FP32 peak of 67 TFLOP/s; its bytes (x0,
// the tables, the outputs) take ~0.01 ms. The first design (one thread a
// problem, trajectories lane-last in device memory, read and written every
// iteration) took 17.5564 ms on an NVIDIA H100 80GB HBM3 at 700 W: ~8
// warps an SM at that batch, each thread running the 38-step chain of
// 16-row matvecs alone, and ~6.9 KB a problem and iteration through device
// memory.
//
// Design (admm_group.cuh):
//   * One problem a group of G threads (16 at (12, 4): a thread a row of
//     the problem), P problems a block (8 for the main path: 128 threads,
//     each group a half warp). Each thread keeps its rows of the small
//     matrices in registers and computes only its rows' dot products, so
//     the serial chain of an iteration is 38 steps of a 12- and a 4-term
//     dot product, not of a 16-row matvec.
//   * A problem's trajectories (slacks, duals, feedforward; the saved
//     slack of a warm solve) stay in shared memory from the first
//     iteration to the last: device memory is read at the start (x0, the
//     carry in, the tables) and written at the end (the outputs, the carry
//     out). One copy of each slack, no ping-pong.
//   * The packed table sits in shared memory beside the arena when both
//     fit (every N the main path and the serving loop use); past that the
//     kernel reads its per-step rows from device memory, where every
//     problem of the launch shares them (L1 / L2), and its arena alone
//     takes shared memory. P shrinks by halves first. A warm solve past
//     N = 1117 at (12, 4), where one problem's three columns a row fill a
//     block's shared memory, keeps its saved columns in a device-memory
//     buffer of the arena's layout (Place, admm_group.cuh); the slacks,
//     duals and feedforward stay in shared memory.
//   * A converged problem stops and keeps its iterates (its result does not
//     depend on its block-mates); block exit on check iterations, as
//     before. A fleet's block loads the table of block_sys[first lane /
//     128]: P divides 128, so a block never straddles two systems' tiles.
//     block_sys is read once a block (null: one system), so the fleet and
//     the single system share one instantiation.
//   * Warm start: the slack columns start from the carried vnew/znew, the
//     duals from g/y, the saved columns from the carried v/z, which
//     iteration 0's dual residual compares against; a later check
//     iteration saves the slack it overwrites. The carry out is then
//     vnew/znew = the last slack; v/z = the saved slack of a lane that
//     converged (the carried one if it converged at iteration 0) or the
//     last slack of one that ran out; g/y = the duals.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, section 6): the
// main path 5.7650-6.0085 ms in turns with the first design's
// 17.2530-17.3787 (chip_compare.py time), every output bitwise the first
// design's; 5.4 ms of it device time (torch.profiler), 20% of the bound.
// G=16, P=8 and a budget of 4 blocks an SM were chosen by timing copies
// of this file at G=4 and G=8 and at other budgets (PERF.md, section 6).
//
// Consensus (admm_consensus.cuh's rule, GroupConsensus in admm_group.cuh):
// a scenario group is G adjacent problems. After every iteration each
// running problem's input rows write its offer u[0] + yc0 into the
// block's (NU, P) offers array, every thread of the block meets a barrier
// (a converged or out-of-range problem's too), each running input row
// sums its group's G offers in lane order from zero, divides by G
// (div_rn), moves zc0 and yc0, and the group's threads reduce
// max|u[0] - zc0| for the gate; a second barrier keeps the next offers
// from overwriting offers still being read. A converged problem freezes
// and its last offer stands. G <= P: the group lies in one block and the
// barriers are __syncthreads. G > P: the group is a thread-block cluster
// of G / P blocks (cudaLaunchKernelEx with a cluster dimension; past 8
// blocks a non-portable size), the offers of the other blocks are read
// through distributed shared memory (map_shared_rank) and the barriers are
// cluster barriers; the exit is voted over the cluster (each block's
// "any running" flag in its arena, read by every block after the second
// barrier), so no block leaves while a cluster-mate may still read its
// offers, and a last cluster barrier precedes the exit. A warm solve also
// carries zc0 / yc0 and the x / u of the last iteration each problem ran:
// once the loop ends, a problem's group re-runs that iteration's rollout
// from x0 and its feedforward d, still in shared memory (the one-thread
// kernel's Families::finish, whose bits it gives).
//
// Adaptive rho (GroupAdaptiveRho): each problem's rho and virtual rho on
// every thread of its group, the sensitivity rows read from the table, the
// adaptation folded into the forward sweep (admm_group.cuh) and the new
// rho formed by rho_update on every thread of the group from the same
// maxima; residual row 4 holds each problem's final rho.
//
// The families (GroupFamilies, admm_group.cuh; Kinds kFamilies*): each
// family that is on gives every row of its side a (slack, dual) column
// pair in the arena; each row subtracts its families' terms from its
// linear cost after the box's; the forward sweep leaves each row's x[i] /
// u[i] in its side's first family slack, and after the sweep the group
// projects the steps in parallel, thread g steps g, g + G, ..., each
// side's whole candidate in feature order (admm_families.cuh's
// projections): no redundant projection and no barrier a step, two a
// sweep. Termination reads the box residuals only (admm.cpp:310-328). A
// warm solve seeds the state slacks from x0 (row 0) and the carried x,
// the input slacks from the carried u, the duals from the carry, and hands
// back the duals and the x/u of the last iteration each problem ran (its
// rollout re-run, as under consensus, with drho dKinf x under adaptive
// rho). At (6, 3) a problem has 9 rows: a group of 8 threads, thread 0
// owning rows 0 and 8 (the exchange slot padded to whole float4s); a
// box-only problem there runs the families kinds with zero counts.
//
// C interface (loaded with ctypes): tinympc_admm_group returns the
// cudaError_t of the launch; it launches on the given stream and never
// synchronises.
#include <cooperative_groups.h>
#include <type_traits>

#include "admm_group.cuh"

namespace {

namespace cg = cooperative_groups;

using tinympc::AdaptArgs;
using tinympc::AdaptMaxima;
using tinympc::GroupAdaptiveRho;
using tinympc::GroupArena;
using tinympc::GroupConsensus;
using tinympc::GroupConsensusArgs;
using tinympc::GroupFamilies;
using tinympc::GroupFamilyArgs;
using tinympc::GroupFixedRho;
using tinympc::GroupNoConsensus;
using tinympc::GroupNoFamilies;
using tinympc::GroupSweep;
using tinympc::Layout;
using tinympc::Residuals;

using tinympc::Place;

// Threads a problem: a row each at (12, 4); at (6, 3), 8 threads for its
// 9 rows, thread 0 owning rows 0 and 8 (16 threads with 7 idle measured
// 20-38% slower on the rocket's launches: PERF.md, section 6).
template <int NX, int NU>
constexpr int kGroupOf = (NX == 6 && NU == 3) ? 8 : 16;
constexpr int kMaxThreads = 128;   // P * the group's width
// Blocks an SM must hold: the register budget. ptxas then keeps ~96
// registers a thread at fixed rho, at most 128 (80 under a bound of 256
// threads and no minimum, which measured slower; 3 blocks and 4 measured
// alike). The adaptive kinds use all 128 (their sensitivity rows read
// from the table, not kept in registers: in registers they spilled here,
// and at 3 blocks the hard batch ran 17% slower; PERF.md, section 6).
constexpr int kMinBlocks = 4;
constexpr int kTile = 128;         // lanes a fleet's block_sys entry covers
constexpr size_t kMaxSmem = 232448;
// Blocks of a consensus group's cluster at most: past 8 a non-portable
// cluster size, which an H100 takes to 16.
constexpr int kMaxCluster = 16;

// What a launch solves: box at fixed rho, consensus within the batch
// (fixed rho), adaptive rho without and with apply_c; the families (any
// mix, zero counts too) at fixed rho, at adaptive rho and with apply_c.
enum Kind : int {
  kBox = 0,
  kConsensus = 1,
  kAdaptive = 2,
  kAdaptiveC = 3,
  kFamilies = 4,
  kFamiliesAdaptive = 5,
  kFamiliesAdaptiveC = 6,
};

constexpr bool families_kind(int k) { return k >= kFamilies; }

// The families kinds' register budget: the most blocks an SM at which
// ptxas spills nothing. 3 (at most 168 registers) but for the cold (6, 3)
// kinds with the table in shared memory, 4 (128). At 4 the (12, 4)
// adaptive kinds spilled up to 108 bytes (the projection's candidate and
// tables on top of the sweeps' rows) and the other (6, 3) ones up to 116;
// the cold (6, 3) ones at 4 ran the rocket ~20% faster than at 3
// (PERF.md, section 6).
template <int NX, int NU, int KIND, bool WARM, int PLACE>
constexpr int kMinBlocksOf =
    !families_kind(KIND) ? kMinBlocks
    : (NX == 6 && NU == 3 && !WARM && PLACE == Place::kShared) ? 4 : 3;

template <int NX, int NU, int KIND>
struct Policies {
  static constexpr int G = kGroupOf<NX, NU>;
  static constexpr int R = (NX + NU + G - 1) / G;
  static constexpr bool kAdapt = KIND == kAdaptive || KIND == kAdaptiveC ||
                                 KIND == kFamiliesAdaptive ||
                                 KIND == kFamiliesAdaptiveC;
  static constexpr bool kApplyC =
      KIND == kAdaptiveC || KIND == kFamiliesAdaptiveC;
  using Rho = std::conditional_t<kAdapt, GroupAdaptiveRho<NX, NU, R, kApplyC>,
                                 GroupFixedRho>;
  using Cons = std::conditional_t<KIND == kConsensus,
                                  GroupConsensus<NX, NU, R>,
                                  GroupNoConsensus>;
  using Fam = std::conditional_t<families_kind(KIND),
                                 GroupFamilies<NX, NU, R>, GroupNoFamilies>;
  using Sweep = GroupSweep<NX, NU, G, Rho, Cons, Fam>;
  using Arena = typename Sweep::Arena;
  // The kernel's last argument: the consensus or the family arguments (a
  // kind has one or neither).
  using XArgs = std::conditional_t<families_kind(KIND), typename Fam::Args,
                                   typename Cons::Args>;
  // The packed table: the box tables, then the family tables, then the
  // adaptive tables or the step-0 consensus gains.
  static __host__ __device__ int table_floats(int N, const XArgs& xa) {
    int fam = 0;
    if constexpr (families_kind(KIND))
      fam = Fam::table_floats(xa, NX, NU, N);
    return Layout(NX, NU, N).total + fam + Rho::table_floats(NX, NU) +
           Cons::table_floats(NX, NU);
  }
  // Family columns of each side.
  static __host__ __device__ int arena_floats(int N, int P, bool saved,
                                              const XArgs& xa) {
    if constexpr (families_kind(KIND))
      return Arena::floats(N, P, saved, Fam::state_sides(xa),
                           Fam::input_sides(xa));
    return Arena::floats(N, P, saved);
  }
};

// The carry of a warm solve; all pointers null on a cold one.
struct Carry {
  const float *vnew_in, *znew_in, *g_in, *y_in, *v_in, *z_in;
  float *vnew_out, *znew_out, *v_out, *z_out, *g_out, *y_out;
};

// Family f of a side (state: cones, hyperplanes, time-varying; input the
// same) counting those that are on: which of the three it is.
__device__ __forceinline__ int family_kind(const GroupFamilyArgs& a, bool st,
                                           int f) {
  const int n0 = st ? a.ncx : a.ncu, n1 = st ? a.nlx : a.nlu;
  if (n0) {
    if (f == 0) return 0;
    --f;
  }
  if (n1) {
    if (f == 0) return 1;
  }
  return 2;
}

__device__ __forceinline__ const float* dual_in(const GroupFamilyArgs& a,
                                                bool st, int kind) {
  return st ? (kind == 0 ? a.gc_in : kind == 1 ? a.gl_in : a.gtv_in)
            : (kind == 0 ? a.yc_in : kind == 1 ? a.yl_in : a.ytv_in);
}

__device__ __forceinline__ float* dual_out(const GroupFamilyArgs& a, bool st,
                                           int kind) {
  return st ? (kind == 0 ? a.gc_out : kind == 1 ? a.gl_out : a.gtv_out)
            : (kind == 0 ? a.yc_out : kind == 1 ? a.yl_out : a.ytv_out);
}

// PLACE (tinympc::Place): kShared copies the packed table into shared
// memory (its reads are then shared-memory loads); kTableGlobal reads it in
// device memory; kSavedGlobal (warm only) also keeps the saved columns in
// `saved`, (grid, N, P * (NX + NU)). KIND: what the launch solves (Kind);
// ra the adaptive-rho arguments of its kind, xa its consensus or family
// arguments.
template <int NX, int NU, bool WARM, int PLACE, int KIND>
__global__ void __launch_bounds__(kMaxThreads,
                                  kMinBlocksOf<NX, NU, KIND, WARM, PLACE>)
    admm_group_kernel(
    const float* __restrict__ tables, const float* __restrict__ x0,
    float* __restrict__ out_x, float* __restrict__ out_u,
    int* __restrict__ out_iters, unsigned char* __restrict__ out_solved,
    float* __restrict__ out_res, Carry carry, int N, int B, int max_iter,
    int check_termination, float rho, float tol_pri, float tol_dua, int P,
    const int* __restrict__ block_sys, int table_stride,
    float* __restrict__ saved,
    typename Policies<NX, NU, KIND>::Rho::Args ra,
    typename Policies<NX, NU, KIND>::XArgs xa) {
  using Pol = Policies<NX, NU, KIND>;
  constexpr int G = Pol::G;
  using Rho = typename Pol::Rho;
  using Cons = typename Pol::Cons;
  using Fam = typename Pol::Fam;
  using Sweep = typename Pol::Sweep;
  constexpr int R = Sweep::R;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Layout L(NX, NU, N);
  const int total = Pol::table_floats(N, xa);
  const int b0 = blockIdx.x * P;
  const float* tab = tables;
  if (block_sys) tab += static_cast<size_t>(block_sys[b0 / kTile]) * table_stride;
  float* arena = sm;
  if constexpr (PLACE == Place::kShared) {
    for (int k = threadIdx.x; k < total; k += blockDim.x) sm[k] = tab[k];
    tab = sm;
    arena = sm + tinympc::align4(total);
  }
  float* vg = nullptr;
  if constexpr (PLACE == Place::kSavedGlobal)
    vg = saved + blockIdx.x * Pol::Arena::saved_floats(N, P);
  __syncthreads();

  const int p = threadIdx.x / G, g = threadIdx.x % G;
  const int b = b0 + p;
  const bool lane = b < B;
  constexpr bool kSavedArena = WARM && PLACE != Place::kSavedGlobal;
  const Sweep sw(tab, L, arena, N, P, p, g, kSavedArena, vg);
  const size_t sB = static_cast<size_t>(B);

  // The families: each owned row's column, and their tables after the
  // box tables.
  Fam fm;
  int fam_floats = 0;
  if constexpr (Fam::kOn) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      fm.init(r, xa, sw.F, N, P, p, sw.state(r), sw.feat[r]);
    fam_floats = Fam::table_floats(xa, NX, NU, N);
  }

  float x0r[R], dvgN[R], pnref[R], u0[R];
  bool done = !lane;
  int iters = 0;
  float res0 = 0.f, res1 = 0.f, res2 = 0.f, res3 = 0.f;
  if (lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x0r[r] = dvgN[r] = pnref[r] = 0.f;
      if (!sw.active(r)) continue;
      const int k = sw.feat[r], F = sw.tstr[r];
      x0r[r] = sw.state(r) ? x0[static_cast<size_t>(b) * NX + k] : 0.f;
      pnref[r] = sw.state(r) ? sw.pnref(r, tab + L.pinft, tab + L.xref + (N - 1) * NX)
                          : 0.f;
      if constexpr (WARM) {
        const float* vin = sw.state(r) ? carry.vnew_in : carry.znew_in;
        const float* gin = sw.state(r) ? carry.g_in : carry.y_in;
        const float* sv = sw.state(r) ? carry.v_in : carry.z_in;
        for (int i = 0; i < sw.rows(r, N); ++i) {
          const size_t a = (static_cast<size_t>(i) * F + k) * sB + b;
          sw.slack(r, i) = vin[a];
          sw.dual(r, i) = gin[a];
          sw.saved(r, i) = sv[a];
        }
      } else {
        // Cold workspace (tiny_api.cpp:68-133): slacks and duals zero.
        for (int i = 0; i < sw.rows(r, N); ++i) {
          sw.slack(r, i) = 0.f;
          sw.dual(r, i) = 0.f;
        }
      }
      dvgN[r] = sw.state(r) ? sw.slack(r, N - 1) - sw.dual(r, N - 1) : 0.f;
      if constexpr (Fam::kOn) {
        // Family seeds (admm_pallas.py:670-692, admm.cpp:352-376): state
        // slacks from x0 in row 0 and the carried x (zeros cold) after
        // it, input slacks from the carried u (zeros cold); the duals
        // from the carry (zeros cold).
        const bool st = sw.state(r);
        const int n = Fam::sides(xa, st);
        for (int f = 0; f < n; ++f) {
          const float* din = nullptr;
          if constexpr (WARM) din = dual_in(xa, st, family_kind(xa, st, f));
          for (int i = 0; i < sw.rows(r, N); ++i) {
            const size_t a = (static_cast<size_t>(i) * F + k) * sB + b;
            float s = 0.f, d = 0.f;
            if (st && i == 0) {
              s = x0r[r];
            } else if constexpr (WARM) {
              s = st ? xa.x_in[a] : xa.u_in[a];
            }
            if constexpr (WARM) d = din[a];
            fm.at(r, st, i, f, N, P) = make_float2(s, d);
          }
        }
      }
    }
  }

  // Adaptive rho: the adaptive tables (after the family tables), -dPinf^T
  // Xref[N-1] (admm_pallas.py:832-837, summed as -Pinf^T Xref[N-1]), the
  // problem's rho (the carry's on a warm solve) and the guard's virtual
  // rho, restarting from it every solve (admm_pallas.py:665-669).
  Rho rh;
  if constexpr (Rho::kAdaptive) {
    const tinympc::AdaptiveLayout AL(NX, NU, Rho::kApplyC);
    rh.t = tab + L.total + fam_floats;
#pragma unroll
    for (int r = 0; r < R; ++r)
      rh.pdp[r] = sw.state(r)
                      ? sw.pnref(r, rh.t + AL.dpt, tab + L.xref + (N - 1) * NX)
                      : 0.f;
    rh.rho0 = rho;
    rh.rho = rho;
    if constexpr (WARM)
      if (lane) rh.rho = ra.rho_in[b];
    rh.rho_v = rh.rho;
    rh.drho = 0.f;
  }

  // Consensus: an input row's rows of Kinf0 and Quu0_inv (after the box
  // tables), its slack from the carried u[0] and dual from the carry (zero
  // cold; admm_pallas.py:693-707), and no offer yet.
  Cons cs;
  float* offers = nullptr;
  int* vote = nullptr;
  const int cluster = [&] {
    if constexpr (Cons::kHooks) return xa.cluster;
    return 1;
  }();
  if constexpr (Cons::kHooks) {
    const auto& ca = xa;
    const float* t0 = tab + L.total;
    offers = arena + Pol::Arena::lanes_at(N, P, kSavedArena);
    vote = reinterpret_cast<int*>(offers + NU * P);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = sw.feat[r];
      const bool st = sw.state(r);
#pragma unroll
      for (int c = 0; c < NX; ++c) cs.k0[r][c] = st ? 0.f : t0[k * NX + c];
#pragma unroll
      for (int c = 0; c < NU; ++c)
        cs.q0[r][c] = st ? 0.f : t0[NU * NX + k * NU + c];
      const size_t o = static_cast<size_t>(k) * sB + b;
      cs.zc[r] = (WARM && lane && !st) ? ca.u_in[o] : 0.f;
      cs.yc[r] = (WARM && lane && !st) ? ca.yc0_in[o] : 0.f;
      if (!st) offers[k * P + p] = 0.f;
    }
    cs.rho_c = ca.rho_c;
  }

  for (int it = 0; it < max_iter; ++it) {
    const bool checking = ((it + 1) % check_termination) == 0;
    bool ok = false;      // this iteration's check passed (consensus)
    if (!done) {
      float pt[R];
      float rho_it = rho;
      bool adapting = false;
      if constexpr (Rho::kAdaptive) {
        rh.drho = rh.rho - rh.rho0;
        adapting = it > 0 && it % tinympc::kAdaptivePeriod == 0;
        rho_it = rh.rho;
#pragma unroll
        for (int r = 0; r < R; ++r)
          pt[r] = (pnref[r] + rh.drho * rh.pdp[r]) - rho_it * dvgN[r];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) pt[r] = pnref[r] - rho * dvgN[r];
      }
      if constexpr (Fam::kOn) {
        // The families' terminal terms (admm_families.cuh's p_terminal).
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (sw.active(r) && sw.state(r))
            pt[r] = fm.terms(r, true, N - 1, pt[r], rho_it, xa, N, P);
      }
      if constexpr (Fam::kOn)
        sw.backward(N, rho_it, pt, rh, cs, fm, xa);
      else
        sw.backward(N, rho_it, pt, rh, cs);
      // Iteration 0 of a warm solve compares against the carried v/z
      // (admm_pallas.py:1159-1164).
      AdaptMaxima am;
      Residuals rr;
      if constexpr (Fam::kOn)
        rr = sw.template forward<WARM>(N, x0r, dvgN, checking,
                                       WARM && it == 0, u0, rh, cs,
                                       adapting, &am, fm, xa);
      else
        rr = sw.template forward<WARM>(N, x0r, dvgN, checking,
                                       WARM && it == 0, u0, rh, cs,
                                       adapting, &am);
      if constexpr (Fam::kOn) {
        // Every row's x[i] / u[i] kept; the steps projected in parallel,
        // and projected before the next backward sweep reads them.
        sw.sync();
        Fam::project(xa, tab + L.total, sw.F, N, P, p, g, G);
        sw.sync();
      }
      // Adaptive rho every 5th iteration (admm_pallas.py:1079-1142); the
      // dual residuals below scale with the rho after it.
      if constexpr (Rho::kAdaptive) {
        if (adapting)
          tinympc::rho_update(ra, am.pri_res, am.pri_norm, am.dual_res,
                              am.dual_norm, rh.rho, rh.rho_v);
        rho_it = rh.rho;
      }
      // Bookkeeping (admm_pallas.py:1144-1182).
      iters = it + 1;
      if (checking) {
        res0 = rr.pri_s;
        res1 = rr.pri_i;
        res2 = rr.dua_s * rho_it;
        res3 = rr.dua_i * rho_it;
        const bool pass = (res0 < tol_pri) && (res1 < tol_pri) &&
                          (res2 < tol_dua) && (res3 < tol_dua);
        if constexpr (Cons::kHooks)
          ok = pass;
        else
          done = pass;
      }
    }
    if constexpr (Cons::kHooks) {
      // Consensus (admm_pallas.py:1059-1066, :1171-1175): every thread of
      // the block (the cluster) meets the exchange, a converged or idle
      // one too; convergence waits for the gate.
      cg::cluster_group cl = cg::this_cluster();
      if (!done) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (!sw.state(r)) offers[sw.feat[r] * P + p] = u0[r] + cs.yc[r];
      }
      if (cluster > 1)
        cl.sync();
      else
        __syncthreads();
      if (!done) {
        const int GS = xa.group;
        float cres = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (sw.state(r)) continue;
          const int k = sw.feat[r];
          // The group's offers in lane order, summed from zero.
          float sum = 0.f;
          if (cluster > 1) {
            for (int q = 0; q < cluster; ++q) {
              const float* o = cl.map_shared_rank(offers + k * P, q);
              for (int j = 0; j < P; ++j) sum = sum + o[j];
            }
          } else {
            const float* o = offers + k * P + (p & ~(GS - 1));
            for (int j = 0; j < GS; ++j) sum = sum + o[j];
          }
          const float z = tinympc::div_rn(sum, static_cast<float>(GS));
          cs.yc[r] = cs.yc[r] + u0[r] - z;
          cs.zc[r] = z;
          cres = tinympc::max_nan(cres, fabsf(u0[r] - z));
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1)
          cres = tinympc::max_nan(cres,
                                  __shfl_xor_sync(sw.mask, cres, off, G));
        ok = ok && cres < tol_pri;
      }
      const bool now_done = done || ok;
      // The second barrier; on check iterations it also votes the exit
      // (admm_pallas.py:1220-1255), over the cluster when there is one.
      bool stop = false;
      if (checking) {
        const int any = __syncthreads_or(!now_done);
        if (cluster > 1) {
          if (threadIdx.x == 0) *vote = any;
          cl.sync();
          int all = 0;
          for (int q = 0; q < cluster; ++q) all |= *cl.map_shared_rank(vote, q);
          stop = !all;
        } else {
          stop = !any;
        }
      } else if (cluster > 1) {
        cl.sync();
      } else {
        __syncthreads();
      }
      done = now_done;
      if (stop) break;
    } else {
      // Block exit (admm_pallas.py:1220-1255): on check iterations, once no
      // problem of the block is still active. `checking` is uniform.
      if (checking && !__syncthreads_or(!done)) break;
    }
  }
  if constexpr (Cons::kHooks) {
    // No block leaves while a cluster-mate may still read its arena.
    if (cluster > 1) cg::this_cluster().sync();
  }

  if (!lane) return;
  // Solution: the slacks of the last iteration this problem ran
  // (admm_pallas.py:1188-1192, :1257-1264); with max_iter 0 the start.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!sw.active(r)) continue;
    const int k = sw.feat[r], F = sw.tstr[r];
    float* out = sw.state(r) ? out_x : out_u;
    for (int i = 0; i < sw.rows(r, N); ++i)
      out[(static_cast<size_t>(i) * sB + b) * F + k] = sw.slack(r, i);
    if constexpr (WARM) {
      // Carry out (admm_pallas.py:1273-1283).
      float* vo = sw.state(r) ? carry.vnew_out : carry.znew_out;
      float* so = sw.state(r) ? carry.v_out : carry.z_out;
      float* go = sw.state(r) ? carry.g_out : carry.y_out;
      for (int i = 0; i < sw.rows(r, N); ++i) {
        const size_t a = (static_cast<size_t>(i) * F + k) * sB + b;
        vo[a] = sw.slack(r, i);
        so[a] = done ? sw.saved(r, i) : sw.slack(r, i);
        go[a] = sw.dual(r, i);
      }
      if constexpr (Fam::kOn) {
        // The families' duals (frozen since the problem converged).
        const bool st = sw.state(r);
        const int n = Fam::sides(xa, st);
        for (int f = 0; f < n; ++f) {
          float* dout = dual_out(xa, st, family_kind(xa, st, f));
          for (int i = 0; i < sw.rows(r, N); ++i)
            dout[(static_cast<size_t>(i) * F + k) * sB + b] =
                fm.at(r, st, i, f, N, P).y;
        }
      }
    }
  }
  if (g == 0) {
    out_iters[b] = iters;
    out_solved[b] = done ? 1 : 0;
    out_res[b] = res0;
    out_res[sB + b] = res1;
    out_res[2 * sB + b] = res2;
    out_res[3 * sB + b] = res3;
    // Converged problems froze their rho: each problem's final rho.
    if constexpr (Rho::kAdaptive) out_res[4 * sB + b] = rh.rho;
  }
  if constexpr (WARM && Cons::kHooks) {
    // The consensus pair of the last iteration this problem ran (frozen
    // since its convergence; admm_pallas.py:1292-1296).
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (sw.state(r)) continue;
      const size_t o = static_cast<size_t>(sw.feat[r]) * sB + b;
      xa.zc0_out[o] = cs.zc[r];
      xa.yc0_out[o] = cs.yc[r];
    }
  }
  if constexpr (WARM && (Cons::kHooks || Fam::kOn)) {
    // The carried x/u (admm_pallas.py:1001-1003): the iterate of the last
    // iteration this problem ran, its rollout re-run from x0 with that
    // iteration's feedforward d (Kinf0 at step 0 under consensus; under
    // adaptive rho Kinf x + drho dKinf x with that iteration's drho), as
    // the one-thread kernel's Families::finish runs it; with no iteration
    // run, the seeds (x0, then the carried x; the carried u). None where
    // no family is on (a box-only problem at (6, 3) carries no x/u).
    const float* x_in = xa.x_in;
    const float* u_in = xa.u_in;
    float* x_out = xa.x_out;
    float* u_out = xa.u_out;
    if (!x_out) return;
    auto xa_ = [&](int i, int k) {
      return (static_cast<size_t>(i) * NX + k) * sB + b;
    };
    auto ua_ = [&](int i, int k) {
      return (static_cast<size_t>(i) * NU + k) * sB + b;
    };
    if (iters == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!sw.active(r)) continue;
        const int k = sw.feat[r];
        if (sw.state(r)) {
          for (int i = 0; i < N; ++i)
            x_out[xa_(i, k)] = i == 0 ? x0r[r] : x_in[xa_(i, k)];
        } else {
          for (int i = 0; i < N - 1; ++i) u_out[ua_(i, k)] = u_in[ua_(i, k)];
        }
      }
    } else {
      float xo[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xo[r] = x0r[r];
        if (sw.state(r)) sw.X[sw.feat[r]] = xo[r];
      }
      sw.sync();
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (sw.state(r)) x_out[xa_(i, sw.feat[r])] = xo[r];
        if (i == N - 1) break;
        float xv[Sweep::kNX4];
        Sweep::load(xv, sw.X);
        float a1[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if constexpr (Cons::kHooks) {
            a1[r] = (i == 0 && !sw.state(r)) ? Sweep::dot(cs.k0[r], xv)
                                             : Sweep::dot(sw.f1[r], xv);
          } else {
            a1[r] = Sweep::dot(sw.f1[r], xv);
          }
          if constexpr (Rho::kAdaptive) {
            if (!sw.state(r)) {
              const tinympc::AdaptiveLayout AL(NX, NU, Rho::kApplyC);
              a1[r] = a1[r] + rh.drho * Sweep::template dotp<NX>(
                                  rh.t + AL.dk + sw.feat[r] * NX, xv);
            }
          }
          if (sw.active(r) && !sw.state(r)) {
            const float u = -a1[r] - sw.F[i * sw.PU + sw.fcol[r]];
            u_out[ua_(i, sw.feat[r])] = u;
            sw.X[Sweep::Arena::kUO + sw.feat[r]] = u;
          }
        }
        sw.sync();
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (!sw.state(r)) continue;
          float uv[Sweep::kNU4];
          Sweep::load(uv, sw.X + Sweep::Arena::kUO);
          xo[r] = a1[r] + Sweep::dot(sw.bm[r], uv) + sw.fv[r];
          sw.X[sw.feat[r]] = xo[r];
        }
        sw.sync();
      }
    }
  }
}

// Shared memory of a launch: the table (kShared) and the arena of P
// problems, with the saved columns of a warm solve but at kSavedGlobal.
template <int NX, int NU, int KIND>
size_t smem_bytes(int N, int P, int place, bool warm,
                  const typename Policies<NX, NU, KIND>::XArgs& xa = {}) {
  using Pol = Policies<NX, NU, KIND>;
  const int table =
      place == Place::kShared ? tinympc::align4(Pol::table_floats(N, xa)) : 0;
  return (table + Pol::arena_floats(
                      N, P, warm && place != Place::kSavedGlobal, xa)) *
         sizeof(float);
}

template <int NX, int NU, bool WARM, int KIND, int PLACE>
cudaError_t launch_at(const dim3& grid, int P, size_t smem, int cluster,
                      cudaStream_t stream, const float* tables,
                      const float* x0, float* out_x, float* out_u,
                      int* out_iters, unsigned char* out_solved,
                      float* out_res, const Carry& carry, int N, int B,
                      int max_iter, int ct, float rho, float tol_pri,
                      float tol_dua, const int* block_sys, int table_stride,
                      float* saved,
                      const typename Policies<NX, NU, KIND>::Rho::Args& ra,
                      const typename Policies<NX, NU, KIND>::XArgs& xa) {
  constexpr int G = Policies<NX, NU, KIND>::G;
  auto kernel = admm_group_kernel<NX, NU, WARM, PLACE, KIND>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  if (cluster > 1) {
    if (cluster > 8) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(P * G);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, tables, x0, out_x, out_u,
                              out_iters, out_solved, out_res, carry, N, B,
                              max_iter, ct, rho, tol_pri, tol_dua, P,
                              block_sys, table_stride, saved, ra, xa);
  }
  kernel<<<grid, P * G, smem, stream>>>(
      tables, x0, out_x, out_u, out_iters, out_solved, out_res, carry, N, B,
      max_iter, ct, rho, tol_pri, tol_dua, P, block_sys, table_stride,
      saved, ra, xa);
  return cudaGetLastError();
}

template <int NX, int NU, bool WARM, int KIND>
cudaError_t launch(const float* tables, const float* x0, float* out_x,
                   float* out_u, int* out_iters, unsigned char* out_solved,
                   float* out_res, const Carry& carry, int N, int B,
                   int max_iter, int ct, float rho, float tol_pri,
                   float tol_dua, int P, int place, const int* block_sys,
                   int table_stride, float* saved, cudaStream_t stream,
                   const typename Policies<NX, NU, KIND>::Rho::Args& ra = {},
                   const typename Policies<NX, NU, KIND>::XArgs& xa = {}) {
  constexpr int G = Policies<NX, NU, KIND>::G;
  if (P < 1 || P * G > kMaxThreads || kTile % P)
    return cudaErrorInvalidValue;
  if (place == Place::kSavedGlobal ? !WARM || !saved
                                   : place != Place::kShared &&
                                         place != Place::kTableGlobal)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<NX, NU, KIND>(N, P, place, WARM, xa);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int cluster = 1;
  if constexpr (KIND == kConsensus) {
    // A scenario group lies in one block (G <= P, G dividing P) or is one
    // cluster of G / P blocks.
    const int GS = xa.group;
    cluster = xa.cluster;
    if (GS < 1 || (GS & (GS - 1)) || B % GS || block_sys ||
        (GS <= P ? (P % GS || cluster != 1)
                 : (GS % P || cluster != GS / P || cluster > kMaxCluster)))
      return cudaErrorInvalidValue;
  }
  const dim3 grid((B + P - 1) / P);
  const auto go = [&](auto place_c) {
    constexpr int PL = decltype(place_c)::value;
    return launch_at<NX, NU, WARM, KIND, PL>(
        grid, P, smem, cluster, stream, tables, x0, out_x, out_u, out_iters,
        out_solved, out_res, carry, N, B, max_iter, ct, rho, tol_pri,
        tol_dua, block_sys, table_stride, saved, ra, xa);
  };
  if (place == Place::kShared)
    return go(std::integral_constant<int, Place::kShared>());
  if constexpr (WARM)   // a cold solve keeps no saved columns
    if (place == Place::kSavedGlobal)
      return go(std::integral_constant<int, Place::kSavedGlobal>());
  return go(std::integral_constant<int, Place::kTableGlobal>());
}

// The launch of one kind at (NX, NU), cold or warm.
template <int NX, int NU, int KIND>
int dispatch(int warm, const float* t, const float* x, float* ox, float* ou,
             int* oi, unsigned char* os, float* orr, const Carry& c, int N,
             int B, int max_iter, int ct, float rho, float tol_pri,
             float tol_dua, int P, int place, const int* bs,
             int table_stride, float* sv, cudaStream_t s,
             const typename Policies<NX, NU, KIND>::Rho::Args& ra = {},
             const typename Policies<NX, NU, KIND>::XArgs& xa = {}) {
  return static_cast<int>(
      warm ? launch<NX, NU, true, KIND>(t, x, ox, ou, oi, os, orr, c, N, B,
                                        max_iter, ct, rho, tol_pri, tol_dua,
                                        P, place, bs, table_stride, sv, s, ra,
                                        xa)
           : launch<NX, NU, false, KIND>(t, x, ox, ou, oi, os, orr, c, N, B,
                                         max_iter, ct, rho, tol_pri, tol_dua,
                                         P, place, bs, table_stride, sv, s,
                                         ra, xa));
}

GroupFamilyArgs counts_only(const int* counts) {
  GroupFamilyArgs a = {};
  a.ncx = counts[0];
  a.ncu = counts[1];
  a.nlx = counts[2];
  a.nlu = counts[3];
  a.ntx = counts[4];
  a.ntu = counts[5];
  return a;
}

// Bytes of shared memory of a families launch at (nx, nu), or -1.
template <int NX, int NU>
long long families_smem(int N, int P, int place, bool w, int kind,
                        const GroupFamilyArgs& a) {
  switch (kind) {
    case kFamilies:
      return static_cast<long long>(
          smem_bytes<NX, NU, kFamilies>(N, P, place, w, a));
    case kFamiliesAdaptive:
      return static_cast<long long>(
          smem_bytes<NX, NU, kFamiliesAdaptive>(N, P, place, w, a));
    case kFamiliesAdaptiveC:
      return static_cast<long long>(
          smem_bytes<NX, NU, kFamiliesAdaptiveC>(N, P, place, w, a));
  }
  return -1;
}

}  // namespace

extern "C" int tinympc_admm_group_max_threads() { return kMaxThreads; }
// Threads a problem of a launch at (nx, nu): 0 where none is instantiated.
extern "C" int tinympc_admm_group_width_at(int nx, int nu) {
  if (nx == 12 && nu == 4) return kGroupOf<12, 4>;
  if (nx == 6 && nu == 3) return kGroupOf<6, 3>;
  return 0;
}
extern "C" int tinympc_admm_group_tile() { return kTile; }
extern "C" int tinympc_admm_group_max_cluster() { return kMaxCluster; }
// Bytes of shared memory of a launch at (N, P, place), cold or warm, of
// kind 0 (box), 1 (consensus), 2 (adaptive rho) or 3 (adaptive rho with
// apply_c), at (12, 4); the wrapper holds its own geometry against it.
extern "C" long long tinympc_admm_group_smem(int N, int P, int place,
                                             int warm, int kind) {
  const bool w = warm != 0;
  switch (kind) {
    case kBox: return static_cast<long long>(smem_bytes<12, 4, kBox>(N, P, place, w));
    case kConsensus:
      return static_cast<long long>(smem_bytes<12, 4, kConsensus>(N, P, place, w));
    case kAdaptive:
      return static_cast<long long>(smem_bytes<12, 4, kAdaptive>(N, P, place, w));
    case kAdaptiveC:
      return static_cast<long long>(smem_bytes<12, 4, kAdaptiveC>(N, P, place, w));
  }
  return -1;
}

// The same for a families launch (kind 4: fixed rho, 5: adaptive rho, 6:
// adaptive rho with apply_c) at (nx, nu), its six family counts in
// `counts` (tinympc_admm_group_families's order); -1 for a kind or an
// (nx, nu) that is not instantiated.
extern "C" long long tinympc_admm_group_families_smem(int nx, int nu, int N,
                                                      int P, int place,
                                                      int warm, int kind,
                                                      const int* counts) {
  const GroupFamilyArgs a = counts_only(counts);
  const bool w = warm != 0;
  if (nx == 12 && nu == 4) return families_smem<12, 4>(N, P, place, w, kind, a);
  if (nx == 6 && nu == 3) return families_smem<6, 3>(N, P, place, w, kind, a);
  return -1;
}

// How many clusters of `cluster` blocks of a consensus launch at (N, P,
// place), cold or warm, the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0 where it cannot form one), or a
// negative cudaError_t.
extern "C" int tinympc_admm_group_cluster_occupancy(int N, int P, int place,
                                                    int warm, int cluster) {
  const size_t smem = smem_bytes<12, 4, kConsensus>(N, P, place, warm != 0);
  auto kernel =
      warm ? (place == Place::kShared
                  ? admm_group_kernel<12, 4, true, Place::kShared, kConsensus>
                  : admm_group_kernel<12, 4, true, Place::kTableGlobal,
                                      kConsensus>)
           : (place == Place::kShared
                  ? admm_group_kernel<12, 4, false, Place::kShared, kConsensus>
                  : admm_group_kernel<12, 4, false, Place::kTableGlobal,
                                      kConsensus>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(P * kGroupOf<12, 4>);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

namespace {

Carry carry_from(int warm, const void* const* carry, bool* bad) {
  Carry c = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  *bad = false;
  if (!warm) return c;
  for (int k = 0; k < 12; ++k)
    if (!carry[k]) *bad = true;
  if (*bad) return c;
  return {static_cast<const float*>(carry[0]),
          static_cast<const float*>(carry[1]),
          static_cast<const float*>(carry[2]),
          static_cast<const float*>(carry[3]),
          static_cast<const float*>(carry[4]),
          static_cast<const float*>(carry[5]),
          static_cast<float*>(const_cast<void*>(carry[6])),
          static_cast<float*>(const_cast<void*>(carry[7])),
          static_cast<float*>(const_cast<void*>(carry[8])),
          static_cast<float*>(const_cast<void*>(carry[9])),
          static_cast<float*>(const_cast<void*>(carry[10])),
          static_cast<float*>(const_cast<void*>(carry[11]))};
}

// The entries' shared part: the carry, the pointers, then the launch of
// one kind (adapt / cons select it; never both).
int entry(int warm, int nx, int nu, int problems, int place, int N, int B,
          int max_iter, int check_termination, float rho, float tol_pri,
          float tol_dua, const void* tables, const void* x0, void* out_x,
          void* out_u, void* out_iters, void* out_solved, void* out_res,
          const void* const* carry, const void* block_sys, int table_stride,
          void* saved, const AdaptArgs* adapt,
          const GroupConsensusArgs* cons, void* stream) {
  if (N < 2 || B < 1 || max_iter < 0 || check_termination < 1 ||
      (block_sys && table_stride < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  bool bad = false;
  const Carry c = carry_from(warm, carry, &bad);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tables);
  const auto* x = static_cast<const float*>(x0);
  auto* ox = static_cast<float*>(out_x);
  auto* ou = static_cast<float*>(out_u);
  auto* oi = static_cast<int*>(out_iters);
  auto* os = static_cast<unsigned char*>(out_solved);
  auto* orr = static_cast<float*>(out_res);
  const auto* bs = static_cast<const int*>(block_sys);
  auto* sv = static_cast<float*>(saved);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nx != 12 || nu != 4)   // the quadrotor of the main path
    return static_cast<int>(cudaErrorInvalidValue);
  if (adapt) {
    if (!adapt->rho_out || (warm && !adapt->rho_in) ||
        (!warm && adapt->rho_in))
      return static_cast<int>(cudaErrorInvalidValue);
    return adapt->apply_c
               ? dispatch<12, 4, kAdaptiveC>(
                     warm, t, x, ox, ou, oi, os, orr, c, N, B, max_iter,
                     check_termination, rho, tol_pri, tol_dua, problems,
                     place, bs, table_stride, sv, s, *adapt)
               : dispatch<12, 4, kAdaptive>(
                     warm, t, x, ox, ou, oi, os, orr, c, N, B, max_iter,
                     check_termination, rho, tol_pri, tol_dua, problems,
                     place, bs, table_stride, sv, s, *adapt);
  }
  if (cons) {
    const bool all = cons->u_in && cons->x_in && cons->yc0_in &&
                     cons->zc0_out && cons->yc0_out && cons->x_out &&
                     cons->u_out;
    const bool none = !cons->u_in && !cons->x_in && !cons->yc0_in &&
                      !cons->zc0_out && !cons->yc0_out && !cons->x_out &&
                      !cons->u_out;
    if (warm ? !all : !none) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch<12, 4, kConsensus>(warm, t, x, ox, ou, oi, os, orr, c, N,
                                       B, max_iter, check_termination, rho,
                                       tol_pri, tol_dua, problems, place, bs,
                                       table_stride, sv, s, {}, *cons);
  }
  return dispatch<12, 4, kBox>(warm, t, x, ox, ou, oi, os, orr, c, N, B,
                               max_iter, check_termination, rho, tol_pri,
                               tol_dua, problems, place, bs, table_stride, sv,
                               s);
}

// A families launch at (NX, NU): fixed rho, or adaptive rho (with or
// without apply_c).
template <int NX, int NU>
int families_entry(int warm, const float* t, const float* x, float* ox,
                   float* ou, int* oi, unsigned char* os, float* orr,
                   const Carry& c, int N, int B, int max_iter, int ct,
                   float rho, float tol_pri, float tol_dua, int P, int place,
                   float* sv, const GroupFamilyArgs& fa,
                   const AdaptArgs* adapt, cudaStream_t s) {
  if (!adapt)
    return dispatch<NX, NU, kFamilies>(warm, t, x, ox, ou, oi, os, orr, c, N,
                                       B, max_iter, ct, rho, tol_pri,
                                       tol_dua, P, place, nullptr, 0, sv, s,
                                       {}, fa);
  return adapt->apply_c
             ? dispatch<NX, NU, kFamiliesAdaptiveC>(
                   warm, t, x, ox, ou, oi, os, orr, c, N, B, max_iter, ct,
                   rho, tol_pri, tol_dua, P, place, nullptr, 0, sv, s,
                   *adapt, fa)
             : dispatch<NX, NU, kFamiliesAdaptive>(
                   warm, t, x, ox, ou, oi, os, orr, c, N, B, max_iter, ct,
                   rho, tol_pri, tol_dua, P, place, nullptr, 0, sv, s,
                   *adapt, fa);
}

}  // namespace

// The box-only fixed-rho solve, cold (warm = 0) or warm. Returns 0 on
// success, a cudaError_t otherwise; cudaErrorInvalidValue for an
// (nx, nu) this file does not instantiate, a bad size or geometry or a
// missing array. problems: P, problems a block (dividing 128, P * 16 <=
// 128); place: a tinympc::Place, kSavedGlobal for a warm solve only, with
// `saved` a (ceil(B / P), N, P * (nx + nu)) float buffer (else unused).
// carry: the warm carry in (vnew_in,
// znew_in, g_in, y_in, v_in, z_in) and out (vnew_out, znew_out, v_out,
// z_out, g_out, y_out), lane-last (N, nx, B) and (N-1, nu, B); null on a
// cold solve. block_sys null is the single-system solve; else tables holds
// one packed table per system, table_stride floats apart, and the lanes of
// each 128-lane tile k solve with table block_sys[k].
extern "C" int tinympc_admm_group(
    int warm, int nx, int nu, int problems, int place, int N, int B,
    int max_iter, int check_termination, float rho, float tol_pri,
    float tol_dua, const void* tables, const void* x0, void* out_x,
    void* out_u, void* out_iters, void* out_solved, void* out_res,
    const void* const* carry, const void* block_sys, int table_stride,
    void* saved, void* stream) {
  return entry(warm, nx, nu, problems, place, N, B, max_iter,
               check_termination, rho, tol_pri, tol_dua, tables, x0, out_x,
               out_u, out_iters, out_solved, out_res, carry, block_sys,
               table_stride, saved, nullptr, nullptr, stream);
}

// The box-only solve at adaptive rho: tinympc_admm_group's arguments, then
// before the stream `adapt` (admm_adaptive.cuh's AdaptArgs: settings,
// rho_in -- the carried rho, (B,), required warm, null cold --, rho_out --
// residual row 4 --; the scratch and rho_v unused). out_res has 5 rows;
// the adaptive tables (and apply_c's) follow the box tables; block_sys as
// there (the fleet).
extern "C" int tinympc_admm_group_adaptive(
    int warm, int nx, int nu, int problems, int place, int N, int B,
    int max_iter, int check_termination, float rho, float tol_pri,
    float tol_dua, const void* tables, const void* x0, void* out_x,
    void* out_u, void* out_iters, void* out_solved, void* out_res,
    const void* const* carry, const void* block_sys, int table_stride,
    void* saved, const AdaptArgs* adapt, void* stream) {
  if (!adapt) return static_cast<int>(cudaErrorInvalidValue);
  return entry(warm, nx, nu, problems, place, N, B, max_iter,
               check_termination, rho, tol_pri, tol_dua, tables, x0, out_x,
               out_u, out_iters, out_solved, out_res, carry, block_sys,
               table_stride, saved, adapt, nullptr, stream);
}

// The box-only solve under consensus: tinympc_admm_group's arguments
// (block_sys null), then before the stream `cons` (GroupConsensusArgs,
// admm_group.cuh): the scenario group G, a power of two dividing B, and
// the cluster, 1 where G <= P (P divisible by G) else G / P, at most
// tinympc_admm_group_max_cluster(); on a warm solve its carry arrays, all
// required (null cold). The step-0 gains follow the box tables.
extern "C" int tinympc_admm_group_consensus(
    int warm, int nx, int nu, int problems, int place, int N, int B,
    int max_iter, int check_termination, float rho, float tol_pri,
    float tol_dua, const void* tables, const void* x0, void* out_x,
    void* out_u, void* out_iters, void* out_solved, void* out_res,
    const void* const* carry, const void* block_sys, int table_stride,
    void* saved, const GroupConsensusArgs* cons, void* stream) {
  if (!cons) return static_cast<int>(cudaErrorInvalidValue);
  return entry(warm, nx, nu, problems, place, N, B, max_iter,
               check_termination, rho, tol_pri, tol_dua, tables, x0, out_x,
               out_u, out_iters, out_solved, out_res, carry, block_sys,
               table_stride, saved, nullptr, cons, stream);
}

// The solve with the constraint families beyond the box (any mix, zero
// counts too) at (12, 4) or (6, 3): tinympc_admm_group's arguments
// (block_sys null; problems P with P * tinympc_admm_group_width_at(nx, nu)
// <= 128), then `fam` (GroupFamilyArgs, admm_group.cuh: the six counts;
// warm, the carried duals of the families that are on and x/u in, the
// duals and x/u out, required where a family is on; x/u null where none
// is; all null cold), then `adapt` (null at fixed rho, else as
// tinympc_admm_group_adaptive takes it), then the stream. The family
// tables follow the box tables, the adaptive ones follow them.
extern "C" int tinympc_admm_group_families(
    int warm, int nx, int nu, int problems, int place, int N, int B,
    int max_iter, int check_termination, float rho, float tol_pri,
    float tol_dua, const void* tables, const void* x0, void* out_x,
    void* out_u, void* out_iters, void* out_solved, void* out_res,
    const void* const* carry, const void* block_sys, int table_stride,
    void* saved, const GroupFamilyArgs* fam, const AdaptArgs* adapt,
    void* stream) {
  if (!fam || block_sys || N < 2 || B < 1 || max_iter < 0 ||
      check_termination < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  (void)table_stride;
  const GroupFamilyArgs& a = *fam;
  const int counts[6] = {a.ncx, a.ncu, a.nlx, a.nlu, a.ntx, a.ntu};
  const void* in[6] = {a.gc_in, a.yc_in, a.gl_in, a.yl_in, a.gtv_in,
                       a.ytv_in};
  const void* out[6] = {a.gc_out, a.yc_out, a.gl_out, a.yl_out, a.gtv_out,
                        a.ytv_out};
  bool any = false;
  for (int f = 0; f < 6; ++f) {
    if (counts[f] < 0) return static_cast<int>(cudaErrorInvalidValue);
    const bool on = counts[f] > 0 && warm;
    any = any || counts[f] > 0;
    // A family's carry where it is on and the solve warm, none elsewhere.
    if (on != (in[f] != nullptr) || on != (out[f] != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool xu = warm && any;
  if (xu != (a.x_in != nullptr) || xu != (a.u_in != nullptr) ||
      xu != (a.x_out != nullptr) || xu != (a.u_out != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (adapt && (!adapt->rho_out || (warm && !adapt->rho_in) ||
                (!warm && adapt->rho_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  bool bad = false;
  const Carry c = carry_from(warm, carry, &bad);
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const float*>(tables);
  const auto* x = static_cast<const float*>(x0);
  auto* ox = static_cast<float*>(out_x);
  auto* ou = static_cast<float*>(out_u);
  auto* oi = static_cast<int*>(out_iters);
  auto* os = static_cast<unsigned char*>(out_solved);
  auto* orr = static_cast<float*>(out_res);
  auto* sv = static_cast<float*>(saved);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nx == 12 && nu == 4)
    return families_entry<12, 4>(warm, t, x, ox, ou, oi, os, orr, c, N, B,
                                 max_iter, check_termination, rho, tol_pri,
                                 tol_dua, problems, place, sv, a, adapt, s);
  if (nx == 6 && nu == 3)
    return families_entry<6, 3>(warm, t, x, ox, ou, oi, os, orr, c, N, B,
                                max_iter, check_termination, rho, tol_pri,
                                tol_dua, problems, place, sv, a, adapt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
