// The streamed solve's two launches on lane teams: for box problems at fixed
// and at adaptive rho, and for problems with constraint families (second-
// order cones, hyperplanes, time-varying hyperplanes) and with scenario-tree
// consensus on u[0], in any mix, at fixed rho (admm_stream.cu routes
// families under adaptive rho, and a consensus group whose thread-block
// cluster cannot be formed, to the one-thread stream_backward_kernel /
// stream_forward_kernel).
//
// stream_backward_team_kernel computes what admm_sweep.cuh's backward_sweep
// computes with NoFamilies and NoConsensus (admm_stream.py:121-253): the
// terminal costate, then for rows N-2 down to 0 the linear cost r, q from
// the previous slacks and duals, d = Quu_inv (B^T p + r + BPf) and
// p = q + AmBKt p - Kinf^T r + APf, with AdaptiveRho's telescoped products
// under adaptive rho. stream_forward_team_kernel computes what
// forward_sweep computes with NoFamilies and NoConsensus, and the
// bookkeeping of stream_forward_kernel (admm_stream.py:474-641): the
// rollout u = -Kinf x - d, x+ = A x + B u + f; each row projected onto its
// box and its dual updated from the pre-update dual; the four max-abs
// residuals on check iterations; under adaptive rho the telescoped gain
// and, on an adaptation iteration, the OSQP residuals and the new rho
// (admm_adaptive.cuh's adapt); iterations, residuals, convergence and the
// `active` flag.
//
// Why a team: the one-thread kernels run one thread a lane, 128 lanes a
// block, so B=1024 fills 8 of the H100's 132 SMs and B=4096 32, and each
// thread walks its lane's rows in series, every row waiting on device
// memory and on the row before's x or p (PERF.md section 6: the forward
// launch 1.7357 ms at N=256, B=4096, against a 0.0851 ms byte bound; the
// backward 0.9704 ms at N=512, B=1024, against 0.0225). Here:
//   * A lane's NX + NU rows are a team of threads, one a row (state rows
//     k < NX, then input rows), kLanes lanes a block: thread t holds row
//     t / kLanes of lane t % kLanes. A warp holds 32 / kLanes rows of
//     kLanes adjacent lanes, so each load or store of a lane-last array
//     ((rows, features, B)) is 32 / kLanes full sectors a warp, and kLanes
//     is the fewest (8 or more) for which the state rows fill whole warps:
//     no warp mixes the two roles. (12, 4): 8 lanes, 128 threads, warps 0-2
//     the state rows, warp 3 the input rows; (6, 3): 16 lanes, 144 threads
//     (8 lanes of 16 row slots, 7 idle, was 3-21% slower at N=512 and
//     mixes the roles in a warp). B=1024 at (12, 4) is then 128 blocks,
//     B=4096 512.
//   * Each thread keeps its rows of the small matrices in registers, as
//     admm_group.cuh does; the vectors a step's products read pass through
//     the lane's slot in shared memory.
//   * Forward: two barriers a step. After the first every thread reads x,
//     the input rows form u = -Kinf x - d and write it, the state rows form
//     A x; after the second the state rows read u and write x+. Each row's
//     projection and dual update sit beside the dot products of its step,
//     off the x -> u -> x+ chain.
//   * Backward: one barrier a step. The chain is p alone: the r rows do not
//     hang on it, so the input rows form r one step ahead and leave it in
//     the slot, and the state rows read p_{i+1} and r_i after the same
//     barrier; Quu_inv w, d, is off the chain too, and the input rows finish
//     it one step later. p, r and w take two halves of the slot each (the
//     step's parity), so a step's writes never meet the reads of the step
//     before.
//   * What a row reads at step i and that does not hang on the chain -- its
//     dual, its bounds, the slack of the dual residual, d (forward); its
//     slack, its dual, its reference (backward) -- is staged into shared
//     memory kTeamDepth - 1 steps ahead with cp.async, each thread its own
//     entries (ring[stage][field][thread]: no other thread reads them, so
//     cp.async.wait_group alone orders them). At B=1024 a block has an SM
//     to itself and nothing else hides device memory's latency: one row
//     ahead (kTeamDepth 2, the lookahead of a register double buffer) ran
//     the forward at N=512 1.3-1.4x slower than 7 rows ahead, 3 rows ahead
//     in between.
//   * Residuals: each thread keeps the maxima of its own rows; they are
//     reduced over the lane's team once, at the end of the launch, with
//     max_nan, which is order-free (a NaN sticks in any order).
//   * Adaptive rho: each thread reads its lane's rho from device memory
//     (drho = rho_lane - rho); an input row keeps its row of dKinf, a state
//     row its row of dKinf^T (and, under apply_c, the rows of dC1 / dC2).
//     The forward's adaptation runs inside the sweep, not as the one-thread
//     kernel's second pass over scratch rows: the OSQP terms of row i need
//     the lane's whole new dual g[i+1] (A^T g[i+1], B^T g[i+1]), which the
//     state rows leave in the slot at step i+1, and its own x_i, u_i, the
//     new slacks and duals of row i and the dynamics row i-1, which each
//     thread keeps one step; the terminal Pinf / dPinf product reads x[N-1]
//     from the slot. So row i's terms are folded in at step i+1, no scratch
//     is written, and the four maxima reduce over the team with the
//     residuals'. Row 0's thread forms the new rho (rho_update) and, with
//     it, the scaled dual residuals: it alone does the bookkeeping.
//   * A converged lane's threads reach every barrier and store nothing; a
//     block whose lanes are all done returns at once; a lane past B is a
//     done lane. Its iterates stay as they were at first convergence.
//   * Bits: every row's dot product is summed from zero in backward_sweep's
//     or forward_sweep's column order with fmaf, and every elementwise term
//     rounds as there (-fmad=false): w = (bp + r) + BPf, p = ((q + ap) -
//     kr) + APf, each telescoped product base + drho s; so the outputs are
//     bitwise the one-thread kernels'.
// The forward's stale launch (the first iteration of a warm solve) is this
// kernel given the carried v/z for the dual residual's slacks: nothing else
// differs (stream_forward_kernel's STALE only picks those pointers).
//
// Families (Fam = TeamFamilies; admm_families.cuh's hooks, split by row):
//   * Backward: each family's term of row i acts on that row alone, so the
//     row's thread stages the family's slack and dual with its box fields
//     and adds rho (slack - dual) to its q or r after the box term, in the
//     order SOC, hyperplane, time-varying hyperplane (the terminal p too).
//     No barrier is added.
//   * Forward: a projection couples all of a lane's features of one row (a
//     cone's norm, a hyperplane's dot, cones and hyperplanes applied in
//     turn). Each row writes its candidate x + dual (or u + dual) of each
//     family into the lane's candidate slot between the step's two
//     barriers; after the second, every thread of that side reads the
//     whole candidate, runs admm_families.cuh's project_cones /
//     project_hyperplane on it -- the same arithmetic on the same values
//     as the one-thread kernel, redundantly on each thread -- and keeps its
//     own feature's slack and dual. The candidate slot of step i is written
//     after barrier 1 of step i and read after barrier 2; the next write
//     follows barrier 1 of step i+1, which every read of step i precedes.
//     The terminal state row N-1 takes one exchange after the loop, between
//     two barriers of its own. The cone and static hyperplane tables sit in
//     dynamic shared memory, loaded once a block; each time-varying row is
//     read from device memory as a broadcast (every thread of a side reads
//     the same words: staged into a block-wide ring with the other fields
//     instead, the tv forward took as long and the rocket's 11% longer,
//     torch.profiler device times, PERF.md section 6). The own feature of
//     a projected candidate is picked with one selp an index (select). A
//     warm solve's tracked x/u are stored row by row, as the sweep forms
//     them. Family residuals do not enter the termination test, as in the
//     one-thread kernel.
//
// Consensus (Cons = TeamConsensus; admm_consensus.cuh's rule, the one-thread
// kernels' CONS instantiations, admm_stream.py:229-239, :496-499,
// :553-570):
//   * Backward: only row 0 changes. The input rows form r[0] - rho_c (zc0 -
//     yc0) from the lane's (NU, B) arrays (read once, before the loop), the
//     state rows read that r[0] from the slot for Kinf^T r as before, and
//     d[0] takes the Quu0_inv row, which sits in dynamic shared memory. No
//     barrier is added and no lane reads another's.
//   * Forward: at step 0 the input rows form u[0] with Kinf0's row (dynamic
//     shared memory, ahead of the static family tables) and park it in the
//     block's offer slot (NU, kLanes); at the end of the launch each input
//     row of a running lane puts its offer u[0] + yc0 there, a done lane's
//     its standing offer (read from device memory), a lane past the batch
//     zero (B is a multiple of G, so no group reads it). After a barrier
//     each running input row sums its group's G offers in lane order from
//     zero and divides by G (div_rn), as admm_consensus.cuh does, moves yc0
//     by u[0] - zc0, stores zc0 and yc0, and leaves |u[0] - zc0| for row
//     0's thread, which folds the lane's NU of them with max_nan into the
//     convergence gate and, when the lane converges, stores its offer from
//     the slot: that offer then stands. A warm solve's x/u are tracked row
//     by row, as the sweep forms them.
//   * Where the group lives: G <= kLanes, in the block, the barriers
//     __syncthreads. G > kLanes: a thread-block cluster of G / kLanes
//     blocks (cudaLaunchKernelEx; past 8 blocks a non-portable size), the
//     mates' offers read through distributed shared memory in cluster-rank
//     order (the lane order), the barriers cluster barriers. Under a
//     cluster a block whose lanes are all done does not return at once: the
//     blocks vote, and the cluster returns only when none of its lanes
//     runs; a block that is done while its mates run skips the sweep (no
//     steps) and serves its standing offers.
//   * Order of a cluster launch, per block: (V) the vote slot written, a
//     cluster barrier, every mate's vote read; if no lane of the cluster
//     runs, a second cluster barrier (no block leaves while a mate reads its
//     vote) and return. (S) The sweep: each step's slot writes and reads
//     between the step's two block barriers, as without consensus; the
//     offer slot is written only by its own input row (u[0] at step 0, read
//     back by the same thread at the end). (A) The offers written, then a
//     cluster barrier: every mate's offers are in place. (R) The mates'
//     offers read through distributed shared memory; the new zc0 / yc0
//     stored; |u[0] - zc0| into the block's reduction row. (E) A cluster
//     barrier: no block leaves, and no offer slot is touched again, while a
//     mate may still read it; it also orders the reduction rows for row 0's
//     thread. Nothing writes the vote or the offer slot after (A) in a
//     launch, and the next launch starts afresh.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_compare.py time in
// turns with the one-thread kernel, N=512, a fresh launch; PERF.md section
// 6): the fixed-rho forward B=1024 0.1787-0.1902 against 2.9296-2.9562 ms,
// B=4096 0.3672-0.3699 against 3.5065-3.5435, B=16384 1.4818-1.4919
// against 3.9565-3.9738 (byte bounds 0.0426, 0.1702, 0.6809). The staging
// depth and the (6, 3) mapping were chosen by timing copies of this file
// (PERF.md section 6).
#pragma once

#include <cooperative_groups.h>
#include <type_traits>

#include "admm_adaptive.cuh"
#include "admm_families.cuh"
#include "admm_sweep.cuh"

namespace tinympc {

template <int NX, int NU>
struct TeamShape {
  static constexpr int kRows = NX + NU;
  static constexpr int kLanes = (8 * NX) % 32 == 0    ? 8
                                : (16 * NX) % 32 == 0 ? 16
                                                      : 32;
  static constexpr int kThreads = kLanes * kRows;
  // A lane's slot: x, then u, each padded to whole float4s; the stride an
  // odd number of float4s, so that 8 adjacent lanes' float4 reads of one
  // step hit 8 distinct bank groups.
  static constexpr int kXP = (NX + 3) / 4 * 4;
  static constexpr int kUP = (NU + 3) / 4 * 4;
  static constexpr int kSlot =
      ((kXP + kUP) / 4) % 2 ? kXP + kUP : kXP + kUP + 4;
  // The forward's new dual g[i] of an adaptation iteration, alone.
  static constexpr int kGSlot = (kXP / 4) % 2 ? kXP : kXP + 4;
  // The backward's slot: p, r and w, two halves each.
  static constexpr int kBSlot =
      ((kXP + 2 * kUP) / 2) % 2 ? 2 * (kXP + 2 * kUP)
                                : 2 * (kXP + 2 * kUP) + 4;
  // The forward's family candidates: one x-sized part for each state-side
  // family, then one u-sized part for each input-side family.
  static constexpr int kCSlot = ((3 * (kXP + kUP)) / 4) % 2
                                    ? 3 * (kXP + kUP)
                                    : 3 * (kXP + kUP) + 4;
};

// Steps staged ahead, the fields of a staged forward step (dual, lower and
// upper bound, the dual residual's slack, d) and backward step (slack,
// dual, reference), and the blocks an SM the register budget leaves room
// for: 6 (at most 85 registers a thread at (12, 4)) for every kernel but
// the adaptive forward, whose rows of dKinf and A^T / B^T and whose
// adaptation take 107 registers at (12, 4) under a bound of 4 (ptxas on
// an H100, PERF.md section 6).
constexpr int kTeamDepth = 8;
constexpr int kTeamFields = 5;
constexpr int kTeamBackFields = 3;
constexpr int kTeamMinBlocks = 6;
constexpr int kTeamAdaptMinBlocks = 4;
// The families of a side (SOC, hyperplane, time-varying hyperplane) and the
// blocks an SM of the forward launch with families: its candidate and the
// projections need more registers than the box forward's 85 (ptxas on an
// H100: 122 at (12, 4), 92 at (6, 3); at 5 blocks an SM it spilled).
constexpr int kTeamFamilies = 3;
constexpr int kTeamFamMinBlocks = 4;
// Blocks of a consensus group's cluster at most: past 8 a non-portable
// cluster size, which an H100 takes to 16 (a group of 128 at (12, 4)).
constexpr int kTeamMaxCluster = 16;

__device__ __forceinline__ void stage_copy(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// p ? a : b as one selp: written as a plain select over every index of a
// register array, the compiler turned "c[j] where j == k" back into c[k]
// and put the array in local memory (ptxas: a 48-byte stack frame at
// (12, 4)).
__device__ __forceinline__ float select(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.s32 q, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(p)));
  return r;
}

template <int n>
__device__ __forceinline__ void load_slot(float (&v)[n], const float* s) {
#pragma unroll
  for (int q = 0; q < n / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(s)[q];
    v[4 * q] = t.x;
    v[4 * q + 1] = t.y;
    v[4 * q + 2] = t.z;
    v[4 * q + 3] = t.w;
  }
}

// A box problem's team launches: no family, and hooks that do nothing.
struct TeamNoFamilies {
  struct Args {};
  __device__ TeamNoFamilies(const Args&, bool, int, size_t, int, int) {}
  __device__ __forceinline__ void stage_back(float*, int) const {}
  __device__ __forceinline__ float terms(const float*, float q,
                                         float) const {
    return q;
  }
  __device__ __forceinline__ void stage_duals(float*, int) const {}
  __device__ __forceinline__ void candidates(float*, float,
                                             const float*) const {}
  __device__ __forceinline__ void track(int, float) const {}
  __device__ __forceinline__ void project(int, float, const float*,
                                          const float*, const float*,
                                          const float*) const {}
};

// The constraint families of one team thread's row: family f of the row's
// side -- 0 the second-order cones, 1 the hyperplanes, 2 the time-varying
// hyperplanes -- is on when its count is, with its slack and dual
// lane-last like the box's ((N, NX, B) or (N-1, NU, B)). The staged fields
// of a step follow the box's in the ring: the backward stages each family's
// slack and dual (fields 3 + 2f, 4 + 2f), the forward each family's dual
// (field 5 + f). Arguments: FamilyArgs, its counts and working arrays
// (the streamed solve seeds them, so its carry pointers stay null) and, on
// a warm solve, x_out / u_out, the tracked x/u (else null).
template <int NX, int NU>
struct TeamFamilies {
  using Args = FamilyArgs;
  static constexpr int kThreads = TeamShape<NX, NU>::kThreads;
  int n[kTeamFamilies];
  float* slk[kTeamFamilies];
  float* dua[kTeamFamilies];
  float* trk;
  bool st;
  int k;
  size_t step;
  // The side's table offsets: cones, hyperplane rows / b / ||a||^2, and the
  // same of the time-varying rows.
  int cones, al, bl, aq, tva, tvb, tvq;

  __device__ TeamFamilies(const Args& f, bool st_, int k_, size_t sB, int b,
                          int N)
      : st(st_), k(k_) {
    const size_t off = static_cast<size_t>(k_) * sB + b;
    n[0] = st ? f.ncx : f.ncu;
    n[1] = st ? f.nlx : f.nlu;
    n[2] = st ? f.ntx : f.ntu;
    slk[0] = (st ? f.vc : f.zc) + off;
    slk[1] = (st ? f.vl : f.zl) + off;
    slk[2] = (st ? f.vtv : f.ztv) + off;
    dua[0] = (st ? f.gc : f.yc) + off;
    dua[1] = (st ? f.gl : f.yl) + off;
    dua[2] = (st ? f.gtv : f.ytv) + off;
    trk = st ? f.x_out : f.u_out;
    if (trk) trk += off;
    step = static_cast<size_t>(st ? NX : NU) * sB;
    const FamilyLayout L(f, NX, NU, N);
    cones = st ? L.xcones : L.ucones;
    al = st ? L.alx : L.alu;
    bl = st ? L.blx : L.blu;
    aq = st ? L.aqx : L.aqu;
    tva = st ? L.tvax : L.tvau;
    tvb = st ? L.tvbx : L.tvbu;
    tvq = st ? L.tvqx : L.tvqu;
  }

  // Backward: stage row j's slack and dual of each family into the ring row
  // r0 (&ring[stage][0][t]).
  __device__ __forceinline__ void stage_back(float* r0, int j) const {
    const size_t a = static_cast<size_t>(j) * step;
#pragma unroll
    for (int f = 0; f < kTeamFamilies; ++f) {
      if (n[f]) {
        stage_copy(r0 + (kTeamBackFields + 2 * f) * kThreads, slk[f] + a);
        stage_copy(r0 + (kTeamBackFields + 2 * f + 1) * kThreads,
                   dua[f] + a);
      }
    }
  }
  // q (or r) - rho (slack - dual) of each family, in the family order.
  __device__ __forceinline__ float terms(const float* r0, float q,
                                         float rho) const {
#pragma unroll
    for (int f = 0; f < kTeamFamilies; ++f) {
      if (n[f])
        q = q - rho * (r0[(kTeamBackFields + 2 * f) * kThreads] -
                       r0[(kTeamBackFields + 2 * f + 1) * kThreads]);
    }
    return q;
  }

  // Forward: stage row i's dual of each family.
  __device__ __forceinline__ void stage_duals(float* r0, int i) const {
    const size_t a = static_cast<size_t>(i) * step;
#pragma unroll
    for (int f = 0; f < kTeamFamilies; ++f)
      if (n[f]) stage_copy(r0 + (kTeamFields + f) * kThreads, dua[f] + a);
  }
  // This row's feature of each family's candidate, val + dual, into the
  // lane's candidate slot cs.
  __device__ __forceinline__ void candidates(float* cs, float val,
                                             const float* r0) const {
    using S = TeamShape<NX, NU>;
    float* c = st ? cs : cs + kTeamFamilies * S::kXP;
    const int w = st ? S::kXP : S::kUP;
#pragma unroll
    for (int f = 0; f < kTeamFamilies; ++f)
      if (n[f]) c[f * w + k] = val + r0[(kTeamFields + f) * kThreads];
  }
  // The tracked x or u of row i.
  __device__ __forceinline__ void track(int i, float val) const {
    if (trk) trk[static_cast<size_t>(i) * step] = val;
  }
  // Row i's projection of each family from the lane's whole candidate, and
  // this thread's feature of it: the new slack, and the dual from the one
  // before its update. fsm: the cone and static hyperplane tables; tv: the
  // family tables in device memory (the time-varying rows).
  __device__ __forceinline__ void project(int i, float val, const float* cs,
                                          const float* r0, const float* fsm,
                                          const float* tv) const {
    using S = TeamShape<NX, NU>;
    const size_t a = static_cast<size_t>(i) * step;
#pragma unroll
    for (int f = 0; f < kTeamFamilies; ++f) {
      if (!n[f]) continue;
      const float sn =
          st ? own<NX, S::kXP>(f, i, cs + f * S::kXP, fsm, tv)
             : own<NU, S::kUP>(f, i, cs + kTeamFamilies * S::kXP +
                                         f * S::kUP, fsm, tv);
      const float dn0 = r0[(kTeamFields + f) * kThreads];
      dua[f][a] = dn0 + val - sn;
      slk[f][a] = sn;
    }
  }
  // Family f's projection of row i of the candidate c (F features, FP
  // padded), this thread's feature of the result.
  template <int F, int FP>
  __device__ __forceinline__ float own(int f, int i, const float* cv,
                                       const float* fsm,
                                       const float* tv) const {
    float c[FP];
    load_slot(c, cv);
    if (f == 0) {
      project_cones<F>(c, fsm + cones, n[0]);
    } else if (f == 1) {
      for (int s = 0; s < n[1]; ++s)
        project_hyperplane<F>(c, fsm + al + s * F, fsm[bl + s],
                              fsm[aq + s]);
    } else {
      for (int s = 0; s < n[2]; ++s)
        project_hyperplane<F>(c, tv + tva + (i * n[2] + s) * F,
                              tv[tvb + i * n[2] + s],
                              tv[tvq + i * n[2] + s]);
    }
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) o = select(j == k, c[j], o);
    return o;
  }
};

// A team launch's consensus arguments (admm_stream.cu fills them from its
// StreamConsensus): the group size G and the blocks of a group's cluster (1
// where G <= kLanes), rho_c, the step-0 gains Kinf0 (NU, NX) then Quu0_inv
// (NU, NU) in the packed table (device memory), each lane's slack zc0, dual
// yc0 and standing offer, (NU, B) each, and on a warm solve the tracked x/u
// (else null).
struct TeamConsensusArgs {
  int group, cluster;
  float rho_c;
  const float* gains;
  float *zc0, *yc0, *offer, *x_out, *u_out;
};

// No consensus: the kernels' consensus code compiles away.
struct TeamNoConsensus {
  struct Args {};
  static constexpr bool kOn = false;
  static constexpr int kForwardGains = 0;   // floats of dynamic shared memory
  static constexpr int kBackwardGains = 0;
};

// Consensus on u[0]: the gains each launch keeps in dynamic shared memory
// (the forward's Kinf0, padded to whole float4s ahead of the static family
// tables; the backward's Quu0_inv), and the kernels' consensus code.
template <int NX, int NU>
struct TeamConsensus {
  using Args = TeamConsensusArgs;
  static constexpr bool kOn = true;
  static constexpr int kForwardGains = (NU * NX + 3) / 4 * 4;
  static constexpr int kBackwardGains = NU * NU;
};

// Backward launch: d of every running lane from its previous iterate
// (vprev / zprev, the duals g / y). Under adaptive rho (Rho =
// AdaptiveRho<NX, NU, APPLY_C>) the lane's rho comes from ra.rho_in and the
// products the Taylor update moves gain their drho-scaled sensitivity
// products. With families (Fam = TeamFamilies, at fixed rho) each family's
// term joins the row's linear cost after the box's. Under consensus (Cons =
// TeamConsensus, at fixed rho) r[0] takes -rho_c (zc0 - yc0) after the
// families' terms and d[0] the Quu0_inv gain, which takes
// Cons::kBackwardGains floats of dynamic shared memory. Zeroes *active.
template <int NX, int NU, class Fam, class Rho, class Cons>
__global__ void __launch_bounds__(TeamShape<NX, NU>::kThreads,
                                  kTeamMinBlocks)
    stream_backward_team_kernel(
        const float* __restrict__ tables, const float* __restrict__ vprev,
        const float* __restrict__ zprev, const float* __restrict__ g,
        const float* __restrict__ y, float* __restrict__ d,
        const unsigned char* __restrict__ done, int* __restrict__ active,
        int N, int B, float rho, typename Rho::Args ra,
        typename Fam::Args fp, typename Cons::Args ca) {
  using S = TeamShape<NX, NU>;
  constexpr bool kAdapt = Rho::kAdaptive;
  constexpr bool kC = Rho::kApplyC;
  constexpr bool kFam = !std::is_same_v<Fam, TeamNoFamilies>;
  constexpr bool kCons = Cons::kOn;
  static_assert(!(kFam && kAdapt), "families on teams at fixed rho only");
  static_assert(!(kCons && kAdapt), "consensus at fixed rho only");
  __shared__ __align__(16) float slots[S::kLanes * S::kBSlot];
  __shared__ float ring[kTeamDepth][kTeamBackFields +
                                    (kFam ? 2 * kTeamFamilies : 0)]
                       [S::kThreads];
  __shared__ float pnref[2 * NX];
  extern __shared__ float q0s[];   // Quu0_inv under consensus
  const int t = threadIdx.x;
  const int row = t / S::kLanes, lane = t % S::kLanes;
  const int b = blockIdx.x * S::kLanes + lane;
  const bool run = b < B && !done[b];
  const Layout L(NX, NU, N);
  const AdaptiveLayout AL(NX, NU, kC);
  const float* at = tables + L.total;   // the adaptive tables (no family's)
  if (blockIdx.x == 0 && t == 0) *active = 0;
  if constexpr (kCons) {
    for (int q = t; q < NU * NU; q += S::kThreads)
      q0s[q] = ca.gains[NU * NX + q];
  }
  // Terminal reference term -Pinf^T Xref[N-1] (admm_stream.py:926), and
  // under adaptive rho its sensitivity -dPinf^T Xref[N-1], summed as the
  // one-thread kernel's prologue sums them.
  if (t < NX) {
    const float* xref_last = tables + L.xref + (N - 1) * NX;
    float acc = 0.f, dacc = 0.f;
    for (int j = 0; j < NX; ++j) {
      acc = fmaf(tables[L.pinft + t * NX + j], xref_last[j], acc);
      if constexpr (kAdapt)
        dacc = fmaf(at[AL.dpt + t * NX + j], xref_last[j], dacc);
    }
    pnref[t] = -acc;
    pnref[NX + t] = -dacc;
  }
  if (!__syncthreads_or(run)) return;

  const size_t sB = static_cast<size_t>(B);
  const bool st = row < NX;   // a state row; else an input row
  const int k = st ? row : row - NX;
  // This row of [B^T; AmBKt], of Kinf^T (a state row) or Quu_inv (an input
  // row), APf or BPf, and Q or R; under adaptive rho dKinf^T (a state row)
  // or, under apply_c, dC1 (an input row), and dC2 (a state row).
  float mb[NX], c1[NU], e1[NU], e2[NX];
  const int mrow = st ? NU + k : k;
#pragma unroll
  for (int c = 0; c < NX; ++c) mb[c] = tables[L.mback + mrow * NX + c];
#pragma unroll
  for (int c = 0; c < NU; ++c)
    c1[c] = st ? tables[L.kinft + k * NU + c] : tables[L.quu + k * NU + c];
  const float cst = st ? tables[L.apf + k] : tables[L.bpf + k];
  const float wq = st ? tables[L.qd + k] : tables[L.rd + k];
  float rho_l = rho;
  if constexpr (kAdapt) {
#pragma unroll
    for (int c = 0; c < NU; ++c)
      e1[c] = st ? at[AL.dkt + k * NU + c]
                 : (kC ? at[AL.dc1 + k * NU + c] : 0.f);
    if constexpr (kC) {
#pragma unroll
      for (int c = 0; c < NX; ++c)
        e2[c] = st ? at[AL.dc2 + k * NX + c] : 0.f;
    }
    if (run) rho_l = ra.rho_in[b];
  }
  const float drho = rho_l - rho;
  // Item n of this row: a state row's row N-1-n (the terminal one first),
  // an input row's row N-2-n; lane-last arrays at (j * F + k) * sB + b, the
  // reference at j * F + k.
  const int F = st ? NX : NU;
  const size_t step = static_cast<size_t>(F) * sB;
  const size_t off = static_cast<size_t>(k) * sB + b;
  const float* slk = (st ? vprev : zprev) + off;
  const float* dua = (st ? g : y) + off;
  const float* ref = tables + (st ? L.xref : L.uref) + k;
  const int items = st ? N : N - 1;
  const int top = st ? N - 1 : N - 2;
  const Fam fam(fp, st, k, sB, b, N);
  // Under consensus an input row's prox term of r[0], rho_c (zc0 - yc0).
  float cterm = 0.f;
  if constexpr (kCons) {
    if (run && !st) cterm = ca.rho_c * (ca.zc0[off] - ca.yc0[off]);
  }
  // The lane's halves of p, r and w in its slot, by the step's parity.
  float* const sl = slots + lane * S::kBSlot;
  auto P = [&](int i) { return sl + (i & 1) * S::kXP; };
  auto R = [&](int i) { return sl + 2 * S::kXP + (i & 1) * S::kUP; };
  auto W = [&](int i) {
    return sl + 2 * (S::kXP + S::kUP) + (i & 1) * S::kUP;
  };

  // Stage item n's fields (nothing for a done lane or past the row's
  // items); one commit group an item, empty or not, on every thread.
  auto issue = [&](int n) {
    if (run && n < items) {
      const int s = n % kTeamDepth, j = top - n;
      const size_t a = static_cast<size_t>(j) * step;
      stage_copy(&ring[s][0][t], slk + a);
      stage_copy(&ring[s][1][t], dua + a);
      stage_copy(&ring[s][2][t], ref + j * F);
      fam.stage_back(&ring[s][0][t], j);
    }
    stage_commit();
  };
  // The linear-cost term of item n: -(ref .* w) - rho (slack - dual), then
  // each family's.
  auto lin = [&](int n) {
    const int s = n % kTeamDepth;
    return fam.terms(&ring[s][0][t],
                     -(ring[s][2][t] * wq) -
                         rho_l * (ring[s][0][t] - ring[s][1][t]),
                     rho_l);
  };
  // d of row i from the lane's w: Quu_inv w (+ drho dC1 w under apply_c).
  auto store_d = [&](int i, const float* wv) {
    float w[S::kUP];
    load_slot(w, wv);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < NU; ++c) acc = fmaf(c1[c], w[c], acc);
    if constexpr (kC) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) s = fmaf(e1[c], w[c], s);
      acc = acc + drho * s;
    }
    d[static_cast<size_t>(i) * NU * sB + off] = acc;
  };

#pragma unroll 1
  for (int n = 0; n < kTeamDepth; ++n) issue(n);
  stage_wait<kTeamDepth - 1>();   // item 0 has landed
  float r_own = 0.f;   // an input row's r of the next step
  if (run) {
    if (st) {
      // p[N-1] = pterm - rho (vprev[N-1] - g[N-1])
      float pt = pnref[k];
      if constexpr (kAdapt) pt = pt + drho * pnref[NX + k];
      const int s = 0;
      P(N - 1)[k] = fam.terms(
          &ring[s][0][t], pt - rho_l * (ring[s][0][t] - ring[s][1][t]),
          rho_l);
    } else {
      r_own = lin(0);
      if (kCons && N == 2) r_own = r_own - cterm;
      R(N - 2)[k] = r_own;
    }
  }
#pragma unroll 1
  for (int i = N - 2; i >= 0; --i) {
    __syncthreads();   // p[i+1], r[i] and w[i+1] in the slots
    const int n = N - 1 - i;   // this step's item
    issue(n + kTeamDepth - 1);
    stage_wait<kTeamDepth - 1>();
    if (!run) continue;
    float p[S::kXP];
    load_slot(p, P(i + 1));
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < NX; ++c) acc = fmaf(mb[c], p[c], acc);
    if (st) {
      // p[i] = q + AmBKt p - Kinf^T r + APf
      float ap = acc;
      if constexpr (kC) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < NX; ++c) s = fmaf(e2[c], p[c], s);
        ap = ap + drho * s;
      }
      float r[S::kUP];
      load_slot(r, R(i));
      float kr = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) kr = fmaf(c1[c], r[c], kr);
      if constexpr (kAdapt) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < NU; ++c) s = fmaf(e1[c], r[c], s);
        kr = kr + drho * s;
      }
      P(i)[k] = ((lin(n) + ap) - kr) + cst;
    } else {
      // w[i] = (B^T p + r) + BPf; d[i+1] from w[i+1]; r[i-1] ahead
      W(i)[k] = (acc + r_own) + cst;
      if (i + 1 <= N - 2) store_d(i + 1, W(i + 1));
      if (i >= 1) {
        r_own = lin(n);
        if (kCons && i == 1) r_own = r_own - cterm;
        R(i - 1)[k] = r_own;
      }
    }
  }
  __syncthreads();   // w[0] in the slots
  if (run && !st) {
    if constexpr (kCons) {
      // d[0] = Quu0_inv w[0]
      float w[S::kUP];
      load_slot(w, W(0));
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc = fmaf(q0s[k * NU + c], w[c], acc);
      d[off] = acc;
    } else {
      store_d(0, W(0));
    }
  }
}

// Forward launch of iteration `it`: the new slacks into vcur/zcur, the
// duals g/y in place, and for the running lanes the bookkeeping; vd/zd are
// the slacks the dual residual compares against (the previous iterate's,
// or the carried v/z in the stale launch). Under adaptive rho (Rho =
// AdaptiveRho<NX, NU, false>) the lane's rho comes from ra.rho_in, an
// adaptation iteration (every kAdaptivePeriod-th, it > 0) moves it and the
// virtual rho (ra.rho_v) before the termination check, and the lane's rho
// goes to ra.rho_out; the adaptive tables follow the box tables. With
// families (Fam = TeamFamilies, at fixed rho) each row's families project
// after the step's second barrier, from the lane's candidates; the cone and
// static hyperplane tables take Families::static_floats floats of dynamic
// shared memory. Under consensus (Cons = TeamConsensus, at fixed rho) row 0
// rolls out with Kinf0 (Cons::kForwardGains floats of dynamic shared memory
// ahead of the family tables), and the launch ends with the group exchange,
// in the block or across the cluster of ca.cluster blocks, whose residual
// gates convergence; a warm solve's x/u go to ca.x_out / ca.u_out.
template <int NX, int NU, class Fam, class Rho, class Cons>
__global__ void __launch_bounds__(
    TeamShape<NX, NU>::kThreads,
    Rho::kAdaptive ? kTeamAdaptMinBlocks
    : std::is_same_v<Fam, TeamNoFamilies> ? kTeamMinBlocks
                                          : kTeamFamMinBlocks)
    stream_forward_team_kernel(
        const float* __restrict__ tables, const float* __restrict__ x0,
        const float* __restrict__ vd, const float* __restrict__ zd,
        float* __restrict__ vcur, float* __restrict__ zcur,
        float* __restrict__ g, float* __restrict__ y,
        const float* __restrict__ d, int* __restrict__ iters,
        unsigned char* __restrict__ done, float* __restrict__ res,
        int* __restrict__ active, int it, int N, int B,
        int check_termination, float rho, float tol_pri, float tol_dua,
        typename Rho::Args ra, typename Fam::Args fp,
        typename Cons::Args ca) {
  using S = TeamShape<NX, NU>;
  constexpr bool kAdapt = Rho::kAdaptive;
  constexpr bool kFam = !std::is_same_v<Fam, TeamNoFamilies>;
  constexpr bool kCons = Cons::kOn;
  static_assert(!(kFam && kAdapt), "families on teams at fixed rho only");
  static_assert(!(kCons && kAdapt), "consensus at fixed rho only");
  __shared__ __align__(16) float xu[S::kLanes * S::kSlot];
  // Under adaptive rho the lanes' new duals g[i]; with families the lanes'
  // candidate slots.
  __shared__ __align__(16) float gs[kAdapt ? S::kLanes * S::kGSlot
                                    : kFam ? S::kLanes * S::kCSlot
                                           : 4];
  __shared__ float ring[kTeamDepth][kTeamFields + (kFam ? kTeamFamilies : 0)]
                       [S::kThreads];
  __shared__ float red[kAdapt ? 6 : kCons ? 3 : 2][S::kThreads];
  // Under consensus the lanes' offers (NU, kLanes), and the block's vote.
  __shared__ __align__(16) float offers[kCons ? NU * S::kLanes : 4];
  __shared__ int vote;
  // Dynamic shared memory: Kinf0 under consensus, then the static family
  // tables.
  extern __shared__ __align__(16) float dsm[];
  float* const fsm = dsm + Cons::kForwardGains;
  const int t = threadIdx.x;
  const int row = t / S::kLanes, lane = t % S::kLanes;
  const int b = blockIdx.x * S::kLanes + lane;
  const bool run = b < B && !done[b];
  if constexpr (kFam) {
    const int nt = Families<NX, NU>::static_floats(fp, NX, NU);
    const float* src = tables + Layout(NX, NU, N).total;
    for (int q = t; q < nt; q += S::kThreads) fsm[q] = src[q];
  }
  if constexpr (kCons) {
    for (int q = t; q < NU * NX; q += S::kThreads) dsm[q] = ca.gains[q];
  }
  // Whether a lane of the block runs; the tables loaded.
  const int any = __syncthreads_or(run);
  if constexpr (kCons) {
    if (ca.cluster > 1) {
      // (V) The cluster's vote: it returns only when none of its lanes runs.
      cooperative_groups::cluster_group cl =
          cooperative_groups::this_cluster();
      if (t == 0) vote = any;
      cl.sync();
      int all = 0;
      for (int q = 0; q < ca.cluster; ++q)
        all |= *cl.map_shared_rank(&vote, q);
      if (!all) {
        cl.sync();   // no block leaves while a mate reads its vote
        return;
      }
    } else if (!any) {
      return;
    }
  } else if (!any) {
    return;
  }
  // A block whose lanes are all done, in a cluster that runs, skips the
  // sweep and only serves its standing offers.
  const int steps = (!kCons || any) ? N - 1 : 0;

  const Layout L(NX, NU, N);
  const size_t sB = static_cast<size_t>(B);
  const bool checking = ((it + 1) % check_termination) == 0;
  const bool adapting = kAdapt && it > 0 && it % kAdaptivePeriod == 0;
  const bool st = row < NX;   // a state row; else an input row
  const int k = st ? row : row - NX;
  // This row of [Kinf; A] and of B (an input row: no B row), and f; under
  // adaptive rho an input row's row of dKinf, the row of A^T (a state row)
  // or B^T (an input row) that the adaptation applies to g[i+1], and Q or R.
  float f1[NX], bm[NU], dk[NX], gr[NX];
  const int mrow = st ? NU + k : k;
#pragma unroll
  for (int c = 0; c < NX; ++c) f1[c] = tables[L.mfwd + mrow * NX + c];
#pragma unroll
  for (int c = 0; c < NU; ++c) bm[c] = st ? tables[L.bm + k * NU + c] : 0.f;
  const float fv = st ? tables[L.f + k] : 0.f;
  const AdaptiveLayout AL(NX, NU, false);
  const float* at = tables + L.total;   // the adaptive tables (no family's)
  float rho_l = rho, wq = 0.f;
  if constexpr (kAdapt) {
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      dk[c] = st ? 0.f : at[AL.dk + k * NX + c];
      gr[c] = st ? at[AL.at + k * NX + c] : tables[L.mback + k * NX + c];
    }
    wq = st ? tables[L.qd + k] : tables[L.rd + k];
    if (run) rho_l = ra.rho_in[b];
  }
  const float drho = rho_l - rho;
  // Step i of this row: lane-last arrays at (i * F + k) * sB + b, the
  // bound tables at i * F + k.
  const int F = st ? NX : NU;
  const size_t step = static_cast<size_t>(F) * sB;
  const size_t off = static_cast<size_t>(k) * sB + b;
  float* dual = (st ? g : y) + off;
  float* slack = (st ? vcur : zcur) + off;
  const float* prev = (st ? vd : zd) + off;
  const float* dff = st ? nullptr : d + off;
  const float* lo = tables + (st ? L.xmin : L.umin) + k;
  const float* hi = tables + (st ? L.xmax : L.umax) + k;
  const int rows = st ? N : N - 1;
  float* slot = xu + lane * S::kSlot;
  float* gslot = gs + lane * S::kGSlot;
  float* cslot = gs + lane * S::kCSlot;
  float* const oslot = offers + k * S::kLanes + lane;   // an input row's
  const Fam fam(fp, st, k, sB, b, N);
  const float* tv = tables + L.total;   // the family tables, device memory

  // Stage step i's fields of this row (nothing for a done lane or past the
  // row's steps); one commit group a step, empty or not, on every thread.
  auto issue = [&](int i) {
    if (run && i < rows) {
      const int s = i % kTeamDepth;
      const size_t a = static_cast<size_t>(i) * step;
      stage_copy(&ring[s][0][t], dual + a);
      stage_copy(&ring[s][1][t], lo + i * F);
      stage_copy(&ring[s][2][t], hi + i * F);
      if (checking) stage_copy(&ring[s][3][t], prev + a);
      if (!st) stage_copy(&ring[s][4][t], dff + a);
      fam.stage_duals(&ring[s][0][t], i);
    }
    stage_commit();
  };
  float pr = 0.f, du = 0.f;   // this row's residual maxima
  // Project `val` (x or u of step i) onto the box, update the dual from the
  // pre-update one, store both, and fold in the residuals; the new slack
  // and dual into sn, dn.
  auto project = [&](int i, float val, float& sn, float& dn) {
    const int s = i % kTeamDepth;
    const size_t a = static_cast<size_t>(i) * step;
    const float dn0 = ring[s][0][t];
    sn = clamp_nan(val + dn0, ring[s][1][t], ring[s][2][t]);
    dn = dn0 + val - sn;
    dual[a] = dn;
    slack[a] = sn;
    if (checking) {
      pr = max_nan(pr, fabsf(val - sn));
      du = max_nan(du, fabsf(ring[s][3][t] - sn));
    }
  };
  // The adaptation's maxima (admm_adaptive.cuh's adapt) and what row i's
  // terms keep until g[i+1] is in the slot: x_i or u_i, the new dual and
  // slack of row i, and a state row's dynamics rows i-1 (ad1) and i-2
  // (ad2) at step i.
  float pres = 0.f, pnorm = 0.f, dres = 0.f, dnorm = 0.f;
  float pa = 0.f, pb = 0.f, pc = 0.f, ad1 = 0.f, ad2 = 0.f;
  // Row j's OSQP terms at step j+1, g[j+1] in the slot: ad2 is then the
  // dynamics row j-1.
  auto terms = [&](int j) {
    float gv[S::kXP];
    load_slot(gv, gslot);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < NX; ++c) acc = fmaf(gr[c], gv[c], acc);
    if (st) {
      // P x = Q x on the stages; A^T g[j+1] - g[j]; dynamics row j-1
      // against the slack of state row j.
      const float qx = wq * pa;
      const float px = qx;
      const float aty = acc - (j >= 1 ? pb : 0.f);
      dres = maxabs(dres, px + qx + aty);
      dnorm = maxabs(maxabs(maxabs(dnorm, px), aty), qx);
      if (j >= 1) {
        pres = maxabs(pres, ad2 - pc);
        pnorm = maxabs(maxabs(pnorm, ad2), pc);
      }
    } else {
      // R u and y + B^T g[j+1]
      const float ru = wq * pa;
      const float aty = pb + acc;
      dres = maxabs(dres, 2.f * ru + aty);
      dnorm = maxabs(maxabs(dnorm, ru), aty);
      pres = maxabs(pres, pa - pc);
      pnorm = maxabs(maxabs(pnorm, pa), pc);
    }
  };

  // Under consensus a warm solve's x or u of step i, as the sweep forms it.
  auto track = [&](int i, float val) {
    if constexpr (kCons) {
      float* out = st ? ca.x_out : ca.u_out;
      if (out) out[static_cast<size_t>(i) * step + off] = val;
    }
  };

  float xo = 0.f;   // a state row's x at the current step
  if (run && st) {
    xo = x0[static_cast<size_t>(b) * NX + k];
    slot[k] = xo;
  }
#pragma unroll 1
  for (int i = 0; i < kTeamDepth - 1; ++i) issue(i);
#pragma unroll 1
  for (int i = 0; i < steps; ++i) {
    __syncthreads();   // x of step i in the slots
    issue(i + kTeamDepth - 1);
    stage_wait<kTeamDepth - 1>();   // step i's fields have landed
    float a1 = 0.f, val = 0.f, sn = 0.f, dn = 0.f, axd = 0.f;
    if (run) {
      float x[S::kXP];
      load_slot(x, slot);
#pragma unroll
      for (int c = 0; c < NX; ++c) a1 = fmaf(f1[c], x[c], a1);   // A x / Kinf x
      if (st) {
        val = xo;
      } else {
        // u = -(Kinf x + drho dKinf x) - d as an exact subtract; under
        // consensus row 0 with Kinf0
        float kx = a1;
        if constexpr (kAdapt) {
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < NX; ++c) s = fmaf(dk[c], x[c], s);
          kx = a1 + drho * s;
        }
        if constexpr (kCons) {
          if (i == 0) {
            kx = 0.f;
#pragma unroll
            for (int c = 0; c < NX; ++c) kx = fmaf(dsm[k * NX + c], x[c], kx);
          }
        }
        val = -kx - ring[i % kTeamDepth][4][t];
        slot[S::kXP + k] = val;
        if (kCons && i == 0) *oslot = val;   // u[0], until the exchange
      }
      project(i, val, sn, dn);
      if (adapting && st) gslot[k] = dn;
      fam.candidates(cslot, val, &ring[i % kTeamDepth][0][t]);
      fam.track(i, val);
      track(i, val);
    }
    // u of step i in the slots; g[i] under adaptation, the family
    // candidates of step i with families
    __syncthreads();
    if (run && st) {
      float u[S::kUP];
      load_slot(u, slot + S::kXP);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc = fmaf(bm[c], u[c], acc);
      // x+ = (A x + B u) + f; (A x + B u) - x+ is the dynamics row of the
      // OSQP residuals (exactly 0 when f = 0)
      const float s = a1 + acc;
      xo = s + fv;
      slot[k] = xo;
      axd = s - xo;
    }
    if (run)
      fam.project(i, val, cslot, &ring[i % kTeamDepth][0][t], fsm, tv);
    if (adapting && run) {
      if (i >= 1) terms(i - 1);
      pa = val;
      pb = dn;
      pc = sn;
      ad2 = ad1;
      ad1 = axd;
    }
  }
  stage_wait<0>();
  float snN = 0.f, dnN = 0.f;
  if (run && st) project(N - 1, xo, snN, dnN);
  if constexpr (kFam) {
    // Row N-1 of the state-side families: every thread has read step
    // N-2's candidates before a state row writes row N-1's.
    const float* r0 = &ring[(N - 1) % kTeamDepth][0][t];
    __syncthreads();
    if (run && st) {
      fam.candidates(cslot, xo, r0);
      fam.track(N - 1, xo);
    }
    __syncthreads();   // row N-1's candidates in the slots
    if (run && st) fam.project(N - 1, xo, cslot, r0, fsm, tv);
  }
  if (run && st) track(N - 1, xo);
  if (adapting) {
    // Every row's terms(N-3) of the last step has read g[N-2] from the
    // slot before a state row overwrites it with g[N-1]: a lane's rows sit
    // in several warps, which the loop's barriers no longer order here.
    __syncthreads();
    if (run && st) gslot[k] = dnN;
    __syncthreads();   // g[N-1] and x[N-1] in the slots
    if (run) {
      terms(N - 2);
      if (st) {
        // Row N-1: P x the terminal Pinf telescoped by drho dPinf, no A^T
        // g term, and the dynamics row N-2 against the slack of row N-1.
        float x[S::kXP];
        load_slot(x, slot);
        float pp = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < NX; ++c) {
          pp = fmaf(at[AL.pinf + k * NX + c], x[c], pp);
          dp = fmaf(at[AL.dp + k * NX + c], x[c], dp);
        }
        const float px = pp + drho * dp;
        const float qx = wq * xo;
        const float aty = 0.f - dnN;
        dres = maxabs(dres, px + qx + aty);
        dnorm = maxabs(maxabs(maxabs(dnorm, px), aty), qx);
        pres = maxabs(pres, ad1 - snN);
        pnorm = maxabs(maxabs(pnorm, ad1), snN);
      }
    }
  }

  if constexpr (kCons) {
    // The exchange (admm_stream.py:553-570, admm_consensus.cuh's rule): a
    // running lane offers u[0] + yc0, a done lane its standing offer, a
    // lane past the batch zero.
    float u0 = 0.f;
    if (!st) {
      const size_t o = static_cast<size_t>(k) * sB + b;
      if (run) {
        u0 = *oslot;
        *oslot = u0 + ca.yc0[o];
      } else {
        *oslot = b < B ? ca.offer[o] : 0.f;
      }
    }
    if (checking) {
      red[0][t] = pr;
      red[1][t] = du;
    }
    // (A) every offer of the group in place
    if (ca.cluster > 1)
      cooperative_groups::this_cluster().sync();
    else
      __syncthreads();
    float cres = 0.f;
    if (run && !st) {
      // (R) the group's offers in lane order, summed from zero
      const int G = ca.group;
      float sum = 0.f;
      if (ca.cluster > 1) {
        cooperative_groups::cluster_group cl =
            cooperative_groups::this_cluster();
        for (int q = 0; q < ca.cluster; ++q) {
          const float* o = cl.map_shared_rank(offers + k * S::kLanes, q);
#pragma unroll
          for (int j = 0; j < S::kLanes; ++j) sum = sum + o[j];
        }
      } else {
        const float* o = offers + k * S::kLanes + (lane & ~(G - 1));
        for (int j = 0; j < G; ++j) sum = sum + o[j];
      }
      const float z = div_rn(sum, static_cast<float>(G));
      const size_t o = static_cast<size_t>(k) * sB + b;
      const float yc = ca.yc0[o];
      ca.yc0[o] = yc + u0 - z;
      ca.zc0[o] = z;
      cres = fabsf(u0 - z);
    }
    red[2][t] = cres;
    // (E) no block leaves while a mate may read its offers; the reduction
    // rows in place for row 0's thread
    if (ca.cluster > 1)
      cooperative_groups::this_cluster().sync();
    else if (checking)
      __syncthreads();
  }
  // Bookkeeping (admm_stream.py:576-641), by row 0's thread: under adaptive
  // rho the new rho first; iterations on every iteration, residuals (dual
  // rows scaled by the lane's rho) and convergence on check iterations, the
  // team's maxima reduced first.
  if (!kCons && (checking || adapting)) {
    red[0][t] = pr;
    red[1][t] = du;
    if constexpr (kAdapt) {
      red[2][t] = pres;
      red[3][t] = pnorm;
      red[4][t] = dres;
      red[5][t] = dnorm;
    }
    __syncthreads();
  }
  if (!run || row != 0) return;
  iters[b] = it + 1;
  if constexpr (kAdapt) {
    if (adapting) {
      float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < S::kRows; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          m[q] = max_nan(m[q], red[2 + q][r * S::kLanes + lane]);
      float rv = ra.rho_v[b];
      rho_update(ra, m[0], m[1], m[2], m[3], rho_l, rv);
      ra.rho_v[b] = rv;
    }
    ra.rho_out[b] = rho_l;
  }
  if (!checking) return;
  float ps = 0.f, ds = 0.f, pi = 0.f, di = 0.f;
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    ps = max_nan(ps, red[0][r * S::kLanes + lane]);
    ds = max_nan(ds, red[1][r * S::kLanes + lane]);
  }
#pragma unroll
  for (int r = NX; r < S::kRows; ++r) {
    pi = max_nan(pi, red[0][r * S::kLanes + lane]);
    di = max_nan(di, red[1][r * S::kLanes + lane]);
  }
  const float r2 = ds * rho_l, r3 = di * rho_l;
  res[b] = ps;
  res[sB + b] = pi;
  res[2 * sB + b] = r2;
  res[3 * sB + b] = r3;
  bool ok =
      (ps < tol_pri) && (pi < tol_pri) && (r2 < tol_dua) && (r3 < tol_dua);
  if constexpr (kCons) {
    // the consensus residual max|u[0] - zc0| joins the gate
    float c = 0.f;
#pragma unroll
    for (int r = NX; r < S::kRows; ++r)
      c = max_nan(c, red[2][r * S::kLanes + lane]);
    ok = ok && c < tol_pri;
  }
  if (ok) {
    done[b] = 1;
    if constexpr (kCons) {
      // the offer of the converging iteration, which then stands
#pragma unroll
      for (int q = 0; q < NU; ++q)
        ca.offer[static_cast<size_t>(q) * sB + b] =
            offers[q * S::kLanes + lane];
    }
  } else {
    *active = 1;
  }
}

}  // namespace tinympc
