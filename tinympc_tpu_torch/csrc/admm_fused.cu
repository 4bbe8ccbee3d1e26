// Fused batched ADMM solve, cold or warm start, with the constraint
// families beyond the box (second-order cones, hyperplanes, time-varying
// hyperplanes; admm_families.cuh) and scenario-tree consensus on u[0]
// (admm_consensus.cuh) at fixed rho; or with any of those families
// (consensus aside), and every problem off (12, 4), at adaptive rho
// (admm_adaptive.cuh). One system's launches of the families and of
// (6, 3), at fixed and adaptive rho, run admm_group.cu's thread groups
// (its families kinds), as do box-only problems at (12, 4) -- at fixed rho
// (the main path), at adaptive rho and under consensus. This file takes
// consensus with a family or at (6, 3), consensus group 0 (no exchange)
// or a box scenario group whose thread-block cluster cannot be formed
// there, the multi-system launch of the families or at (6, 3), a
// families horizon whose columns do not fit one problem a block there
// (kernels/admm_fused.py:group_route), and every launch at cartpole's
// (4, 1) and the degenerate pairs (2, 2), (2, 1), (3, 3) and (1, 1),
// which have no thread-group kind.
//
// Replaces those variants of the TPU kernel
// tinympc_tpu/kernels/admm_pallas.py:_make_kernel (launched by _fused_call):
// the cold solve (solve_fused) and the warm solve with its carry
// (solve_fused_warm, FusedCarry). One launch runs the whole ADMM loop for
// every problem of the batch: the iteration of admm_sweep.cuh,
// termination every check_termination iterations, and a per-block exit
// once every lane of the block has converged.
//
// Instantiations: the families kernel for (12, 4), (6, 3) (the rocket),
// (4, 1) (cartpole), (2, 2), (2, 1), (3, 3) and (1, 1) (off (12, 4) a
// box-only problem runs it with zero family counts); the families
// adaptive-rho kernel for (12, 4) with the families and for every problem
// off (12, 4), with and without apply_c: the families kernel with the rho
// hooks filled in, its tables the family tables and then the adaptive
// ones; the family hooks scale their linear-cost terms by the lane's rho;
// each lane's rho and the guard's virtual rho in registers, the adaptation
// every 5th iteration as a second pass over the rows of that iteration
// (admm_adaptive.cuh), the final rho out, and on a warm solve the carried
// rho in. The families kernel is the template with the family hooks
// filled in: each family's slack and dual arrays sit beside the box's in
// device memory, its tables follow the box tables in shared memory, and
// termination still reads the box family's residuals only, as the
// reference does (admm.cpp:310-328). A warm families solve carries the
// family duals and the primal x/u (whose rows seed the family slacks); a
// lane hands over the x/u of the last iteration it ran, re-run from x0 and
// that iteration's feedforward once it has stopped. The families kernel
// takes __launch_bounds__(128, 1): its longer live state fits in registers
// only above the ~100 that ptxas otherwise aims for, and at the batches it
// runs there is about one block an SM anyway. Consensus is an
// instantiation of the families kernel (a box problem with consensus runs
// it with zero family counts): its slack and dual sit in shared memory,
// (nu, 128) a block, beside the offers a group's lanes exchange there
// after every iteration between two barriers that every thread of the
// block reaches, a converged one too (admm_consensus.cuh). The step-0
// gains follow the family tables. A warm consensus solve also carries x/u
// and the pair.
//
// Multi-system launch (the TPU kernel's multi_tps variant,
// admm_pallas.py:532-575, entry solve_fused_multi): a heterogeneous fleet
// in one launch of any instantiation but consensus, cold or warm. The
// wrapper stacks one packed table per system and pads each system's lanes
// to whole blocks; block k loads table block_sys[k] into shared memory
// and then runs the single-system solve. The TPU kernel selects its tile's
// system from the stack in VMEM, which cost it Mosaic's hoisting; here
// every block loads its table anyway, so the index only moves the load's
// source. The index and stride come last among the kernel's arguments
// (arguments before N, B, rho cost the stream kernels registers), and the
// system selection is a template parameter (MULTI): a single-system
// instantiation's code is that of a kernel without the multi-system
// launch (with a run-time select instead, the main path measured ~1%
// slower on an H100).
//
// Design (one thread a problem; the box-only solves at (12, 4) -- fixed
// rho, adaptive rho, consensus -- and one system's families and (6, 3)
// solves at fixed and adaptive rho moved to admm_group.cu's thread groups;
// what stays here is listed in ROADMAP.md):
//   * One thread per problem; 128 threads a block; threads past B count as
//     converged from the start. A converged lane stops computing and keeps
//     its iterates, so what a lane returns does not depend on the block it
//     shares (the TPU kernel snapshots instead; the outputs are the same).
//     Under consensus a lane depends on its group's lanes, all in its
//     block; a converged lane's last offer stands for its group.
//   * Per-lane trajectories live in device memory in the lane-last layout
//     (N, nx, B). vnew/znew are ping-pong halves (2, N, nx, B) /
//     (2, N-1, nu, B): iteration `it` writes half it%2 and reads the
//     previous iterate from the other half.
//   * The costate p, the state x, x0 and the carried terminal term
//     vnew[N-1] - g[N-1] stay in registers. The small shared matrices and
//     per-step tables sit in shared memory (about 7 KB at nx=12, nu=4,
//     N=20); every thread reads the same word, a broadcast.
//   * Warm start (admm_pallas.py:639-649, :1159-1164, :1273-1283): the
//     carried slack goes into half 1, which iteration 0 reads as
//     "previous"; g/y start from the carry; the carried v/z are what
//     iteration 0's dual residual compares against; the terminal term
//     starts as vnew_in[N-1] - g_in[N-1]. Since a converged thread stops,
//     its halves and duals are already frozen at first convergence, and the
//     carry is written from them at the end: vnew/znew <- the last half;
//     g/y <- the duals; v/z <- the "previous" the converging iteration
//     compared against (the carried v/z if that was iteration 0, else the
//     other half), or the last half for a lane that ran out of iterations
//     (the reference's v <- vnew copy ran for it).
//
// What bounds it on an H100: operations, but this design streams each
// lane's trajectories (~7 KB an iteration at nx=12, nu=4, N=20) through
// device memory and runs one thread a problem, ~250 threads an SM at
// B=32768: the adaptive hard batch (B=32768, N=20, max_iter 500; 7.0192 ms
// at the FP32 peak) measured 114.9255 ms here (NVIDIA H100 80GB HBM3,
// 700 W) before it moved to admm_group.cu. The box-only solve measured the
// same layout's limit: its time a lane-iteration fell from 5.25 to 3.61 ns
// as the batch grew from 32768 to 131072 lanes (more warps), the mark of
// too few threads to hide latency.
//
// C interface (loaded with ctypes): tinympc_admm_fused, one entry for the
// cold and the warm solve, adaptive with the families or off (12, 4), and
// tinympc_admm_fused_multi, the same with the multi-system launch's two
// arguments, return the cudaError_t of the launch; they launch on the
// given stream and never synchronise.
#include <type_traits>

#include "admm_adaptive.cuh"
#include "admm_consensus.cuh"
#include "admm_families.cuh"
#include "admm_sweep.cuh"

namespace {

using tinympc::AdaptArgs;
using tinympc::AdaptiveRho;
using tinympc::ConsensusArgs;
using tinympc::FamilyArgs;
using tinympc::FixedRho;
using tinympc::Layout;
using tinympc::NegRefTable;
using tinympc::NoConsensus;
using tinympc::NoFamilies;
using tinympc::Residuals;
using tinympc::Tables;

constexpr int kBlock = 128;

template <int NX, int NU>
using Consensus = tinympc::Consensus<NX, NU, kBlock>;

// The carry of a warm solve; all pointers null on a cold one.
struct Carry {
  const float *vnew_in, *znew_in, *g_in, *y_in, *v_in, *z_in;
  float *vnew_out, *znew_out, *v_out, *z_out;
};

template <class Fam, class Rho>
constexpr int kMinBlocksOf =
    Fam::kMinBlocks > Rho::kMinBlocks ? Fam::kMinBlocks : Rho::kMinBlocks;

// Fam is NoFamilies (box only) or tinympc::Families<NX, NU>; Rho is
// FixedRho or tinympc::AdaptiveRho<NX, NU, APPLY_C>; Cons is NoConsensus,
// or Consensus<NX, NU> with the families at fixed rho. MULTI: a block
// loads table block_sys[blockIdx.x] of a stack (never with consensus).
template <int NX, int NU, bool WARM, class Fam, class Rho, class Cons,
          bool MULTI>
__global__ void __launch_bounds__(kBlock, (kMinBlocksOf<Fam, Rho>))
    admm_fused_kernel(
        const float* __restrict__ tables, const float* __restrict__ x0,
        float* __restrict__ vnew, float* __restrict__ znew,
        float* __restrict__ g, float* __restrict__ y, float* __restrict__ d,
        float* __restrict__ out_x, float* __restrict__ out_u,
        int* __restrict__ out_iters, unsigned char* __restrict__ out_solved,
        float* __restrict__ out_res, Carry carry, typename Fam::Args fa,
        typename Rho::Args ra, typename Cons::Args ca, int N, int B,
        int max_iter, int check_termination, float rho, float tol_pri,
        float tol_dua, const int* __restrict__ block_sys,
        int table_stride) {
  extern __shared__ float sm[];
  const Layout L(NX, NU, N);
  const int fam_total = L.total + Fam::table_floats(fa, NX, NU, N);
  const int rho_total = fam_total + Rho::table_floats(ra, NX, NU);
  const int total = rho_total + Cons::table_floats(ca, NX, NU);
  // A multi-system launch gives each block its system's packed table, one
  // of the stacked tables; everything after this load is the
  // single-system solve.
  const float* tab = tables;
  if constexpr (MULTI)
    tab += static_cast<size_t>(block_sys[blockIdx.x]) * table_stride;
  for (int k = threadIdx.x; k < total; k += blockDim.x) sm[k] = tab[k];
  __syncthreads();

  // Terminal reference term -Pinf^T Xref[N-1] (admm_pallas.py:823) and,
  // under adaptive rho, its sensitivity -dPinf^T Xref[N-1] after it; then
  // the -(Xref .* Q) and -(Uref .* R) tables in place (:817-818).
  float* pnref = sm + total;
  if (threadIdx.x < NX) {
    const int k = threadIdx.x;
    float acc = 0.f;
    for (int j = 0; j < NX; ++j)
      acc = fmaf(sm[L.pinft + k * NX + j], sm[L.xref + (N - 1) * NX + j], acc);
    pnref[k] = -acc;
    Rho::prologue(ra, sm + fam_total, sm + L.xref + (N - 1) * NX, pnref + NX,
                  k);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N * NX; k += blockDim.x)
    sm[L.xref + k] = -(sm[L.xref + k] * sm[L.qd + k % NX]);
  for (int k = threadIdx.x; k < (N - 1) * NU; k += blockDim.x)
    sm[L.uref + k] = -(sm[L.uref + k] * sm[L.rd + k % NU]);
  __syncthreads();

  const Tables t(sm, L);
  const NegRefTable<NX> negxq{sm + L.xref};

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = b < B;
  const size_t sB = static_cast<size_t>(B);
  const size_t half_x = static_cast<size_t>(N) * NX * sB;
  const size_t half_u = static_cast<size_t>(N - 1) * NU * sB;
  const Fam fam(fa, sm + L.total, sm + L.total, N, sB, b);
  Rho rh(ra, sm + fam_total, pnref + NX, rho, sB, b);
  // The lane arrays of consensus follow the terminal reference rows.
  const Cons cons(ca, sm + rho_total, pnref + NX * (1 + Rho::kTerminalRows));
  cons.template seed<WARM>(sB, b, lane);

  bool done = !lane;
  int iters = 0;
  float res0 = 0.f, res1 = 0.f, res2 = 0.f, res3 = 0.f;
  float x0r[NX], dvgN[NX];
  if (lane) {
#pragma unroll
    for (int k = 0; k < NX; ++k) x0r[k] = x0[static_cast<size_t>(b) * NX + k];
    if constexpr (WARM) {
      // The carried slack into half 1, the duals from the carry.
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const size_t a = (static_cast<size_t>(i) * NX + k) * sB + b;
          g[a] = carry.g_in[a];
          vnew[half_x + a] = carry.vnew_in[a];
        }
      }
      for (int i = 0; i < N - 1; ++i) {
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          const size_t a = (static_cast<size_t>(i) * NU + k) * sB + b;
          y[a] = carry.y_in[a];
          znew[half_u + a] = carry.znew_in[a];
        }
      }
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const size_t a = (static_cast<size_t>(N - 1) * NX + k) * sB + b;
        dvgN[k] = carry.vnew_in[a] - carry.g_in[a];
      }
    } else {
      // Cold workspace (tiny_api.cpp:68-133): g, y and the half iteration
      // 0 reads as "previous" are zero; half 0 is written before it is
      // read.
#pragma unroll
      for (int k = 0; k < NX; ++k) dvgN[k] = 0.f;
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const size_t a = (static_cast<size_t>(i) * NX + k) * sB + b;
          g[a] = 0.f;
          vnew[half_x + a] = 0.f;
        }
      }
      for (int i = 0; i < N - 1; ++i) {
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          const size_t a = (static_cast<size_t>(i) * NU + k) * sB + b;
          y[a] = 0.f;
          znew[half_u + a] = 0.f;
        }
      }
    }
    fam.template seed<WARM>(x0r);
    rh.template init<WARM>();
  }

  for (int it = 0; it < max_iter; ++it) {
    const int cur = it & 1;
    const bool checking = ((it + 1) % check_termination) == 0;
    bool ok = false;      // this iteration's check passed (consensus)
    float u0[NU];
    if (!done) {
      const float* vprev = vnew + (cur ^ 1) * half_x;
      const float* zprev = znew + (cur ^ 1) * half_u;
      // Iteration 0 of a warm solve compares against the carried v/z
      // (admm_pallas.py:1159-1164).
      const bool stale = WARM && it == 0;
      rh.begin(it);
      const Residuals r = tinympc::admm_iteration<NX, NU>(
          t, negxq, pnref, x0r, dvgN, vnew + cur * half_x,
          znew + cur * half_u, vprev, zprev, stale ? carry.v_in : vprev,
          stale ? carry.z_in : zprev, g, y, d, N, sB, b, rh.rho(), checking,
          u0, fam, rh, cons);
      // Adaptive rho every 5th iteration (admm_pallas.py:1079-1142); the
      // dual residuals below scale with the rho after it.
      if constexpr (Rho::kAdaptive) {
        if (rh.adapting())
          rh.adapt(t, sm + L.qd, sm + L.rd, vnew + cur * half_x,
                   znew + cur * half_u, g, y, N);
      }
      // Bookkeeping (admm_pallas.py:1144-1182): iters on every iteration,
      // residuals and convergence on check iterations only.
      iters = it + 1;
      if (checking) {
        res0 = r.pri_s;
        res1 = r.pri_i;
        res2 = r.dua_s * rh.rho();
        res3 = r.dua_i * rh.rho();
        const bool pass = (res0 < tol_pri) && (res1 < tol_pri) &&
                          (res2 < tol_dua) && (res3 < tol_dua);
        if constexpr (Cons::kHooks)
          ok = pass;
        else
          done = pass;
      }
      if constexpr (Cons::kHooks) cons.offer(u0);
    }
    if constexpr (Cons::kHooks) {
      // Consensus (admm_pallas.py:1059-1066, :1171-1175): every thread of
      // the block meets the exchange, a converged or idle one too.
      // Convergence waits for the gate.
      __syncthreads();
      if (!done) {
        const float cres = cons.update(u0);
        ok = ok && cres < tol_pri;
      }
      __syncthreads();
      if (checking && !done) done = ok;
    }
    // Block exit (admm_pallas.py:1220-1255): on check iterations, once no
    // lane of the block is still active. `checking` is uniform.
    if (checking && !__syncthreads_or(!done)) break;
  }

  if (!lane) return;
  // Solution: the slacks of the last iteration this lane ran -- the
  // converging one, or max_iter - 1 (admm_pallas.py:1188-1192, :1257-1264).
  // With max_iter = 0 that is half 1: zero, or the carried slack.
  const int last = (iters - 1) & 1;
  const float* vs = vnew + last * half_x;
  const float* zs = znew + last * half_u;
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int k = 0; k < NX; ++k)
      out_x[(static_cast<size_t>(i) * sB + b) * NX + k] =
          vs[(static_cast<size_t>(i) * NX + k) * sB + b];
  }
  for (int i = 0; i < N - 1; ++i) {
#pragma unroll
    for (int k = 0; k < NU; ++k)
      out_u[(static_cast<size_t>(i) * sB + b) * NU + k] =
          zs[(static_cast<size_t>(i) * NU + k) * sB + b];
  }
  out_iters[b] = iters;
  out_solved[b] = done ? 1 : 0;
  out_res[b] = res0;
  out_res[sB + b] = res1;
  out_res[2 * sB + b] = res2;
  out_res[3 * sB + b] = res3;

  if constexpr (WARM) {
    // Carry out (admm_pallas.py:1273-1283); g/y are already the carry's.
    const bool stale = done && iters == 1;
    const float* vo = !done ? vs : stale ? carry.v_in
                                         : vnew + (last ^ 1) * half_x;
    const float* zo = !done ? zs : stale ? carry.z_in
                                         : znew + (last ^ 1) * half_u;
    tinympc::copy_lane(carry.vnew_out, vs, N * NX, sB, b);
    tinympc::copy_lane(carry.v_out, vo, N * NX, sB, b);
    tinympc::copy_lane(carry.znew_out, zs, (N - 1) * NU, sB, b);
    tinympc::copy_lane(carry.z_out, zo, (N - 1) * NU, sB, b);
  }
  fam.template finish<WARM>(t, cons.kinf(0, t.Mfwd), x0r, d, iters, rh);
  cons.template finish<WARM>(sB, b);
  rh.finish();
}

// Pointers and sizes of one launch.
struct Buffers {
  const float *tables, *x0;
  float *vnew, *znew, *g, *y, *d, *out_x, *out_u;
  int* out_iters;
  unsigned char* out_solved;
  float* out_res;
  int N, B, max_iter, check_termination;
  float rho, tol_pri, tol_dua;
  const int* block_sys;   // null: one system; else each block's system
  int table_stride;       // floats between two systems' tables
};

template <int NX, int NU, bool WARM, class Fam, class Rho, class Cons,
          bool MULTI>
cudaError_t launch_kernel(const Buffers& p, const Carry& carry,
                          const typename Fam::Args& fa,
                          const typename Rho::Args& ra,
                          const typename Cons::Args& ca, size_t smem,
                          cudaStream_t stream) {
  auto kernel = admm_fused_kernel<NX, NU, WARM, Fam, Rho, Cons, MULTI>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.B + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, smem, stream>>>(
      p.tables, p.x0, p.vnew, p.znew, p.g, p.y, p.d, p.out_x, p.out_u,
      p.out_iters, p.out_solved, p.out_res, carry, fa, ra, ca, p.N, p.B,
      p.max_iter, p.check_termination, p.rho, p.tol_pri, p.tol_dua,
      p.block_sys, p.table_stride);
  return cudaGetLastError();
}

// The single-system instantiation, or with p.block_sys the multi-system
// one (none with consensus: the entry refuses that pair).
template <int NX, int NU, bool WARM, class Fam, class Rho = FixedRho,
          class Cons = NoConsensus>
cudaError_t launch(const Buffers& p, const Carry& carry,
                   const typename Fam::Args& fa, cudaStream_t stream,
                   const typename Rho::Args& ra = {},
                   const typename Cons::Args& ca = {}) {
  const int N = p.N;
  const size_t smem =
      (Layout(NX, NU, N).total + Fam::table_floats(fa, NX, NU, N) +
       Rho::table_floats(ra, NX, NU) + Cons::table_floats(ca, NX, NU) +
       NX * (1 + Rho::kTerminalRows) + Cons::lane_floats(ca, NU)) *
      sizeof(float);
  if constexpr (std::is_same_v<Cons, NoConsensus>) {
    if (p.block_sys)
      return launch_kernel<NX, NU, WARM, Fam, Rho, Cons, true>(
          p, carry, fa, ra, ca, smem, stream);
  }
  return launch_kernel<NX, NU, WARM, Fam, Rho, Cons, false>(
      p, carry, fa, ra, ca, smem, stream);
}

Buffers buffers(int N, int B, int max_iter, int check_termination, float rho,
                float tol_pri, float tol_dua, const void* tables,
                const void* x0, void* vnew, void* znew, void* g, void* y,
                void* d, void* out_x, void* out_u, void* out_iters,
                void* out_solved, void* out_res, const void* block_sys,
                int table_stride) {
  return {static_cast<const float*>(tables), static_cast<const float*>(x0),
          static_cast<float*>(vnew),         static_cast<float*>(znew),
          static_cast<float*>(g),            static_cast<float*>(y),
          static_cast<float*>(d),            static_cast<float*>(out_x),
          static_cast<float*>(out_u),        static_cast<int*>(out_iters),
          static_cast<unsigned char*>(out_solved),
          static_cast<float*>(out_res),      N, B, max_iter,
          check_termination, rho, tol_pri, tol_dua,
          static_cast<const int*>(block_sys), table_stride};
}

bool bad_size(const Buffers& p) {
  return p.N < 2 || p.B < 1 || p.max_iter < 0 || p.check_termination < 1 ||
         (p.block_sys && p.table_stride < 1);
}

// The families kernel, with consensus when its group is not 0; under
// `adapt`, the families adaptive-rho kernel. Off (12, 4) every problem
// runs a families instantiation, a box-only one with zero family counts;
// at (12, 4) a box-only problem at fixed or adaptive rho runs admm_group.cu
// and is refused here. cudaErrorInvalidValue for an (nx, nu) pair or a
// combination that is not instantiated.
template <bool WARM, int NX, int NU>
int dispatch_families(const AdaptArgs* adapt, const Buffers& p,
                      const Carry& carry, const FamilyArgs& fa,
                      const ConsensusArgs& ca, cudaStream_t s) {
  using Fam = tinympc::Families<NX, NU>;
  if (adapt)
    return static_cast<int>(
        adapt->apply_c
            ? launch<NX, NU, WARM, Fam, AdaptiveRho<NX, NU, true>>(
                  p, carry, fa, s, *adapt)
            : launch<NX, NU, WARM, Fam, AdaptiveRho<NX, NU, false>>(
                  p, carry, fa, s, *adapt));
  if (ca.group > 0)
    return static_cast<int>(
        launch<NX, NU, WARM, Fam, FixedRho, Consensus<NX, NU>>(p, carry, fa,
                                                               s, {}, ca));
  return static_cast<int>(launch<NX, NU, WARM, Fam>(p, carry, fa, s));
}

template <bool WARM>
int dispatch(int nx, int nu, bool families, const AdaptArgs* adapt,
             const Buffers& p, const Carry& carry, const FamilyArgs& fa,
             const ConsensusArgs& ca, cudaStream_t s) {
  if (nx == 12 && nu == 4) {   // the quadrotor
    if (!families)   // box only, at fixed or adaptive rho: admm_group.cu
      return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_families<WARM, 12, 4>(adapt, p, carry, fa, ca, s);
  }
  if (nx == 6 && nu == 3)      // the rocket
    return dispatch_families<WARM, 6, 3>(adapt, p, carry, fa, ca, s);
  // Cartpole and the degenerate pairs of tests/test_degenerate_dims.py:
  // this kernel alone, no thread-group kind.
  if (nx == 4 && nu == 1)      // cartpole
    return dispatch_families<WARM, 4, 1>(adapt, p, carry, fa, ca, s);
  if (nx == 2 && nu == 2)
    return dispatch_families<WARM, 2, 2>(adapt, p, carry, fa, ca, s);
  if (nx == 2 && nu == 1)
    return dispatch_families<WARM, 2, 1>(adapt, p, carry, fa, ca, s);
  if (nx == 3 && nu == 3)
    return dispatch_families<WARM, 3, 3>(adapt, p, carry, fa, ca, s);
  if (nx == 1 && nu == 1)
    return dispatch_families<WARM, 1, 1>(adapt, p, carry, fa, ca, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Carry carry_from(const void* const* c) {
  return {static_cast<const float*>(c[0]), static_cast<const float*>(c[1]),
          static_cast<const float*>(c[2]), static_cast<const float*>(c[3]),
          static_cast<const float*>(c[4]), static_cast<const float*>(c[5]),
          static_cast<float*>(const_cast<void*>(c[6])),
          static_cast<float*>(const_cast<void*>(c[7])),
          static_cast<float*>(const_cast<void*>(c[8])),
          static_cast<float*>(const_cast<void*>(c[9]))};
}

// q = div_rn(a, b) and r = sqrt_rn(|a|) elementwise: the families kernel's
// division and square root, for a check against IEEE's on the card.
__global__ void check_rounding_kernel(int n, const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float* __restrict__ q,
                                      float* __restrict__ r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    q[i] = tinympc::div_rn(a[i], b[i]);
    r[i] = tinympc::sqrt_rn(fabsf(a[i]));
  }
}

}  // namespace

extern "C" int tinympc_admm_fused_block() { return kBlock; }

extern "C" int tinympc_admm_fused_check_rounding(int n, const void* a,
                                                 const void* b, void* q,
                                                 void* r, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  check_rounding_kernel<<<(n + 255) / 256, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(q), static_cast<float*>(r));
  return static_cast<int>(cudaGetLastError());
}

// The fused solve, cold (warm = 0) or warm. Returns 0 on success, a
// cudaError_t otherwise; cudaErrorInvalidValue for an (nx, nu) pair this
// file does not instantiate, a bad size or a missing array.
// counts: the six family sizes beyond the box (state cones, input cones,
// state and input hyperplanes, state and input time-varying hyperplanes);
// all zero without consensus at (12, 4) is refused (the box solves of
// admm_group.cu, at fixed and adaptive rho). carry: the warm carry in (vnew_in,
// znew_in, g_in, y_in, v_in, z_in) and out (vnew_out, znew_out, v_out,
// z_out; g and y are the carry's g/y out), lane-last (N, nx, B) and
// (N-1, nu, B); all null on a cold solve. fam: 22 arrays -- the working
// slack and dual of each family (vc gc zc yc vl gl zl yl vtv gtv ztv ytv;
// null for a family that is off), then the warm carry in (gc yc gl yl gtv
// ytv x u) and the carried x/u out (null on a cold or box-only solve; on
// a warm solve off (12, 4), which runs a families instantiation, x/u in and
// out are required, a box-only problem's as scratch).
// adapt: null at fixed rho; else the adaptive-rho arguments
// (admm_adaptive.cuh: settings, rho_in -- the carried rho, required on a
// warm solve --, rho_out, the scratch xs, us, axd; rho_v unused), rho the
// problem's rho. cons: null without consensus; else its arguments
// (admm_consensus.cuh: the group size, a power of two up to the block
// size dividing B, rho_c, and on a warm solve the carried dual in and the
// slack and dual out; the carried u is fam's u_in), with the tables'
// step-0 gains after the family tables; not with adapt. A consensus solve
// runs the families kernel and, warm, carries x/u as the families do.
// Group 0 runs the families kernel without consensus (the step-0 gains
// in the table are then not read): the same solve without the exchange.
extern "C" int tinympc_admm_fused_multi(
    int warm, int nx, int nu, int N, int B, int max_iter,
    int check_termination, const int* counts, float rho, float tol_pri,
    float tol_dua, const void* tables, const void* x0, void* vnew,
    void* znew, void* g, void* y, void* d, void* out_x, void* out_u,
    void* out_iters, void* out_solved, void* out_res,
    const void* const* carry, void* const* fam, const AdaptArgs* adapt,
    const ConsensusArgs* cons, const void* block_sys, int table_stride,
    void* stream);

extern "C" int tinympc_admm_fused(
    int warm, int nx, int nu, int N, int B, int max_iter,
    int check_termination, const int* counts, float rho, float tol_pri,
    float tol_dua, const void* tables, const void* x0, void* vnew,
    void* znew, void* g, void* y, void* d, void* out_x, void* out_u,
    void* out_iters, void* out_solved, void* out_res,
    const void* const* carry, void* const* fam, const AdaptArgs* adapt,
    const ConsensusArgs* cons, void* stream) {
  return tinympc_admm_fused_multi(
      warm, nx, nu, N, B, max_iter, check_termination, counts, rho, tol_pri,
      tol_dua, tables, x0, vnew, znew, g, y, d, out_x, out_u, out_iters,
      out_solved, out_res, carry, fam, adapt, cons, nullptr, 0, stream);
}

// The multi-system launch: tinympc_admm_fused's arguments, and before the
// stream block_sys and table_stride. block_sys null is the single-system
// solve; else (not with consensus) tables holds one packed table per
// system, table_stride floats apart, and block k of the ceil(B / 128)
// blocks solves its lanes with table block_sys[k].
extern "C" int tinympc_admm_fused_multi(
    int warm, int nx, int nu, int N, int B, int max_iter,
    int check_termination, const int* counts, float rho, float tol_pri,
    float tol_dua, const void* tables, const void* x0, void* vnew,
    void* znew, void* g, void* y, void* d, void* out_x, void* out_u,
    void* out_iters, void* out_solved, void* out_res,
    const void* const* carry, void* const* fam, const AdaptArgs* adapt,
    const ConsensusArgs* cons, const void* block_sys, int table_stride,
    void* stream) {
  FamilyArgs fa;
  fa.ncx = counts[0];
  fa.ncu = counts[1];
  fa.nlx = counts[2];
  fa.nlu = counts[3];
  fa.ntx = counts[4];
  fa.ntu = counts[5];
  float** work[12] = {&fa.vc, &fa.gc, &fa.zc,  &fa.yc,  &fa.vl,  &fa.gl,
                      &fa.zl, &fa.yl, &fa.vtv, &fa.gtv, &fa.ztv, &fa.ytv};
  for (int k = 0; k < 12; ++k) *work[k] = static_cast<float*>(fam[k]);
  const float** in[8] = {&fa.gc_in,  &fa.yc_in,  &fa.gl_in, &fa.yl_in,
                         &fa.gtv_in, &fa.ytv_in, &fa.x_in,  &fa.u_in};
  for (int k = 0; k < 8; ++k) *in[k] = static_cast<const float*>(fam[12 + k]);
  fa.x_out = static_cast<float*>(fam[20]);
  fa.u_out = static_cast<float*>(fam[21]);
  // Each family that is on needs its arrays, and a warm solve its carry.
  bool families = false;
  for (int f = 0; f < 6; ++f) {
    if (counts[f] < 0) return static_cast<int>(cudaErrorInvalidValue);
    const bool on = counts[f] > 0;
    families = families || on;
    if (on && (!fam[2 * f] || !fam[2 * f + 1] || (warm && !fam[12 + f])))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const Buffers p = buffers(N, B, max_iter, check_termination, rho, tol_pri,
                            tol_dua, tables, x0, vnew, znew, g, y, d, out_x,
                            out_u, out_iters, out_solved, out_res, block_sys,
                            table_stride);
  if (bad_size(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (adapt && (!adapt->rho_out || !adapt->xs || !adapt->us || !adapt->axd ||
                (warm && !adapt->rho_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  ConsensusArgs ca = {0, 0.f, nullptr, nullptr, nullptr, nullptr};
  if (cons) {
    const int G = cons->group;
    if (adapt || G < 0 || G > kBlock || (G & (G - 1)) || (G && B % G) ||
        (warm && G && (!cons->yc0_in || !cons->zc0_out || !cons->yc0_out)) ||
        (!(warm && G) && (cons->yc0_in || cons->zc0_out || cons->yc0_out)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (G && block_sys) return static_cast<int>(cudaErrorInvalidValue);
    if (G) {
      ca = *cons;
      ca.u_in = fa.u_in;
    }
    families = true;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (!warm) {
    if (fa.x_out || fa.u_out) return static_cast<int>(cudaErrorInvalidValue);
    const Carry none = {nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, nullptr};
    return dispatch<false>(nx, nu, families, adapt, p, none, fa, ca, s);
  }
  for (int k = 0; k < 10; ++k)
    if (!carry[k]) return static_cast<int>(cudaErrorInvalidValue);
  // A families instantiation (every problem off (12, 4)) seeds from the
  // carried x/u and hands them over.
  if ((families || !(nx == 12 && nu == 4)) &&
      (!fa.x_in || !fa.u_in || !fa.x_out || !fa.u_out))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(nx, nu, families, adapt, p, carry_from(carry), fa,
                        ca, s);
}
