// Fused batched ADMM solve, cold or warm start: box constraints alone, or
// with the other constraint families (second-order cones, hyperplanes,
// time-varying hyperplanes; admm_families.cuh), at fixed rho; or box
// constraints with adaptive rho (admm_adaptive.cuh).
//
// Replaces those variants of the TPU kernel
// tinympc_tpu/kernels/admm_pallas.py:_make_kernel (launched by _fused_call):
// the cold solve (solve_fused) and the warm solve with its carry
// (solve_fused_warm, FusedCarry). One launch runs the whole ADMM loop for
// every problem of the batch: the iteration of admm_sweep.cuh,
// termination every check_termination iterations, and a per-block exit
// once every lane of the block has converged.
//
// Instantiations: the box-only kernel for (nx, nu) = (12, 4), the
// quadrotor of the main path; the families kernel for (12, 4) and (6, 3),
// the rocket; the adaptive-rho kernel for (12, 4), with and without
// apply_c. The adaptive kernel is the box kernel with the rho hooks filled
// in: each lane's rho and the guard's virtual rho in registers, the
// sensitivity tables after the box tables in shared memory, the adaptation
// every 5th iteration as a second pass over the rows of that iteration
// (admm_adaptive.cuh), the final rho out, and on a warm solve the carried
// rho in. The families kernel is the box kernel with the family hooks
// filled in: each family's slack and dual arrays sit beside the box's in
// device memory, its tables follow the box tables in shared memory, and
// termination still reads the box family's residuals only, as the
// reference does (admm.cpp:310-328). A warm families solve carries the
// family duals and the primal x/u (whose rows seed the family slacks); a
// lane hands over the x/u of the last iteration it ran, re-run from x0 and
// that iteration's feedforward once it has stopped. The families kernel
// takes __launch_bounds__(128, 1): its longer live state fits in registers
// only above the ~100 that ptxas otherwise aims for, and at the batches it
// runs there is about one block an SM anyway.
//
// Design (the first, simple one):
//   * One thread per problem; 128 threads a block; threads past B count as
//     converged from the start. A converged lane stops computing and keeps
//     its iterates, so what a lane returns does not depend on the block it
//     shares (the TPU kernel snapshots instead; the outputs are the same).
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
// What bounds it on an H100: the arithmetic is ~9.4k FMA per lane and
// iteration at nx=12, nu=4, N=20 (0.9 ms for 32768 lanes x 100 iterations
// at the FP32 peak), but this design streams ~7 KB per lane and iteration
// through device memory (the per-lane state, ~4 KB a lane, does not fit in
// the 50 MB L2 at B=32768) and runs only ~250 threads per SM at that batch,
// too few to hide the serial 38-step chain of each iteration. Keeping the
// state on chip and spreading a problem over several threads is later work.
//
// C interface (loaded with ctypes): tinympc_admm_fused, one entry for the
// cold and the warm solve, box-only or with the families, returns the
// cudaError_t of the launch; it launches on the given stream and never
// synchronises.
#include "admm_adaptive.cuh"
#include "admm_families.cuh"
#include "admm_sweep.cuh"

namespace {

using tinympc::AdaptArgs;
using tinympc::AdaptiveRho;
using tinympc::FamilyArgs;
using tinympc::FixedRho;
using tinympc::Layout;
using tinympc::NegXQTable;
using tinympc::NoFamilies;
using tinympc::Residuals;
using tinympc::Tables;

constexpr int kBlock = 128;

// The carry of a warm solve; all pointers null on a cold one.
struct Carry {
  const float *vnew_in, *znew_in, *g_in, *y_in, *v_in, *z_in;
  float *vnew_out, *znew_out, *v_out, *z_out;
};

template <class Fam, class Rho>
constexpr int kMinBlocksOf =
    Fam::kMinBlocks > Rho::kMinBlocks ? Fam::kMinBlocks : Rho::kMinBlocks;

// Fam is NoFamilies (box only) or tinympc::Families<NX, NU>; Rho is
// FixedRho or tinympc::AdaptiveRho<NX, NU, APPLY_C> (box only).
template <int NX, int NU, bool WARM, class Fam, class Rho>
__global__ void __launch_bounds__(kBlock, (kMinBlocksOf<Fam, Rho>))
    admm_fused_kernel(
        const float* __restrict__ tables, const float* __restrict__ x0,
        float* __restrict__ vnew, float* __restrict__ znew,
        float* __restrict__ g, float* __restrict__ y, float* __restrict__ d,
        float* __restrict__ out_x, float* __restrict__ out_u,
        int* __restrict__ out_iters, unsigned char* __restrict__ out_solved,
        float* __restrict__ out_res, Carry carry, typename Fam::Args fa,
        typename Rho::Args ra, int N, int B, int max_iter,
        int check_termination, float rho, float tol_pri, float tol_dua) {
  extern __shared__ float sm[];
  const Layout L(NX, NU, N);
  const int fam_total = L.total + Fam::table_floats(fa, NX, NU, N);
  const int total = fam_total + Rho::table_floats(ra, NX, NU);
  for (int k = threadIdx.x; k < total; k += blockDim.x) sm[k] = tables[k];
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
  const NegXQTable<NX> negxq{sm + L.xref};

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = b < B;
  const size_t sB = static_cast<size_t>(B);
  const size_t half_x = static_cast<size_t>(N) * NX * sB;
  const size_t half_u = static_cast<size_t>(N - 1) * NU * sB;
  const Fam fam(fa, sm + L.total, N, sB, b, rho);
  Rho rh(ra, sm + fam_total, pnref + NX, rho, sB, b);

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
    if (!done) {
      const float* vprev = vnew + (cur ^ 1) * half_x;
      const float* zprev = znew + (cur ^ 1) * half_u;
      // Iteration 0 of a warm solve compares against the carried v/z
      // (admm_pallas.py:1159-1164).
      const bool stale = WARM && it == 0;
      float u0[NU];
      rh.begin(it);
      const Residuals r = tinympc::admm_iteration<NX, NU>(
          t, negxq, pnref, x0r, dvgN, vnew + cur * half_x,
          znew + cur * half_u, vprev, zprev, stale ? carry.v_in : vprev,
          stale ? carry.z_in : zprev, g, y, d, N, sB, b, rh.rho(), checking,
          u0, fam, rh);
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
        done = (res0 < tol_pri) && (res1 < tol_pri) && (res2 < tol_dua) &&
               (res3 < tol_dua);
      }
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
  fam.template finish<WARM>(t, x0r, d, iters);
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
};

template <int NX, int NU, bool WARM, class Fam, class Rho = FixedRho>
cudaError_t launch(const Buffers& p, const Carry& carry,
                   const typename Fam::Args& fa, cudaStream_t stream,
                   const typename Rho::Args& ra = {}) {
  const int N = p.N;
  const size_t smem =
      (Layout(NX, NU, N).total + Fam::table_floats(fa, NX, NU, N) +
       Rho::table_floats(ra, NX, NU) + NX * (1 + Rho::kTerminalRows)) *
      sizeof(float);
  auto kernel = admm_fused_kernel<NX, NU, WARM, Fam, Rho>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.B + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, smem, stream>>>(
      p.tables, p.x0, p.vnew, p.znew, p.g, p.y, p.d, p.out_x, p.out_u,
      p.out_iters, p.out_solved, p.out_res, carry, fa, ra, N, p.B,
      p.max_iter, p.check_termination, p.rho, p.tol_pri, p.tol_dua);
  return cudaGetLastError();
}

Buffers buffers(int N, int B, int max_iter, int check_termination, float rho,
                float tol_pri, float tol_dua, const void* tables,
                const void* x0, void* vnew, void* znew, void* g, void* y,
                void* d, void* out_x, void* out_u, void* out_iters,
                void* out_solved, void* out_res) {
  return {static_cast<const float*>(tables), static_cast<const float*>(x0),
          static_cast<float*>(vnew),         static_cast<float*>(znew),
          static_cast<float*>(g),            static_cast<float*>(y),
          static_cast<float*>(d),            static_cast<float*>(out_x),
          static_cast<float*>(out_u),        static_cast<int*>(out_iters),
          static_cast<unsigned char*>(out_solved),
          static_cast<float*>(out_res),      N, B, max_iter,
          check_termination, rho, tol_pri, tol_dua};
}

bool bad_size(const Buffers& p) {
  return p.N < 2 || p.B < 1 || p.max_iter < 0 || p.check_termination < 1;
}

// The box-only kernel when no family beyond the box is on, else the
// families kernel, at fixed rho; the adaptive-rho kernel when `adapt` is
// given (box only); cudaErrorInvalidValue for an (nx, nu) pair or a
// combination that is not instantiated.
template <bool WARM>
int dispatch(int nx, int nu, bool families, const AdaptArgs* adapt,
             const Buffers& p, const Carry& carry, const FamilyArgs& fa,
             cudaStream_t s) {
  if (adapt) {
    if (families || nx != 12 || nu != 4)
      return static_cast<int>(cudaErrorInvalidValue);
    const NoFamilies::Args none{};
    return static_cast<int>(
        adapt->apply_c
            ? launch<12, 4, WARM, NoFamilies, AdaptiveRho<12, 4, true>>(
                  p, carry, none, s, *adapt)
            : launch<12, 4, WARM, NoFamilies, AdaptiveRho<12, 4, false>>(
                  p, carry, none, s, *adapt));
  }
  if (!families && nx == 12 && nu == 4)   // the quadrotor of the main path
    return static_cast<int>(
        launch<12, 4, WARM, NoFamilies>(p, carry, NoFamilies::Args{}, s));
  if (families && nx == 12 && nu == 4)    // the quadrotor hyperplane demos
    return static_cast<int>(
        launch<12, 4, WARM, tinympc::Families<12, 4>>(p, carry, fa, s));
  if (families && nx == 6 && nu == 3)     // the rocket
    return static_cast<int>(
        launch<6, 3, WARM, tinympc::Families<6, 3>>(p, carry, fa, s));
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
// all zero runs the box-only kernel. carry: the warm carry in (vnew_in,
// znew_in, g_in, y_in, v_in, z_in) and out (vnew_out, znew_out, v_out,
// z_out; g and y are the carry's g/y out), lane-last (N, nx, B) and
// (N-1, nu, B); all null on a cold solve. fam: 22 arrays -- the working
// slack and dual of each family (vc gc zc yc vl gl zl yl vtv gtv ztv ytv;
// null for a family that is off), then the warm carry in (gc yc gl yl gtv
// ytv x u) and the carried x/u out (null on a cold or box-only solve).
// adapt: null at fixed rho; else the adaptive-rho arguments
// (admm_adaptive.cuh: settings, rho_in -- the carried rho, required on a
// warm solve --, rho_out, the scratch xs, us, axd), box only, rho the
// problem's rho.
extern "C" int tinympc_admm_fused(
    int warm, int nx, int nu, int N, int B, int max_iter,
    int check_termination, const int* counts, float rho, float tol_pri,
    float tol_dua, const void* tables, const void* x0, void* vnew,
    void* znew, void* g, void* y, void* d, void* out_x, void* out_u,
    void* out_iters, void* out_solved, void* out_res,
    const void* const* carry, void* const* fam, const AdaptArgs* adapt,
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
                            out_u, out_iters, out_solved, out_res);
  if (bad_size(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (adapt && (!adapt->rho_out || !adapt->xs || !adapt->us || !adapt->axd ||
                (warm && !adapt->rho_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (!warm) {
    if (fa.x_out || fa.u_out) return static_cast<int>(cudaErrorInvalidValue);
    const Carry none = {nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, nullptr};
    return dispatch<false>(nx, nu, families, adapt, p, none, fa, s);
  }
  for (int k = 0; k < 10; ++k)
    if (!carry[k]) return static_cast<int>(cudaErrorInvalidValue);
  if (families && (!fa.x_in || !fa.u_in || !fa.x_out || !fa.u_out))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(nx, nu, families, adapt, p, carry_from(carry), fa,
                        s);
}
