// Fused batched ADMM solve of box-constrained problems at fixed rho, cold
// or warm start, one system or a fleet (a system a 128-lane tile): the
// main path's kernel.
//
// Replaces those variants of the TPU kernel
// tinympc_tpu/kernels/admm_pallas.py:_make_kernel (launched by _fused_call;
// the multi_tps variant, :532-575): the cold solve (solve_fused), the warm
// solve with its carry (solve_fused_warm, FusedCarry; final=True too, which
// keeps no snapshots here), and solve_fused_multi / the fleet solver. One
// launch runs the whole ADMM loop for every problem of the batch,
// termination every check_termination iterations, and a per-block exit
// once every problem of the block has converged. The other families,
// adaptive rho and consensus run csrc/admm_fused.cu.
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
// C interface (loaded with ctypes): tinympc_admm_group returns the
// cudaError_t of the launch; it launches on the given stream and never
// synchronises.
#include "admm_group.cuh"

namespace {

using tinympc::GroupArena;
using tinympc::GroupSweep;
using tinympc::Layout;
using tinympc::Residuals;

using tinympc::Place;

constexpr int kGroup = 16;         // threads a problem: a row each at (12, 4)
constexpr int kMaxThreads = 128;   // P * kGroup
// Blocks an SM must hold: the register budget. ptxas then keeps ~96
// registers a thread, at most 128 (80 under a bound of 256 threads and no
// minimum, which measured slower; 3 blocks and 4 measured alike).
constexpr int kMinBlocks = 4;
constexpr int kTile = 128;         // lanes a fleet's block_sys entry covers
constexpr size_t kMaxSmem = 232448;

// The carry of a warm solve; all pointers null on a cold one.
struct Carry {
  const float *vnew_in, *znew_in, *g_in, *y_in, *v_in, *z_in;
  float *vnew_out, *znew_out, *v_out, *z_out, *g_out, *y_out;
};

// PLACE (tinympc::Place): kShared copies the packed table into shared
// memory (its reads are then shared-memory loads); kTableGlobal reads it in
// device memory; kSavedGlobal (warm only) also keeps the saved columns in
// `saved`, (grid, N, P * (NX + NU)).
template <int NX, int NU, bool WARM, int PLACE>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) admm_group_kernel(
    const float* __restrict__ tables, const float* __restrict__ x0,
    float* __restrict__ out_x, float* __restrict__ out_u,
    int* __restrict__ out_iters, unsigned char* __restrict__ out_solved,
    float* __restrict__ out_res, Carry carry, int N, int B, int max_iter,
    int check_termination, float rho, float tol_pri, float tol_dua, int P,
    const int* __restrict__ block_sys, int table_stride,
    float* __restrict__ saved) {
  constexpr int G = kGroup;
  using Sweep = GroupSweep<NX, NU, G>;
  constexpr int R = Sweep::R;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Layout L(NX, NU, N);
  const int b0 = blockIdx.x * P;
  const float* tab = tables;
  if (block_sys) tab += static_cast<size_t>(block_sys[b0 / kTile]) * table_stride;
  float* arena = sm;
  if constexpr (PLACE == Place::kShared) {
    for (int k = threadIdx.x; k < L.total; k += blockDim.x) sm[k] = tab[k];
    tab = sm;
    arena = sm + tinympc::align4(L.total);
  }
  float* vg = nullptr;
  if constexpr (PLACE == Place::kSavedGlobal)
    vg = saved + blockIdx.x * GroupArena<NX, NU>::saved_floats(N, P);
  __syncthreads();

  const int p = threadIdx.x / G, g = threadIdx.x % G;
  const int b = b0 + p;
  const bool lane = b < B;
  const Sweep sw(tab, L, arena, N, P, p, g,
                 WARM && PLACE != Place::kSavedGlobal, vg);
  const size_t sB = static_cast<size_t>(B);

  float x0r[R], dvgN[R], pnref[R], u0[R];
  bool done = !lane;
  int iters = 0;
  float res0 = 0.f, res1 = 0.f, res2 = 0.f, res3 = 0.f;
  if (lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
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
    }
  }

  for (int it = 0; it < max_iter; ++it) {
    const bool checking = ((it + 1) % check_termination) == 0;
    if (!done) {
      float pt[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pt[r] = pnref[r] - rho * dvgN[r];
      sw.backward(N, rho, pt);
      // Iteration 0 of a warm solve compares against the carried v/z
      // (admm_pallas.py:1159-1164).
      const Residuals rr = sw.template forward<WARM>(N, x0r, dvgN, checking,
                                                     WARM && it == 0, u0);
      // Bookkeeping (admm_pallas.py:1144-1182).
      iters = it + 1;
      if (checking) {
        res0 = rr.pri_s;
        res1 = rr.pri_i;
        res2 = rr.dua_s * rho;
        res3 = rr.dua_i * rho;
        done = (res0 < tol_pri) && (res1 < tol_pri) && (res2 < tol_dua) &&
               (res3 < tol_dua);
      }
    }
    // Block exit (admm_pallas.py:1220-1255): on check iterations, once no
    // problem of the block is still active. `checking` is uniform.
    if (checking && !__syncthreads_or(!done)) break;
  }

  if (!lane) return;
  // Solution: the slacks of the last iteration this problem ran
  // (admm_pallas.py:1188-1192, :1257-1264); with max_iter 0 the start.
#pragma unroll
  for (int r = 0; r < R; ++r) {
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
    }
  }
  if (g == 0) {
    out_iters[b] = iters;
    out_solved[b] = done ? 1 : 0;
    out_res[b] = res0;
    out_res[sB + b] = res1;
    out_res[2 * sB + b] = res2;
    out_res[3 * sB + b] = res3;
  }
}

// Shared memory of a launch: the table (kShared) and the arena of P
// problems, with the saved columns of a warm solve but at kSavedGlobal.
template <int NX, int NU>
size_t smem_bytes(int N, int P, int place, bool warm) {
  const int table = place == Place::kShared
                        ? tinympc::align4(Layout(NX, NU, N).total) : 0;
  return (table + GroupArena<NX, NU>::floats(
                      N, P, warm && place != Place::kSavedGlobal)) *
         sizeof(float);
}

template <int NX, int NU, bool WARM>
cudaError_t launch(const float* tables, const float* x0, float* out_x,
                   float* out_u, int* out_iters, unsigned char* out_solved,
                   float* out_res, const Carry& carry, int N, int B,
                   int max_iter, int ct, float rho, float tol_pri,
                   float tol_dua, int P, int place, const int* block_sys,
                   int table_stride, float* saved, cudaStream_t stream) {
  if (P < 1 || P * kGroup > kMaxThreads || kTile % P)
    return cudaErrorInvalidValue;
  if (place == Place::kSavedGlobal ? !WARM || !saved
                                   : place != Place::kShared &&
                                         place != Place::kTableGlobal)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<NX, NU>(N, P, place, WARM);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = place == Place::kShared
                    ? admm_group_kernel<NX, NU, WARM, Place::kShared>
                    : admm_group_kernel<NX, NU, WARM, Place::kTableGlobal>;
  if constexpr (WARM)   // a cold solve keeps no saved columns
    if (place == Place::kSavedGlobal)
      kernel = admm_group_kernel<NX, NU, WARM, Place::kSavedGlobal>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + P - 1) / P);
  kernel<<<grid, P * kGroup, smem, stream>>>(
      tables, x0, out_x, out_u, out_iters, out_solved, out_res, carry, N, B,
      max_iter, ct, rho, tol_pri, tol_dua, P, block_sys, table_stride,
      saved);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tinympc_admm_group_max_threads() { return kMaxThreads; }
extern "C" int tinympc_admm_group_width() { return kGroup; }
extern "C" int tinympc_admm_group_tile() { return kTile; }
// Bytes of shared memory of a launch at (N, P, place), cold or warm, at
// (12, 4); the wrapper holds its own geometry against it.
extern "C" long long tinympc_admm_group_smem(int N, int P, int place,
                                             int warm) {
  return static_cast<long long>(smem_bytes<12, 4>(N, P, place, warm != 0));
}

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
  if (N < 2 || B < 1 || max_iter < 0 || check_termination < 1 ||
      (block_sys && table_stride < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Carry c = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (warm) {
    for (int k = 0; k < 12; ++k)
      if (!carry[k]) return static_cast<int>(cudaErrorInvalidValue);
    c = {static_cast<const float*>(carry[0]),
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
  return static_cast<int>(
      warm ? launch<12, 4, true>(t, x, ox, ou, oi, os, orr, c, N, B,
                                 max_iter, check_termination, rho, tol_pri,
                                 tol_dua, problems, place, bs, table_stride,
                                 sv, s)
           : launch<12, 4, false>(t, x, ox, ou, oi, os, orr, c, N, B,
                                  max_iter, check_termination, rho, tol_pri,
                                  tol_dua, problems, place, bs, table_stride,
                                  sv, s));
}
