// The streamed forward launch of box problems at fixed rho on lane teams:
// the forward kernel that the long-horizon box solves run (admm_stream.cu
// routes families, adaptive rho and consensus to stream_forward_kernel).
//
// It computes what admm_sweep.cuh's forward_sweep computes with
// NoFamilies, FixedRho and NoConsensus, and the bookkeeping of
// stream_forward_kernel (admm_stream.py:474-641): the rollout u = -Kinf x
// - d, x+ = A x + B u + f; each row projected onto its box and its dual
// updated from the pre-update dual; the four max-abs residuals on check
// iterations; iterations, residuals, convergence and the `active` flag.
//
// Why a team: stream_forward_kernel runs one thread a lane, 128 lanes a
// block, so B=1024 fills 8 of the H100's 132 SMs and B=4096 32, and each
// thread walks its lane's rows in series, every row waiting on device
// memory and on the row before's x (1.7357 ms a launch at N=256, B=4096,
// against a 0.0851 ms byte bound; PERF.md section 6, row 4). Here:
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
//   * Each thread keeps its row of [Kinf; A] and of B in registers, as
//     admm_group.cuh does. x and u pass through the lane's slot in shared
//     memory, two barriers a step: after the first every thread reads x,
//     the input rows form u = -Kinf x - d and write it, the state rows form
//     A x; after the second the state rows read u and write x+. Each row's
//     projection and dual update sit beside the dot products of its step,
//     off the x -> u -> x+ chain.
//   * What a row reads at step i and that does not hang on the chain -- its
//     dual, its bounds, the slack of the dual residual, d -- is staged into
//     shared memory kTeamDepth - 1 steps ahead with cp.async, each thread
//     its own entries (ring[stage][field][thread]: no other thread reads
//     them, so cp.async.wait_group alone orders them). At B=1024 a block
//     has an SM to itself and nothing else hides device memory's latency:
//     one row ahead (kTeamDepth 2, the lookahead of a register double
//     buffer) ran N=512 1.3-1.4x slower than 7 rows ahead, 3 rows ahead
//     in between.
//   * Residuals: each thread keeps the maxima of its own rows; they are
//     reduced over the lane's team once, at the end of a check launch,
//     with max_nan, which is order-free (a NaN sticks in any order).
//   * A converged lane's threads reach every barrier and store nothing; a
//     block whose lanes are all done returns at once; a lane past B is a
//     done lane. Its iterates stay as they were at first convergence.
//   * Bits: every row's dot product is summed from zero in
//     forward_sweep's column order with fmaf, and every elementwise term
//     rounds as there (-fmad=false), so the outputs are bitwise
//     stream_forward_kernel's.
// The stale launch (the first iteration of a warm solve) is this kernel
// given the carried v/z for the dual residual's slacks: nothing else
// differs (stream_forward_kernel's STALE only picks those pointers).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_compare.py time in
// turns with the one-thread kernel, N=512, a fresh launch; PERF.md section
// 6): B=1024 0.1787-0.1902 against 2.9296-2.9562 ms, B=4096 0.3672-0.3699
// against 3.5065-3.5435, B=16384 1.4818-1.4919 against 3.9565-3.9738
// (byte bounds 0.0426, 0.1702, 0.6809). The staging depth and the (6, 3)
// mapping were chosen by timing copies of this file (PERF.md section 6).
#pragma once

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
};

// Steps staged ahead, the fields of a staged step (dual, lower and upper
// bound, the dual residual's slack, d), and the blocks an SM the register
// budget leaves room for.
constexpr int kTeamDepth = 8;
constexpr int kTeamFields = 5;
constexpr int kTeamMinBlocks = 6;

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

// Forward launch of iteration `it`: the new slacks into vcur/zcur, the
// duals g/y in place, and for the running lanes the bookkeeping; vd/zd are
// the slacks the dual residual compares against (the previous iterate's,
// or the carried v/z in the stale launch).
template <int NX, int NU>
__global__ void __launch_bounds__(TeamShape<NX, NU>::kThreads,
                                  kTeamMinBlocks)
    stream_forward_team_kernel(
        const float* __restrict__ tables, const float* __restrict__ x0,
        const float* __restrict__ vd, const float* __restrict__ zd,
        float* __restrict__ vcur, float* __restrict__ zcur,
        float* __restrict__ g, float* __restrict__ y,
        const float* __restrict__ d, int* __restrict__ iters,
        unsigned char* __restrict__ done, float* __restrict__ res,
        int* __restrict__ active, int it, int N, int B,
        int check_termination, float rho, float tol_pri, float tol_dua) {
  using S = TeamShape<NX, NU>;
  __shared__ __align__(16) float xu[S::kLanes * S::kSlot];
  __shared__ float ring[kTeamDepth][kTeamFields][S::kThreads];
  __shared__ float red[2][S::kThreads];
  const int t = threadIdx.x;
  const int row = t / S::kLanes, lane = t % S::kLanes;
  const int b = blockIdx.x * S::kLanes + lane;
  const bool run = b < B && !done[b];
  if (!__syncthreads_or(run)) return;

  const Layout L(NX, NU, N);
  const size_t sB = static_cast<size_t>(B);
  const bool checking = ((it + 1) % check_termination) == 0;
  const bool st = row < NX;   // a state row; else an input row
  const int k = st ? row : row - NX;
  // This row of [Kinf; A] and of B (an input row: no B row), and f.
  float f1[NX], bm[NU];
  const int mrow = st ? NU + k : k;
#pragma unroll
  for (int c = 0; c < NX; ++c) f1[c] = tables[L.mfwd + mrow * NX + c];
#pragma unroll
  for (int c = 0; c < NU; ++c) bm[c] = st ? tables[L.bm + k * NU + c] : 0.f;
  const float fv = st ? tables[L.f + k] : 0.f;
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
    }
    stage_commit();
  };
  float pr = 0.f, du = 0.f;   // this row's residual maxima
  // Project `val` (x or u of step i) onto the box, update the dual from the
  // pre-update one, store both, and fold in the residuals.
  auto project = [&](int i, float val) {
    const int s = i % kTeamDepth;
    const size_t a = static_cast<size_t>(i) * step;
    const float dn0 = ring[s][0][t];
    const float sn = clamp_nan(val + dn0, ring[s][1][t], ring[s][2][t]);
    dual[a] = dn0 + val - sn;
    slack[a] = sn;
    if (checking) {
      pr = max_nan(pr, fabsf(val - sn));
      du = max_nan(du, fabsf(ring[s][3][t] - sn));
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
  for (int i = 0; i < N - 1; ++i) {
    __syncthreads();   // x of step i in the slots
    issue(i + kTeamDepth - 1);
    stage_wait<kTeamDepth - 1>();   // step i's fields have landed
    float a1 = 0.f;
    if (run) {
      float x[S::kXP];
      load_slot(x, slot);
#pragma unroll
      for (int c = 0; c < NX; ++c) a1 = fmaf(f1[c], x[c], a1);   // A x / Kinf x
      if (st) {
        project(i, xo);
      } else {
        // u = -Kinf x - d as an exact subtract
        const float u = -a1 - ring[i % kTeamDepth][4][t];
        slot[S::kXP + k] = u;
        project(i, u);
      }
    }
    __syncthreads();   // u of step i in the slots
    if (run && st) {
      float u[S::kUP];
      load_slot(u, slot + S::kXP);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NU; ++c) acc = fmaf(bm[c], u[c], acc);
      // x+ = (A x + B u) + f
      xo = a1 + acc + fv;
      slot[k] = xo;
    }
  }
  stage_wait<0>();
  if (run && st) project(N - 1, xo);

  // Bookkeeping (admm_stream.py:576-641), by row 0's thread: iterations on
  // every iteration, residuals (dual rows scaled by rho) and convergence on
  // check iterations, the team's maxima reduced first.
  if (checking) {
    red[0][t] = pr;
    red[1][t] = du;
    __syncthreads();
  }
  if (!run || row != 0) return;
  iters[b] = it + 1;
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
  const float r2 = ds * rho, r3 = di * rho;
  res[b] = ps;
  res[sB + b] = pi;
  res[2 * sB + b] = r2;
  res[3 * sB + b] = r3;
  if ((ps < tol_pri) && (pi < tol_pri) && (r2 < tol_dua) && (r3 < tol_dua))
    done[b] = 1;
  else
    *active = 1;
}

}  // namespace tinympc
