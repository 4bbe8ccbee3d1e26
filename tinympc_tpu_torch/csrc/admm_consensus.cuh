// Scenario-tree consensus on u[0] as the hooks admm_iteration
// (admm_sweep.cuh) calls, and the exchange the fused solve (admm_fused.cu)
// runs after each iteration. They replace the consensus parts of the TPU
// kernel tinympc_tpu/kernels/admm_pallas.py:_make_kernel: the step-0 gain
// pair Kinf0 / Quu0_inv in both sweeps (:804-806, :837-839, :945-982), the
// r[0] term -rho_c (zc0 - yc0) (:904-906), the group mean
// (_segment_mean_lanes, :354-384, :1059-1066), the dual update, the
// residual gate (:1171-1175), the seeds (:693-707) and the carry out
// (:1292-1296).
//
// A scenario group is G adjacent lanes, G a power of two up to the block
// size, so a group never straddles two blocks and its lanes meet in one
// block's shared memory. Each lane keeps its slack zc0 and dual yc0 in a
// (NU, BLOCK) column of shared memory; after an iteration it writes its
// offer cand0 = u[0] + yc0 into a third such array, every thread of the
// block passes a barrier (a converged thread too: it skips the iteration
// but not the barrier), each active lane sums its group's G offers in lane
// order from zero and divides by G (div_rn: the exact quotient, rounded
// once, as the plain version's division), takes zc0 = that mean,
// yc0 += u[0] - zc0, and gates its convergence on max|u[0] - zc0| <
// abs_pri_tol; a second barrier keeps the next iteration's offers from
// overwriting offers still being read. A converged lane freezes: it
// writes no more offers, so the offer of its converging iteration stands
// for its group until the solve ends (the JAX package's XLA path offers
// one iteration past the frozen iterate instead, and its TPU kernel keeps
// iterating converged lanes; the plain version in kernels/admm_fused.py
// follows this kernel's rule).
//
// The families kernel has an instantiation with these hooks, which the
// entry point picks for a consensus solve; its other instantiations, and
// the box-only, adaptive-rho, closed-loop and streamed kernels, take
// NoConsensus (admm_sweep.cuh), whose hooks compile to nothing. (A
// run-time flag in the one families instantiation cost its other problems
// up to 12%: the row hooks' tests and pointer selects sit in the serial
// sweep of every row.)
#pragma once

#include "admm_families.cuh"
#include "admm_sweep.cuh"

namespace tinympc {

// Per-launch consensus arguments: the group size G and rho_c; on a warm solve the carried u (its row 0 seeds the slack) and
// dual in, (N-1, nu, B) and (nu, B), and the slack and dual out, (nu, B).
// All pointers null on a cold solve.
struct ConsensusArgs {
  int group;
  float rho_c;
  const float* u_in;
  const float* yc0_in;
  float* zc0_out;
  float* yc0_out;
};

template <int NX, int NU, int BLOCK>
struct Consensus {
  using Args = ConsensusArgs;
  static constexpr bool kHooks = true;
  ConsensusArgs a;
  const float* K0;   // Kinf0 (NU, NX), shared memory
  const float* Q0;   // Quu0_inv (NU, NU), shared memory
  float* lanes;      // zc0, yc0 and offer, (NU, BLOCK) each, shared memory

  // The step-0 gains after the other tables, and the three lane arrays.
  static __host__ __device__ int table_floats(const ConsensusArgs&, int nx,
                                              int nu) {
    return nu * nx + nu * nu;
  }
  static __host__ __device__ int lane_floats(const ConsensusArgs&, int nu) {
    return 3 * nu * BLOCK;
  }

  __device__ Consensus(const ConsensusArgs& args, const float* tables,
                       float* lane_arrays)
      : a(args), K0(tables), Q0(tables + NU * NX), lanes(lane_arrays) {}

  __device__ __forceinline__ float& zc0(int k) const {
    return lanes[k * BLOCK + threadIdx.x];
  }
  __device__ __forceinline__ float& yc0(int k) const {
    return lanes[(NU + k) * BLOCK + threadIdx.x];
  }
  __device__ __forceinline__ float* offers(int k) const {
    return lanes + (2 * NU + k) * BLOCK;
  }

  // Row-0 hooks of the sweeps: r[0] gains -rho_c (zc0 - yc0) after the
  // families' terms, d[0] takes Quu0_inv, u[0] takes Kinf0.
  __device__ __forceinline__ void r_terms(int i, float* r) const {
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < NU; ++k) r[k] = r[k] - a.rho_c * (zc0(k) - yc0(k));
    }
  }
  __device__ __forceinline__ const float* quu(int i, const float* q) const {
    return i == 0 ? Q0 : q;
  }
  __device__ __forceinline__ const float* kinf(int i, const float* k) const {
    return i == 0 ? K0 : k;
  }

  // Seeds (admm.seed_extra_slacks, admm_pallas.py:693-707): the slack from
  // the carried u[0] (zero on a cold solve), the dual from the carry (zero
  // cold), no offer yet. Every thread of the block seeds its column, a
  // lane past the batch with zeros.
  template <bool WARM>
  __device__ __forceinline__ void seed(size_t sB, int b, bool lane) const {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const size_t o = static_cast<size_t>(k) * sB + b;
      zc0(k) = WARM && lane ? a.u_in[o] : 0.f;
      yc0(k) = WARM && lane ? a.yc0_in[o] : 0.f;
      offers(k)[threadIdx.x] = 0.f;
    }
  }

  // This lane's offer u[0] + yc0, before the barrier.
  __device__ __forceinline__ void offer(const float* u0) const {
#pragma unroll
    for (int k = 0; k < NU; ++k) offers(k)[threadIdx.x] = u0[k] + yc0(k);
  }

  // After the barrier: the group mean of the offers, the new slack and
  // dual; returns the consensus residual max|u[0] - zc0|.
  __device__ __forceinline__ float update(const float* u0) const {
    const int G = a.group;
    const int first = threadIdx.x & ~(G - 1);
    float cres = 0.f;
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const float* row = offers(k) + first;
      float sum = 0.f;
      for (int j = 0; j < G; ++j) sum = sum + row[j];
      const float z = div_rn(sum, static_cast<float>(G));
      yc0(k) = yc0(k) + u0[k] - z;
      zc0(k) = z;
      cres = max_nan(cres, fabsf(u0[k] - z));
    }
    return cres;
  }

  // The warm carry out: the slack and dual of the last iteration this lane
  // ran (frozen since its convergence).
  template <bool WARM>
  __device__ __forceinline__ void finish(size_t sB, int b) const {
    if (!WARM) return;
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const size_t o = static_cast<size_t>(k) * sB + b;
      a.zc0_out[o] = zc0(k);
      a.yc0_out[o] = yc0(k);
    }
  }
};

}  // namespace tinympc
