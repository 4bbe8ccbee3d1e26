// Streamed batched ADMM solve for long horizons: each iteration is two
// launches, a backward and a forward sweep over the horizon, box
// constraints alone or with the other constraint families (second-order
// cones, hyperplanes, time-varying hyperplanes; admm_families.cuh), at
// fixed rho with or without scenario-tree consensus on u[0]
// (admm_consensus.cuh), or with adaptive rho (admm_adaptive.cuh), cold or
// warm. The host loop (kernels/admm_stream.py) launches them. One
// instantiation serves every mix of families at each (nx, nu): a family
// that is off has count 0, and its hooks do nothing. (A box-only
// instantiation, without the hooks, spilled 752 B in its backward kernel
// at the 128-register cap, and spilled without the cap too.) The pairs are
// (12, 4) and (6, 3), and on the one-thread kernels alone cartpole's
// (4, 1) and the degenerate (2, 2), (2, 1), (3, 3) and (1, 1); the team
// entries take (12, 4) and (6, 3) only.
// Consensus is an instantiation of its own (CONS), not a run-time flag: in
// the resident families kernel such a flag cost the other problems ~12%.
//
// Replaces the TPU kernels of tinympc_tpu/kernels/admm_stream.py:
//   * stream_backward_kernel <- _backward_kernel (:121): forms the q/r rows
//     of the linear cost, rolls the costate p from the terminal row down to
//     row 0, and writes the feedforward d;
//   * stream_forward_kernel <- _forward_kernel (:258), and its STALE
//     variant <- _forward_kernel(stale=True), which the first iteration of
//     a warm solve runs: rolls x and u = -Kinf x - d, projects onto the box
//     and updates the duals row by row, projects the other families,
//     accumulates the four max-abs residuals, and does the bookkeeping of
//     :573-641 (iterations, convergence every check_termination
//     iterations, residuals). On warm solves with families or consensus
//     it also writes the x/u trajectories the carry hands over (track_xu).
//     Both run the problems with families under adaptive rho, consensus
//     groups whose thread-block cluster cannot be formed (and, with
//     team=False in kernels/admm_stream.py, any problem);
//   * stream_backward_team_kernel and stream_forward_team_kernel
//     (admm_stream_team.cuh) <- the same two TPU kernels, for box problems
//     at fixed or adaptive rho and for problems with families, consensus or
//     both at fixed rho (the families of admm_pallas.py:283-351 as the
//     forward's projections; consensus with TeamConsensus, a scenario group
//     in a block or across a thread-block cluster): a thread a row of each
//     lane, bitwise the one-thread kernels' (the forward's stale launch is
//     the same kernel given the carried v/z).
// Their CONS instantiations add consensus (admm_stream.py:229-239, :496-499,
// :553-570): the backward kernel's row 0 takes r[0] - rho_c (zc0 - yc0) and
// the Quu0_inv gain, the forward kernel's row 0 the Kinf0 gain, and at the
// end of the forward launch the lanes of a group exchange their offers
// u[0] + yc0 in shared memory: zc0 becomes the group mean, yc0 moves by
// u[0] - zc0, and |u[0] - zc0| joins the convergence gate. The hooks and
// the exchange are admm_consensus.cuh's, the resident kernel's, so the two
// solves agree bitwise under consensus too.
// Their adaptive instantiations (the rho policy Rho = AdaptiveRho, as the
// resident kernel takes it; admm_stream.py:121-191, :203-210, :258,
// :400-472, :577-621) keep each lane's rho and the guard's virtual rho in
// device memory, (B,) each, between launches: the backward launch reads the
// lane's rho, scales the box and family terms by it and adds the
// drho-scaled sensitivity products (dKinf^T r, the terminal -dPinf^T
// Xref[N-1], and dC1 w, dC2 p under apply_c); the forward launch telescopes
// the rollout gain, runs admm_adaptive.cuh's adaptation pass on an
// adaptation iteration of a running lane -- a second pass over the rows the
// sweep kept in scratch, on the same thread, where the TPU kernel carries
// "pending" cross-row terms between its horizon chunks -- and commits the
// new rho before the termination check. apply_c moves only the backward
// sweep, so the forward kernel has one adaptive instantiation.
// The arithmetic of each sweep is admm_sweep.cuh's backward_sweep and
// forward_sweep, the same device functions the resident fused solve
// (admm_fused.cu) runs, so the two solves agree bitwise.
//
// Why stream at all on Hopper: the resident kernel keeps its packed tables
// (the reference, the box bounds, the time-varying hyperplanes; ~192 B a
// horizon row at nx=12, nu=4) in shared memory, and past N ~ 1190 they
// exceed the 232,448 B a block may have. Here shared memory holds only the
// tables whose size does not grow with N (the small matrices, cones and
// static hyperplanes: ~2.7 KB at (12, 4)); the per-row tables are read row
// by row from device memory, where every thread of a warp reads the same
// word (a broadcast, served by L1/L2). The TPU's VMEM chunking has no
// counterpart: the per-lane trajectories already live in device memory in
// the lane-last layout (rows, features, B), one thread per lane, so a
// warp's access to a row is one coalesced line.
//
// Design (the first, simple one):
//   * One thread per problem, 128 a block. p, x and the row being formed
//     stay in registers, so each sweep is one pass over the lane's rows.
//   * A converged lane stops: both kernels return at once for it, and a
//     block whose lanes are all done returns at once (the per-tile exit).
//     Its iterates stay as they were at first convergence, so the solution
//     and the warm carry are read from the arrays at the end, with no
//     snapshot or blend (the TPU kernels snapshot instead; the outputs are
//     the same). vnew/znew are ping-pong halves, (2, N, nx, B) and
//     (2, N-1, nu, B): iteration `it` writes half it % 2 and reads the
//     previous iterate from the other, which the carry's one-behind v/z
//     also needs.
//   * The backward launch zeroes a one-int flag; the forward launch of a
//     check iteration sets it for every lane still active after the check,
//     so the host reads one int, after check iterations only.
//   * The dead rows of the TPU kernels are not computed: d and u exist for
//     rows 0..N-2 only.
//   * Consensus: each lane's slack zc0, dual yc0 and standing offer live in
//     device memory, (nu, B) each, between launches; a launch copies the
//     lane's slack and dual into admm_consensus.cuh's shared-memory columns
//     and stores a lane's offer only on its converging iteration. A group is G
//     adjacent lanes of one block (G a power of two up to 128), so the
//     exchange needs no other block. Every thread of a block that holds a
//     running lane reaches the exchange's barrier, a converged one too
//     (it puts its standing offer, the offer of its converging iteration,
//     into shared memory); only a block whose lanes are all done returns
//     at once. (On lane teams a block holds 8 or 16 lanes, so a larger
//     group is a thread-block cluster; admm_stream_team.cuh.)
//
// What bounds it on an H100: per lane and iteration the two sweeps move
// ~104 floats a horizon row at (12, 4) (416 B: the backward reads vnew, g,
// znew, y and writes d; the forward reads g, y, d and the previous slacks
// and writes the slacks and duals) against ~1 k FMA a row, so in bytes
// alone a launch is memory-bound. But one thread a lane fills only B / 128
// blocks (8 of 132 SMs at B=1024) and each thread walks its rows in
// series, each row waiting on device-memory latency and on the row
// before's p or x: at small batches the launches are latency-bound. The
// box launches, and those of families and of consensus at fixed rho,
// therefore run on lane teams, their rows staged ahead
// (admm_stream_team.cuh; the box fixed-rho forward at N=512, B=4096:
// 0.3672-0.3699 against 3.5065-3.5435 ms a launch in turns with this
// file's one-thread kernel, chip_compare.py time, on an NVIDIA H100 80GB
// HBM3 at 700 W; PERF.md section 6); the launches with families under
// adaptive rho are still one thread a lane.
//
// C interface (loaded with ctypes): tinympc_stream_backward,
// tinympc_stream_forward and their team entries (box, families, consensus)
// launch on the given stream, never synchronise, and return the
// cudaError_t of the launch; tinympc_stream_team_cluster_occupancy tells
// the route whether the card holds a consensus group's cluster.
#include <type_traits>

#include "admm_adaptive.cuh"
#include "admm_consensus.cuh"
#include "admm_families.cuh"
#include "admm_stream_team.cuh"
#include "admm_sweep.cuh"

namespace tinympc {

// Consensus state of a streamed solve in device memory, lane-last, (nu, B)
// each: every lane's slack zc0, dual yc0 and standing offer u[0] + yc0 (the
// offer of its converging iteration, which stands for its group from then
// on; stored then only, since no running lane reads it). group = 0 without
// consensus.
struct StreamConsensus {
  int group;
  float rho_c;
  float* zc0;
  float* yc0;
  float* offer;
};

}  // namespace tinympc

namespace {

using tinympc::AdaptArgs;
using tinympc::AdaptiveRho;
using tinympc::ConsensusArgs;
using tinympc::FamilyArgs;
using tinympc::Families;
using tinympc::FixedRho;
using tinympc::Layout;
using tinympc::NegRefWindow;
using tinympc::NoConsensus;
using tinympc::Residuals;
using tinympc::StreamConsensus;
using tinympc::Tables;
using tinympc::TeamConsensus;
using tinympc::TeamConsensusArgs;
using tinympc::TeamFamilies;
using tinympc::TeamNoConsensus;
using tinympc::TeamNoFamilies;
using tinympc::TeamShape;

constexpr int kBlock = 128;
// At fixed rho at least 4 blocks an SM: at most 128 registers a thread,
// which the kernels fit without spilling (120 and 118 at (12, 4)). The
// adaptive instantiations take AdaptiveRho's minimum, as the resident
// kernel does (kMinBlocksOf in admm_fused.cu): the lane's rho state and the
// adaptation pass need more registers, and at the batches the streamed
// solve runs (up to 128 blocks at B=16384, on 132 SMs) no SM holds a second
// block anyway.
template <class Rho>
constexpr int kMinBlocksOf = Rho::kAdaptive ? Rho::kMinBlocks : 4;

// The consensus hooks of an instantiation: admm_consensus.cuh's under
// CONS, else the empty set.
template <int NX, int NU, bool CONS>
using ConsOf = std::conditional_t<CONS, tinympc::Consensus<NX, NU, kBlock>,
                                  NoConsensus>;

template <int NX, int NU, bool CONS>
__host__ __device__ typename ConsOf<NX, NU, CONS>::Args cons_args(
    const StreamConsensus& sc) {
  if constexpr (CONS)
    return ConsensusArgs{sc.group, sc.rho_c, nullptr, nullptr, nullptr,
                         nullptr};
  else
    return {};
}

// Shared memory of a launch, in floats, in this order: the small box tables
// (Layout's prefix, up to the reference), the family tables that do not grow
// with N, the consensus gains and lane columns (CONS), the adaptive tables
// (Rho; the forward launch's AdaptiveRho<NX, NU, false> leaves out dC1 and
// dC2, which only the backward sweep reads), and the terminal reference term
// with its sensitivity under adaptive rho (the backward launch only).
template <int NX, int NU, bool CONS, class Rho>
struct SharedLayout {
  int fam, cons, lanes, adapt, pnref, total;
  __host__ __device__ SharedLayout(const FamilyArgs& fa,
                                   const StreamConsensus& sc,
                                   const typename Rho::Args& ra, int N) {
    using Cons = ConsOf<NX, NU, CONS>;
    const auto ca = cons_args<NX, NU, CONS>(sc);
    fam = Layout(NX, NU, N).xref;
    cons = fam + Families<NX, NU>::static_floats(fa, NX, NU);
    lanes = cons + Cons::table_floats(ca, NX, NU);
    adapt = lanes + Cons::lane_floats(ca, NU);
    pnref = adapt + Rho::table_floats(ra, NX, NU);
    total = pnref + NX * (1 + Rho::kTerminalRows);
  }
};

// Copy the tables SharedLayout counts into shared memory: Layout's prefix,
// the static family tables, under CONS the step-0 gains Kinf0 and
// Quu0_inv, and under adaptive rho the adaptive tables; the last two follow
// every family table (the growing ones too) in the packed table
// (kernels/admm_fused.py:_table_layout), the adaptive ones first.
template <int NX, int NU, bool CONS, class Rho>
__device__ void load_tables(float* sm, const float* tables, const Layout& L,
                            const SharedLayout<NX, NU, CONS, Rho>& S,
                            const FamilyArgs& fa, int N) {
  for (int k = threadIdx.x; k < L.xref; k += blockDim.x) sm[k] = tables[k];
  for (int k = threadIdx.x; k < S.cons - S.fam; k += blockDim.x)
    sm[S.fam + k] = tables[L.total + k];
  const int after = L.total + Families<NX, NU>::table_floats(fa, NX, NU, N);
  if constexpr (Rho::kAdaptive) {
    for (int k = threadIdx.x; k < S.pnref - S.adapt; k += blockDim.x)
      sm[S.adapt + k] = tables[after + k];
  } else {
    for (int k = threadIdx.x; k < S.lanes - S.cons; k += blockDim.x)
      sm[S.cons + k] = tables[after + k];
  }
}

// Under CONS, this lane's slack and dual into its shared-memory columns.
template <int NX, int NU, bool CONS>
__device__ __forceinline__ void load_lane(const ConsOf<NX, NU, CONS>& cons,
                                          const StreamConsensus& sc,
                                          size_t sB, int b) {
  if constexpr (CONS) {
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const size_t o = static_cast<size_t>(k) * sB + b;
      cons.zc0(k) = sc.zc0[o];
      cons.yc0(k) = sc.yc0[o];
    }
  }
}

// The forward sweep's family hooks plus, on warm family or consensus
// solves, the x/u trajectories the carry hands over (admm_stream.py:
// 547-551): row i of x and u as the sweep forms them, for the lanes still
// running.
template <int NX, int NU>
struct TrackXU {
  const Families<NX, NU>& fam;
  float* x_out;   // (N, NX, B) or null
  float* u_out;   // (N-1, NU, B) or null
  size_t sB;
  int b;
  __device__ __forceinline__ void state_row(int i, const float* x) const {
    fam.state_row(i, x);
    if (x_out) {
#pragma unroll
      for (int k = 0; k < NX; ++k)
        x_out[(static_cast<size_t>(i) * NX + k) * sB + b] = x[k];
    }
  }
  __device__ __forceinline__ void input_row(int i, const float* u) const {
    fam.input_row(i, u);
    if (u_out) {
#pragma unroll
      for (int k = 0; k < NU; ++k)
        u_out[(static_cast<size_t>(i) * NU + k) * sB + b] = u[k];
    }
  }
};

// Backward launch: d of every running lane from its previous iterate;
// under CONS row 0 takes the consensus term and the Quu0_inv gain; under
// adaptive rho (Rho) the lane's rho comes from device memory, the family
// and box terms scale by it, and each product of a matrix the Taylor update
// moves gains its drho-scaled sensitivity product, as in the resident
// kernel (admm_stream.py:121-191, :203-210). The rho policy's arguments
// come last in both kernels: placed before N, B and rho they moved those
// parameters' offsets, and ptxas then gave the fixed-rho backward kernel 2
// to 6 more registers.
template <int NX, int NU, bool CONS, class Rho>
__global__ void __launch_bounds__(kBlock, kMinBlocksOf<Rho>)
    stream_backward_kernel(const float* __restrict__ tables,
                           const float* __restrict__ vprev,
                           const float* __restrict__ zprev,
                           const float* __restrict__ g,
                           const float* __restrict__ y,
                           float* __restrict__ d,
                           const unsigned char* __restrict__ done,
                           int* __restrict__ active, FamilyArgs fa,
                           StreamConsensus sc, int N, int B, float rho,
                           typename Rho::Args ra) {
  extern __shared__ float sm[];
  const Layout L(NX, NU, N);
  const SharedLayout<NX, NU, CONS, Rho> S(fa, sc, ra, N);
  load_tables<NX, NU, CONS, Rho>(sm, tables, L, S, fa, N);
  if (blockIdx.x == 0 && threadIdx.x == 0) *active = 0;
  __syncthreads();
  // Terminal reference term -Pinf^T Xref[N-1] (admm_stream.py:926), and
  // under adaptive rho its sensitivity -dPinf^T Xref[N-1] after it, summed
  // as the resident kernel sums them.
  float* pnref = sm + S.pnref;
  if (threadIdx.x < NX) {
    const int k = threadIdx.x;
    const float* xref_last = tables + L.xref + (N - 1) * NX;
    float acc = 0.f;
    for (int j = 0; j < NX; ++j)
      acc = fmaf(sm[L.pinft + k * NX + j], xref_last[j], acc);
    pnref[k] = -acc;
    Rho::prologue(ra, sm + S.adapt, xref_last, pnref + NX, k);
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || done[b]) return;   // no barrier follows
  const size_t sB = static_cast<size_t>(B);
  const Tables t(sm, tables, L);
  const Families<NX, NU> fam(fa, sm + S.fam, tables + L.total, N, sB, b);
  const ConsOf<NX, NU, CONS> cons(cons_args<NX, NU, CONS>(sc), sm + S.cons,
                                  sm + S.lanes);
  load_lane<NX, NU, CONS>(cons, sc, sB, b);
  Rho rh(ra, sm + S.adapt, pnref + NX, rho, sB, b);
  if constexpr (Rho::kAdaptive) rh.resume(false);
  rh.begin(0);   // the sweep reads drho only
  const NegRefWindow<NX> negxq{tables + L.xref, sm + L.qd};
  const NegRefWindow<NU> negur{tables + L.uref, sm + L.rd};
  float dvgN[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const size_t a = (static_cast<size_t>(N - 1) * NX + k) * sB + b;
    dvgN[k] = vprev[a] - g[a];
  }
  tinympc::backward_sweep<NX, NU>(t, negxq, negur, pnref, dvgN, vprev, zprev,
                                  g, y, d, N, sB, b, rh.rho(), fam, rh,
                                  cons);
}

// Forward launch of iteration `it`: the new slacks into vcur/zcur, the
// duals in place, the residuals and the bookkeeping. The dual residual
// compares against vprev/zprev, or, in the STALE variant, against the
// carried v/z (vstale/zstale; admm_stream.py:270-275). Under CONS row 0
// takes the Kinf0 gain, and the launch ends with the group exchange
// (admm_consensus.cuh), whose residual gates convergence. Under adaptive
// rho (Rho) the rollout gain telescopes (Kinf x + drho dKinf x), an
// adaptation iteration (every 5th, it > 0) keeps its rows in scratch and
// runs admm_adaptive.cuh's second pass over them -- the OSQP residuals, the
// guard, the clip -- and the new rho is committed before termination, whose
// dual residuals scale with it (admm_stream.py:400-472, :577-621); the
// lane's rho and virtual rho go back to device memory.
template <int NX, int NU, bool STALE, bool CONS, class Rho>
__global__ void __launch_bounds__(kBlock, kMinBlocksOf<Rho>)
    stream_forward_kernel(
        const float* __restrict__ tables, const float* __restrict__ x0,
        const float* __restrict__ vprev, const float* __restrict__ zprev,
        const float* __restrict__ vstale, const float* __restrict__ zstale,
        float* __restrict__ vcur, float* __restrict__ zcur,
        float* __restrict__ g, float* __restrict__ y,
        const float* __restrict__ d, int* __restrict__ iters,
        unsigned char* __restrict__ done, float* __restrict__ res,
        int* __restrict__ active, FamilyArgs fa, StreamConsensus sc,
        float* x_out, float* u_out, int it, int N, int B,
        int check_termination, float rho, float tol_pri, float tol_dua,
        typename Rho::Args ra) {
  extern __shared__ float sm[];
  const Layout L(NX, NU, N);
  const SharedLayout<NX, NU, CONS, Rho> S(fa, sc, ra, N);
  load_tables<NX, NU, CONS, Rho>(sm, tables, L, S, fa, N);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool run = b < B && !done[b];
  if constexpr (CONS) {
    // The exchange's barrier needs every thread of a block that holds a
    // running lane; a block whose lanes are all done returns at once.
    if (!__syncthreads_or(run)) return;
  } else {
    if (!run) return;   // no barrier follows
  }
  const size_t sB = static_cast<size_t>(B);
  const ConsOf<NX, NU, CONS> cons(cons_args<NX, NU, CONS>(sc), sm + S.cons,
                                  sm + S.lanes);
  const bool checking = ((it + 1) % check_termination) == 0;
  bool pass = false;   // the box residuals' check of this iteration passed
  float u0[NU];
  if (run) {
    const Tables t(sm, tables, L);
    const Families<NX, NU> fam(fa, sm + S.fam, tables + L.total, N, sB, b);
    const TrackXU<NX, NU> hooks{fam, x_out, u_out, sB, b};
    load_lane<NX, NU, CONS>(cons, sc, sB, b);
    Rho rh(ra, sm + S.adapt, nullptr, rho, sB, b);
    if constexpr (Rho::kAdaptive) rh.resume(true);
    rh.begin(it);
    float x0r[NX], dvgN[NX];
#pragma unroll
    for (int k = 0; k < NX; ++k) x0r[k] = x0[static_cast<size_t>(b) * NX + k];
    const Residuals r = tinympc::forward_sweep<NX, NU>(
        t, x0r, dvgN, vcur, zcur, STALE ? vstale : vprev,
        STALE ? zstale : zprev, g, y, d, N, sB, b, checking, u0, hooks, rh,
        cons);
    if constexpr (Rho::kAdaptive) {
      if (rh.adapting())
        rh.adapt(t, sm + L.qd, sm + L.rd, vcur, zcur, g, y, N);
      rh.suspend();
    }
    // Bookkeeping (admm_stream.py:576-641): iterations on every iteration,
    // residuals (dual rows scaled by the rho after adaptation) and
    // convergence on check iterations only.
    iters[b] = it + 1;
    if (checking) {
      const float r2 = r.dua_s * rh.rho(), r3 = r.dua_i * rh.rho();
      res[b] = r.pri_s;
      res[sB + b] = r.pri_i;
      res[2 * sB + b] = r2;
      res[3 * sB + b] = r3;
      pass = (r.pri_s < tol_pri) && (r.pri_i < tol_pri) && (r2 < tol_dua) &&
             (r3 < tol_dua);
      if constexpr (!CONS) {
        if (pass)
          done[b] = 1;
        else
          *active = 1;
      }
    }
    if constexpr (CONS) cons.offer(u0);
  }
  if constexpr (CONS) {
    // The exchange (admm_stream.py:553-570, the resident kernel's rule for
    // a converged lane): a lane that is done offers what it offered on its
    // converging iteration; a thread past the batch offers zero, which no
    // group reads (B is a multiple of G).
    if (!run) {
#pragma unroll
      for (int k = 0; k < NU; ++k)
        cons.offers(k)[threadIdx.x] =
            b < B ? sc.offer[static_cast<size_t>(k) * sB + b] : 0.f;
    }
    __syncthreads();
    if (run) {
      const float cres = cons.update(u0);
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        const size_t o = static_cast<size_t>(k) * sB + b;
        sc.zc0[o] = cons.zc0(k);
        sc.yc0[o] = cons.yc0(k);
      }
      if (checking && pass && cres < tol_pri) {
        // Only a done lane's offer is read again: store the one that
        // stands, that of its converging iteration.
        done[b] = 1;
#pragma unroll
        for (int k = 0; k < NU; ++k)
          sc.offer[static_cast<size_t>(k) * sB + b] =
              cons.offers(k)[threadIdx.x];
      } else if (checking) {
        *active = 1;
      }
    }
  }
}

// The family arguments: counts, then the working slack and dual of each
// family (vc gc zc yc vl gl zl yl vtv gtv ztv ytv; null for a family that
// is off). The streamed solve seeds them itself, so the carry pointers of
// FamilyArgs stay null. Sets *families when one is on.
bool family_args(const int* counts, void* const* fam, FamilyArgs* fa,
                 bool* families) {
  *fa = FamilyArgs{};
  fa->ncx = counts[0];
  fa->ncu = counts[1];
  fa->nlx = counts[2];
  fa->nlu = counts[3];
  fa->ntx = counts[4];
  fa->ntu = counts[5];
  float** work[12] = {&fa->vc, &fa->gc, &fa->zc,  &fa->yc,
                      &fa->vl, &fa->gl, &fa->zl,  &fa->yl,
                      &fa->vtv, &fa->gtv, &fa->ztv, &fa->ytv};
  for (int k = 0; k < 12; ++k) *work[k] = static_cast<float*>(fam[k]);
  *families = false;
  for (int f = 0; f < 6; ++f) {
    if (counts[f] < 0) return false;
    const bool on = counts[f] > 0;
    *families = *families || on;
    if (on && (!fam[2 * f] || !fam[2 * f + 1])) return false;
  }
  return true;
}

// The consensus arguments of a launch: group 0 (none) for a null `cons`;
// else a group size that is a power of two up to the block, divides B, and
// comes with the three lane arrays.
bool consensus_args(const StreamConsensus* cons, int B,
                    StreamConsensus* sc) {
  *sc = StreamConsensus{0, 0.f, nullptr, nullptr, nullptr};
  if (!cons) return true;
  const int G = cons->group;
  if (G < 1 || G > kBlock || (G & (G - 1)) || B % G || !cons->zc0 ||
      !cons->yc0 || !cons->offer)
    return false;
  *sc = *cons;
  return true;
}

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Pointers of a backward launch.
struct Backward {
  const float *tables, *vprev, *zprev, *g, *y;
  float* d;
  const unsigned char* done;
  int* active;
};

template <int NX, int NU, bool CONS, class Rho>
cudaError_t backward(const FamilyArgs& fa, const StreamConsensus& sc,
                     const typename Rho::Args& ra, const Backward& p, int N,
                     int B, float rho, cudaStream_t s) {
  const size_t smem =
      SharedLayout<NX, NU, CONS, Rho>(fa, sc, ra, N).total * sizeof(float);
  auto kernel = stream_backward_kernel<NX, NU, CONS, Rho>;
  const cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(B + kBlock - 1) / kBlock, kBlock, smem, s>>>(
      p.tables, p.vprev, p.zprev, p.g, p.y, p.d, p.done, p.active, fa, sc,
      N, B, rho, ra);
  return cudaGetLastError();
}

// The instantiation of a backward launch at (NX, NU): adaptive rho (with
// or without apply_c), consensus, or neither.
template <int NX, int NU>
int backward_at(const FamilyArgs& fa, const StreamConsensus& sc,
                const AdaptArgs* adapt, const Backward& p, int N, int B,
                float rho, cudaStream_t s) {
  if (adapt)
    return static_cast<int>(
        adapt->apply_c
            ? backward<NX, NU, false, AdaptiveRho<NX, NU, true>>(
                  fa, sc, *adapt, p, N, B, rho, s)
            : backward<NX, NU, false, AdaptiveRho<NX, NU, false>>(
                  fa, sc, *adapt, p, N, B, rho, s));
  return static_cast<int>(
      sc.group ? backward<NX, NU, true, FixedRho>(fa, sc, {}, p, N, B, rho, s)
               : backward<NX, NU, false, FixedRho>(fa, sc, {}, p, N, B, rho,
                                                   s));
}

// Pointers of a forward launch.
struct Forward {
  const float *tables, *x0, *vprev, *zprev, *vstale, *zstale;
  float *vcur, *zcur, *g, *y;
  const float* d;
  int* iters;
  unsigned char* done;
  float* res;
  int* active;
  float *x_out, *u_out;
};

template <int NX, int NU, bool STALE, bool CONS, class Rho>
cudaError_t forward(const FamilyArgs& fa, const StreamConsensus& sc,
                    const typename Rho::Args& ra, const Forward& p, int it,
                    int N, int B, int ct, float rho, float tol_pri,
                    float tol_dua, cudaStream_t s) {
  const size_t smem =
      SharedLayout<NX, NU, CONS, Rho>(fa, sc, ra, N).pnref * sizeof(float);
  auto kernel = stream_forward_kernel<NX, NU, STALE, CONS, Rho>;
  const cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(B + kBlock - 1) / kBlock, kBlock, smem, s>>>(
      p.tables, p.x0, p.vprev, p.zprev, p.vstale, p.zstale, p.vcur, p.zcur,
      p.g, p.y, p.d, p.iters, p.done, p.res, p.active, fa, sc, p.x_out,
      p.u_out, it, N, B, ct, rho, tol_pri, tol_dua, ra);
  return cudaGetLastError();
}

// The instantiation of a forward launch at (NX, NU): stale or not, with
// adaptive rho (AdaptiveRho<NX, NU, false> either way: apply_c moves only
// the backward sweep's products), consensus, or neither.
template <int NX, int NU, bool STALE>
int forward_at(const FamilyArgs& fa, const StreamConsensus& sc,
               const AdaptArgs* adapt, const Forward& p, int it, int N, int B,
               int ct, float rho, float tol_pri, float tol_dua,
               cudaStream_t s) {
  if (adapt)
    return static_cast<int>(
        forward<NX, NU, STALE, false, AdaptiveRho<NX, NU, false>>(
            fa, sc, *adapt, p, it, N, B, ct, rho, tol_pri, tol_dua, s));
  return static_cast<int>(
      sc.group ? forward<NX, NU, STALE, true, FixedRho>(
                     fa, sc, {}, p, it, N, B, ct, rho, tol_pri, tol_dua, s)
               : forward<NX, NU, STALE, false, FixedRho>(
                     fa, sc, {}, p, it, N, B, ct, rho, tol_pri, tol_dua, s));
}

template <bool STALE>
int forward_dispatch(int nx, int nu, const FamilyArgs& fa,
                     const StreamConsensus& sc, const AdaptArgs* adapt,
                     const Forward& p, int it, int N, int B, int ct,
                     float rho, float tol_pri, float tol_dua,
                     cudaStream_t s) {
  if (nx == 12 && nu == 4)   // the quadrotor
    return forward_at<12, 4, STALE>(fa, sc, adapt, p, it, N, B, ct, rho,
                                    tol_pri, tol_dua, s);
  if (nx == 6 && nu == 3)    // the rocket
    return forward_at<6, 3, STALE>(fa, sc, adapt, p, it, N, B, ct, rho,
                                   tol_pri, tol_dua, s);
  // Cartpole and the degenerate pairs: these one-thread kernels only.
  if (nx == 4 && nu == 1)    // cartpole
    return forward_at<4, 1, STALE>(fa, sc, adapt, p, it, N, B, ct, rho,
                                   tol_pri, tol_dua, s);
  if (nx == 2 && nu == 2)
    return forward_at<2, 2, STALE>(fa, sc, adapt, p, it, N, B, ct, rho,
                                   tol_pri, tol_dua, s);
  if (nx == 2 && nu == 1)
    return forward_at<2, 1, STALE>(fa, sc, adapt, p, it, N, B, ct, rho,
                                   tol_pri, tol_dua, s);
  if (nx == 3 && nu == 3)
    return forward_at<3, 3, STALE>(fa, sc, adapt, p, it, N, B, ct, rho,
                                   tol_pri, tol_dua, s);
  if (nx == 1 && nu == 1)
    return forward_at<1, 1, STALE>(fa, sc, adapt, p, it, N, B, ct, rho,
                                   tol_pri, tol_dua, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches on lane teams (admm_stream_team.cuh) at (NX, NU): one block
// a team of TeamShape's lanes, at fixed rho (FixedRho) or adaptive rho
// (AdaptiveRho; the forward's with apply_c off, which moves only the
// backward sweep). The forward's p.vprev / p.zprev hold the slacks the dual
// residual compares against (the carried v/z in the stale launch).
template <int NX, int NU, class Rho>
cudaError_t backward_team(const typename Rho::Args& ra, const Backward& p,
                          int N, int B, float rho, cudaStream_t s) {
  using S = TeamShape<NX, NU>;
  tinympc::stream_backward_team_kernel<NX, NU, TeamNoFamilies, Rho,
                                       TeamNoConsensus>
      <<<(B + S::kLanes - 1) / S::kLanes, S::kThreads, 0, s>>>(
          p.tables, p.vprev, p.zprev, p.g, p.y, p.d, p.done, p.active, N, B,
          rho, ra, TeamNoFamilies::Args{}, TeamNoConsensus::Args{});
  return cudaGetLastError();
}

template <int NX, int NU>
cudaError_t backward_team_at(const AdaptArgs* adapt, const Backward& p,
                             int N, int B, float rho, cudaStream_t s) {
  if (!adapt) return backward_team<NX, NU, FixedRho>({}, p, N, B, rho, s);
  return adapt->apply_c
             ? backward_team<NX, NU, AdaptiveRho<NX, NU, true>>(
                   *adapt, p, N, B, rho, s)
             : backward_team<NX, NU, AdaptiveRho<NX, NU, false>>(
                   *adapt, p, N, B, rho, s);
}

template <int NX, int NU, class Rho>
cudaError_t forward_team(const typename Rho::Args& ra, const Forward& p,
                         int it, int N, int B, int ct, float rho,
                         float tol_pri, float tol_dua, cudaStream_t s) {
  using S = TeamShape<NX, NU>;
  tinympc::stream_forward_team_kernel<NX, NU, TeamNoFamilies, Rho,
                                      TeamNoConsensus>
      <<<(B + S::kLanes - 1) / S::kLanes, S::kThreads, 0, s>>>(
          p.tables, p.x0, p.vprev, p.zprev, p.vcur, p.zcur, p.g, p.y, p.d,
          p.iters, p.done, p.res, p.active, it, N, B, ct, rho, tol_pri,
          tol_dua, ra, TeamNoFamilies::Args{}, TeamNoConsensus::Args{});
  return cudaGetLastError();
}

template <int NX, int NU>
cudaError_t forward_team_at(const AdaptArgs* adapt, const Forward& p, int it,
                            int N, int B, int ct, float rho, float tol_pri,
                            float tol_dua, cudaStream_t s) {
  if (!adapt)
    return forward_team<NX, NU, FixedRho>({}, p, it, N, B, ct, rho, tol_pri,
                                          tol_dua, s);
  return forward_team<NX, NU, AdaptiveRho<NX, NU, false>>(
      *adapt, p, it, N, B, ct, rho, tol_pri, tol_dua, s);
}

// The opt-ins a forward team launch of `cluster` blocks needs: dynamic
// shared memory past 48 KB with the static arrays, a non-portable cluster
// size past 8 blocks.
template <class Kernel>
cudaError_t prepare_team(Kernel kernel, size_t smem, int cluster) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (attr.sharedSizeBytes + smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  if (cluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// The launches with families at fixed rho on lane teams (TeamFamilies):
// the forward's cone and static hyperplane tables in dynamic shared memory,
// past 48 KB with the static arrays only after the opt-in.
template <int NX, int NU>
cudaError_t backward_team_families(const FamilyArgs& fa, const Backward& p,
                                   int N, int B, float rho,
                                   cudaStream_t s) {
  using S = TeamShape<NX, NU>;
  tinympc::stream_backward_team_kernel<NX, NU, TeamFamilies<NX, NU>,
                                       FixedRho, TeamNoConsensus>
      <<<(B + S::kLanes - 1) / S::kLanes, S::kThreads, 0, s>>>(
          p.tables, p.vprev, p.zprev, p.g, p.y, p.d, p.done, p.active, N, B,
          rho, FixedRho::Args{}, fa, TeamNoConsensus::Args{});
  return cudaGetLastError();
}

// fa carries the tracked x/u of a warm solve in x_out / u_out.
template <int NX, int NU>
cudaError_t forward_team_families(const FamilyArgs& fa, const Forward& p,
                                  int it, int N, int B, int ct, float rho,
                                  float tol_pri, float tol_dua,
                                  cudaStream_t s) {
  using S = TeamShape<NX, NU>;
  auto kernel =
      tinympc::stream_forward_team_kernel<NX, NU, TeamFamilies<NX, NU>,
                                          FixedRho, TeamNoConsensus>;
  const size_t smem =
      tinympc::Families<NX, NU>::static_floats(fa, NX, NU) * sizeof(float);
  const cudaError_t e = prepare_team(kernel, smem, 1);
  if (e != cudaSuccess) return e;
  kernel<<<(B + S::kLanes - 1) / S::kLanes, S::kThreads, smem, s>>>(
      p.tables, p.x0, p.vprev, p.zprev, p.vcur, p.zcur, p.g, p.y, p.d,
      p.iters, p.done, p.res, p.active, it, N, B, ct, rho, tol_pri, tol_dua,
      FixedRho::Args{}, fa, TeamNoConsensus::Args{});
  return cudaGetLastError();
}

// The launches with consensus at fixed rho on lane teams (TeamConsensus),
// with families (TeamFamilies) or without (TeamNoFamilies, whose
// instantiation needs fewer registers).
template <int NX, int NU, bool FAM>
using TeamFamOf =
    std::conditional_t<FAM, TeamFamilies<NX, NU>, TeamNoFamilies>;

template <int NX, int NU, bool FAM>
typename TeamFamOf<NX, NU, FAM>::Args team_family_args(const FamilyArgs& fa) {
  if constexpr (FAM)
    return fa;
  else
    return {};
}

// The consensus arguments of a team launch at (NX, NU): the group of sc, a
// group of G <= kLanes lanes in one block, of G > kLanes a cluster of
// G / kLanes blocks (at most kTeamMaxCluster), the step-0 gains after the
// family tables of the packed table, and the tracked x/u. False for a
// cluster past kTeamMaxCluster.
template <int NX, int NU>
bool team_consensus_args(const StreamConsensus& sc, const FamilyArgs& fa,
                         const float* tables, int N, float* x_out,
                         float* u_out, TeamConsensusArgs* ca) {
  constexpr int P = TeamShape<NX, NU>::kLanes;
  const int G = sc.group;
  const int cluster = G <= P ? 1 : G / P;
  if (cluster > tinympc::kTeamMaxCluster) return false;
  *ca = TeamConsensusArgs{
      G, cluster, sc.rho_c,
      tables + Layout(NX, NU, N).total +
          Families<NX, NU>::table_floats(fa, NX, NU, N),
      sc.zc0, sc.yc0, sc.offer, x_out, u_out};
  return true;
}

template <int NX, int NU, bool FAM>
cudaError_t backward_team_consensus(const FamilyArgs& fa,
                                    const TeamConsensusArgs& ca,
                                    const Backward& p, int N, int B,
                                    float rho, cudaStream_t s) {
  using S = TeamShape<NX, NU>;
  using Cons = TeamConsensus<NX, NU>;
  tinympc::stream_backward_team_kernel<NX, NU, TeamFamOf<NX, NU, FAM>,
                                       FixedRho, Cons>
      <<<(B + S::kLanes - 1) / S::kLanes, S::kThreads,
         Cons::kBackwardGains * sizeof(float), s>>>(
          p.tables, p.vprev, p.zprev, p.g, p.y, p.d, p.done, p.active, N, B,
          rho, FixedRho::Args{}, team_family_args<NX, NU, FAM>(fa), ca);
  return cudaGetLastError();
}

// The forward consensus kernel at (NX, NU), and the bytes of its dynamic
// shared memory: Kinf0, then the static family tables.
template <int NX, int NU, bool FAM>
auto forward_team_consensus_kernel() {
  return tinympc::stream_forward_team_kernel<NX, NU, TeamFamOf<NX, NU, FAM>,
                                             FixedRho, TeamConsensus<NX, NU>>;
}

template <int NX, int NU, bool FAM>
size_t forward_team_consensus_smem(const FamilyArgs& fa) {
  return (TeamConsensus<NX, NU>::kForwardGains +
          (FAM ? Families<NX, NU>::static_floats(fa, NX, NU) : 0)) *
         sizeof(float);
}

// A launch configuration of the forward consensus kernel: a cluster
// dimension of `cluster` blocks.
struct ClusterConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterConfig(int blocks, int threads, size_t smem, int cluster,
                cudaStream_t s) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int NX, int NU, bool FAM>
cudaError_t forward_team_consensus(const FamilyArgs& fa,
                                   const TeamConsensusArgs& ca,
                                   const Forward& p, int it, int N, int B,
                                   int ct, float rho, float tol_pri,
                                   float tol_dua, cudaStream_t s) {
  using S = TeamShape<NX, NU>;
  auto kernel = forward_team_consensus_kernel<NX, NU, FAM>();
  const size_t smem = forward_team_consensus_smem<NX, NU, FAM>(fa);
  const cudaError_t e = prepare_team(kernel, smem, ca.cluster);
  if (e != cudaSuccess) return e;
  const int blocks = (B + S::kLanes - 1) / S::kLanes;
  const auto fp = team_family_args<NX, NU, FAM>(fa);
  if (ca.cluster > 1) {
    ClusterConfig c(blocks, S::kThreads, smem, ca.cluster, s);
    return cudaLaunchKernelEx(&c.cfg, kernel, p.tables, p.x0, p.vprev,
                              p.zprev, p.vcur, p.zcur, p.g, p.y, p.d,
                              p.iters, p.done, p.res, p.active, it, N, B, ct,
                              rho, tol_pri, tol_dua, FixedRho::Args{}, fp,
                              ca);
  }
  kernel<<<blocks, S::kThreads, smem, s>>>(
      p.tables, p.x0, p.vprev, p.zprev, p.vcur, p.zcur, p.g, p.y, p.d,
      p.iters, p.done, p.res, p.active, it, N, B, ct, rho, tol_pri, tol_dua,
      FixedRho::Args{}, fp, ca);
  return cudaGetLastError();
}

// How many clusters of `cluster` blocks of the forward consensus launch at
// (NX, NU) the card holds at once (cudaOccupancyMaxActiveClusters), or a
// negative cudaError_t.
template <int NX, int NU, bool FAM>
int team_cluster_occupancy(const FamilyArgs& fa, int cluster) {
  using S = TeamShape<NX, NU>;
  auto kernel = forward_team_consensus_kernel<NX, NU, FAM>();
  const size_t smem = forward_team_consensus_smem<NX, NU, FAM>(fa);
  cudaError_t e = prepare_team(kernel, smem, cluster);
  if (e != cudaSuccess) return -static_cast<int>(e);
  ClusterConfig c(cluster * 64, S::kThreads, smem, cluster, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &c.cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

extern "C" int tinympc_stream_block() { return kBlock; }

// The lanes a block of the team launches holds at (nx, nu); 0 for a pair
// this file does not instantiate.
extern "C" int tinympc_stream_team_lanes(int nx, int nu) {
  if (nx == 12 && nu == 4) return TeamShape<12, 4>::kLanes;
  if (nx == 6 && nu == 3) return TeamShape<6, 3>::kLanes;
  return 0;
}

// The backward launch. counts: the six family sizes beyond the box (state
// cones, input cones, state and input hyperplanes, state and input
// time-varying hyperplanes; all zero for box constraints alone); fam: the
// 12 working slack and dual arrays (null for a family that is off).
// vprev (N, nx, B), zprev (N-1, nu, B): the previous slacks; g, y the
// duals; d (N-1, nu, B) out; done (B,) the lanes that have converged;
// active one int, zeroed. cons: null without consensus; else the group
// size G (a power of two up to the block size, dividing B), rho_c and the
// lanes' zc0, yc0 and offer arrays, (nu, B) each, with the tables' step-0
// gains after the family tables. adapt: null at fixed rho; else the
// adaptive-rho arguments (admm_adaptive.cuh), of which the backward launch
// reads apply_c and rho_in, each lane's rho (B,), with the tables' adaptive
// tables after the family tables; not with cons. rho is the problem's rho.
// Returns 0 or a cudaError_t; cudaErrorInvalidValue for an (nx, nu) pair
// this file does not instantiate, a bad size or a missing array.
extern "C" int tinympc_stream_backward(int nx, int nu, int N, int B,
                                       const int* counts, float rho,
                                       const void* tables, const void* vprev,
                                       const void* zprev, const void* g,
                                       const void* y, void* d,
                                       const void* done, void* active,
                                       void* const* fam,
                                       const StreamConsensus* cons,
                                       const AdaptArgs* adapt, void* stream) {
  FamilyArgs fa;
  StreamConsensus sc;
  bool families;
  if (N < 2 || B < 1 || !family_args(counts, fam, &fa, &families) ||
      !consensus_args(cons, B, &sc) || !tables || !vprev || !zprev || !g ||
      !y || !d || !done || !active ||
      (adapt && (sc.group || !adapt->rho_in)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Backward p = {static_cast<const float*>(tables),
                      static_cast<const float*>(vprev),
                      static_cast<const float*>(zprev),
                      static_cast<const float*>(g),
                      static_cast<const float*>(y),
                      static_cast<float*>(d),
                      static_cast<const unsigned char*>(done),
                      static_cast<int*>(active)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (nx == 12 && nu == 4)   // the quadrotor
    return backward_at<12, 4>(fa, sc, adapt, p, N, B, rho, s);
  if (nx == 6 && nu == 3)    // the rocket
    return backward_at<6, 3>(fa, sc, adapt, p, N, B, rho, s);
  // Cartpole and the degenerate pairs: these one-thread kernels only.
  if (nx == 4 && nu == 1)    // cartpole
    return backward_at<4, 1>(fa, sc, adapt, p, N, B, rho, s);
  if (nx == 2 && nu == 2)
    return backward_at<2, 2>(fa, sc, adapt, p, N, B, rho, s);
  if (nx == 2 && nu == 1)
    return backward_at<2, 1>(fa, sc, adapt, p, N, B, rho, s);
  if (nx == 3 && nu == 3)
    return backward_at<3, 3>(fa, sc, adapt, p, N, B, rho, s);
  if (nx == 1 && nu == 1)
    return backward_at<1, 1>(fa, sc, adapt, p, N, B, rho, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward launch of iteration `it`, STALE when `stale` is set.
// prev: vprev, zprev (the previous slacks), then vstale, zstale (the
// carried v/z; read by the STALE variant only, null otherwise). vcur
// (N, nx, B) and zcur (N-1, nu, B) out; g, y updated; d from the backward
// launch; iters (B,) int, done (B,) bytes and res (4, B) updated for the
// running lanes; active set on check iterations while a lane runs; fam as
// for the backward launch; x_out/u_out the tracked trajectories (both or
// neither; only with families or consensus); cons as for the backward
// launch, its zc0 and yc0 updated for the running lanes and the offer for
// the lanes that converge in this launch. adapt: null at fixed rho; else
// the adaptive-rho arguments with rho_in and rho_out the lanes' rho (B,)
// and rho_v their virtual rho (B,), both updated for the running lanes,
// and the scratch xs (N, nx, B), us (N-1, nu, B), axd (N-1, nx, B); not
// with cons. Returns 0 or a cudaError_t.
extern "C" int tinympc_stream_forward(
    int stale, int nx, int nu, int N, int B, int it, int check_termination,
    const int* counts, float rho, float tol_pri, float tol_dua,
    const void* tables, const void* x0, const void* const* prev, void* vcur,
    void* zcur, void* g, void* y, const void* d, void* iters, void* done,
    void* res, void* active, void* const* fam, void* x_out, void* u_out,
    const StreamConsensus* cons, const AdaptArgs* adapt, void* stream) {
  FamilyArgs fa;
  StreamConsensus sc;
  bool families;
  if (N < 2 || B < 1 || it < 0 || check_termination < 1 ||
      !family_args(counts, fam, &fa, &families) ||
      !consensus_args(cons, B, &sc) || !tables || !x0 || !prev[0] ||
      !prev[1] || (stale && (!prev[2] || !prev[3])) || !vcur || !zcur ||
      !g || !y || !d || !iters || !done || !res || !active ||
      (!x_out != !u_out) || (x_out && !families && !sc.group) ||
      (adapt && (sc.group || !adapt->rho_in || !adapt->rho_out ||
                 !adapt->rho_v || !adapt->xs || !adapt->us || !adapt->axd)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Forward p = {static_cast<const float*>(tables),
                     static_cast<const float*>(x0),
                     static_cast<const float*>(prev[0]),
                     static_cast<const float*>(prev[1]),
                     static_cast<const float*>(prev[2]),
                     static_cast<const float*>(prev[3]),
                     static_cast<float*>(vcur),
                     static_cast<float*>(zcur),
                     static_cast<float*>(g),
                     static_cast<float*>(y),
                     static_cast<const float*>(d),
                     static_cast<int*>(iters),
                     static_cast<unsigned char*>(done),
                     static_cast<float*>(res),
                     static_cast<int*>(active),
                     static_cast<float*>(x_out),
                     static_cast<float*>(u_out)};
  const auto s = static_cast<cudaStream_t>(stream);
  const int ct = check_termination;
  return stale ? forward_dispatch<true>(nx, nu, fa, sc, adapt, p, it, N, B,
                                        ct, rho, tol_pri, tol_dua, s)
               : forward_dispatch<false>(nx, nu, fa, sc, adapt, p, it, N, B,
                                         ct, rho, tol_pri, tol_dua, s);
}

// The backward launch of a box problem (no family, no consensus) on lane
// teams, at fixed rho (adapt null) or adaptive rho (apply_c and rho_in read;
// the adaptive tables after the box tables); the other arguments as
// tinympc_stream_backward takes them. Returns 0 or a cudaError_t;
// cudaErrorInvalidValue for an (nx, nu) pair this file does not
// instantiate, a bad size or a missing array.
extern "C" int tinympc_stream_backward_team(
    int nx, int nu, int N, int B, float rho, const void* tables,
    const void* vprev, const void* zprev, const void* g, const void* y,
    void* d, const void* done, void* active, const AdaptArgs* adapt,
    void* stream) {
  if (N < 2 || B < 1 || !tables || !vprev || !zprev || !g || !y || !d ||
      !done || !active || (adapt && !adapt->rho_in))
    return static_cast<int>(cudaErrorInvalidValue);
  const Backward p = {static_cast<const float*>(tables),
                      static_cast<const float*>(vprev),
                      static_cast<const float*>(zprev),
                      static_cast<const float*>(g),
                      static_cast<const float*>(y),
                      static_cast<float*>(d),
                      static_cast<const unsigned char*>(done),
                      static_cast<int*>(active)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (nx == 12 && nu == 4)   // the quadrotor
    return static_cast<int>(backward_team_at<12, 4>(adapt, p, N, B, rho, s));
  if (nx == 6 && nu == 3)    // the rocket
    return static_cast<int>(backward_team_at<6, 3>(adapt, p, N, B, rho, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward launch of iteration `it` of a box problem (no family, no
// consensus) on lane teams. vd, zd: the slacks the dual residual compares
// against -- the previous iterate's vprev (N, nx, B) / zprev (N-1, nu, B),
// or in the stale launch (the first iteration of a warm solve) the carried
// v/z. adapt: null at fixed rho; else the adaptive-rho arguments, of which
// this launch reads the settings, rho_in, rho_out and rho_v (the lanes' rho
// and virtual rho, (B,) each, updated for the running lanes) and not the
// scratch (its adaptation needs none); the adaptive tables after the box
// tables. The other arguments as tinympc_stream_forward takes them. Returns
// 0 or a cudaError_t; cudaErrorInvalidValue for an (nx, nu) pair this file
// does not instantiate, a bad size or a missing array.
extern "C" int tinympc_stream_forward_team(
    int nx, int nu, int N, int B, int it, int check_termination, float rho,
    float tol_pri, float tol_dua, const void* tables, const void* x0,
    const void* vd, const void* zd, void* vcur, void* zcur, void* g,
    void* y, const void* d, void* iters, void* done, void* res,
    void* active, const AdaptArgs* adapt, void* stream) {
  if (N < 2 || B < 1 || it < 0 || check_termination < 1 || !tables || !x0 ||
      !vd || !zd || !vcur || !zcur || !g || !y || !d || !iters || !done ||
      !res || !active ||
      (adapt && (!adapt->rho_in || !adapt->rho_out || !adapt->rho_v)))
    return static_cast<int>(cudaErrorInvalidValue);
  Forward p = {};
  p.tables = static_cast<const float*>(tables);
  p.x0 = static_cast<const float*>(x0);
  p.vprev = static_cast<const float*>(vd);
  p.zprev = static_cast<const float*>(zd);
  p.vcur = static_cast<float*>(vcur);
  p.zcur = static_cast<float*>(zcur);
  p.g = static_cast<float*>(g);
  p.y = static_cast<float*>(y);
  p.d = static_cast<const float*>(d);
  p.iters = static_cast<int*>(iters);
  p.done = static_cast<unsigned char*>(done);
  p.res = static_cast<float*>(res);
  p.active = static_cast<int*>(active);
  const auto s = static_cast<cudaStream_t>(stream);
  const int ct = check_termination;
  if (nx == 12 && nu == 4)   // the quadrotor
    return static_cast<int>(forward_team_at<12, 4>(
        adapt, p, it, N, B, ct, rho, tol_pri, tol_dua, s));
  if (nx == 6 && nu == 3)    // the rocket
    return static_cast<int>(forward_team_at<6, 3>(
        adapt, p, it, N, B, ct, rho, tol_pri, tol_dua, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward launch of a problem with families at fixed rho (no
// consensus) on lane teams: counts and fam as tinympc_stream_backward takes
// them (a box problem, all counts zero, runs too), the other arguments as
// tinympc_stream_backward_team takes them. Returns 0 or a cudaError_t;
// cudaErrorInvalidValue for an (nx, nu) pair this file does not
// instantiate, a bad size or a missing array.
extern "C" int tinympc_stream_backward_team_families(
    int nx, int nu, int N, int B, const int* counts, float rho,
    const void* tables, const void* vprev, const void* zprev, const void* g,
    const void* y, void* d, const void* done, void* active, void* const* fam,
    void* stream) {
  FamilyArgs fa;
  bool families;
  if (N < 2 || B < 1 || !family_args(counts, fam, &fa, &families) ||
      !tables || !vprev || !zprev || !g || !y || !d || !done || !active)
    return static_cast<int>(cudaErrorInvalidValue);
  const Backward p = {static_cast<const float*>(tables),
                      static_cast<const float*>(vprev),
                      static_cast<const float*>(zprev),
                      static_cast<const float*>(g),
                      static_cast<const float*>(y),
                      static_cast<float*>(d),
                      static_cast<const unsigned char*>(done),
                      static_cast<int*>(active)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (nx == 12 && nu == 4)   // the quadrotor
    return static_cast<int>(
        backward_team_families<12, 4>(fa, p, N, B, rho, s));
  if (nx == 6 && nu == 3)    // the rocket
    return static_cast<int>(
        backward_team_families<6, 3>(fa, p, N, B, rho, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward launch of iteration `it` of a problem with families at fixed
// rho (no consensus) on lane teams: vd, zd the slacks the dual residual
// compares against (the carried v/z in the stale launch); counts, fam and
// x_out / u_out (the tracked trajectories of a warm solve, both or
// neither, only with a family on) as tinympc_stream_forward takes them;
// the other arguments as tinympc_stream_forward_team takes them. Returns 0
// or a cudaError_t; cudaErrorInvalidValue for an (nx, nu) pair this file
// does not instantiate, a bad size or a missing array.
extern "C" int tinympc_stream_forward_team_families(
    int nx, int nu, int N, int B, int it, int check_termination,
    const int* counts, float rho, float tol_pri, float tol_dua,
    const void* tables, const void* x0, const void* vd, const void* zd,
    void* vcur, void* zcur, void* g, void* y, const void* d, void* iters,
    void* done, void* res, void* active, void* const* fam, void* x_out,
    void* u_out, void* stream) {
  FamilyArgs fa;
  bool families;
  if (N < 2 || B < 1 || it < 0 || check_termination < 1 ||
      !family_args(counts, fam, &fa, &families) || !tables || !x0 || !vd ||
      !zd || !vcur || !zcur || !g || !y || !d || !iters || !done || !res ||
      !active || (!x_out != !u_out) || (x_out && !families))
    return static_cast<int>(cudaErrorInvalidValue);
  Forward p = {};
  p.tables = static_cast<const float*>(tables);
  p.x0 = static_cast<const float*>(x0);
  p.vprev = static_cast<const float*>(vd);
  p.zprev = static_cast<const float*>(zd);
  p.vcur = static_cast<float*>(vcur);
  p.zcur = static_cast<float*>(zcur);
  p.g = static_cast<float*>(g);
  p.y = static_cast<float*>(y);
  p.d = static_cast<const float*>(d);
  p.iters = static_cast<int*>(iters);
  p.done = static_cast<unsigned char*>(done);
  p.res = static_cast<float*>(res);
  p.active = static_cast<int*>(active);
  fa.x_out = static_cast<float*>(x_out);
  fa.u_out = static_cast<float*>(u_out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int ct = check_termination;
  if (nx == 12 && nu == 4)   // the quadrotor
    return static_cast<int>(forward_team_families<12, 4>(
        fa, p, it, N, B, ct, rho, tol_pri, tol_dua, s));
  if (nx == 6 && nu == 3)    // the rocket
    return static_cast<int>(forward_team_families<6, 3>(
        fa, p, it, N, B, ct, rho, tol_pri, tol_dua, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks a consensus group's thread-block cluster may span on the team
// launches.
extern "C" int tinympc_stream_team_max_cluster() {
  return tinympc::kTeamMaxCluster;
}

// How many clusters of `cluster` blocks of the forward consensus launch on
// lane teams the card holds at once (cudaOccupancyMaxActiveClusters; 0
// where it cannot form one), at (nx, nu) with the six family counts of
// `counts` (as tinympc_stream_backward takes them), or a negative
// cudaError_t (cudaErrorInvalidValue for an (nx, nu) pair this file does not
// instantiate or a bad count).
extern "C" int tinympc_stream_team_cluster_occupancy(int nx, int nu,
                                                     const int* counts,
                                                     int cluster) {
  FamilyArgs fa = {};
  int* n[6] = {&fa.ncx, &fa.ncu, &fa.nlx, &fa.nlu, &fa.ntx, &fa.ntu};
  bool families = false;
  for (int f = 0; f < 6; ++f) {
    if (counts[f] < 0) return -static_cast<int>(cudaErrorInvalidValue);
    *n[f] = counts[f];
    families = families || counts[f] > 0;
  }
  if (cluster < 1 || cluster > tinympc::kTeamMaxCluster)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (nx == 12 && nu == 4)   // the quadrotor
    return families ? team_cluster_occupancy<12, 4, true>(fa, cluster)
                    : team_cluster_occupancy<12, 4, false>(fa, cluster);
  if (nx == 6 && nu == 3)    // the rocket
    return families ? team_cluster_occupancy<6, 3, true>(fa, cluster)
                    : team_cluster_occupancy<6, 3, false>(fa, cluster);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// The backward launch of a consensus problem at fixed rho on lane teams, box
// constraints alone or with families: counts and fam as
// tinympc_stream_backward takes them, cons the group (a power of two up to
// tinympc_stream_block(), dividing B) with rho_c and the lanes' zc0 / yc0
// (read) and offer arrays, (nu, B) each, the tables' step-0 gains after the
// family tables; the other arguments as tinympc_stream_backward_team takes
// them. Returns 0 or a cudaError_t; cudaErrorInvalidValue for an (nx, nu)
// pair this file does not instantiate, a bad size, a missing array, or a
// group whose cluster would pass tinympc_stream_team_max_cluster() blocks.
extern "C" int tinympc_stream_backward_team_consensus(
    int nx, int nu, int N, int B, const int* counts, float rho,
    const void* tables, const void* vprev, const void* zprev, const void* g,
    const void* y, void* d, const void* done, void* active, void* const* fam,
    const StreamConsensus* cons, void* stream) {
  FamilyArgs fa;
  StreamConsensus sc;
  TeamConsensusArgs ca;
  bool families;
  const auto* tab = static_cast<const float*>(tables);
  if (N < 2 || B < 1 || !cons || !family_args(counts, fam, &fa, &families) ||
      !consensus_args(cons, B, &sc) || !tables || !vprev || !zprev || !g ||
      !y || !d || !done || !active)
    return static_cast<int>(cudaErrorInvalidValue);
  const Backward p = {tab,
                      static_cast<const float*>(vprev),
                      static_cast<const float*>(zprev),
                      static_cast<const float*>(g),
                      static_cast<const float*>(y),
                      static_cast<float*>(d),
                      static_cast<const unsigned char*>(done),
                      static_cast<int*>(active)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (nx == 12 && nu == 4) {   // the quadrotor
    if (!team_consensus_args<12, 4>(sc, fa, tab, N, nullptr, nullptr, &ca))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        families ? backward_team_consensus<12, 4, true>(fa, ca, p, N, B, rho, s)
                 : backward_team_consensus<12, 4, false>(fa, ca, p, N, B, rho,
                                                         s));
  }
  if (nx == 6 && nu == 3) {    // the rocket
    if (!team_consensus_args<6, 3>(sc, fa, tab, N, nullptr, nullptr, &ca))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        families ? backward_team_consensus<6, 3, true>(fa, ca, p, N, B, rho, s)
                 : backward_team_consensus<6, 3, false>(fa, ca, p, N, B, rho,
                                                        s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward launch of iteration `it` of a consensus problem at fixed rho
// on lane teams, box constraints alone or with families: vd, zd the slacks
// the dual residual compares against (the carried v/z in the stale launch);
// counts and fam as tinympc_stream_forward takes them; x_out / u_out the
// tracked trajectories of a warm solve (both or neither); cons as
// tinympc_stream_backward_team_consensus takes it, its zc0 and yc0 updated
// for the running lanes and the offer for the lanes that converge in this
// launch. A group of G lanes lies in one block (G <= the block's lanes,
// tinympc_stream_team_lanes) or is a thread-block cluster of G / lanes
// blocks. The other arguments as tinympc_stream_forward_team takes them.
// Returns 0 or a cudaError_t, as the backward launch.
extern "C" int tinympc_stream_forward_team_consensus(
    int nx, int nu, int N, int B, int it, int check_termination,
    const int* counts, float rho, float tol_pri, float tol_dua,
    const void* tables, const void* x0, const void* vd, const void* zd,
    void* vcur, void* zcur, void* g, void* y, const void* d, void* iters,
    void* done, void* res, void* active, void* const* fam, void* x_out,
    void* u_out, const StreamConsensus* cons, void* stream) {
  FamilyArgs fa;
  StreamConsensus sc;
  TeamConsensusArgs ca;
  bool families;
  const auto* tab = static_cast<const float*>(tables);
  if (N < 2 || B < 1 || it < 0 || check_termination < 1 || !cons ||
      !family_args(counts, fam, &fa, &families) ||
      !consensus_args(cons, B, &sc) || !tables || !x0 || !vd || !zd ||
      !vcur || !zcur || !g || !y || !d || !iters || !done || !res ||
      !active || (!x_out != !u_out))
    return static_cast<int>(cudaErrorInvalidValue);
  Forward p = {};
  p.tables = tab;
  p.x0 = static_cast<const float*>(x0);
  p.vprev = static_cast<const float*>(vd);
  p.zprev = static_cast<const float*>(zd);
  p.vcur = static_cast<float*>(vcur);
  p.zcur = static_cast<float*>(zcur);
  p.g = static_cast<float*>(g);
  p.y = static_cast<float*>(y);
  p.d = static_cast<const float*>(d);
  p.iters = static_cast<int*>(iters);
  p.done = static_cast<unsigned char*>(done);
  p.res = static_cast<float*>(res);
  p.active = static_cast<int*>(active);
  auto* xo = static_cast<float*>(x_out);
  auto* uo = static_cast<float*>(u_out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int ct = check_termination;
  if (nx == 12 && nu == 4) {   // the quadrotor
    if (!team_consensus_args<12, 4>(sc, fa, tab, N, xo, uo, &ca))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        families ? forward_team_consensus<12, 4, true>(
                       fa, ca, p, it, N, B, ct, rho, tol_pri, tol_dua, s)
                 : forward_team_consensus<12, 4, false>(
                       fa, ca, p, it, N, B, ct, rho, tol_pri, tol_dua, s));
  }
  if (nx == 6 && nu == 3) {    // the rocket
    if (!team_consensus_args<6, 3>(sc, fa, tab, N, xo, uo, &ca))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        families ? forward_team_consensus<6, 3, true>(
                       fa, ca, p, it, N, B, ct, rho, tol_pri, tol_dua, s)
                 : forward_team_consensus<6, 3, false>(
                       fa, ca, p, it, N, B, ct, rho, tol_pri, tol_dua, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
