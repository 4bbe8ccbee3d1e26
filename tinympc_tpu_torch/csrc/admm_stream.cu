// Streamed batched ADMM solve for long horizons: each iteration is two
// launches, a backward and a forward sweep over the horizon, at fixed rho,
// box constraints alone or with the other constraint families (second-order
// cones, hyperplanes, time-varying hyperplanes; admm_families.cuh), cold or
// warm. The host loop (kernels/admm_stream.py) launches them. One
// instantiation serves every mix of families at each (nx, nu), (12, 4) and
// (6, 3): a family that is off has count 0, and its hooks do nothing. (A
// box-only instantiation, without the hooks, spilled 752 B in its backward
// kernel at the 128-register cap, and spilled without the cap too.)
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
//     iterations, residuals). On warm solves with families it also writes
//     the x/u trajectories the carry hands over (track_xu).
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
//
// What bounds it on an H100: per lane and iteration the two sweeps move
// ~104 floats a horizon row at (12, 4) (416 B: the backward reads vnew, g,
// znew, y and writes d; the forward reads g, y, d and the previous slacks
// and writes the slacks and duals) against ~1 k FMA a row, so in bytes
// alone a launch is memory-bound. But one thread a lane fills only B / 128
// blocks (8 of 132 SMs at B=1024) and each thread walks its rows in
// series, each row waiting on device-memory latency and on the row
// before's p or x: at small batches the launches are latency-bound. Several
// threads a lane, prefetching the next rows (or staging them through TMA)
// are later work.
//
// C interface (loaded with ctypes): tinympc_stream_backward and
// tinympc_stream_forward launch on the given stream, never synchronise,
// and return the cudaError_t of the launch.
#include "admm_families.cuh"
#include "admm_sweep.cuh"

namespace {

using tinympc::FamilyArgs;
using tinympc::Families;
using tinympc::FixedRho;
using tinympc::Layout;
using tinympc::NegRefWindow;
using tinympc::Residuals;
using tinympc::Tables;

constexpr int kBlock = 128;
// At least 4 blocks an SM: at most 128 registers a thread, which the
// kernels fit without spilling (120 and 118 at (12, 4)).
constexpr int kMinBlocks = 4;

// Floats of shared memory a launch uses: the small box tables (Layout's
// prefix, up to the reference), the family tables that do not grow with N,
// and the terminal reference term.
template <int NX, int NU>
int shared_floats(const FamilyArgs& fa, int N) {
  return Layout(NX, NU, N).xref + Families<NX, NU>::static_floats(fa, NX, NU)
         + NX;
}

// Copy the tables shared_floats counts into shared memory: Layout's prefix
// to sm[0..), the family tables after it.
template <int NX, int NU>
__device__ void load_tables(float* sm, const float* tables, const Layout& L,
                            const FamilyArgs& fa) {
  for (int k = threadIdx.x; k < L.xref; k += blockDim.x) sm[k] = tables[k];
  const int nf = Families<NX, NU>::static_floats(fa, NX, NU);
  for (int k = threadIdx.x; k < nf; k += blockDim.x)
    sm[L.xref + k] = tables[L.total + k];
}

// The forward sweep's family hooks plus, on warm family solves, the x/u
// trajectories the carry hands over (admm_stream.py:547-551): row i of x
// and u as the sweep forms them, for the lanes still running.
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

// Backward launch: d of every running lane from its previous iterate.
template <int NX, int NU>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_backward_kernel(const float* __restrict__ tables,
                           const float* __restrict__ vprev,
                           const float* __restrict__ zprev,
                           const float* __restrict__ g,
                           const float* __restrict__ y,
                           float* __restrict__ d,
                           const unsigned char* __restrict__ done,
                           int* __restrict__ active, FamilyArgs fa, int N,
                           int B, float rho) {
  extern __shared__ float sm[];
  const Layout L(NX, NU, N);
  load_tables<NX, NU>(sm, tables, L, fa);
  if (blockIdx.x == 0 && threadIdx.x == 0) *active = 0;
  __syncthreads();
  // Terminal reference term -Pinf^T Xref[N-1] (admm_stream.py:926), summed
  // as the resident kernel sums it.
  float* pnref = sm + L.xref + Families<NX, NU>::static_floats(fa, NX, NU);
  if (threadIdx.x < NX) {
    const int k = threadIdx.x;
    float acc = 0.f;
    for (int j = 0; j < NX; ++j)
      acc = fmaf(sm[L.pinft + k * NX + j], tables[L.xref + (N - 1) * NX + j],
                 acc);
    pnref[k] = -acc;
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || done[b]) return;   // no barrier follows
  const size_t sB = static_cast<size_t>(B);
  const Tables t(sm, tables, L);
  const Families<NX, NU> fam(fa, sm + L.xref, tables + L.total, N, sB, b,
                             rho);
  const NegRefWindow<NX> negxq{tables + L.xref, sm + L.qd};
  const NegRefWindow<NU> negur{tables + L.uref, sm + L.rd};
  float dvgN[NX];
#pragma unroll
  for (int k = 0; k < NX; ++k) {
    const size_t a = (static_cast<size_t>(N - 1) * NX + k) * sB + b;
    dvgN[k] = vprev[a] - g[a];
  }
  tinympc::backward_sweep<NX, NU>(t, negxq, negur, pnref, dvgN, vprev, zprev,
                                  g, y, d, N, sB, b, rho, fam, FixedRho());
}

// Forward launch of iteration `it`: the new slacks into vcur/zcur, the
// duals in place, the residuals and the bookkeeping. The dual residual
// compares against vprev/zprev, or, in the STALE variant, against the
// carried v/z (vstale/zstale; admm_stream.py:270-275).
template <int NX, int NU, bool STALE>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_forward_kernel(
        const float* __restrict__ tables, const float* __restrict__ x0,
        const float* __restrict__ vprev, const float* __restrict__ zprev,
        const float* __restrict__ vstale, const float* __restrict__ zstale,
        float* __restrict__ vcur, float* __restrict__ zcur,
        float* __restrict__ g, float* __restrict__ y,
        const float* __restrict__ d, int* __restrict__ iters,
        unsigned char* __restrict__ done, float* __restrict__ res,
        int* __restrict__ active, FamilyArgs fa, float* x_out, float* u_out,
        int it, int N, int B, int check_termination, float rho, float tol_pri,
        float tol_dua) {
  extern __shared__ float sm[];
  const Layout L(NX, NU, N);
  load_tables<NX, NU>(sm, tables, L, fa);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || done[b]) return;   // no barrier follows
  const size_t sB = static_cast<size_t>(B);
  const Tables t(sm, tables, L);
  const Families<NX, NU> fam(fa, sm + L.xref, tables + L.total, N, sB, b,
                             rho);
  const TrackXU<NX, NU> hooks{fam, x_out, u_out, sB, b};
  const bool checking = ((it + 1) % check_termination) == 0;
  float x0r[NX], dvgN[NX], u0[NU];
#pragma unroll
  for (int k = 0; k < NX; ++k) x0r[k] = x0[static_cast<size_t>(b) * NX + k];
  const Residuals r = tinympc::forward_sweep<NX, NU>(
      t, x0r, dvgN, vcur, zcur, STALE ? vstale : vprev,
      STALE ? zstale : zprev, g, y, d, N, sB, b, checking, u0, hooks,
      FixedRho());
  // Bookkeeping (admm_stream.py:576-641): iterations on every iteration,
  // residuals (dual rows scaled by rho) and convergence on check
  // iterations only.
  iters[b] = it + 1;
  if (checking) {
    const float r2 = r.dua_s * rho, r3 = r.dua_i * rho;
    res[b] = r.pri_s;
    res[sB + b] = r.pri_i;
    res[2 * sB + b] = r2;
    res[3 * sB + b] = r3;
    const bool ok = (r.pri_s < tol_pri) && (r.pri_i < tol_pri) &&
                    (r2 < tol_dua) && (r3 < tol_dua);
    if (ok)
      done[b] = 1;
    else
      *active = 1;
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

template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int NX, int NU>
cudaError_t backward(const FamilyArgs& fa, int N, int B, float rho,
                     const float* tables, const float* vprev,
                     const float* zprev, const float* g, const float* y,
                     float* d, const unsigned char* done, int* active,
                     cudaStream_t s) {
  const size_t smem = shared_floats<NX, NU>(fa, N) * sizeof(float);
  auto kernel = stream_backward_kernel<NX, NU>;
  const cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(B + kBlock - 1) / kBlock, kBlock, smem, s>>>(
      tables, vprev, zprev, g, y, d, done, active, fa, N, B, rho);
  return cudaGetLastError();
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

template <int NX, int NU, bool STALE>
cudaError_t forward(const FamilyArgs& fa, const Forward& p, int it, int N,
                    int B, int ct, float rho, float tol_pri, float tol_dua,
                    cudaStream_t s) {
  const size_t smem = (shared_floats<NX, NU>(fa, N) - NX) * sizeof(float);
  auto kernel = stream_forward_kernel<NX, NU, STALE>;
  const cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(B + kBlock - 1) / kBlock, kBlock, smem, s>>>(
      p.tables, p.x0, p.vprev, p.zprev, p.vstale, p.zstale, p.vcur, p.zcur,
      p.g, p.y, p.d, p.iters, p.done, p.res, p.active, fa, p.x_out, p.u_out,
      it, N, B, ct, rho, tol_pri, tol_dua);
  return cudaGetLastError();
}

template <bool STALE>
int forward_dispatch(int nx, int nu, const FamilyArgs& fa, const Forward& p,
                     int it, int N, int B, int ct, float rho, float tol_pri,
                     float tol_dua, cudaStream_t s) {
  if (nx == 12 && nu == 4)   // the quadrotor
    return static_cast<int>(forward<12, 4, STALE>(fa, p, it, N, B, ct, rho,
                                                  tol_pri, tol_dua, s));
  if (nx == 6 && nu == 3)    // the rocket
    return static_cast<int>(forward<6, 3, STALE>(fa, p, it, N, B, ct, rho,
                                                 tol_pri, tol_dua, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int tinympc_stream_block() { return kBlock; }

// The backward launch. counts: the six family sizes beyond the box (state
// cones, input cones, state and input hyperplanes, state and input
// time-varying hyperplanes; all zero for box constraints alone); fam: the
// 12 working slack and dual arrays (null for a family that is off).
// vprev (N, nx, B), zprev (N-1, nu, B): the previous slacks; g, y the
// duals; d (N-1, nu, B) out; done (B,) the lanes that have converged;
// active one int, zeroed. Returns 0 or a cudaError_t;
// cudaErrorInvalidValue for an (nx, nu) pair this file does not
// instantiate, a bad size or a missing array.
extern "C" int tinympc_stream_backward(int nx, int nu, int N, int B,
                                       const int* counts, float rho,
                                       const void* tables, const void* vprev,
                                       const void* zprev, const void* g,
                                       const void* y, void* d,
                                       const void* done, void* active,
                                       void* const* fam, void* stream) {
  FamilyArgs fa;
  bool families;
  if (N < 2 || B < 1 || !family_args(counts, fam, &fa, &families) ||
      !tables || !vprev || !zprev || !g || !y || !d || !done || !active)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tables);
  const auto* vp = static_cast<const float*>(vprev);
  const auto* zp = static_cast<const float*>(zprev);
  const auto* gg = static_cast<const float*>(g);
  const auto* yy = static_cast<const float*>(y);
  auto* dd = static_cast<float*>(d);
  const auto* dn = static_cast<const unsigned char*>(done);
  auto* act = static_cast<int*>(active);
  if (nx == 12 && nu == 4)
    return static_cast<int>(
        backward<12, 4>(fa, N, B, rho, t, vp, zp, gg, yy, dd, dn, act, s));
  if (nx == 6 && nu == 3)
    return static_cast<int>(
        backward<6, 3>(fa, N, B, rho, t, vp, zp, gg, yy, dd, dn, act, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward launch of iteration `it`, STALE when `stale` is set.
// prev: vprev, zprev (the previous slacks), then vstale, zstale (the
// carried v/z; read by the STALE variant only, null otherwise). vcur
// (N, nx, B) and zcur (N-1, nu, B) out; g, y updated; d from the backward
// launch; iters (B,) int, done (B,) bytes and res (4, B) updated for the
// running lanes; active set on check iterations while a lane runs; fam as
// for the backward launch; x_out/u_out the tracked trajectories (both or
// neither; only with families). Returns 0 or a cudaError_t.
extern "C" int tinympc_stream_forward(
    int stale, int nx, int nu, int N, int B, int it, int check_termination,
    const int* counts, float rho, float tol_pri, float tol_dua,
    const void* tables, const void* x0, const void* const* prev, void* vcur,
    void* zcur, void* g, void* y, const void* d, void* iters, void* done,
    void* res, void* active, void* const* fam, void* x_out, void* u_out,
    void* stream) {
  FamilyArgs fa;
  bool families;
  if (N < 2 || B < 1 || it < 0 || check_termination < 1 ||
      !family_args(counts, fam, &fa, &families) || !tables || !x0 ||
      !prev[0] || !prev[1] || (stale && (!prev[2] || !prev[3])) || !vcur ||
      !zcur || !g || !y || !d || !iters || !done || !res || !active ||
      (!x_out != !u_out) || (x_out && !families))
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
  return stale ? forward_dispatch<true>(nx, nu, fa, p, it, N, B,
                                        check_termination, rho, tol_pri,
                                        tol_dua, s)
               : forward_dispatch<false>(nx, nu, fa, p, it, N, B,
                                         check_termination, rho, tol_pri,
                                         tol_dua, s);
}
