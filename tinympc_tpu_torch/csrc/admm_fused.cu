// Fused batched ADMM solve: box constraints, cold start, fixed rho.
//
// Replaces the box-only, cold, fixed-rho variant of the TPU kernel
// tinympc_tpu/kernels/admm_pallas.py:_make_kernel (launched by _fused_call).
// One launch runs the whole ADMM loop for every problem of the batch:
// linear cost fused into the backward Riccati sweep, forward rollout fused
// with the box projection, the dual update and the four max-abs residuals,
// termination every check_termination iterations, and a per-block exit once
// every lane of the block has converged.
//
// Design (the first, simple one):
//   * One thread per problem; 128 threads a block; threads past B count as
//     converged from the start. A converged lane stops computing and keeps
//     its iterates, so what a lane returns does not depend on the block it
//     shares (the TPU kernel snapshots instead; the outputs are the same).
//   * Per-lane trajectories live in device memory in the lane-last layout
//     (N, nx, B): thread b touches address b of every row, so each access of
//     a warp is one coalesced 128-byte line. vnew/znew are ping-pong halves
//     (2, N, nx, B) / (2, N-1, nu, B): iteration `it` writes half it%2 and
//     reads the previous iterate from the other half.
//   * The costate p, the state x, x0 and the carried terminal term
//     vnew[N-1] - g[N-1] stay in registers. The small shared matrices and
//     per-step tables sit in shared memory (about 7 KB at nx=12, nu=4, N=20);
//     every thread reads the same word, a broadcast.
//   * Float32 FMA on the CUDA cores only: no tensor cores, no TF32, no fast
//     math. Each matvec sums in a fixed column order.
//
// What bounds it on an H100: the arithmetic is ~9.4k FMA per lane and
// iteration at nx=12, nu=4, N=20 (0.9 ms for 32768 lanes x 100 iterations
// at the FP32 peak), but this design streams ~7 KB per lane and iteration
// through device memory (the per-lane state, ~4 KB a lane, does not fit in
// the 50 MB L2 at B=32768) and runs only ~250 threads per SM at that batch,
// too few to hide the serial 38-step chain of each iteration. Keeping the
// state on chip and spreading a problem over several threads is later work.
//
// C interface (loaded with ctypes): tinympc_admm_fused_box_cold returns the
// cudaError_t of the launch; it launches on the given stream and never
// synchronises.
#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int kBlock = 128;

// Float offsets into the packed table the wrapper builds (row-major);
// kernels/admm_fused.py:_pack_tables writes the same order.
struct Layout {
  int mback, mfwd, quu, kinft, bm, apf, bpf, f, qd, rd, pinft, xref, uref,
      xmin, xmax, umin, umax, total;
  __host__ __device__ Layout(int nx, int nu, int N) {
    int o = 0;
    mback = o; o += (nu + nx) * nx;
    mfwd = o;  o += (nu + nx) * nx;
    quu = o;   o += nu * nu;
    kinft = o; o += nx * nu;
    bm = o;    o += nx * nu;
    apf = o;   o += nx;
    bpf = o;   o += nu;
    f = o;     o += nx;
    qd = o;    o += nx;
    rd = o;    o += nu;
    pinft = o; o += nx * nx;
    xref = o;  o += N * nx;
    uref = o;  o += (N - 1) * nu;
    xmin = o;  o += N * nx;
    xmax = o;  o += N * nx;
    umin = o;  o += (N - 1) * nu;
    umax = o;  o += (N - 1) * nu;
    total = o;
  }
};

// Box projection min(hi, max(lo, s)) with NaN propagating like
// jnp.minimum/jnp.maximum (fminf/fmaxf would drop it).
__device__ __forceinline__ float clamp_nan(float s, float lo, float hi) {
  s = (s < lo) ? lo : s;
  return (s > hi) ? hi : s;
}

// max that keeps a NaN once seen, like jnp.max.
__device__ __forceinline__ float max_nan(float m, float a) {
  return (a > m || a != a) ? a : m;
}

template <int NX, int NU>
__global__ void __launch_bounds__(kBlock) admm_fused_box_cold_kernel(
    const float* __restrict__ tables, const float* __restrict__ x0,
    float* __restrict__ vnew, float* __restrict__ znew,
    float* __restrict__ g, float* __restrict__ y, float* __restrict__ d,
    float* __restrict__ out_x, float* __restrict__ out_u,
    int* __restrict__ out_iters, unsigned char* __restrict__ out_solved,
    float* __restrict__ out_res, int N, int B, int max_iter,
    int check_termination, float rho, float tol_pri, float tol_dua) {
  extern __shared__ float sm[];
  const Layout L(NX, NU, N);
  for (int k = threadIdx.x; k < L.total; k += blockDim.x) sm[k] = tables[k];
  __syncthreads();

  // Terminal reference term -Pinf^T Xref[N-1] (admm_pallas.py:823), then
  // the -(Xref .* Q) and -(Uref .* R) tables in place (:817-818).
  float* pnref = sm + L.total;
  if (threadIdx.x < NX) {
    const int k = threadIdx.x;
    float acc = 0.f;
    for (int j = 0; j < NX; ++j)
      acc = fmaf(sm[L.pinft + k * NX + j], sm[L.xref + (N - 1) * NX + j], acc);
    pnref[k] = -acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N * NX; k += blockDim.x)
    sm[L.xref + k] = -(sm[L.xref + k] * sm[L.qd + k % NX]);
  for (int k = threadIdx.x; k < (N - 1) * NU; k += blockDim.x)
    sm[L.uref + k] = -(sm[L.uref + k] * sm[L.rd + k % NU]);
  __syncthreads();

  const float* Mback = sm + L.mback;
  const float* Mfwd = sm + L.mfwd;
  const float* Quu = sm + L.quu;
  const float* KinfT = sm + L.kinft;
  const float* Bm = sm + L.bm;
  const float* APf = sm + L.apf;
  const float* BPf = sm + L.bpf;
  const float* fv = sm + L.f;
  const float* negxq = sm + L.xref;
  const float* negur = sm + L.uref;
  const float* xmin = sm + L.xmin;
  const float* xmax = sm + L.xmax;
  const float* umin = sm + L.umin;
  const float* umax = sm + L.umax;

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = b < B;
  const size_t sB = static_cast<size_t>(B);
  const size_t half_x = static_cast<size_t>(N) * NX * sB;
  const size_t half_u = static_cast<size_t>(N - 1) * NU * sB;

  bool done = !lane;
  int iters = 0;
  float res0 = 0.f, res1 = 0.f, res2 = 0.f, res3 = 0.f;
  float x0r[NX], dvgN[NX];
  if (lane) {
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      x0r[k] = x0[static_cast<size_t>(b) * NX + k];
      dvgN[k] = 0.f;   // vnew[N-1] - g[N-1] of the zero cold workspace
    }
    // Cold workspace (tiny_api.cpp:68-133): g, y and the half iteration 0
    // reads as "previous" are zero; half 0 is written before it is read.
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

  for (int it = 0; it < max_iter; ++it) {
    const int cur = it & 1;
    const bool checking = ((it + 1) % check_termination) == 0;
    if (!done) {
      float* vcur = vnew + cur * half_x;
      float* zcur = znew + cur * half_u;
      const float* vprev = vnew + (cur ^ 1) * half_x;
      const float* zprev = znew + (cur ^ 1) * half_u;

      // 1+2. Linear cost fused into the backward sweep
      // (admm_pallas.py:894-968): q/r rows from the previous iterate.
      float p[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) p[k] = pnref[k] - rho * dvgN[k];
      for (int i = N - 2; i >= 0; --i) {
        float r[NU], q[NX];
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          const size_t a = (static_cast<size_t>(i) * NU + k) * sB + b;
          r[k] = negur[i * NU + k] - rho * (zprev[a] - y[a]);
        }
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const size_t a = (static_cast<size_t>(i) * NX + k) * sB + b;
          q[k] = negxq[i * NX + k] - rho * (vprev[a] - g[a]);
        }
        // [B^T; AmBKt] p
        float bp[NU], ap[NX];
#pragma unroll
        for (int row = 0; row < NU; ++row) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < NX; ++c) acc = fmaf(Mback[row * NX + c], p[c], acc);
          bp[row] = acc;
        }
#pragma unroll
        for (int row = 0; row < NX; ++row) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < NX; ++c)
            acc = fmaf(Mback[(NU + row) * NX + c], p[c], acc);
          ap[row] = acc;
        }
        // d[i] = Quu_inv (B^T p + r + BPf)
        float w[NU];
#pragma unroll
        for (int k = 0; k < NU; ++k) w[k] = bp[k] + r[k] + BPf[k];
#pragma unroll
        for (int row = 0; row < NU; ++row) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < NU; ++c) acc = fmaf(Quu[row * NU + c], w[c], acc);
          d[(static_cast<size_t>(i) * NU + row) * sB + b] = acc;
        }
        // p[i] = q + AmBKt p - Kinf^T r + APf
#pragma unroll
        for (int row = 0; row < NX; ++row) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < NU; ++c) acc = fmaf(KinfT[row * NU + c], r[c], acc);
          p[row] = q[row] + ap[row] - acc + APf[row];
        }
      }

      // 3-6. Forward rollout (admm_pallas.py:971-988) fused row by row
      // with the box projection, the dual update (both from the
      // pre-update duals, :1004-1046) and the residual maxima (:1165-1168).
      float x[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) x[k] = x0r[k];
      float pri_s = 0.f, pri_i = 0.f, dua_s = 0.f, dua_i = 0.f;
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const size_t a = (static_cast<size_t>(i) * NX + k) * sB + b;
          const float gi = g[a];
          const float vn = clamp_nan(x[k] + gi, xmin[i * NX + k], xmax[i * NX + k]);
          const float gn = gi + x[k] - vn;
          g[a] = gn;
          vcur[a] = vn;
          if (checking) {
            pri_s = max_nan(pri_s, fabsf(x[k] - vn));
            dua_s = max_nan(dua_s, fabsf(vprev[a] - vn));
          }
          if (i == N - 1) dvgN[k] = vn - gn;
        }
        if (i == N - 1) break;
        // [Kinf; A] x, then u = -Kinf x - d as an exact subtract
        float kx[NU], ax[NX];
#pragma unroll
        for (int row = 0; row < NU; ++row) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < NX; ++c) acc = fmaf(Mfwd[row * NX + c], x[c], acc);
          kx[row] = acc;
        }
#pragma unroll
        for (int row = 0; row < NX; ++row) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < NX; ++c)
            acc = fmaf(Mfwd[(NU + row) * NX + c], x[c], acc);
          ax[row] = acc;
        }
        float u[NU];
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          const size_t a = (static_cast<size_t>(i) * NU + k) * sB + b;
          u[k] = -kx[k] - d[a];
          const float yi = y[a];
          const float zn = clamp_nan(u[k] + yi, umin[i * NU + k], umax[i * NU + k]);
          y[a] = yi + u[k] - zn;
          zcur[a] = zn;
          if (checking) {
            pri_i = max_nan(pri_i, fabsf(u[k] - zn));
            dua_i = max_nan(dua_i, fabsf(zprev[a] - zn));
          }
        }
        // x+ = A x + B u + f
#pragma unroll
        for (int row = 0; row < NX; ++row) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < NU; ++c) acc = fmaf(Bm[row * NU + c], u[c], acc);
          x[row] = ax[row] + acc + fv[row];
        }
      }

      // Bookkeeping (admm_pallas.py:1144-1182): iters on every iteration,
      // residuals and convergence on check iterations only.
      iters = it + 1;
      if (checking) {
        res0 = pri_s;
        res1 = pri_i;
        res2 = dua_s * rho;
        res3 = dua_i * rho;
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
  // With max_iter = 0 that is the zero half 1.
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
}

template <int NX, int NU>
cudaError_t launch(const float* tables, const float* x0, float* vnew,
                   float* znew, float* g, float* y, float* d, float* out_x,
                   float* out_u, int* out_iters, unsigned char* out_solved,
                   float* out_res, int N, int B, int max_iter, int ct,
                   float rho, float tol_pri, float tol_dua,
                   cudaStream_t stream) {
  const size_t smem = (Layout(NX, NU, N).total + NX) * sizeof(float);
  auto kernel = admm_fused_box_cold_kernel<NX, NU>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((B + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, smem, stream>>>(
      tables, x0, vnew, znew, g, y, d, out_x, out_u, out_iters, out_solved,
      out_res, N, B, max_iter, ct, rho, tol_pri, tol_dua);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tinympc_admm_fused_block() { return kBlock; }

// Returns 0 on success, a cudaError_t otherwise; cudaErrorInvalidValue for
// an (nx, nu) pair this file does not instantiate or a bad size.
extern "C" int tinympc_admm_fused_box_cold(
    int nx, int nu, int N, int B, int max_iter, int check_termination,
    float rho, float tol_pri, float tol_dua, const void* tables,
    const void* x0, void* vnew, void* znew, void* g, void* y, void* d,
    void* out_x, void* out_u, void* out_iters, void* out_solved,
    void* out_res, void* stream) {
  if (N < 2 || B < 1 || max_iter < 0 || check_termination < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define TINYMPC_LAUNCH(NX_, NU_)                                              \
  if (nx == NX_ && nu == NU_)                                                 \
    return static_cast<int>(launch<NX_, NU_>(                                 \
        static_cast<const float*>(tables), static_cast<const float*>(x0),     \
        static_cast<float*>(vnew), static_cast<float*>(znew),                 \
        static_cast<float*>(g), static_cast<float*>(y),                       \
        static_cast<float*>(d), static_cast<float*>(out_x),                   \
        static_cast<float*>(out_u), static_cast<int*>(out_iters),             \
        static_cast<unsigned char*>(out_solved),                              \
        static_cast<float*>(out_res), N, B, max_iter, check_termination, rho, \
        tol_pri, tol_dua, static_cast<cudaStream_t>(stream)));
  TINYMPC_LAUNCH(12, 4)   // the quadrotor of the main path
#undef TINYMPC_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
