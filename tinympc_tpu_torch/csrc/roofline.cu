// Roofline probes of the fused solve on Hopper: a chain of matrix-vector
// products per lane, and a lane-last elementwise stream.
//
// Replaces the TPU probes of tools/roofline.py: dot_kernel (:59, launched at
// :89), L (depth, depth) x (depth, tile) dots, chained or independent, and
// elementwise_kernel (:98, launched at :117), add+clip passes and max-abs
// lane reductions over (N, F, tile). Each computes what the TPU probe
// computes; the layout is the port's own solve pattern, not the TPU's
// single-core tile: one thread per lane (column), blocks of 128 lanes over
// all lanes, per-lane vectors lane-last in device memory ((rows, lanes):
// thread b reads address b of every row, one coalesced line a warp).
//
// dot probe. The operand type is a template parameter:
//   * BF16 (the TPU function): each dot's operand is rounded to bf16
//     (__float2bfloat16_rn) and the products accumulate in float32 with
//     explicit fmaf; a bf16 x bf16 product is exact in float32, so each
//     fmaf rounds once, as a float32 sum of exact products;
//   * float32 (the card's own chain): no cast, at depth nx, as each matvec
//     of csrc/admm_sweep.cuh runs.
// Chained: x <- M x, L times, each dot waiting on the previous one (M in
// shared memory, read as a broadcast: every thread of a warp reads the same
// word, as the solve reads its tables). Independent: acc += Ms[k] y for L
// distinct matrices (distinct data defeats common-subexpression folding, as
// in the TPU probe); Ms does not fit a block's shared memory at the
// quadrotor's point (95 bf16 matrices of 36 x 36, 246 KB against 227 KB),
// so it streams through shared memory in chunks of up to 96 KB, once per
// rep, in the TPU probe's accumulation order (rep, then matrix). The
// per-lane vectors stay in registers (2 x depth floats); the chained sum
// over reps goes to the output in device memory once a rep.
// What bounds it: a lane's dot is depth^2 FMAs, so the probe is arithmetic
// on the CUDA cores (67 TFLOP/s FP32 at most); the chained variant is bound
// by the latency of a depth-long FMA chain once too few warps run to hide
// it. The bound of the same work is lower still on the tensor cores (989
// TFLOP/s bf16): this probe measures the solve's pattern, not that peak.
//
// elementwise probe: each thread walks the N*F rows of its lane, reading
// a and b once a rep (`reps` re-reads a, as the TPU probe does), running
// the `passes` add+clip(+-5) passes in registers, and keeping the max-abs
// of the lane. `reductions` identical reductions of the same values give
// one result; a lane computes it once. Bound by device memory (or L2 when
// the two arrays fit in it): 8 bytes read per element and rep.
//
// The rep loop re-reads its inputs through a pointer the compiler cannot
// see through (opaque), so no rep's work is hoisted out of the loop.
//
// C interface (loaded with ctypes): tinympc_roofline_dot and
// tinympc_roofline_elementwise return the cudaError_t of the launch; they
// launch on the given stream and never synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kBlock = 128;
constexpr int kChunkBytes = 96 * 1024;   // shared memory of Ms chunks

// p, laundered through an empty volatile asm: the loads through it are new
// on every rep.
template <class T>
__device__ __forceinline__ const T* opaque(const T* p) {
  unsigned long long a = reinterpret_cast<unsigned long long>(p);
  asm volatile("" : "+l"(a));
  return reinterpret_cast<const T*>(a);
}

// 0, laundered the same way: an offset into a shared array whose loads are
// new on every use, as loads from the shared state space.
__device__ __forceinline__ int opaque_zero() {
  int z = 0;
  asm volatile("" : "+r"(z));
  return z;
}

template <bool BF16>
using Mat = std::conditional_t<BF16, __nv_bfloat16, float>;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A dot's operand: rounded to bf16 (exactly representable in float32), or
// as it is.
template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  if constexpr (BF16)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// max that keeps a NaN once seen, as jnp.max / jnp.maximum do.
__device__ __forceinline__ float max_nan(float m, float a) {
  return (a > m || a != a) ? a : m;
}

// min(hi, max(lo, s)) with NaN propagating as jnp.minimum / jnp.maximum.
__device__ __forceinline__ float clip_nan(float s, float lo, float hi) {
  s = (s < lo) ? lo : s;
  return (s > hi) ? hi : s;
}

// out (D, lanes) = sum over reps of (M o cast)^L v: v (D, lanes), M (D, D).
template <int D, bool BF16>
__global__ void __launch_bounds__(kBlock, 1)
    dot_chained_kernel(const Mat<BF16>* __restrict__ M,
                       const float* __restrict__ v, float* __restrict__ out,
                       int L, int lanes, int reps) {
  __shared__ float m[D * D];
  for (int k = threadIdx.x; k < D * D; k += blockDim.x) m[k] = to_float(M[k]);
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lanes) return;
  const size_t sL = static_cast<size_t>(lanes);
#pragma unroll
  for (int row = 0; row < D; ++row) out[row * sL + b] = 0.f;
  for (int r = 0; r < reps; ++r) {
    const float* vr = opaque(v);
    float x[D];
#pragma unroll
    for (int k = 0; k < D; ++k) x[k] = vr[k * sL + b];
#pragma unroll 1
    for (int l = 0; l < L; ++l) {
      // M is read from shared memory on every product, as the solve reads
      // its tables: held in registers across the chain, its D*D entries
      // would spill from depth 32 on.
      const float* mm = m + opaque_zero();
      float xo[D];
#pragma unroll
      for (int k = 0; k < D; ++k) xo[k] = operand<BF16>(x[k]);
#pragma unroll
      for (int row = 0; row < D; ++row) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) acc = fmaf(mm[row * D + c], xo[c], acc);
        x[row] = acc;
      }
    }
#pragma unroll
    for (int row = 0; row < D; ++row)
      out[row * sL + b] = out[row * sL + b] + x[row];
  }
}

// out (D, lanes) = sum over reps r, then k < L, of Ms[k] cast(v + r):
// Ms (L, D, D) streamed through shared memory `chunk` matrices at a time.
template <int D, bool BF16>
__global__ void __launch_bounds__(kBlock, 1)
    dot_independent_kernel(const Mat<BF16>* __restrict__ Ms,
                           const float* __restrict__ v,
                           float* __restrict__ out, int L, int lanes,
                           int reps, int chunk) {
  extern __shared__ float ms[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = b < lanes;
  const size_t sL = static_cast<size_t>(lanes);
  float acc[D];
#pragma unroll
  for (int row = 0; row < D; ++row) acc[row] = 0.f;
  for (int r = 0; r < reps; ++r) {
    float y[D];
#pragma unroll
    for (int k = 0; k < D; ++k)
      y[k] = lane ? operand<BF16>(v[k * sL + b] + static_cast<float>(r)) : 0.f;
    for (int k0 = 0; k0 < L; k0 += chunk) {
      const int n = L - k0 < chunk ? L - k0 : chunk;
      __syncthreads();
      const Mat<BF16>* src = Ms + static_cast<size_t>(k0) * D * D;
      for (int e = threadIdx.x; e < n * D * D; e += blockDim.x)
        ms[e] = to_float(src[e]);
      __syncthreads();
      if (!lane) continue;
#pragma unroll 1
      for (int k = 0; k < n; ++k) {
        const float* mk = ms + k * D * D;
#pragma unroll
        for (int row = 0; row < D; ++row) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < D; ++c) dot = fmaf(mk[row * D + c], y[c], dot);
          acc[row] = acc[row] + dot;
        }
      }
    }
  }
  if (!lane) return;
#pragma unroll
  for (int row = 0; row < D; ++row) out[row * sL + b] = acc[row];
}

// out (1, lanes): per rep, x = a passed `passes` times through
// clip(x + b, -5, 5), the lane's max |x| over the rows folded into the sum
// by max when reductions > 0, then x's row 0 added.
__global__ void __launch_bounds__(kBlock)
    elementwise_kernel(const float* __restrict__ a,
                       const float* __restrict__ bv, float* __restrict__ out,
                       int rows, int lanes, int passes, int reductions,
                       int reps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lanes) return;
  const size_t sL = static_cast<size_t>(lanes);
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) {
    const float* ar = opaque(a);
    const float* br = opaque(bv);
    float m = 0.f, x0 = 0.f;
#pragma unroll 4
    for (int e = 0; e < rows; ++e) {
      float x = ar[e * sL + b];
      if (passes > 0) {
        const float add = br[e * sL + b];
        for (int p = 0; p < passes; ++p) x = clip_nan(x + add, -5.f, 5.f);
      }
      m = max_nan(m, fabsf(x));
      if (e == 0) x0 = x;
    }
    if (reductions > 0) acc = max_nan(acc, m);
    acc = acc + x0;
  }
  out[b] = acc;
}

template <int D, bool BF16>
cudaError_t launch_dot(bool chained, int L, int lanes, int reps,
                       const void* M, const void* v, float* out,
                       cudaStream_t s) {
  const dim3 grid((lanes + kBlock - 1) / kBlock);
  const auto* mat = static_cast<const Mat<BF16>*>(M);
  const auto* vec = static_cast<const float*>(v);
  if (chained) {
    dot_chained_kernel<D, BF16><<<grid, kBlock, 0, s>>>(mat, vec, out, L,
                                                        lanes, reps);
    return cudaGetLastError();
  }
  int chunk = kChunkBytes / static_cast<int>(D * D * sizeof(float));
  if (chunk > L) chunk = L;
  const size_t smem = static_cast<size_t>(chunk) * D * D * sizeof(float);
  auto kernel = dot_independent_kernel<D, BF16>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kBlock, smem, s>>>(mat, vec, out, L, lanes, reps, chunk);
  return cudaGetLastError();
}

// The depths the roofline tool runs: bf16 at the TPU probe's 3 nx (36 for
// the quadrotor, 96 for the synthetic (32, 8) system), float32 at nx (12,
// 32).
cudaError_t dispatch_dot(int depth, bool bf16, bool chained, int L,
                         int lanes, int reps, const void* M, const void* v,
                         float* out, cudaStream_t s) {
  if (bf16 && depth == 36)
    return launch_dot<36, true>(chained, L, lanes, reps, M, v, out, s);
  if (bf16 && depth == 96)
    return launch_dot<96, true>(chained, L, lanes, reps, M, v, out, s);
  if (!bf16 && depth == 12)
    return launch_dot<12, false>(chained, L, lanes, reps, M, v, out, s);
  if (!bf16 && depth == 32)
    return launch_dot<32, false>(chained, L, lanes, reps, M, v, out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tinympc_roofline_block() { return kBlock; }

// The dot probe. bf16 nonzero for bf16 matrices (M or Ms as
// __nv_bfloat16) and bf16 operands, at depth 36 or 96; else float32, at
// depth 12 or 32; chained nonzero: M (depth, depth), else Ms (L, depth,
// depth); v and out (depth, lanes) float32. cudaErrorInvalidValue for
// another depth or a bad size.
extern "C" int tinympc_roofline_dot(int depth, int bf16, int chained, int L,
                                    int lanes, int reps, const void* M,
                                    const void* v, void* out, void* stream) {
  if (L < 1 || lanes < 1 || reps < 0 || !M || !v || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  return static_cast<int>(
      dispatch_dot(depth, bf16, chained, L, lanes, reps, M, v, o, s));
}

// The elementwise probe: a and b (rows, lanes) float32 (rows = N * F), out
// (1, lanes).
extern "C" int tinympc_roofline_elementwise(int rows, int lanes, int passes,
                                            int reductions, int reps,
                                            const void* a, const void* b,
                                            void* out, void* stream) {
  if (rows < 1 || lanes < 1 || passes < 0 || reductions < 0 || reps < 0 ||
      !a || !b || !out)
    return static_cast<int>(cudaErrorInvalidValue);
  elementwise_kernel<<<(lanes + kBlock - 1) / kBlock, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), rows, lanes, passes, reductions, reps);
  return static_cast<int>(cudaGetLastError());
}
