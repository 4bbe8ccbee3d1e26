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
//     (__float2bfloat16_rn) and the products accumulate in float32; a
//     bf16 x bf16 product is exact in float32;
//   * float32 (the card's own chain): no cast, at depth nx, as each matvec
//     of csrc/admm_sweep.cuh runs.
// Chained: x <- M x, L times, each dot waiting on the previous one (M in
// shared memory, read as a broadcast: every thread of a warp reads the same
// word, as the solve reads its tables), on the CUDA cores with explicit
// fmaf, one thread a lane, both operand types: a chain of one-column
// products is the solve's pattern. Independent: acc += Ms[k] y for L
// distinct matrices (distinct data defeats common-subexpression folding, as
// in the TPU probe), in the TPU probe's accumulation order (rep, then
// matrix); Ms does not fit a block's shared memory at the quadrotor's point
// (95 bf16 matrices of 36 x 36, 246 KB against 227 KB), so it streams
// through shared memory in chunks of up to 96 KB, once per rep.
//   * bf16 (dot_independent_mma_kernel): on the tensor cores, as the TPU
//     probe runs on the MXU: mma.sync m16n8k16 bf16 with float32
//     accumulation. A warp holds 32 lanes (4 tiles of 8); depth is padded
//     with zeros to a multiple of 16 (36 -> 48) as a chunk is staged into
//     shared memory with cp.async, every copy of the chunk in flight at
//     once (rows padded by 8 more bf16, so ldmatrix reads them without
//     bank conflicts). Each rep the warp forms its B fragments,
//     bf16(v + r) padded, once, and keeps them in registers for all L
//     matrices; each matrix's A fragments come from shared memory through
//     ldmatrix. Each matrix's dot is formed from zero over its k16 chunks
//     in a fresh accumulator and then added to the running float32 sum with
//     an IEEE add: the plain version's order, so the tensor core's own
//     accumulation touches one dot at a time, never the growing sum.
//   * float32 (dot_independent_kernel): on the CUDA cores with explicit
//     fmaf, one thread a lane, the per-lane vectors in registers.
// What bounds it: the independent bf16 dots do ~14 GFLOP of padded MMA at
// the quadrotor's point against the tensor cores' 989 TFLOP/s and move
// ~9 MB; the float32 dots are depth^2 FMAs a lane on the CUDA cores (67
// TFLOP/s at most); the chained variant is bound by the latency of a
// depth-long FMA chain once too few warps run to hide it. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (chip_compare.py time dot, in turns;
// PERF.md section 6), L=95: depth 36, 32768 lanes 0.0856-0.1007 ms
// against 0.4823-0.4969 for the CUDA-core kernel it replaced; depth 96,
// 16384 lanes 0.1897-0.1997 against 5.5965-5.6631. Staging a chunk with
// plain loads instead of cp.async took 0.1209-0.1236 and 0.4300-0.4394;
// 256-lane blocks gained nothing.
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

// out (D, lanes) = sum over reps r, then k < L, of Ms[k] (v + r), in
// float32 on the CUDA cores: Ms (L, D, D) streamed through shared memory
// `chunk` matrices at a time.
template <int D>
__global__ void __launch_bounds__(kBlock, 1)
    dot_independent_kernel(const float* __restrict__ Ms,
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
      y[k] = lane ? v[k * sL + b] + static_cast<float>(r) : 0.f;
    for (int k0 = 0; k0 < L; k0 += chunk) {
      const int n = L - k0 < chunk ? L - k0 : chunk;
      __syncthreads();
      const float* src = Ms + static_cast<size_t>(k0) * D * D;
      for (int e = threadIdx.x; e < n * D * D; e += blockDim.x)
        ms[e] = src[e];
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

// The staged shape of a bf16 matrix of depth D on the tensor cores: depth
// padded with zeros to whole k16 chunks (kTiles of them, and as many
// 16-row tiles), each row padded by 8 more bf16 so that the 8 rows an
// ldmatrix phase reads start in 8 distinct bank groups.
template <int D>
struct MmaShape {
  static constexpr int kPad = (D + 15) / 16 * 16;
  static constexpr int kTiles = kPad / 16;
  static constexpr int kStride = kPad + 8;
  static constexpr int kElems = kPad * kStride;   // bf16 a staged matrix
};
constexpr int kNTiles = 4;   // 8-lane tiles a warp: 32 lanes
// Threads (4 warps, 128 lanes) a block of the tensor-core kernel: the
// lanes that share one staging of each chunk.
constexpr int kMmaBlock = 128;

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// d += A B on one m16n8k16 tile: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col),
// d 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 8 bytes from device memory into shared memory, asynchronously
// (cp.async): a chunk's copies are all in flight at once, and
// cp.async.wait_all ends them.
__device__ __forceinline__ void copy8_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// The four 8 x 8 bf16 tiles of a 16 x 16 A fragment from shared memory;
// `row` is this thread's row address (thread i: row i % 16, column
// (i / 16) * 8 of the tile).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4],
                                            const __nv_bfloat16* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// out (D, lanes) = sum over reps r, then k < L, of Ms[k] bf16(v + r), on
// the tensor cores: Ms (L, D, D) bf16 staged `chunk` matrices at a time.
template <int D>
__global__ void __launch_bounds__(kMmaBlock, 1)
    dot_independent_mma_kernel(const __nv_bfloat16* __restrict__ Ms,
                               const float* __restrict__ v,
                               float* __restrict__ out, int L, int lanes,
                               int reps, int chunk) {
  using S = MmaShape<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* ms = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* ms32 = reinterpret_cast<unsigned*>(smem);
  const int tl = threadIdx.x & 31;
  const int grp = tl >> 2, tid = tl & 3;
  const int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31);
  const size_t sL = static_cast<size_t>(lanes);
  // The padding of the staged matrices is zero for the whole launch: a
  // chunk's staging writes the D x D entries alone.
  for (int e = threadIdx.x; e < chunk * S::kElems / 2; e += blockDim.x)
    ms32[e] = 0u;
  float sum[S::kTiles][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < S::kTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[mt][nt][q] = 0.f;
  // A row of D bf16 is D / 4 pieces of 8 bytes (D is a multiple of 4).
  constexpr int kQuads = D / 4, kPieces = D * kQuads;
  const auto* src8 = reinterpret_cast<const uint2*>(Ms);
  for (int r = 0; r < reps; ++r) {
    // B fragments: thread (grp, tid) holds k = 16 kc + 2 tid (+1, +8, +9)
    // of lane base + 8 nt + grp; zero past the depth and past the lanes.
    unsigned bf[S::kTiles][kNTiles][2];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const int n = base + nt * 8 + grp;
      auto val = [&](int k) {
        return (n < lanes && k < D) ? v[k * sL + n] + static_cast<float>(r)
                                    : 0.f;
      };
#pragma unroll
      for (int kc = 0; kc < S::kTiles; ++kc) {
        const int k0 = kc * 16 + 2 * tid;
        bf[kc][nt][0] = pack_bf16(val(k0), val(k0 + 1));
        bf[kc][nt][1] = pack_bf16(val(k0 + 8), val(k0 + 9));
      }
    }
    for (int k0 = 0; k0 < L; k0 += chunk) {
      const int n = L - k0 < chunk ? L - k0 : chunk;
      __syncthreads();
      const uint2* src = src8 + static_cast<size_t>(k0) * kPieces;
      for (int e = threadIdx.x; e < n * kPieces; e += blockDim.x) {
        const int m = e / kPieces, w = e % kPieces;
        const int row = w / kQuads, q = w % kQuads;
        copy8_async(ms + m * S::kElems + row * S::kStride + 4 * q, src + e);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
#pragma unroll 1
      for (int k = 0; k < n; ++k) {
        const __nv_bfloat16* mk =
            ms + k * S::kElems + (tl & 15) * S::kStride + (tl >> 4) * 8;
#pragma unroll
        for (int mt = 0; mt < S::kTiles; ++mt) {
          float acc[kNTiles][4] = {};
#pragma unroll
          for (int kc = 0; kc < S::kTiles; ++kc) {
            unsigned a[4];
            ldmatrix_x4(a, mk + mt * 16 * S::kStride + kc * 16);
#pragma unroll
            for (int nt = 0; nt < kNTiles; ++nt) mma_bf16(acc[nt], a, bf[kc][nt]);
          }
#pragma unroll
          for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              sum[mt][nt][q] = sum[mt][nt][q] + acc[nt][q];
        }
      }
    }
  }
  // Thread (grp, tid) holds rows 16 mt + grp (q 0, 1) and + 8 (q 2, 3) of
  // lanes base + 8 nt + 2 tid (q even) and + 1 (q odd).
#pragma unroll
  for (int mt = 0; mt < S::kTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = mt * 16 + grp + (q >> 1) * 8;
        const int n = base + nt * 8 + 2 * tid + (q & 1);
        if (row < D && n < lanes) out[row * sL + n] = sum[mt][nt][q];
      }
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
  // bf16 on the tensor cores (staged bf16, padded), float32 on the CUDA
  // cores (staged float32).
  const int per = BF16 ? MmaShape<D>::kElems * 2 : D * D * 4;
  int chunk = kChunkBytes / per;
  if (chunk > L) chunk = L;
  const size_t smem = static_cast<size_t>(chunk) * per;
  void (*kernel)(const Mat<BF16>*, const float*, float*, int, int, int,
                 int);
  if constexpr (BF16)
    kernel = dot_independent_mma_kernel<D>;
  else
    kernel = dot_independent_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = BF16 ? kMmaBlock : kBlock;
  kernel<<<(lanes + threads - 1) / threads, threads, smem, s>>>(
      mat, vec, out, L, lanes, reps, chunk);
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
