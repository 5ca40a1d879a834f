// Dequantizing GEMM: the int8 feature-cache tier's leading product on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/dequant_matmul.py:
// dequant_matmul_fwd (body _dqmm_kernel). It computes the same function:
//   out[m, n] = sum_k (f32(q[m, k]) * s(m, k)) * f32(w[k, n])
// with q [M, K] int8, f32 or bf16, w [K, N] f32 or bf16, and an f32 scale
// in one of three layouts: row s[m] ([M, 1]), col s[k] ([1, K]) or full
// s[m * K + k] ([M, K]). Products accumulate in f32; out is f32 or bf16,
// written once.
//
// Numerics. TF32 is off in the port and the dequantized operand is an f32
// product, so the multiply-adds are f32 FMAs on the CUDA cores, not bf16 or
// TF32 tensor-core products, which would round the operand. Each f32(q) * s
// is rounded once, as the plain version's materialized q.float() * scale
// is; only the order of the sum differs from the plain version.
//
// Design. The Pallas kernel walks the K axis on a sequential grid with an
// f32 VMEM accumulator. Here:
//  * dequant_matmul_kernel: one block per 32 x 64 output tile and K slice,
//    128 threads with a 4 x 4 register tile each, four blocks an SM. Every
//    32-deep k step stages the q tile into shared memory already widened
//    and scaled (the dequantized operand never exists in device memory,
//    which is the point of the kernel) and the w tile widened to f32; the
//    next step's loads are in flight in registers while this step's
//    products run.
//  * Split K. The slice's shape is skinny (M 32, K 16,384, N 512): its
//    M x N tile grid is 8 blocks for 132 SMs, so the host splits K into
//    slices (a plan that depends on M, N, K and the SM count only) and each
//    block writes its f32 partial tile to a workspace.
//  * splitk_reduce_kernel: sums the partials in slice order and writes out
//    in its dtype. No atomics: a rerun gives equal bits. With one slice and
//    an f32 out the first kernel writes out directly.
//  * M, N and K are runtime bounds. Tails are masked by bounds checks
//    (out-of-range elements stage as 0); nothing is padded.
//
// Bound. At the slice's shape w dominates the bytes (33.5 MB of f32 against
// 0.5 MB of q), 10.2 us at 3.35 TB/s, and the 0.537 GFLOP take 8.0 us at
// the 67 TFLOP/s f32 peak: bytes bound it, and each w element is read once
// (one M tile). With bf16 w the operations bound it. PERF.md has the times.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 32;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // blocks an SM holds: at most 128 registers
constexpr int kTM = 4;  // rows of a thread's output tile
constexpr int kTN = 4;  // columns of a thread's output tile
constexpr int kReduceThreads = 256;
constexpr long long kMaxReduceBlocks = 1LL << 16;

enum ScaleKind { kRow = 0, kCol = 1, kFull = 2 };
enum QType { kQInt8 = 0, kQF32 = 1, kQBF16 = 2 };
enum WType { kWF32 = 0, kWBF16 = 1 };
enum OType { kOF32 = 0, kOBF16 = 1 };

static_assert(kBM * kBK % kThreads == 0, "q tile loads");
static_assert(kBK * kBN % kThreads == 0, "w tile loads");
static_assert((kBM / kTM) * (kBN / kTN) == kThreads, "thread tiles");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename QT, typename WT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) dequant_matmul_kernel(
    const QT* __restrict__ q, const float* __restrict__ scale,
    int scale_kind, const WT* __restrict__ w, float* __restrict__ dst,
    int M, int N, int K, int k_per_split) {
  __shared__ float as[kBM][kBK + 1];            // dequantized q, [m][k]
  __shared__ __align__(16) float bs[kBK][kBN];  // widened w, [k][n]
  constexpr int kQLoads = kBM * kBK / kThreads;
  constexpr int kWLoads = kBK * kBN / kThreads;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  const long long k_begin = static_cast<long long>(blockIdx.z) * k_per_split;
  const long long k_end =
      k_begin + k_per_split < K ? k_begin + k_per_split : K;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  // The next k step's tiles are loaded into registers (dequantized and
  // widened on the way) while the current step's products run.
  float qr[kQLoads];
  float wr[kWLoads];
  auto load = [&](long long k0) {
    // q tile, k fastest: a warp reads 32 consecutive elements of one row
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int idx = tid + i * kThreads;
      const long long m = m0 + idx / kBK;
      const long long k = k0 + idx % kBK;
      float v = 0.f;
      if (m < M && k < k_end) {
        const float s = scale_kind == kRow   ? scale[m]
                        : scale_kind == kCol ? scale[k]
                                             : scale[m * K + k];
        v = widen(q[m * K + k]) * s;
      }
      qr[i] = v;
    }
    // w tile, n fastest
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kThreads;
      const long long k = k0 + idx / kBN;
      const long long n = n0 + idx % kBN;
      wr[i] = (k < k_end && n < N) ? widen(w[k * N + n]) : 0.f;
    }
  };

  if (k_begin < k_end) load(k_begin);
  for (long long k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kQLoads; ++i) {
      const int idx = tid + i * kThreads;
      as[idx / kBK][idx % kBK] = qr[i];
    }
#pragma unroll
    for (int i = 0; i < kWLoads; ++i) {
      const int idx = tid + i * kThreads;
      bs[idx / kBN][idx % kBN] = wr[i];
    }
    __syncthreads();
    if (k0 + kBK < k_end) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = as[ty * kTM + i][kk];
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tx * kTN]);
      const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  float* part = dst + static_cast<long long>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long m = m0 + ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const long long n = n0 + tx * kTN + j;
      if (m < M && n < N) part[m * N + n] = acc[i][j];
    }
  }
}

// out[i] = ws[i] + ws[mn + i] + ... in slice order, written in OT.
template <typename OT>
__global__ void __launch_bounds__(kReduceThreads) splitk_reduce_kernel(
    const float* __restrict__ ws, OT* __restrict__ out, long long mn,
    int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < mn; i += stride) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[z * mn + i];
    store(out + i, s);
  }
}

template <typename QT, typename WT>
void launch_gemm(const void* q, const void* scale, int scale_kind,
                 const void* w, float* dst, int M, int N, int K, int splits,
                 int k_per_split, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  dequant_matmul_kernel<QT, WT><<<grid, kThreads, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const float*>(scale),
      scale_kind, static_cast<const WT*>(w), dst, M, N, K, k_per_split);
}

template <typename QT>
void launch_gemm_w(const void* q, const void* scale, int scale_kind,
                   const void* w, int w_type, float* dst, int M, int N,
                   int K, int splits, int k_per_split, cudaStream_t stream) {
  if (w_type == kWF32) {
    launch_gemm<QT, float>(q, scale, scale_kind, w, dst, M, N, K, splits,
                           k_per_split, stream);
  } else {
    launch_gemm<QT, __nv_bfloat16>(q, scale, scale_kind, w, dst, M, N, K,
                                   splits, k_per_split, stream);
  }
}

}  // namespace

// q_type: 0 int8, 1 f32, 2 bf16; w_type: 0 f32, 1 bf16; out_type: 0 f32,
// 1 bf16; scale_kind: 0 row, 1 col, 2 full. ws holds splits * M * N f32
// partials; it is unused (may be null) when splits == 1 and out is f32.
// k_per_split is a multiple of 32 and splits * k_per_split covers K.
// Launches on `stream` and returns cudaGetLastError() as an int (0 on
// success); the caller raises on anything else.
extern "C" int dequant_matmul_launch(const void* q, int q_type,
                                     const void* scale, int scale_kind,
                                     const void* w, int w_type, void* ws,
                                     void* out, int out_type, int M, int N,
                                     int K, int splits, int k_per_split,
                                     void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || k_per_split <= 0 ||
      k_per_split % kBK != 0 ||
      static_cast<long long>(splits) * k_per_split < K ||
      (M + kBM - 1) / kBM > 65535 || splits > 65535 || q_type < 0 ||
      q_type > 2 || w_type < 0 || w_type > 1 || out_type < 0 ||
      out_type > 1 || scale_kind < 0 || scale_kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool direct = splits == 1 && out_type == kOF32;
  float* dst = static_cast<float*>(direct ? out : ws);
  if (dst == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (q_type) {
    case kQInt8:
      launch_gemm_w<int8_t>(q, scale, scale_kind, w, w_type, dst, M, N, K,
                            splits, k_per_split, st);
      break;
    case kQF32:
      launch_gemm_w<float>(q, scale, scale_kind, w, w_type, dst, M, N, K,
                           splits, k_per_split, st);
      break;
    default:
      launch_gemm_w<__nv_bfloat16>(q, scale, scale_kind, w, w_type, dst, M,
                                   N, K, splits, k_per_split, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || direct) {
    return static_cast<int>(err);
  }
  const long long mn = static_cast<long long>(M) * N;
  long long blocks = (mn + kReduceThreads - 1) / kReduceThreads;
  if (blocks > kMaxReduceBlocks) blocks = kMaxReduceBlocks;
  if (out_type == kOF32) {
    splitk_reduce_kernel<float>
        <<<static_cast<unsigned>(blocks), kReduceThreads, 0, st>>>(
            static_cast<const float*>(ws), static_cast<float*>(out), mn,
            splits);
  } else {
    splitk_reduce_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kReduceThreads, 0, st>>>(
            static_cast<const float*>(ws),
            static_cast<__nv_bfloat16*>(out), mn, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dequant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
