// Block-perturbation reduction: the pace controller's Eq. 2 norms on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/block_perturb.py:
// diff_sqnorm (body _diff_sq_kernel). It computes the same function:
// sum((a - b)^2) over two flat buffers of n elements, each operand widened
// to f32 on its own and subtracted in f32, in one pass that writes no diff.
// Operands are f32 or bf16, each independently: the pace controller diffs
// bf16 model leaves against its f32 snapshots.
//
// Numerics. The TPU kernel accumulates in f32. Here each f32 difference is
// widened to f64, squared (exactly: 24-bit mantissas) and summed in f64,
// as the reference's numpy observe does (repro/core/pace.py: np.square(v,
// dtype=np.float64) and np.sum). So the card's norms agree with the numpy
// path to about 1e-15 relative, and a finite f32 input cannot overflow the
// sum. NaN and inf propagate.
//
// Design. The Pallas grid walks row blocks in order with one scalar
// accumulator in VMEM scratch. Hopper runs blocks in parallel and in no
// order, so the sum is two kernels on one stream:
//  * diff_sqnorm_partial: a grid sized by n and the SM count only (the
//    wrapper's plan), a grid-stride loop with per-thread f64 accumulators,
//    then a warp shuffle and a block reduction into one f64 partial per
//    block;
//  * diff_sqnorm_final: one block sums the partials in a fixed order.
// Every thread sees the same elements in the same order from run to run,
// so the result repeats bit for bit. Indices are 64-bit: a Qwen2-72B
// freeze block has more than 2^31 elements.
//
// Alignment. A snapshot view at a leaf's offset inside a flat f32 buffer
// need not be 16-byte aligned, nor at the same element as its bf16
// partner. The host finds the first element h < 8 at which both operands
// are 16-byte aligned; the body then reads chunks of 8 elements (one
// 16-byte load of bf16, two of f32), and the h head and the short tail
// are scalar. Where no such h exists, every load is scalar (still
// coalesced, 4 in flight per thread).
//
// Bound. It does 3 operations per element (subtract, an f64 fused
// multiply-add) against 6-8 bytes read: device memory bounds it. The
// Llama-3-8B stage-0 block (1.745e9 elements, bf16 leaf against f32
// snapshot) is 10.5 GB, 3.1 ms at 3.35 TB/s. PERF.md has its times.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;   // elements per vector step
constexpr int kUnroll = 2;  // vector steps per thread per iteration
constexpr int kScalarUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 consecutive elements at a 16-byte aligned address, widened to f32
__device__ __forceinline__ void load8(const float* p, float out[kChunk]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
  out[4] = v.x; out[5] = v.y; out[6] = v.z; out[7] = v.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float out[kChunk]) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // a bf16 is the top half of an f32: widening is a shift
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// acc + (x - y)^2: the difference in f32, its square and the sum in f64
__device__ __forceinline__ double add_sq(double acc, float x, float y) {
  const double d = static_cast<double>(x - y);
  return fma(d, d, acc);
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(kFull, x, off);
  }
  return x;
}

// The block's sum in a fixed order: shuffles within each warp, then warp 0's
// thread 0 adds the warps' sums in order. Returns it on thread 0.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_part[kWarps];
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) {
    warp_part[threadIdx.x >> 5] = x;
  }
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += warp_part[w];
    }
  }
  return s;
}

template <typename TA, typename TB, bool kVec>
__global__ void __launch_bounds__(kThreads) diff_sqnorm_partial(
    const TA* __restrict__ a, const TB* __restrict__ b, long long n,
    int head, double* __restrict__ partials) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  double acc = 0.0;
  if (kVec) {
    // elements [0, head) and [tail0, n) are scalar; [head, tail0) chunks
    const long long n_chunks = (n - head) / kChunk;
    const long long tail0 = head + n_chunks * kChunk;
    if (tid < head) {
      acc = add_sq(acc, widen(a[tid]), widen(b[tid]));
    }
    if (tid < n - tail0) {
      acc = add_sq(acc, widen(a[tail0 + tid]), widen(b[tail0 + tid]));
    }
    const TA* ac = a + head;
    const TB* bc = b + head;
    long long c = tid;
    for (; c + (kUnroll - 1) * stride < n_chunks; c += kUnroll * stride) {
      float x[kUnroll][kChunk], y[kUnroll][kChunk];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load8(ac + (c + u * stride) * kChunk, x[u]);
        load8(bc + (c + u * stride) * kChunk, y[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          acc = add_sq(acc, x[u][e], y[u][e]);
        }
      }
    }
    for (; c < n_chunks; c += stride) {
      float x[kChunk], y[kChunk];
      load8(ac + c * kChunk, x);
      load8(bc + c * kChunk, y);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        acc = add_sq(acc, x[e], y[e]);
      }
    }
  } else {
    long long i = tid;
    for (; i + (kScalarUnroll - 1) * stride < n; i += kScalarUnroll * stride) {
      float x[kScalarUnroll], y[kScalarUnroll];
#pragma unroll
      for (int u = 0; u < kScalarUnroll; ++u) {
        x[u] = widen(a[i + u * stride]);
        y[u] = widen(b[i + u * stride]);
      }
#pragma unroll
      for (int u = 0; u < kScalarUnroll; ++u) {
        acc = add_sq(acc, x[u], y[u]);
      }
    }
    for (; i < n; i += stride) {
      acc = add_sq(acc, widen(a[i]), widen(b[i]));
    }
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads) diff_sqnorm_final(
    const double* __restrict__ partials, int count, double* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    acc += partials[i];
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) {
    out[0] = s;
  }
}

template <typename TA, typename TB>
void launch_partial(const void* a, const void* b, long long n, int head,
                    int blocks, double* partials, cudaStream_t stream) {
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  if (head >= 0) {
    diff_sqnorm_partial<TA, TB, true><<<blocks, kThreads, 0, stream>>>(
        pa, pb, n, head, partials);
  } else {
    diff_sqnorm_partial<TA, TB, false><<<blocks, kThreads, 0, stream>>>(
        pa, pb, n, 0, partials);
  }
}

// The first element at which both operands sit on a 16-byte boundary, or
// -1 when none of the first kChunk does (then no chunk of 8 is aligned in
// both, since a step of 8 elements keeps each operand's offset mod 16).
int common_head(const void* a, int a_size, const void* b, int b_size,
                long long n) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  for (int h = 0; h < kChunk && h <= n; ++h) {
    if ((pa + static_cast<uintptr_t>(h) * a_size) % 16 == 0 &&
        (pb + static_cast<uintptr_t>(h) * b_size) % 16 == 0) {
      return h;
    }
  }
  return -1;
}

}  // namespace

// a and b: n elements each, contiguous, f32 or bf16 (a_bf16, b_bf16 = 1 for
// bf16), any alignment of their element type. partials: `blocks` f64 of
// scratch; out: one f64, sum((a - b)^2). Launches both kernels on `stream`
// and returns cudaGetLastError() as an int (0 on success); the caller
// raises on anything else.
extern "C" int diff_sqnorm_launch(const void* a, int a_bf16, const void* b,
                                  int b_bf16, long long n, int blocks,
                                  void* partials, void* out, void* stream) {
  if (n <= 0 || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int head = common_head(a, a_bf16 ? 2 : 4, b, b_bf16 ? 2 : 4, n);
  double* part = static_cast<double*>(partials);
  if (a_bf16 && b_bf16) {
    launch_partial<__nv_bfloat16, __nv_bfloat16>(a, b, n, head, blocks, part, st);
  } else if (a_bf16) {
    launch_partial<__nv_bfloat16, float>(a, b, n, head, blocks, part, st);
  } else if (b_bf16) {
    launch_partial<float, __nv_bfloat16>(a, b, n, head, blocks, part, st);
  } else {
    launch_partial<float, float>(a, b, n, head, blocks, part, st);
  }
  diff_sqnorm_final<<<1, kThreads, 0, st>>>(part, blocks,
                                             static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* diff_sqnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
