// Sparse cohort scatter-add: the compressed-uplink Eq. 1 fold on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_agg.py:
// sparse_cohort_add_fwd (body _sparse_agg_kernel). It computes the same
// function: a dense [L] f32 output equal to sum_i w[i] * scatter(idx[i],
// vals[i]) over K clients' top-k rows, idx [K, k] int32, vals [K, k] f32,
// w [K] f32. Duplicate indices accumulate, within a row and across rows.
//
// Design. The TPU kernel walks the cohort on a sequential grid with the
// whole output resident in VMEM, which is what makes its duplicates safe
// without atomics. Hopper runs blocks in parallel and in no order, so here
// each thread takes one (client, entry) pair t and does
// atomicAdd(out + idx[t], w[t / k] * vals[t]) into an output the wrapper
// zeroed with torch.zeros on the same stream. There is no residency limit
// on the card, so every leaf length goes through this kernel; the
// reference's MAX_VMEM_ELEMS dispatch rule has no counterpart.
//
// Bound. The kernel is bound by memory: it reads K*k*8 bytes of
// (idx, vals), the wrapper's zeroing writes L*4 bytes, and it performs
// K*k atomic read-modify-writes, which mostly hit L2 (a ResNet-18 leaf is
// at most 9.4 MB of f32, well inside the 50 MB L2). Atomics make the
// summation order vary from run to run, so the result is allclose to the
// plain version (repro_torch/kernels/ref.py), not bitwise equal.
//
// Indices outside [0, L) are dropped rather than written, so a bad index
// cannot corrupt memory; the engine's indices come from top-k and are
// always in range.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;

__global__ void __launch_bounds__(kThreads) sparse_cohort_add_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ vals,
    const float* __restrict__ w, float* __restrict__ out, long long n,
    int k, long long length) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n; t += stride) {
    const long long at = idx[t];
    if (at >= 0 && at < length) {
      atomicAdd(out + at, w[t / k] * vals[t]);
    }
  }
}

}  // namespace

// n = K * k entries. Launches on `stream` and returns cudaGetLastError()
// as an int (0 on success); the caller raises on anything else.
extern "C" int sparse_cohort_add_launch(const void* idx, const void* vals,
                                        const void* w, void* out,
                                        long long n, int k, long long length,
                                        void* stream) {
  if (n <= 0 || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  sparse_cohort_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<float*>(out), n, k, length);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sparse_cohort_add_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
