// Chunked Mamba2 SSD scan (selective state space, "state space duality")
// on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py:ssd_scan (body
// _ssd_kernel). It computes the same function, the recurrence
//
//   h_t = exp(log_a_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
//
// per (batch row b, head h), with x [B, S, H, HD], dt and log_a [B, S, H]
// f32, Bm and Cm [B, S, N] shared by all heads, the state h [HD, N] f32 and
// y [B, S, H, HD] in x's dtype. Every product and every decay is f32.
//
// Design. The Pallas grid runs (b, h, chunk) with the chunk axis
// sequential and h in VMEM scratch. Here one block owns one (b, h) and
// loops over the chunks in order (448 blocks at Zamba2-7B's training shape,
// B 4 x H 112), with the state kept in shared memory for the whole loop.
// Per chunk of kChunk = 64 rows (the kernel's own choice: y is the same
// function for any chunk length), in f32:
//
//   cum_i  = sum_{l <= i} log_a_l          (one warp's shuffle scan)
//   S_ij   = (C_i . B_j) exp(cum_i - cum_j) dt_j   for j <= i, else 0
//   y_i    = sum_j S_ij x_j + exp(cum_i) (C_i . h)
//   h     <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
//
// The mask is tested before the exp: above the diagonal cum_i - cum_j is
// positive and its exp could overflow to inf, and inf * 0 is NaN. On the
// diagonal and below it the exponent is <= 0 for a decaying model, so exp
// underflows to 0 (log decays reach about -45 within a chunk at dt ~ 0.7),
// never to NaN. A ragged tail is handled by bounds: rows past S load as
// x = B = C = dt = log_a = 0, so they add nothing, and their y is not
// stored. There is no padded copy.
//
// Each of the four products is an outer-product tile loop over operands
// laid out K-major in shared memory (x [L][HD], B [L][N] and B^T [N][L],
// C^T [N][L], S^T [L][L], h^T [N][HD]), a 4 x 4 tile of f32 accumulators
// per thread where the shape allows, float4 shared-memory reads.
//
// Bound. At the training shape (B 4, S 1024, H 112, HD 64, N 64, bf16 x, B
// and C) the function moves about 122 MB (x and y in bf16, dt and log_a in
// f32, B and C once), 0.036 ms at 3.35 TB/s. Its operations: C B^T below
// the diagonal once per batch row and chunk (the same for every head), on
// bf16 tensor cores at 989 TFLOP/s; per head the decayed S x below the
// diagonal, C h^T and the state update in f32 at 67 TFLOP/s. At the chunk
// length that needs the fewest (8) that is about 8.0 GFLOP, 0.12 ms, so
// the operations bound it; at this kernel's chunk of 64, 9.5 GFLOP. This
// first kernel uses no tensor cores, no TMA and computes C B^T once per
// head; those three are the known remedies (PERF.md has its times).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;     // rows per chunk
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Thread tiling of an [M, NN] output: each thread owns TM consecutive rows
// and TN consecutive columns; USED threads (at most kThreads) take part.
template <int M, int NN>
struct Tile {
  static constexpr int TN = NN < 4 ? NN : 4;
  static constexpr int COLS = NN / TN;
  static constexpr int TM0 = M * NN / (kThreads * TN);
  static constexpr int TM = TM0 < 1 ? 1 : (TM0 > 4 ? 4 : TM0);
  static constexpr int ROWS = M / TM;
  static constexpr int USED = ROWS * COLS;
  static_assert(NN % TN == 0 && M % TM == 0, "tile does not divide");
  static_assert(USED <= kThreads, "output too large for one block");
};

// T consecutive floats of shared memory; float4 reads when T % 4 == 0 (the
// callers keep those addresses 16-byte aligned)
template <int T>
__device__ __forceinline__ void lds(const float* p, float (&out)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int i = 0; i < T; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) out[i] = p[i];
  }
}

// acc[i][j] += sum_k A[k][r0 + i] * s[k] * B[k][c0 + j], A [K][M] and B
// [K][NN] K-major in shared memory; s is a per-k scale (nullptr: 1).
template <int M, int NN, int K>
__device__ __forceinline__ void tile_mm(
    const float* A, const float* B, const float* s, int r0, int c0,
    float (&acc)[Tile<M, NN>::TM][Tile<M, NN>::TN]) {
  using Tl = Tile<M, NN>;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[Tl::TM], bv[Tl::TN];
    lds<Tl::TM>(A + k * M + r0, a);
    lds<Tl::TN>(B + k * NN + c0, bv);
    if (s != nullptr) {
      const float sk = s[k];
#pragma unroll
      for (int i = 0; i < Tl::TM; ++i) a[i] *= sk;
    }
#pragma unroll
    for (int i = 0; i < Tl::TM; ++i) {
#pragma unroll
      for (int j = 0; j < Tl::TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
}

template <int HD, int N>
constexpr int smem_floats() {
  return kChunk * HD + 3 * kChunk * N + kChunk * kChunk + N * HD + 3 * kChunk;
}

template <typename T, int HD, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ la, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y, int S, int H) {
  constexpr int L = kChunk;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // x       [L][HD]
  float* bs = xs + L * HD;     // B       [L][N]
  float* bt = bs + L * N;      // B^T     [N][L]
  float* ct = bt + N * L;      // C^T     [N][L]
  float* st = ct + N * L;      // S^T     [L][L]: st[j * L + i] = S_ij
  float* ht = st + L * L;      // h^T     [N][HD]
  float* cum = ht + N * HD;    // [L] running sum of log_a within the chunk
  float* wv = cum + L;         // [L] exp(cum_last - cum_j) dt_j
  float* dts = wv + L;         // [L] dt_j

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long xrow = static_cast<long long>(H) * HD;  // x / y row stride
  const T* xb = x + static_cast<long long>(b) * S * xrow + h * HD;
  T* yb = y + static_cast<long long>(b) * S * xrow + h * HD;
  const float* dtb = dt + static_cast<long long>(b) * S * H + h;
  const float* lab = la + static_cast<long long>(b) * S * H + h;
  const T* Bb = Bm + static_cast<long long>(b) * S * N;
  const T* Cb = Cm + static_cast<long long>(b) * S * N;

  for (int i = tid; i < N * HD; i += kThreads) ht[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += L) {
    const int rows = min(L, S - s0);
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < L * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      xs[i] = r < rows ? to_f32(xb[(s0 + r) * xrow + c]) : 0.f;
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int r = i / N, c = i % N;
      float bv = 0.f, cv = 0.f;
      if (r < rows) {
        bv = to_f32(Bb[static_cast<long long>(s0 + r) * N + c]);
        cv = to_f32(Cb[static_cast<long long>(s0 + r) * N + c]);
      }
      bs[i] = bv;
      bt[c * L + r] = bv;
      ct[c * L + r] = cv;
    }
    if (tid < 32) {  // cum: each lane sums two rows, then a warp scan
      const int r = 2 * tid;
      float a0 = 0.f, a1 = 0.f, d0 = 0.f, d1 = 0.f;
      if (r < rows) {
        a0 = lab[static_cast<long long>(s0 + r) * H];
        d0 = dtb[static_cast<long long>(s0 + r) * H];
      }
      if (r + 1 < rows) {
        a1 = lab[static_cast<long long>(s0 + r + 1) * H];
        d1 = dtb[static_cast<long long>(s0 + r + 1) * H];
      }
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(kFull, incl, off);
        if (tid >= off) incl += t;
      }
      const float c0 = (incl - pair) + a0;
      cum[r] = c0;
      cum[r + 1] = c0 + a1;
      dts[r] = d0;
      dts[r + 1] = d1;
    }
    __syncthreads();
    const float total = cum[L - 1];
    if (tid < L) wv[tid] = expf(total - cum[tid]) * dts[tid];

    {  // S^T: the masked, decayed C B^T, scaled by dt_j
      using Tl = Tile<L, L>;
      if (tid < Tl::USED) {
        const int r0 = (tid / Tl::COLS) * Tl::TM, c0 = (tid % Tl::COLS) * Tl::TN;
        float acc[Tl::TM][Tl::TN] = {};
        if (c0 <= r0 + Tl::TM - 1) {  // some j <= i in this tile
          tile_mm<L, L, N>(ct, bt, nullptr, r0, c0, acc);
        }
#pragma unroll
        for (int jj = 0; jj < Tl::TN; ++jj) {
          const int j = c0 + jj;
#pragma unroll
          for (int ii = 0; ii < Tl::TM; ++ii) {
            const int i = r0 + ii;
            // the mask before the exp: never exp of a positive exponent
            st[j * L + i] = j <= i ? acc[ii][jj] * expf(cum[i] - cum[j]) * dts[j]
                                   : 0.f;
          }
        }
      }
    }
    __syncthreads();
    {  // y = S x + exp(cum) (C h^T)
      using Tl = Tile<L, HD>;
      if (tid < Tl::USED) {
        const int r0 = (tid / Tl::COLS) * Tl::TM, c0 = (tid % Tl::COLS) * Tl::TN;
        float intra[Tl::TM][Tl::TN] = {}, inter[Tl::TM][Tl::TN] = {};
        tile_mm<L, HD, L>(st, xs, nullptr, r0, c0, intra);
        tile_mm<L, HD, N>(ct, ht, nullptr, r0, c0, inter);
#pragma unroll
        for (int ii = 0; ii < Tl::TM; ++ii) {
          const int i = r0 + ii;
          if (i < rows) {
            const float e = expf(cum[i]);
            T* out = yb + (s0 + i) * xrow + c0;
#pragma unroll
            for (int jj = 0; jj < Tl::TN; ++jj) {
              out[jj] = from_f32<T>(fmaf(e, inter[ii][jj], intra[ii][jj]));
            }
          }
        }
      }
    }
    __syncthreads();  // every read of the entering state is done
    {  // h^T <- exp(total) h^T + sum_j B_j^T w_j x_j
      using Tl = Tile<N, HD>;
      if (tid < Tl::USED) {
        const int r0 = (tid / Tl::COLS) * Tl::TM, c0 = (tid % Tl::COLS) * Tl::TN;
        float acc[Tl::TM][Tl::TN] = {};
        tile_mm<N, HD, L>(bs, xs, wv, r0, c0, acc);
        const float decay = expf(total);
#pragma unroll
        for (int ii = 0; ii < Tl::TM; ++ii) {
#pragma unroll
          for (int jj = 0; jj < Tl::TN; ++jj) {
            float* p = ht + (r0 + ii) * HD + c0 + jj;
            *p = fmaf(decay, *p, acc[ii][jj]);
          }
        }
      }
    }
  }
}

template <typename T, int HD, int N>
int launch(const void* x, const void* dt, const void* la, const void* Bm,
           const void* Cm, void* y, int B, int S, int H, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD, N>() * static_cast<int>(sizeof(float));
  auto* kernel = ssd_scan_kernel<T, HD, N>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(H, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(la), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), S, H);
  return 0;
}

template <typename T>
int launch_widths(int hd, int n, const void* x, const void* dt, const void* la,
                  const void* Bm, const void* Cm, void* y, int B, int S, int H,
                  cudaStream_t st) {
  if (hd == 64 && n == 64) return launch<T, 64, 64>(x, dt, la, Bm, Cm, y, B, S, H, st);
  if (hd == 16 && n == 16) return launch<T, 16, 16>(x, dt, la, Bm, Cm, y, B, S, H, st);
  if (hd == 16 && n == 4) return launch<T, 16, 4>(x, dt, la, Bm, Cm, y, B, S, H, st);
  if (hd == 8 && n == 16) return launch<T, 8, 16>(x, dt, la, Bm, Cm, y, B, S, H, st);
  if (hd == 8 && n == 4) return launch<T, 8, 4>(x, dt, la, Bm, Cm, y, B, S, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x / y [B, S, H, hd] and Bm / Cm [B, S, n] bf16 (is_bf16 = 1) or f32, dt /
// la [B, S, H] f32, all contiguous. (hd, n) is one of (64, 64), (16, 16),
// (16, 4), (8, 16), (8, 4). Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success); the caller raises on
// anything else.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* la,
                               const void* Bm, const void* Cm, void* y, int B,
                               int S, int H, int hd, int n, int is_bf16,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = is_bf16
      ? launch_widths<__nv_bfloat16>(hd, n, x, dt, la, Bm, Cm, y, B, S, H, st)
      : launch_widths<float>(hd, n, x, dt, la, Bm, Cm, y, B, S, H, st);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
