// Causal / full GQA flash attention forward on Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd (body _flash_fwd_kernel). It computes the same
// function: o = softmax(scale * q k^T [causal mask]) v per (batch, q head),
// with q [B, S, Hq, D], k and v [B, S, Hkv, D], Hq % Hkv == 0, and each q
// head h reading kv head h / (Hq / Hkv), as the Pallas index maps do, so kv
// is never repeated in memory. Scores are f32 and scaled in f32; the
// running max m, denominator l and accumulator stay f32; l is clamped at
// 1e-30; the output is written in the input dtype. Masked scores are
// -1e30, as in the reference.
//
// Design. The Pallas grid walks the kv blocks sequentially with m, l and
// the accumulator in VMEM scratch. Here that axis is a loop inside one
// block: a block owns (one 64-row query tile, one q head, one batch row),
// stages each kv tile in shared memory, and keeps m, l and the
// accumulator in registers across the loop. The loop stops at the causal
// limit (the pl.when skip of the reference) and at the end of the
// sequence; a ragged tail is masked by bounds (zero-filled tiles, masked
// columns, unstored rows), with no padded copy.
//
//  * bf16: four warps, 16 query rows each. q k^T and p v run on the tensor
//    cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The Pallas
//    kernel computes p v in f32; here p is split into two bf16 terms, hi =
//    bf16(p) and lo = bf16(p - hi), and p v is two products, so p keeps
//    about 16 bits and the output stays within one bf16 rounding of the
//    f32 plain version. 64-row kv tiles.
//  * f32: true f32 on the CUDA cores (TF32 stays off, as in the rest of
//    the port). Two threads per query row, each holding half the head dim
//    of q and of the accumulator; 32-row kv tiles.
//
// Head dims 16, 32, 64, 80 (hubert-xlarge), 112 (Zamba2-7B's shared
// attention) and 128. Each is a multiple of 16, so the bf16 path's D / 16
// k-steps and D / 8 accumulator tiles are whole (d 80: 5 and 10); nothing
// assumes a power of two (the tile loaders divide by D / 8 or D / 4 16-byte
// vectors a row, and 80 or 112 bf16 or f32 values are a whole number of
// 16-byte vectors, so every row stays 16-byte aligned; the padded shared
// row of D + 8 bf16 values keeps the fragment reads free of bank conflicts
// at both).
//
// Bound. Causal attention needs 4 * B * Hq * D * S (S + 1) / 2 flops and
// moves q, k, v and o once: at the Llama-3-8B training shape (B 4, S 1024,
// Hq 32, Hkv 8, D 128, bf16) that is 34.4 GFLOP against 84 MB, so the
// tensor cores bound it (0.035 ms at 989 TFLOP/s). This first kernel
// uses mma.sync with plain shared-memory staging (no TMA, no wgmma, no
// pipelining), and its split p v issues half again the products the
// function needs, so it runs well below that bound; PERF.md has its times.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kThreads = 128;
constexpr int kTileBf16 = 64;  // kv rows per tile, bf16 path
constexpr int kTileF32 = 32;   // kv rows per tile, f32 path
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as two packed bf16 pairs: hi = bf16(x, y) and lo = bf16 of what
// hi misses (exact in f32), so hi + lo carries about 16 bits of each
__device__ __forceinline__ void pack_split(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float2 hf = __bfloat1622float2(h);
  lo = pack_f32(x - hf.x, y - hf.y);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c += a (16x16 bf16, row major) * b (16x8 bf16, column major), f32 sums.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// kv tiles a query tile needs: up to the causal limit, at most the sequence
__device__ __forceinline__ int kv_tiles(int S, int q_tile, int tile,
                                        int causal) {
  int n = (S + tile - 1) / tile;
  if (causal) {
    n = min(n, (q_tile * kBlockQ + kBlockQ - 1) / tile + 1);
  }
  return n;
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * gid + tig):
//   A: reg0 (row gid, cols 2tig..+1), reg1 (row gid+8, same cols),
//      reg2 (row gid, cols 2tig+8..+9), reg3 (row gid+8, cols 2tig+8..+9)
//   B: reg0 (k 2tig..+1, col gid), reg1 (k 2tig+8..+9, col gid)
//   C: c0, c1 (row gid, cols 2tig..+1), c2, c3 (row gid+8, same cols)
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int S, int Hq, int Hkv, float scale, int causal) {
  constexpr int kStride = D + 8;  // padded rows: conflict-free fragment reads
  constexpr int kVec = D / 8;     // 16-byte vectors per row
  constexpr int kN = kTileBf16 / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kTileBf16 * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kTileBf16 * kStride];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<long long>(b) * S * q_stride + h * D;
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * S * kv_stride + hk * D;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * S * kv_stride + hk * D;
  __nv_bfloat16* ob = o + static_cast<long long>(b) * S * q_stride + h * D;
  const int r0 = qt * kBlockQ + warp * 16 + gid;
  const int r1 = r0 + 8;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * tig;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(qb + r0 * q_stride + c);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(qb + r1 * q_stride + c);
    qf[kk][0] = r0 < S ? p0[0] : 0u;
    qf[kk][1] = r1 < S ? p1[0] : 0u;
    qf[kk][2] = r0 < S ? p0[4] : 0u;
    qf[kk][3] = r1 < S ? p1[4] : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int n_tiles = kv_tiles(S, qt, kTileBf16, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTileBf16;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kTileBf16 * kVec; i += kThreads) {
      const int r = i / kVec, c = (i % kVec) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kv_stride + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(ks + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * kStride + c) = vv;
    }
    __syncthreads();

    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kp = ks + (n * 8 + gid) * kStride + kk * 16 + 2 * tig;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(kp);
        bf[1] = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_16816(s[n], qf[kk], bf);
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * tig + (e & 1);
        const int row = e < 2 ? r0 : r1;
        float x = s[n][e] * scale;
        if (col >= S || (causal && col > row)) {
          x = kNegInf;
        }
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + quad_sum(sum0);
    l1 = l1 * corr1 + quad_sum(sum1);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= corr0;
      acc[i][1] *= corr0;
      acc[i][2] *= corr1;
      acc[i][3] *= corr1;
    }

#pragma unroll
    for (int kk = 0; kk < kTileBf16 / 16; ++kk) {
      uint32_t pa[4], pl[4];
      pack_split(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
      pack_split(s[2 * kk][2], s[2 * kk][3], pa[1], pl[1]);
      pack_split(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
      pack_split(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pl[3]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const __nv_bfloat16* vp = vs + (kk * 16 + 2 * tig) * kStride + i * 8 + gid;
        uint32_t bf[2];
        bf[0] = pack_raw(vp[0], vp[kStride]);
        bf[1] = pack_raw(vp[8 * kStride], vp[9 * kStride]);
        mma_16816(acc[i], pa, bf);
        mma_16816(acc[i], pl, bf);
      }
    }
  }

  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = i * 8 + 2 * tig;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_f32(acc[i][0] / l0, acc[i][1] / l0);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_f32(acc[i][2] / l1, acc[i][3] / l1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int Hq,
    int Hkv, float scale, int causal) {
  constexpr int kHalf = D / 2;
  constexpr int kVec = D / 4;  // 16-byte vectors per row
  __shared__ __align__(16) float ks[kTileF32 * D];
  __shared__ __align__(16) float vs[kTileF32 * D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int half = threadIdx.x & 1;
  const int row = qt * kBlockQ + (threadIdx.x >> 1);
  const long long q_stride = static_cast<long long>(Hq) * D;
  const long long kv_stride = static_cast<long long>(Hkv) * D;
  const float* qb = q + static_cast<long long>(b) * S * q_stride + h * D;
  const float* kb = k + static_cast<long long>(b) * S * kv_stride + hk * D;
  const float* vb = v + static_cast<long long>(b) * S * kv_stride + hk * D;
  float* ob = o + static_cast<long long>(b) * S * q_stride + h * D;

  float qr[kHalf], acc[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    qr[c] = row < S ? qb[row * q_stride + half * kHalf + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int n_tiles = kv_tiles(S, qt, kTileF32, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTileF32;
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF32 * kVec; i += kThreads) {
      const int r = i / kVec, c = (i % kVec) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const float4*>(kb + (k0 + r) * kv_stride + c);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * kv_stride + c);
      }
      *reinterpret_cast<float4*>(ks + r * D + c) = kv;
      *reinterpret_cast<float4*>(vs + r * D + c) = vv;
    }
    __syncthreads();

    float s[kTileF32];
    float mx = m;
#pragma unroll
    for (int t = 0; t < kTileF32; ++t) {
      const float* kp = ks + t * D + half * kHalf;
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        part = fmaf(qr[c], kp[c], part);
      }
      // both threads of the row add the same two halves: same sum
      const float other = __shfl_xor_sync(kFull, part, 1);
      float x = (half ? other + part : part + other) * scale;
      const int col = k0 + t;
      if (col >= S || (causal && col > row)) {
        x = kNegInf;
      }
      s[t] = x;
      mx = fmaxf(mx, x);
    }
    const float corr = expf(m - mx);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kTileF32; ++t) {
      s[t] = expf(s[t] - m);
      sum += s[t];
    }
    l = l * corr + sum;
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      acc[c] *= corr;
    }
#pragma unroll
    for (int t = 0; t < kTileF32; ++t) {
      const float* vp = vs + t * D + half * kHalf;
#pragma unroll
      for (int c = 0; c < kHalf; ++c) {
        acc[c] = fmaf(s[t], vp[c], acc[c]);
      }
    }
  }

  if (row < S) {
    l = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kHalf; ++c) {
      ob[row * q_stride + half * kHalf + c] = acc[c] / l;
    }
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int S, int Hq, int Hkv, float scale, int causal, int is_bf16,
            cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, Hq, B);
  if (is_bf16) {
    flash_fwd_bf16<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        S, Hq, Hkv, scale, causal);
  } else {
    flash_fwd_f32<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, Hq, Hkv,
        scale, causal);
  }
}

}  // namespace

// q/o [B, S, Hq, D], k/v [B, S, Hkv, D], contiguous, 16-byte aligned,
// bf16 (is_bf16 = 1) or f32. Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success); the caller raises on
// anything else.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int Hq, int Hkv, int D, float scale,
                                      int causal, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: launch<16>(q, k, v, o, B, S, Hq, Hkv, scale, causal, is_bf16, st); break;
    case 32: launch<32>(q, k, v, o, B, S, Hq, Hkv, scale, causal, is_bf16, st); break;
    case 64: launch<64>(q, k, v, o, B, S, Hq, Hkv, scale, causal, is_bf16, st); break;
    case 80: launch<80>(q, k, v, o, B, S, Hq, Hkv, scale, causal, is_bf16, st); break;
    case 112: launch<112>(q, k, v, o, B, S, Hq, Hkv, scale, causal, is_bf16, st); break;
    case 128: launch<128>(q, k, v, o, B, S, Hq, Hkv, scale, causal, is_bf16, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
