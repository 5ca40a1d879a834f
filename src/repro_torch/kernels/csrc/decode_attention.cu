// One-token GQA decode attention over a KV cache on Hopper (flash-decode).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:
// decode_attention (body _decode_kernel). It computes the same function:
// for each batch row b and q head h, o = softmax(scale * q k^T) v over the
// first length[b] cached rows, with q [B, Hq, D], k and v [B, S, Hkv, D],
// Hq % Hkv == 0 and q head h reading kv head h / (Hq / Hkv), as the Pallas
// index maps do. Scores, the running max m, the denominator l and the
// accumulator are f32; l is clamped at 1e-30; the output is written in the
// input dtype. A row with length 0 has nothing to attend to and comes out
// as exact zeros, as in the reference.
//
// Design. The Pallas grid walks the kv blocks of one (b, q head) in order
// and carries (m, l, acc) in VMEM scratch. On Hopper that one sequential
// walk would use at most B * Hq blocks; at the serving shape that is under
// two waves of small blocks with nothing else to hide memory latency. So
// the kv axis is split (split-KV, "flash-decode"):
//
//  * decode_split: grid (splits, Hkv * head chunks, B). A block owns one
//    range of cached rows of one kv head and serves all of that kv head's
//    q heads (up to kMaxGroup of them, a "head chunk"), so each K and V
//    row is read from device memory once per group, not once per q head.
//    Each lane group of a warp (D / 8 lanes for bf16, D / 4 for f32, one
//    16-byte vector per lane, rounded up to a power of two) takes one row
//    at a time, kUnroll rows per step with every load issued before any is
//    used, and keeps its own online softmax (m, l, acc) in registers. At
//    D = 112 (Zamba2-7B) a row is 14 vectors in bf16 and 28 in f32, so a
//    group is 16 or 32 lanes with 2 or 4 idle: they load nothing, add 0 to
//    the group's butterfly sum and store nothing, so the xor shuffles stay
//    inside an aligned power-of-two group. At the end the block merges
//    its lane groups through shared memory and writes one partial (m, l,
//    acc) per (q head, split) to an f32 workspace.
//  * decode_merge: grid (Hq, B). Merges the splits with a log-sum-exp
//    rescale and writes acc / max(l, 1e-30) in the input dtype.
//
// Rows at or past length[b] are never read: the ragged tail is handled by
// bounds, with no padded copy of the cache (the reference zero-pads the
// cache to its block size). A split whose range starts at or past
// length[b] writes m = -inf, l = 0 and exits; the merge skips such splits
// by a branch, never by multiplying garbage by exp(-inf) = 0, so an empty
// split or an empty row cannot make a NaN. The split count is chosen by the
// caller from the cache's allocated S and the SM count, never from length,
// which lives on the device.
//
// Bound. Each score is 2 D flops and each accumulate 2 D flops against
// 2 D elements of K and V read once per kv head, so the kernel does about
// 2 g flops per byte: device memory bounds it by far. At the Llama-3-8B
// serving shape (B 8, Hq 32, Hkv 8, D 128, bf16) a full 1024-row cache is
// 33.6 MB of K and V, 0.010 ms at 3.35 TB/s; at 32,768 rows 1.07 GB,
// 0.32 ms. This first kernel streams with plain 16-byte loads (no TMA, no
// cp.async ring); PERF.md has its times.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // rows per lane group per step
constexpr int kMaxGroup = 8;   // q heads a block serves at most
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of the cache or of q, widened to f32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const uint4& raw, float out[4]) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  __device__ __forceinline__ static float narrow(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& raw, float out[8]) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the top half of an f32: widening is a shift
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static __nv_bfloat16 narrow(float x) {
    return __float2bfloat16(x);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__host__ __device__ constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

// Lane groups: kVecs = D / kN 16-byte vectors cover one cached row; a group
// is kLanes = kVecs rounded up to a power of two lanes (lanes past kVecs
// idle), a warp holds 32 / kLanes groups and a block kGroups of them.
template <typename T, int D, int GC>
__global__ void __launch_bounds__(kThreads) decode_split(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ length,
    float* __restrict__ ws_m, float* __restrict__ ws_l,
    float* __restrict__ ws_acc, int S, int Hq, int Hkv, int n_chunks,
    int chunk_rows, int splits, float scale) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kVecs = D / kN;
  constexpr int kLanes = pow2_ceil(kVecs);
  static_assert(D % kN == 0 && kLanes <= 32, "unsupported head dim");
  constexpr int kRowsPerWarp = 32 / kLanes;
  constexpr int kGroups = kWarps * kRowsPerWarp;
  __shared__ float sm_m[kGroups][GC];
  __shared__ float sm_l[kGroups][GC];
  __shared__ float sm_acc[kGroups][GC][D];

  const int split = blockIdx.x;
  const int hk = blockIdx.y / n_chunks;
  const int chunk = blockIdx.y % n_chunks;
  const int b = blockIdx.z;
  const int g = Hq / Hkv;
  const int h0 = hk * g + chunk * GC;       // first q head of this block
  const int gh = min(GC, g - chunk * GC);   // q heads this block serves
  const int len = min(max(length[b], 0), S);
  const int s0 = split * chunk_rows;
  const int s1 = min(s0 + chunk_rows, len);

  if (s0 >= len) {  // an empty split: nothing to attend to
    if (threadIdx.x < gh) {
      const long long w = (static_cast<long long>(b) * Hq + h0 + threadIdx.x)
                          * splits + split;
      ws_m[w] = -INFINITY;
      ws_l[w] = 0.f;
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp * kRowsPerWarp + lane / kLanes;
  const int col = (lane % kLanes) * kN;
  const bool live = col < D;  // false on a padded group's idle lanes
  const long long row_stride = static_cast<long long>(Hkv) * D;
  const T* kb = k + static_cast<long long>(b) * S * row_stride + hk * D + col;
  const T* vb = v + static_cast<long long>(b) * S * row_stride + hk * D + col;

  float qr[GC][kN];
#pragma unroll
  for (int j = 0; j < GC; ++j) {
    if (j < gh && live) {
      Vec<T>::widen(load16(q + (static_cast<long long>(b) * Hq + h0 + j) * D
                           + col), qr[j]);
    } else {
#pragma unroll
      for (int e = 0; e < kN; ++e) qr[j][e] = 0.f;
    }
  }

  float m[GC], l[GC], acc[GC][kN];
#pragma unroll
  for (int j = 0; j < GC; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[j][e] = 0.f;
  }

  // every lane of the warp runs the same number of steps, so the shuffles
  // below always see full warps; rows past s1 load nothing and weigh 0
  const int warp_row0 = s0 + warp * kRowsPerWarp;
  for (int r0 = warp_row0; r0 < s1; r0 += kGroups * kUnroll) {
    uint4 kraw[kUnroll], vraw[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r0 + u * kGroups + lane / kLanes;
      valid[u] = row < s1;
      kraw[u] = vraw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (valid[u] && live) {
        kraw[u] = load16(kb + row * row_stride);
        vraw[u] = load16(vb + row * row_stride);
      }
    }
    float s[kUnroll][GC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kN];
      Vec<T>::widen(kraw[u], kf);
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kN; ++e) part = fmaf(qr[j][e], kf[e], part);
        // butterfly: every lane of the group ends with the same sum
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) {
          part += __shfl_xor_sync(kFull, part, off);
        }
        s[u][j] = valid[u] ? part * scale : -INFINITY;
      }
    }
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      float mx = m[j];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[u][j]);
      if (mx == -INFINITY) continue;  // this group has no row yet
      const float corr = expf(m[j] - mx);  // exp(-inf) = 0 on a first row
      m[j] = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u][j] = expf(s[u][j] - mx);  // 0 for an invalid row
        sum += s[u][j];
      }
      l[j] = l[j] * corr + sum;
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[j][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!valid[u]) continue;
      float vf[kN];
      Vec<T>::widen(vraw[u], vf);
#pragma unroll
      for (int j = 0; j < GC; ++j) {
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[j][e] = fmaf(s[u][j], vf[e], acc[j][e]);
      }
    }
  }

  // merge the block's lane groups
#pragma unroll
  for (int j = 0; j < GC; ++j) {
    if (col == 0) {
      sm_m[grp][j] = m[j];
      sm_l[grp][j] = l[j];
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < kN; ++e) sm_acc[grp][j][col + e] = acc[j][e];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < gh * D; t += kThreads) {
    const int j = t / D, c = t % D;
    float mx = -INFINITY;
    for (int i = 0; i < kGroups; ++i) mx = fmaxf(mx, sm_m[i][j]);
    // the group holding row s0 has seen a row, so mx is finite here
    float lsum = 0.f, a = 0.f;
    for (int i = 0; i < kGroups; ++i) {
      const float mi = sm_m[i][j];
      if (mi == -INFINITY) continue;
      const float w = expf(mi - mx);
      lsum = fmaf(sm_l[i][j], w, lsum);
      a = fmaf(sm_acc[i][j][c], w, a);
    }
    const long long w = (static_cast<long long>(b) * Hq + h0 + j) * splits
                        + split;
    if (c == 0) {
      ws_m[w] = mx;
      ws_l[w] = lsum;
    }
    ws_acc[w * D + c] = a;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D) decode_merge(
    const float* __restrict__ ws_m, const float* __restrict__ ws_l,
    const float* __restrict__ ws_acc, T* __restrict__ o, int Hq,
    int splits) {
  const int h = blockIdx.x, b = blockIdx.y, c = threadIdx.x;
  const long long w0 = (static_cast<long long>(b) * Hq + h) * splits;
  float mx = -INFINITY;
  for (int i = 0; i < splits; ++i) mx = fmaxf(mx, ws_m[w0 + i]);
  float out = 0.f;  // length 0: every split is empty, the output is 0
  if (mx != -INFINITY) {
    float lsum = 0.f, a = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float mi = ws_m[w0 + i];
      if (mi == -INFINITY) continue;  // empty split: its acc was never written
      const float wt = expf(mi - mx);
      lsum = fmaf(ws_l[w0 + i], wt, lsum);
      a = fmaf(ws_acc[(w0 + i) * D + c], wt, a);
    }
    out = a / fmaxf(lsum, 1e-30f);
  }
  o[(static_cast<long long>(b) * Hq + h) * D + c] = Vec<T>::narrow(out);
}

template <typename T, int D, int GC>
void launch(const void* q, const void* k, const void* v, const int* length,
            void* o, float* ws_m, float* ws_l, float* ws_acc, int B, int S,
            int Hq, int Hkv, int n_chunks, int chunk_rows, int splits,
            float scale, cudaStream_t stream) {
  const dim3 grid(splits, Hkv * n_chunks, B);
  decode_split<T, D, GC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, ws_m, ws_l, ws_acc, S, Hq, Hkv,
      n_chunks, chunk_rows, splits, scale);
  decode_merge<T, D><<<dim3(Hq, B), D, 0, stream>>>(
      ws_m, ws_l, ws_acc, static_cast<T*>(o), Hq, splits);
}

template <typename T, int D>
int launch_group(int gc, const void* q, const void* k, const void* v,
                 const int* length, void* o, float* ws_m, float* ws_l,
                 float* ws_acc, int B, int S, int Hq, int Hkv, int n_chunks,
                 int chunk_rows, int splits, float scale,
                 cudaStream_t stream) {
  switch (gc) {
    case 1: launch<T, D, 1>(q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream); break;
    case 2: launch<T, D, 2>(q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream); break;
    case 4: launch<T, D, 4>(q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream); break;
    case 8: launch<T, D, 8>(q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch_dim(int D, int gc, const void* q, const void* k, const void* v,
               const int* length, void* o, float* ws_m, float* ws_l,
               float* ws_acc, int B, int S, int Hq, int Hkv, int n_chunks,
               int chunk_rows, int splits, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch_group<T, 16>(gc, q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream);
    case 32: return launch_group<T, 32>(gc, q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream);
    case 64: return launch_group<T, 64>(gc, q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream);
    case 112: return launch_group<T, 112>(gc, q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream);
    case 128: return launch_group<T, 128>(gc, q, k, v, length, o, ws_m, ws_l, ws_acc, B, S, Hq, Hkv, n_chunks, chunk_rows, splits, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q/o [B, Hq, D], k/v [B, S, Hkv, D], length [B] int32, all contiguous and
// 16-byte aligned, bf16 (is_bf16 = 1) or f32. Workspace: ws_m and ws_l
// [B, Hq, splits] f32, ws_acc [B, Hq, splits, D] f32. A block serves gc
// (1, 2, 4 or 8) q heads of one kv head, n_chunks = ceil((Hq / Hkv) / gc)
// blocks per kv head; split i covers rows [i * chunk_rows, (i + 1) *
// chunk_rows). Launches both kernels on `stream` and returns
// cudaGetLastError() as an int (0 on success); the caller raises on
// anything else.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* length, void* o,
    void* ws_m, void* ws_l, void* ws_acc, int B, int S, int Hq, int Hkv,
    int D, int gc, int n_chunks, int chunk_rows, int splits, float scale,
    int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || splits <= 0 ||
      chunk_rows <= 0 || static_cast<long long>(chunk_rows) * splits < S ||
      gc < 1 || gc > kMaxGroup || gc * n_chunks < Hq / Hkv || B > 65535 ||
      Hkv * n_chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* m = static_cast<float*>(ws_m);
  float* l = static_cast<float*>(ws_l);
  float* acc = static_cast<float*>(ws_acc);
  const int err = is_bf16
      ? launch_dim<__nv_bfloat16>(D, gc, q, k, v, len, o, m, l, acc, B, S, Hq,
                                  Hkv, n_chunks, chunk_rows, splits, scale, st)
      : launch_dim<float>(D, gc, q, k, v, len, o, m, l, acc, B, S, Hq, Hkv,
                          n_chunks, chunk_rows, splits, scale, st);
  if (err != 0) {
    return err;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
