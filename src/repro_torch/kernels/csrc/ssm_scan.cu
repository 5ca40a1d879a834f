// Chunked Mamba2 SSD scan (selective state space, "state space duality")
// on Hopper: tensor-core products with f32 operands split into three bf16
// terms, the state kept in the accumulators of the warps that update it,
// a double-buffered ring of chunk tiles, (head dim, state) widths at run
// time.
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py:ssd_scan (body
// _ssd_kernel). It computes the same function, the recurrence
//
//   h_t = exp(log_a_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
//
// per (batch row b, head h), with x [B, S, H, hd], dt and log_a [B, S, H]
// f32, Bm and Cm [B, S, n] shared by all heads, the state h [hd, n] f32 and
// y [B, S, H, hd] in x's dtype. Every decay is f32 and every product is
// f32-accurate (below).
//
// Structure. The Pallas grid runs (b, h, chunk) with the chunk axis
// sequential and h in VMEM scratch. Here one block owns one (b, h) and
// loops over the chunks in order (448 blocks at Zamba2-7B's training shape,
// B 4 x H 112); the state never leaves the chip. Per chunk of kChunk = 64
// rows (the kernel's own choice: y is the same function for any chunk
// length), in f32:
//
//   cum_i  = sum_{l <= i} log_a_l          (each warp's own shuffle scan)
//   S_ij   = (C_i . B_j) exp(cum_i - cum_j) dt_j   for j <= i, else 0
//   y_i    = sum_j S_ij x_j + exp(cum_i) (C_i . h)
//   h     <- exp(cum_last) h + sum_j (w_j B_j)^T x_j,
//             w_j = exp(cum_last - cum_j) dt_j
//
// The mask is tested before the exp: above the diagonal cum_i - cum_j is
// positive and its exp could overflow to inf, and inf * 0 is NaN. On the
// diagonal and below it the exponent is <= 0 for a decaying model, so exp
// underflows to 0 (log decays reach about -45 within a chunk at dt ~ 0.7),
// never to NaN. A ragged tail is handled by bounds: rows past S load as
// x = B = C = dt = log_a = 0, so they add nothing, and their y is not
// stored. There is no padded copy.
//
// bf16 x, B and C (the training path):
//  * Products on tensor cores, mma.sync m16n8k16 bf16 in, f32 sums. x, B
//    and C are bf16 inputs and so exact operands. Each f32 operand (the
//    decayed scores S, the state h, w_j B_j) is split into three bf16 terms
//    hi + mid + lo, which carry all 24 bits of its significand, and its
//    product is three products summed in f32. Two terms would leave about
//    2^-17 of each term; near-zero outputs are sums of terms of up to about
//    150 that cancel, so that residual would exceed the 1e-4 floor of the
//    bound. Three keep the error at f32's own rounding.
//  * Warps. Warp w owns rows 16 (w % 4) .. +15 of the chunk for y (with 8
//    warps, pairs split y's columns). It computes its rows' C B^T, applies
//    the mask, the decay and dt_j in the accumulators, splits them and
//    feeds them to S x as A fragments (as B4 feeds p): the scores never
//    touch shared memory, and k-steps above the diagonal are skipped. The
//    scores' decays are one MUFU ex2 each (exp_mufu); the few others are
//    expf. C B^T is the same for every head, but computing it once per
//    head costs about 2% of the kernel's time (a build without it), so
//    the heads do not share it.
//  * State. h^T [n, hd] lives in the mma accumulators of the warps that
//    update it (16 rows of n each): they scale it by exp(cum_last), add
//    (w B)^T x, and write its three bf16 terms to shared memory, where the
//    next chunk's C h^T reads them (two plane buffers where they fit, so
//    one barrier a chunk; one buffer and a second barrier at the 128 x 128
//    ceiling).
//  * Loads. x, B and C arrive as bf16 tiles (no transposed copies) by
//    16-byte cp.async into a double-buffered ring in dynamic shared memory:
//    chunk c + 1 is in flight while chunk c computes; each thread's copies
//    follow a walk set up once, with no division a chunk. dt and log_a
//    come by 4-byte cp.async. Rows are padded to an odd number of 16-byte units so
//    ldmatrix (.trans where the operand needs the other orientation) reads
//    8 rows from 8 bank groups. A width that is not a whole number of
//    16-byte vectors, or a pointer off 16 bytes, takes a masked element
//    path in the same kernel.
//  * Widths at run time. hd and n are arguments from 1 to kMaxWidth; the
//    kernel is instantiated for ceiling classes 64 and 128 of each, and
//    every k-step and n-tile of the class runs with no branch around the
//    warp-wide loads and products: columns past a width are zeros in
//    shared memory (the ring is zeroed once), so they add nothing, and
//    outputs past hd are not stored.
//
// f32 x, B and C: no configuration trains in f32 on the card, so its
// products stay f32 FMAs on the CUDA cores (outer-product tile loops over
// operands laid out K-major in shared memory), with the same one-block
// walk and the state in shared memory, at the same run-time widths under
// ceiling classes 16, 64 and 128; at a class's own widths its column masks
// compile away.
//
// Bound. At the training shape (B 4, S 1024, H 112, hd 64, n 64, bf16 x, B
// and C) the function moves about 122 MB (x and y in bf16, dt and log_a in
// f32, B and C once), 0.036 ms at 3.35 TB/s. Its products on tensor cores,
// each f32 operand counted as three bf16 products, come to about 24 GFLOP
// at the chunk length that needs the fewest (18), 0.026 ms at 989 TFLOP/s:
// the bytes bound it. This kernel's chunk of 64 does about 30 GFLOP of
// bf16 products (C B^T once per head, the other three in three terms).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;        // rows per chunk
constexpr int kMaxWidth = 128;    // hd and n at most
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on Hopper
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16 path: layout
// ---------------------------------------------------------------------------

// the ceiling class of a width: 64 or 128 for the bf16 kernel; the f32
// kernel adds 16, so the reference sweep's small widths are not padded
// fourfold
__host__ __device__ constexpr int width_class(int w) { return w <= 64 ? 64 : 128; }
__host__ __device__ constexpr int f32_class(int w) { return w <= 16 ? 16 : width_class(w); }

__host__ __device__ constexpr int warps_of(int hdc, int nc) {
  return hdc == 64 && nc == 64 ? 4 : 8;
}

// bytes of one bf16 row of `cols` columns in shared memory: an odd number
// of 16-byte units, so ldmatrix's 8 rows at one column hit 8 bank groups
__host__ __device__ constexpr int pitch(int cols) {
  return 16 * ((cols * 2 / 16) | 1);
}

// one ring slot: x [64][hdc], B [64][nc], C [64][nc], dt [64], log_a [64]
__host__ __device__ constexpr int stage_bytes(int hdc, int nc) {
  return kChunk * (pitch(hdc) + 2 * pitch(nc)) + 2 * kChunk * 4;
}

// one buffer of the state's three bf16 terms, h^T [nc][hdc] each
__host__ __device__ constexpr int planes_bytes(int hdc, int nc) {
  return 3 * nc * pitch(hdc);
}

// each warp's cum and w [64] f32
__host__ __device__ constexpr int scratch_bytes(int hdc, int nc) {
  return warps_of(hdc, nc) * 2 * kChunk * 4;
}

__host__ __device__ constexpr int plane_buffers(int hdc, int nc) {
  return 2 * stage_bytes(hdc, nc) + 2 * planes_bytes(hdc, nc)
                 + scratch_bytes(hdc, nc) <= kMaxSmem ? 2 : 1;
}

__host__ __device__ constexpr int bf16_smem(int hdc, int nc) {
  return 2 * stage_bytes(hdc, nc) + plane_buffers(hdc, nc) * planes_bytes(hdc, nc)
         + scratch_bytes(hdc, nc);
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (valid) or 16 zero bytes into shared memory
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(__cvta_generic_to_global(src)),
                  "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(__cvta_generic_to_global(src)),
                  "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Fragment loads and products are plain (not volatile) asm, so that the
// compiler may issue the next loads before the last products; a load
// keeps a memory clobber, so that none moves above a barrier.

// four 8x8 b16 matrices at a shared-memory address, lanes 8i..8i+7 giving
// the rows of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  uint32_t addr) {
  asm("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}

// c += a (16x16 bf16, row major) * b (16x8 bf16, column major), f32 sums.
// Fragments (lane = 4 gid + tig): a0 (row gid, cols 2tig..+1), a1 (row
// gid+8), a2 (row gid, cols 2tig+8..+9), a3 (row gid+8, cols +8); b0 (k
// 2tig..+1, col gid), b1 (k 2tig+8..+9); c0, c1 (row gid, cols 2tig..+1),
// c2, c3 (row gid+8).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as three packed bf16 pairs hi + mid + lo: hi = bf16(x), mid =
// bf16 of what hi misses, lo = bf16 of what both miss (each residual is
// exact in f32), so the three carry the whole 24-bit significand
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// e^x as 2^(x log2 e) in one MUFU instruction (relative error about 2^-22,
// as expf's two ulps; results below 2^-126 flush to 0)
__device__ __forceinline__ float exp_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// one warp's inclusive scan of log_a over the chunk (lane l: rows 2l and
// 2l + 1) into cum[64], and w_j = exp(cum_last - cum_j) dt_j into w[64];
// returns cum_last
__device__ __forceinline__ float chunk_scan(const float* la, const float* dt,
                                            float* cum, float* w, int lane) {
  const float2 a = *reinterpret_cast<const float2*>(la + 2 * lane);
  const float2 d = *reinterpret_cast<const float2*>(dt + 2 * lane);
  const float pair = a.x + a.y;
  float incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const float c0 = (incl - pair) + a.x, c1 = c0 + a.y;
  const float total = __shfl_sync(kFull, c1, 31);
  *reinterpret_cast<float2*>(cum + 2 * lane) = make_float2(c0, c1);
  *reinterpret_cast<float2*>(w + 2 * lane) =
      make_float2(expf(total - c0) * d.x, expf(total - c1) * d.y);
  __syncwarp();
  return total;
}

struct Args {
  const void* x;
  const float* dt;
  const float* la;
  const void* Bm;
  const void* Cm;
  void* y;
  int S, H, hd, n;
  int vec_x;   // hd a whole number of 16-byte vectors, x 16-byte aligned
  int vec_bc;  // the same for n, Bm and Cm
};

// A thread's 16-byte copies of a chunk's [64][nv] vectors: item tid + k T
// is row (tid + k T) / nv, vector (tid + k T) % nv. The division is made
// once; a step of T items adds dr rows and dv vectors.
struct Walk {
  int r, v, dr, dv;
};

__device__ __forceinline__ Walk walk_of(int tid, int nv, int T) {
  Walk w;
  w.r = nv > 0 ? tid / nv : kChunk;
  w.v = tid - w.r * nv;
  w.dr = nv > 0 ? T / nv : 0;
  w.dv = T - w.dr * nv;
  return w;
}

// Chunk rows [s0, s0 + rows) of (b, h) into a ring slot: cp.async, zeros
// for rows past S; the masked element path where a width or a pointer does
// not allow 16-byte copies (plain loads and stores, done on return).
template <int HDC, int NC, int T>
__device__ __forceinline__ void load_chunk(unsigned char* slot, const Args& a,
                                           const Walk& wx, const Walk& wb,
                                           int b, int h, int s0, int rows,
                                           int tid) {
  constexpr int XP = pitch(HDC), BP = pitch(NC);
  unsigned char* xs = slot;
  unsigned char* bs = xs + kChunk * XP;
  unsigned char* cs = bs + kChunk * BP;
  float* fs = reinterpret_cast<float*>(cs + kChunk * BP);  // dt, then log_a
  const long long xrow = static_cast<long long>(a.H) * a.hd;
  const long long row0 = static_cast<long long>(b) * a.S + s0;
  const __nv_bfloat16* xg =
      static_cast<const __nv_bfloat16*>(a.x) + row0 * xrow + h * a.hd;
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(a.Bm) + row0 * a.n;
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(a.Cm) + row0 * a.n;
  if (a.vec_x) {
    const int nv = a.hd / 8;
    for (int r = wx.r, v = wx.v; r < kChunk;) {
      const bool ok = r < rows;
      cp_async16(smem_u32(xs + r * XP + v * 16), ok ? xg + r * xrow + v * 8 : xg,
                 ok);
      r += wx.dr;
      v += wx.dv;
      if (v >= nv) {
        v -= nv;
        ++r;
      }
    }
  } else {
    for (int i = tid; i < kChunk * a.hd; i += T) {
      const int r = i / a.hd, c = i - r * a.hd;
      *reinterpret_cast<__nv_bfloat16*>(xs + r * XP + c * 2) =
          r < rows ? __ldg(xg + r * xrow + c) : __float2bfloat16(0.f);
    }
  }
  if (a.vec_bc) {
    const int nv = a.n / 8;
    for (int r = wb.r, v = wb.v; r < kChunk;) {
      const bool ok = r < rows;
      const int off = ok ? r * a.n + v * 8 : 0;
      cp_async16(smem_u32(bs + r * BP + v * 16), bg + off, ok);
      cp_async16(smem_u32(cs + r * BP + v * 16), cg + off, ok);
      r += wb.dr;
      v += wb.dv;
      if (v >= nv) {
        v -= nv;
        ++r;
      }
    }
  } else {
    for (int i = tid; i < kChunk * a.n; i += T) {
      const int r = i / a.n, c = i - r * a.n;
      const int off = r * a.n + c;
      const __nv_bfloat16 z = __float2bfloat16(0.f);
      *reinterpret_cast<__nv_bfloat16*>(bs + r * BP + c * 2) =
          r < rows ? __ldg(bg + off) : z;
      *reinterpret_cast<__nv_bfloat16*>(cs + r * BP + c * 2) =
          r < rows ? __ldg(cg + off) : z;
    }
  }
  const float* dtg = a.dt + row0 * a.H + h;
  const float* lag = a.la + row0 * a.H + h;
  for (int i = tid; i < 2 * kChunk; i += T) {
    const int r = i & (kChunk - 1);
    const bool ok = r < rows;
    const float* src = i < kChunk ? dtg : lag;
    cp_async4(smem_u32(fs + i), src + (ok ? static_cast<long long>(r) * a.H : 0),
              ok);
  }
  cp_async_commit();
}

template <int HDC, int NC>
__global__ void __launch_bounds__(warps_of(HDC, NC) * 32) ssd_scan_bf16(Args a) {
  constexpr int W = warps_of(HDC, NC), T = W * 32;
  constexpr int XP = pitch(HDC), BP = pitch(NC);
  constexpr int SB = stage_bytes(HDC, NC), PB = plane_buffers(HDC, NC);
  constexpr int PLANE = NC * XP;                 // one term of h^T
  constexpr int YCOLS = HDC / (W / 4), YNT = YCOLS / 8;  // y: columns, n-tiles
  constexpr int MTS = NC / 16;                   // state m-tiles (16 rows of n)
  constexpr int SCOLS = HDC / (W / MTS), SNT = SCOLS / 8;
  constexpr int NK = NC / 16;                    // k-steps over n
  constexpr int JK = kChunk / 16;                // k-steps over the chunk
  static_assert(W % MTS == 0 && YNT % 2 == 0 && SNT % 2 == 0, "warp layout");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* planes = smem + 2 * SB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  float* cum = reinterpret_cast<float*>(planes + PB * 3 * PLANE) + warp * 2 * kChunk;
  float* wv = cum + kChunk;

  // zeros: the ring's columns past the widths stay zero for good, and the
  // state enters the first chunk as zero
  for (int i = tid * 16; i < 2 * SB + 3 * PLANE; i += T * 16) {
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  const int n_chunks = (a.S + kChunk - 1) / kChunk;
  const Walk wx = walk_of(tid, a.vec_x ? a.hd / 8 : 0, T);
  const Walk wb = walk_of(tid, a.vec_bc ? a.n / 8 : 0, T);
  load_chunk<HDC, NC, T>(ring, a, wx, wb, b, h, 0, min(kChunk, a.S), tid);

  // this warp's rows of y and tile of the state
  const int rg = warp & 3, i0 = rg * 16, yc0 = (warp >> 2) * YCOLS;
  const int n0 = (warp % MTS) * 16, sc0 = (warp / MTS) * SCOLS;
  // ldmatrix lane offsets (bytes at a row pitch of 1): A of a row-major
  // tile (C as the A of C B^T and C h^T); B from rows that are the n index
  // (B as the B of C B^T); B from rows that are the k index, .trans (x as
  // the B of S x and of the state update, h^T as the B of C h^T); A from
  // rows that are the k index, .trans (B^T as the A of the state update)
  const int a_row = lane & 15, a_col = (lane >> 4) * 16;
  const int k_row = ((lane >> 4) << 3) + (lane & 7), k_col = ((lane >> 3) & 1) * 16;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) * 16;
  const int t_row = (lane & 7) + (((lane >> 4) & 1) << 3), t_col = ((lane >> 3) & 1) * 16;

  float hacc[SNT][4];
#pragma unroll
  for (int t = 0; t < SNT; ++t) hacc[t][0] = hacc[t][1] = hacc[t][2] = hacc[t][3] = 0.f;
  const long long xrow = static_cast<long long>(a.H) * a.hd;
  const bool pair_store = (a.hd & 1) == 0;

  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * kChunk, rows = min(kChunk, a.S - s0);
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    if (c + 1 < n_chunks) {
      load_chunk<HDC, NC, T>(ring + ((c + 1) & 1) * SB, a, wx, wb, b, h,
                             s0 + kChunk, min(kChunk, a.S - s0 - kChunk), tid);
    }
    unsigned char* slot = ring + (c & 1) * SB;
    const uint32_t xs = smem_u32(slot), bs = xs + kChunk * XP,
                   cs = bs + kChunk * BP;
    const float* dts = reinterpret_cast<const float*>(slot + kChunk * (XP + 2 * BP));
    const float total = chunk_scan(dts + kChunk, dts, cum, wv, lane);

    // y = exp(cum_i) (C h^T), h^T as three terms from the plane buffer
    float yacc[YNT][4];
#pragma unroll
    for (int t = 0; t < YNT; ++t) yacc[t][0] = yacc[t][1] = yacc[t][2] = yacc[t][3] = 0.f;
    {
      const uint32_t prd = smem_u32(planes) + (c % PB) * 3 * PLANE;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, cs + (i0 + a_row) * BP + kk * 32 + a_col);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const uint32_t pb = prd + t * PLANE + (kk * 16 + v_row) * XP + yc0 * 2 + v_col;
#pragma unroll
          for (int np = 0; np < YNT / 2; ++np) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, pb + np * 32);
            mma_16816(yacc[2 * np], af, bf);
            mma_16816(yacc[2 * np + 1], af, bf + 2);
          }
        }
      }
      const float e0 = expf(cum[i0 + gid]), e1 = expf(cum[i0 + gid + 8]);
#pragma unroll
      for (int t = 0; t < YNT; ++t) {
        yacc[t][0] *= e0;
        yacc[t][1] *= e0;
        yacc[t][2] *= e1;
        yacc[t][3] *= e1;
      }
    }
    if constexpr (PB == 1) __syncthreads();  // every read of h is done

    // h^T <- exp(total) h^T + (w B)^T x on this warp's tile, then its three
    // terms into the other plane buffer
    {
      const float decay = expf(total);
#pragma unroll
      for (int t = 0; t < SNT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[t][e] *= decay;
      }
#pragma unroll
      for (int kk = 0; kk < JK; ++kk) {
        uint32_t raw[4], ah[4], am[4], al[4];
        ldmatrix_x4_trans(raw, bs + (kk * 16 + t_row) * BP + n0 * 2 + t_col);
        const float2 w0 = *reinterpret_cast<const float2*>(wv + kk * 16 + 2 * tig);
        const float2 w8 = *reinterpret_cast<const float2*>(wv + kk * 16 + 8 + 2 * tig);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = unpack(raw[r]);
          const float2 w = r < 2 ? w0 : w8;
          split3(v.x * w.x, v.y * w.y, ah[r], am[r], al[r]);
        }
        const uint32_t xb = xs + (kk * 16 + v_row) * XP + sc0 * 2 + v_col;
#pragma unroll
        for (int np = 0; np < SNT / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, xb + np * 32);
          mma_16816(hacc[2 * np], ah, bf);
          mma_16816(hacc[2 * np], am, bf);
          mma_16816(hacc[2 * np], al, bf);
          mma_16816(hacc[2 * np + 1], ah, bf + 2);
          mma_16816(hacc[2 * np + 1], am, bf + 2);
          mma_16816(hacc[2 * np + 1], al, bf + 2);
        }
      }
      unsigned char* pw = planes + ((c + 1) % PB) * 3 * PLANE;
#pragma unroll
      for (int t = 0; t < SNT; ++t) {
        const int col = sc0 + t * 8 + 2 * tig;
        unsigned char* p0 = pw + (n0 + gid) * XP + col * 2;
        unsigned char* p1 = p0 + 8 * XP;
        uint32_t hi, mid, lo;
        split3(hacc[t][0], hacc[t][1], hi, mid, lo);
        *reinterpret_cast<uint32_t*>(p0) = hi;
        *reinterpret_cast<uint32_t*>(p0 + PLANE) = mid;
        *reinterpret_cast<uint32_t*>(p0 + 2 * PLANE) = lo;
        split3(hacc[t][2], hacc[t][3], hi, mid, lo);
        *reinterpret_cast<uint32_t*>(p1) = hi;
        *reinterpret_cast<uint32_t*>(p1 + PLANE) = mid;
        *reinterpret_cast<uint32_t*>(p1 + 2 * PLANE) = lo;
      }
    }

    // scores of this warp's 16 rows: C B^T up to the diagonal, then the
    // mask (before the exp), the decay and dt_j, in the accumulators
    float s[2 * JK][4];
#pragma unroll
    for (int t = 0; t < 2 * JK; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, cs + (i0 + a_row) * BP + kk * 32 + a_col);
#pragma unroll
      for (int np = 0; np < JK; ++np) {
        if (np <= rg) {
          uint32_t bk[4];
          ldmatrix_x4(bk, bs + (np * 16 + k_row) * BP + kk * 32 + k_col);
          mma_16816(s[2 * np], af, bk);
          mma_16816(s[2 * np + 1], af, bk + 2);
        }
      }
    }
    {
      const int r0 = i0 + gid, r1 = r0 + 8;
      const float c0 = cum[r0], c1 = cum[r1];
#pragma unroll
      for (int t = 0; t < 2 * JK; ++t) {
        if (t < 2 * (rg + 1)) {
          const int j = t * 8 + 2 * tig;
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
          s[t][0] = j <= r0 ? s[t][0] * exp_mufu(c0 - cj.x) * dj.x : 0.f;
          s[t][1] = j + 1 <= r0 ? s[t][1] * exp_mufu(c0 - cj.y) * dj.y : 0.f;
          s[t][2] = j <= r1 ? s[t][2] * exp_mufu(c1 - cj.x) * dj.x : 0.f;
          s[t][3] = j + 1 <= r1 ? s[t][3] * exp_mufu(c1 - cj.y) * dj.y : 0.f;
        }
      }
    }
    // y += S x, S as A fragments in three terms, k-steps up to the diagonal
#pragma unroll
    for (int kk = 0; kk < JK; ++kk) {
      if (kk <= rg) {
        uint32_t ah[4], am[4], al[4];
        split3(s[2 * kk][0], s[2 * kk][1], ah[0], am[0], al[0]);
        split3(s[2 * kk][2], s[2 * kk][3], ah[1], am[1], al[1]);
        split3(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], am[2], al[2]);
        split3(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], am[3], al[3]);
        const uint32_t xb = xs + (kk * 16 + v_row) * XP + yc0 * 2 + v_col;
#pragma unroll
        for (int np = 0; np < YNT / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, xb + np * 32);
          mma_16816(yacc[2 * np], ah, bf);
          mma_16816(yacc[2 * np], am, bf);
          mma_16816(yacc[2 * np], al, bf);
          mma_16816(yacc[2 * np + 1], ah, bf + 2);
          mma_16816(yacc[2 * np + 1], am, bf + 2);
          mma_16816(yacc[2 * np + 1], al, bf + 2);
        }
      }
    }

    // y rows of this chunk, columns below hd
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(a.y)
                        + (static_cast<long long>(b) * a.S + s0) * xrow + h * a.hd;
    const int r0 = i0 + gid, r1 = r0 + 8;
#pragma unroll
    for (int t = 0; t < YNT; ++t) {
      const int col = yc0 + t * 8 + 2 * tig;
      if (col < a.hd) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? r1 : r0;
          if (r < rows) {
            __nv_bfloat16* out = yb + r * xrow + col;
            const float v0 = yacc[t][2 * half], v1 = yacc[t][2 * half + 1];
            if (pair_store) {
              *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
            } else {
              out[0] = __float2bfloat16(v0);
              if (col + 1 < a.hd) out[1] = __float2bfloat16(v1);
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32 path: CUDA-core FMA products
// ---------------------------------------------------------------------------

constexpr int kThreadsF32 = 256;

// Thread tiling of an [M, NN] output: each thread owns TM consecutive rows
// and TN consecutive columns; USED threads (at most kThreadsF32) take part.
template <int M, int NN>
struct Tile {
  static constexpr int TN = NN < 4 ? NN : 4;
  static constexpr int COLS = NN / TN;
  static constexpr int TM0 = M * NN / (kThreadsF32 * TN);
  static constexpr int TM = TM0 < 1 ? 1 : (TM0 > 16 ? 16 : TM0);
  static constexpr int ROWS = M / TM;
  static constexpr int USED = ROWS * COLS;
  static_assert(NN % TN == 0 && M % TM == 0, "tile does not divide");
  static_assert(USED <= kThreadsF32, "output too large for one block");
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
    float av[Tl::TM], bv[Tl::TN];
    lds<Tl::TM>(A + k * M + r0, av);
    lds<Tl::TN>(B + k * NN + c0, bv);
    if (s != nullptr) {
      const float sk = s[k];
#pragma unroll
      for (int i = 0; i < Tl::TM; ++i) av[i] *= sk;
    }
#pragma unroll
    for (int i = 0; i < Tl::TM; ++i) {
#pragma unroll
      for (int j = 0; j < Tl::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__host__ __device__ constexpr int f32_smem(int hdc, int nc) {
  return 4 * (kChunk * hdc + 3 * kChunk * nc + kChunk * kChunk + nc * hdc
              + 3 * kChunk);
}

// FULL: hd and n are their classes' ceilings, so no column is masked (the
// masks cost a sixth of the kernel's time at the training shape)
template <int HDC, int NC, bool FULL>
__global__ void __launch_bounds__(kThreadsF32) ssd_scan_f32(Args a) {
  constexpr int L = kChunk;
  extern __shared__ __align__(16) float fsm[];
  float* xs = fsm;             // x       [L][HDC]
  float* bs = xs + L * HDC;    // B       [L][NC]
  float* bt = bs + L * NC;     // B^T     [NC][L]
  float* ct = bt + NC * L;     // C^T     [NC][L]
  float* st = ct + NC * L;     // S^T     [L][L]: st[j * L + i] = S_ij
  float* ht = st + L * L;      // h^T     [NC][HDC]
  float* cum = ht + NC * HDC;  // [L] running sum of log_a within the chunk
  float* wv = cum + L;         // [L] exp(cum_last - cum_j) dt_j
  float* dts = wv + L;         // [L] dt_j

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int hd = a.hd, n = a.n, H = a.H, S = a.S;
  const long long xrow = static_cast<long long>(H) * hd;  // x / y row stride
  const float* __restrict__ xb = static_cast<const float*>(a.x)
                                 + static_cast<long long>(b) * S * xrow + h * hd;
  float* __restrict__ yb =
      static_cast<float*>(a.y) + static_cast<long long>(b) * S * xrow + h * hd;
  const float* __restrict__ dtb = a.dt + static_cast<long long>(b) * S * H + h;
  const float* __restrict__ lab = a.la + static_cast<long long>(b) * S * H + h;
  const float* __restrict__ Bb =
      static_cast<const float*>(a.Bm) + static_cast<long long>(b) * S * n;
  const float* __restrict__ Cb =
      static_cast<const float*>(a.Cm) + static_cast<long long>(b) * S * n;

  for (int i = tid; i < NC * HDC; i += kThreadsF32) ht[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += L) {
    const int rows = min(L, S - s0);
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < L * HDC; i += kThreadsF32) {
      const int r = i / HDC, c = i % HDC;
      xs[i] = r < rows && (FULL || c < hd) ? __ldg(xb + (s0 + r) * xrow + c) : 0.f;
    }
    for (int i = tid; i < L * NC; i += kThreadsF32) {
      const int r = i / NC, c = i % NC;
      float bv = 0.f, cv = 0.f;
      if (r < rows && (FULL || c < n)) {
        bv = __ldg(Bb + static_cast<long long>(s0 + r) * n + c);
        cv = __ldg(Cb + static_cast<long long>(s0 + r) * n + c);
      }
      bs[i] = bv;
      bt[c * L + r] = bv;
      ct[c * L + r] = cv;
    }
    if (tid < 32) {
      float la2[2], dt2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * tid + e;
        la2[e] = r < rows ? __ldg(lab + static_cast<long long>(s0 + r) * H) : 0.f;
        dt2[e] = r < rows ? __ldg(dtb + static_cast<long long>(s0 + r) * H) : 0.f;
      }
      dts[2 * tid] = dt2[0];
      dts[2 * tid + 1] = dt2[1];
      cum[2 * tid] = la2[0];  // chunk_scan reads them back in place
      cum[2 * tid + 1] = la2[1];
      __syncwarp();
      chunk_scan(cum, dts, cum, wv, tid);
    }
    __syncthreads();
    const float total = cum[L - 1];

    {  // S^T: the masked, decayed C B^T, scaled by dt_j
      using Tl = Tile<L, L>;
      if (tid < Tl::USED) {
        const int r0 = (tid / Tl::COLS) * Tl::TM, c0 = (tid % Tl::COLS) * Tl::TN;
        float acc[Tl::TM][Tl::TN] = {};
        if (c0 <= r0 + Tl::TM - 1) {  // some j <= i in this tile
          tile_mm<L, L, NC>(ct, bt, nullptr, r0, c0, acc);
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
      using Tl = Tile<L, HDC>;
      if (tid < Tl::USED) {
        const int r0 = (tid / Tl::COLS) * Tl::TM, c0 = (tid % Tl::COLS) * Tl::TN;
        float intra[Tl::TM][Tl::TN] = {}, inter[Tl::TM][Tl::TN] = {};
        tile_mm<L, HDC, L>(st, xs, nullptr, r0, c0, intra);
        tile_mm<L, HDC, NC>(ct, ht, nullptr, r0, c0, inter);
#pragma unroll
        for (int ii = 0; ii < Tl::TM; ++ii) {
          const int i = r0 + ii;
          if (i < rows) {
            const float e = expf(cum[i]);
            float* out = yb + (s0 + i) * xrow + c0;
#pragma unroll
            for (int jj = 0; jj < Tl::TN; ++jj) {
              if (FULL || c0 + jj < hd) out[jj] = fmaf(e, inter[ii][jj], intra[ii][jj]);
            }
          }
        }
      }
    }
    __syncthreads();  // every read of the entering state is done
    {  // h^T <- exp(total) h^T + sum_j B_j^T w_j x_j
      using Tl = Tile<NC, HDC>;
      if (tid < Tl::USED) {
        const int r0 = (tid / Tl::COLS) * Tl::TM, c0 = (tid % Tl::COLS) * Tl::TN;
        float acc[Tl::TM][Tl::TN] = {};
        tile_mm<NC, HDC, L>(bs, xs, wv, r0, c0, acc);
        const float decay = expf(total);
#pragma unroll
        for (int ii = 0; ii < Tl::TM; ++ii) {
#pragma unroll
          for (int jj = 0; jj < Tl::TN; ++jj) {
            float* p = ht + (r0 + ii) * HDC + c0 + jj;
            *p = fmaf(decay, *p, acc[ii][jj]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// A kernel of one class, its block size and its shared memory (allowed
// above 48 KB before it launches).
struct Kernel {
  void (*fn)(Args);
  int threads, smem;
};

template <int HDC, int NC>
Kernel bf16_kernel() {
  return {ssd_scan_bf16<HDC, NC>, warps_of(HDC, NC) * 32, bf16_smem(HDC, NC)};
}

template <int HDC, int NC>
Kernel f32_kernel(bool full) {
  return {full ? ssd_scan_f32<HDC, NC, true> : ssd_scan_f32<HDC, NC, false>,
          kThreadsF32, f32_smem(HDC, NC)};
}

template <int HDC>
Kernel f32_kernel_n(int nc, bool full) {
  return nc == 16 ? f32_kernel<HDC, 16>(full)
         : nc == 64 ? f32_kernel<HDC, 64>(full) : f32_kernel<HDC, 128>(full);
}

int kernel_for(int hd, int n, int is_bf16, Kernel* k) {
  if (is_bf16) {
    const int hc = width_class(hd), nc = width_class(n);
    *k = hc == 64 ? (nc == 64 ? bf16_kernel<64, 64>() : bf16_kernel<64, 128>())
                  : (nc == 64 ? bf16_kernel<128, 64>() : bf16_kernel<128, 128>());
  } else {
    const int hc = f32_class(hd), nc = f32_class(n);
    const bool full = hd == hc && n == nc;
    *k = hc == 16 ? f32_kernel_n<16>(nc, full)
         : hc == 64 ? f32_kernel_n<64>(nc, full) : f32_kernel_n<128>(nc, full);
  }
  return static_cast<int>(cudaFuncSetAttribute(
      k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem));
}

static_assert(bf16_smem(128, 128) <= kMaxSmem && f32_smem(128, 128) <= kMaxSmem,
              "shared memory");

}  // namespace

// x / y [B, S, H, hd] and Bm / Cm [B, S, n] bf16 (is_bf16 = 1) or f32, dt /
// la [B, S, H] f32, all contiguous; hd and n from 1 to 128. vec_x (vec_bc):
// hd (n) is a multiple of 8 and x (Bm and Cm) 16-byte aligned, so the bf16
// path copies 16-byte vectors. Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success); the caller raises on
// anything else.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* la,
                               const void* Bm, const void* Cm, void* y, int B,
                               int S, int H, int hd, int n, int is_bf16,
                               int vec_x, int vec_bc, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || hd < 1 || n < 1
      || hd > kMaxWidth || n > kMaxWidth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(la),
               Bm, Cm, y, S, H, hd, n, vec_x, vec_bc};
  Kernel k;
  const int err = kernel_for(hd, n, is_bf16, &k);
  if (err != 0) return err;
  k.fn<<<dim3(H, B), k.threads, k.smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// shared memory bytes of one block, as the launch sizes it
extern "C" int ssd_scan_smem_bytes(int hd, int n, int is_bf16) {
  return is_bf16 ? bf16_smem(width_class(hd), width_class(n))
                 : f32_smem(f32_class(hd), f32_class(n));
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
