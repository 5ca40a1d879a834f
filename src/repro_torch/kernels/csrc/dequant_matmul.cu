// Dequantizing GEMM on Hopper tensor cores: the int8 feature-cache tier's
// leading product, with f32 operands as exact bf16 terms, a cp.async ring
// of w tiles and split K merged inside the one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/dequant_matmul.py:
// dequant_matmul_fwd (body _dqmm_kernel). It computes the same function:
//   out[m, n] = sum_k (f32(q[m, k]) * s(m, k)) * f32(w[k, n])
// with q [M, K] int8, f32 or bf16, w [K, N] f32 or bf16, and an f32 scale
// in one of three layouts: row s[m * s_stride] ([M, 1], or a 0-d scale
// with s_stride 0), col s[k] ([1, K]) or full s[m * K + k] ([M, K]). Sums
// are f32; out is f32 or bf16, written once. M, N and K are run-time
// values of 1 or more; tails are masked and nothing is padded. The
// dequantized operand never exists in device memory.
//
// Numerics. Every product runs on bf16 tensor cores (mma.sync m16n8k16,
// f32 accumulators) with operands that are exact:
//  * int8 q (|q| <= 127) and bf16 q are exact in bf16, and so is bf16 w.
//  * An f32 operand is split into three bf16 terms hi + mid + lo by
//    truncation (split3): hi is its top 8 significand bits, mid the next 8
//    of the remainder, lo the rest. The split is exact for |x| >= about
//    2^-110 (below, lo is a bf16 subnormal and drops bits) and never
//    overflows; each product of terms is exact in f32.
//  * Terms on the q side (TA) and on the w side (TW) are template
//    parameters. TA = 1 for int8 or bf16 q under a row (or 0-d) scale: the
//    scale multiplies a whole output row, so it is applied once, in the
//    f32 epilogue: out[m, n] = s[m] * sum_k q[m, k] w[k, n]. TA = 3 for a
//    col or full scale and for f32 q: the terms of a = fl(q s), formed per
//    element as the plain version does. TW = 1 for bf16 w, 3 for f32 w.
//    The main path's cases (int8 q, row scale, f32 or bf16 w) take 3 and
//    1 products. For 3 x 3, the six products whose terms' weights add to
//    at most 2^-16 are kept (hi hi; hi mid, mid hi; hi lo, lo hi, mid mid):
//    the dropped ones weigh 2^-24 and less, a rounding of f32 (the CPU
//    emulation in tests/test_torch_dequant_matmul.py holds the summation
//    bound with them dropped).
//  * In the 32- and 64-row classes hi x hi goes to one accumulator, the
//    smaller products (smallest first) to a second, and the two are added
//    once at the end: at a small K that sum is rounded to nearest once,
//    where one chain through the tensor cores would truncate (their
//    additions are not IEEE round-to-nearest). The 128-row class, taken
//    only from K 256 up, chains them in one accumulator, smallest first.
//  * A row whose scale is not finite takes the per-element route: its
//    outputs are summed on the CUDA cores as sum_k fma(q s, w), so they
//    carry the plain version's pattern of NaN and +-inf, and the epilogue
//    leaves them unscaled. Under TA = 3, a block that meets a non-finite a
//    or f32 w recomputes its whole tile so. (A +-inf in bf16 w under TA = 3
//    may come out NaN where the plain version gives +-inf.)
//
// Design. Products put N on the MMA's 16-row side and M on its 8-column
// side (out^T = w^T q^T), so a narrow M fills the columns:
//  * Tiles: a block owns BN output columns (n) and BM rows (m) of one K
//    slice, 16 n per warp with all of BM in each warp; the 16-deep MMA
//    steps of a k step are dealt to KG groups of such warps, whose sums
//    are added in group order at the end. M <= 32 takes BM 32 (BN 64,
//    64-deep steps, 2 groups of 4 warps), M <= 64 BM 64 (the same), else
//    BM 128 (BN 128, 32-deep steps, 2 groups of 8 warps, one accumulator
//    chain for registers; below K 256 such M takes the 64-row class).
//    Each w element lands in one warp and is split once a block; at M <=
//    64 the whole of M is in the block, so once in all.
//  * Ring: each k step's w tile, q tile (and a col or full scale tile)
//    arrive by cp.async in a ring of 4 stages in dynamic shared memory
//    (about 20 KB a stage at the main shape, so 60 KB is in flight an SM,
//    one block an SM), 16-byte copies where a row's byte stride and base
//    allow, with no masks for a whole tile; otherwise an out-of-line path
//    copies 8 or 4 bytes, or takes a masked element path (plain loads and
//    stores). A row's tail is zero-filled by the copy's source size. Rows
//    are padded so ldmatrix and the f32 fragment loads hit distinct
//    banks.
//  * One barrier a step: after it, the copies of the stage STAGES - 1
//    ahead go out; then per 16-deep k: w's A fragments (ldmatrix.trans for
//    bf16 w, or f32 loads split into three terms in registers), q's B
//    fragments by ldmatrix from bf16 planes [m][k], and the products;
//    then the next stage's q tile is converted into the other pair of
//    planes (dequantized and split for TA = 3).
//  * Split K in one launch: a plan that depends on the shape and the SM
//    count only (kernels/dequant_matmul.py:plan) cuts K into slices;
//    slice z covers [z per, (z + 1) per). Each block stores its f32
//    partial tile (in fragment order) to a workspace and counts itself in
//    on a per-tile counter; the block that arrives last sums the tile's
//    partials in slice order (all of a thread's loads in flight at once),
//    applies the epilogue and writes out, then sets the counter back to
//    0. A rerun gives equal bits. With one slice the block writes out
//    directly. (A merge through a cluster of a tile's 16 slices was
//    tried: at one block an SM, not every cluster fit the card at once.)
//  * Index math is 32-bit inside a tile; base pointers are 64-bit.
//
// Bound. At the main shape (M 32, K 16,384, N 512, int8 q, row scales,
// f32 w) w dominates the bytes (33.5 MB against 0.5 MB of q): 10.2 us at
// 3.35 TB/s, while the three bf16 products take 1.6 GFLOP, 1.6 us at 989
// TFLOP/s: bytes bound it, and each w element is read from device memory
// once. With bf16 w the bytes are 16.8 MB, 5.2 us. At M 4,096 the products
// bound it: 206 GFLOP, 0.208 ms. PERF.md has the times.

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum ScaleKind { kRow = 0, kCol = 1, kFull = 2 };
enum QType { kQInt8 = 0, kQF32 = 1, kQBF16 = 2 };
enum WType { kWF32 = 0, kWBF16 = 1 };
enum OType { kOF32 = 0, kOBF16 = 1 };

constexpr int kSmemBudget = 232448 - 1024;  // 227 KB, a block's most on
                                           // Hopper, less room for statics
constexpr int kMaxStages = 4;  // deeper rings ran no faster (PERF.md)
constexpr int kMaxExtent = 1 << 22;  // K and N at most (32-bit tile offsets)

struct Args {
  const void* q;
  const float* s;
  const void* w;
  float* ws;       // splits x tiles partial tiles (splits > 1)
  int* counters;   // one per tile, 0 between calls (splits > 1)
  void* out;
  int M, N, K, splits, per, s_stride, out_bf16;
  int vq, vs, vw;  // copy widths in bytes: 16, 8, 4, or 0 (element path)
};

// BM: rows of M a block owns; BN = 16 WN columns of N (16 a warp);
// BK-deep steps, whose 16-deep MMA steps are dealt to KG groups of WN
// warps; CHAIN: one accumulator chain (the 128-row class, for registers)
// rather than hi x hi apart from the smaller products.
template <int BM> struct Tile;
template <> struct Tile<32> {
  static constexpr int BN = 64, BK = 64, WN = 4, KG = 2;
  static constexpr bool CHAIN = false;
};
template <> struct Tile<64> {
  static constexpr int BN = 64, BK = 64, WN = 4, KG = 2;
  static constexpr bool CHAIN = false;
};
template <> struct Tile<128> {
  static constexpr int BN = 128, BK = 32, WN = 8, KG = 2;
  static constexpr bool CHAIN = true;
};

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int clog2(int v) { return v <= 1 ? 0 : 1 + clog2(v / 2); }

template <int BM, typename QT, int SK, typename WT>
struct Layout {
  static constexpr int BN = Tile<BM>::BN, BK = Tile<BM>::BK;
  static constexpr int WN = Tile<BM>::WN, KG = Tile<BM>::KG;
  static constexpr int THREADS = 32 * WN * KG, T0 = 32 * WN;  // all, group 0
  static constexpr int MT = BM / 8;  // m-tiles of 8 in a warp
  static constexpr int TA = SK == kRow && !std::is_same<QT, float>::value ? 1 : 3;
  static constexpr int TW = std::is_same<WT, float>::value ? 3 : 1;
  static constexpr bool SPLIT_SUMS = TA * TW > 1 && !Tile<BM>::CHAIN;
  static constexpr int EQ = sizeof(QT), EW = sizeof(WT);
  // bytes: a w row padded by 16 (f32: 4 floats, so the fragment loads of
  // rows 2 tig and columns gid fall in 32 banks; bf16: an odd number of
  // 16-byte units, for ldmatrix)
  static constexpr int W_PITCH = BN * EW + 16;
  static constexpr int Q_PITCH = BK * EQ;
  static constexpr int W_BYTES = BK * W_PITCH;
  static constexpr int Q_BYTES = BM * Q_PITCH;
  static constexpr int S_BYTES = SK == kCol ? BK * 4 : SK == kFull ? BM * BK * 4 : 0;
  static constexpr int STAGE = W_BYTES + Q_BYTES + S_BYTES;
  static constexpr int P_PITCH = BK * 2 + 16;  // a plane row: odd 16-byte units
  static constexpr int PLANE = BM * P_PITCH;
  static constexpr int FIXED = 2 * TA * PLANE + BM * 4;  // 2 planes, row scales
  static constexpr int STAGES = cmin(kMaxStages, (kSmemBudget - FIXED) / STAGE);
  // the k-groups' partial tiles, summed in the ring after the last step
  static constexpr int RED = (KG - 1) * BM * BN * 4;
  static constexpr int SMEM = FIXED + (STAGES * STAGE > RED ? STAGES * STAGE : RED);
  static_assert(BN == 16 * WN && MT % 2 == 0 && (BK / 16) % KG == 0, "warp layout");
  static_assert(STAGES >= 3, "ring depth");
  static_assert(STAGE % 16 == 0 && PLANE % 16 == 0 && W_BYTES % 16 == 0 &&
                Q_BYTES % 16 == 0, "16-byte alignment");
  static_assert(SMEM <= kSmemBudget, "shared memory");
};

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `vec` bytes at src into shared memory, of which the first `bytes` are
// copied and the rest zero-filled
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int vec, int bytes) {
  const auto g = __cvta_generic_to_global(src);
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(g), "r"(bytes) : "memory");
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(g), "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(g), "r"(bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int E> struct Word;
template <> struct Word<1> { using T = uint8_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<4> { using T = uint32_t; };

// A [ROWS][RB-byte] tile into shared memory at dst (row pitch P bytes) from
// src (row stride ld bytes) by V-byte cp.async: bytes c < vb of rows r <
// vr come from src, the rest are zero-filled.
template <int ROWS, int RB, int P, int V, int T>
__device__ __forceinline__ void copy_vec(unsigned char* dst,
                                         const unsigned char* src, int ld,
                                         int vr, int vb, int tid) {
  constexpr int CPR = RB / V;  // copies a row
  constexpr int N = ROWS * CPR;
  if (vr == ROWS && vb == RB) {  // a whole tile: no masks
#pragma unroll
    for (int j = 0; j < (N + T - 1) / T; ++j) {
      const int i = tid + j * T;
      if (N % T != 0 && i >= N) break;
      const int r = i / CPR, c = (i % CPR) * V;
      cp_async(smem_u32(dst + r * P + c), src + r * ld + c, V, V);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < (N + T - 1) / T; ++j) {
    const int i = tid + j * T;
    if (N % T != 0 && i >= N) break;
    const int r = i / CPR, c = (i % CPR) * V;
    const int bytes = r < vr ? min(max(vb - c, 0), V) : 0;
    cp_async(smem_u32(dst + r * P + c), bytes > 0 ? src + r * ld + c : src,
             V, bytes);
  }
}

// The same for rows that 16-byte copies do not fit (a byte stride or base
// off 16 bytes): cp.async of vec = 8 or 4 bytes, or, for vec = 0, plain
// loads and stores of E bytes (done on return). Out of line, so that its
// addresses take no registers in the main loop.
template <int ROWS, int RB, int P, int E, int T>
__device__ __noinline__ void copy_narrow(unsigned char* dst,
                                         const unsigned char* src, int ld,
                                         int vr, int vb, int vec, int tid) {
  if (vec == 8) {
    copy_vec<ROWS, RB, P, 8, T>(dst, src, ld, vr, vb, tid);
  } else if (vec == 4) {
    copy_vec<ROWS, RB, P, 4, T>(dst, src, ld, vr, vb, tid);
  } else {
    using W = typename Word<E>::T;
    constexpr int PER_ROW = RB / E;
    for (int i = tid; i < ROWS * PER_ROW; i += T) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * E;
      *reinterpret_cast<W*>(dst + r * P + c) =
          r < vr && c < vb ? *reinterpret_cast<const W*>(src + r * ld + c)
                           : W(0);
    }
  }
}

// A [ROWS][RB-byte] tile into shared memory at dst (row pitch P bytes) from
// src (row stride ld bytes): bytes c < vb of rows r < vr come from src, the
// rest are zeros. vec: the copy width (16, 8 or 4 bytes by cp.async, a
// row's last copy zero-filled past vb), or 0, the masked element path.
template <int ROWS, int RB, int P, int E, int T>
__device__ __forceinline__ void copy_tile(unsigned char* dst,
                                          const unsigned char* src, int ld,
                                          int vr, int vb, int vec, int tid) {
  if (vec == 16) {
    copy_vec<ROWS, RB, P, 16, T>(dst, src, ld, vr, vb, tid);
  } else {
    copy_narrow<ROWS, RB, P, E, T>(dst, src, ld, vr, vb, vec, tid);
  }
}

// Fragment loads and products are plain (not volatile) asm, so that the
// compiler may interleave them; a load keeps a memory clobber, so that none
// moves above a barrier.

// four 8x8 b16 matrices, lanes 8i..8i+7 giving the rows of matrix i
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

__device__ __forceinline__ float top16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// the upper halves of x (low 16 bits) and y (high 16 bits): (x, y) as a
// bf16 pair, exact when their low halves are zero
__device__ __forceinline__ uint32_t pack_top(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// (x, y) as three packed bf16 pairs by truncation: hi = top 8 significand
// bits, mid = the top 8 of the remainder, lo = what is left (at most 8
// bits). Each remainder is exact in f32, so hi + mid + lo == x for |x| >=
// about 2^-110. +-inf keeps all of itself in hi (mid = lo = 0); NaN stays
// NaN.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const float hx = top16(x), hy = top16(y);
  const float rx = hx == x ? 0.f : x - hx, ry = hy == y ? 0.f : y - hy;
  const float mx = top16(rx), my = top16(ry);
  hi = pack_top(x, y);
  mid = pack_top(rx, ry);
  lo = pack_top(rx - mx, ry - my);
}

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// eight q elements of a raw tile row as floats
__device__ __forceinline__ void load8(const int8_t* p, float v[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * i)));
    v[4 + i] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * i)));
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <int SK>
__device__ __forceinline__ float scale_at(const Args& a, int m, int k) {
  if constexpr (SK == kRow) return a.s[static_cast<long long>(m) * a.s_stride];
  if constexpr (SK == kCol) return a.s[k];
  return a.s[static_cast<long long>(m) * a.K + k];
}

// Fragment element e of m-tile j of group-0 thread t is output row 8 j +
// 2 tig + (e & 1) and column 16 warp + gid + 8 (e >> 1) of the tile.
__device__ __forceinline__ int frag_m(int j, int t, int e) {
  return 8 * j + 2 * (t & 3) + (e & 1);
}
__device__ __forceinline__ int frag_n(int t, int e) {
  return (t >> 5) * 16 + ((t & 31) >> 2) + 8 * (e >> 1);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int BM, typename QT, int SK, typename WT>
__global__ void __launch_bounds__(Layout<BM, QT, SK, WT>::THREADS, 1)
    dequant_matmul_kernel(const Args a) {
  using L = Layout<BM, QT, SK, WT>;
  constexpr int BN = L::BN, BK = L::BK, T = L::THREADS, T0 = L::T0;
  constexpr int MT = L::MT, KG = L::KG;
  constexpr int TA = L::TA, TW = L::TW, STAGES = L::STAGES;
  constexpr int RESTS = L::SPLIT_SUMS ? MT : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  unsigned char* planes = smem;
  float* srow = reinterpret_cast<float*>(smem + 2 * TA * L::PLANE);
  unsigned char* ring = smem + L::FIXED;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wn = warp % L::WN, group = warp / L::WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const int kb = z * a.per, ke = min(a.K, kb + a.per);
  const int nsteps = (ke - kb + BK - 1) / BK;
  const int vm = min(BM, a.M - m0), vn = min(BN, a.N - n0);

  const unsigned char* qg = static_cast<const unsigned char*>(a.q) +
      (static_cast<long long>(m0) * a.K + kb) * L::EQ;
  const unsigned char* wg = static_cast<const unsigned char*>(a.w) +
      (static_cast<long long>(kb) * a.N + n0) * L::EW;
  const unsigned char* sg = reinterpret_cast<const unsigned char*>(a.s) +
      (SK == kFull ? (static_cast<long long>(m0) * a.K + kb) * 4
                   : static_cast<long long>(kb) * 4);
  const int ldq = a.K * L::EQ, ldw = a.N * L::EW;

  auto load_stage = [&](int st) {
    unsigned char* slot = ring + (st % STAGES) * L::STAGE;
    const int k0 = st * BK, vk = min(BK, ke - kb - k0);
    copy_tile<BK, BN * L::EW, L::W_PITCH, L::EW, T>(
        slot, wg + static_cast<long long>(k0) * ldw, ldw, vk, vn * L::EW,
        a.vw, tid);
    copy_tile<BM, BK * L::EQ, L::Q_PITCH, L::EQ, T>(
        slot + L::W_BYTES, qg + k0 * L::EQ, ldq, vm, vk * L::EQ, a.vq, tid);
    if constexpr (SK == kCol) {
      copy_tile<1, BK * 4, BK * 4, 4, T>(slot + L::W_BYTES + L::Q_BYTES,
                                         sg + k0 * 4, 0, 1, vk * 4, a.vs,
                                         tid);
    } else if constexpr (SK == kFull) {
      copy_tile<BM, BK * 4, BK * 4, 4, T>(slot + L::W_BYTES + L::Q_BYTES,
                                          sg + k0 * 4, a.K * 4, vm, vk * 4,
                                          a.vs, tid);
    }
  };

  // the ring's first stages, then the row scales: their finiteness, and
  // their values for the conversion (TA = 3) and the epilogue (TA = 1)
#pragma unroll 1
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load_stage(st);
    cp_async_commit();
  }
  bool rows_bad = false;
  if constexpr (SK == kRow) {
    if (tid < BM) {
      const float sv = tid < vm ? scale_at<kRow>(a, m0 + tid, 0) : 1.f;
      srow[tid] = sv;
      rows_bad = !finite(sv);
    }
  }
  rows_bad = __syncthreads_or(rows_bad);

  float acc[MT][4], rest[RESTS][4];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < RESTS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) rest[j][e] = 0.f;
  }
  bool bad = false;  // TA = 3: a non-finite a or f32 w met

  // ldmatrix lane offsets: B from the planes' [m][k] rows (matrices: m-tile
  // 2jp k 0-7, k 8-15, m-tile 2jp+1 k 0-7, k 8-15); A of w^T from w's [k][n]
  // rows, .trans (a0: k 0-7 n 0-7, a1: n 8-15, a2: k 8-15, a3: both)
  const int b_row = ((lane >> 4) << 3) + (lane & 7), b_col = ((lane >> 3) & 1) * 16;
  const int t_k = ((lane >> 4) << 3) + (lane & 7), t_n = (((lane >> 3) & 1) << 3) + wn * 16;

  // q tile of stage st -> bf16 planes [m][k] of buffer st & 1, in groups
  // of 8 k
  auto convert = [&](int st) {
    constexpr int G = BM * BK / 8;
    const unsigned char* slot = ring + (st % STAGES) * L::STAGE;
    const QT* qs = reinterpret_cast<const QT*>(slot + L::W_BYTES);
    const float* ss = reinterpret_cast<const float*>(slot + L::W_BYTES + L::Q_BYTES);
    unsigned char* pl = planes + (st & 1) * TA * L::PLANE;
#pragma unroll
    for (int i = 0; i < (G + T - 1) / T; ++i) {
      const int g = tid + i * T;
      if (G % T != 0 && g >= G) break;
      const int m = g / (BK / 8), kc = (g % (BK / 8)) * 8;
      float v[8];
      load8(qs + m * BK + kc, v);
      unsigned char* dst = pl + m * L::P_PITCH + kc * 2;
      if constexpr (TA == 1) {
        uint4 o;
        o.x = pack_top(v[0], v[1]);  // exact: int8 and bf16 values
        o.y = pack_top(v[2], v[3]);
        o.z = pack_top(v[4], v[5]);
        o.w = pack_top(v[6], v[7]);
        *reinterpret_cast<uint4*>(dst) = o;
      } else {
        float sv[8];
        if constexpr (SK == kRow) {
#pragma unroll
          for (int e = 0; e < 8; ++e) sv[e] = srow[m];
        } else if constexpr (SK == kCol) {
          load8(ss + kc, sv);
        } else {
          load8(ss + m * BK + kc, sv);
        }
        uint32_t h[4], md[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = v[2 * e] * sv[2 * e], y = v[2 * e + 1] * sv[2 * e + 1];
          bad |= !finite(x) || !finite(y);
          split3(x, y, h[e], md[e], lo[e]);
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(dst + L::PLANE) = make_uint4(md[0], md[1], md[2], md[3]);
        *reinterpret_cast<uint4*>(dst + 2 * L::PLANE) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
  };

  // One barrier a step. Step s: the planes of stage s (converted during
  // step s - 1) and stage s + 1 are in, and every warp is done with step
  // s - 1; the copies of stage s + STAGES - 1 go out into the slot that
  // step s - 1 freed; the products of stage s; then stage s + 1's q into
  // the other planes.
  cp_async_wait<STAGES - 2>();
  __syncthreads();  // stage 0 is in
  convert(0);
#pragma unroll 1
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (step + STAGES - 1 < nsteps) load_stage(step + STAGES - 1);
    cp_async_commit();
    const unsigned char* slot = ring + (step % STAGES) * L::STAGE;
    const uint32_t planes_u = smem_u32(planes + (step & 1) * TA * L::PLANE);

    // this group's 16-deep steps: group, group + KG, ...
#pragma unroll
    for (int i = 0; i < BK / 16 / KG; ++i) {
      const int kk = group + i * KG;
      uint32_t A[TW][4];
      if constexpr (TW == 1) {
        ldmatrix_x4_trans(A[0], smem_u32(slot) + (kk * 16 + t_k) * L::W_PITCH + t_n * 2);
      } else {
        constexpr int R = L::W_PITCH / 4;  // floats a row
        const float* wf = reinterpret_cast<const float*>(slot) +
                          (kk * 16 + 2 * tig) * R + wn * 16 + gid;
        const float x0 = wf[0], x1 = wf[R], x2 = wf[8], x3 = wf[R + 8];
        const float x4 = wf[8 * R], x5 = wf[9 * R], x6 = wf[8 * R + 8], x7 = wf[9 * R + 8];
        if constexpr (TA == 3) {
          bad |= !finite(x0) || !finite(x1) || !finite(x2) || !finite(x3) ||
                 !finite(x4) || !finite(x5) || !finite(x6) || !finite(x7);
        }
        split3(x0, x1, A[0][0], A[1][0], A[2][0]);
        split3(x2, x3, A[0][1], A[1][1], A[2][1]);
        split3(x4, x5, A[0][2], A[1][2], A[2][2]);
        split3(x6, x7, A[0][3], A[1][3], A[2][3]);
      }
#pragma unroll
      for (int jp = 0; jp < MT / 2; ++jp) {
        uint32_t B[TA][4];
#pragma unroll
        for (int t = 0; t < TA; ++t) {
          ldmatrix_x4(B[t], planes_u + t * L::PLANE +
                                (jp * 16 + b_row) * L::P_PITCH + kk * 32 + b_col);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * jp + h;
          // the smaller products first, into their own sums unless CHAIN
          float* r = L::SPLIT_SUMS ? rest[RESTS == MT ? j : 0] : acc[j];
          if constexpr (TW == 3 && TA == 3) {
            mma_16816(r, A[2], B[0] + 2 * h);
            mma_16816(r, A[0], B[2] + 2 * h);
            mma_16816(r, A[1], B[1] + 2 * h);
            mma_16816(r, A[1], B[0] + 2 * h);
            mma_16816(r, A[0], B[1] + 2 * h);
          } else if constexpr (TW == 3) {
            mma_16816(r, A[2], B[0] + 2 * h);
            mma_16816(r, A[1], B[0] + 2 * h);
          } else if constexpr (TA == 3) {
            mma_16816(r, A[0], B[2] + 2 * h);
            mma_16816(r, A[0], B[1] + 2 * h);
          }
          mma_16816(acc[j], A[0], B[0] + 2 * h);
        }
      }
    }
    if (step + 1 < nsteps) convert(step + 1);
  }
  cp_async_wait<0>();

  if constexpr (RESTS == MT) {
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += rest[j][e];
    }
  }
  const bool slow = TA == 1 ? rows_bad : static_cast<bool>(__syncthreads_or(bad));
  // the k-groups' sums into group 0's, in group order, through the ring
  if constexpr (KG > 1) {
    if constexpr (TA == 1) __syncthreads();  // every warp is done with the ring
    float* red = reinterpret_cast<float*>(ring);
    const int t = tid % T0;
    if (group > 0) {
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        reinterpret_cast<float4*>(red)[((group - 1) * MT + j) * T0 + t] =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();
    if (group == 0) {
#pragma unroll 1
      for (int g = 1; g < KG; ++g) {
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const float4 v = reinterpret_cast<const float4*>(red)[((g - 1) * MT + j) * T0 + t];
          acc[j][0] += v.x;
          acc[j][1] += v.y;
          acc[j][2] += v.z;
          acc[j][3] += v.w;
        }
      }
    }
  }

  if (group == 0 && slow) {
    // the per-element route (TA = 1: the rows whose scale is not finite,
    // left unscaled by the epilogue; TA = 3: the whole tile)
    const QT* q = static_cast<const QT*>(a.q);
    const WT* w = static_cast<const WT*>(a.w);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ml = frag_m(j, tid, e), nl = frag_n(tid, e);
        if (ml >= vm || nl >= vn) continue;
        if (TA == 1 && finite(srow[ml])) continue;
        const int m = m0 + ml, n = n0 + nl;
        float v = 0.f;
#pragma unroll 1
        for (int k = kb; k < ke; ++k) {
          v = fmaf(widen(q[static_cast<long long>(m) * a.K + k]) * scale_at<SK>(a, m, k),
                   widen(w[static_cast<long long>(k) * a.N + n]), v);
        }
        acc[j][e] = v;
      }
    }
  }

  // epilogue of fragment (j, t): the row scale (TA = 1, finite rows), out's
  // dtype
  auto store = [&](const float v[4], int j, int t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ml = frag_m(j, t, e), nl = frag_n(t, e);
      if (ml >= vm || nl >= vn) continue;
      float x = v[e];
      if constexpr (TA == 1) {
        const float sv = srow[ml];
        if (finite(sv)) x *= sv;
      }
      const long long o = static_cast<long long>(m0 + ml) * a.N + n0 + nl;
      if (a.out_bf16) {
        static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(x);
      } else {
        static_cast<float*>(a.out)[o] = x;
      }
    }
  };

  if (a.splits == 1) {
    if (group == 0) {
#pragma unroll
      for (int j = 0; j < MT; ++j) store(acc[j], j, tid);
    }
    return;
  }

  // split K: this slice's partial tile (fragment order) into the
  // workspace; the tile's last block sums every slice's, in slice order
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float4* part = reinterpret_cast<float4*>(a.ws) +
                 static_cast<long long>(tile) * a.splits * (MT * T0);
  if (group == 0) {
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      part[static_cast<long long>(z) * (MT * T0) + j * T0 + tid] =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the block's partial, ordered by the barrier, first
    last = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll 1
  for (int u = tid; u < MT * T0; u += T) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 16
    for (int zz = 0; zz < a.splits; ++zz) {
      const float4 p = __ldcg(part + static_cast<long long>(zz) * (MT * T0) + u);
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    }
    store(v, u / T0, u % T0);
  }
  if (tid == 0) a.counters[tile] = 0;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Once per (device, kernel): the kernel may use its dynamic shared memory.
int prepare(const void* fn, int smem) {
  struct Ready { int device; const void* fn; };
  static Ready ready[256];
  static int n_ready = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < n_ready; ++i) {
    if (ready[i].device == device && ready[i].fn == fn) return 0;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ready < 256) ready[n_ready++] = {device, fn};
  return 0;
}

template <int BM, typename QT, int SK, typename WT>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<BM, QT, SK, WT>;
  const void* fn = reinterpret_cast<const void*>(&dequant_matmul_kernel<BM, QT, SK, WT>);
  const int err = prepare(fn, L::SMEM);
  if (err != 0) return err;
  const dim3 grid((a.N + L::BN - 1) / L::BN, (a.M + BM - 1) / BM, a.splits);
  dequant_matmul_kernel<BM, QT, SK, WT><<<grid, L::THREADS, L::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, typename QT, typename WT>
int launch_scale(const Args& a, int scale_kind, cudaStream_t stream) {
  switch (scale_kind) {
    case kRow: return launch<BM, QT, kRow, WT>(a, stream);
    case kCol: return launch<BM, QT, kCol, WT>(a, stream);
    default: return launch<BM, QT, kFull, WT>(a, stream);
  }
}

template <int BM, typename QT>
int launch_w(const Args& a, int scale_kind, int w_type, cudaStream_t stream) {
  return w_type == kWF32 ? launch_scale<BM, QT, float>(a, scale_kind, stream)
                         : launch_scale<BM, QT, __nv_bfloat16>(a, scale_kind, stream);
}

template <int BM>
int launch_q(const Args& a, int q_type, int scale_kind, int w_type,
             cudaStream_t stream) {
  switch (q_type) {
    case kQInt8: return launch_w<BM, int8_t>(a, scale_kind, w_type, stream);
    case kQF32: return launch_w<BM, float>(a, scale_kind, w_type, stream);
    default: return launch_w<BM, __nv_bfloat16>(a, scale_kind, w_type, stream);
  }
}

// the widest copy (16, 8 or 4 bytes) that the base and the row stride
// allow, or 0 (the element path)
int vec_of(const void* p, long long ld_bytes) {
  const auto addr = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v >= 4; v /= 2) {
    if (addr % v == 0 && ld_bytes % v == 0) return v;
  }
  return 0;
}

}  // namespace

// q_type: 0 int8, 1 f32, 2 bf16; w_type: 0 f32, 1 bf16; out_type: 0 f32,
// 1 bf16; scale_kind: 0 row (s[m * s_stride]; s_stride 0 for a 0-d
// scale), 1 col, 2 full. block_m: 32, 64 or 128 (the tile class,
// kernels/dequant_matmul.py:block_m). With splits > 1, ws holds splits x
// tiles x block_m x BN f32 partials and counters one int per tile, all 0
// (the kernel leaves them 0); with one slice both may be null.
// k_per_split is a multiple of the class's step and splits * k_per_split
// covers K with no empty slice. Launches on `stream` and returns
// cudaGetLastError() as an int (0 on success); the caller raises on
// anything else.
extern "C" int dequant_matmul_launch(const void* q, int q_type,
                                     const void* scale, int scale_kind,
                                     int s_stride, const void* w, int w_type,
                                     void* ws, void* counters, void* out,
                                     int out_type, int M, int N, int K,
                                     int block_m, int splits, int k_per_split,
                                     void* stream) {
  const int bk = block_m == 128 ? Tile<128>::BK : block_m == 64 ? Tile<64>::BK : Tile<32>::BK;
  if (M <= 0 || N <= 0 || K <= 0 || N > kMaxExtent || K > kMaxExtent ||
      (block_m != 32 && block_m != 64 && block_m != 128) ||
      splits <= 0 || splits > 65535 || k_per_split <= 0 ||
      k_per_split % bk != 0 ||
      static_cast<long long>(splits - 1) * k_per_split >= K ||
      static_cast<long long>(splits) * k_per_split < K ||
      (M + block_m - 1) / block_m > 65535 || q_type < 0 || q_type > 2 ||
      w_type < 0 || w_type > 1 || out_type < 0 || out_type > 1 ||
      scale_kind < 0 || scale_kind > 2 || s_stride < 0 ||
      (splits > 1 && (ws == nullptr || counters == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int eq = q_type == kQInt8 ? 1 : q_type == kQF32 ? 4 : 2;
  const int ew = w_type == kWF32 ? 4 : 2;
  Args a;
  a.q = q;
  a.s = static_cast<const float*>(scale);
  a.w = w;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.splits = splits;
  a.per = k_per_split;
  a.s_stride = s_stride;
  a.out_bf16 = out_type == kOBF16;
  a.vq = vec_of(q, static_cast<long long>(K) * eq);
  a.vw = vec_of(w, static_cast<long long>(N) * ew);
  a.vs = vec_of(scale, static_cast<long long>(K) * 4);  // col and full tiles
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block_m) {
    case 32: return launch_q<32>(a, q_type, scale_kind, w_type, st);
    case 64: return launch_q<64>(a, q_type, scale_kind, w_type, st);
    default: return launch_q<128>(a, q_type, scale_kind, w_type, st);
  }
}

extern "C" const char* dequant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
