// Causal / full GQA flash attention forward on Hopper: a ring of K and V
// tiles filled by the Tensor Memory Accelerator and shared by the q heads
// of one kv head, mma.sync products, head dims at run time.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd (body _flash_fwd_kernel). It computes the same
// function: o = softmax(scale * q k^T [causal mask]) v per (batch, q head),
// with q [B, S, Hq, dk], k [B, S, Hkv, dk], v [B, S, Hkv, dv], Hq % Hkv ==
// 0, and each q head h reading kv head h / (Hq / Hkv), as the Pallas index
// maps do, so kv is never repeated in memory. Scores are f32 and scaled in
// f32; masked scores (causal: col > row; col >= S) are -1e30; the running
// max m, denominator l and accumulator stay f32; l is clamped at 1e-30; the
// output [B, S, Hq, dv] is written in the input dtype.
//
// Bound. Causal attention needs 2 (dk + dv) B Hq flops per (query, key)
// pair, S (S + 1) / 2 pairs, and moves q, k, v and o once: at the
// Llama-3-8B training shape (B 4, S 1024, Hq 32, Hkv 8, d 128, bf16) 34.4
// GFLOP against 84 MB, so the tensor cores bound it (0.035 ms at 989
// TFLOP/s). The design keeps the tensor cores of every sub-partition of
// the SM fed:
//
//  * Grid. The Pallas grid walks the kv blocks of one (q block, q head) in
//    order with m, l and the accumulator in VMEM; here that walk is a loop
//    inside one block. A block serves one batch row, one kv head, a chunk
//    of `heads` of its q heads (a power of two dividing the group and the
//    warp count) and `positions` query positions: 16 rows a warp, 128
//    rows for 8 warps, and every staged K/V byte feeds them all, so the
//    heads of one group stage a tile once, not once each. Warp w owns 16
//    consecutive positions of one head, so each row's causal limit is its
//    own position. grid.y runs over position tiles in reverse, so the
//    tiles with the most kv tiles start first.
//  * Ring. K and V tiles arrive by cp.async.bulk.tensor in `stages` slots
//    of dynamic shared memory, each completing on its slot's "full"
//    mbarrier. There is no producer warp: a ninth warp puts three warps on
//    one of the SM's four register files and holds every thread to 168
//    registers, where the bf16 kernel spills; 8 warps keep 255. Thread 0
//    starts the ring, and the warp that is the last to be done with a
//    tile, counted by a shared-memory atomic per slot, copies the tile
//    `stages` ahead into the slot it frees, so no warp waits to refill.
//    K and V are seen as 4-D tensors [B, S, Hkv, d]: a box never crosses
//    into another head or batch row, and rows past S and columns past d
//    arrive as the TMA's zeros, so a ragged tail needs no bounds in the
//    copy. The loop stops at the block's causal limit (the pl.when skip of
//    the reference), and a warp whose rows all lie before a tile skips it:
//    every warp waits on and counts out of every tile, so the ring's laps
//    stay in step, but no row meets a tile that is masked for it
//    everywhere (an all-masked first tile would leave m at -1e30 and give
//    exp(s - m) = 1). Masks stay on the scores: a zero row of the TMA
//    scores 0, not -1e30.
//  * q is read once from device memory into shared memory (every load of
//    a lane issued before its first store); bf16 up to the 128 ceiling
//    keeps its fragments in registers, at 256 ldmatrix reads them at each
//    tile.
//  * bf16: tensor cores, mma.sync m16n8k16 (bf16 in, f32 sums), 64-row kv
//    tiles. bf16 tiles are 64-column regions of 128-byte rows that the
//    TMA writes swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)),
//    so the ldmatrix reads of 8 rows hit 8 bank groups: ldmatrix.x4 for K
//    in q k^T, ldmatrix.x4.trans for V in p v. The Pallas kernel computes
//    p v in f32; here p is split into two bf16 terms, hi = bf16(p) and lo
//    = bf16(p - hi), and p v is two products, so p keeps about 16 bits and
//    the output stays within one bf16 rounding of the f32 plain version.
//    Softmax weights are powers of 2 of scores scaled by scale * log2(e),
//    one MUFU instruction each.
//  * f32: true f32 on the CUDA cores (TF32 stays off, as in the rest of the
//    port), 32-row kv tiles, 8 warps (4 at widths past 128), two lanes a
//    query row, each holding every other 16-byte vector of the row's
//    accumulator; q is read from shared memory once per vector and tile;
//    exp as the reference's.
//  * Head dims at run time. dk and dv are separate widths up to 256, each a
//    whole number of 16-byte vectors. A few register ceilings, not one
//    kernel a width: bf16 64, 96, 128 and 256 columns, f32 64, 128 and
//    256. A bf16 slot holds the ceiling's regions of K and of V, so every
//    16-column step of the ceiling runs with no branch around the
//    warp-wide loads and products: a step past a width reads the TMA's
//    zero columns, times zero q columns or into outputs that are dropped.
//    In f32 a lane's vector loops stop at the width.
//
// The launch is a plain <<<>>> launch on the caller's stream.
// kernels/flash_attention.py:plan chooses heads, warps and stages.

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes via cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMmaRows = 16;      // query rows of one warp
constexpr int kMaxWarps = 8;      // warps of a block at most
constexpr int kMaxHeads = 8;      // q heads a block serves at most
constexpr int kKvBf16 = 64;       // kv rows of a ring slot, bf16
constexpr int kKvF32 = 32;        // kv rows of a ring slot, f32
constexpr int kSwizzleCols = 64;  // bf16 columns of one swizzled region
constexpr int kRegionBytes = kKvBf16 * 128;  // one region of a bf16 slot
constexpr int kMaxStages = 4;
constexpr int kMaxDim = 256;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on Hopper
constexpr float kMasked = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// error codes past CUDA's own (returned negative)
constexpr int kErrArgs = -1;
constexpr int kErrEncoder = -3;
constexpr int kErrTensorMap = -4;

__host__ __device__ __forceinline__ int regions(int d) {
  return (d + kSwizzleCols - 1) / kSwizzleCols;
}

// bytes of one ring slot: K's tile, then V's. bf16: the ceiling's
// 64-column regions of each, so that every step of the ceiling reads
// inside the slot (columns past the width are the TMA's zeros); f32: the
// rows as they are.
__host__ __device__ __forceinline__ int slot_bytes(int dk, int dv, int elt,
                                                   int ceiling) {
  return elt == 2 ? 2 * regions(ceiling) * kRegionBytes
                  : kKvF32 * (dk + dv) * 4;
}

// bytes of one query row in shared memory. bf16: the ceiling's columns
// (every step of the ceiling reads q; zeros past dk), an odd number of
// 16-byte units, so that ldmatrix's 8 rows at one column hit 8 bank
// groups. f32: dk, a number of 16-byte units that is 2 mod 4, so that the
// 8 lanes of a quarter warp (4 rows x 2 vectors) hit 8 bank groups.
__host__ __device__ __forceinline__ int q_pitch(int dk, int ceiling,
                                                int elt) {
  if (elt == 2) return 16 * ((ceiling * 2 / 16) | 1);
  const int u = dk * 4 / 16;
  return 16 * (u + (6 - u % 4) % 4);
}

// Shared memory of one block, after 1024 bytes of alignment slack (the
// swizzle's period): the ring's slots, the warps' q rows, a "full"
// mbarrier and a counter a slot (16 bytes).
__host__ __device__ __forceinline__ int smem_bytes(int dk, int dv, int elt,
                                                   int ceiling, int warps,
                                                   int stages) {
  return 1024 + stages * slot_bytes(dk, dv, elt, ceiling)
         + warps * kMmaRows * q_pitch(dk, ceiling, elt) + 16 * stages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map at (column, head, row, batch row) into
// shared memory, completing its bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// 2^x in one MUFU instruction (max relative error about 2^-22; results
// below 2^-126 flush to 0, far under what a softmax weight can matter)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void sts16(void* p, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(smem_u32(p)), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 lds16f(const void* p) {
  float4 r;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "r"(smem_u32(p)));
  return r;
}

// Fragment loads and products are plain (not volatile) asm, so that the
// compiler may issue the next loads before the last products; a load
// keeps a memory clobber, so that none moves above a barrier wait.

// four 8x8 b16 matrices at a shared-memory address, lanes 8i..8i+7
// giving the rows of matrix i
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

struct Maps {
  CUtensorMap k, v;
};

// Where a block and its warps sit, and how far they read; the same in
// both dtypes (kv: rows of a ring slot).
struct Tile {
  int b, hk, h, p0, pw0, nt, nt_w;
};

__device__ __forceinline__ Tile locate(int S, int Hq, int Hkv, int heads,
                                       int n_chunks, int warps, int warp,
                                       int causal, int kv) {
  Tile t;
  const int g = Hq / Hkv;
  const int bx = blockIdx.x;
  t.b = bx / (Hkv * n_chunks);
  t.hk = (bx / n_chunks) % Hkv;
  const int chunk = bx % n_chunks;
  const int positions = warps * kMmaRows / heads;
  // reversed: the position tiles with the most kv tiles start first
  t.p0 = (gridDim.y - 1 - blockIdx.y) * positions;
  const int groups = warps / heads;  // 16-position groups of one head
  t.h = t.hk * g + chunk * heads + warp / groups;
  t.pw0 = t.p0 + (warp % groups) * kMmaRows;
  t.nt = (S + kv - 1) / kv;
  if (causal) t.nt = min(t.nt, (min(t.p0 + positions, S) - 1) / kv + 1);
  // the tiles this warp computes on: up to its own last row's limit
  t.nt_w = t.nt;
  if (t.pw0 >= S) {
    t.nt_w = 0;
  } else if (causal) {
    t.nt_w = min(t.nt, (min(t.pw0 + kMmaRows, S) - 1) / kv + 1);
  }
  return t;
}

// One tile a step through the ring of `stages` slots. Thread 0 starts the
// ring; after that the warp that is the last to be done with tile t copies
// tile t + stages into its slot, so no warp ever waits to refill. `done`
// counts, per slot, the warps that have passed it on every lap.
// `copy(t)` issues tile t's boxes, completing on the slot's "full" barrier.
__device__ __forceinline__ void ring_init(uint64_t* full, int* done,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(full + i, 1);
      done[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <typename Copy>
__device__ __forceinline__ void ring_start(int nt, int stages,
                                           const Copy& copy) {
  if (threadIdx.x == 0) {
    for (int t = 0; t < min(stages, nt); ++t) copy(t);
  }
}

// After a warp's last read of tile t's slot (its fragments are in
// registers): count the warp out of the slot, and the last one in refills
// it. The reads are ordered before the bulk copy's writes by the
// shared-memory atomic and a proxy fence.
template <typename Copy>
__device__ __forceinline__ void ring_release(int t, int nt, int stages,
                                             int warps, int* done, int lane,
                                             const Copy& copy) {
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();
    const int before = atomicAdd(done + t % stages, 1);
    if (before == (t / stages + 1) * warps - 1 && t + stages < nt) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      copy(t + stages);
    }
  }
}

template <int CEIL>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) flash_fwd_bf16(
    const __grid_constant__ Maps maps, const __nv_bfloat16* __restrict__ q,
    __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv, int dk, int dv,
    int heads, int n_chunks, int stages, float scale_log2, int causal) {
  constexpr int NK = CEIL / 16;  // 16-column steps of the ceiling
  constexpr int NR = (CEIL + kSwizzleCols - 1) / kSwizzleCols;  // regions
  constexpr bool kQRegs = CEIL <= 128;  // q's fragments held in registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warps = blockDim.x / 32;
  const int sb = slot_bytes(dk, dv, 2, CEIL);
  const int qp = q_pitch(dk, CEIL, 2);
  unsigned char* qs = base + stages * sb;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + warps * kMmaRows * qp);
  int* done = reinterpret_cast<int*>(full + stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tile at = locate(S, Hq, Hkv, heads, n_chunks, warps, warp, causal,
                         kKvBf16);
  // tile t: the ceiling's regions of K, then of V; a region past a width
  // is out of bounds and arrives as zeros
  const auto copy = [&](int t) {
    const int st = t % stages;
    bar_expect_tx(full + st, sb);
    unsigned char* dst = base + st * sb;
    for (int r = 0; r < NR; ++r) {
      tma_load_4d(dst + r * kRegionBytes, &maps.k, r * kSwizzleCols, at.hk,
                  t * kKvBf16, at.b, full + st);
    }
    for (int r = 0; r < NR; ++r) {
      tma_load_4d(dst + (NR + r) * kRegionBytes, &maps.v, r * kSwizzleCols,
                  at.hk, t * kKvBf16, at.b, full + st);
    }
  };
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&maps.k)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&maps.v)) : "memory");
  }
  ring_init(full, done, stages);
  ring_start(at.nt, stages, copy);

  // this warp's 16 q rows into shared memory: zeros past S and past dk.
  // Every load is issued before the first store, so that the lane waits
  // for device memory once, not once a vector.
  unsigned char* qw = qs + warp * kMmaRows * qp;
  {
    constexpr int kVecs = CEIL / 8;  // 16-byte vectors of a ceiling row
    constexpr int kPer = kMmaRows * kVecs / 32;  // vectors of a lane
    const int nvq = dk / 8;
    uint4 val[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = lane + 32 * j, r = i / kVecs, c = i % kVecs;
      const int pos = at.pw0 + r;
      val[j] = make_uint4(0u, 0u, 0u, 0u);
      if (pos < S && c < nvq) {
        val[j] = ldg16(q + ((static_cast<long long>(at.b) * S + pos) * Hq
                            + at.h) * dk + c * 8);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = lane + 32 * j;
      sts16(qw + (i / kVecs) * qp + (i % kVecs) * 16, val[j]);
    }
  }
  __syncwarp();

  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix addresses of this lane. q as A fragments: row lane % 16,
  // 8-column half lane / 16, step kk at + 32 kk. K, as the B operand of
  // q k^T (16 kv rows x 16 columns a load): kv row 8 (lane / 16) + lane %
  // 8, half (lane / 8) % 2. V, .trans, as the B operand of p v: kv row
  // lane % 8 + 8 ((lane / 8) % 2), half lane / 16. Each row is 8-aligned
  // plus lane % 8, so the swizzle puts chunk 2 (step % 4) + half at that
  // xor lane % 8: four offsets in a slot a lane, one for each step % 4;
  // the region and the row step are constants of the unrolled loops.
  const uint32_t qa = smem_u32(qw + (lane & 15) * qp + (lane >> 4) * 16);
  uint32_t qf[kQRegs ? NK : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) ldmatrix_x4(qf[kk], qa + kk * 32);
  }
  uint32_t koff[4], voff[4];
  {
    const int k_row = ((lane >> 4) << 3) + (lane & 7);
    const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int xk = ((lane >> 3) & 1) ^ (lane & 7);
    const int xv = (lane >> 4) ^ (lane & 7);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      koff[j] = k_row * 128 + (((2 * j) ^ xk) << 4);
      voff[j] = NR * kRegionBytes + v_row * 128 + (((2 * j) ^ xv) << 4);
    }
  }

  float acc[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  // running max (scores in base 2) and this lane's share of l, rows gid
  // and gid + 8
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  const int r0 = at.pw0 + gid, r1 = r0 + 8;

  for (int t = 0; t < at.nt; ++t) {
    const int st = t % stages;
    bar_wait(full + st, (t / stages) & 1);
    if (t < at.nt_w) {
      const uint32_t slot = smem_u32(base) + st * sb;
      // S = q k^T: 8 n-tiles of 8 kv rows; steps past dk read zero
      // columns of K and of q
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t a[4];
        if constexpr (kQRegs) {
          a[0] = qf[kk][0];
          a[1] = qf[kk][1];
          a[2] = qf[kk][2];
          a[3] = qf[kk][3];
        } else {
          ldmatrix_x4(a, qa + kk * 32);
        }
        const uint32_t kb = slot + koff[kk & 3] + (kk >> 2) * kRegionBytes;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, kb + np * 16 * 128);
          mma_16816(s[2 * np], a, bk);
          mma_16816(s[2 * np + 1], a, bk + 2);
        }
      }
      // scale into base 2; mask past S and above the diagonal
      const int kv0 = t * kKvBf16;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
      }
      if (kv0 + kKvBf16 > S || (causal && kv0 + kKvBf16 - 1 > at.pw0)) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + n * 8 + 2 * tig + (e & 1);
            const int row = e < 2 ? r0 : r1;
            if (col >= S || (causal && col > row)) s[n][e] = kMasked;
          }
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = ex2(m0 - mx0), c1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = ex2(s[n][0] - m0);
        s[n][1] = ex2(s[n][1] - m0);
        s[n][2] = ex2(s[n][2] - m1);
        s[n][3] = ex2(s[n][3] - m1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n) {
        acc[n][0] *= c0;
        acc[n][1] *= c0;
        acc[n][2] *= c1;
        acc[n][3] *= c1;
      }
      // O += P V, P as A fragments in hi + lo bf16 terms; steps past dv
      // read zero columns into outputs that are dropped
#pragma unroll
      for (int kk = 0; kk < kKvBf16 / 16; ++kk) {
        uint32_t hi[4], lo[4];
        pack_split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        pack_split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        pack_split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        pack_split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int ms = 0; ms < NK; ++ms) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, slot + voff[ms & 3] + (ms >> 2) * kRegionBytes
                                    + kk * 16 * 128);
          mma_16816(acc[2 * ms], hi, bv);
          mma_16816(acc[2 * ms], lo, bv);
          mma_16816(acc[2 * ms + 1], hi, bv + 2);
          mma_16816(acc[2 * ms + 1], lo, bv + 2);
        }
      }
    }
    ring_release(t, at.nt, stages, warps, done, lane, copy);
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  const long long ostride = static_cast<long long>(Hq) * dv;
  __nv_bfloat16* ob =
      o + (static_cast<long long>(at.b) * S) * ostride + at.h * dv;
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) {
    const int c = n * 8 + 2 * tig;
    if (c < dv) {
      if (r0 < S) {
        *reinterpret_cast<uint32_t*>(ob + r0 * ostride + c) =
            pack_f32(acc[n][0] / l0, acc[n][1] / l0);
      }
      if (r1 < S) {
        *reinterpret_cast<uint32_t*>(ob + r1 * ostride + c) =
            pack_f32(acc[n][2] / l1, acc[n][3] / l1);
      }
    }
  }
}

template <int CEIL>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) flash_fwd_f32(
    const __grid_constant__ Maps maps, const float* __restrict__ q,
    float* __restrict__ o, int S, int Hq, int Hkv, int dk, int dv, int heads,
    int n_chunks, int stages, float scale, int causal) {
  constexpr int NV = CEIL / 8;  // 16-byte vectors of a lane (two a row)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int warps = blockDim.x / 32;
  const int sb = slot_bytes(dk, dv, 4, CEIL);
  const int qp = q_pitch(dk, CEIL, 4);
  unsigned char* qs = base + stages * sb;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + warps * kMmaRows * qp);
  int* done = reinterpret_cast<int*>(full + stages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tile at = locate(S, Hq, Hkv, heads, n_chunks, warps, warp, causal,
                         kKvF32);
  // tile t: one box of K rows and one of V rows
  const auto copy = [&](int t) {
    const int st = t % stages;
    bar_expect_tx(full + st, sb);
    unsigned char* dst = base + st * sb;
    tma_load_4d(dst, &maps.k, 0, at.hk, t * kKvF32, at.b, full + st);
    tma_load_4d(dst + kKvF32 * dk * 4, &maps.v, 0, at.hk, t * kKvF32, at.b,
                full + st);
  };
  ring_init(full, done, stages);
  ring_start(at.nt, stages, copy);

  // two lanes a row: lane 2 r + half holds vectors half, half + 2, ...
  const int r = lane >> 1, half = lane & 1;
  const int row = at.pw0 + r;
  const int nvk = dk / 4, nvv = dv / 4;  // 16-byte vectors of a row
  const int ck = (nvk - half + 1) >> 1, cv = (nvv - half + 1) >> 1;
  // this warp's 16 q rows into shared memory (zeros past S), each lane
  // its own vectors, every load issued before the first store
  unsigned char* qrow = qs + (warp * kMmaRows + r) * qp;
  {
    const float* qg = q + ((static_cast<long long>(at.b) * S + row) * Hq
                           + at.h) * dk;
    uint4 val[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i >= ck) break;
      val[i] = row < S ? ldg16(qg + (half + 2 * i) * 4)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i >= ck) break;
      sts16(qrow + (half + 2 * i) * 16, val[i]);
    }
  }
  __syncwarp();

  float acc[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
  float m = kMasked, l = 0.f;

  for (int t = 0; t < at.nt; ++t) {
    const int st = t % stages;
    bar_wait(full + st, (t / stages) & 1);
    if (t < at.nt_w) {
      const float* ks = reinterpret_cast<const float*>(base + st * sb);
      const float* vs = ks + kKvF32 * dk;
      float s[kKvF32];
#pragma unroll
      for (int u = 0; u < kKvF32; ++u) s[u] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i >= ck) break;
        const int vi = half + 2 * i;
        const float4 qv = lds16f(qrow + vi * 16);
#pragma unroll
        for (int u = 0; u < kKvF32; ++u) {
          const float4 kv = lds16f(ks + u * dk + vi * 4);
          s[u] = fmaf(qv.x, kv.x, s[u]);
          s[u] = fmaf(qv.y, kv.y, s[u]);
          s[u] = fmaf(qv.z, kv.z, s[u]);
          s[u] = fmaf(qv.w, kv.w, s[u]);
        }
      }
      const int kv0 = t * kKvF32;
      const bool edge =
          kv0 + kKvF32 > S || (causal && kv0 + kKvF32 - 1 > at.pw0);
      float mx = m;
#pragma unroll
      for (int u = 0; u < kKvF32; ++u) {
        // the two halves added in either order: the same sum in both lanes
        float x = (s[u] + __shfl_xor_sync(kFull, s[u], 1)) * scale;
        const int col = kv0 + u;
        if (edge && (col >= S || (causal && col > row))) x = kMasked;
        s[u] = x;
        mx = fmaxf(mx, x);
      }
      const float corr = expf(m - mx);
      m = mx;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kKvF32; ++u) {
        s[u] = expf(s[u] - m);
        sum += s[u];
      }
      l = l * corr + sum;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i >= cv) break;
        const int vi = half + 2 * i;
        float a0 = acc[i][0] * corr, a1 = acc[i][1] * corr;
        float a2 = acc[i][2] * corr, a3 = acc[i][3] * corr;
#pragma unroll
        for (int u = 0; u < kKvF32; ++u) {
          const float4 vv = lds16f(vs + u * dv + vi * 4);
          a0 = fmaf(s[u], vv.x, a0);
          a1 = fmaf(s[u], vv.y, a1);
          a2 = fmaf(s[u], vv.z, a2);
          a3 = fmaf(s[u], vv.w, a3);
        }
        acc[i][0] = a0;
        acc[i][1] = a1;
        acc[i][2] = a2;
        acc[i][3] = a3;
      }
    }
    ring_release(t, at.nt, stages, warps, done, lane, copy);
  }

  if (row < S) {
    l = fmaxf(l, 1e-30f);
    float* orow = o + ((static_cast<long long>(at.b) * S + row) * Hq + at.h)
                          * dv;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i >= cv) break;
      *reinterpret_cast<float4*>(orow + (half + 2 * i) * 4) = make_float4(
          acc[i][0] / l, acc[i][1] / l, acc[i][2] / l, acc[i][3] / l);
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, reached through the runtime's entry
// point lookup (no link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// k or v [B, S, H, d] as a 4-D tensor, innermost d. A box is one head of
// `rows` rows of one batch row: bf16 64 columns (128 bytes, swizzled),
// f32 the whole row. Columns past d and rows past S arrive as zeros.
int encode(CUtensorMap* map, const void* ptr, int B, int S, int H, int d,
           int elt, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * elt;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {
      static_cast<cuuint32_t>(elt == 2 ? kSwizzleCols : d), 1,
      static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      elt == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, S, Hq, Hkv, dk, dv, heads, n_chunks, warps, stages;
  float scale;
  int causal;
};

// Once per (device, kernel): the kernel may use a block's most shared
// memory, with the largest shared memory carveout.
int prepare(const void* fn) {
  struct Ready { int device; const void* fn; };
  static Ready ready[64];
  static int n_ready = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < n_ready; ++i) {
    if (ready[i].device == device && ready[i].fn == fn) return 0;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_ready < 64) ready[n_ready++] = {device, fn};
  return 0;
}

template <typename T, int CEIL>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int elt = sizeof(T);
  const void* kernel;
  if constexpr (kBf16) {
    kernel = reinterpret_cast<const void*>(flash_fwd_bf16<CEIL>);
  } else {
    kernel = reinterpret_cast<const void*>(flash_fwd_f32<CEIL>);
  }
  int err = prepare(kernel);
  if (err != 0) return err;
  const int kv = kBf16 ? kKvBf16 : kKvF32;
  Maps maps;
  err = encode(&maps.k, a.k, a.B, a.S, a.Hkv, a.dk, elt, kv);
  if (err == 0) err = encode(&maps.v, a.v, a.B, a.S, a.Hkv, a.dv, elt, kv);
  if (err != 0) return err;
  const int positions = a.warps * kMmaRows / a.heads;
  const dim3 grid(a.B * a.Hkv * a.n_chunks,
                  (a.S + positions - 1) / positions);
  const int threads = a.warps * 32;
  const int smem = smem_bytes(a.dk, a.dv, elt, CEIL, a.warps, a.stages);
  if constexpr (kBf16) {
    flash_fwd_bf16<CEIL><<<grid, threads, smem, stream>>>(
        maps, static_cast<const __nv_bfloat16*>(a.q),
        static_cast<__nv_bfloat16*>(a.o), a.S, a.Hq, a.Hkv, a.dk, a.dv,
        a.heads, a.n_chunks, a.stages, a.scale * 1.4426950408889634f,
        a.causal);
  } else {
    flash_fwd_f32<CEIL><<<grid, threads, smem, stream>>>(
        maps, static_cast<const float*>(a.q), static_cast<float*>(a.o), a.S,
        a.Hq, a.Hkv, a.dk, a.dv, a.heads, a.n_chunks, a.stages, a.scale,
        a.causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// the register ceiling (columns) of these widths: bf16 64, 96, 128, 256;
// f32 64, 128, 256
__host__ __device__ __forceinline__ int ceiling(int dk, int dv, int elt) {
  const int d = dk > dv ? dk : dv;
  if (d <= 64) return 64;
  if (elt == 2 && d <= 96) return 96;
  return d <= 128 ? 128 : 256;
}

int dispatch(const Args& a, int is_bf16, cudaStream_t stream) {
  const int elt = is_bf16 ? 2 : 4;
  const int vec = 16 / elt;
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.Hq <= 0 ||
      a.Hq % a.Hkv != 0 || a.dk < vec || a.dv < vec || a.dk > kMaxDim ||
      a.dv > kMaxDim || a.dk % vec != 0 || a.dv % vec != 0 ||
      (a.warps != 4 && a.warps != kMaxWarps) || a.heads < 1 ||
      a.heads > kMaxHeads || (a.heads & (a.heads - 1)) != 0 ||
      a.warps % a.heads != 0 || a.heads * a.n_chunks != a.Hq / a.Hkv ||
      a.stages < 2 || a.stages > kMaxStages) {
    return kErrArgs;
  }
  const int positions = a.warps * kMmaRows / a.heads;
  const int ceil = ceiling(a.dk, a.dv, elt);
  // grid bounds and the tensor maps' int32 coordinates
  if (static_cast<long long>(a.B) * a.Hkv * a.n_chunks > 0x7fffffffLL ||
      (static_cast<long long>(a.S) + positions - 1) / positions > 65535 ||
      static_cast<long long>(a.S) + kKvBf16 > 0x7fffffffLL ||
      smem_bytes(a.dk, a.dv, elt, ceil, a.warps, a.stages) > kMaxSmem) {
    return kErrArgs;
  }
  if (is_bf16) {
    switch (ceil) {
      case 64: return launch<__nv_bfloat16, 64>(a, stream);
      case 96: return launch<__nv_bfloat16, 96>(a, stream);
      case 128: return launch<__nv_bfloat16, 128>(a, stream);
      default: return launch<__nv_bfloat16, 256>(a, stream);
    }
  }
  switch (ceil) {
    case 64: return launch<float, 64>(a, stream);
    case 128: return launch<float, 128>(a, stream);
    default: return launch<float, 256>(a, stream);
  }
}

}  // namespace

// q [B, S, Hq, dk], k [B, S, Hkv, dk], v [B, S, Hkv, dv], o [B, S, Hq, dv],
// contiguous, 16-byte aligned, bf16 (is_bf16 = 1) or f32; dk and dv whole
// 16-byte vectors up to 256. A block serves `heads` (1, 2, 4 or 8, dividing
// both Hq / Hkv = heads * n_chunks and `warps`) q heads of one kv head and
// 16 warps / heads positions; `warps` (4 or 8) warps; a ring of
// `stages` (2 to 4) slots.
// Launches one kernel on `stream` and returns 0, a CUDA error code, or a
// negative code of this file (flash_attention_error_string names each);
// the caller raises on anything but 0.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Hq, int Hkv, int dk, int dv, int heads, int n_chunks, int warps,
    int stages, float scale, int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, o, B, S, Hq, Hkv, dk, dv, heads, n_chunks, warps,
               stages, scale, causal};
  return dispatch(a, is_bf16, static_cast<cudaStream_t>(stream));
}

// shared memory bytes of one block for these widths and this plan
extern "C" int flash_attention_smem_bytes(int dk, int dv, int elt, int warps,
                                          int stages) {
  return smem_bytes(dk, dv, elt, ceiling(dk, dv, elt), warps, stages);
}

extern "C" const char* flash_attention_error_string(int code) {
  switch (code) {
    case kErrArgs: return "invalid arguments";
    case kErrEncoder: return "cuTensorMapEncodeTiled not found in libcuda";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused k or v";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
