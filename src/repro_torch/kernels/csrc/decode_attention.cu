// One-token GQA decode attention over a KV cache on Hopper (flash-decode),
// one kernel launch a call.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py:
// decode_attention (body _decode_kernel). It computes the same function:
// for each batch row b and q head h, o = softmax(scale * q k^T) v over the
// first length[b] cached rows, with q [B, Hq, dk], k [B, S, Hkv, dk], v
// [B, S, Hkv, dv], Hq % Hkv == 0 and q head h reading kv head h / (Hq /
// Hkv), as the Pallas index maps do. Scores, the running max m, the
// denominator l and the accumulator are f32; l is clamped at 1e-30; the
// output [B, Hq, dv] is written in the input dtype. A row with length 0
// has nothing to attend to and comes out as exact zeros, as in the
// reference.
//
// Bound. Each cached row costs 2 (dk + dv) flops per q head against
// (dk + dv) elements of K and V read once per kv head, so the kernel does
// about 2 g flops per byte: device memory bounds it by far. At the
// Llama-3-8B serving shape (B 8, Hq 32, Hkv 8, d 128, bf16) a full
// 1024-row cache is 33.6 MB of K and V, 0.010 ms at 3.35 TB/s; at 32,768
// rows 1.07 GB, 0.32 ms. The design pays the fixed cost of a call once,
// keeps bytes in flight, and spends few instructions a byte:
//
//  * Split-KV in one launch. The Pallas grid walks the kv blocks of one
//    (b, q head) in order; on Hopper that walk would fill too few SMs, so
//    the cache of each (b, kv head, head chunk) is shared by `splits`
//    blocks that form one thread block cluster (grid x = cluster x, at
//    most 16). The splits share [0, length[b]) evenly, so a long row keeps
//    all of its blocks busy whatever the other rows' lengths. A block
//    serves all (up to 8, a "head chunk") q heads of its kv head, so a K
//    or V row is read from device memory once per group. After its range
//    each block pushes its partial (m, l, acc) through distributed shared
//    memory into the inboxes of the cluster's blocks, each of which owns a
//    slice of the group's outputs; behind one cluster barrier every block
//    merges its slice in split order. No f32 workspace, no second kernel,
//    and the fixed merge order gives equal bits on a rerun. Every block
//    reaches every cluster barrier, also one whose range is empty (it
//    streams nothing and pushes m = -inf, l = 0).
//  * A ring of K and V tiles in shared memory filled by the Tensor Memory
//    Accelerator. The cache is seen as a 2-D tensor [B * S, Hkv * d]; a
//    box is 16 cached rows of one column region of one kv head, and a
//    stage of `rows` rows takes the boxes that reach the block's end,
//    completing on the stage's "full" mbarrier. bf16 rows are cut into
//    64-column regions that the TMA writes swizzled (128 bytes a row, no
//    byte read past them), which keeps the fragment loads of 8 rows free
//    of bank conflicts, and a padded remainder (its box reaches 16 or 32
//    bytes past the row, the next head's or zeros past the tensor); f32
//    rows are dense, in regions of 128 columns. One producer lane keeps
//    `stages` stages in flight, issuing a stage only if it starts below
//    this block's end; four consumer warps wait on "full", compute, and
//    release the stage on its "empty" mbarrier (phase parity flips on
//    every lap of the ring). Rows and columns past the end are real cache
//    entries or the TMA's zeros: masked, multiplied by q = 0, or dropped,
//    never garbage.
//  * bf16: tensor cores. Per 16 cached rows a warp computes S^T = K q^T
//    with mma.sync m16n8k16 (K from shared memory by ldmatrix, q^T as
//    register fragments, up to 8 heads as the n dimension), masks rows
//    past the end with -inf, keeps the online softmax of two heads a lane
//    in f32, and accumulates O^T += V^T P^T with V^T from ldmatrix .trans
//    and P^T from movmatrix. bf16 products are exact and the sums f32, as
//    the reference's; p is f32, so P^T is split into two bf16 terms, hi =
//    bf16(p) and lo = bf16(p - hi), and each product is two mma (as B4
//    does), which keeps about 16 bits of p. Every 16-column step runs
//    with no branch around the warp-wide loads and products (a branch
//    there makes each step wait for a warp synchronisation); a step past
//    the width reads step 0 again into a product that adds 0 or is
//    dropped.
//  * f32: CUDA cores, as the reference: a lane group of L lanes (a power
//    of two covering max(dk, dv) in 16-byte vectors, VPL vectors a lane)
//    takes one cached row at a time, kUnroll rows per step, with its q
//    slice in registers; scores are summed by xor butterflies inside the
//    group, all rows and heads of a step at once.
//  * Head dims at run time. dk and dv are separate run-time widths up to
//    256, each a whole number of 16-byte vectors. Two register ceilings,
//    VPL = 1 for widths up to 128 and VPL = 2 up to 256, not one kernel a
//    width. Softmax weights are exponentials in base 2 of scores scaled by
//    log2(e), one MUFU instruction each.
//  * Empty lane groups, warps and splits are merged by a branch, never by
//    multiplying garbage by exp(-inf) = 0, so nothing makes a NaN.
//
// The split count, rows a stage and ring depth are chosen by the caller
// (kernels/decode_attention.py:plan) from S, the widths and the SM count,
// never from length, which stays on the device.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes via cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + one producer warp
constexpr int kUnroll = 4;       // f32: rows per lane group per step
constexpr int kMmaRows = 16;     // bf16: cached rows of one warp step
constexpr int kMaxGroup = 8;     // q heads a block serves at most
constexpr int kMaxDim = 256;     // dk, dv at most
constexpr int kMaxCluster = 16;  // splits; above 8 the cluster is non-portable
constexpr int kMaxStages = 8;
constexpr int kMaxRows = 256;    // cached rows of one stage at most
constexpr int kBoxRows = 16;     // cached rows of one TMA box
constexpr int kRegion = 128;     // f32: columns of one column region at most
constexpr int kSwizzleCols = 64; // bf16: columns of one swizzled region
constexpr int kMaxSmem = 232448; // 227 KB, a block's most on Hopper
constexpr unsigned kFull = 0xffffffffu;

// error codes past CUDA's own (returned negative)
constexpr int kErrArgs = -1;
constexpr int kErrNoCluster = -2;
constexpr int kErrEncoder = -3;
constexpr int kErrTensorMap = -4;

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

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
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

// one box of a 2-D tensor map at (column c0, row c1) into shared memory,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// every thread of the block, met from the producer's and the consumers'
// own code paths: after it no stage is read and the ring is free
__device__ __forceinline__ void ring_free_barrier() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// 2^x in one MUFU instruction (max relative error about 2^-22; results
// below 2^-126 flush to 0, far under what a softmax weight can matter)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 bytes of a stage in shared memory
__device__ __forceinline__ uint4 lds16(const void* p) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(smem_u32(p)));
  return r;
}

// Fragment loads and products are plain (not volatile) asm, so that the
// compiler may issue the next loads before the last products; a load
// keeps a memory clobber, so that none moves above a barrier wait.

// four 8x8 b16 matrices, lanes 8i..8i+7 giving the rows of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p))
      : "memory");
}

// the transpose of an 8x8 b16 matrix held one (row, 2 columns) a lane
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
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

__host__ __device__ __forceinline__ int round8(int x) {
  return (x + 7) / 8 * 8;
}

// bytes between two cached rows of a padded column region: its columns
// and 16 or 32 bytes more, an odd number of 16-byte units, so that 8
// consecutive rows start in 8 different bank groups
__host__ __device__ __forceinline__ int region_pitch(int cols, int elt) {
  const int units = cols * elt / 16 + 1;
  return 16 * (units % 2 ? units : units + 1);
}

// The column regions of one cached row in a stage, each a TMA box wide:
// n0 regions of p0 bytes a row, then one of p1 bytes (none if p1 is 0)
// from column c1.
//  * bf16: 64-column regions of 128 bytes, which the TMA writes swizzled
//    (16-byte chunk c of row r at chunk c ^ (r % 8)), so that the fragment
//    loads of 8 rows hit 8 bank groups without reading a byte more; the
//    rest of the row (d % 64 columns) padded as region_pitch says.
//  * f32: columns [0, 128) and [128, d), dense: a lane group reads a row's
//    consecutive 16-byte vectors, free of conflicts as they are.
struct Layout {
  int n0, p0, p1, c1;
};

__host__ __device__ __forceinline__ Layout row_layout(int d, int elt) {
  if (elt == 2) {
    const int rem = d % kSwizzleCols;
    return {d / kSwizzleCols, 128, rem ? region_pitch(rem, 2) : 0,
            d - rem};
  }
  return {1, (d < kRegion ? d : kRegion) * 4,
          d > kRegion ? (d - kRegion) * 4 : 0, kRegion};
}

__host__ __device__ __forceinline__ int pitch_bytes(int d, int elt) {
  const Layout r = row_layout(d, elt);
  return r.n0 * r.p0 + r.p1;
}

// one tensor map a kind of column region of K and of V: [0] the n0
// regions, [1] the last one (unused when p1 is 0)
struct Maps {
  CUtensorMap k[2], v[2];
};

__host__ __device__ __forceinline__ int slice_len(int gc, int dv, int splits) {
  return (gc * dv + splits - 1) / splits;
}

// Shared memory of one block, after 1024 bytes of alignment slack:
//  * the ring of `stages` stages, 1024-byte aligned (the swizzle's
//    period), each the K tile's column regions, then the V tile's; after
//    the stream it holds the consumer warps' partials;
//  * the inbox, where the blocks of the cluster push their partials of the
//    outputs this block merges: (m, l) of every split and head, and the
//    accumulators of its slice of the gc * dv outputs;
//  * 2 * stages mbarriers.
__host__ __device__ __forceinline__ int ring_bytes(int dk, int dv, int elt,
                                                   int gc, int rows,
                                                   int stages) {
  const int tiles = stages * rows * (pitch_bytes(dk, elt)
                                     + pitch_bytes(dv, elt));
  const int scratch = kConsumerWarps * gc * (dv + 2) * 4;
  return round8(tiles > scratch ? tiles : scratch);
}

__host__ __device__ __forceinline__ int inbox_bytes(int dv, int gc,
                                                    int splits) {
  return round8((splits * slice_len(gc, dv, splits) + 2 * splits * gc) * 4);
}

__host__ __device__ __forceinline__ int smem_bytes(int dk, int dv, int elt,
                                                   int gc, int rows,
                                                   int stages, int splits) {
  return 1024 + ring_bytes(dk, dv, elt, gc, rows, stages)
         + inbox_bytes(dv, gc, splits) + 16 * stages;
}

// f32 with 8 heads keeps 2 x 8 x 8 accumulators and q values a lane: one
// block an SM; every other kernel fits three
template <typename T, int GC, int VPL>
__global__ void __launch_bounds__(kThreads,
                                  std::is_same<T, float>::value && GC >= 8
                                      ? 1 : 3)
decode_attention_cluster(const __grid_constant__ Maps maps,
                         const T* __restrict__ q,
                         const int* __restrict__ length, T* __restrict__ o,
                         int S, int Hq, int Hkv, int dk, int dv,
                         int n_chunks, int rows, int stages,
                         float scale_log2) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kN = Vec<T>::kN;
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  // a peer's shared memory may be written only once the peer runs: each
  // block announces itself now and waits for the others before its first
  // write to a peer, long after they have all arrived
  cluster_arrive_relaxed();

  const int b = blockIdx.z;
  const int split = blockIdx.x;  // the cluster spans grid x: its rank
  const int splits = gridDim.x;
  const int hk = blockIdx.y / n_chunks;
  const int chunk = blockIdx.y % n_chunks;
  const int g = Hq / Hkv;
  const int h0 = hk * g + chunk * GC;      // first q head of this block
  const int gh = min(GC, g - chunk * GC);  // q heads this block serves
  const int elt = static_cast<int>(sizeof(T));
  // column regions of a stage's K and V tiles
  const Layout lk = row_layout(dk, elt), lv = row_layout(dv, elt);
  const int k_tile = rows * (lk.n0 * lk.p0 + lk.p1);
  const int stage_bytes = k_tile + rows * (lv.n0 * lv.p0 + lv.p1);
  const int part = dv + 2;  // floats of one (m, l, acc[dv]) partial
  const int slice = slice_len(GC, dv, splits);
  const int ring = ring_bytes(dk, dv, elt, GC, rows, stages);
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* inbox_m = reinterpret_cast<float*>(base + ring);  // [splits][GC]
  float* inbox_l = inbox_m + splits * GC;                  // [splits][GC]
  float* inbox_acc = inbox_l + splits * GC;                // [splits][slice]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + ring + inbox_bytes(dv, GC, splits));
  uint64_t* empty = full + stages;
  // in the ring, after the stream
  float* warp_part = reinterpret_cast<float*>(base);   // [warps][GC][part]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == kConsumerWarps * 32) {  // the producer's descriptors
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&maps.k[0])) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&maps.v[0])) : "memory");
  }
  // thread 0 sets up the barriers before it loads anything, so that its
  // fence waits for no load
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int len = min(max(length[b], 0), S);
  // the splits share [0, len) evenly
  const int per_split = (len + splits - 1) / splits;
  const int s0 = min(split * per_split, len);
  const int s1 = min(s0 + per_split, len);  // this block's rows: [s0, s1)
  const int n_tiles = s1 > s0 ? (s1 - s0 + rows - 1) / rows : 0;
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      const int row0 = b * S + s0;  // B * S + rows < 2^31: checked on launch
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % stages;
        if (t >= stages) bar_wait(empty + st, ((t / stages) - 1) & 1);
        // the boxes that reach this block's end
        const int boxes =
            (min(rows, s1 - s0 - t * rows) + kBoxRows - 1) / kBoxRows;
        bar_expect_tx(full + st, boxes * kBoxRows * stage_bytes / rows);
        unsigned char* dst = base + st * stage_bytes;
        for (int i = 0; i < boxes; ++i) {
          const int r = i * kBoxRows, row = row0 + t * rows + r;
          for (int g0 = 0; g0 < lk.n0; ++g0) {
            tma_load_2d(dst + (g0 * rows + r) * lk.p0, &maps.k[0],
                        hk * dk + g0 * (lk.p0 / elt), row, full + st);
          }
          if (lk.p1) {
            tma_load_2d(dst + rows * lk.n0 * lk.p0 + r * lk.p1, &maps.k[1],
                        hk * dk + lk.c1, row, full + st);
          }
          unsigned char* vdst = dst + k_tile;
          for (int g0 = 0; g0 < lv.n0; ++g0) {
            tma_load_2d(vdst + (g0 * rows + r) * lv.p0, &maps.v[0],
                        hk * dv + g0 * (lv.p0 / elt), row, full + st);
          }
          if (lv.p1) {
            tma_load_2d(vdst + rows * lv.n0 * lv.p0 + r * lv.p1, &maps.v[1],
                        hk * dv + lv.c1, row, full + st);
          }
        }
      }
    }
    __syncwarp();
    ring_free_barrier();
  } else if constexpr (kBf16) {
    // tensor cores: 16 cached rows a warp step, heads as the n dimension
    constexpr int kSteps = 8 * VPL;  // 16-wide steps of a width <= 128 VPL
    const int gid = lane >> 2, tig = lane & 3;
    const int nks = (dk + 15) / 16, nms = (dv + 15) / 16;
    // q^T as B fragments: head gid, k = 16 kk + 2 tig (+ 8); past dk, 0
    uint32_t qf[kSteps][2];
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int kc = kk * 16 + 2 * tig + 8 * hf;
        qf[kk][hf] = gid < gh && kc < dk
            ? __ldg(reinterpret_cast<const unsigned int*>(
                  q + (static_cast<long long>(b) * Hq + h0 + gid) * dk + kc))
            : 0u;
      }
    }
    // O^T fragments: dv 16 mb + gid (+ 8), heads 2 tig, 2 tig + 1
    float acc[kSteps][4];
#pragma unroll
    for (int mb = 0; mb < kSteps; ++mb) {
      acc[mb][0] = acc[mb][1] = acc[mb][2] = acc[mb][3] = 0.f;
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const int steps = rows / (kMmaRows * kConsumerWarps);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % stages;
      bar_wait(full + st, (t / stages) & 1);
      const unsigned char* ks = base + st * stage_bytes;
      const unsigned char* vs = ks + k_tile;
      const int tile_rows = min(rows, s1 - (s0 + t * rows));
      for (int c = 0; c < steps; ++c) {
        const int r0 = (c * kConsumerWarps + warp) * kMmaRows;
        if (r0 >= tile_rows) break;
        // two accumulators (even and odd k steps) halve the mma chain
        float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
        // this lane's row in K: 16-byte chunk c of a swizzled region at
        // c ^ (row % 8), the rest padded
        const int ra = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const unsigned char* ka = ks + ra * 128;
        const unsigned char* kr = ks + rows * lk.n0 * 128 + ra * lk.p1
                                  + (lane >> 4) * 16;
        // every step runs, with no branch around the warp-wide loads and
        // products: a step past dk reads step 0 again, where q^T is 0
        const unsigned char* k_first =
            lk.n0 ? ka + (((lane >> 4) ^ (ra & 7)) << 4) : kr;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const unsigned char* at =
              kk < 4 * lk.n0
                  ? ka + (kk / 4) * rows * 128
                        + ((((kk % 4) * 2 + (lane >> 4)) ^ (ra & 7)) << 4)
                  : kr + (kk - 4 * lk.n0) * 32;
          uint32_t a[4];
          ldmatrix_x4(a, kk < nks ? at : k_first);
          mma_16816(kk % 2 ? s2 : s, a, qf[kk]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += s2[e];
        // rows r0 + gid and r0 + gid + 8, heads 2 tig and 2 tig + 1; a row
        // past the end is masked by a select
        const bool v0 = r0 + gid < tile_rows, v1 = r0 + gid + 8 < tile_rows;
        s[0] = v0 ? s[0] * scale_log2 : -INFINITY;
        s[1] = v0 ? s[1] * scale_log2 : -INFINITY;
        s[2] = v1 ? s[2] * scale_log2 : -INFINITY;
        s[3] = v1 ? s[3] * scale_log2 : -INFINITY;
        float p[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = fmaxf(s[h], s[h + 2]);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
          }
          mx = fmaxf(mx, m[h]);
          if (mx == -INFINITY) {  // this head has no row yet
            p[h] = p[h + 2] = 0.f;
            continue;
          }
          if (mx != m[h]) {  // a new max: rescale (by 0 on a first row)
            const float corr = ex2(m[h] - mx);
            m[h] = mx;
            l[h] *= corr;
#pragma unroll
            for (int mb = 0; mb < kSteps; ++mb) {
              acc[mb][h] *= corr;
              acc[mb][h + 2] *= corr;
            }
          }
          p[h] = ex2(s[h] - mx);  // 0 for a masked row
          p[h + 2] = ex2(s[h + 2] - mx);
          l[h] += p[h] + p[h + 2];
        }
        // P^T as B fragments: the lane's (row, 2 heads) pairs transposed
        // into (2 rows, head gid) pairs, as hi + lo bf16 terms
        uint32_t hi[2], lo[2];
        pack_split(p[0], p[1], hi[0], lo[0]);
        pack_split(p[2], p[3], hi[1], lo[1]);
        hi[0] = movmatrix_trans(hi[0]);
        hi[1] = movmatrix_trans(hi[1]);
        lo[0] = movmatrix_trans(lo[0]);
        lo[1] = movmatrix_trans(lo[1]);
        const int rv = r0 + (lane & 7) + ((lane >> 4) & 1) * 8;
        const unsigned char* va = vs + rv * 128;
        const unsigned char* vr = vs + rows * lv.n0 * 128 + rv * lv.p1
                                  + ((lane >> 3) & 1) * 16;
        // as above: a step past dv reads step 0 again, into outputs that
        // are dropped
        const unsigned char* v_first =
            lv.n0 ? va + ((((lane >> 3) & 1) ^ (rv & 7)) << 4) : vr;
#pragma unroll
        for (int mb = 0; mb < kSteps; ++mb) {
          const unsigned char* at =
              mb < 4 * lv.n0
                  ? va + (mb / 4) * rows * 128
                        + ((((mb % 4) * 2 + ((lane >> 3) & 1)) ^ (rv & 7))
                           << 4)
                  : vr + (mb - 4 * lv.n0) * 32;
          uint32_t a[4];
          ldmatrix_x4_trans(a, mb < nms ? at : v_first);
          mma_16816(acc[mb], a, hi);
          mma_16816(acc[mb], a, lo);
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + st);  // this warp is done with st
    }
    // l over the warp's rows: the lanes of one tig hold parts of it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        l[h] += __shfl_xor_sync(kFull, l[h], off);
      }
    }
    ring_free_barrier();
    float* wp = warp_part + warp * GC * part;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * tig + h;
      if (j < gh) {
        if (gid == 0) {
          wp[j * part] = m[h];
          wp[j * part + 1] = l[h];
        }
#pragma unroll
        for (int mb = 0; mb < kSteps; ++mb) {
          const int c0 = mb * 16 + gid;
          if (c0 < dv) wp[j * part + 2 + c0] = acc[mb][h];
          if (c0 + 8 < dv) wp[j * part + 2 + c0 + 8] = acc[mb][h + 2];
        }
      }
    }
  } else {
    // CUDA cores: lane groups of L lanes (a power of two) cover a row of
    // both widths
    const int nvk = dk / kN, nvv = dv / kN;  // 16-byte vectors a row
    const int need = max((nvk + VPL - 1) / VPL, (nvv + VPL - 1) / VPL);
    int L = 1;
    while (L < need) L <<= 1;
    const int per_warp = 32 / L;
    const int G = kConsumerWarps * per_warp;  // lane groups of the block
    const int li = lane & (L - 1);
    const int grp = warp * per_warp + lane / L;
    // a lane's vector p lies in column region p, at element li * kN: VPL
    // is 2 only past 32 vectors a row, where L is 32 and a region is 32
    // vectors wide
    const int pk[2] = {lk.p0 / elt, lk.p1 / elt};
    const int pv[2] = {lv.p0 / elt, lv.p1 / elt};

    // this lane's slice of the group's q rows, times scale * log2(e), so
    // that scores are exponents in base 2
    float qr[GC][VPL][kN];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
        const int vi = li + p * L;
        if (j < gh && vi < nvk) {
          Vec<T>::widen(load16(q + (static_cast<long long>(b) * Hq + h0 + j)
                                       * dk + vi * kN), qr[j][p]);
#pragma unroll
          for (int e = 0; e < kN; ++e) qr[j][p][e] *= scale_log2;
        } else {
#pragma unroll
          for (int e = 0; e < kN; ++e) qr[j][p][e] = 0.f;
        }
      }
    }
    float m[GC], l[GC], acc[GC][VPL][kN];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      m[j] = -INFINITY;
      l[j] = 0.f;
#pragma unroll
      for (int p = 0; p < VPL; ++p) {
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[j][p][e] = 0.f;
      }
    }

    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % stages;
      bar_wait(full + st, (t / stages) & 1);
      const unsigned char* stage = base + st * stage_bytes;
      const T* ks[2] = {reinterpret_cast<const T*>(stage),
                        reinterpret_cast<const T*>(stage + rows * lk.p0)};
      const T* vs[2] = {reinterpret_cast<const T*>(stage + k_tile),
                        reinterpret_cast<const T*>(stage + k_tile
                                                   + rows * lv.p0)};
      const int tile_rows = min(rows, s1 - (s0 + t * rows));
      // every lane of a warp runs the same steps, so the shuffles always
      // see full warps; a row past the end is masked by a select
      for (int r0 = 0; r0 < tile_rows; r0 += G * kUnroll) {
        bool valid[kUnroll];
        float s[kUnroll][GC];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = r0 + u * G + grp;
          valid[u] = r < tile_rows;
          const int rr = min(r, rows - 1);  // stay inside the stage
#pragma unroll
          for (int j = 0; j < GC; ++j) s[u][j] = 0.f;
#pragma unroll
          for (int p = 0; p < VPL; ++p) {
            const int vi = li + p * L;
            if (vi < nvk) {
              float kf[kN];
              Vec<T>::widen(
                  lds16(ks[p] + rr * pk[p] + li * kN), kf);
#pragma unroll
              for (int j = 0; j < GC; ++j) {
#pragma unroll
                for (int e = 0; e < kN; ++e) {
                  s[u][j] = fmaf(qr[j][p][e], kf[e], s[u][j]);
                }
              }
            }
          }
        }
        // butterflies, every (row, head) at once: each lane of a group
        // ends with the group's sum
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          if (off < L) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
              for (int j = 0; j < GC; ++j) {
                s[u][j] += __shfl_xor_sync(kFull, s[u][j], off);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int j = 0; j < GC; ++j) {
            s[u][j] = valid[u] ? s[u][j] : -INFINITY;
          }
        }
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          float mx = m[j];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, s[u][j]);
          if (mx == -INFINITY) continue;  // this group has no row yet
          if (mx != m[j]) {  // a new max: rescale (by 0 on a first row)
            const float corr = ex2(m[j] - mx);
            m[j] = mx;
            l[j] *= corr;
#pragma unroll
            for (int p = 0; p < VPL; ++p) {
#pragma unroll
              for (int e = 0; e < kN; ++e) acc[j][p][e] *= corr;
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            s[u][j] = ex2(s[u][j] - mx);  // 0 for a masked row
            l[j] += s[u][j];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (!valid[u]) continue;
          const int r = r0 + u * G + grp;
#pragma unroll
          for (int p = 0; p < VPL; ++p) {
            const int vi = li + p * L;
            if (vi < nvv) {
              float vf[kN];
              Vec<T>::widen(
                  lds16(vs[p] + r * pv[p] + li * kN), vf);
#pragma unroll
              for (int j = 0; j < GC; ++j) {
#pragma unroll
                for (int e = 0; e < kN; ++e) {
                  acc[j][p][e] = fmaf(s[u][j], vf[e], acc[j][p][e]);
                }
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + st);  // this warp is done with st
    }

    // merge the warp's lane groups: xor partners L, 2L, ... 16 lanes away
    for (int off = L; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        const float mo = __shfl_xor_sync(kFull, m[j], off);
        const float lo = __shfl_xor_sync(kFull, l[j], off);
        const float mx = fmaxf(m[j], mo);
        // a group that saw no row (m = -inf, l = 0, acc = 0) weighs 0
        const float ws = m[j] == -INFINITY ? 0.f : ex2(m[j] - mx);
        const float wo = mo == -INFINITY ? 0.f : ex2(mo - mx);
        l[j] = l[j] * ws + lo * wo;
#pragma unroll
        for (int p = 0; p < VPL; ++p) {
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            const float ao = __shfl_xor_sync(kFull, acc[j][p][e], off);
            acc[j][p][e] = acc[j][p][e] * ws + ao * wo;
          }
        }
        m[j] = mx;
      }
    }
    ring_free_barrier();
    if (lane < L) {  // group 0 holds the warp's merge
      float* wp = warp_part + warp * GC * part;
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        if (j >= gh) break;
        if (lane == 0) {
          wp[j * part] = m[j];
          wp[j * part + 1] = l[j];
        }
#pragma unroll
        for (int p = 0; p < VPL; ++p) {
          const int vi = li + p * L;
          if (vi < nvv) {
#pragma unroll
            for (int e = 0; e < kN; ++e) {
              wp[j * part + 2 + vi * kN + e] = acc[j][p][e];
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the consumer warps' partials are written
  cluster_wait();   // every peer runs: its inbox may be written

  // this block's (m, l) of each head, its warps merged in warp order,
  // pushed to every block of the cluster
  if (threadIdx.x < gh) {
    const int j = threadIdx.x;
    float mx = -INFINITY;
    for (int w = 0; w < kConsumerWarps; ++w) {
      mx = fmaxf(mx, warp_part[(w * GC + j) * part]);
    }
    float lsum = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float* wp = warp_part + (w * GC + j) * part;
      if (wp[0] != -INFINITY) lsum = fmaf(wp[1], ex2(wp[0] - mx), lsum);
    }
    for (int i = 0; i < splits; ++i) {
      cluster.map_shared_rank(inbox_m, i)[split * GC + j] = mx;
      cluster.map_shared_rank(inbox_l, i)[split * GC + j] = lsum;
    }
  }
  // this block's accumulators, the same merge, each pushed to the block
  // that merges its output; a warp that saw no row adds nothing
  for (int t = threadIdx.x; t < gh * dv; t += kThreads) {
    const int j = t / dv, c = t % dv;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      mx = fmaxf(mx, warp_part[(w * GC + j) * part]);
    }
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float* wp = warp_part + (w * GC + j) * part;
      if (wp[0] != -INFINITY) a = fmaf(wp[2 + c], ex2(wp[0] - mx), a);
    }
    const int owner = t / slice;
    cluster.map_shared_rank(inbox_acc, owner)[split * slice + t - owner * slice]
        = a;
  }
  cluster.sync();  // every push has landed

  // merge this block's slice of the outputs, the splits in split order;
  // an empty split adds nothing, and length 0 leaves the output 0
  const int t0 = split * slice, t1 = min(t0 + slice, gh * dv);
  for (int t = t0 + threadIdx.x; t < t1; t += kThreads) {
    const int j = t / dv, c = t % dv;
    float mx = -INFINITY;
    for (int i = 0; i < splits; ++i) mx = fmaxf(mx, inbox_m[i * GC + j]);
    float lsum = 0.f, a = 0.f;
    for (int i = 0; i < splits; ++i) {
      const float mi = inbox_m[i * GC + j];
      if (mi == -INFINITY) continue;
      const float wt = ex2(mi - mx);
      lsum = fmaf(inbox_l[i * GC + j], wt, lsum);
      a = fmaf(inbox_acc[i * slice + t - t0], wt, a);
    }
    o[(static_cast<long long>(b) * Hq + h0 + j) * dv + c] =
        Vec<T>::narrow(a / fmaxf(lsum, 1e-30f));
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

// the cache [B, S, Hkv, d] as a 2-D tensor [B * S, Hkv * d]; a box is
// kBoxRows cached rows of `pitch` bytes: one column region and, for a
// padded one, the bytes past it
int encode(CUtensorMap* map, const void* ptr, int rows_total, int Hkv, int d,
           int pitch, int elt, bool swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrEncoder;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Hkv) * d,
                              static_cast<cuuint64_t>(rows_total)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Hkv) * d * elt};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(pitch / elt),
                             static_cast<cuuint32_t>(kBoxRows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = fn(
      map, elt == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// the tensor maps of one operand's two kinds of column region; an absent
// kind copies the other, so that every map is valid
int encode_operand(CUtensorMap map[2], const void* ptr, int rows_total,
                   int Hkv, int d, int elt) {
  const Layout r = row_layout(d, elt);
  const bool swizzle = elt == 2;
  int err = 0;
  if (r.n0) err = encode(&map[0], ptr, rows_total, Hkv, d, r.p0, elt, swizzle);
  if (err == 0 && r.p1) {
    err = encode(&map[1], ptr, rows_total, Hkv, d, r.p1, elt, false);
  }
  if (!r.n0) map[0] = map[1];
  if (!r.p1) map[1] = map[0];
  return err;
}

struct Args {
  const void *q, *k, *v;
  const int* length;
  void* o;
  int B, S, Hq, Hkv, dk, dv, gc, n_chunks, chunk_rows, splits, rows, stages;
  float scale;
};

// Once per (device, kernel): the kernel may use a block's most shared
// memory, asks for the largest shared memory carveout (else L1 may stay
// large and fit one block an SM) and may form clusters of 16. Then,
// once per (device, kernel, shared memory, cluster size), how many
// clusters of this launch the card holds at once; 0 is an error.
int prepare(const void* fn, const cudaLaunchConfig_t& cfg, int* clusters) {
  struct Ready { int device; const void* fn; };
  struct Fit { int device; const void* fn; size_t smem; unsigned x; int n; };
  static Ready ready[64];
  static Fit fits[256];
  static int n_ready = 0, n_fits = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned x = cfg.attrs[0].val.clusterDim.x;
  for (int i = 0; i < n_fits; ++i) {
    const Fit& f = fits[i];
    if (f.device == device && f.fn == fn && f.smem == cfg.dynamicSmemBytes &&
        f.x == x) {
      *clusters = f.n;
      return 0;
    }
  }
  bool is_ready = false;
  for (int i = 0; i < n_ready; ++i) {
    is_ready |= ready[i].device == device && ready[i].fn == fn;
  }
  if (!is_ready) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n_ready < 64) ready[n_ready++] = {device, fn};
  }
  err = cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*clusters < 1) return kErrNoCluster;
  if (n_fits < 256) {
    fits[n_fits++] = {device, fn, cfg.dynamicSmemBytes, x, *clusters};
  }
  return 0;
}

// Launches the kernel, or with `clusters` set only reports how many
// clusters of this launch the card holds at once.
template <typename T, int GC, int VPL>
int launch(const Args& a, cudaStream_t stream, int* clusters) {
  auto* kernel = decode_attention_cluster<T, GC, VPL>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, a.Hkv * a.n_chunks, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(a.dk, a.dv, sizeof(T), GC, a.rows,
                                    a.stages, a.splits);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int resident = 0;
  int err = prepare(reinterpret_cast<const void*>(kernel), cfg, &resident);
  if (clusters != nullptr) {
    *clusters = resident;
    return err;
  }
  if (err != 0) return err;
  constexpr int elt = sizeof(T);
  const int n = a.B * a.S;
  Maps maps;
  err = encode_operand(maps.k, a.k, n, a.Hkv, a.dk, elt);
  if (err == 0) err = encode_operand(maps.v, a.v, n, a.Hkv, a.dv, elt);
  if (err != 0) return err;
  // the launch's own status (a refused launch never runs); cleared, so
  // that it is not reported again as another caller's
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, kernel, maps, static_cast<const T*>(a.q), a.length,
      static_cast<T*>(a.o), a.S, a.Hq, a.Hkv, a.dk, a.dv, a.n_chunks, a.rows,
      a.stages, a.scale * 1.4426950408889634f);
  if (launched != cudaSuccess) cudaGetLastError();
  return static_cast<int>(launched);
}

template <typename T, int VPL>
int launch_group(const Args& a, cudaStream_t stream, int* clusters) {
  switch (a.gc) {
    case 1: return launch<T, 1, VPL>(a, stream, clusters);
    case 2: return launch<T, 2, VPL>(a, stream, clusters);
    case 4: return launch<T, 4, VPL>(a, stream, clusters);
    case 8: return launch<T, 8, VPL>(a, stream, clusters);
    default: return kErrArgs;
  }
}

int dispatch(const Args& a, int is_bf16, cudaStream_t stream,
             int* clusters) {
  const int elt = is_bf16 ? 2 : 4;
  // bf16 stages are whole steps of every consumer warp
  const int row_unit = is_bf16 ? kMmaRows * kConsumerWarps : kBoxRows;
  if (a.B <= 0 || a.S <= 0 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 ||
      a.dk <= 0 || a.dv <= 0 || a.dk > kMaxDim || a.dv > kMaxDim ||
      (a.dk * elt) % 16 != 0 || (a.dv * elt) % 16 != 0 || a.splits <= 0 ||
      a.splits > kMaxCluster || a.chunk_rows <= 0 ||
      static_cast<long long>(a.chunk_rows) * a.splits < a.S ||
      a.rows < row_unit || a.rows > kMaxRows || a.rows % row_unit != 0 ||
      a.stages < 1 || a.stages > kMaxStages || a.gc < 1 ||
      a.gc > kMaxGroup || a.gc * a.n_chunks < a.Hq / a.Hkv ||
      a.B > 65535 || a.Hkv * a.n_chunks > 65535 ||
      static_cast<long long>(a.B) * a.S + kMaxRows >= (1LL << 31) ||
      smem_bytes(a.dk, a.dv, elt, a.gc, a.rows, a.stages, a.splits) >
          kMaxSmem) {
    return kErrArgs;
  }
  // two register ceilings: widths up to 128 and to 256
  const bool wide = a.dk > kRegion || a.dv > kRegion;
  if (is_bf16) {
    return wide ? launch_group<__nv_bfloat16, 2>(a, stream, clusters)
                : launch_group<__nv_bfloat16, 1>(a, stream, clusters);
  }
  return wide ? launch_group<float, 2>(a, stream, clusters)
              : launch_group<float, 1>(a, stream, clusters);
}

}  // namespace

// q [B, Hq, dk], k [B, S, Hkv, dk], v [B, S, Hkv, dv], o [B, Hq, dv],
// length [B] int32, all contiguous and 16-byte aligned, bf16 (is_bf16 = 1)
// or f32. A block serves gc (1, 2, 4 or 8) q heads of one kv head, n_chunks
// = ceil((Hq / Hkv) / gc) blocks per kv head, and the `splits` blocks of
// one (b, kv head, head chunk) form one cluster and share [0, length[b])
// evenly; chunk_rows * splits >= S bounds a split's rows. The ring holds
// `stages` stages of `rows` cached rows (bf16: a multiple of 64; f32: of 16;
// at most 256), copied in boxes of 16 rows; B * S + 256 < 2^31 (the TMA's
// row coordinate).
// Launches one kernel on `stream` and returns 0, a CUDA
// error code, or a negative code of this file (decode_attention_error_string
// names each); the caller raises on anything but 0.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* length, void* o,
    int B, int S, int Hq, int Hkv, int dk, int dv, int gc, int n_chunks,
    int chunk_rows, int splits, int rows, int stages, float scale,
    int is_bf16, void* stream) {
  const Args a{q, k, v, static_cast<const int*>(length), o, B, S, Hq, Hkv,
               dk, dv, gc, n_chunks, chunk_rows, splits, rows, stages, scale};
  return dispatch(a, is_bf16, static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of this launch the current device holds at once (>= 1),
// or an error code as decode_attention_launch returns it.
extern "C" int decode_attention_clusters(
    int B, int S, int Hq, int Hkv, int dk, int dv, int gc, int n_chunks,
    int chunk_rows, int splits, int rows, int stages, int is_bf16) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, B, S, Hq, Hkv,
               dk, dv, gc, n_chunks, chunk_rows, splits, rows, stages, 1.f};
  int clusters = 0;
  const int err = dispatch(a, is_bf16, nullptr, &clusters);
  return err != 0 ? err : clusters;
}

// shared memory bytes of one block for these widths and ring
extern "C" int decode_attention_smem_bytes(int dk, int dv, int elt, int gc,
                                           int rows, int stages, int splits) {
  return smem_bytes(dk, dv, elt, gc, rows, stages, splits);
}

extern "C" const char* decode_attention_error_string(int code) {
  switch (code) {
    case kErrArgs: return "invalid arguments";
    case kErrNoCluster:
      return "no cluster of this size fits on the card with this shared "
             "memory (cudaOccupancyMaxActiveClusters is 0)";
    case kErrEncoder: return "cuTensorMapEncodeTiled not found in libcuda";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused the cache";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
