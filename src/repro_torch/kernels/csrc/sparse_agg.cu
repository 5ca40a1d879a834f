// Sparse cohort scatter-add: the compressed-uplink Eq. 1 fold on Hopper,
// summed in the reference's order.
//
// Replaces the Pallas TPU kernel repro/kernels/sparse_agg.py:
// sparse_cohort_add_fwd (body _sparse_agg_kernel). It computes the same
// function: a dense [L] f32 output equal to sum_c w[c] * scatter(idx[c],
// vals[c]) over K clients' top-k rows, idx [K, k] int32, vals [K, k] f32,
// w [K] f32. Duplicate indices accumulate, within a row and across rows.
//
// Order. out[i] starts at +0.0f. For c = 0..K-1, then j = 0..k-1, every
// entry with idx[c, j] == i adds the rounded product w[c] * vals[c, j],
// each add rounded once (__fmul_rn / __fadd_rn: no contraction to FMA).
// That is the TPU kernel's order (a sequential grid over clients, a
// fori_loop over each row) and the plain version's (index_add_ on the
// CPU), so the result equals the plain version run on the CPU bit for bit
// and a rerun gives the same bits. An element nothing lands on is +0.0.
//
// Design. The TPU kernel keeps the whole output resident in VMEM and walks
// the cohort on a sequential grid. Here each block owns a tile of the
// output in shared memory (2,048 elements for leaves up to 2^20, 4,096
// above: the smaller tile has more blocks in flight on the mid-sized
// leaves, the larger one searches half as often on the largest) and
// writes it once, zeros included: no atomics, no memset. The precondition
// is that every row of idx is non-decreasing, as top-k sends it
// (ascending, distinct). Then a block
//   1. finds, for each client, the segment of the row that lands in its
//      tile: two lower-bound searches a client (the tile's first index and
//      the next tile's), each by 16 lanes probing 16 points a step, about
//      5 dependent loads at k 235,929; all 2K searches run at once. (Eight
//      points a lane, three steps, was slower: each probe is a scattered
//      load, and the probes' traffic outgrew what the steps saved.) A grid
//      of one block owns the whole row and searches nothing;
//   2. stages the segments' (idx, vals) into shared memory with coalesced
//      loads, up to 12 independent loads a thread in flight, and the
//      weights;
//   3. adds client by client into the tile, a __syncthreads() between
//      clients. Within one client's non-decreasing row, equal indices are
//      adjacent: the thread holding the first entry of a run adds the
//      whole run in entry order, the others add nothing, so no two threads
//      touch one element at once.
// A block reads its segments once and writes its tile once, so the
// traffic is the bound's: K*k*8 bytes read and L*4 written (plus K*4).
//
// No silent wrong sum. Each block checks its segments: every entry inside
// its tile and not below its predecessor; the first tile's segments start
// at 0, the last tile's end at k, and no segment ends before it starts.
// A tile's end search is the same function of the same data as the next
// tile's start search, so the segments tile each row, and together the
// checks hold exactly when every row is non-decreasing within [0, L). A
// row that is not fails the launch with a device-side assert, which the
// next synchronizing call reports (the wrapper can sort rows first; see
// kernels/sparse_agg.py).

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                // output elements a block owns,
constexpr int kSmallTile = 2048;           // or these, up to this length:
constexpr long long kSmallTileLength = 1 << 20;
constexpr int kGroup = 16;                 // lanes of one search
constexpr int kProbes = 1;                 // points a lane probes a step
constexpr int kWays = kGroup * kProbes;    // points a search probes a step
constexpr int kGroups = kThreads / kGroup;
constexpr int kSmemLimit = 232448;         // a block's shared memory

// entries staged at a time: three quarters of a tile
__host__ __device__ constexpr int stage_of(int tile) { return tile / 4 * 3; }

// tile, staging buffer, and lo, hi, first and the weight a client
__host__ __device__ constexpr int smem_bytes(int tile, int K) {
  return tile * 4 + stage_of(tile) * 8 + 4 + 16 * K;
}

static_assert(stage_of(kSmallTile) % kThreads == 0,
              "staging is whole rounds of threads");
static_assert(kSmallTile % 4 == 0, "tiles are stored as float4");

__device__ __forceinline__ int probe_at(int lo, int span, int m) {
  return lo + static_cast<int>(static_cast<long long>(m) * span / kWays);
}

// First position of the row whose value is >= target, searched by the 16
// lanes of one group (glane 0..15, bits at gshift of the warp's ballot):
// each step probes kWays points lo + m * span / kWays, lane glane the
// kProbes points m = glane * kProbes + j, all loads independent. On a
// non-decreasing row the probes below target are a prefix of m, so their
// count places the answer between two neighbouring probes. A group whose
// search is inactive keeps lo == hi == 0 and loads nothing; every lane of
// the warp runs the loop until all its groups are done. On a row that is
// not non-decreasing the result is still a position in [0, k] determined
// by the data alone, which the checks rely on.
__device__ int lower_bound_group(const int32_t* __restrict__ row, int k,
                                 long long target, bool active, int glane,
                                 int gshift) {
  int lo = 0, hi = active ? k : 0;
  while (__any_sync(0xffffffffu, lo < hi)) {
    const int span = hi - lo;
    int32_t v[kProbes];
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      v[j] = lo < hi ? row[probe_at(lo, span, glane * kProbes + j)] : 0;
    }
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kProbes; ++j) {
      const bool less = lo < hi && static_cast<long long>(v[j]) < target;
      cnt += __popc((__ballot_sync(0xffffffffu, less) >> gshift) & 0xffffu);
    }
    if (lo < hi) {
      if (cnt == 0) {
        hi = lo;
      } else {
        const int last = probe_at(lo, span, cnt - 1);
        const int next = cnt < kWays ? probe_at(lo, span, cnt) : hi;
        lo = last + 1;
        hi = next;
      }
    }
  }
  return lo;
}

template <int TILE>
__global__ void __launch_bounds__(kThreads) sparse_cohort_add_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ vals,
    const float* __restrict__ w, float* __restrict__ out, int K, int k,
    long long length) {
  constexpr int kStage = stage_of(TILE);      // entries staged at a time
  constexpr int kPer = kStage / kThreads;     // staged entries a thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  int32_t* sidx = reinterpret_cast<int32_t*>(tile + TILE);
  float* sval = reinterpret_cast<float*>(sidx + kStage);
  int* lo = reinterpret_cast<int*>(sval + kStage);
  int* hi = lo + K;
  int* first = hi + K;  // flat staged position of each client's segment
  float* sw = reinterpret_cast<float*>(first + K + 1);
  __shared__ int bad;

  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * TILE;
  const int n_tile = static_cast<int>(
      length - t0 < TILE ? length - t0 : TILE);

  if (tid == 0) {
    bad = 0;
  }
  float4* tile4 = reinterpret_cast<float4*>(tile);
  for (int i = tid; i < (n_tile + 3) / 4; i += kThreads) {
    tile4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = tid; c < K; c += kThreads) {
    sw[c] = w[c];
  }

  // 1. segments: search s finds client s / 2's lower bound of the tile's
  // first index (s even) or of the next tile's (s odd). One block owns
  // every row whole: [0, k), and the checks below still see every entry.
  if (gridDim.x == 1) {
    for (int c = tid; c < K; c += kThreads) {
      lo[c] = 0;
      hi[c] = k;
    }
  } else {
    const int group = tid / kGroup, glane = tid % kGroup;
    const int gshift = (tid & 31) >= kGroup ? kGroup : 0;
    for (int s0 = 0; s0 < 2 * K; s0 += kGroups) {
      const int s = s0 + group;
      const bool active = s < 2 * K;
      const int c = active ? s >> 1 : 0;
      const long long target = t0 + ((s & 1) ? n_tile : 0);
      const int at = lower_bound_group(idx + static_cast<long long>(c) * k,
                                       k, target, active, glane, gshift);
      if (active && glane == 0) {
        ((s & 1) ? hi : lo)[c] = at;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int c = 0; c < K; ++c) {
      if ((blockIdx.x == 0 && lo[c] != 0) ||
          (blockIdx.x == gridDim.x - 1 && hi[c] != k) || hi[c] < lo[c]) {
        bad = 1;
        hi[c] = hi[c] < lo[c] ? lo[c] : hi[c];
      }
      first[c] = total;
      total += hi[c] - lo[c];
    }
    first[K] = total;
  }
  __syncthreads();

  const int total = first[K];
  for (int base = 0; base < total; base += kStage) {
    const int n = total - base < kStage ? total - base : kStage;
    // 2. stage flat positions base + e * kThreads + tid; a thread's client
    // only moves forward with e
    int32_t ri[kPer];
    float rv[kPer];
    int c = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int q = e * kThreads + tid;
      ri[e] = 0;
      rv[e] = 0.f;
      if (q < n) {
        const int p = base + q;
        while (first[c + 1] <= p) {
          ++c;
        }
        const long long g =
            static_cast<long long>(c) * k + lo[c] + (p - first[c]);
        ri[e] = idx[g];
        rv[e] = vals[g];
      }
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int q = e * kThreads + tid;
      if (q < n) {
        sidx[q] = ri[e];
        sval[q] = rv[e];
      }
    }
    __syncthreads();

    // 3. add client by client; the last client's barrier also frees the
    // staging buffer for the next round
    for (int cl = 0; cl < K; ++cl) {
      const int a = first[cl] > base ? first[cl] : base;
      const int b = first[cl + 1] < base + n ? first[cl + 1] : base + n;
      if (a >= b) {
        continue;  // the same for every thread of the block
      }
      const float wc = sw[cl];
      const int end = first[cl + 1];
      // global offset of flat position p of this client: row + p
      const long long row = static_cast<long long>(cl) * k + lo[cl] -
                            first[cl];
      for (int p = a + tid; p < b; p += kThreads) {
        const int q = p - base;
        const int cur = sidx[q];
        bool starts_run = true;
        if (p > first[cl]) {
          const int prev = q > 0 ? sidx[q - 1] : idx[row + p - 1];
          if (prev > cur) {
            bad = 1;
          }
          starts_run = prev != cur;
        }
        const long long local = static_cast<long long>(cur) - t0;
        if (local < 0 || local >= n_tile) {
          bad = 1;
          continue;
        }
        if (!starts_run) {
          continue;
        }
        float acc = __fadd_rn(tile[local], __fmul_rn(wc, sval[q]));
        for (int r = p + 1; r < end; ++r) {
          const int rq = r - base;
          const int nxt = rq < n ? sidx[rq] : idx[row + r];
          if (nxt != cur) {
            break;
          }
          acc = __fadd_rn(acc, __fmul_rn(wc, rq < n ? sval[rq]
                                                    : vals[row + r]));
        }
        tile[local] = acc;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  if (bad) {
    if (tid == 0) {
      printf("sparse_cohort_add: block %d found a row of idx that is not "
             "non-decreasing within [0, %lld)\n", blockIdx.x, length);
      assert(!"sparse_cohort_add: rows of idx must be non-decreasing "
              "within [0, length)");
    }
    return;
  }
  // 4. write the whole tile, zeros included
  const int n4 = n_tile / 4;
  float4* out4 = reinterpret_cast<float4*>(out + t0);
  for (int i = tid; i < n4; i += kThreads) {
    out4[i] = tile4[i];
  }
  for (int i = n4 * 4 + tid; i < n_tile; i += kThreads) {
    out[t0 + i] = tile[i];
  }
}

}  // namespace

// The most clients one launch takes (their segment bounds share the
// block's shared memory with the tile and the staging buffer).
extern "C" int sparse_cohort_add_max_clients() {
  return (kSmemLimit - smem_bytes(kTile, 0)) / 16;
}

template <int TILE>
int launch(const void* idx, const void* vals, const void* w, void* out,
           int K, int k, long long length, cudaStream_t stream) {
  const int smem = smem_bytes(TILE, K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_cohort_add_kernel<TILE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const long long blocks = (length + TILE - 1) / TILE;
  sparse_cohort_add_kernel<TILE><<<static_cast<unsigned>(blocks), kThreads,
                                   smem, stream>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(vals),
      static_cast<const float*>(w), static_cast<float*>(out), K, k, length);
  return static_cast<int>(cudaGetLastError());
}

// idx [K, k] int32 with non-decreasing rows, vals [K, k] f32, w [K] f32,
// out [length] f32 16-byte aligned (every element written). Launches on
// `stream` and returns cudaGetLastError() as an int (0 on success); the
// caller raises on anything else.
extern "C" int sparse_cohort_add_launch(const void* idx, const void* vals,
                                        const void* w, void* out, int K,
                                        int k, long long length,
                                        void* stream) {
  if (K <= 0 || k <= 0 || length <= 0 ||
      K > sparse_cohort_add_max_clients()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return length <= kSmallTileLength
      ? launch<kSmallTile>(idx, vals, w, out, K, k, length, s)
      : launch<kTile>(idx, vals, w, out, K, k, length, s);
}

extern "C" const char* sparse_cohort_add_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
