// The analytics finisher for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel staged_stats_finish
// (gubernator_tpu/ops/pallas_kernel.py:1168, body _make_stats_finish_kernel
// :1045).  It computes what the oracle computes (ops/analytics.py
// oracle_stats / staged_stats_tail): from one drain's stats accumulator
// (window_drain.cu's StatsAcc: the touched rows' (row, occupied, over,
// hits) entries, the tenant rows and the header) and the resident
// count-min sketch, per shard,
//
//   sketch >>= decay; each touched row adds hits + over_weight * over
//   into its D hashed buckets; its estimate is the minimum over them;
//   the touched rows ranked by (estimate desc, row asc), first topk, pads
//   (-1, 0, 0, 0); tenant rows; header (lanes, hits, under, over, inits,
//   live and expired rows of the expiry plane, 0),
//
// into stats i64[S, V], V = 8 + 3T + 4 topk, and clears what it read from
// the accumulator (the touched rows' index entries, the count, tenant rows,
// header), so the next drain starts from zero without an O(C) pass.
//
// What the TPU kernel's design was for, and what goes: Mosaic has no
// 64-bit vectors and no scatter, so it kept every value as i32 lo/hi pairs,
// summed in 14-bit limbs, scattered into the sketch through a one-hot
// [W, C] mask per row and ranked all C slots with a bitonic network.  Here
// the values are int64 (wrapping through uint64_t, as numpy wraps), the
// duplicate-safe scatter is atomicAdd (integer adds are exact in any
// order), and the work follows the touched rows, not C.
//
// Design.  One launch, grid (1 + X, S).  CTA (0, s) is shard s's
// finisher: decay, atomic adds, estimates (into the accumulator's est
// scratch), then topk rounds, each a block-wide arg-best over the entries
// ranking strictly after the previous winner (the keys are unique: one
// entry per row), then tenant rows, header and clears.  CTAs (1..X, s)
// count live and expired rows of shard s's expiry plane, a slice each; the
// last of them to finish (a counter in the accumulator) writes the two
// header fields and resets the counters.
//
// Bounds on this card.  The expiry plane dominates the bytes: 8 B per arena
// row, 134 MB at 8 x 2^21 rows, 40 us at the H100 SXM's published
// 3.35 TB/s; the rest moves about a megabyte.  The finisher CTA's topk
// rounds are serial (topk block-wide reductions over the entries), one SM
// per shard.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxWarps = kThreads / 32;
constexpr int kLive = 5, kExpired = 6;
constexpr uint64_t kMask62 = (1ull << 62) - 1;

__constant__ uint64_t kMults[8] = {
    0x2545F4914F6CDD1Dull, 0x369DEA0F31A53F85ull, 0x27BB2EE687B0B0FDull,
    0x106689D45497FDB5ull, 0x1B873593CC9E2D51ull, 0x2127599BF4325C37ull,
    0x0B4B82E749B0A2F5ull, 0x3C6EF372FE94F82Bull,
};

// ops/analytics.py hash_slots: bucket of arena row `row` in sketch row r
__device__ __forceinline__ int64_t bucket(int64_t row, int r, int64_t W) {
  uint64_t x = (static_cast<uint64_t>(row) + 1 + static_cast<uint64_t>(r)) * kMults[r % 8];
  x &= kMask62;
  x ^= x >> 31;
  return static_cast<int64_t>(x % static_cast<uint64_t>(W));
}

struct Args {
  int64_t* sketch;         // [S, D, W]
  int D;
  int64_t W;
  int32_t* index;          // [S, C]
  const int64_t* entries;  // [S, N, 4] (row, occ, over, hits)
  int32_t* count;          // [S]
  int64_t* tenant;         // [S, T, 3]
  int64_t* header;         // [S, 4] (lanes, hits, over, inits)
  int64_t* est;            // [S, N] scratch
  int64_t N;
  int T;
  const int64_t* expire;   // [S, C]
  int64_t C;
  int64_t now;
  int decay;
  int64_t over_weight;
  int topk;
  unsigned long long* ecount;  // [S, 2] live / expired partial sums
  unsigned int* edone;         // [S] expiry CTAs finished
  int64_t* stats;              // [S, V]
  int64_t V;
};

// a ranked entry; idx < 0 is "none", which ranks after everything
struct Cand {
  int64_t est, row;
  int idx;
};

__device__ __forceinline__ bool before(const Cand& a, const Cand& b) {
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
  return a.est > b.est || (a.est == b.est && a.row < b.row);
}

__device__ Cand warp_best(Cand c) {
  for (int m = 16; m > 0; m >>= 1) {
    Cand o;
    o.est = __shfl_xor_sync(0xffffffffu, c.est, m);
    o.row = __shfl_xor_sync(0xffffffffu, c.row, m);
    o.idx = __shfl_xor_sync(0xffffffffu, c.idx, m);
    if (before(o, c)) c = o;
  }
  return c;
}

__device__ void finish_shard(const Args& a, int s) {
  __shared__ Cand best_of_warp[kMaxWarps];
  __shared__ Cand winner;
  const int n = a.count[s];
  int64_t* sk = a.sketch + static_cast<size_t>(s) * a.D * a.W;
  const int64_t* ent = a.entries + static_cast<size_t>(s) * a.N * 4;
  int64_t* est = a.est + static_cast<size_t>(s) * a.N;
  int64_t* out = a.stats + static_cast<size_t>(s) * a.V;

  for (int64_t i = threadIdx.x; i < a.D * a.W; i += blockDim.x) sk[i] >>= a.decay;
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int64_t* en = ent + 4 * e;
    const uint64_t w = static_cast<uint64_t>(en[3]) +
                       static_cast<uint64_t>(a.over_weight) * static_cast<uint64_t>(en[2]);
    for (int r = 0; r < a.D; ++r) {
      atomicAdd(reinterpret_cast<unsigned long long*>(sk + r * a.W + bucket(en[0], r, a.W)),
                static_cast<unsigned long long>(w));
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int64_t row = ent[4 * e];
    int64_t m = sk[bucket(row, 0, a.W)];
    for (int r = 1; r < a.D; ++r) {
      const int64_t v = sk[r * a.W + bucket(row, r, a.W)];
      m = v < m ? v : m;
    }
    est[e] = m;
  }
  __syncthreads();

  // topk rounds: the best entry ranking strictly after the last winner;
  // an estimate below 0 never ranks (the oracle's untouched score is -1)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = (blockDim.x + 31) / 32;
  Cand prev{0, 0, -1};
  int k = 0;
  for (; k < a.topk; ++k) {
    Cand best{0, 0, -1};
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const Cand c{est[e], ent[4 * e], e};
      if (c.est < 0 || (prev.idx >= 0 && !before(prev, c))) continue;
      if (before(c, best)) best = c;
    }
    best = warp_best(best);
    if (lane == 0) best_of_warp[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
      Cand b = best_of_warp[0];
      for (int w = 1; w < warps; ++w) {
        if (before(best_of_warp[w], b)) b = best_of_warp[w];
      }
      winner = b;
    }
    __syncthreads();
    prev = winner;
    if (prev.idx < 0) break;
    if (threadIdx.x == 0) {
      int64_t* c = out + 8 + 3 * a.T + 4 * k;
      c[0] = prev.row;
      c[1] = prev.est;
      c[2] = ent[4 * prev.idx + 3];
      c[3] = ent[4 * prev.idx + 2];
    }
  }
  for (int j = k + threadIdx.x; j < a.topk; j += blockDim.x) {
    int64_t* c = out + 8 + 3 * a.T + 4 * j;
    c[0] = -1;
    c[1] = c[2] = c[3] = 0;
  }

  int64_t* trows = a.tenant + static_cast<size_t>(s) * 3 * a.T;
  for (int i = threadIdx.x; i < 3 * a.T; i += blockDim.x) {
    out[8 + i] = trows[i];
    trows[i] = 0;
  }
  if (threadIdx.x == 0) {
    int64_t* h = a.header + 4 * s;
    out[0] = h[0];
    out[1] = h[1];
    out[2] = static_cast<int64_t>(static_cast<uint64_t>(h[0]) - static_cast<uint64_t>(h[2]));
    out[3] = h[2];
    out[4] = h[3];
    out[7] = 0;
    h[0] = h[1] = h[2] = h[3] = 0;
  }
  int32_t* index = a.index + static_cast<size_t>(s) * a.C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) index[ent[4 * e]] = 0;
  __syncthreads();
  if (threadIdx.x == 0) a.count[s] = 0;
}

// slice blockIdx.x - 1 of X of shard s's expiry plane
__device__ void count_expiry(const Args& a, int s) {
  __shared__ unsigned int live_sum, expired_sum;
  const int X = gridDim.x - 1;
  const int64_t chunk = (a.C + X - 1) / X;
  const int64_t lo = (blockIdx.x - 1) * chunk;
  const int64_t hi = lo + chunk < a.C ? lo + chunk : a.C;
  const int64_t* ex = a.expire + static_cast<size_t>(s) * a.C;
  if (threadIdx.x == 0) live_sum = expired_sum = 0;
  __syncthreads();
  unsigned int live = 0, expired = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int64_t e = ex[i];
    live += e > a.now;
    expired += e != 0 && e <= a.now;
  }
  live = __reduce_add_sync(0xffffffffu, live);
  expired = __reduce_add_sync(0xffffffffu, expired);
  if (threadIdx.x % 32 == 0) {
    atomicAdd(&live_sum, live);
    atomicAdd(&expired_sum, expired);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  atomicAdd(&a.ecount[2 * s], static_cast<unsigned long long>(live_sum));
  atomicAdd(&a.ecount[2 * s + 1], static_cast<unsigned long long>(expired_sum));
  __threadfence();
  if (atomicAdd(&a.edone[s], 1u) == static_cast<unsigned int>(X - 1)) {
    // the shard's last slice: every other slice's sums are in
    __threadfence();
    int64_t* out = a.stats + static_cast<size_t>(s) * a.V;
    out[kLive] = static_cast<int64_t>(atomicExch(&a.ecount[2 * s], 0ull));
    out[kExpired] = static_cast<int64_t>(atomicExch(&a.ecount[2 * s + 1], 0ull));
    a.edone[s] = 0;
  }
}

__global__ void __launch_bounds__(kThreads) stats_finish_kernel(Args a) {
  if (blockIdx.x == 0) {
    finish_shard(a, blockIdx.y);
  } else {
    count_expiry(a, blockIdx.y);
  }
}

// expiry slices per shard: ~16 rows a thread, ~1024 CTAs over all shards
int expiry_ctas(long long C, int S) {
  const long long by_rows = (C + kThreads * 16 - 1) / (kThreads * 16);
  const long long by_grid = 1024 / S > 1 ? 1024 / S : 1;
  const long long x = by_rows < by_grid ? by_rows : by_grid;
  return static_cast<int>(x < 1 ? 1 : x);
}

}  // namespace

extern "C" {

const char* guber_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Finish one drain's analytics over S shards (see the top of this file):
// sketch i64[S, D, W] updated in place; the accumulator (index i32[S, C],
// entries i64[S, N, 4], count i32[S], tenant i64[S, T, 3], header
// i64[S, 4]) read and cleared; est i64[S, N] scratch; expire i64[S, C];
// ecount u64[S, 2] and edone u32[S] zero before and after; writes stats
// i64[S, 8 + 3T + 4 topk].  Returns cudaGetLastError() after the launch.
int guber_stats_finish(void* sketch, int D, long long W, void* index, const void* entries,
                       void* count, void* tenant, void* header, void* est, long long N, int T,
                       const void* expire, long long C, int S, long long now, int decay,
                       long long over_weight, int topk, void* ecount, void* edone,
                       void* stats, void* stream) {
  if (S < 1 || D < 1 || D > 8 || W < 1 || N < 1 || T < 1 || C < 1 || topk < 1 ||
      decay < 0 || decay > 1) {
    return cudaErrorInvalidValue;
  }
  Args a{static_cast<int64_t*>(sketch), D, static_cast<int64_t>(W),
         static_cast<int32_t*>(index), static_cast<const int64_t*>(entries),
         static_cast<int32_t*>(count), static_cast<int64_t*>(tenant),
         static_cast<int64_t*>(header), static_cast<int64_t*>(est), static_cast<int64_t>(N), T,
         static_cast<const int64_t*>(expire), static_cast<int64_t>(C),
         static_cast<int64_t>(now), decay, static_cast<int64_t>(over_weight), topk,
         static_cast<unsigned long long*>(ecount), static_cast<unsigned int*>(edone),
         static_cast<int64_t*>(stats), static_cast<int64_t>(8 + 3 * T + 4 * topk)};
  const dim3 grid(1 + expiry_ctas(C, S), S);
  stats_finish_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
