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
// Design.  One launch of S + S X CTAs of 1024 threads, the S finishers
// first, so that they start before the expiry slices, and X chosen so
// that the grid is one wave of the card's SMs.  CTA s < S finishes shard
// s: decay, adds and estimates on a copy of its sketch in dynamic shared
// memory (each 64-bit add as native 32-bit shared atomics, add_split),
// the estimates as rank keys beside the sketch (or, where the keys do not
// fit, into the accumulator's est scratch), the rank, then tenant rows,
// header, clears and the sketch's copy back.  The expiry slices keep
// device memory busy meanwhile, so that a round trip to it costs the
// finisher a few microseconds, an instruction fetch that misses its cache
// included: the finisher reads each entry once, eight loads in flight a
// thread, into its key's place (row and weight) in shared memory, and its
// phases are short loops whose code stays cached.  The rank has no round
// per top-k entry:
//
//   * each entry has a unique key, the estimate above the row's complement
//     (est << r) | (2^r - 1 - row), r the bits of C - 1 rounded up to whole
//     bytes, so that key order descending is the rank order (ties at an
//     estimate to the lower row); an estimate below 0 (it never ranks)
//     sets the key's top bit instead;
//   * a radix select finds the topk-th key a byte at a time from the top
//     byte the largest estimate has: per pass a block-wide histogram of
//     the next byte over the keys that match the bytes chosen so far
//     (warp-aggregated shared atomics), then warp 0 finds the bin that
//     holds the topk-th key.  It stops at the first pass after which the
//     keys at or above the chosen bytes fit a list of kSelCap, or are
//     exactly the topk: one or two passes at the analytics defaults, at
//     most 12;
//   * those candidates go to the list in shared memory, and each takes
//     its place by counting the list's keys above its own; the first
//     min(topk, ranked) places are written.  A topk past kSelCap selects
//     exactly and counts over every key instead.
//
// The keys sit in shared memory when the accumulator's entry capacity N
// fits (key_cap keys, up to kMaxKeys); past that they are rebuilt from the
// est scratch and the entries on every pass.  The sketch is worked on in
// place when it does not fit beside them.
//
// CTAs S + s X + x count live and expired rows of slice x of shard s's
// expiry plane, 16 B a load where the rows pair up; the last of a shard's
// X slices to finish (a counter in the accumulator) writes the two header
// fields and resets the counters.
//
// A debug buffer, when given, takes globaltimer stamps: each finisher's
// phase ends (and its select's passes) and the expiry slices' first start
// and last end.
//
// Bounds on this card.  The expiry plane dominates the bytes: 8 B per arena
// row, 134 MB at 8 x 2^21 rows, 40 us at the H100 SXM's published
// 3.35 TB/s; the rest moves about a megabyte.  A finisher's chain (its
// barriers, a few dependent round trips, one or two passes of the select
// in shared memory) runs beside that read on one SM per shard, and ends
// before it at the analytics defaults.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 256;
// ranked entries the shared list holds; a larger topk ranks by counting
// over every key
constexpr int kSelCap = 256;
// rank keys in dynamic shared memory at most (192 KB), and the dynamic
// shared memory a finisher may take for its keys and the sketch
constexpr int kMaxKeys = 12288;
constexpr int kSmemBudget = 216 * 1024;
constexpr int kLive = 5, kExpired = 6;
// the debug stamps a shard: start, decay, adds, estimates, select,
// places, end, and the select's passes; then, after S shards, the expiry
// slices' first start and last end
constexpr int kStamps = 8;
constexpr uint64_t kMask62 = (1ull << 62) - 1;

typedef unsigned __int128 Key;
// the key of an entry whose estimate is below 0: it never ranks
constexpr int kUnranked = 127;

__constant__ uint64_t kMults[8] = {
    0x2545F4914F6CDD1Dull, 0x369DEA0F31A53F85ull, 0x27BB2EE687B0B0FDull,
    0x106689D45497FDB5ull, 0x1B873593CC9E2D51ull, 0x2127599BF4325C37ull,
    0x0B4B82E749B0A2F5ull, 0x3C6EF372FE94F82Bull,
};

#ifndef GUBER_HOST_SHIM
// the card's nanosecond clock, for the debug stamps
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// ops/analytics.py hash_slots: bucket of arena row `row` in sketch row r;
// a power-of-two W takes a mask, the same value as the remainder
__device__ __forceinline__ int64_t bucket(int64_t row, int r, int64_t W) {
  uint64_t x = (static_cast<uint64_t>(row) + 1 + static_cast<uint64_t>(r)) * kMults[r % 8];
  x &= kMask62;
  x ^= x >> 31;
  const uint64_t w = static_cast<uint64_t>(W);
  return static_cast<int64_t>((w & (w - 1)) == 0 ? x & (w - 1) : x % w);
}

// the bytes a shard's sketch takes in shared memory, ahead of the keys
__host__ __device__ __forceinline__ int64_t sketch_bytes(int D, int64_t W) {
  return (static_cast<int64_t>(D) * W * 8 + 15) & ~static_cast<int64_t>(15);
}

// bytes in v's binary form, at least one
__device__ __forceinline__ int byte_len(uint64_t v) {
  int n = 1;
  while (v >>= 8) ++n;
  return n;
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
  int S, X;                    // shards, expiry slices a shard
  int key_cap;                 // rank keys the dynamic shared memory holds
  int sketch_smem;             // 1: the sketch is worked on in shared memory
  unsigned long long* stamps;  // [S * kStamps + 2] debug stamps, or null
};

__device__ __forceinline__ void stamp(const Args& a, int s, int k) {
  if (a.stamps != nullptr && threadIdx.x == 0) a.stamps[s * kStamps + k] = global_ns();
}

// an entry's row above its sketch weight, hits + over_weight * over
// (wrapping), from its two 16 B halves (row, occ) and (over, hits)
__device__ __forceinline__ Key row_weight(const Args& a, const int64_t* en) {
  const longlong2 lo = *reinterpret_cast<const longlong2*>(en);
  const longlong2 hi = *reinterpret_cast<const longlong2*>(en + 2);
  const uint64_t w = static_cast<uint64_t>(hi.y) +
                     static_cast<uint64_t>(a.over_weight) * static_cast<uint64_t>(hi.x);
  return (static_cast<Key>(static_cast<uint64_t>(lo.x)) << 64) | w;
}

// *at += w, exactly mod 2^64, as native 32-bit shared atomics: the low
// word's add returns its old value, and the high word takes w's high word
// and the carry out of the low one (the total is the same in any order)
__device__ __forceinline__ void add_split(int64_t* at, uint64_t w) {
  unsigned* word = reinterpret_cast<unsigned*>(at);
  const unsigned lo = static_cast<unsigned>(w);
  const unsigned old = atomicAdd(word, lo);
  const unsigned hi = static_cast<unsigned>(w >> 32) + (old + lo < old ? 1u : 0u);
  if (hi != 0) atomicAdd(word + 1, hi);
}

// the rank keys of shard s: every entry's (est << rbits) | (rmax - row),
// the top bit set where est < 0; in shared memory, or rebuilt from the
// est scratch and the entries
struct Keys {
  const Key* staged;  // null: rebuild
  const int64_t* est;
  const int64_t* ent;
  int rbits;
  uint64_t rmax;

  __device__ Key make(int64_t e_est, int64_t row) const {
    const Key low = static_cast<Key>(rmax - static_cast<uint64_t>(row));
    return e_est < 0 ? (static_cast<Key>(1) << kUnranked) | low
                     : (static_cast<Key>(static_cast<uint64_t>(e_est)) << rbits) | low;
  }
  __device__ Key at(int e) const { return staged ? staged[e] : make(est[e], ent[4 * e]); }
  __device__ int64_t row(Key k) const {
    return static_cast<int64_t>(rmax - static_cast<uint64_t>(k & static_cast<Key>(rmax)));
  }
};

__device__ __forceinline__ bool ranked_key(Key k) { return (k >> kUnranked) == 0; }

// one pass's vote: a participating thread adds one to bin `dig`, lanes of
// a warp with the same digit in one atomic
__device__ __forceinline__ void vote(unsigned* hist, bool part, unsigned dig) {
  const unsigned act = __ballot_sync(0xffffffffu, part);
  if (!part) return;
  const unsigned peers = __match_any_sync(act, dig);
  if (static_cast<int>(threadIdx.x % 32) == __ffs(peers) - 1) {
    atomicAdd(&hist[dig], static_cast<unsigned>(__popc(peers)));
  }
}

// warp 0 (its first min(32, blockDim) lanes): the bin holding the need-th
// key counted from the top, and the keys in the bins above it
__device__ void find_bin(const unsigned* hist, unsigned need, int* bin, unsigned* above) {
  const int lanes = blockDim.x < 32 ? static_cast<int>(blockDim.x) : 32;
  const int lane = threadIdx.x;
  const int per = kBins / lanes;
  const int top = kBins - 1 - lane * per;
  unsigned sum = 0;
  for (int j = 0; j < per; ++j) sum += hist[top - j];
  unsigned incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  unsigned acc = incl - sum;
  if (acc >= need || need > incl) return;
  for (int j = 0; j < per; ++j) {
    const unsigned h = hist[top - j];
    if (acc + h >= need) {
      *bin = top - j;
      *above = acc;
      return;
    }
    acc += h;
  }
}

// candidate row `place` of shard s's stats from entry e
__device__ __forceinline__ void put(const Args& a, int64_t* out, int place, const int64_t* ent,
                                    int e, int64_t row, int64_t e_est) {
  int64_t* c = out + 8 + 3 * a.T + 4 * place;
  c[0] = row;
  c[1] = e_est;
  c[2] = ent[4 * e + 3];
  c[3] = ent[4 * e + 2];
}

// kSmemSketch: the sketch is worked on in shared memory (a.sketch_smem),
// as a template argument so that the compiler sees which memory each
// access of it reads
template <bool kSmemSketch>
__device__ __forceinline__ void finish_shard(const Args& a, int s, unsigned char* dyn) {
  __shared__ unsigned hist[kBins];
  __shared__ unsigned long long max_est;
  __shared__ unsigned ranked_n, listed;
  __shared__ int sel_bin;
  __shared__ unsigned sel_above;
  __shared__ Key list_key[kSelCap];
  __shared__ int list_idx[kSelCap];
  stamp(a, s, 0);
  const int n = a.count[s];
  const int bd = blockDim.x, tid = threadIdx.x;
  const int64_t dw = a.D * a.W;
  int64_t* sk = a.sketch + static_cast<size_t>(s) * dw;
  const int64_t* ent = a.entries + static_cast<size_t>(s) * a.N * 4;
  int64_t* est = a.est + static_cast<size_t>(s) * a.N;
  int64_t* out = a.stats + static_cast<size_t>(s) * a.V;
  // the sketch worked on: a copy in shared memory, or the shard's own rows
  int64_t* skw = kSmemSketch ? reinterpret_cast<int64_t*>(dyn) : sk;
  Key* skeys = reinterpret_cast<Key*>(dyn + (kSmemSketch ? sketch_bytes(a.D, a.W) : 0));
  const int rbits = 8 * byte_len(static_cast<uint64_t>(a.C - 1));
  const Keys keys{n <= a.key_cap ? skeys : nullptr, est, ent, rbits,
                  rbits >= 64 ? ~0ull : (1ull << rbits) - 1};

  if (tid == 0) {
    max_est = 0;
    ranked_n = listed = 0;
  }
#pragma unroll 8
  for (int64_t i = tid; i < dw; i += bd) skw[i] = sk[i] >> a.decay;
  // where the keys are staged, each entry's row and weight wait in its
  // key's place for the adds and the estimates
  if (keys.staged != nullptr) {
#pragma unroll 8
    for (int e = tid; e < n; e += bd) skeys[e] = row_weight(a, ent + 4 * e);
  }
  __syncthreads();
  stamp(a, s, 1);
  for (int e = tid; e < n; e += bd) {
    const Key rw = keys.staged != nullptr ? skeys[e] : row_weight(a, ent + 4 * e);
    const int64_t row = static_cast<int64_t>(rw >> 64);
    const uint64_t w = static_cast<uint64_t>(rw);
    for (int r = 0; r < a.D; ++r) {
      int64_t* at = skw + r * a.W + bucket(row, r, a.W);
      if (kSmemSketch) {
        add_split(at, w);
      } else {
        atomicAdd(reinterpret_cast<unsigned long long*>(at), static_cast<unsigned long long>(w));
      }
    }
  }
  __syncthreads();
  stamp(a, s, 2);
  // estimates, and each entry's key
  unsigned long long hi = 0;
  unsigned ranked = 0;
  for (int e = tid; e < n; e += bd) {
    const int64_t row = keys.staged != nullptr ? static_cast<int64_t>(skeys[e] >> 64)
                                               : ent[4 * e];
    int64_t m = skw[bucket(row, 0, a.W)];
    for (int r = 1; r < a.D; ++r) {
      const int64_t v = skw[r * a.W + bucket(row, r, a.W)];
      m = v < m ? v : m;
    }
    if (keys.staged != nullptr) {
      skeys[e] = keys.make(m, row);
    } else {
      est[e] = m;
    }
    if (m >= 0) {
      ++ranked;
      hi = static_cast<unsigned long long>(m) > hi ? static_cast<unsigned long long>(m) : hi;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long t = __shfl_xor_sync(0xffffffffu, hi, o);
    hi = t > hi ? t : hi;
  }
  ranked = __reduce_add_sync(0xffffffffu, ranked);
  if (tid % 32 == 0) {
    atomicMax(&max_est, hi);
    atomicAdd(&ranked_n, ranked);
  }
  __syncthreads();
  stamp(a, s, 3);

  // ---- the rank: radix select of the topk-th key, byte by byte ----
  const int width = rbits + 8 * byte_len(max_est);
  const int n_ranked = static_cast<int>(ranked_n);
  const int m = n_ranked < a.topk ? n_ranked : a.topk;
  Key prefix = 0;
  int chosen = 0;  // bytes of the key chosen so far
  if (n_ranked > a.topk) {
    unsigned need = static_cast<unsigned>(a.topk);
    for (int d = 0; d < width / 8; ++d) {
      for (int b = tid; b < kBins; b += bd) hist[b] = 0;
      __syncthreads();
      const int sh_pre = width - 8 * d, sh_dig = width - 8 * (d + 1);
      for (int e0 = 0; e0 < n; e0 += bd) {
        const int e = e0 + tid;
        bool part = false;
        unsigned dig = 0;
        if (e < n) {
          const Key k = keys.at(e);
          part = ranked_key(k) && (k >> sh_pre) == prefix;
          dig = static_cast<unsigned>(k >> sh_dig) & (kBins - 1);
        }
        vote(hist, part, dig);
      }
      __syncthreads();
      if (tid < 32) find_bin(hist, need, &sel_bin, &sel_above);
      __syncthreads();
      const int b = sel_bin;
      need -= sel_above;
      prefix = (prefix << 8) | static_cast<Key>(b);
      chosen = d + 1;
      if (a.stamps != nullptr && tid == 0) a.stamps[s * kStamps + 7] = chosen;
      // stop once the keys at or above the chosen bytes fit the list
      // (their places come from counting), or are exactly the topk
      const unsigned at_or_above = static_cast<unsigned>(a.topk) - need + hist[b];
      const bool done = hist[b] == need || (a.topk <= kSelCap && at_or_above <= kSelCap);
      __syncthreads();
      if (done) break;
    }
  }
  stamp(a, s, 4);
  // the candidates: ranked, key at or above the chosen bytes (every ranked
  // entry when none were chosen); the first m of them by key rank
  const int sh_sel = width - 8 * chosen;
  if (m <= kSelCap) {
    for (int e = tid; e < n; e += bd) {
      const Key k = keys.at(e);
      if (!ranked_key(k) || (k >> sh_sel) < prefix) continue;
      const unsigned at = atomicAdd(&listed, 1u);
      list_key[at] = k;
      list_idx[at] = e;
    }
    __syncthreads();
    const int c = static_cast<int>(listed);
    for (int i = tid; i < c; i += bd) {
      const Key k = list_key[i];
      int place = 0;
      for (int j = 0; j < c; ++j) place += list_key[j] > k;
      if (place < m) {
        put(a, out, place, ent, list_idx[i], keys.row(k), static_cast<int64_t>(k >> rbits));
      }
    }
  } else {
    for (int e = tid; e < n; e += bd) {
      const Key k = keys.at(e);
      if (!ranked_key(k) || (k >> sh_sel) < prefix) continue;
      int place = 0;
      for (int j = 0; j < n; ++j) {
        const Key o = keys.at(j);
        place += ranked_key(o) && o > k;
      }
      put(a, out, place, ent, e, keys.row(k), static_cast<int64_t>(k >> rbits));
    }
  }
  for (int j = m + tid; j < a.topk; j += bd) {
    int64_t* c = out + 8 + 3 * a.T + 4 * j;
    c[0] = -1;
    c[1] = c[2] = c[3] = 0;
  }
  __syncthreads();
  stamp(a, s, 5);

  int64_t* trows = a.tenant + static_cast<size_t>(s) * 3 * a.T;
  for (int i = tid; i < 3 * a.T; i += bd) {
    out[8 + i] = trows[i];
    trows[i] = 0;
  }
  if (tid == 0) {
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
  for (int e = tid; e < n; e += bd) index[keys.row(keys.at(e))] = 0;
  // the sketch back to its shard: stores that no phase waits for, after
  // the expiry slices have had the memory to themselves
  if (kSmemSketch) {
    for (int64_t i = tid; i < dw; i += bd) sk[i] = skw[i];
  }
  __syncthreads();
  if (tid == 0) a.count[s] = 0;
  stamp(a, s, 6);
}

// live and expired rows among n expiry times
__device__ __forceinline__ void tally(int64_t e, int64_t now, unsigned& live, unsigned& expired) {
  live += e > now;
  expired += e != 0 && e <= now;
}

// slice x of X of shard s's expiry plane
__device__ void count_expiry(const Args& a, int s, int x) {
  __shared__ unsigned int live_sum, expired_sum;
  if (a.stamps != nullptr && threadIdx.x == 0) {
    atomicMin(&a.stamps[a.S * kStamps], global_ns());
  }
  // slices of whole row pairs, so that an even C reads 16 B a load
  const int64_t chunk = ((a.C + a.X - 1) / a.X + 1) & ~static_cast<int64_t>(1);
  const int64_t lo = x * chunk < a.C ? x * chunk : a.C;
  const int64_t hi = lo + chunk < a.C ? lo + chunk : a.C;
  const int64_t* ex = a.expire + static_cast<size_t>(s) * a.C;
  if (threadIdx.x == 0) live_sum = expired_sum = 0;
  __syncthreads();
  unsigned int live = 0, expired = 0;
  if (a.C % 2 == 0) {
    const longlong2* pairs = reinterpret_cast<const longlong2*>(ex);
#pragma unroll 4
    for (int64_t p = lo / 2 + threadIdx.x; p < hi / 2; p += blockDim.x) {
      const longlong2 v = pairs[p];
      tally(v.x, a.now, live, expired);
      tally(v.y, a.now, live, expired);
    }
  } else {
#pragma unroll 4
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) tally(ex[i], a.now, live, expired);
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
  if (atomicAdd(&a.edone[s], 1u) == static_cast<unsigned int>(a.X - 1)) {
    // the shard's last slice: every other slice's sums are in
    __threadfence();
    int64_t* out = a.stats + static_cast<size_t>(s) * a.V;
    out[kLive] = static_cast<int64_t>(atomicExch(&a.ecount[2 * s], 0ull));
    out[kExpired] = static_cast<int64_t>(atomicExch(&a.ecount[2 * s + 1], 0ull));
    a.edone[s] = 0;
  }
  if (a.stamps != nullptr) atomicMax(&a.stamps[a.S * kStamps + 1], global_ns());
}

__global__ void __launch_bounds__(kThreads) stats_finish_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  if (b < a.S) {
    if (a.sketch_smem) {
      finish_shard<true>(a, b, smem);
    } else {
      finish_shard<false>(a, b, smem);
    }
  } else {
    count_expiry(a, (b - a.S) / a.X, (b - a.S) % a.X);
  }
}

// expiry slices per shard: at least ~16 rows a thread, and with the S
// finishers one wave of `sms` CTAs
int expiry_ctas(long long C, int S, int sms) {
  const long long by_rows = (C + kThreads * 16 - 1) / (kThreads * 16);
  const long long by_grid = (sms - S) / S > 1 ? (sms - S) / S : 1;
  const long long x = by_rows < by_grid ? by_rows : by_grid;
  return static_cast<int>(x < 1 ? 1 : x);
}

}  // namespace

extern "C" {

const char* guber_stats_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the expiry slices a shard the kernel chooses for C rows over S shards on
// the current device, or a negative cudaError_t
int guber_stats_expiry_ctas(long long C, int S) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return expiry_ctas(C, S < 1 ? 1 : S, sms);
}

// Finish one drain's analytics over S shards (see the top of this file):
// sketch i64[S, D, W] updated in place; the accumulator (index i32[S, C],
// entries i64[S, N, 4], count i32[S], tenant i64[S, T, 3], header
// i64[S, 4]) read and cleared; est i64[S, N] scratch; expire i64[S, C];
// ecount u64[S, 2] and edone u32[S] zero before and after; writes stats
// i64[S, 8 + 3T + 4 topk].  X expiry slices a shard (0: the kernel's
// choice); key_cap rank keys in shared memory (-1: min(N, kMaxKeys));
// sketch_smem 1 works on the sketch in shared memory, 0 in place (-1: in
// shared memory when it fits beside the keys); stamps
// u64[S * 8 + 2] (null: none) takes the debug stamps, its last two set to
// the largest and smallest u64 by the caller.  Returns cudaGetLastError()
// after the launch.
int guber_stats_finish(void* sketch, int D, long long W, void* index, const void* entries,
                       void* count, void* tenant, void* header, void* est, long long N, int T,
                       const void* expire, long long C, int S, long long now, int decay,
                       long long over_weight, int topk, void* ecount, void* edone,
                       void* stats, int X, int key_cap, int sketch_smem, void* stamps,
                       void* stream) {
  if (S < 1 || D < 1 || D > 8 || W < 1 || N < 1 || T < 1 || C < 1 || topk < 1 ||
      decay < 0 || decay > 1 || X < 0 || key_cap > kMaxKeys || C - 1 > 0xFFFFFFFFll) {
    return cudaErrorInvalidValue;
  }
  if (X == 0) {
    X = guber_stats_expiry_ctas(C, S);
    if (X < 0) return -X;
  }
  if (key_cap < 0) key_cap = static_cast<int>(N < kMaxKeys ? N : kMaxKeys);
  const int64_t keys_bytes = static_cast<int64_t>(key_cap) * sizeof(Key);
  if (keys_bytes > kSmemBudget) return cudaErrorInvalidValue;
  if (sketch_smem < 0) sketch_smem = sketch_bytes(D, W) + keys_bytes <= kSmemBudget;
  if (sketch_smem && sketch_bytes(D, W) + keys_bytes > kSmemBudget) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(keys_bytes + (sketch_smem ? sketch_bytes(D, W) : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stats_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  Args a{static_cast<int64_t*>(sketch), D, static_cast<int64_t>(W),
         static_cast<int32_t*>(index), static_cast<const int64_t*>(entries),
         static_cast<int32_t*>(count), static_cast<int64_t*>(tenant),
         static_cast<int64_t*>(header), static_cast<int64_t*>(est), static_cast<int64_t>(N), T,
         static_cast<const int64_t*>(expire), static_cast<int64_t>(C),
         static_cast<int64_t>(now), decay, static_cast<int64_t>(over_weight), topk,
         static_cast<unsigned long long*>(ecount), static_cast<unsigned int*>(edone),
         static_cast<int64_t*>(stats), static_cast<int64_t>(8 + 3 * T + 4 * topk), S, X,
         key_cap, sketch_smem != 0, static_cast<unsigned long long*>(stamps)};
  stats_finish_kernel<<<S + S * X, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
