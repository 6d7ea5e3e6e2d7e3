// The serving window drain for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernels window_drain_fused_planes
// (gubernator_tpu/ops/pallas_kernel.py:974) and its K=1 form
// window_step_fused_planes (:793).  It computes what they compute, which is
// what the int64 oracle computes (gubernator_tpu_torch/ops/kernel.py
// window_step + encode_output_word): K windows of requests applied in order
// to each of S shards' slot arenas.  Per shard and window:
//
//   decode each lane -> stable sort of the lanes by slot -> for each slot,
//   its lanes walked in arrival order through the five-algorithm transition
//   ladder -> one write per touched slot -> each lane's response written
//   straight to its request position (no unsort pass).
//
// Design.  The grid is one CTA per shard (the JAX mesh's shard axis as the
// arena's leading dimension): CTA s drains row s of the [S, C] arena planes
// with the shard's lanes of each window, and no CTA reads or writes another
// shard's row, so the CTAs need nothing from each other.  Each CTA loops
// over the K windows; a __syncthreads() between windows makes window k's
// commits visible to window k+1's reads.
// The lanes of a window live in shared memory as one u64 sort key each,
// (clean_slot << lane_bits) | lane: the keys are unique, so a bitonic
// network over them is a stable argsort (pads sort last on slot 2^31-1).
// One thread owns each slot's run of lanes and walks it in arrival order;
// a lane with is_init starts a fresh virtual segment inside the run (a
// recycled slot's new tenant), and the run's final register - the last
// virtual segment's - is the one that commits.  Since one thread reads and
// writes each slot, no two threads touch one arena row.  Each virtual
// segment is classified as the oracle classifies it (fold_classify): a
// uniform segment (one config, every nonzero hit equal, no AGG lane) takes
// each lane's entering register in closed form (fold_entering) from the
// segment's entry register; any other segment is replayed lane by lane,
// fresh on its first lane on is_init, expire < now or an algorithm switch
// and on later lanes on an algorithm switch.  The two agree on sane state;
// they part where the clock runs backwards over a leaky bucket (a negative
// leak), and there the kernel follows the oracle's fold.
// The arena stays int64 in device memory; all int64 arithmetic wraps
// (done in uint64_t), and every `//` of the oracle is a floor division.
// The ladder itself (transition, sliding_roll, the integer helpers) is
// ladder.cuh, which global_window.cu shares; the closed-form fold (struct
// Fold) is fold.cuh, which window_math.cu shares.
//
// Bounds on this card.  The work per drain is small: 16 B in and 16 B out
// per lane, plus one read and one write of six arena planes per touched
// slot, each a scattered 32 B sector.  At 3.35 TB/s that is about a
// microsecond for a 8 x 1024-lane drain, so the launch latency and this
// design's serial parts set the time: one SM works per shard (at S = 1 the
// other 131 idle), the sort is 55 barrier-separated stages at 1024 lanes,
// and a hot slot's lanes run one after another on one thread (a folded
// segment's lanes need not wait for each other, but this kernel still walks
// them in turn).
//
// A second entry point, guber_drain_compact_stats, runs the same drain and
// also adds every window's traffic analytics into a per-shard accumulator
// (the TPU drain kernel's stats fold; "analytics" below).  Its extra pass
// per window re-reads the lanes, their response words and tenant ids and
// touches one accumulator entry per run: a few more bytes per lane, and
// the same serial parts.
//
// Pad lanes (slot field 0, so slot < 0) get response word 0 and limit 0;
// the plain version does the same.  Slots >= C read row C-1 as it stood
// when the window began and commit nothing, as in the oracle; the router
// never emits them.

#include <cstdint>
#include <cuda_runtime.h>

#include "fold.cuh"
#include "ladder.cuh"

namespace {

constexpr int64_t kConcMaxHits = 1 << 27;
constexpr int64_t kCompactMaxHits = 1 << 28;
constexpr int32_t kAggSlotBit = 1 << 30;
constexpr uint64_t kPadKey = 0x7FFFFFFFull;
constexpr int kMaxLanes = 16384;  // 128 KB of sort keys in shared memory
// threads per CTA: __launch_bounds__ lets the transition ladder keep up to
// 128 registers a thread without spilling
constexpr int kThreads = 512;

// One shard's row of the [S, C] arena planes.
struct Arena {
  int64_t* limit;
  int64_t* duration;
  int64_t* remaining;
  int64_t* tstamp;
  int64_t* expire;
  int32_t* algo;
  int64_t capacity;

  __device__ Arena shard(int s) const {
    const size_t off = static_cast<size_t>(s) * static_cast<size_t>(capacity);
    return Arena{limit + off, duration + off, remaining + off, tstamp + off,
                 expire + off, algo + off, capacity};
  }
};

__device__ __forceinline__ void set_slot(Req& q, int32_t raw) {
  q.valid = raw >= 0;
  q.agg = q.valid && (raw & kAggSlotBit) != 0;
  q.slot = q.agg ? (raw & ~kAggSlotBit) : raw;
}

// the compact request pair (gubernator_tpu_torch/ops/kernel.py decode_batch)
struct CompactSrc {
  const int64_t* packed;  // [B, 2]
  __device__ Req load(int lane) const {
    const int64_t w0 = packed[2 * lane];
    const int64_t w1 = packed[2 * lane + 1];
    Req q;
    q.algo = static_cast<int32_t>(((w0 >> 33) & 1) | (((w0 >> 62) & 3) << 1));
    const int64_t raw = (w0 >> 34) & (kCompactMaxHits - 1);
    q.hits = q.algo == kConcurrency ? (raw ^ kConcMaxHits) - kConcMaxHits : raw;
    q.limit = w1 & 0xFFFFFFFFll;
    q.duration = (w1 >> 32) & 0x7FFFFFFFll;
    q.init = ((w0 >> 32) & 1) != 0;
    set_slot(q, static_cast<int32_t>(static_cast<uint32_t>(w0) - 1u));
    return q;
  }
};

// decoded int64 columns (the engine's full-format window)
struct FullSrc {
  const int32_t* slot;
  const int64_t* hits;
  const int64_t* limit;
  const int64_t* duration;
  const int32_t* algo;
  const uint8_t* init;
  __device__ FullSrc shard(size_t off) const {
    return FullSrc{slot + off, hits + off, limit + off, duration + off, algo + off, init + off};
  }
  __device__ Req load(int lane) const {
    Req q;
    set_slot(q, slot[lane]);
    q.hits = hits[lane];
    q.limit = limit[lane];
    q.duration = duration[lane];
    q.algo = algo[lane];
    q.init = init[lane] != 0;
    return q;
  }
};

// response word: kernel.encode_output_word
struct CompactDst {
  int64_t* words;
  int64_t* limits;
  __device__ void store(int lane, const Out& o, int64_t now) const {
    const int64_t enc =
        o.reset == 0 ? 0 : clip(sub(o.reset, now), 0, (1ll << 31) - 2) + 1;
    const uint64_t rem = static_cast<uint64_t>(clip(o.remaining, 0, (1ll << 31) - 1));
    words[lane] = static_cast<int64_t>((static_cast<uint64_t>(enc) << 32) |
                                       (static_cast<uint64_t>(o.status) << 31) | rem);
    limits[lane] = o.limit;
  }
  __device__ void pad(int lane) const {
    words[lane] = 0;
    limits[lane] = 0;
  }
};

struct FullDst {
  int32_t* status;
  int64_t* limit;
  int64_t* remaining;
  int64_t* reset;
  __device__ FullDst shard(size_t off) const {
    return FullDst{status + off, limit + off, remaining + off, reset + off};
  }
  __device__ void store(int lane, const Out& o, int64_t) const {
    status[lane] = o.status;
    limit[lane] = o.limit;
    remaining[lane] = o.remaining;
    reset[lane] = o.reset;
  }
  __device__ void pad(int lane) const {
    status[lane] = 0;
    limit[lane] = 0;
    remaining[lane] = 0;
    reset[lane] = 0;
  }
};

// Ascending bitonic sort of n (a power of two) unique keys in shared memory.
__device__ void bitonic_sort(uint64_t* key, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = key[i], b = key[ixj];
          if ((a > b) == ((i & k) == 0)) {
            key[i] = b;
            key[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// One window: sort, walk each slot's run, commit, respond.  Ends with a
// barrier so the next window sees this one's commits and the key buffer
// can be refilled.
template <class Src, class Dst>
__device__ void run_window(const Src& src, const Dst& dst, const Arena& arena,
                           int B, int Bp, int lane_bits, int64_t now,
                           uint64_t* key, int* mism) {
  // Row C - 1 as the window found it: a run on a slot past the arena reads
  // it (kernel.window_prep clips the gather), and the oracle gathers every
  // row before the window, so such a run must not see a same-window commit
  // of the run on slot C - 1.  Read here, before the barrier that ends the
  // key fill; every commit of this window comes after the sort's barriers.
  __shared__ Reg last_row;
  const int64_t last = arena.capacity - 1;
  if (threadIdx.x == 0) {
    last_row = Reg{arena.limit[last],  arena.duration[last], arena.remaining[last],
                   arena.tstamp[last], arena.expire[last],   arena.algo[last]};
  }
  for (int i = threadIdx.x; i < Bp; i += blockDim.x) {
    uint64_t slot_key = kPadKey;
    if (i < B) {
      const Req q = src.load(i);
      if (q.valid) slot_key = static_cast<uint32_t>(q.slot);
    }
    key[i] = (slot_key << lane_bits) | static_cast<uint64_t>(i);
  }
  __syncthreads();
  bitonic_sort(key, Bp);

  const uint64_t lane_mask = (1ull << lane_bits) - 1;
  for (int i = threadIdx.x; i < Bp; i += blockDim.x) {
    int lane = static_cast<int>(key[i] & lane_mask);
    if (lane >= B) continue;
    Req q = src.load(lane);
    if (!q.valid) {
      dst.pad(lane);
      continue;
    }
    const uint64_t slot = key[i] >> lane_bits;
    if (i > 0 && (key[i - 1] >> lane_bits) == slot) continue;  // not the run's head

    Reg r = last_row;
    if (static_cast<int64_t>(slot) < last) {
      r = Reg{arena.limit[slot],  arena.duration[slot], arena.remaining[slot],
              arena.tstamp[slot], arena.expire[slot],   arena.algo[slot]};
    }
    bool mismatch = false;
    auto lane_at = [&](int m) { return static_cast<int>(key[m] & lane_mask); };
    auto in_run = [&](int m) {
      return m < Bp && (key[m] >> lane_bits) == slot && lane_at(m) < B;
    };
    // the run's virtual segments in turn: [j, e) ends before the next
    // is_init lane or at the run's end (kernel.segment_structure)
    for (int j = i; in_run(j);) {
      const Req q0 = src.load(lane_at(j));
      int64_t n_lead = q0.hits == 0 ? 1 : 0;
      int64_t hstar = q0.hits;
      bool cfg_ok = !q0.agg;
      int e = j + 1;
      for (; in_run(e); ++e) {
        const Req q = src.load(lane_at(e));
        if (q.init) break;
        if (hstar == 0) {
          if (q.hits == 0) ++n_lead; else hstar = q.hits;
        }
        cfg_ok = cfg_ok && !q.agg && q.limit == q0.limit && q.duration == q0.duration &&
                 q.algo == q0.algo && (q.hits == 0 || q.hits == hstar);
      }
      // kernel.fold_classify
      const bool fresh_seg = q0.init || r.expire < now;
      const bool fresh0 = fresh_seg || q0.algo != r.algo;
      bool fold = false;
      if (e - j >= 2) {
        const int64_t L_eff = fresh0 ? q0.limit : r.limit;
        const int64_t rate0 =
            imax(fdiv(fresh0 ? q0.duration : r.duration, imax(q0.limit, 1)), 1);
        const int64_t leak0 = fresh0 ? 0 : fdiv(sub(now, r.tstamp), rate0);
        const bool lky_ok = q0.algo != kLeaky || fresh0 ||
                            (r.remaining <= L_eff && (leak0 >= 0 || n_lead == 0));
        fold = cfg_ok && (hstar >= 0 || q0.algo == kConcurrency) && lky_ok;
      }
      // one lane through the ladder from r, its response to its position
      auto apply = [&](int m, bool fresh) {
        const int lane = lane_at(m);
        const Req q = src.load(lane);
        const Out o = transition(r, q, now, fresh);
        dst.store(lane, o, now);
        mismatch |= o.limit != q.limit;
        return q.hits != 0;
      };
      if (fold) {
        // every lane enters from the closed form; only the first is fresh
        const Fold f(r, fresh0, q0.hits, q0.limit, q0.duration, q0.algo, n_lead, hstar, now);
        int64_t nz = apply(j, fresh0) ? 1 : 0;
        for (int m = j + 1; m < e; ++m) {
          r = f.enter(m - j, nz);
          if (apply(m, false)) ++nz;
        }
      } else {
        // replay: lane by lane from the previous lane's register
        apply(j, fresh0);
        for (int m = j + 1; m < e; ++m) {
          apply(m, src.load(lane_at(m)).algo != r.algo);
        }
      }
      j = e;
    }
    if (static_cast<int64_t>(slot) < arena.capacity) {
      arena.limit[slot] = r.limit;
      arena.duration[slot] = r.duration;
      arena.remaining[slot] = r.remaining;
      arena.tstamp[slot] = r.tstamp;
      arena.expire[slot] = r.expire;
      arena.algo[slot] = r.algo;
    }
    if (mismatch) *mism = 1;
  }
  __syncthreads();
}

// ---- analytics: the stats drain (drain_compact_stats) ---------------------
//
// Replaces _accumulate_window_stats (gubernator_tpu/ops/pallas_kernel.py:852),
// the TPU drain kernel's in-kernel stats fold.  The TPU kernel sums hits in
// 14-bit limbs into i32 lo/hi pair planes and zeroes [C]-wide planes every
// drain; here the sums are int64 and live in a per-shard accumulator that
// grows only by the rows a drain touches:
//
//   index   i32[S, C]     arena row -> its entry + 1 (0: untouched)
//   entries i64[S, N, 4]  (row, occupied lanes, over-limit lanes, hits)
//   count   i32[S]        entries in use
//   tenant  i64[S, T, 3]  per tenant id: occupied lanes, hits, over
//   header  i64[S, 4]     lanes, hits, over, inits
//
// The finisher (stats_finish.cu) reads and clears exactly what a drain
// added, so no drain pays O(C) to zero anything.  The sums follow the
// oracle (ops/analytics.py oracle_stats) on the drain's own wire arrays:
// a lane's arena row is its request word's slot field with the AGG bit
// stripped, clipped to C - 1; hits are the raw 28-bit field (a
// CONCURRENCY release counts its two's-complement image, an AGG lane its
// run's total); over-limit is the response word's status bit; tenant ids
// clip to [0, T - 1].
//
// After a window's walk (and its barrier) each thread takes sorted
// positions again.  Per lane it adds to the tenant rows (shared memory,
// atomics) and to its own header sums (registers, reduced once per
// drain).  The head of each slot's run sums the run and adds it to the
// run's entry, appending the row first when the drain has not seen it:
// one thread per row and window, barriers between windows, so the entries
// need no atomics.  Rows below C - 1 are exactly the runs of the sort;
// lanes the oracle clips to row C - 1 (slots >= C - 1, and wire words the
// drain treats as padding) add into three shared counters that thread 0
// commits after a barrier.
struct StatsAcc {
  const int32_t* tenants;  // [K, S, B]
  int T;
  int32_t* index;
  int64_t* entries;
  int32_t* count;
  int64_t* tenant;
  int64_t* header;
  int64_t N;  // entries per shard
};

// row += (occ, over, hits), appending the row when the drain first sees it
__device__ void commit_row(const StatsAcc& a, int s, int64_t C, int64_t row, uint64_t occ,
                           uint64_t over, uint64_t hits, int* n_entries) {
  int32_t* idx = a.index + static_cast<size_t>(s) * static_cast<size_t>(C) + row;
  int64_t* e;
  if (*idx == 0) {
    const int k = atomicAdd(n_entries, 1);
    *idx = k + 1;
    e = a.entries + (static_cast<size_t>(s) * a.N + k) * 4;
    e[0] = row;
    e[1] = e[2] = e[3] = 0;
  } else {
    e = a.entries + (static_cast<size_t>(s) * a.N + (*idx - 1)) * 4;
  }
  e[1] = add(e[1], static_cast<int64_t>(occ));
  e[2] = add(e[2], static_cast<int64_t>(over));
  e[3] = add(e[3], static_cast<int64_t>(hits));
}

// One window's stats (kernel window k of shard s), after run_window.
__device__ void window_stats(const StatsAcc& a, int s, int64_t C, const int64_t* packed,
                             const int64_t* words, const int32_t* tenants, int B, int Bp,
                             int lane_bits, const uint64_t* key, unsigned long long* trows,
                             unsigned long long* clip_row, int* n_entries, uint64_t* hdr) {
  const uint64_t lane_mask = (1ull << lane_bits) - 1;
  auto lane_at = [&](int m) { return static_cast<int>(key[m] & lane_mask); };
  for (int i = threadIdx.x; i < Bp; i += blockDim.x) {
    const int lane = lane_at(i);
    if (lane >= B) continue;
    const int64_t w0 = packed[2 * lane];
    const int64_t slot = (w0 & (0xFFFFFFFFll & ~static_cast<int64_t>(kAggSlotBit))) - 1;
    if (slot < 0) continue;
    const uint64_t hits = static_cast<uint64_t>((w0 >> 34) & (kCompactMaxHits - 1));
    const uint64_t over = static_cast<uint64_t>((words[lane] >> 31) & 1);
    hdr[0] += 1;
    hdr[1] += hits;
    hdr[2] += over;
    hdr[3] += static_cast<uint64_t>((w0 >> 32) & 1);
    const int t = static_cast<int>(clip(tenants[lane], 0, a.T - 1));
    atomicAdd(&trows[3 * t], 1ull);
    atomicAdd(&trows[3 * t + 1], static_cast<unsigned long long>(hits));
    atomicAdd(&trows[3 * t + 2], static_cast<unsigned long long>(over));
    if (slot >= C - 1) {
      atomicAdd(&clip_row[0], 1ull);
      atomicAdd(&clip_row[1], static_cast<unsigned long long>(over));
      atomicAdd(&clip_row[2], static_cast<unsigned long long>(hits));
      continue;
    }
    // a row below C - 1 is one run of the sort: its head sums it
    const uint64_t skey = key[i] >> lane_bits;
    if (i > 0 && (key[i - 1] >> lane_bits) == skey) continue;
    uint64_t occ = 0, r_over = 0, r_hits = 0;
    for (int m = i; m < Bp && (key[m] >> lane_bits) == skey && lane_at(m) < B; ++m) {
      const int l = lane_at(m);
      occ += 1;
      r_over += static_cast<uint64_t>((words[l] >> 31) & 1);
      r_hits += static_cast<uint64_t>((packed[2 * l] >> 34) & (kCompactMaxHits - 1));
    }
    commit_row(a, s, C, slot, occ, r_over, r_hits, n_entries);
  }
  __syncthreads();
  if (threadIdx.x == 0 && clip_row[0] != 0) {
    commit_row(a, s, C, C - 1, clip_row[0], clip_row[1], clip_row[2], n_entries);
    clip_row[0] = clip_row[1] = clip_row[2] = 0;
  }
  __syncthreads();
}

// The K-window drain of shard blockIdx.x; with kStats, also the stats of
// every window into the shard's accumulator (the tenant rows in dynamic
// shared memory after the Bp sort keys).
template <bool kStats>
__device__ void drain_body(const int64_t* __restrict__ packed, const int64_t* __restrict__ nows,
                           int K, int B, int Bp, int lane_bits, const Arena& arena,
                           int64_t* words, int64_t* limits, uint8_t* mism, const StatsAcc& acc) {
  extern __shared__ uint64_t key[];
  __shared__ int window_mism;
  const int s = blockIdx.x, S = gridDim.x;
  const Arena row = arena.shard(s);
  __shared__ unsigned long long clip_row[3], hdr_sum[4];
  __shared__ int n_entries;
  unsigned long long* trows = reinterpret_cast<unsigned long long*>(key + Bp);
  uint64_t hdr[4] = {0, 0, 0, 0};
  if constexpr (kStats) {
    for (int i = threadIdx.x; i < 3 * acc.T; i += blockDim.x) trows[i] = 0;
    if (threadIdx.x == 0) {
      clip_row[0] = clip_row[1] = clip_row[2] = 0;
      hdr_sum[0] = hdr_sum[1] = hdr_sum[2] = hdr_sum[3] = 0;
      n_entries = acc.count[s];
    }
    __syncthreads();
  }
  for (int k = 0; k < K; ++k) {
    if (threadIdx.x == 0) window_mism = 0;
    // window k of shard s: [K, S, B] lane blocks, [K, S] flags
    const size_t ks = static_cast<size_t>(k) * S + s;
    const size_t off = ks * B;
    run_window(CompactSrc{packed + 2 * off}, CompactDst{words + off, limits + off},
               row, B, Bp, lane_bits, nows[k], key, &window_mism);
    if (threadIdx.x == 0) mism[ks] = static_cast<uint8_t>(window_mism);
    if constexpr (kStats) {
      window_stats(acc, s, row.capacity, packed + 2 * off, words + off, acc.tenants + off, B,
                   Bp, lane_bits, key, trows, clip_row, &n_entries, hdr);
    }
  }
  if constexpr (kStats) {
    for (int j = 0; j < 4; ++j) atomicAdd(&hdr_sum[j], static_cast<unsigned long long>(hdr[j]));
    __syncthreads();
    int64_t* tenant = acc.tenant + static_cast<size_t>(s) * 3 * acc.T;
    for (int i = threadIdx.x; i < 3 * acc.T; i += blockDim.x) {
      tenant[i] = add(tenant[i], static_cast<int64_t>(trows[i]));
    }
    for (int j = threadIdx.x; j < 4; j += blockDim.x) {
      acc.header[4 * s + j] = add(acc.header[4 * s + j], static_cast<int64_t>(hdr_sum[j]));
    }
    if (threadIdx.x == 0) acc.count[s] = n_entries;
  }
}

__global__ void __launch_bounds__(kThreads) drain_compact_kernel(const int64_t* __restrict__ packed,
                                     const int64_t* __restrict__ nows, int K, int B,
                                     int Bp, int lane_bits, Arena arena,
                                     int64_t* words, int64_t* limits, uint8_t* mism) {
  drain_body<false>(packed, nows, K, B, Bp, lane_bits, arena, words, limits, mism, StatsAcc{});
}

__global__ void __launch_bounds__(kThreads) drain_compact_stats_kernel(
    const int64_t* __restrict__ packed, const int64_t* __restrict__ nows, int K, int B, int Bp,
    int lane_bits, Arena arena, int64_t* words, int64_t* limits, uint8_t* mism, StatsAcc acc) {
  drain_body<true>(packed, nows, K, B, Bp, lane_bits, arena, words, limits, mism, acc);
}

__global__ void __launch_bounds__(kThreads) window_full_kernel(FullSrc src, int64_t now, int B, int Bp,
                                   int lane_bits, Arena arena, FullDst dst) {
  extern __shared__ uint64_t key[];
  __shared__ int unused_mism;
  const size_t off = static_cast<size_t>(blockIdx.x) * B;
  run_window(src.shard(off), dst.shard(off), arena.shard(blockIdx.x), B, Bp, lane_bits, now,
             key, &unused_mism);
}

struct Geometry {
  int Bp, lane_bits, threads;
  size_t smem;
};

Geometry geometry(int B) {
  Geometry g;
  g.Bp = 1;
  g.lane_bits = 0;
  while (g.Bp < B) {
    g.Bp <<= 1;
    ++g.lane_bits;
  }
  if (g.lane_bits < 1) g.lane_bits = 1;
  g.threads = g.Bp < 32 ? 32 : (g.Bp > kThreads ? kThreads : g.Bp);
  g.smem = static_cast<size_t>(g.Bp) * sizeof(uint64_t);
  return g;
}

Arena make_arena(void* limit, void* duration, void* remaining, void* tstamp,
                 void* expire, void* algo, long long capacity) {
  return Arena{static_cast<int64_t*>(limit),  static_cast<int64_t*>(duration),
               static_cast<int64_t*>(remaining), static_cast<int64_t*>(tstamp),
               static_cast<int64_t*>(expire), static_cast<int32_t*>(algo),
               static_cast<int64_t>(capacity)};
}

}  // namespace

extern "C" {

int guber_max_lanes() { return kMaxLanes; }

const char* guber_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K compact windows over S shards in one launch of S CTAs: packed
// i64[K, S, B, 2], nows i64[K], the six [S, C] arena planes updated in place;
// writes words i64[K, S, B], limits i64[K, S, B], mism u8[K, S].  Returns
// cudaGetLastError() after the launch.
int guber_drain_compact(const void* packed, const void* nows, int K, int S, int B,
                        void* limit, void* duration, void* remaining, void* tstamp,
                        void* expire, void* algo, long long capacity, void* words,
                        void* limits, void* mism, void* stream) {
  if (K < 1 || S < 1 || B < 1 || B > kMaxLanes || capacity < 1) return cudaErrorInvalidValue;
  const Geometry g = geometry(B);
  cudaError_t err = cudaFuncSetAttribute(
      drain_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  drain_compact_kernel<<<S, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(packed), static_cast<const int64_t*>(nows), K, B,
      g.Bp, g.lane_bits,
      make_arena(limit, duration, remaining, tstamp, expire, algo, capacity),
      static_cast<int64_t*>(words), static_cast<int64_t*>(limits),
      static_cast<uint8_t*>(mism));
  return cudaGetLastError();
}

// drain_compact plus the analytics of every window (see StatsAcc): tenants
// i32[K, S, B] with T tenant rows; the accumulator's index i32[S, C],
// entries i64[S, N, 4], count i32[S], tenant i64[S, T, 3], header i64[S, 4],
// added to in place.  The caller guarantees count + K * B <= N.  Returns
// cudaGetLastError() after the launch.
int guber_drain_compact_stats(const void* packed, const void* nows, int K, int S, int B,
                              void* limit, void* duration, void* remaining, void* tstamp,
                              void* expire, void* algo, long long capacity, void* words,
                              void* limits, void* mism, const void* tenants, int T,
                              void* index, void* entries, void* count, void* tenant,
                              void* header, long long N, void* stream) {
  if (K < 1 || S < 1 || B < 1 || B > kMaxLanes || capacity < 1 || T < 1 || N < 1) {
    return cudaErrorInvalidValue;
  }
  const Geometry g = geometry(B);
  const size_t smem = g.smem + static_cast<size_t>(3 * T) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(drain_compact_stats_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const StatsAcc acc{static_cast<const int32_t*>(tenants), T, static_cast<int32_t*>(index),
                     static_cast<int64_t*>(entries),  static_cast<int32_t*>(count),
                     static_cast<int64_t*>(tenant),   static_cast<int64_t*>(header),
                     static_cast<int64_t>(N)};
  drain_compact_stats_kernel<<<S, g.threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(packed), static_cast<const int64_t*>(nows), K, B, g.Bp,
      g.lane_bits, make_arena(limit, duration, remaining, tstamp, expire, algo, capacity),
      static_cast<int64_t*>(words), static_cast<int64_t*>(limits), static_cast<uint8_t*>(mism),
      acc);
  return cudaGetLastError();
}

// One window of decoded columns over S shards (the engine's full-format
// path), one CTA per shard: slot i32, hits/limit/duration i64, algo i32,
// is_init u8, all [S, B]; the six [S, C] arena planes updated in place;
// writes status i32, limit/remaining/reset i64 [S, B].  Returns
// cudaGetLastError() after the launch.
int guber_window_full(const void* slot, const void* hits, const void* limit_in,
                      const void* duration_in, const void* algo_in, const void* init,
                      long long now, int S, int B, void* limit, void* duration,
                      void* remaining, void* tstamp, void* expire, void* algo,
                      long long capacity, void* status_out, void* limit_out,
                      void* remaining_out, void* reset_out, void* stream) {
  if (S < 1 || B < 1 || B > kMaxLanes || capacity < 1) return cudaErrorInvalidValue;
  const Geometry g = geometry(B);
  cudaError_t err = cudaFuncSetAttribute(
      window_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  const FullSrc src{static_cast<const int32_t*>(slot), static_cast<const int64_t*>(hits),
                    static_cast<const int64_t*>(limit_in),
                    static_cast<const int64_t*>(duration_in),
                    static_cast<const int32_t*>(algo_in), static_cast<const uint8_t*>(init)};
  const FullDst dst{static_cast<int32_t*>(status_out), static_cast<int64_t*>(limit_out),
                    static_cast<int64_t*>(remaining_out), static_cast<int64_t*>(reset_out)};
  window_full_kernel<<<S, g.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<int64_t>(now), B, g.Bp, g.lane_bits,
      make_arena(limit, duration, remaining, tstamp, expire, algo, capacity), dst);
  return cudaGetLastError();
}

}  // extern "C"
