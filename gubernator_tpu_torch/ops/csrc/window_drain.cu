// The serving window drain for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernels window_drain_fused_planes
// (gubernator_tpu/ops/pallas_kernel.py:974) and its K=1 form
// window_step_fused_planes (:793).  It computes what they compute, which is
// what the int64 oracle computes (gubernator_tpu_torch/ops/kernel.py
// window_step + encode_output_word): K windows of requests applied in order
// to each of S shards' slot arenas.  Per shard and window:
//
//   decode each lane -> stable sort of the lanes by slot -> virtual
//   segments (a slot's run, cut again at each is_init lane) -> each lane's
//   response from its segment's entering register -> one write per touched
//   slot -> each response straight to its request position (no unsort).
//
// Design.  The grid is P x S CTAs.  CTA (p, s) owns the lanes of shard s
// whose routing row, min(slot, C - 1), hashes to partition p (a
// multiplicative hash, so a Zipf head's hot slots spread over the CTAs),
// and it drains all K windows of those rows in order.  A row's lanes meet
// one CTA only, so window order per row holds without any cross-CTA
// synchronisation, and no two CTAs touch one arena row.  Routing on the
// clamped row keeps every lane that reads row C - 1 (slot C - 1 and the
// slots past the arena, which read the row as the window found it) in the
// CTA that commits it.  The host picks P from the SM count, S and the CTAs
// an SM holds, aiming at one wave; an explicit P overrides it.
//
// Per window each CTA:
//   1. stages the window's 16 B compact lanes in shared memory, in chunks
//      of up to 1024 lanes through a double buffer filled with cp.async;
//      the first chunk of window k + 1 is requested before window k is
//      sorted and walked, so its copy overlaps that work;
//   2. decodes the staged lanes (every lane once), keeps the ones it owns
//      in a shared-memory array in lane order (a block scan of owned
//      counts gives each its place) with the sort key
//      (slot << lane_bits) | index, unique, so the sort is stable;
//   3. sorts only what it owns: a bitonic network over the next power of
//      two of the owned count, strides below 32 in registers through
//      __shfl_xor_sync, larger ones through shared memory;
//   4. finds the segment structure with block scans over the sorted lanes
//      (kernel.segment_structure): each lane's segment start, its count
//      of earlier nonzero hits, its physical run; then each segment's end,
//      leading zero-hit lanes and first nonzero hit, and whether every
//      lane shares the first lane's config (kernel.fold_classify);
//   5. reads each physical run's arena row once, as the window found it,
//      into shared memory: every virtual segment enters from it, as the
//      oracle's gather does (kernel.window_prep);
//   6. answers every lane: in a uniform (folded) segment each lane builds
//      the closed-form fold (struct Fold, fold.cuh) from the segment's
//      shared inputs, takes its entering register f.enter(pos, nz) and one
//      transition on its own thread; any other segment is replayed lane by
//      lane by one thread (fresh on its first lane on is_init, expiry or an
//      algorithm switch, on later lanes on a switch), different segments on
//      different threads.  The last lane of a run's last virtual segment
//      commits the row: every read of the window's rows came before the
//      barrier that opens this step.
// Barriers separate the steps and the windows, so window k + 1 reads
// window k's commits.  The two paths agree on sane state; they part where
// the clock runs backwards over a leaky bucket (a negative leak), and
// there the kernel follows the oracle's fold.  The arena stays int64 in
// device memory; all int64 arithmetic wraps (done in uint64_t), and every
// `//` of the oracle is a floor division.  The ladder (transition,
// sliding_roll, the integer helpers) is ladder.cuh, which
// global_window.cu shares; the closed-form fold is fold.cuh, which
// window_math.cu shares.
//
// Per-CTA arrays sized to the window's B lanes live in dynamic shared
// memory when they fit (compact windows up to about 2400 lanes); larger
// windows keep them in a workspace in device memory that the wrapper
// allocates, one slice per CTA, and only the owned part of a slice is
// touched.  The staging buffers stay in shared memory either way.
//
// Bounds on this card.  The work per drain is small: 16 B in and 16 B out
// per lane, plus one read and one write of six arena planes per touched
// slot, each a scattered 32 B sector.  At 3.35 TB/s that is about a
// microsecond for a 8 x 1024-lane drain.  What is left above it is each
// window's chain of barriers and its dependent row reads (one device
// memory latency per window), and a replayed segment's lanes, which still
// run one after another on one thread: a hot key whose runs do not fold
// costs its longest replayed segment.
//
// A second entry point, guber_drain_compact_stats, runs the same drain and
// also adds every window's traffic analytics into a per-shard accumulator
// (the TPU drain kernel's stats fold; "analytics" below).
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
constexpr int kMaxLanes = 16384;
// threads per CTA: __launch_bounds__ leaves the ladder and the fold up to
// 255 registers a thread
constexpr int kThreads = 256;
// lanes per staged chunk
constexpr int kChunk = 1024;
// dynamic shared memory a CTA may take: Hopper's 227 KB less room for the
// kernel's static shared memory
constexpr size_t kSmemBudget = 232448 - 4096;
// the most workspace a launch's chosen P may ask for
constexpr long long kWorkspaceCap = 64ll << 20;

// ---- the async copy of staged lanes: the kernel's only inline PTX ---------
#ifndef GUBER_HOST_SHIM
// start copying 16 B from device memory into shared memory
__device__ __forceinline__ void stage_copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
// close the copies this thread started into one group
__device__ __forceinline__ void stage_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait for every group of this thread but the newest
__device__ __forceinline__ void stage_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
#endif

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
  __device__ Reg load(int64_t row) const {
    return Reg{limit[row], duration[row], remaining[row], tstamp[row], expire[row], algo[row]};
  }
  __device__ void store(int64_t row, const Reg& r) const {
    limit[row] = r.limit;
    duration[row] = r.duration;
    remaining[row] = r.remaining;
    tstamp[row] = r.tstamp;
    expire[row] = r.expire;
    algo[row] = r.algo;
  }
};

__device__ __forceinline__ void set_slot(Req& q, int32_t raw) {
  q.valid = raw >= 0;
  q.agg = q.valid && (raw & kAggSlotBit) != 0;
  q.slot = q.agg ? (raw & ~kAggSlotBit) : raw;
}

// A staged compact lane: the request pair (kernel.decode_batch).
struct CompactLane {
  int64_t w0, w1;
};

__device__ __forceinline__ Req decode(const CompactLane& l) {
  Req q;
  q.algo = static_cast<int32_t>(((l.w0 >> 33) & 1) | (((l.w0 >> 62) & 3) << 1));
  const int64_t raw = (l.w0 >> 34) & (kCompactMaxHits - 1);
  q.hits = q.algo == kConcurrency ? (raw ^ kConcMaxHits) - kConcMaxHits : raw;
  q.limit = l.w1 & 0xFFFFFFFFll;
  q.duration = (l.w1 >> 32) & 0x7FFFFFFFll;
  q.init = ((l.w0 >> 32) & 1) != 0;
  set_slot(q, static_cast<int32_t>(static_cast<uint32_t>(l.w0) - 1u));
  return q;
}

// A staged lane of decoded int64 columns (the engine's full-format window).
struct FullLane {
  int64_t hits, limit, duration;
  int32_t slot, algo;
  uint8_t init;
};

__device__ __forceinline__ Req decode(const FullLane& l) {
  Req q;
  set_slot(q, l.slot);
  q.hits = l.hits;
  q.limit = l.limit;
  q.duration = l.duration;
  q.algo = l.algo;
  q.init = l.init != 0;
  return q;
}

// compact request words [B, 2]: staged with async 16 B copies
struct CompactSrc {
  using Lane = CompactLane;
  const int64_t* packed;
  // start staging lanes [l0, l0 + n) into buf
  __device__ void issue(CompactLane* buf, int l0, int n) const {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      stage_copy16(buf + i, packed + 2 * static_cast<size_t>(l0 + i));
    }
  }
};

// decoded int64 columns [B]: staged with plain loads (one window a launch,
// so there is no next window to overlap)
struct FullSrc {
  using Lane = FullLane;
  const int32_t* slot;
  const int64_t* hits;
  const int64_t* limit;
  const int64_t* duration;
  const int32_t* algo;
  const uint8_t* init;
  __device__ FullSrc shard(size_t off) const {
    return FullSrc{slot + off, hits + off, limit + off, duration + off, algo + off, init + off};
  }
  __device__ void issue(FullLane* buf, int l0, int n) const {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int l = l0 + i;
      buf[i] = FullLane{hits[l], limit[l], duration[l], slot[l], algo[l], init[l]};
    }
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

// the partition that owns an arena row
__device__ __forceinline__ int owner(int64_t row, int P) {
  const uint32_t h = static_cast<uint32_t>(row) * 2654435769u;
  return static_cast<int>((static_cast<uint64_t>(h) * static_cast<uint64_t>(P)) >> 32);
}

// ---- block scans ------------------------------------------------------------

// What the segment scan carries: nonzero-hit lanes, physical runs, and the
// latest segment start (-1: none yet).
struct Carry {
  uint32_t nz, runs;
  int32_t last;
};

__device__ __forceinline__ Carry combine(const Carry& a, const Carry& b) {
  return Carry{a.nz + b.nz, a.runs + b.runs, b.last > a.last ? b.last : a.last};
}

// Exclusive scan of one Carry a thread, in thread order; *total gets the
// whole block's.  Every thread of the block calls it.
__device__ Carry block_scan(const Carry& v, Carry* total) {
  __shared__ Carry warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Carry x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const Carry y{__shfl_up_sync(0xffffffffu, x.nz, d), __shfl_up_sync(0xffffffffu, x.runs, d),
                  __shfl_up_sync(0xffffffffu, x.last, d)};
    if (lane >= d) x = combine(y, x);
  }
  if (lane == 31 || threadIdx.x == blockDim.x - 1) warp_sum[warp] = x;
  // x of the lane before, the warp's exclusive prefix
  Carry ex{__shfl_up_sync(0xffffffffu, x.nz, 1), __shfl_up_sync(0xffffffffu, x.runs, 1),
           __shfl_up_sync(0xffffffffu, x.last, 1)};
  if (lane == 0) ex = Carry{0, 0, -1};
  __syncthreads();
  Carry before{0, 0, -1}, all{0, 0, -1};
  const int warps = (blockDim.x + 31) >> 5;
  for (int w = 0; w < warps; ++w) {
    if (w == warp) before = all;
    all = combine(all, warp_sum[w]);
  }
  __syncthreads();
  *total = all;
  return combine(before, ex);
}

// Ascending bitonic sort of n (a power of two) unique keys in shared
// memory.  Strides of 32 and up go through shared memory, one barrier
// each; the strides below 32 of each merge run in registers, element i on
// lane i % 32 of a warp, exchanged with __shfl_xor_sync.
__device__ void bitonic_sort(uint64_t* key, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32 || (j > 0 && blockDim.x < 32); j >>= 1) {
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
    if (j == 0) continue;
    for (int base = 0; base < n; base += blockDim.x) {
      const int i = base + static_cast<int>(threadIdx.x);
      if ((i & ~31) >= n) continue;  // whole warps past the keys
      uint64_t v = i < n ? key[i] : ~0ull;
      const bool up = (i & k) == 0;
      for (int jj = j; jj > 0; jj >>= 1) {
        const uint64_t o = __shfl_xor_sync(0xffffffffu, v, jj);
        const bool lower = (i & jj) == 0;
        v = (lower == up) ? (o < v ? o : v) : (o > v ? o : v);
      }
      if (i < n) key[i] = v;
    }
    __syncthreads();
  }
}

// ---- per-CTA arrays -------------------------------------------------------

// Byte offsets of a CTA's arrays for windows of B lanes: the staging
// double buffer and the stats drain's tenant sums in dynamic shared memory,
// then the arrays indexed by owned lane or sorted position, in shared
// memory too unless they do not fit (`global`: then in the workspace, one
// slice of array_bytes per CTA).
struct Layout {
  int lane_bits, chunk;
  size_t trows, arrays, smem;
  size_t key, lane, rows, lane_of, ss, cnz, run, seg_end, n_lead, bad, over;
  size_t array_bytes;
  bool global;
};

inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

Layout layout(int B, size_t lane_size, int T) {
  Layout g;
  int np2 = 1;
  g.lane_bits = 0;
  while (np2 < B) {
    np2 <<= 1;
    ++g.lane_bits;
  }
  if (g.lane_bits < 1) g.lane_bits = 1;
  g.chunk = B < kChunk ? B : kChunk;
  const size_t n = static_cast<size_t>(B);
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = align16(o + bytes);
    return at;
  };
  g.key = take(8 * static_cast<size_t>(np2));
  g.lane = take(lane_size * n);
  g.rows = take(sizeof(Reg) * n);
  g.lane_of = take(2 * n);
  g.ss = take(2 * n);
  g.cnz = take(2 * (n + 1));
  g.run = take(2 * n);
  g.seg_end = take(2 * n);
  g.n_lead = take(2 * n);
  g.bad = take(n);
  g.over = take(n);
  g.array_bytes = o;
  // the staging double buffer at offset 0
  g.trows = align16(2 * static_cast<size_t>(g.chunk) * lane_size);
  g.arrays = align16(g.trows + 3 * 8 * static_cast<size_t>(T));
  g.global = g.arrays + g.array_bytes > kSmemBudget;
  g.smem = g.global ? g.arrays : g.arrays + g.array_bytes;
  return g;
}

template <class Lane>
struct Work {
  // [B rounded up to a power of two] sort keys, (slot << lane_bits) | owned index
  uint64_t* key;
  Lane* lane;         // [B] owned lanes, in lane order
  Reg* rows;          // [B] per physical run: its arena row before the window
  uint16_t* lane_of;  // [B] owned index -> lane
  uint16_t* ss;       // [B] per sorted position: its segment's start
  uint16_t* cnz;      // [B + 1] nonzero-hit lanes before the position
  uint16_t* run;      // [B] its physical run
  uint16_t* seg_end;  // [B] at a segment start: the segment's end
  uint16_t* n_lead;   // [B] at a segment start: its first nonzero hit's offset
  uint8_t* bad;       // [B] at a segment start: some lane breaks the fold's config
  uint8_t* over;      // [B] the response's status bit (the stats pass reads it)
};

template <class Lane>
__device__ Work<Lane> work(const Layout& g, unsigned char* smem, unsigned char* workspace) {
  unsigned char* b = g.global
                         ? workspace + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                                           g.array_bytes
                         : smem + g.arrays;
  auto u16 = [&](size_t at) { return reinterpret_cast<uint16_t*>(b + at); };
  return Work<Lane>{reinterpret_cast<uint64_t*>(b + g.key), reinterpret_cast<Lane*>(b + g.lane),
                    reinterpret_cast<Reg*>(b + g.rows), u16(g.lane_of), u16(g.ss), u16(g.cnz),
                    u16(g.run), u16(g.seg_end), u16(g.n_lead), b + g.bad, b + g.over};
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
// Each lane is counted by the CTA that owns its row.  After a window's
// answers (and a barrier), each thread takes a stretch of sorted
// positions: per lane it adds to the tenant rows (shared memory, atomics)
// and to its own header sums (registers, reduced once per drain), and per
// stretch of one run it adds (lanes, over, hits) to the run's entry with
// 64-bit atomics in device memory; the run's first lane appended the entry
// (one per row and drain, counted by an atomic on count[s]) before the
// answers.  Lanes the oracle clips to row C - 1 (slots >= C - 1, and wire
// words the drain treats as padding, which the CTA of row C - 1 counts
// while it decodes) add into three shared counters that one thread
// commits after a barrier.  At its end each CTA adds its tenant rows and
// header sums into the shard's with 64-bit atomics; the unsigned adds wrap
// as `add` does.  The order of the entries is free.
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

// One CTA's analytics state for one shard's window.
struct StatsWin {
  StatsAcc acc;
  int s;
  int64_t C;
  const int32_t* tenants;    // this window's [B]
  unsigned long long* trows;  // [T, 3] shared
  unsigned long long* clip;   // [3] shared: lanes, over, hits on row C - 1
  uint64_t* hdr;              // [4] this thread's header sums
};

__device__ __forceinline__ int64_t* entry_of(const StatsAcc& a, int s, int64_t C, int64_t row) {
  const int32_t k = a.index[static_cast<size_t>(s) * static_cast<size_t>(C) + row];
  return a.entries + (static_cast<size_t>(s) * a.N + (k - 1)) * 4;
}

// the row's entry, appended when the drain first sees the row
__device__ int64_t* open_row(const StatsAcc& a, int s, int64_t C, int64_t row) {
  int32_t* idx = a.index + static_cast<size_t>(s) * static_cast<size_t>(C) + row;
  if (*idx == 0) {
    const int k = atomicAdd(a.count + s, 1);
    *idx = k + 1;
    int64_t* e = a.entries + (static_cast<size_t>(s) * a.N + k) * 4;
    e[0] = row;
    e[1] = e[2] = e[3] = 0;
    return e;
  }
  return entry_of(a, s, C, row);
}

// a lane's tenant row and header sums
__device__ __forceinline__ void count_lane(const StatsWin& st, int lane, uint64_t hits,
                                           uint64_t over, uint64_t init) {
  st.hdr[0] += 1;
  st.hdr[1] += hits;
  st.hdr[2] += over;
  st.hdr[3] += init;
  const int t = static_cast<int>(clip(st.tenants[lane], 0, st.acc.T - 1));
  atomicAdd(&st.trows[3 * t], 1ull);
  atomicAdd(&st.trows[3 * t + 1], static_cast<unsigned long long>(hits));
  atomicAdd(&st.trows[3 * t + 2], static_cast<unsigned long long>(over));
}

__device__ __forceinline__ int64_t stats_slot(int64_t w0) {
  return (w0 & (0xFFFFFFFFll & ~static_cast<int64_t>(kAggSlotBit))) - 1;
}

// the window's lanes the CTA owns (sorted positions [0, n)), after the
// answers and a barrier
template <class Lane>
__device__ void window_stats(const StatsWin& st, const Work<Lane>& w, int n, int lane_bits) {
  const uint64_t lane_mask = (1ull << lane_bits) - 1;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int a = min(n, static_cast<int>(threadIdx.x) * per), b = min(n, a + per);
  uint64_t occ = 0, r_over = 0, r_hits = 0;
  int cur = -1;
  int64_t cur_row = 0;
  auto flush = [&]() {
    if (cur < 0) return;
    auto* e = reinterpret_cast<unsigned long long*>(entry_of(st.acc, st.s, st.C, cur_row));
    atomicAdd(e + 1, static_cast<unsigned long long>(occ));
    atomicAdd(e + 2, static_cast<unsigned long long>(r_over));
    atomicAdd(e + 3, static_cast<unsigned long long>(r_hits));
    occ = r_over = r_hits = 0;
  };
  for (int i = a; i < b; ++i) {
    const int c = static_cast<int>(w.key[i] & lane_mask);
    const int64_t w0 = w.lane[c].w0;
    const int64_t slot = stats_slot(w0);
    if (slot < 0) continue;
    const uint64_t hits = static_cast<uint64_t>((w0 >> 34) & (kCompactMaxHits - 1));
    const uint64_t over = w.over[i];
    count_lane(st, w.lane_of[c], hits, over, static_cast<uint64_t>((w0 >> 32) & 1));
    if (slot >= st.C - 1) {
      atomicAdd(&st.clip[0], 1ull);
      atomicAdd(&st.clip[1], static_cast<unsigned long long>(over));
      atomicAdd(&st.clip[2], static_cast<unsigned long long>(hits));
      continue;
    }
    // a row below C - 1 is one run of the sort
    if (w.run[i] != cur) {
      flush();
      cur = w.run[i];
      cur_row = slot;
    }
    occ += 1;
    r_over += over;
    r_hits += hits;
  }
  flush();
}

// ---- one window -------------------------------------------------------------

// set byte mism[0] to 1 (the flags are bytes; the atomic takes their word)
__device__ __forceinline__ void flag_byte(uint8_t* mism) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(mism);
  atomicOr(reinterpret_cast<unsigned*>(at & ~static_cast<uintptr_t>(3)),
           1u << (8 * static_cast<unsigned>(at & 3)));
}

// One window of CTA (p, s): stage, decode, sort, segment, answer, commit,
// and with kStats count.  `ring` holds the staging double buffer; chunk j
// of this window was requested into buffer chunk_no & 1 (the caller
// requested the first), and the last chunk requests the first chunk of
// `next` when there is one.  Ends with a barrier, so the next window sees
// this one's commits.  Returns whether a valid lane got a stored limit
// other than its request's.
template <bool kStats, class Src, class Dst>
__device__ bool run_window(const Src& src, const Src* next, const Dst& dst, const Arena& arena,
                           const Work<typename Src::Lane>& w, typename Src::Lane* ring,
                           int& chunk_no, const Layout& g, int B, int64_t now, const StatsWin* st) {
  using Lane = typename Src::Lane;
  __shared__ int window_mism;
  const int p = blockIdx.x, P = gridDim.x;
  const int64_t C1 = arena.capacity - 1;
  const int lane_bits = g.lane_bits;
  const uint64_t lane_mask = (1ull << lane_bits) - 1;
  const int chunk = g.chunk;
  const int chunks = (B + chunk - 1) / chunk;
  if (threadIdx.x == 0) window_mism = 0;

  // ---- 1-2: stage and decode, keep the owned lanes in lane order ----
  int n = 0;
  for (int j = 0; j < chunks; ++j, ++chunk_no) {
    Lane* buf = ring + (chunk_no & 1) * chunk;
    Lane* nbuf = ring + ((chunk_no + 1) & 1) * chunk;
    if (j + 1 < chunks) {
      src.issue(nbuf, (j + 1) * chunk, min(chunk, B - (j + 1) * chunk));
    } else if (next != nullptr) {
      next->issue(nbuf, 0, chunk);
    }
    stage_commit();
    stage_wait_prior();
    __syncthreads();
    const int l0 = j * chunk, cn = min(chunk, B - l0);
    const int per = (cn + blockDim.x - 1) / blockDim.x;
    const int a = min(cn, static_cast<int>(threadIdx.x) * per), b = min(cn, a + per);
    uint32_t mine = 0;
    for (int i = a; i < b; ++i) {
      const Req q = decode(buf[i]);
      if (q.valid) {
        mine += owner(q.slot < C1 ? q.slot : C1, P) == p;
        continue;
      }
      const int lane = l0 + i;
      if (lane % P == p) dst.pad(lane);
      if constexpr (kStats) {
        // a wire word the drain pads but the oracle clips to row C - 1
        const int64_t w0 = buf[i].w0;
        if (stats_slot(w0) >= 0 && owner(C1, P) == p) {
          const uint64_t hits = static_cast<uint64_t>((w0 >> 34) & (kCompactMaxHits - 1));
          count_lane(*st, lane, hits, 0, static_cast<uint64_t>((w0 >> 32) & 1));
          atomicAdd(&st->clip[0], 1ull);
          atomicAdd(&st->clip[2], static_cast<unsigned long long>(hits));
        }
      }
    }
    Carry total;
    const Carry before = block_scan(Carry{mine, 0, -1}, &total);
    uint32_t c = static_cast<uint32_t>(n) + before.nz;
    for (int i = a; i < b; ++i) {
      const Req q = decode(buf[i]);
      if (q.valid && owner(q.slot < C1 ? q.slot : C1, P) == p) {
        w.key[c] = (static_cast<uint64_t>(q.slot) << lane_bits) | c;
        w.lane[c] = buf[i];
        w.lane_of[c] = static_cast<uint16_t>(l0 + i);
        ++c;
      }
    }
    n += static_cast<int>(total.nz);
    __syncthreads();  // buf is refilled two chunks on
  }

  // ---- 3: sort what the CTA owns ----
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  for (int i = n + threadIdx.x; i < np2; i += blockDim.x) w.key[i] = ~0ull;
  __syncthreads();
  bitonic_sort(w.key, np2);

  auto slot_at = [&](int i) { return static_cast<int64_t>(w.key[i] >> lane_bits); };
  auto req_at = [&](int i) { return decode(w.lane[w.key[i] & lane_mask]); };
  auto phys_start = [&](int i) { return i == 0 || slot_at(i - 1) != slot_at(i); };

  // ---- 4a: segment starts, nonzero counts and runs by one block scan ----
  {
    const int per = (n + blockDim.x - 1) / blockDim.x;
    const int a = min(n, static_cast<int>(threadIdx.x) * per), b = min(n, a + per);
    Carry mine{0, 0, -1};
    for (int i = a; i < b; ++i) {
      const Req q = req_at(i);
      const bool phys = phys_start(i);
      mine.nz += q.hits != 0;
      mine.runs += phys;
      if (phys || q.init) mine.last = i;
    }
    Carry total;
    Carry at = block_scan(mine, &total);
    for (int i = a; i < b; ++i) {
      const Req q = req_at(i);
      const bool phys = phys_start(i);
      at.runs += phys;
      if (phys || q.init) at.last = i;
      w.ss[i] = static_cast<uint16_t>(at.last);
      w.cnz[i] = static_cast<uint16_t>(at.nz);
      w.run[i] = static_cast<uint16_t>(at.runs - 1);
      at.nz += q.hits != 0;
    }
    if (threadIdx.x == 0) w.cnz[n] = static_cast<uint16_t>(total.nz);
    __syncthreads();
  }

  // ---- 4b, 5: segment ends, first nonzero hits; each run's row ----
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const Req q = req_at(i);
    const int s0 = w.ss[i];
    if (s0 == i) {
      w.bad[i] = 0;
      if (i > 0) w.seg_end[w.ss[i - 1]] = static_cast<uint16_t>(i);
    }
    if (i == n - 1) w.seg_end[s0] = static_cast<uint16_t>(n);
    if (q.hits != 0 && w.cnz[i] == w.cnz[s0]) w.n_lead[s0] = static_cast<uint16_t>(i - s0);
    if (phys_start(i)) {
      const int64_t slot = slot_at(i);
      w.rows[w.run[i]] = arena.load(slot < C1 ? slot : C1);
      if constexpr (kStats) {
        if (slot < C1) open_row(st->acc, st->s, st->C, slot);
      }
    }
  }
  __syncthreads();

  // a segment's leading zero-hit lanes and its one nonzero hit (0: none)
  auto lead = [&](int s0, int e, int64_t& hstar) {
    if (w.cnz[e] == w.cnz[s0]) {
      hstar = 0;
      return e - s0;
    }
    const int nl = w.n_lead[s0];
    hstar = req_at(s0 + nl).hits;
    return nl;
  };

  // ---- 4c: every lane holds its segment to the first lane's config ----
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s0 = w.ss[i];
    int64_t hstar;
    lead(s0, w.seg_end[s0], hstar);
    const Req q = req_at(i), q0 = req_at(s0);
    const bool ok = !q.agg && q.limit == q0.limit && q.duration == q0.duration &&
                    q.algo == q0.algo && (q.hits == 0 || q.hits == hstar);
    if (!ok) w.bad[s0] = 1;
  }
  __syncthreads();

  // ---- 6: answers and commits ----
  bool mismatch = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int s0 = w.ss[i], e = w.seg_end[s0];
    const int64_t slot = slot_at(i);
    const bool commits = (e == n || slot_at(e) != slot) && slot < arena.capacity;
    int64_t hstar;
    const int n_lead = lead(s0, e, hstar);
    const Req q0 = req_at(s0);
    const Reg row = w.rows[w.run[i]];
    // kernel.fold_classify
    const bool fresh0 = q0.init || row.expire < now || q0.algo != row.algo;
    bool fold = false;
    if (e - s0 >= 2) {
      const int64_t L_eff = fresh0 ? q0.limit : row.limit;
      const int64_t rate0 =
          imax(fdiv(fresh0 ? q0.duration : row.duration, imax(q0.limit, 1)), 1);
      const int64_t leak0 = fresh0 ? 0 : fdiv(sub(now, row.tstamp), rate0);
      const bool lky_ok = q0.algo != kLeaky || fresh0 ||
                          (row.remaining <= L_eff && (leak0 >= 0 || n_lead == 0));
      fold = !w.bad[s0] && (hstar >= 0 || q0.algo == kConcurrency) && lky_ok;
    }
    // one lane through the ladder from r, its response to its position
    auto apply = [&](int m, Reg& r, bool fresh) {
      const int c = static_cast<int>(w.key[m] & lane_mask);
      const Req q = decode(w.lane[c]);
      const Out o = transition(r, q, now, fresh);
      dst.store(w.lane_of[c], o, now);
      w.over[m] = static_cast<uint8_t>(o.status);
      mismatch |= o.limit != q.limit;
    };
    if (fold) {
      // this lane alone: its entering register in closed form
      Reg r = row;
      bool fresh = fresh0;
      if (i > s0) {
        const Fold f(row, fresh0, q0.hits, q0.limit, q0.duration, q0.algo, n_lead, hstar, now);
        r = f.enter(i - s0, w.cnz[i] - w.cnz[s0]);
        fresh = false;
      }
      apply(i, r, fresh);
      if (commits && i == e - 1) arena.store(slot, r);
    } else if (i == s0) {
      // replay: lane by lane from the previous lane's register
      Reg r = row;
      apply(s0, r, fresh0);
      for (int m = s0 + 1; m < e; ++m) apply(m, r, req_at(m).algo != r.algo);
      if (commits) arena.store(slot, r);
    }
  }
  if (mismatch) window_mism = 1;
  __syncthreads();
  if constexpr (kStats) {
    window_stats(*st, w, n, lane_bits);
    __syncthreads();
    if (threadIdx.x == 0 && owner(C1, P) == p && st->clip[0] != 0) {
      int64_t* ent = open_row(st->acc, st->s, st->C, C1);
      ent[1] = add(ent[1], static_cast<int64_t>(st->clip[0]));
      ent[2] = add(ent[2], static_cast<int64_t>(st->clip[1]));
      ent[3] = add(ent[3], static_cast<int64_t>(st->clip[2]));
      st->clip[0] = st->clip[1] = st->clip[2] = 0;
    }
    __syncthreads();
  }
  return window_mism != 0;
}

// The K-window drain of CTA (blockIdx.x, blockIdx.y) = (p, s); with kStats,
// also the stats of every window into the shard's accumulator.
template <bool kStats>
__device__ void drain_body(const int64_t* __restrict__ packed, const int64_t* __restrict__ nows,
                           int K, int B, const Layout& g, const Arena& arena, int64_t* words,
                           int64_t* limits, uint8_t* mism, const StatsAcc& acc,
                           unsigned char* workspace) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.y, S = gridDim.y;
  const Arena row = arena.shard(s);
  const Work<CompactLane> w = work<CompactLane>(g, smem, workspace);
  CompactLane* ring = reinterpret_cast<CompactLane*>(smem);
  __shared__ unsigned long long clip_row[3], hdr_sum[4];
  unsigned long long* trows = reinterpret_cast<unsigned long long*>(smem + g.trows);
  uint64_t hdr[4] = {0, 0, 0, 0};
  StatsWin st{acc, s, arena.capacity, nullptr, trows, clip_row, hdr};
  if constexpr (kStats) {
    for (int i = threadIdx.x; i < 3 * acc.T; i += blockDim.x) trows[i] = 0;
    if (threadIdx.x == 0) {
      clip_row[0] = clip_row[1] = clip_row[2] = 0;
      hdr_sum[0] = hdr_sum[1] = hdr_sum[2] = hdr_sum[3] = 0;
    }
  }
  // window k of shard s: [K, S, B] lane blocks, [K, S] flags
  auto lanes = [&](int k) { return static_cast<size_t>(k) * S * B + static_cast<size_t>(s) * B; };
  int chunk_no = 0;
  CompactSrc{packed + 2 * lanes(0)}.issue(ring, 0, g.chunk);
  stage_commit();
  for (int k = 0; k < K; ++k) {
    const size_t off = lanes(k);
    const CompactSrc next{k + 1 < K ? packed + 2 * lanes(k + 1) : nullptr};
    if constexpr (kStats) st.tenants = acc.tenants + off;
    const bool flagged = run_window<kStats>(
        CompactSrc{packed + 2 * off}, k + 1 < K ? &next : nullptr,
        CompactDst{words + off, limits + off}, row, w, ring, chunk_no, g, B, nows[k], &st);
    if (threadIdx.x == 0 && flagged) flag_byte(mism + static_cast<size_t>(k) * S + s);
  }
  if constexpr (kStats) {
    for (int j = 0; j < 4; ++j) {
      if (hdr[j] != 0) atomicAdd(&hdr_sum[j], static_cast<unsigned long long>(hdr[j]));
    }
    __syncthreads();
    unsigned long long* tenant =
        reinterpret_cast<unsigned long long*>(acc.tenant) + static_cast<size_t>(s) * 3 * acc.T;
    for (int i = threadIdx.x; i < 3 * acc.T; i += blockDim.x) {
      if (trows[i] != 0) atomicAdd(tenant + i, trows[i]);
    }
    unsigned long long* header = reinterpret_cast<unsigned long long*>(acc.header) + 4 * s;
    for (int j = threadIdx.x; j < 4; j += blockDim.x) {
      if (hdr_sum[j] != 0) atomicAdd(header + j, hdr_sum[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) drain_compact_kernel(
    const int64_t* __restrict__ packed, const int64_t* __restrict__ nows, int K, int B,
    Layout g, Arena arena, int64_t* words, int64_t* limits, uint8_t* mism,
    unsigned char* workspace) {
  drain_body<false>(packed, nows, K, B, g, arena, words, limits, mism, StatsAcc{}, workspace);
}

__global__ void __launch_bounds__(kThreads) drain_compact_stats_kernel(
    const int64_t* __restrict__ packed, const int64_t* __restrict__ nows, int K, int B,
    Layout g, Arena arena, int64_t* words, int64_t* limits, uint8_t* mism, StatsAcc acc,
    unsigned char* workspace) {
  drain_body<true>(packed, nows, K, B, g, arena, words, limits, mism, acc, workspace);
}

// One window of decoded columns, CTA (p, s); the drain's run_window at K = 1.
__global__ void __launch_bounds__(kThreads) window_full_kernel(FullSrc src, int64_t now, int B,
                                                               Layout g, Arena arena, FullDst dst,
                                                               unsigned char* workspace) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t off = static_cast<size_t>(blockIdx.y) * B;
  const FullSrc mine = src.shard(off);
  FullLane* ring = reinterpret_cast<FullLane*>(smem);
  int chunk_no = 0;
  mine.issue(ring, 0, g.chunk);
  run_window<false>(mine, static_cast<const FullSrc*>(nullptr), dst.shard(off),
                    arena.shard(blockIdx.y), work<FullLane>(g, smem, workspace), ring, chunk_no,
                    g, B, now, static_cast<const StatsWin*>(nullptr));
}

Arena make_arena(void* limit, void* duration, void* remaining, void* tstamp,
                 void* expire, void* algo, long long capacity) {
  return Arena{static_cast<int64_t*>(limit),  static_cast<int64_t*>(duration),
               static_cast<int64_t*>(remaining), static_cast<int64_t*>(tstamp),
               static_cast<int64_t*>(expire), static_cast<int32_t*>(algo),
               static_cast<int64_t>(capacity)};
}

enum Kind { kDrain = 0, kDrainStats = 1, kFull = 2 };

Layout kind_layout(int kind, int B, int T) {
  return layout(B, kind == kFull ? sizeof(FullLane) : sizeof(CompactLane),
                kind == kDrainStats ? T : 0);
}

}  // namespace

extern "C" {

int guber_max_lanes() { return kMaxLanes; }

const char* guber_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan of one entry point (kind 0 drain_compact, 1
// drain_compact_stats with T tenant rows, 2 window_full) for windows of B
// lanes over S shards: out[0] P (the one asked for, or with P = 0 the
// chosen one: the SMs times the CTAs an SM holds at this shared memory,
// over S, at least 1, and fewer where the workspace would pass 64 MB),
// out[1] threads per CTA, out[2] dynamic shared memory per CTA, out[3] the
// workspace the launch needs in bytes (0: none).
// Returns a cudaError_t.
int guber_drain_plan(int kind, int B, int S, int T, int P, long long* out) {
  if (kind < kDrain || kind > kFull || S < 1 || B < 1 || B > kMaxLanes || P < 0 || T < 0) {
    return cudaErrorInvalidValue;
  }
  const Layout g = kind_layout(kind, B, T);
  if (g.smem > kSmemBudget) return cudaErrorInvalidValue;
  const void* fn = kind == kDrain ? reinterpret_cast<const void*>(drain_compact_kernel)
                   : kind == kDrainStats ? reinterpret_cast<const void*>(drain_compact_stats_kernel)
                                         : reinterpret_cast<const void*>(window_full_kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  if (P == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, g.smem);
    if (err != cudaSuccess) return err;
    P = sms * (per_sm > 0 ? per_sm : 1) / S;
    if (g.global) {
      const long long most = kWorkspaceCap / (static_cast<long long>(g.array_bytes) * S);
      if (P > most) P = static_cast<int>(most);
    }
    if (P < 1) P = 1;
  }
  if (P > 65535) return cudaErrorInvalidValue;
  out[0] = P;
  out[1] = kThreads;
  out[2] = static_cast<long long>(g.smem);
  out[3] = g.global ? static_cast<long long>(g.array_bytes) * P * S : 0;
  return cudaSuccess;
}

// K compact windows over S shards in one launch of P x S CTAs (P = 0:
// chosen, guber_drain_plan): packed i64[K, S, B, 2] (16 B aligned), nows
// i64[K], the six [S, C] arena planes updated in place; writes words
// i64[K, S, B], limits i64[K, S, B], mism u8[K, S] (zeroed here first);
// `workspace` holds the plan's workspace bytes.  Returns
// cudaGetLastError() after the launch.
int guber_drain_compact(const void* packed, const void* nows, int K, int S, int B,
                        void* limit, void* duration, void* remaining, void* tstamp,
                        void* expire, void* algo, long long capacity, void* words,
                        void* limits, void* mism, int P, void* workspace,
                        long long workspace_bytes, void* stream) {
  if (K < 1 || capacity < 1 || reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  long long plan[4];
  cudaError_t err = static_cast<cudaError_t>(guber_drain_plan(kDrain, B, S, 0, P, plan));
  if (err != cudaSuccess) return err;
  if (workspace_bytes < plan[3]) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(mism, 0, static_cast<size_t>(K) * S, st)) != cudaSuccess) return err;
  const Layout g = kind_layout(kDrain, B, 0);
  drain_compact_kernel<<<dim3(static_cast<unsigned>(plan[0]), S), kThreads, g.smem, st>>>(
      static_cast<const int64_t*>(packed), static_cast<const int64_t*>(nows), K, B, g,
      make_arena(limit, duration, remaining, tstamp, expire, algo, capacity),
      static_cast<int64_t*>(words), static_cast<int64_t*>(limits), static_cast<uint8_t*>(mism),
      static_cast<unsigned char*>(workspace));
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
                              void* header, long long N, int P, void* workspace,
                              long long workspace_bytes, void* stream) {
  if (K < 1 || capacity < 1 || T < 1 || N < 1 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  long long plan[4];
  cudaError_t err = static_cast<cudaError_t>(guber_drain_plan(kDrainStats, B, S, T, P, plan));
  if (err != cudaSuccess) return err;
  if (workspace_bytes < plan[3]) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(mism, 0, static_cast<size_t>(K) * S, st)) != cudaSuccess) return err;
  const Layout g = kind_layout(kDrainStats, B, T);
  const StatsAcc acc{static_cast<const int32_t*>(tenants), T, static_cast<int32_t*>(index),
                     static_cast<int64_t*>(entries),  static_cast<int32_t*>(count),
                     static_cast<int64_t*>(tenant),   static_cast<int64_t*>(header),
                     static_cast<int64_t>(N)};
  drain_compact_stats_kernel<<<dim3(static_cast<unsigned>(plan[0]), S), kThreads, g.smem, st>>>(
      static_cast<const int64_t*>(packed), static_cast<const int64_t*>(nows), K, B, g,
      make_arena(limit, duration, remaining, tstamp, expire, algo, capacity),
      static_cast<int64_t*>(words), static_cast<int64_t*>(limits), static_cast<uint8_t*>(mism),
      acc, static_cast<unsigned char*>(workspace));
  return cudaGetLastError();
}

// One window of decoded columns over S shards (the engine's full-format
// path), P x S CTAs: slot i32, hits/limit/duration i64, algo i32, is_init
// u8, all [S, B]; the six [S, C] arena planes updated in place; writes
// status i32, limit/remaining/reset i64 [S, B].  Returns
// cudaGetLastError() after the launch.
int guber_window_full(const void* slot, const void* hits, const void* limit_in,
                      const void* duration_in, const void* algo_in, const void* init,
                      long long now, int S, int B, void* limit, void* duration,
                      void* remaining, void* tstamp, void* expire, void* algo,
                      long long capacity, void* status_out, void* limit_out,
                      void* remaining_out, void* reset_out, int P, void* workspace,
                      long long workspace_bytes, void* stream) {
  if (capacity < 1) return cudaErrorInvalidValue;
  long long plan[4];
  cudaError_t err = static_cast<cudaError_t>(guber_drain_plan(kFull, B, S, 0, P, plan));
  if (err != cudaSuccess) return err;
  if (workspace_bytes < plan[3]) return cudaErrorInvalidValue;
  const Layout g = kind_layout(kFull, B, 0);
  const FullSrc src{static_cast<const int32_t*>(slot), static_cast<const int64_t*>(hits),
                    static_cast<const int64_t*>(limit_in),
                    static_cast<const int64_t*>(duration_in),
                    static_cast<const int32_t*>(algo_in), static_cast<const uint8_t*>(init)};
  const FullDst dst{static_cast<int32_t*>(status_out), static_cast<int64_t*>(limit_out),
                    static_cast<int64_t*>(remaining_out), static_cast<int64_t*>(reset_out)};
  window_full_kernel<<<dim3(static_cast<unsigned>(plan[0]), S), kThreads, g.smem,
                       static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<int64_t>(now), B, g,
      make_arena(limit, duration, remaining, tstamp, expire, algo, capacity), dst,
      static_cast<unsigned char*>(workspace));
  return cudaGetLastError();
}

}  // extern "C"
