// The phases of a GLOBAL window, as device functions over an item index
// (sm_90a).  global_window.cu runs them in one launch of one thread block
// cluster with a cluster barrier between them; global_apply.cu runs phases
// A0 and A (global_stage) and phase C alone (global_apply) for the per-op
// lowering, which reads the replica in torch ops between them.
//
// A window's control crosses as one packed int64 block (ops/global_kernel.py
// pack_control), n lanes, kg config-write / reset lanes and ku upsert lanes:
//
//   [0, 7n)        slot, hits, limit, duration, algo, is_init, gacc  (n each)
//   [7n, 7n + 5kg) uslot, ulimit, uduration, ualgo, rslot            (kg each)
//   [.., + 7ku)    pslot, plimit, pduration, premaining, ptstamp,
//                  pexpire, palgo                                    (ku each)
//
// An upsert lane is an owner's broadcast written into this replica (JAX
// engine.py:2617 _apply_control): the row's limit, duration, remaining,
// tstamp, expire and algo, and its config's limit, duration and algo.
// gacc is a lane's hits contributed to its slot's sum (0 for a lane whose
// hits reconcile elsewhere).  The sums live in an engine-owned scratch
// i64[G] that is all zero between windows: phase A adds into it, phase C
// exchanges each touched slot's sum for 0.
//
//   A0 (upserts; a window with ku > 0 only), items [0, ku): item p writes
//     upsert lane p into its row and the row's config, by the JAX
//     package's scatter rule (.at[idx].set(mode="drop")): an index in
//     [-G, 0) writes row G + idx, one outside [-G, G) drops.  The JAX
//     engine writes the upserts before the config lanes and resets
//     (_apply_control), so phase A0 ends before phase A starts (a barrier,
//     or the stream's order): on a row both name, the config lane's
//     fields and the reset's expire = 0 are the ones left.
//   A (stage), items [0, kg + n): item k < kg writes config lane k into
//     gcfg and resets row rslot[k] (expire = 0), by the same scatter
//     rule.  Item kg + i adds lane i's gacc into its slot's sum when the
//     slot is in [0, G) and gacc != 0 (kernel.global_accumulate drops
//     slots < 0 and >= G).
//   B (read), items [0, n): lane i answers from row min(slot, G - 1) as
//     phase A left it (config written, no hits applied), with fresh =
//     is_init | expire < now | algo != row algo and its hits only when
//     fresh (kernel.global_read); the answer goes to read[i] = (status,
//     limit, remaining, reset).  Pad lanes (slot < 0) answer 0.
//   C (apply), items [0, n): a contributing lane (slot in [0, G), gacc !=
//     0) exchanges its slot's sum for 0; the one lane that gets a nonzero
//     sum applies it to the row under the row's config, with fresh =
//     expire < now | config algo != row algo (kernel.global_apply).  A sum
//     that cancels to 0 leaves the row as it is, as in the oracle.  The
//     touched rows are the contributing lanes' slots, so the phase needs
//     no list and no count, and which lane of a slot wins does not matter.
//
// Nothing reads or writes rows that no lane or config lane names.
//
// Mesh mode (several processes, one arena) splits the window across an
// all-reduce of the sums (parallel/distributed.py): a rank runs phases A0,
// A and B on its own lanes (global_window.cu global_stage_read, or
// global_apply.cu global_stage and the torch reads), the ranks' scratches
// are summed in place, and then
//
//   C' (apply rows), items [0, G): row g exchanges its reduced sum for 0
//     and, when it is nonzero, applies it under the row's config as phase
//     C does (kernel.global_apply).  After the all-reduce a rank holds sums
//     for slots only another rank's lanes hit, so the touched rows are no
//     longer its own lanes' slots: this phase visits every row, as the
//     TPU kernel's apply does (global_apply_pallas reads `summed` whole).
//
// global_stage_read runs phases A0, A and B with no barrier between them.
// In their place one rule: a read lane whose row the window writes takes
// the written planes from the control block, never from the arena, and an
// upsert leaves to the config lane and the reset the fields they write on
// its row.  Every address then has one writer in the window and no reader
// of what it writes, so the items may run in any order, and what they
// leave is what the JAX order (upserts, then config lanes and resets)
// leaves.  A CTA learns what the window writes on its items' rows from a
// RowTable in shared memory (below), built from the control's pslot,
// rslot and uslot columns before its items run.

#pragma once

#include <cstdint>

#include "ladder.cuh"

namespace {

// number of int64 fields of a lane, a config lane and an upsert lane in
// the block
constexpr int64_t kLaneFields = 7;
constexpr int64_t kUpdFields = 5;

struct Control {
  const int64_t* base;
  int64_t n, kg;
  int64_t ku = 0;

  __device__ int64_t lane(int field, int64_t i) const { return base[field * n + i]; }
  __device__ int64_t upd(int field, int64_t k) const {
    return base[kLaneFields * n + field * kg + k];
  }
  __device__ int64_t ups(int field, int64_t p) const {
    return base[kLaneFields * n + kUpdFields * kg + field * ku + p];
  }
};

// the GLOBAL arena and its config, written in place (no __restrict__: phase
// B reads rows phase A wrote, so the loads must not take the read-only path)
struct GArena {
  int64_t* limit;
  int64_t* duration;
  int64_t* remaining;
  int64_t* tstamp;
  int64_t* expire;
  int32_t* algo;
  int64_t G;

  // the row's planes but expire, which phase A may reset: a lane takes them
  // before phase A ends (after phase A0, which writes them all) and expire
  // after it
  __device__ Reg load_but_expire(int64_t row) const {
    return Reg{limit[row], duration[row], remaining[row], tstamp[row], 0, algo[row]};
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

struct GConfig {
  int64_t* limit;
  int64_t* duration;
  int32_t* algo;
};

// the row a JAX scatter with mode="drop" writes for index idx, or -1
__device__ __forceinline__ int64_t scatter_row(int64_t idx, int64_t G) {
  const int64_t row = idx < 0 ? idx + G : idx;
  return (row >= 0 && row < G) ? row : -1;
}

// a lane's slot when it contributes to the sums, else -1
__device__ __forceinline__ int64_t contributing_slot(const Control& c, int64_t i, int64_t G) {
  const int64_t slot = c.lane(0, i);
  return (slot >= 0 && slot < G && c.lane(6, i) != 0) ? slot : -1;
}

__device__ __forceinline__ int64_t stage_items(const Control& c) { return c.kg + c.n; }

// upsert lane p's writes into row `row`: its state, expire unless a reset
// names the row, and the row's config unless a config lane names it
__device__ void upsert_write(const GArena& a, const GConfig& cfg, const Control& c, int64_t p,
                             int64_t row, bool expire_too, bool config_too) {
  const int64_t limit = c.ups(1, p);
  const int64_t duration = c.ups(2, p);
  const int32_t algo = static_cast<int32_t>(c.ups(6, p));
  a.limit[row] = limit;
  a.duration[row] = duration;
  a.remaining[row] = c.ups(3, p);
  a.tstamp[row] = c.ups(4, p);
  if (expire_too) a.expire[row] = c.ups(5, p);
  a.algo[row] = algo;
  if (config_too) {
    cfg.limit[row] = limit;
    cfg.duration[row] = duration;
    cfg.algo[row] = algo;
  }
}

// phase A0: upsert lane p into its row and the row's config (upsert slots
// are unique within a window, as the host stages them)
__device__ void upsert_item(const GArena& a, const GConfig& cfg, const Control& c, int64_t p) {
  const int64_t row = scatter_row(c.ups(0, p), a.G);
  if (row >= 0) upsert_write(a, cfg, c, p, row, true, true);
}

// phase A's config lane k, whose uslot and rslot are u_idx and r_idx: its
// config write and its reset
__device__ void config_write(const GArena& a, const GConfig& cfg, const Control& c, int64_t k,
                             int64_t u_idx, int64_t r_idx) {
  const int64_t u = scatter_row(u_idx, a.G);
  if (u >= 0) {
    cfg.limit[u] = c.upd(1, k);
    cfg.duration[u] = c.upd(2, k);
    cfg.algo[u] = static_cast<int32_t>(c.upd(3, k));
  }
  const int64_t r = scatter_row(r_idx, a.G);
  if (r >= 0) a.expire[r] = 0;
}

__device__ void config_item(const GArena& a, const GConfig& cfg, const Control& c, int64_t k) {
  config_write(a, cfg, c, k, c.upd(0, k), c.upd(4, k));
}

// phase A's lane with slot `slot` and contributed hits `gacc`: the hits
// added into its slot's sum when the slot is in [0, G) and gacc != 0
__device__ void add_hits(int64_t* sums, int64_t G, int64_t slot, int64_t gacc) {
  if (slot >= 0 && slot < G && gacc != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(sums + slot),
              static_cast<unsigned long long>(gacc));
  }
}

__device__ void lane_hits(const Control& c, int64_t G, int64_t* sums, int64_t i) {
  add_hits(sums, G, c.lane(0, i), c.lane(6, i));
}

__device__ void stage_item(const GArena& a, const GConfig& cfg, const Control& c,
                           int64_t* sums, int64_t item) {
  if (item < c.kg) {
    config_item(a, cfg, c, item);
  } else {
    lane_hits(c, a.G, sums, item - c.kg);
  }
}

// A lane's read or apply, split so that a thread can issue its loads
// before phase A ends: the lane's control and the row planes phase A
// never writes (all but expire) are taken first (*_prefetch); expire, the
// config and the sum only after the barrier.
struct ReadLane {
  int64_t i;     // the lane
  int64_t row;   // min(slot, G - 1), or -1 on a pad lane
  Reg r;         // the row, expire excepted until read_finish
  Req q;
};

struct ApplyLane {
  int64_t row;   // the lane's slot when it contributes, else -1
  bool live;     // apply_prepare took a nonzero sum: r is the new row
  Reg r;
};

// a lane's request and row (min(slot, G - 1), or -1 on a pad lane)
__device__ ReadLane read_request(const Control& c, int64_t G, int64_t i) {
  ReadLane l;
  l.i = i;
  const int64_t slot = c.lane(0, i);
  l.row = slot < 0 ? -1 : imin(slot, G - 1);
  if (l.row < 0) return l;
  l.q.slot = static_cast<int32_t>(slot);
  l.q.valid = true;
  l.q.agg = false;
  l.q.init = c.lane(5, i) != 0;
  l.q.hits = c.lane(1, i);
  l.q.limit = c.lane(2, i);
  l.q.duration = c.lane(3, i);
  l.q.algo = static_cast<int32_t>(c.lane(4, i));
  return l;
}

// phase B's answer of a lane whose row l.r holds, expire included
__device__ void read_answer(int64_t now, int64_t* read, ReadLane& l) {
  int64_t* o = read + 4 * l.i;
  if (l.row < 0) {
    o[0] = o[1] = o[2] = o[3] = 0;
    return;
  }
  const bool fresh = l.q.init || l.r.expire < now || l.q.algo != l.r.algo;
  if (!fresh) l.q.hits = 0;
  const Out res = transition(l.r, l.q, now, fresh);
  o[0] = res.status;
  o[1] = res.limit;
  o[2] = res.remaining;
  o[3] = res.reset;
}

__device__ ReadLane read_prefetch(const GArena& a, const Control& c, int64_t i) {
  ReadLane l = read_request(c, a.G, i);
  if (l.row >= 0) l.r = a.load_but_expire(l.row);
  return l;
}

// phase B for one lane: its answer from the row as phase A left it
__device__ void read_finish(const GArena& a, int64_t now, int64_t* read, ReadLane& l) {
  if (l.row >= 0) l.r.expire = a.expire[l.row];
  read_answer(now, read, l);
}

__device__ void read_lane(const GArena& a, const Control& c, int64_t now, int64_t* read,
                          int64_t i) {
  ReadLane l = read_prefetch(a, c, i);
  read_finish(a, now, read, l);
}

__device__ ApplyLane apply_prefetch(const GArena& a, const Control& c, int64_t i) {
  ApplyLane l;
  l.row = contributing_slot(c, i, a.G);
  l.live = false;
  if (l.row >= 0) l.r = a.load_but_expire(l.row);
  return l;
}

// phase C for one lane, up to the store: exchange the slot's sum for 0;
// the lane that gets a nonzero sum computes the row's transition
__device__ void apply_prepare(const GArena& a, const GConfig& cfg, int64_t* sums, int64_t now,
                              ApplyLane& l) {
  if (l.row < 0) return;
  const int64_t h = static_cast<int64_t>(
      atomicExch(reinterpret_cast<unsigned long long*>(sums + l.row), 0ull));
  if (h == 0) return;
  l.r.expire = a.expire[l.row];
  Req q;
  q.slot = static_cast<int32_t>(l.row);
  q.valid = true;
  q.agg = false;
  q.init = false;
  q.hits = h;
  q.limit = cfg.limit[l.row];
  q.duration = cfg.duration[l.row];
  q.algo = cfg.algo[l.row];
  transition(l.r, q, now, l.r.expire < now || q.algo != l.r.algo);
  l.live = true;
}

__device__ void apply_store(const GArena& a, const ApplyLane& l) {
  if (l.live) a.store(l.row, l.r);
}

__device__ void apply_lane(const GArena& a, const GConfig& cfg, const Control& c,
                           int64_t* sums, int64_t now, int64_t i) {
  ApplyLane l = apply_prefetch(a, c, i);
  apply_prepare(a, cfg, sums, now, l);
  apply_store(a, l);
}

// phase C' for one row whose reduced sum h is nonzero: the sum zeroed and
// applied under the row's config
__device__ void apply_sum(const GArena& a, const GConfig& cfg, int64_t* sums, int64_t now,
                          int64_t row, int64_t h) {
  sums[row] = 0;
  Reg r = a.load_but_expire(row);
  r.expire = a.expire[row];
  Req q;
  q.slot = static_cast<int32_t>(row);
  q.valid = true;
  q.agg = false;
  q.init = false;
  q.hits = h;
  q.limit = cfg.limit[row];
  q.duration = cfg.duration[row];
  q.algo = cfg.algo[row];
  transition(r, q, now, r.expire < now || q.algo != r.algo);
  a.store(row, r);
}

// phase C' for one row: its reduced sum exchanged for 0, and applied when
// it is nonzero
__device__ void apply_row(const GArena& a, const GConfig& cfg, int64_t* sums, int64_t now,
                          int64_t row) {
  const int64_t h = sums[row];
  if (h != 0) apply_sum(a, cfg, sums, now, row, h);
}

// ---------------------------------------------------------------- the row table
//
// A CTA of global_stage_read's barrier-free launch keeps, in shared memory,
// the rows its own items name (its read lanes' rows and its upsert lanes'
// rows: at most 2 kThreads), each with what the window writes there: the
// upsert lane that writes the row (or -1), whether a reset names it, and
// whether a config lane names it.  Open addressing with linear probing at
// a load of at most 1/2; the key is the row after the scatter rule (an
// upsert's or a reset's index wrapped, a read lane's slot clamped to
// G - 1), so an index that drops never reaches the table.  Keyed by the
// CTA's own rows, not by the window's writes, its size is bounded by the
// CTA's items whatever kg and ku are.  Built in three steps, each over the
// CTA's threads (tid of nt): table_clear, table_insert of each own row,
// table_mark over the control's columns; a barrier between steps.
template <int kThreads>
struct RowTable {
  static constexpr int kCap = 4 * kThreads;
  static constexpr unsigned long long kEmpty = ~0ull;
  unsigned long long key[kCap];
  int32_t ups[kCap];
  uint8_t reset[kCap];
  uint8_t config[kCap];

  __device__ static int home(int64_t row) {
    return static_cast<int>((static_cast<uint64_t>(row) * 0x9E3779B97F4A7C15ull) >> 40) &
           (kCap - 1);
  }
  // the entry of `row`, or -1 when the CTA's items do not name it
  __device__ int find(int64_t row) const {
    for (int h = home(row);; h = (h + 1) & (kCap - 1)) {
      if (key[h] == static_cast<unsigned long long>(row)) return h;
      if (key[h] == kEmpty) return -1;
    }
  }
};

template <int kThreads>
__device__ void table_clear(RowTable<kThreads>& t, int tid, int nt) {
  for (int k = tid; k < RowTable<kThreads>::kCap; k += nt) {
    t.key[k] = RowTable<kThreads>::kEmpty;
    t.ups[k] = -1;
    t.reset[k] = 0;
    t.config[k] = 0;
  }
}

template <int kThreads>
__device__ void table_insert(RowTable<kThreads>& t, int64_t row) {
  using T = RowTable<kThreads>;
  const auto want = static_cast<unsigned long long>(row);
  for (int h = T::home(row);; h = (h + 1) & (T::kCap - 1)) {
    const unsigned long long prev = atomicCAS(&t.key[h], T::kEmpty, want);
    if (prev == T::kEmpty || prev == want) return;
  }
}

// whether the window writes anything a read lane or an upsert must step
// around, from this thread's share of the reset and upsert columns: a
// config lane's write alone changes nothing a read takes (the reads take
// no config), and matters only to an upsert on its row
__device__ bool window_writes(const Control& c, int64_t G, int tid, int nt) {
  // no early exit: the loads of a thread's share go out together
  bool any = false;
#pragma unroll 4
  for (int64_t k = tid; k < c.kg; k += nt) any |= scatter_row(c.upd(4, k), G) >= 0;
#pragma unroll 4
  for (int64_t p = tid; p < c.ku; p += nt) any |= scatter_row(c.ups(0, p), G) >= 0;
  return any;
}

// the rows of the CTA's item i: read lane i's, upsert lane i's
template <int kThreads>
__device__ void table_insert_item(RowTable<kThreads>& t, const Control& c, int64_t G,
                                  int64_t i) {
  if (i < c.n) {
    const int64_t slot = c.lane(0, i);
    if (slot >= 0) table_insert(t, imin(slot, G - 1));
  }
  if (i < c.ku) {
    const int64_t row = scatter_row(c.ups(0, i), G);
    if (row >= 0) table_insert(t, row);
  }
}

// what the window writes on the table's rows, from this thread's share of
// the control's columns (config lanes only where upserts may meet them)
template <int kThreads>
__device__ void table_mark(RowTable<kThreads>& t, const Control& c, int64_t G, int tid,
                           int nt) {
  for (int64_t k = tid; k < c.kg; k += nt) {
    int e = -1;
    const int64_t r = scatter_row(c.upd(4, k), G);
    if (r >= 0 && (e = t.find(r)) >= 0) t.reset[e] = 1;
    const int64_t u = c.ku > 0 ? scatter_row(c.upd(0, k), G) : -1;
    if (u >= 0 && (e = t.find(u)) >= 0) t.config[e] = 1;
  }
  for (int64_t p = tid; p < c.ku; p += nt) {
    int e = -1;
    const int64_t r = scatter_row(c.ups(0, p), G);
    if (r >= 0 && (e = t.find(r)) >= 0) t.ups[e] = static_cast<int32_t>(p);
  }
}

// phase B's row for a read lane, as phases A0 and A leave it, with no
// barrier after them: an upserted row's planes from its upsert lane, a
// reset row's expire 0, every other plane from the arena (the planes
// nobody writes in this window).  A null table: the window writes no row.
template <int kThreads>
__device__ void read_row(const GArena& a, const Control& c, const RowTable<kThreads>* t,
                         ReadLane& l) {
  if (l.row < 0) return;
  const int e = t == nullptr ? -1 : t->find(l.row);
  const int32_t p = e < 0 ? -1 : t->ups[e];
  const bool reset = e >= 0 && t->reset[e];
  if (p >= 0) {
    l.r = Reg{c.ups(1, p), c.ups(2, p), c.ups(3, p), c.ups(4, p), c.ups(5, p),
              static_cast<int32_t>(c.ups(6, p))};
  } else {
    l.r = a.load_but_expire(l.row);
    if (!reset) l.r.expire = a.expire[l.row];
  }
  if (reset) l.r.expire = 0;
}

// phase A0 with no barrier after it: upsert lane p leaves expire to a
// reset on its row and the config to a config lane on its row
template <int kThreads>
__device__ void upsert_item_table(const GArena& a, const GConfig& cfg, const Control& c,
                                  const RowTable<kThreads>& t, int64_t p) {
  const int64_t row = scatter_row(c.ups(0, p), a.G);
  if (row < 0) return;
  const int e = t.find(row);
  upsert_write(a, cfg, c, p, row, !t.reset[e], !t.config[e]);
}

// One CTA of global_stage_read: thread tid of the CTA owns read lane i,
// upsert lane i and config lane i (i its global index; further config
// lanes by grid stride).  Every load that needs no other goes out first:
// the lane's control, its config lane's indices and the CTA's share of
// the reset and upsert indices; then the lane's hits are added into the
// sums (the atomic's latency hides behind the rest), the CTA votes, and
// only a window that writes a row builds the table (a uniform test, after
// the one barrier of the vote, which also ends the table's clear); a
// window with no config, reset or upsert lane at all skips both.
template <int kThreads>
__device__ void stage_read_cta(const GArena& a, const GConfig& cfg, const Control& c,
                               int64_t* sums, int64_t now, int64_t* read,
                               RowTable<kThreads>& t) {
  const int tid = static_cast<int>(threadIdx.x);
  const int nt = static_cast<int>(blockDim.x);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * nt + tid;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * nt;
  ReadLane l;
  l.row = -1;
  int64_t slot = -1, gacc = 0;
  if (i < c.n) {
    l = read_request(c, a.G, i);
    slot = c.lane(0, i);
    gacc = c.lane(6, i);
  }
  const bool own_config = i < c.kg;
  const int64_t u_idx = own_config ? c.upd(0, i) : 0;
  const int64_t r_idx = own_config ? c.upd(4, i) : 0;
  bool writes = false;
  if (c.kg > 0 || c.ku > 0) {
    table_clear(t, tid, nt);
    writes = window_writes(c, a.G, tid, nt);
  }
  if (i < c.n) add_hits(sums, a.G, slot, gacc);
  if (c.kg > 0 || c.ku > 0) writes = __syncthreads_or(writes) != 0;
  if (writes) {
    table_insert_item(t, c, a.G, i);
    __syncthreads();
    table_mark(t, c, a.G, tid, nt);
    __syncthreads();
  }
  if (i < c.n) read_row(a, c, writes ? &t : nullptr, l);
  if (own_config) config_write(a, cfg, c, i, u_idx, r_idx);
  for (int64_t k = i + stride; k < c.kg; k += stride) config_item(a, cfg, c, k);
  if (writes && i < c.ku) upsert_item_table(a, cfg, c, t, i);
  if (i < c.n) read_answer(now, read, l);
}

}  // namespace
