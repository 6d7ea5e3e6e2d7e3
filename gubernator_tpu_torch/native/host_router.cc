// Native host router: batch key -> (shard, slot) resolution for the window
// packer.
//
// The reference's equivalent work is a Go map lookup + LRU list touch under a
// mutex per request (cache/lru.go:104-121) plus a crc32 ring lookup
// (hash.go:80-96).  In this framework that host-side bookkeeping is the hot
// loop feeding the device (the kernel itself left Python long ago), so it is
// implemented natively: one C call resolves a whole window.
//
// Design:
//   * per-shard open-addressing hash table (linear probing, backward-shift
//     deletion), keyed by a 64-bit FNV-1a fingerprint of the key string.
//     Key bytes are NOT stored — at 100M keys the expected fingerprint
//     collision count is ~0.03 percent windows of one colliding pair
//     (n^2 / 2^65), and a collision merely merges two keys' counters.
//   * shard = crc32(key) % num_shards, matching the Python router
//     (core/engine.py shard_of) so native and Python paths route alike.
//   * per-shard LRU via an intrusive doubly-linked list over entry indices.
//     A full shard first reclaims an EXPIRED slot (lazy expiry min-heap)
//     and only then evicts the LRU tail like the reference
//     (cache/lru.go:92-94,131-136) — so churny workloads never evict live
//     keys while dead ones occupy slots.
//   * expiry estimates refresh on every touch; hit/miss counters match the
//     reference's semantics (expired-entry touch counts as a miss,
//     lru.go:110-119).
//
// Built as a plain shared library, loaded via ctypes (native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>

namespace {

// ---- the entry points' own clock ------------------------------------------

int64_t mono_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000ll + ts.tv_nsec;
}

// Writes the nanoseconds its scope took on CLOCK_MONOTONIC into *out as it
// ends (no write when out is null): the C work of a call, without the
// binding around it or the wait to take the interpreter lock back.
struct ScopeClock {
  int64_t* out;
  int64_t t0;
  explicit ScopeClock(int64_t* o) : out(o), t0(o ? mono_ns() : 0) {}
  ~ScopeClock() {
    if (out) *out = mono_ns() - t0;
  }
};

// ---- hashing --------------------------------------------------------------

uint32_t crc32_table[256];
bool crc32_init_done = false;

void crc32_init() {
  if (crc32_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc32_table[i] = c;
  }
  crc32_init_done = true;
}

// IEEE crc32, matching zlib.crc32 / Go hash/crc32.ChecksumIEEE
uint32_t crc32(const uint8_t* data, int64_t len) {
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < len; i++)
    c = crc32_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint64_t fnv1a64(const uint8_t* data, int64_t len) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < len; i++) {
    h ^= data[i];
    h *= 1099511628211ull;
  }
  // never return 0: 0 marks an empty table cell
  return h ? h : 1ull;
}

// ---- per-shard table ------------------------------------------------------

constexpr int32_t NIL = -1;

struct HeapNode {
  int64_t expire;
  int32_t e;
};

struct Shard {
  // open-addressing table: cell -> entry index (or NIL)
  int32_t* cells;
  uint32_t mask;  // table size - 1 (power of two)

  // entry storage, one per device slot
  uint64_t* fp;        // fingerprint per entry (entry i owns device slot i)
  int64_t* expire;     // host-side expiry estimate
  uint32_t* cell_of;   // entry -> its cell (for O(1) delete)
  int32_t* prev;       // LRU links (head = MRU)
  int32_t* next;
  int32_t lru_head, lru_tail;
  int32_t* free_list;
  int32_t free_top;
  int32_t capacity;
  int64_t hits, misses, size;
  // init-pending tracking: a freshly (re)allocated entry keeps reporting
  // is_init=1 until a device dispatch actually commits its window
  // (router_commit).  Without this, a pack that aborts before dispatch
  // would consume the flag, and a retry could inherit a recycled slot's
  // previous tenant's live device state.
  uint8_t* pending;
  uint32_t* seq;  // pack sequence that last touched the entry
  // lazy expiry min-heap: lets a full shard reclaim an EXPIRED slot before
  // evicting a live LRU victim.  Nodes go stale when an entry is re-touched
  // (its expiry moved) or evicted; staleness is detected on pop against the
  // entry's live expire + residency.  To BOUND the heap at 100M-key scale
  // without a stop-the-world rebuild (an O(capacity) pause lands mid-window
  // at that size), overflow swaps the heap aside and drains it back a few
  // nodes per touch (heap_old), and refresh pushes are suppressed when the
  // expiry moved by less than duration/4 (reclaim correctness survives
  // because a popped hint reclaims on the entry's CURRENT expiry, not the
  // hint's).
  HeapNode* heap;
  int64_t heap_len, heap_cap;
  HeapNode* heap_old;  // draining after an overflow swap (nullptr if none)
  int64_t heap_old_len;
  // exact-key guard (opt-in, router_set_exact): stores each entry's full
  // key so a 64-bit fingerprint collision probes onward instead of silently
  // merging two keys' counters.  nullptr when disabled.
  uint8_t** keys;
  int32_t* klen;
};

// One tracked key's segment stats for the replay-bound guard.  A cell is
// live iff seq == Router::drain_seq (stamp-validated: no per-drain clear).
struct RepCell {
  uint64_t fp;       // 0 = empty slot in the map
  int64_t h, l, d;   // the segment's first-lane request tuple
  uint32_t seq;
  int32_t shard;
  int32_t algo;
  int32_t lanes;     // lanes staged for this key in its current window
  int32_t nonuniform;  // 1 once any lane broke the uniform pattern
  // duplicate-run aggregation (stage-time, pass 2): while a key's run
  // stays uniform hits=1/limit>0, later items fold into ONE staged lane
  // (AGG_SLOT_BIT, kernel.py) instead of new lanes.  The fold compares
  // against the ARMED LANE's own tuple (agg_l/agg_d/agg_algo) — the
  // pass-1 cfg above is tracking state that the replay-cap reset
  // rewrites and MUST NOT gate folding (fuzz-caught: a stale-reset cfg
  // matched a later item into a different-config lane).  Every staged
  // lane of a key re-arms or invalidates the target, so the armed lane
  // is always the key's LATEST lane and folding never reorders.
  int64_t agg_off;   // w0 index of the aggregation lane, -1 none
  int32_t agg_k;     // window the lane lives in (stale => new lane)
  int32_t agg_n;     // items folded so far (next item's 0-based pos)
  int32_t slot;      // device slot of the lane (eviction check)
  int64_t agg_l, agg_d;  // the armed lane's limit/duration (hits == 1)
  int32_t agg_algo;
};

struct Router {
  Shard* shards;
  int32_t num_shards;         // local shards staged by this process
  int32_t num_global_shards;  // hashing modulus (== num_shards single-proc)
  int32_t shard_offset;       // first local shard's global index
  uint32_t pack_seq;          // increments per pack/parse call (or per drain)
  int64_t* commit_list;       // (shard << 32) | entry, pending inits staged
  int64_t commit_len, commit_cap;  //   by the LAST pack/parse call or drain
  int32_t exact;              // exact-key guard enabled
  uint8_t* scratch;           // assembled hash_key scratch (exact mode)
  int64_t scratch_cap;
  // cluster mode: the consistent-hash ring (reference hash.go:28-96) so
  // the RPC parser can classify items local-vs-forward per key.  Empty
  // (ring_len == 0) means standalone: every key is local.
  uint32_t* ring_points;      // sorted hash points
  int32_t* ring_peer;         // peer index per point
  int32_t ring_len;
  int32_t ring_self;          // this node's peer index
  // replay-bound tracker (see rep_track): per-drain open-addressing map
  // (shard, fp) -> this key's current-window segment stats, used to split
  // windows so the device kernel's per-window replay loop stays bounded.
  RepCell* rep;
  int64_t rep_cap;            // power of two, grown on load
  int64_t rep_live;           // live cells this drain (load control)
  uint32_t drain_seq;         // validity stamp (bumped per drain)
  int32_t replay_cap;         // max lanes of a NON-uniform segment per
                              // window; 0 disables the guard
};

uint32_t next_pow2(uint32_t v) {
  v--;
  v |= v >> 1; v |= v >> 2; v |= v >> 4; v |= v >> 8; v |= v >> 16;
  return v + 1;
}

void shard_init(Shard* s, int32_t capacity) {
  uint32_t tsize = next_pow2((uint32_t)capacity * 2);
  s->cells = (int32_t*)malloc(sizeof(int32_t) * tsize);
  for (uint32_t i = 0; i < tsize; i++) s->cells[i] = NIL;
  s->mask = tsize - 1;
  s->fp = (uint64_t*)calloc(capacity, sizeof(uint64_t));
  s->expire = (int64_t*)calloc(capacity, sizeof(int64_t));
  s->cell_of = (uint32_t*)calloc(capacity, sizeof(uint32_t));
  s->prev = (int32_t*)malloc(sizeof(int32_t) * capacity);
  s->next = (int32_t*)malloc(sizeof(int32_t) * capacity);
  s->free_list = (int32_t*)malloc(sizeof(int32_t) * capacity);
  for (int32_t i = 0; i < capacity; i++) s->free_list[i] = capacity - 1 - i;
  s->free_top = capacity;
  s->lru_head = s->lru_tail = NIL;
  s->capacity = capacity;
  s->hits = s->misses = s->size = 0;
  s->pending = (uint8_t*)calloc(capacity, sizeof(uint8_t));
  s->seq = (uint32_t*)calloc(capacity, sizeof(uint32_t));
  s->heap = nullptr;
  s->heap_len = s->heap_cap = 0;
  s->heap_old = nullptr;
  s->heap_old_len = 0;
  s->keys = nullptr;
  s->klen = nullptr;
}

// entry e is resident iff some table cell still points at it (cell_of is
// only maintained while resident, and removal clears the pointing cell)
inline bool is_resident(Shard* s, int32_t e) {
  return s->cells[s->cell_of[e]] == e;
}

// pop the min node off an arbitrary heap array (sift-down the last node)
inline HeapNode heap_pop_min(HeapNode* heap, int64_t* len) {
  HeapNode top = heap[0];
  heap[0] = heap[--*len];
  if (*len) {
    int64_t i = 0;
    HeapNode v = heap[0];
    for (;;) {
      int64_t l = 2 * i + 1, r = l + 1, m = i;
      int64_t best = v.expire;
      if (l < *len && heap[l].expire < best) {
        m = l;
        best = heap[l].expire;
      }
      if (r < *len && heap[r].expire < best) m = r;
      if (m == i) break;
      heap[i] = heap[m];
      i = m;
    }
    heap[i] = v;
  }
  return top;
}

void heap_insert(Shard* s, int64_t expire, int32_t e) {
  if (s->heap_len == s->heap_cap) {
    s->heap_cap = s->heap_cap ? s->heap_cap * 2 : 1024;
    s->heap = (HeapNode*)realloc(s->heap, sizeof(HeapNode) * s->heap_cap);
  }
  int64_t i = s->heap_len++;
  while (i > 0) {
    int64_t p = (i - 1) / 2;
    if (s->heap[p].expire <= expire) break;
    s->heap[i] = s->heap[p];
    i = p;
  }
  s->heap[i].expire = expire;
  s->heap[i].e = e;
}

// is node n still worth keeping as a reclaim hint?
inline bool hint_live(Shard* s, const HeapNode& n) {
  return s->cells[s->cell_of[n.e]] == n.e && s->expire[n.e] >= n.expire;
}

void heap_push(Shard* s, int64_t expire, int32_t e) {
  // Overflow: swap the (mostly stale) heap aside and drain it back
  // incrementally — a stop-the-world rebuild is an O(capacity) pause,
  // which at the 100M-key target lands mid-serving-window.
  if (s->heap_old == nullptr && s->heap_len > 4 * (int64_t)s->capacity) {
    s->heap_old = s->heap;
    s->heap_old_len = s->heap_len;
    s->heap = nullptr;
    s->heap_len = s->heap_cap = 0;
  }
  if (s->heap_old != nullptr) {
    // amortized drain: far faster than the ~1 push/touch growth rate
    for (int drained = 0; drained < 8 && s->heap_old_len > 0; drained++) {
      HeapNode n = heap_pop_min(s->heap_old, &s->heap_old_len);
      if (hint_live(s, n)) heap_insert(s, n.expire, n.e);
    }
    if (s->heap_old_len == 0) {
      free(s->heap_old);
      s->heap_old = nullptr;
    }
  }
  heap_insert(s, expire, e);
}


void push_commit(Router* r, int32_t shard, int32_t e) {
  if (r->commit_len == r->commit_cap) {
    r->commit_cap = r->commit_cap ? r->commit_cap * 2 : 256;
    r->commit_list = (int64_t*)realloc(r->commit_list,
                                       sizeof(int64_t) * r->commit_cap);
  }
  r->commit_list[r->commit_len++] = ((int64_t)shard << 32) | (uint32_t)e;
}

void lru_unlink(Shard* s, int32_t e) {
  if (s->prev[e] != NIL) s->next[s->prev[e]] = s->next[e];
  else s->lru_head = s->next[e];
  if (s->next[e] != NIL) s->prev[s->next[e]] = s->prev[e];
  else s->lru_tail = s->prev[e];
}

void lru_push_front(Shard* s, int32_t e) {
  s->prev[e] = NIL;
  s->next[e] = s->lru_head;
  if (s->lru_head != NIL) s->prev[s->lru_head] = e;
  s->lru_head = e;
  if (s->lru_tail == NIL) s->lru_tail = e;
}

// backward-shift deletion keeps probe chains tombstone-free
void table_delete_cell(Shard* s, uint32_t cell) {
  uint32_t hole = cell;
  uint32_t i = cell;
  for (;;) {
    i = (i + 1) & s->mask;
    int32_t e = s->cells[i];
    if (e == NIL) break;
    uint32_t home = (uint32_t)(s->fp[e] & s->mask);
    // can entry at i move into the hole? yes iff hole is within its probe path
    uint32_t dist_home_to_hole = (hole - home) & s->mask;
    uint32_t dist_home_to_i = (i - home) & s->mask;
    if (dist_home_to_hole <= dist_home_to_i) {
      s->cells[hole] = e;
      s->cell_of[e] = hole;
      hole = i;
    }
  }
  s->cells[hole] = NIL;
}

// Pop expired hints until one names a live-and-truly-expired entry;
// returns its entry index (removed from table+LRU, ready for reuse) or
// NIL.  Reclaim checks the entry's CURRENT expiry (not the hint's), so
// hints left behind by the push-suppression rule still reclaim correctly;
// a hint whose entry refreshed past `now` is RE-PUSHED at the entry's
// current expiry (conserves hint coverage for hot-then-idle keys).  Work
// per attempt is capped so an allocation never stalls on a stale-hint
// burst (it falls back to LRU eviction instead).  An entry the current
// pack call touched (seq == cur_seq) is never reclaimed: a negative
// duration puts its expiry behind `now` while its device row stays live
// for this drain, so its hint is re-pushed for a later drain.
int32_t try_reclaim_expired(Shard* s, int64_t now, uint32_t cur_seq) {
  HeapNode repush[32];
  int nr = 0;
  int32_t out = NIL;
  for (int iter = 0; iter < 32; iter++) {
    HeapNode* heap;
    int64_t* len;
    if (s->heap_len > 0 && s->heap[0].expire < now) {
      heap = s->heap;
      len = &s->heap_len;
    } else if (s->heap_old != nullptr && s->heap_old_len > 0 &&
               s->heap_old[0].expire < now) {
      heap = s->heap_old;
      len = &s->heap_old_len;
    } else {
      break;
    }
    HeapNode n = heap_pop_min(heap, len);
    if (!is_resident(s, n.e)) continue;  // dead hint
    if (s->expire[n.e] < now && s->seq[n.e] != cur_seq) {
      lru_unlink(s, n.e);
      table_delete_cell(s, s->cell_of[n.e]);
      out = n.e;
      break;
    }
    if (nr < 32) {  // refreshed or touched entry: restore an exact hint
      repush[nr].expire = s->expire[n.e];
      repush[nr++].e = n.e;
    }
  }
  for (int i = 0; i < nr; i++) heap_insert(s, repush[i].expire, repush[i].e);
  if (s->heap_old != nullptr && s->heap_old_len == 0) {
    free(s->heap_old);
    s->heap_old = nullptr;
  }
  return out;
}

// returns slot; *is_init set when the device must (re)initialize it.
// cur_seq: the current pack call's sequence — a pending entry reports
// is_init only once per pack call (later duplicates in the same window see
// the in-window live register, kernel-side), but keeps reporting it across
// pack calls until router_commit confirms a dispatch wrote the slot.
// key/key_len: the full hash-key bytes, compared (and stored) only when the
// exact-key guard is on — a fingerprint collision then probes onward to its
// own cell instead of merging counters.
int32_t shard_lookup(Shard* s, uint64_t fp, int64_t now, int64_t duration,
                     uint32_t cur_seq, uint8_t* is_init,
                     const uint8_t* key = nullptr, int64_t key_len = 0) {
  uint32_t cell = (uint32_t)(fp & s->mask);
  for (;;) {
    int32_t e = s->cells[cell];
    if (e == NIL) break;
    if (s->fp[e] == fp &&
        (s->keys == nullptr ||
         (s->klen[e] == (int32_t)key_len &&
          memcmp(s->keys[e], key, key_len) == 0))) {
      if (s->expire[e] < now) s->misses++;  // expired touch counts as a miss
      else s->hits++;
      int64_t ne = now + duration;
      if (s->expire[e] != ne) {
        // hint-churn suppression: re-push only when the expiry moved by
        // more than duration/4 (or backwards).  Pop-time reclaim checks
        // the entry's CURRENT expiry and re-pushes refreshed hints, so
        // sparser hints stay correct — this is what keeps the heap bounded
        // at the 100M-key scale instead of growing one node per touch.
        bool push = ne - s->expire[e] > duration / 4 || ne < s->expire[e];
        s->expire[e] = ne;
        if (push) heap_push(s, ne, e);
      }
      lru_unlink(s, e);
      lru_push_front(s, e);
      if (s->pending[e] && s->seq[e] != cur_seq) {
        *is_init = 1;  // allocated by an earlier pack that never dispatched
      } else {
        *is_init = 0;
      }
      s->seq[e] = cur_seq;  // touched by this pack call (reclaim skips it)
      return e;
    }
    cell = (cell + 1) & s->mask;
  }
  // miss: allocate (free slot, else reclaim an expired slot, else evict
  // the LRU tail)
  s->misses++;
  int32_t e;
  if (s->free_top > 0) {
    e = s->free_list[--s->free_top];
    s->size++;
  } else {
    e = try_reclaim_expired(s, now, cur_seq);
    if (e == NIL) {
      // the LRU tail is untouched by this pack call unless every resident
      // entry was touched (each touch moves its entry to the front)
      e = s->lru_tail;
      lru_unlink(s, e);
      table_delete_cell(s, s->cell_of[e]);
    }
    // the probe chain may have shifted into our target cell; re-probe
    cell = (uint32_t)(fp & s->mask);
    while (s->cells[cell] != NIL) cell = (cell + 1) & s->mask;
  }
  s->cells[cell] = e;
  s->cell_of[e] = cell;
  s->fp[e] = fp;
  s->expire[e] = now + duration;
  heap_push(s, now + duration, e);
  lru_push_front(s, e);
  s->pending[e] = 1;
  s->seq[e] = cur_seq;
  if (s->keys != nullptr) {
    free(s->keys[e]);
    s->keys[e] = (uint8_t*)malloc(key_len ? key_len : 1);
    memcpy(s->keys[e], key, key_len);
    s->klen[e] = (int32_t)key_len;
  }
  *is_init = 1;
  return e;
}

}  // namespace

extern "C" {

// Mesh mode (parallel/distributed.py): keys hash over num_global_shards but
// this process only stages lanes for [shard_offset, shard_offset+num_shards).
// Single-process: global == local, offset 0 (router_new).
Router* router_new_mesh(int32_t num_global_shards, int32_t shard_offset,
                        int32_t num_local_shards,
                        int32_t capacity_per_shard) {
  crc32_init();
  Router* r = (Router*)malloc(sizeof(Router));
  r->num_shards = num_local_shards;
  r->num_global_shards = num_global_shards;
  r->shard_offset = shard_offset;
  r->shards = (Shard*)malloc(sizeof(Shard) * num_local_shards);
  for (int32_t i = 0; i < num_local_shards; i++)
    shard_init(&r->shards[i], capacity_per_shard);
  r->pack_seq = 0;
  r->commit_list = nullptr;
  r->commit_len = r->commit_cap = 0;
  r->exact = 0;
  r->scratch = nullptr;
  r->scratch_cap = 0;
  r->ring_points = nullptr;
  r->ring_peer = nullptr;
  r->ring_len = 0;
  r->ring_self = -1;
  r->rep = nullptr;
  r->rep_cap = 0;
  r->rep_live = 0;
  r->drain_seq = 0;
  r->replay_cap = 128;  // see rep_track; router_set_replay_cap overrides
  return r;
}

// Bound on NON-uniform duplicate-key segment length per device window
// (the kernel replays such segments one lane per round).  0 disables.
void router_set_replay_cap(Router* r, int32_t cap) {
  r->replay_cap = cap < 0 ? 0 : cap;
}

// Install (or clear, n == 0) the cluster's consistent-hash ring so
// fastpath_parse_stack can classify items per key.  points must be sorted
// ascending; peer_of[i] is the peer index owning point i; self_idx is this
// node's peer index.  Caller must serialize with staging calls (the engine
// executor thread does).
void router_set_ring(Router* r, const uint32_t* points,
                     const int32_t* peer_of, int32_t n, int32_t self_idx) {
  free(r->ring_points);
  free(r->ring_peer);
  r->ring_points = nullptr;
  r->ring_peer = nullptr;
  r->ring_len = n;
  r->ring_self = self_idx;
  if (n > 0) {
    r->ring_points = (uint32_t*)malloc(sizeof(uint32_t) * n);
    r->ring_peer = (int32_t*)malloc(sizeof(int32_t) * n);
    memcpy(r->ring_points, points, sizeof(uint32_t) * n);
    memcpy(r->ring_peer, peer_of, sizeof(int32_t) * n);
  }
}

// Enable the exact-key collision guard.  Must be called before any key is
// inserted (entries allocated earlier have no stored key to compare).
void router_set_exact(Router* r) {
  r->exact = 1;
  for (int32_t i = 0; i < r->num_shards; i++) {
    Shard* s = &r->shards[i];
    if (s->keys == nullptr) {
      s->keys = (uint8_t**)calloc(s->capacity, sizeof(uint8_t*));
      s->klen = (int32_t*)calloc(s->capacity, sizeof(int32_t));
    }
  }
}

// ---- drain protocol ------------------------------------------------------
// A drain is one engine-thread batch of stacked staging calls
// (fastpath_parse_stack / router_pack_stack) followed by ONE device
// dispatch.  All calls share one pack sequence (so a key allocated by an
// earlier call in the drain stops reporting is_init to later calls — its
// init lane is already staged in an earlier window of the same stack), and
// the pending-init commit list accumulates across the drain:
//   router_drain_begin -> stage... -> dispatch -> router_commit
//                                  \-> dispatch failed -> router_abort
// router_abort keeps the staged entries pending, so their next touch
// re-reports is_init and the device re-initializes the slot (the arena
// never saw the failed windows).
void router_drain_begin(Router* r) {
  r->pack_seq++;
  r->drain_seq++;   // invalidates every replay-guard cell (stamp check)
  r->rep_live = 0;
  // belt-and-braces: a crashed previous drain that called neither commit
  // nor abort must not have its pending inits cleared by THIS drain's
  // commit (the entries stay pending, so their next touch re-inits)
  r->commit_len = 0;
}

void router_abort(Router* r) { r->commit_len = 0; }

// Confirm that the window staged by the LAST pack/parse call was actually
// dispatched: its fresh allocations stop reporting is_init.
void router_commit(Router* r) {
  for (int64_t i = 0; i < r->commit_len; i++) {
    int32_t shard = (int32_t)(r->commit_list[i] >> 32);
    int32_t e = (int32_t)(r->commit_list[i] & 0xFFFFFFFF);
    r->shards[shard].pending[e] = 0;
  }
  r->commit_len = 0;
}

Router* router_new(int32_t num_shards, int32_t capacity_per_shard) {
  return router_new_mesh(num_shards, 0, num_shards, capacity_per_shard);
}

void router_free(Router* r) {
  for (int32_t i = 0; i < r->num_shards; i++) {
    Shard* s = &r->shards[i];
    free(s->cells); free(s->fp); free(s->expire); free(s->cell_of);
    free(s->prev); free(s->next); free(s->free_list);
    free(s->pending); free(s->seq); free(s->heap); free(s->heap_old);
    if (s->keys != nullptr) {
      for (int32_t e = 0; e < s->capacity; e++) free(s->keys[e]);
      free(s->keys);
      free(s->klen);
    }
  }
  free(r->shards);
  free(r->commit_list);
  free(r->scratch);
  free(r->ring_points);
  free(r->ring_peer);
  free(r->rep);
  free(r);
}

namespace {

// Shared body of router_pack / router_pack_window (the latter runs under
// an open drain: one pack sequence and an accumulating commit list across
// K caller-delimited windows, see router_drain_begin).
int64_t pack_full_impl(
    Router* r,
    const uint8_t* key_bytes, const int64_t* key_ends, int64_t n,
    const int64_t* hits, const int64_t* limits, const int64_t* durations,
    const int32_t* algos, int64_t now, int32_t lanes,
    int32_t* out_slot, int64_t* out_hits, int64_t* out_limit,
    int64_t* out_duration, int32_t* out_algo, uint8_t* out_is_init,
    int32_t* out_shard, int32_t* out_lane, int32_t* shard_fill) {
  for (int64_t i = 0; i < n; i++) {
    int64_t beg = i == 0 ? 0 : key_ends[i - 1];
    int64_t len = key_ends[i] - beg;
    const uint8_t* key = key_bytes + beg;
    int32_t shard =
        (int32_t)(crc32(key, len) % (uint32_t)r->num_global_shards) -
        r->shard_offset;
    if (shard < 0 || shard >= r->num_shards) {
      // mis-routed key (mesh mode): mark it and let the caller reject the
      // batch before dispatching — it consumes no lane
      out_shard[i] = -1;
      out_lane[i] = -1;
      continue;
    }
    int32_t lane = shard_fill[shard];
    if (lane >= lanes) return i;
    uint8_t is_init = 0;
    int32_t slot = shard_lookup(&r->shards[shard], fnv1a64(key, len), now,
                                durations[i], r->pack_seq, &is_init, key, len);
    if (is_init) push_commit(r, shard, slot);
    int64_t o = (int64_t)shard * lanes + lane;

    out_slot[o] = slot;
    out_hits[o] = hits[i];
    out_limit[o] = limits[i];
    out_duration[o] = durations[i];
    out_algo[o] = algos[i];
    out_is_init[o] = is_init;
    out_shard[i] = (int32_t)shard;
    out_lane[i] = lane;
    shard_fill[shard] = lane + 1;
  }
  return n;
}

}  // namespace

// Resolve and pack one window.  Keys are concatenated UTF-8 bytes with
// exclusive end offsets.  Output lane arrays are [num_shards * lanes]
// row-major; slot lanes the packer doesn't fill must be pre-set to PAD by
// the caller.  Returns the number of requests packed: < n means the next
// request would overflow its shard's lane budget (caller ships this window
// and repacks the rest).
int64_t router_pack(
    Router* r,
    const uint8_t* key_bytes, const int64_t* key_ends, int64_t n,
    const int64_t* hits, const int64_t* limits, const int64_t* durations,
    const int32_t* algos, int64_t now, int32_t lanes,
    int32_t* out_slot, int64_t* out_hits, int64_t* out_limit,
    int64_t* out_duration, int32_t* out_algo, uint8_t* out_is_init,
    int32_t* out_shard, int32_t* out_lane, int32_t* shard_fill) {
  r->pack_seq++;
  r->commit_len = 0;  // an uncommitted previous window stays pending
  return pack_full_impl(r, key_bytes, key_ends, n, hits, limits, durations,
                        algos, now, lanes, out_slot, out_hits, out_limit,
                        out_duration, out_algo, out_is_init, out_shard,
                        out_lane, shard_fill);
}

// Drain-protocol sibling of router_pack: caller delimits the windows of a
// stacked dispatch (RateLimitEngine.step_stacked) — one window per call,
// output arrays pointed at that window's slice of the stacked staging —
// under one router_drain_begin .. router_commit/router_abort bracket, so a
// key first seen in window k reports is_init exactly once across the
// whole stack.
int64_t router_pack_window(
    Router* r,
    const uint8_t* key_bytes, const int64_t* key_ends, int64_t n,
    const int64_t* hits, const int64_t* limits, const int64_t* durations,
    const int32_t* algos, int64_t now, int32_t lanes,
    int32_t* out_slot, int64_t* out_hits, int64_t* out_limit,
    int64_t* out_duration, int32_t* out_algo, uint8_t* out_is_init,
    int32_t* out_shard, int32_t* out_lane, int32_t* shard_fill) {
  return pack_full_impl(r, key_bytes, key_ends, n, hits, limits, durations,
                        algos, now, lanes, out_slot, out_hits, out_limit,
                        out_duration, out_algo, out_is_init, out_shard,
                        out_lane, shard_fill);
}

// ---- fast serving path --------------------------------------------------
//
// One C call takes a serialized GetRateLimitsReq straight to a staged
// compact-format device window (api/proto/gubernator.proto; wire format in
// ops/kernel.py "compact wire format"), and a second C call takes the
// fetched compact response straight to a serialized GetRateLimitsResp.
// This replaces the per-item Python protobuf decode + dataclass hops that
// otherwise bound the serving path (the reference's whole GetRateLimits
// walk, gubernator.go:75-166, is Go codegen + map ops; ours is two C calls
// and one device dispatch).
//
// The parser is deliberately narrow: BATCHING behavior, valid algorithm,
// nonempty name/key, compact-range hits/limit/duration.  Anything else
// returns a negative code and the caller falls back to the full Python
// path, which handles every semantic (per-item errors, GLOBAL, chunking).

namespace {

inline bool read_varint(const uint8_t** pp, const uint8_t* end,
                        uint64_t* out) {
  const uint8_t* p = *pp;
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 70) {
    uint8_t b = *p++;
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      *pp = p;
      return true;
    }
    shift += 7;
  }
  return false;
}

inline uint32_t crc32_update(uint32_t c, const uint8_t* d, int64_t n) {
  for (int64_t i = 0; i < n; i++)
    c = crc32_table[(c ^ d[i]) & 0xFF] ^ (c >> 8);
  return c;
}

inline uint64_t fnv1a_update(uint64_t h, const uint8_t* d, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    h ^= d[i];
    h *= 1099511628211ull;
  }
  return h;
}

inline int varint_size(uint64_t v) {
  int n = 1;
  while (v >= 0x80) {
    v >>= 7;
    n++;
  }
  return n;
}

inline uint8_t* write_varint(uint8_t* p, uint64_t v) {
  while (v >= 0x80) {
    *p++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *p++ = (uint8_t)v;
  return p;
}

constexpr int64_t COMPACT_MAX_HITS = 1ll << 28;
constexpr int64_t COMPACT_MAX_LIMIT = 1ll << 31;
constexpr int64_t COMPACT_MAX_DURATION = (1ll << 31) - 16;
// Algorithm-plane caps (ops/kernel.py): sliding windows interpolate across
// two buckets so the rebased-i32 proof needs now - window_start < 2*duration;
// concurrency hits are sign-extended through bit 27 of the compact hits field
// so releases (negative hits) survive the 28-bit encode.
constexpr int64_t SLIDING_MAX_DURATION = 1ll << 30;
constexpr int64_t CONC_MAX_HITS = 1ll << 27;

// Per-algorithm compact range gate.  algo 0..4 are stageable; anything the
// compact wire cannot carry exactly returns false and the caller falls back
// to the full python path (-2).
inline bool compact_ranges_ok(int64_t hits, int64_t limit, int64_t duration,
                              int64_t algo) {
  if (algo < 0 || algo > 4) return false;
  if (algo == 4) {
    if (hits <= -CONC_MAX_HITS || hits >= CONC_MAX_HITS) return false;
  } else {
    if (hits < 0 || hits >= COMPACT_MAX_HITS) return false;
  }
  if (limit < 0 || limit >= COMPACT_MAX_LIMIT) return false;
  int64_t dcap = algo == 3 ? SLIDING_MAX_DURATION : COMPACT_MAX_DURATION;
  if (duration < 0 || duration >= dcap) return false;
  return true;
}

}  // namespace

namespace {

constexpr int32_t MAX_STACK_ITEMS = 1024;  // > MAX_BATCH_SIZE (1000)
constexpr int32_t MAX_STACK_SHARDS = 256;

struct ParsedItem {
  const uint8_t* name;
  int64_t name_len;
  const uint8_t* key;
  int64_t key_len;
  int64_t hits, limit, duration;
  uint32_t algo;
  int32_t shard;  // local shard index
  uint64_t fp;
  int64_t scratch_off;  // assembled hash_key offset (exact mode)
  int32_t owner;        // ring peer index (-1 == local / no ring)
  int64_t msg_off;      // serialized RateLimitReq body within the RPC bytes
  int32_t msg_len;
};

// Parse one serialized RateLimitReq message body into *it (no validation).
// Returns false on malformed bytes.
bool parse_item(const uint8_t* q, const uint8_t* qend, ParsedItem* it,
                uint64_t* behavior) {
  it->name = nullptr;
  it->name_len = 0;
  it->key = nullptr;
  it->key_len = 0;
  it->hits = it->limit = it->duration = 0;
  it->algo = 0;
  *behavior = 0;
  while (q < qend) {
    uint64_t t;
    if (!read_varint(&q, qend, &t)) return false;
    uint64_t field = t >> 3;
    int wt = (int)(t & 7);
    if (wt == 2) {
      uint64_t l;
      if (!read_varint(&q, qend, &l) || l > (uint64_t)(qend - q))
        return false;
      if (field == 1) {
        it->name = q;
        it->name_len = (int64_t)l;
      } else if (field == 2) {
        it->key = q;
        it->key_len = (int64_t)l;
      }
      q += l;
    } else if (wt == 0) {
      uint64_t v;
      if (!read_varint(&q, qend, &v)) return false;
      if (field == 3) it->hits = (int64_t)v;
      else if (field == 4) it->limit = (int64_t)v;
      else if (field == 5) it->duration = (int64_t)v;
      else if (field == 6) it->algo = (uint32_t)v;
      else if (field == 7) *behavior = v;
    } else {
      return false;
    }
  }
  return true;
}

// Per-shard stack-fit check shared by the two staging entry points: can
// `demand[s]` more lanes be placed for every shard, given the monotonic
// window cursors?  (Windows fill per shard in cursor order, so the free
// space is the tail of the cursor's window plus every later window.)
// ---- replay-bound guard -------------------------------------------------
// The device kernel replays a NON-uniform duplicate-key segment one lane
// per while_loop round; an RPC carrying thousands of same-key lanes with
// mixed configs would compile into one multi-hundred-ms device execution
// (big enough ones crashed the device runtime worker).
// Uniform hot keys are untouched (the closed form is O(1) regardless of
// length).  When a key's segment is known non-uniform and reaches
// replay_cap lanes in the current window, the NEXT lane forces its shard
// onto a fresh window of the stack, bounding every window's replay depth.
//
// Tracking runs in the side-effect-free pass 1 (keyed by (shard, fp) —
// the slot is not known until pass 2).  On a pack that later falls back,
// the counts persist for the drain: purely conservative (an earlier
// split next time), never wrong.

RepCell* rep_probe(Router* r, int32_t shard, uint64_t fp) {
  if (r->rep_cap == 0) {
    r->rep = (RepCell*)calloc(1024, sizeof(RepCell));
    if (!r->rep) return nullptr;  // OOM: guard degrades to off, no crash
    r->rep_cap = 1024;
  }
  uint64_t mask = (uint64_t)r->rep_cap - 1;
  uint64_t h = fp ^ ((uint64_t)(uint32_t)shard * 0x9E3779B97F4A7C15ull);
  for (int64_t probe = 0;; probe++) {
    RepCell* c = &r->rep[(h + probe) & mask];
    if (c->seq != r->drain_seq || c->fp == 0) return c;  // free (stale ok)
    if (c->fp == fp && c->shard == shard) return c;
    if (probe >= r->rep_cap) return nullptr;  // table saturated
  }
}

void rep_grow(Router* r) {
  int64_t old_cap = r->rep_cap;
  RepCell* old = r->rep;
  RepCell* grown = (RepCell*)calloc(old_cap * 2, sizeof(RepCell));
  if (!grown) return;  // OOM: keep the old table (denser probing, no crash)
  r->rep_cap = old_cap * 2;
  r->rep = grown;
  uint64_t mask = (uint64_t)r->rep_cap - 1;
  for (int64_t i = 0; i < old_cap; i++) {
    if (old[i].seq != r->drain_seq || old[i].fp == 0) continue;
    uint64_t h = old[i].fp ^
                 ((uint64_t)(uint32_t)old[i].shard * 0x9E3779B97F4A7C15ull);
    for (int64_t probe = 0;; probe++) {
      RepCell* c = &r->rep[(h + probe) & mask];
      if (c->seq != r->drain_seq || c->fp == 0) { *c = old[i]; break; }
    }
  }
  free(old);
}

// Track one local item; returns 1 if it must open a new window for its
// shard (the caller accounts the spill and pass 2 honors it).
inline int rep_track(Router* r, int32_t shard, uint64_t fp, int64_t h,
                     int64_t l, int64_t d, int32_t algo) {
  if (!r->replay_cap) return 0;
  if (fp == 0) fp = 1;
  if (r->rep_cap && r->rep_live * 2 >= r->rep_cap) rep_grow(r);
  RepCell* c = rep_probe(r, shard, fp);
  if (!c) return 0;  // saturated: guard degrades to off for new keys
  if (c->seq != r->drain_seq || c->fp == 0 ||
      !(c->fp == fp && c->shard == shard)) {
    r->rep_live++;
    *c = RepCell{fp, h, l, d, r->drain_seq, shard, algo, 1,
                 h == 0, -1, -1, 0, -1, 0, 0, 0};
    return 0;
  }
  c->lanes++;
  if (!c->nonuniform &&
      !(h == c->h && l == c->l && d == c->d && algo == c->algo && h > 0))
    c->nonuniform = 1;
  if (c->nonuniform && c->lanes > r->replay_cap) {
    // this lane starts the key's segment in a FRESH window
    *c = RepCell{fp, h, l, d, r->drain_seq, shard, algo, 1, h == 0,
                 -1, -1, 0, -1, 0, 0, 0};
    return 1;
  }
  return 0;
}

// Exact pass-1 placement check: walk the staged items per shard in order
// (fold-predicted items still count a lane — conservative; fold
// misprediction must never overflow pass 2), applying window spills and
// replay-cap splits exactly as stage_lane will.  items: per-item shard;
// bumps: per-item force-new flags.  Returns false if any shard would run
// past the K-th window.
bool stack_fits_exact(const int32_t* shards_arr, const uint8_t* bumps,
                      int64_t n, const int32_t* kcur,
                      const int32_t* shard_fill, int32_t S, int32_t lanes,
                      int32_t K) {
  int32_t simk[MAX_STACK_SHARDS];
  int32_t simfill[MAX_STACK_SHARDS];
  for (int32_t s = 0; s < S; s++) {
    simk[s] = kcur[s];
    simfill[s] = shard_fill[kcur[s] * S + s];
  }
  for (int64_t i = 0; i < n; i++) {
    int32_t s = shards_arr[i];
    if (s < 0) continue;  // forwarded / not staged
    if (bumps[i] && simfill[s] > 0) {
      simk[s]++;
      simfill[s] = 0;
    }
    if (simfill[s] >= lanes) {
      simk[s]++;
      simfill[s] = 0;
    }
    if (simk[s] >= K) return false;
    simfill[s]++;
  }
  return true;
}

// Stage one resolved item into the window stack.  packed is
// i64[K, S, lanes, 2]; out_row gets the flattened window-row index
// (widx * S + shard) so the encoder can address the fetched [K*S, lanes]
// response plane directly.
// AGG_SLOT_BIT mirror (ops/kernel.py): bit 30 of the packed slot+1 field
// marks an aggregated hits=1 run; the device answers with r_start and the
// encoder synthesizes each item's response from its 0-based position.
constexpr int64_t AGG_W0_BIT = 1ll << 30;

inline void stage_lane(Router* r, int32_t shard, uint64_t fp,
                       const uint8_t* key, int64_t key_len, int64_t now,
                       int64_t hits, int64_t limit, int64_t duration,
                       uint32_t algo, int32_t lanes, int32_t K,
                       int64_t* packed, int32_t* kcur, int32_t* shard_fill,
                       int32_t* out_row, int32_t* out_lane, int32_t* out_pos,
                       int64_t i, int force_new) {
  int32_t S = r->num_shards;
  // replay-bound split (rep_track said so in pass 1): this lane opens a
  // fresh window for its shard so the device replay loop stays bounded
  if (force_new && shard_fill[kcur[shard] * S + shard] > 0) kcur[shard]++;
  uint8_t is_init = 0;
  int32_t slot = shard_lookup(&r->shards[shard], fp, now, duration,
                              r->pack_seq, &is_init, key, key_len);
  // response synthesizable by pos; algo >= 2 never aggregates (posinfo
  // carries the algorithm in 2 bits only, and GCRA/sliding/concurrency
  // responses are not linear in the fold count anyway)
  bool synth = hits == 1 && limit > 0 && algo <= 1;
  // Probe the key's drain cell for BOTH synth and plain items: a plain
  // lane staged for this key must invalidate any armed aggregation lane
  // (folding a later item into a lane that sorts BEFORE the plain lane
  // would reorder the key's sequential semantics — and pass-1 state
  // cannot carry this, the replay-cap reset clears nonuniform).
  RepCell* c = r->replay_cap ? rep_probe(r, shard, fp) : nullptr;
  bool cell_live = c && c->seq == r->drain_seq && c->fp == (fp ? fp : 1) &&
                   c->shard == shard;
  if (synth && cell_live && !is_init &&
      c->agg_off >= 0 && c->agg_k == kcur[shard] && c->slot == slot &&
      c->agg_l == limit && c->agg_d == duration &&
      c->agg_algo == (int32_t)algo &&
      c->agg_n < (int32_t)(COMPACT_MAX_HITS - 1)) {
    // the cap keeps the folded count inside the 28-bit compact hits
    // field (folds consume no lanes, so stack capacity alone does not
    // bound it); at the cap the item below stages a fresh lane and
    // re-arms the cell there
    // fold into the existing aggregation lane: one more hit, no new lane
    packed[c->agg_off] += 1ll << 34;
    int64_t row_lane = c->agg_off / 2;
    out_row[i] = (int32_t)(row_lane / lanes);
    out_lane[i] = (int32_t)(row_lane % lanes);
    out_pos[i] = c->agg_n++ | ((int32_t)algo << 30);
    return;
  }
  int32_t k = kcur[shard];
  if (shard_fill[k * S + shard] >= lanes) k = ++kcur[shard];
  int32_t lane = shard_fill[k * S + shard]++;
  if (is_init) push_commit(r, shard, slot);
  int64_t row = (int64_t)k * S + shard;
  int64_t o = (row * lanes + lane) * 2;
  // algo rides in 3 bits: bit 33 plus bits 62..63, so legacy token/leaky
  // words stay bit-identical; hits are masked because concurrency releases
  // are negative (sign-extended from bit 27 on decode)
  int64_t w0 = (int64_t)(slot + 1) | ((int64_t)is_init << 32) |
               ((int64_t)(algo & 1) << 33) |
               ((hits & (COMPACT_MAX_HITS - 1)) << 34) |
               ((int64_t)((algo >> 1) & 3) << 62);
  if (synth) {
    w0 |= AGG_W0_BIT;  // n=1 aggregate: device returns r_start
    out_pos[i] = 0 | ((int32_t)algo << 30);
    if (cell_live) {  // future uniform duplicates fold into this lane
      c->agg_off = o;
      c->agg_k = k;
      c->agg_n = 1;
      c->slot = slot;
      c->agg_l = limit;
      c->agg_d = duration;
      c->agg_algo = (int32_t)algo;
    }
  } else {
    out_pos[i] = -1;  // plain lane: legacy response decode
    if (cell_live) c->agg_off = -1;  // see probe comment above
  }
  packed[o] = w0;
  packed[o + 1] = limit | (duration << 32);
  out_row[i] = (int32_t)row;
  out_lane[i] = lane;
}

uint8_t* scratch_reserve(Router* r, int64_t need) {
  if (need > r->scratch_cap) {
    int64_t cap = r->scratch_cap ? r->scratch_cap : 4096;
    while (cap < need) cap *= 2;
    r->scratch = (uint8_t*)realloc(r->scratch, cap);
    r->scratch_cap = cap;
  }
  return r->scratch;
}

// Successor point with wraparound (reference hash.go:80-96 / the Python
// ring's bisect_left): owner of hash h.
inline int32_t ring_owner(const Router* r, uint32_t h) {
  int32_t lo = 0, hi = r->ring_len;
  while (lo < hi) {
    int32_t mid = (lo + hi) / 2;
    if (r->ring_points[mid] < h) lo = mid + 1;
    else hi = mid;
  }
  if (lo == r->ring_len) lo = 0;
  return r->ring_peer[lo];
}

}  // namespace

// Parse a serialized GetRateLimitsReq and stage it into a STACK of K
// compact-format windows (one drain = many such calls + one stacked device
// dispatch; see router_drain_begin).  Items spill to later windows when
// their shard's current window is full; the per-shard cursor `kcur`
// (caller-owned, zeroed at drain start) only moves forward, so all staging
// for a shard — and therefore for any single key — is window-monotonic
// across the whole drain, preserving sequential per-key semantics through
// the device-side scan.
//
// Two passes: pass 1 parses, validates and hashes every item with NO side
// effects (a fallback return leaves the router and the stack untouched —
// no allocations, no evictions, no consumed lanes); pass 2 stages
// unconditionally.
//
// packed: i64[K, S, lanes, 2] pre-zeroed; shard_fill: i32[K, S];
// kcur: i32[S].  out_row/out_lane/out_limit: per-item demux info
// (out_limit feeds the response encoder, which echoes the request limit —
// see fastpath_encode_w).
//
// Cluster mode (router_set_ring installed): items whose ring owner is a
// DIFFERENT peer are not staged; they come back marked
// out_row[i] = -2 - owner with their serialized RateLimitReq body range in
// out_off/out_mlen, so the host forwards just those items without
// re-parsing the RPC (reference analog: the per-item owner-vs-forward
// split, gubernator.go:114-152).
//
// Returns the request count n >= 0, or:
//   -1  malformed protobuf
//   -2  a request needs the full path (behavior/algorithm/validation/range)
//   -3  more than max_items requests
//   -6  the RPC does not fit in this stack's remaining lanes (caller
//       dispatches the stack and retries on a fresh one; -6 on a FRESH
//       stack means the RPC can never fit and must take the full path)
// use_ring == 0 treats every item as local even when a ring is installed:
// the peer-plane lane (GetPeerRateLimits) is authoritative for whatever it
// receives, like the reference owner (gubernator.go:210-227).
// out_ns (may be null): the call's own nanoseconds (ScopeClock), as for
// fastpath_encode_w and fastpath_encode_parts.
int64_t fastpath_parse_stack(Router* r, const uint8_t* buf, int64_t len,
                             int64_t now, int32_t lanes, int32_t K,
                             int64_t max_items, int32_t use_ring,
                             int64_t* packed,
                             int32_t* kcur, int32_t* shard_fill,
                             int32_t* out_row, int32_t* out_lane,
                             int32_t* out_pos,
                             int64_t* out_limit, int64_t* out_off,
                             int32_t* out_mlen, int64_t* out_ns) {
  ScopeClock clock(out_ns);
  int32_t S = r->num_shards;
  if (S > MAX_STACK_SHARDS) return -2;
  if (max_items > MAX_STACK_ITEMS) max_items = MAX_STACK_ITEMS;
  static thread_local ParsedItem items[MAX_STACK_ITEMS];
  static thread_local uint8_t bump[MAX_STACK_ITEMS];
  static thread_local int32_t item_shard[MAX_STACK_ITEMS];

  // ---- pass 1: parse + validate + hash, no side effects on the router
  //      tables (the replay-bound tracker is drain-scoped and purely
  //      conservative on aborted packs — see rep_track) ----
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  int64_t n = 0;
  int64_t scratch_need = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(&p, end, &tag)) return -1;
    if (tag != ((1u << 3) | 2)) {  // only field 1: repeated RateLimitReq
      int wt = (int)(tag & 7);
      if (wt == 0) {
        uint64_t dummy;
        if (!read_varint(&p, end, &dummy)) return -1;
      } else if (wt == 2) {
        uint64_t l;
        if (!read_varint(&p, end, &l) || l > (uint64_t)(end - p))
          return -1;
        p += l;
      } else {
        return -1;
      }
      continue;
    }
    uint64_t mlen;
    if (!read_varint(&p, end, &mlen) || mlen > (uint64_t)(end - p))
      return -1;
    if (n >= max_items) return -3;
    ParsedItem* it = &items[n];
    it->msg_off = p - buf;
    it->msg_len = (int32_t)mlen;
    uint64_t behavior;
    if (!parse_item(p, p + mlen, it, &behavior)) return -1;
    p += mlen;

    if (it->name_len == 0 || it->key_len == 0) return -2;
    if (behavior != 0) return -2;  // BATCHING only
    // concurrency rides the python path: the host lease book needs
    // per-item visibility the bytes lane does not surface
    if (it->algo == 4) return -2;
    if (!compact_ranges_ok(it->hits, it->limit, it->duration, it->algo))
      return -2;

    // hash key = name + "_" + unique_key (client.go:33-35), streamed
    uint8_t sep = '_';
    uint32_t c = 0xFFFFFFFFu;
    c = crc32_update(c, it->name, it->name_len);
    c = crc32_update(c, &sep, 1);
    c = crc32_update(c, it->key, it->key_len);
    uint32_t crc = c ^ 0xFFFFFFFFu;

    it->owner = -1;  // local
    if (use_ring && r->ring_len > 0) {
      int32_t owner = ring_owner(r, crc);
      if (owner != r->ring_self) {
        it->owner = owner;  // forwarded: parsed but never staged
        bump[n] = 0;
        item_shard[n] = -1;
        n++;
        continue;
      }
    }

    uint64_t fp = fnv1a_update(1469598103934665603ull, it->name,
                               it->name_len);
    fp = fnv1a_update(fp, &sep, 1);
    fp = fnv1a_update(fp, it->key, it->key_len);
    it->fp = fp ? fp : 1;

    int32_t shard = (int32_t)(crc % (uint32_t)r->num_global_shards) -
                    r->shard_offset;
    if (shard < 0 || shard >= S) return -2;  // not ours: full path routes it
    it->shard = shard;
    item_shard[n] = shard;
    bump[n] = (uint8_t)rep_track(r, shard, it->fp, it->hits, it->limit,
                                 it->duration, (int32_t)it->algo);
    if (r->exact) {
      it->scratch_off = scratch_need;
      scratch_need += it->name_len + 1 + it->key_len;
    }
    n++;
  }
  // Exact placement simulation: spills and replay-cap splits are applied
  // as pass 2 will; fold-predicted duplicates still count a lane
  // (conservative — fold prediction can break on mid-drain eviction, and
  // pass 2 must never overflow).
  if (!stack_fits_exact(item_shard, bump, n, kcur, shard_fill, S, lanes, K))
    return -6;

  // ---- pass 2: stage (cannot fail) ----
  uint8_t* scratch = r->exact ? scratch_reserve(r, scratch_need) : nullptr;
  for (int64_t i = 0; i < n; i++) {
    ParsedItem* it = &items[i];
    if (it->owner >= 0) {  // forwarded item: marker + message byte range
      out_row[i] = -2 - it->owner;
      out_lane[i] = -1;
      out_pos[i] = -1;
      out_limit[i] = it->limit;
      out_off[i] = it->msg_off;
      out_mlen[i] = it->msg_len;
      continue;
    }
    const uint8_t* kb = nullptr;
    int64_t kl = 0;
    if (r->exact) {
      kb = scratch + it->scratch_off;
      uint8_t* w = scratch + it->scratch_off;
      memcpy(w, it->name, it->name_len);
      w[it->name_len] = '_';
      memcpy(w + it->name_len + 1, it->key, it->key_len);
      kl = it->name_len + 1 + it->key_len;
    }
    stage_lane(r, it->shard, it->fp, kb, kl, now, it->hits, it->limit,
               it->duration, it->algo, lanes, K, packed, kcur, shard_fill,
               out_row, out_lane, out_pos, i, bump[i]);
    out_limit[i] = it->limit;
  }
  return n;
}

// Stateless pass-1 of fastpath_parse_stack for the frontdoor workers
// (core/shm_ring.py): parse + validate a serialized GetRateLimitsReq into
// request COLUMNS written to caller-owned (shared-memory) buffers, with
// exactly the acceptance rules of the engine's native RPC lane — so a
// worker-parsed RPC never range-falls-back inside the engine, and a
// rejected one ships as RAW bytes instead.  Touches NO router state:
// workers run this without a Router* (they never see the engine's
// tables), and the engine re-stages the columns via router_pack_stack.
// key_bytes gets concat(name + '_' + unique_key) per item (client.go:33-35,
// the same assembled hash key router_pack_stack hashes); key_ends are
// cumulative exclusive offsets; name_lens keeps each item's name length so
// the engine's rare fallback lane can split the assembled key back into
// (name, unique_key) exactly — COLS records then never need the original
// bytes appended.
// Returns the request count n >= 0, or:
//   -1  malformed protobuf
//   -2  a request needs the full path (behavior/algorithm/validation/range)
//   -3  more than max_items requests
//   -4  concatenated keys exceed key_cap bytes
int64_t frontdoor_parse_req(const uint8_t* buf, int64_t len,
                            int64_t max_items, int64_t key_cap,
                            uint8_t* key_bytes, int64_t* key_ends,
                            int64_t* hits, int64_t* limits,
                            int64_t* durations, int32_t* algos,
                            int32_t* name_lens) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  int64_t n = 0;
  int64_t koff = 0;
  while (p < end) {
    uint64_t tag;
    if (!read_varint(&p, end, &tag)) return -1;
    if (tag != ((1u << 3) | 2)) {  // only field 1: repeated RateLimitReq
      int wt = (int)(tag & 7);
      if (wt == 0) {
        uint64_t dummy;
        if (!read_varint(&p, end, &dummy)) return -1;
      } else if (wt == 2) {
        uint64_t l;
        if (!read_varint(&p, end, &l) || l > (uint64_t)(end - p))
          return -1;
        p += l;
      } else {
        return -1;
      }
      continue;
    }
    uint64_t mlen;
    if (!read_varint(&p, end, &mlen) || mlen > (uint64_t)(end - p))
      return -1;
    if (n >= max_items) return -3;
    ParsedItem it;
    uint64_t behavior;
    if (!parse_item(p, p + mlen, &it, &behavior)) return -1;
    p += mlen;

    if (it.name_len == 0 || it.key_len == 0) return -2;
    if (behavior != 0) return -2;  // BATCHING only
    if (it.algo == 4) return -2;  // python path (lease book visibility)
    if (!compact_ranges_ok(it.hits, it.limit, it.duration, it.algo))
      return -2;

    int64_t kl = it.name_len + 1 + it.key_len;
    if (koff + kl > key_cap) return -4;
    memcpy(key_bytes + koff, it.name, it.name_len);
    key_bytes[koff + it.name_len] = '_';
    memcpy(key_bytes + koff + it.name_len + 1, it.key, it.key_len);
    koff += kl;
    key_ends[n] = koff;
    hits[n] = it.hits;
    limits[n] = it.limit;
    durations[n] = it.duration;
    algos[n] = (int32_t)it.algo;
    name_lens[n] = (int32_t)it.name_len;
    n++;
  }
  return n;
}

// Response-direction mirror of frontdoor_parse_req (core/shm_ring.py):
// encode DECISION COLUMNS (status, limit, remaining, reset_time, shed
// flag) into a serialized GetRateLimitsResp, in the worker's process —
// the engine's completion path ships columns over the completion-ring
// slab and never serializes protobuf for columnar records.  Stateless
// like the parse lane: no Router*, byte-compatible with the engine's
// fastpath_encode_w emit loop (proto3 zero-field omission) plus the
// metadata map entries of qos/admission.py's shed_response for flagged
// items.  flags[i] == 0 is a plain decision; 1..5 index SHED_REASONS
// (the code table mirrored in shm_ring.py SHED_REASON_CODES).
// Returns the byte length, or -1 if out_cap is too small, or -2 for an
// unknown shed code (caller falls back to the Python encoder).
static const char* SHED_REASONS[] = {
    "", "queue_full", "deadline", "breaker_open", "draining", "ring_full"};
constexpr int64_t N_SHED_REASONS = 6;

int64_t frontdoor_encode_resp(const int64_t* status, const int64_t* limit,
                              const int64_t* remaining, const int64_t* reset,
                              const int32_t* flags, int64_t n,
                              uint8_t* out, int64_t out_cap) {
  uint8_t* w = out;
  uint8_t* wend = out + out_cap;
  for (int64_t i = 0; i < n; i++) {
    int64_t st = status[i], li = limit[i], re = remaining[i], rs = reset[i];
    int32_t fl = flags ? flags[i] : 0;
    if (fl < 0 || fl >= N_SHED_REASONS) return -2;
    // RateLimitResp: status=1, limit=2, remaining=3, reset_time=4,
    // metadata=6 map<string,string> (proto3: zero-valued fields omitted)
    int body = 0;
    if (st) body += 1 + varint_size((uint64_t)st);
    if (li) body += 1 + varint_size((uint64_t)li);
    if (re) body += 1 + varint_size((uint64_t)re);
    if (rs) body += 1 + varint_size((uint64_t)rs);
    int64_t rl = 0;
    if (fl) {
      rl = (int64_t)strlen(SHED_REASONS[fl]);
      // entry "shed" -> "true": 0x32 len {0x0a 4 shed 0x12 4 true}
      // entry "shed_reason" -> reason: 0x32 len {0x0a 11 ... 0x12 rl ...}
      body += 14 + 1 + (int)varint_size((uint64_t)(15 + rl)) + 15 + (int)rl;
    }
    if (w + 1 + varint_size((uint64_t)body) + body > wend) return -1;
    *w++ = (1u << 3) | 2;  // GetRateLimitsResp.responses
    w = write_varint(w, (uint64_t)body);
    if (st) {
      *w++ = (1u << 3) | 0;
      w = write_varint(w, (uint64_t)st);
    }
    if (li) {
      *w++ = (2u << 3) | 0;
      w = write_varint(w, (uint64_t)li);
    }
    if (re) {
      *w++ = (3u << 3) | 0;
      w = write_varint(w, (uint64_t)re);
    }
    if (rs) {
      *w++ = (4u << 3) | 0;
      w = write_varint(w, (uint64_t)rs);
    }
    if (fl) {
      *w++ = (6u << 3) | 2;  // metadata["shed"] = "true"
      *w++ = 12;
      *w++ = (1u << 3) | 2;
      *w++ = 4;
      memcpy(w, "shed", 4);
      w += 4;
      *w++ = (2u << 3) | 2;
      *w++ = 4;
      memcpy(w, "true", 4);
      w += 4;
      *w++ = (6u << 3) | 2;  // metadata["shed_reason"] = reason
      w = write_varint(w, (uint64_t)(15 + rl));
      *w++ = (1u << 3) | 2;
      *w++ = 11;
      memcpy(w, "shed_reason", 11);
      w += 11;
      *w++ = (2u << 3) | 2;
      *w++ = (uint8_t)rl;
      memcpy(w, SHED_REASONS[fl], (size_t)rl);
      w += rl;
    }
  }
  return w - out;
}

// Columnar-input sibling of fastpath_parse_stack for already-parsed request
// lists (the batcher's Python-side jobs).  Same drain protocol, same
// monotonic spill, same no-side-effects-on-fallback guarantee.
// Returns n >= 0, or -2 (a value outside the compact ranges: caller routes
// the job through the full-format path), -3 (too many items), -5 (a key
// routed to a shard this process does not own), -6 (stack full).
int64_t router_pack_stack(Router* r, const uint8_t* key_bytes,
                          const int64_t* key_ends, int64_t n,
                          const int64_t* hits, const int64_t* limits,
                          const int64_t* durations, const int32_t* algos,
                          int64_t now, int32_t lanes, int32_t K,
                          int64_t* packed, int32_t* kcur,
                          int32_t* shard_fill, int32_t* out_row,
                          int32_t* out_lane, int32_t* out_pos) {
  int32_t S = r->num_shards;
  if (S > MAX_STACK_SHARDS) return -2;
  if (n > MAX_STACK_ITEMS) return -3;
  static thread_local uint64_t fps[MAX_STACK_ITEMS];
  static thread_local int32_t shards[MAX_STACK_ITEMS];
  static thread_local uint8_t bump2[MAX_STACK_ITEMS];

  for (int64_t i = 0; i < n; i++) {
    if (!compact_ranges_ok(hits[i], limits[i], durations[i], algos[i]))
      return -2;
    int64_t beg = i == 0 ? 0 : key_ends[i - 1];
    int64_t len = key_ends[i] - beg;
    const uint8_t* key = key_bytes + beg;
    int32_t shard = (int32_t)(crc32(key, len) %
                              (uint32_t)r->num_global_shards) -
                    r->shard_offset;
    if (shard < 0 || shard >= S) return -5;
    shards[i] = shard;
    fps[i] = fnv1a64(key, len);
    bump2[i] = (uint8_t)rep_track(r, shard, fps[i], hits[i], limits[i],
                                  durations[i], algos[i]);
  }
  if (!stack_fits_exact(shards, bump2, n, kcur, shard_fill, S, lanes, K))
    return -6;

  for (int64_t i = 0; i < n; i++) {
    int64_t beg = i == 0 ? 0 : key_ends[i - 1];
    stage_lane(r, shards[i], fps[i], key_bytes + beg, key_ends[i] - beg,
               now, hits[i], limits[i], durations[i], (uint32_t)algos[i],
               lanes, K, packed, kcur, shard_fill, out_row, out_lane,
               out_pos, i, bump2[i]);
  }
  return n;
}

// Encode the fetched response-word plane (w0 = i64[K*S, lanes], the packed
// status/remaining/reset word — see ops/kernel.py encode_output_word) as a
// serialized GetRateLimitsResp for the n requests at
// (out_row[i], out_lane[i]).  The response's `limit` field echoes the
// REQUEST limit (item_limit, captured at parse time) — stored-vs-request
// limit mismatches are rare (a config change on a live bucket), so the
// device ships the full limit plane only when its per-window mismatch flag
// fires, and `climit` is non-null only then.
// Returns the byte length, or -1 if out_cap is too small; out_ns (may be
// null) receives the call's own nanoseconds.

// Decode one response word for item i: aggregated/synthesizable items
// (out_pos[i] >= 0: bits 0..29 the item's 0-based position in its run,
// bit 30 the algorithm) synthesize from r_start; plain items read the
// word directly.  See AGG_W0_BIT / ops/kernel.py transition(agg=...).
inline void decode_word_item(int64_t word, int64_t now, int32_t posinfo,
                             int64_t* status, int64_t* remaining,
                             int64_t* reset) {
  int64_t enc = (word >> 32) & 0xFFFFFFFFll;
  if (posinfo >= 0) {
    int64_t pos = posinfo & 0x3FFFFFFF;
    int32_t algo = (posinfo >> 30) & 1;
    int64_t r_start = word & 0x7FFFFFFFll;
    bool under = pos < r_start;
    *status = under ? 0 : 1;
    *remaining = under ? r_start - pos - 1 : 0;
    *reset = (enc == 0 || (algo == 1 && under)) ? 0 : now + enc - 1;
  } else {
    *status = (word >> 31) & 1;
    *remaining = word & 0x7FFFFFFFll;
    *reset = enc == 0 ? 0 : now + enc - 1;
  }
}

int64_t fastpath_encode_w(const int64_t* w0, const int64_t* item_limit,
                          int64_t now, int32_t lanes, int64_t n,
                          const int32_t* out_row, const int32_t* out_lane,
                          const int32_t* out_pos,
                          const int64_t* climit, uint8_t* out,
                          int64_t out_cap, int64_t* out_ns) {
  ScopeClock clock(out_ns);
  uint8_t* w = out;
  uint8_t* wend = out + out_cap;
  for (int64_t i = 0; i < n; i++) {
    int64_t o = (int64_t)out_row[i] * lanes + out_lane[i];
    int64_t word = w0[o];
    int64_t limit = climit ? climit[o] : item_limit[i];
    int64_t status, remaining, reset;
    decode_word_item(word, now, out_pos ? out_pos[i] : -1,
                     &status, &remaining, &reset);

    // RateLimitResp: status=1, limit=2, remaining=3, reset_time=4
    // (proto3: zero-valued fields are omitted)
    int body = 0;
    if (status) body += 1 + varint_size((uint64_t)status);
    if (limit) body += 1 + varint_size((uint64_t)limit);
    if (remaining) body += 1 + varint_size((uint64_t)remaining);
    if (reset) body += 1 + varint_size((uint64_t)reset);
    if (w + 1 + varint_size((uint64_t)body) + body > wend) return -1;
    *w++ = (1u << 3) | 2;  // GetRateLimitsResp.responses
    w = write_varint(w, (uint64_t)body);
    if (status) {
      *w++ = (1u << 3) | 0;
      w = write_varint(w, (uint64_t)status);
    }
    if (limit) {
      *w++ = (2u << 3) | 0;
      w = write_varint(w, (uint64_t)limit);
    }
    if (remaining) {
      *w++ = (3u << 3) | 0;
      w = write_varint(w, (uint64_t)remaining);
    }
    if (reset) {
      *w++ = (4u << 3) | 0;
      w = write_varint(w, (uint64_t)reset);
    }
  }
  return w - out;
}

// Encode the fetched response-word plane as PER-ITEM FRAMED segments —
// each local item becomes `0x0a + varint(len) + RateLimitResp body` at
// out[item_off[i] .. +item_len[i]] (the framing of one repeated-field
// entry, identical in GetRateLimitsResp and GetPeerRateLimitsResp).
// Forwarded items (rows[i] < 0) get item_len[i] == 0; the host splices the
// peer's framed response bytes there instead.  Returns total bytes
// written, or -1 if out_cap is too small.
int64_t fastpath_encode_parts(const int64_t* w0, const int64_t* item_limit,
                              int64_t now, int32_t lanes, int64_t n,
                              const int32_t* rows, const int32_t* lanes_arr,
                              const int32_t* out_pos,
                              const int64_t* climit, uint8_t* out,
                              int64_t out_cap, int64_t* item_off,
                              int32_t* item_len, int64_t* out_ns) {
  ScopeClock clock(out_ns);
  uint8_t* w = out;
  uint8_t* wend = out + out_cap;
  for (int64_t i = 0; i < n; i++) {
    if (rows[i] < 0) {
      item_off[i] = w - out;
      item_len[i] = 0;
      continue;
    }
    int64_t o = (int64_t)rows[i] * lanes + lanes_arr[i];
    int64_t word = w0[o];
    int64_t limit = climit ? climit[o] : item_limit[i];
    int64_t status, remaining, reset;
    decode_word_item(word, now, out_pos ? out_pos[i] : -1,
                     &status, &remaining, &reset);

    int body = 0;
    if (status) body += 1 + varint_size((uint64_t)status);
    if (limit) body += 1 + varint_size((uint64_t)limit);
    if (remaining) body += 1 + varint_size((uint64_t)remaining);
    if (reset) body += 1 + varint_size((uint64_t)reset);
    if (w + 1 + varint_size((uint64_t)body) + body > wend) return -1;
    uint8_t* seg = w;
    *w++ = (1u << 3) | 2;
    w = write_varint(w, (uint64_t)body);
    if (status) {
      *w++ = (1u << 3) | 0;
      w = write_varint(w, (uint64_t)status);
    }
    if (limit) {
      *w++ = (2u << 3) | 0;
      w = write_varint(w, (uint64_t)limit);
    }
    if (remaining) {
      *w++ = (3u << 3) | 0;
      w = write_varint(w, (uint64_t)remaining);
    }
    if (reset) {
      *w++ = (4u << 3) | 0;
      w = write_varint(w, (uint64_t)reset);
    }
    item_off[i] = seg - out;
    item_len[i] = (int32_t)(w - seg);
  }
  return w - out;
}

// total expiry-heap nodes (live + draining) for one shard — test/debug
// observability for the bounded-heap guarantees above
int64_t router_heap_size(Router* r, int32_t shard) {
  Shard* s = &r->shards[shard];
  return s->heap_len + s->heap_old_len;
}

int64_t router_size(Router* r) {
  int64_t total = 0;
  for (int32_t i = 0; i < r->num_shards; i++) total += r->shards[i].size;
  return total;
}

int64_t router_hits(Router* r) {
  int64_t total = 0;
  for (int32_t i = 0; i < r->num_shards; i++) total += r->shards[i].hits;
  return total;
}

int64_t router_misses(Router* r) {
  int64_t total = 0;
  for (int32_t i = 0; i < r->num_shards; i++) total += r->shards[i].misses;
  return total;
}

// ---- state lifecycle (key-map export/import for snapshots) ----------------

// Export one local shard's resident, committed entries oldest-first (LRU
// tail -> head): fingerprint, device slot (entry index IS the slot), and
// host expiry estimate.  Output buffers must hold `capacity` items.
// Pending entries are skipped — their device rows were never written, so a
// snapshot of them would resurrect the slot's previous tenant.
int64_t router_export_keys(Router* r, int32_t shard, uint64_t* out_fp,
                           int32_t* out_slot, int64_t* out_expire) {
  Shard* s = &r->shards[shard];
  int64_t n = 0;
  for (int32_t e = s->lru_tail; e != NIL; e = s->prev[e]) {
    if (s->pending[e]) continue;
    out_fp[n] = s->fp[e];
    out_slot[n] = e;
    out_expire[n] = s->expire[e];
    n++;
  }
  return n;
}

// Rebuild one local shard from router_export_keys output (oldest first).
// Each entry lands at its exported entry index — the index is the device
// slot the restored arena planes address.  Returns 0; -1 on an invalid or
// duplicate slot; -2 when the exact-key guard is on (key bytes are not
// part of the export, and fingerprint-only entries would make every
// exact-mode lookup probe past them forever).
int64_t router_import_keys(Router* r, int32_t shard, const uint64_t* fps,
                           const int32_t* slots, const int64_t* expires,
                           int64_t n) {
  Shard* s = &r->shards[shard];
  if (s->keys != nullptr) return -2;
  int32_t capacity = s->capacity;
  for (int64_t i = 0; i < n; i++)
    if (slots[i] < 0 || slots[i] >= capacity) return -1;
  for (uint32_t i = 0; i <= s->mask; i++) s->cells[i] = NIL;
  s->heap_len = 0;
  if (s->heap_old != nullptr) {
    free(s->heap_old);
    s->heap_old = nullptr;
    s->heap_old_len = 0;
  }
  s->lru_head = s->lru_tail = NIL;
  memset(s->pending, 0, (size_t)capacity);
  memset(s->seq, 0, (size_t)capacity * sizeof(uint32_t));
  uint8_t* used = (uint8_t*)calloc(capacity, 1);
  for (int64_t i = 0; i < n; i++) {
    int32_t e = slots[i];
    if (used[e]) {
      free(used);
      return -1;
    }
    used[e] = 1;
    uint32_t cell = (uint32_t)(fps[i] & s->mask);
    while (s->cells[cell] != NIL) cell = (cell + 1) & s->mask;
    s->cells[cell] = e;
    s->cell_of[e] = cell;
    s->fp[e] = fps[i];
    s->expire[e] = expires[i];
    lru_push_front(s, e);  // oldest-first input => head ends up MRU
    heap_push(s, expires[i], e);
  }
  // rebuild the free list so pops come back ascending, like shard_init
  s->free_top = 0;
  for (int32_t e = capacity - 1; e >= 0; e--)
    if (!used[e]) s->free_list[s->free_top++] = e;
  free(used);
  s->size = n;
  return 0;
}

// Occupancy by the host expiry estimate over all local shards: live and
// expired resident entries plus free slots (engine.cache_stats surface).
void router_occupancy(Router* r, int64_t now, int64_t* out_live,
                      int64_t* out_expired, int64_t* out_free) {
  int64_t live = 0, expired = 0, free_slots = 0;
  for (int32_t si = 0; si < r->num_shards; si++) {
    Shard* s = &r->shards[si];
    free_slots += s->capacity - s->size;
    for (int32_t e = s->lru_head; e != NIL; e = s->next[e]) {
      if (s->expire[e] >= now) live++;
      else expired++;
    }
  }
  *out_live = live;
  *out_expired = expired;
  *out_free = free_slots;
}

}  // extern "C"
