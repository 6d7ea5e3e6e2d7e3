// The GLOBAL sub-window for Hopper (sm_90a), CUDA C++: one launch of one
// thread block cluster per window.
//
// Replaces the JAX package's Pallas kernel global_combined_staged
// (gubernator_tpu/ops/pallas_kernel.py:1381; body _global_kernel :1295, its
// pair-arithmetic ladder _pair_transition :1207), together with the XLA ops
// the JAX engine runs around it in the same executable: the config writes
// and resets (_apply_config, gubernator_tpu/core/engine.py:2645) and the
// per-slot sum of the lanes' hits (kernel.global_accumulate and the mesh
// psum, engine.py:2665).  It computes, for any int64 input, what
// ops/global_kernel.py global_window_plain composes from the oracle:
// apply_config, kernel.global_accumulate, then kernel.global_combined
// (every read sees the arena with the window's config written and no hits
// applied; every summed hit applies once under its slot's config) on all
// five algorithm ladders.  The Pallas kernel carries only the token and
// leaky ladders; this one runs the shared ladder of ladder.cuh, so on
// GCRA, sliding-window and concurrency rows it follows the oracle where
// the Pallas kernel does not (the service refuses GLOBAL on those
// algorithms either way).
//
// What bounds it.  A window names at most kg config rows and the rows of
// its n lanes (256 and 2048 at the JAX engine's defaults), while the arena
// holds G rows (4096 by default, millions for a large GLOBAL key space).
// The earlier design ran a thread over every one of the G rows each window
// (72 B read and 44 B written a row) and wrote the arena out of place; the
// host wrote the config with torch ops and summed the hits in another
// pass, each a launch and several a host sync.  The window's own work is
// small: each lane reads its 56 B of control, gathers one row and writes a
// 32 B answer; each config lane writes 28 B; each touched row is read and
// written once.  So launch latency and the serial ladder of a lane (two
// int64 divisions among ~200 integer operations) set its time, not bytes.
//
// Design.  The three phases of global_phases.cuh (A stage, B read, C
// apply) in one kernel, with a cluster.sync() after A and another before
// C's stores.  The phases need a barrier across CTAs (B reads the rows A
// reset, C must not write a row before every B read of it) and a cluster
// barrier is a hardware barrier: a second launch or a cooperative grid
// sync would each cost microseconds.  Its arrive has release and its wait
// acquire semantics at cluster scope, which orders phase A's plain global
// stores before the loads of other CTAs of the cluster after it; the arena
// pointers carry no __restrict__, so those loads never take the
// non-coherent read-only path.  A launch has a thread per read lane and
// one per apply lane: 2n threads over 16 CTAs, the non-portable cluster
// size, where the card schedules it (it measured faster than 8, PERF.md),
// else over 8, the portable size (the ladder is too long for 2048 lanes on
// one SM).  Each thread loads its lane's control and the row planes phase A
// never writes before phase A, then, after the first barrier, only what A
// may have written (expire, the config, the sum); the apply threads
// compute their new rows while the read threads answer, and store them
// after the second barrier.  So a window costs about one ladder after
// phase A, not two.  The per-slot sums are global atomics on an
// engine-owned scratch i64[G] (all zero between windows; phase C exchanges
// each touched sum for 0): 2048 lanes' atomics stay in L2, and a sum in
// distributed shared memory would need the slot's owning CTA to be known
// before the adds, which a key's slot does not say.  The arena is updated
// in place, only on the rows the window names.  A window that carries an
// owner's broadcast (upsert lanes, a replica's control-plane traffic) runs
// phase A0 first and one more cluster barrier before phase A, so the
// config lanes and resets land after the upserts as in the JAX engine's
// _apply_control; the lanes' loads still overlap phase A.  (An upsert that
// searched the config lanes for its row instead took 31.6 us a window
// against 5.7 without upserts, PERF.md.)
//
// Mesh mode (several processes serve one arena, parallel/distributed.py)
// needs the window split across an all-reduce of the sums, since a rank's
// apply must see every rank's hits: the second entry point,
// global_stage_read, runs phases A0, A and B (the upserts, the config
// writes and resets, the lanes' hits summed into the scratch, every lane's
// answer from the pre-apply replica).  The caller all-reduces the scratch
// and launches global_apply.cu's global_apply_rows, which applies every
// nonzero sum.  global_stage_read launches no cluster and has no barrier
// across CTAs: a plain grid of kStageThreads-thread CTAs, a thread per
// read lane (and per upsert and config lane), where a barrier's ordering
// is replaced by global_phases.cuh's rule that a read takes what the
// window writes on its row from the control block (each CTA's RowTable).
// A window whose control has no reset and no upsert on a row (the mesh's
// steady state: configs are written at registration) builds no table and
// costs two dependent loads and one ladder a lane: its control (with its
// config lane's and its CTA's share of the reset indices, all issued
// together), then its row.  Each lane's atomic on its slot's sum goes out
// as soon as its control is in, so that its latency hides behind the row
// gather and the ladder; issued after them it cost more than the ladder
// (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "global_phases.cuh"

namespace {

// One thread's share of a window.  Its items between the two barriers are
// j = first, first + stride, ... in [0, 2n): read lane j for j < n, apply
// lane j - n above.  Its first such item is prefetched before phase A (the
// lane's control and the row planes phase A never writes), so the loads
// overlap phase A; when that item is an apply lane, its new row waits in
// registers and is stored after the second barrier, so reads and applies
// run side by side on different threads.  Further items (when the launch
// has fewer than 2n threads) run whole in their segment.
struct WindowThread {
  int64_t first, stride;
  bool has_read, has_apply;
  ReadLane rl;
  ApplyLane al;
};

// segment 0, in a window with upsert lanes only: phase A0
__device__ void window_seg_u(const GArena& a, const GConfig& cfg, const Control& c,
                             WindowThread& t) {
  for (int64_t p = t.first; p < c.ku; p += t.stride) upsert_item(a, cfg, c, p);
}

// segment 1: the prefetch, then phase A
__device__ void window_seg_a(const GArena& a, const GConfig& cfg, const Control& c,
                             int64_t* sums, WindowThread& t) {
  t.has_read = t.first < c.n;
  t.has_apply = t.first >= c.n && t.first < 2 * c.n;
  if (t.has_read) t.rl = read_prefetch(a, c, t.first);
  if (t.has_apply) t.al = apply_prefetch(a, c, t.first - c.n);
  for (int64_t i = t.first; i < stage_items(c); i += t.stride) stage_item(a, cfg, c, sums, i);
}

// segment 2: phase B, and phase C up to its stores
__device__ void window_seg_b(const GArena& a, const GConfig& cfg, const Control& c,
                             int64_t* sums, int64_t now, int64_t* read, WindowThread& t) {
  if (t.has_read) read_finish(a, now, read, t.rl);
  if (t.has_apply) apply_prepare(a, cfg, sums, now, t.al);
  for (int64_t j = t.first + t.stride; j < c.n; j += t.stride) read_lane(a, c, now, read, j);
}

// segment 3: phase C's stores, and its further lanes whole
__device__ void window_seg_c(const GArena& a, const GConfig& cfg, const Control& c,
                             int64_t* sums, int64_t now, WindowThread& t) {
  if (t.has_apply) apply_store(a, t.al);
  for (int64_t j = t.first + t.stride; j < 2 * c.n; j += t.stride) {
    if (j >= c.n) apply_lane(a, cfg, c, sums, now, j - c.n);
  }
}

}  // namespace

#ifndef GUBER_HOST_SHIM
#include <cooperative_groups.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxThreads = 512;

// The debug stamps a CTA (thread 0's view): its start, the end of its
// phase A, its exit from the first barrier, the end of its phase B, its
// exit from the second barrier and its end.  A CTA's row of the stamps
// buffer holds them as globaltimer nanoseconds, then as clock64 cycles.
// They live in a second instance of the kernel, so that the one serving
// launches take carries no trace of them.
constexpr int kStamps = 6;

// the card's nanosecond clock, for the debug stamps
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool kStamped>
__device__ __forceinline__ void stamp(unsigned long long* stamps, int k) {
  if (kStamped && threadIdx.x == 0) {
    unsigned long long* row = stamps + 2 * kStamps * blockIdx.x;
    row[k] = global_ns();
    row[kStamps + k] = static_cast<unsigned long long>(clock64());
  }
}

template <bool kStamped>
__global__ void __launch_bounds__(kMaxThreads)
    global_window_kernel(GArena a, GConfig cfg, Control c, int64_t* sums, int64_t now,
                         int64_t* read, unsigned long long* stamps) {
  cg::cluster_group cluster = cg::this_cluster();
  stamp<kStamped>(stamps, 0);
  WindowThread t;
  t.first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  t.stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (c.ku > 0) {
    // an owner's broadcast lands before the window's config lanes (the
    // branch is uniform: every thread reaches the barrier)
    window_seg_u(a, cfg, c, t);
    cluster.sync();
  }
  window_seg_a(a, cfg, c, sums, t);
  stamp<kStamped>(stamps, 1);
  cluster.sync();
  stamp<kStamped>(stamps, 2);
  window_seg_b(a, cfg, c, sums, now, read, t);
  stamp<kStamped>(stamps, 3);
  cluster.sync();
  stamp<kStamped>(stamps, 4);
  window_seg_c(a, cfg, c, sums, now, t);
  stamp<kStamped>(stamps, 5);
}

// the stage-read launch's CTA size: 64 threads spread a rank's 1024 lanes
// over 16 SMs (32, 64, 128 and 256 timed on the H100, PERF.md)
constexpr int kStageThreads = 64;

// The mesh window's first half: phases A0 (with upsert lanes), A and B,
// the scratch left holding this rank's sums for the all-reduce; a plain
// grid, no barrier across CTAs (global_phases.cuh stage_read_cta).
__global__ void __launch_bounds__(kStageThreads)
    global_stage_read_kernel(GArena a, GConfig cfg, Control c, int64_t* sums, int64_t now,
                             int64_t* read) {
  __shared__ RowTable<kStageThreads> table;
  stage_read_cta<kStageThreads>(a, cfg, c, sums, now, read, table);
}

// threads a CTA: a thread per read lane and one per apply lane (2n items)
// over the cluster, in whole warps
long long window_threads(long long items, int ctas) {
  long long threads = (items + ctas - 1) / ctas;
  threads = (threads + 31) / 32 * 32;
  if (threads < 64) threads = 64;
  if (threads > kMaxThreads) threads = kMaxThreads;
  return threads;
}

cudaLaunchConfig_t window_config(long long items, int ctas, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t conf = {};
  conf.gridDim = dim3(static_cast<unsigned>(ctas), 1, 1);
  conf.blockDim = dim3(static_cast<unsigned>(window_threads(items, ctas)), 1, 1);
  conf.dynamicSmemBytes = 0;
  conf.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(ctas);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  conf.attrs = attr;
  conf.numAttrs = 1;
  return conf;
}

// Allow the non-portable cluster size (above 8 CTAs) on both instances,
// once.
cudaError_t allow_nonportable() {
  static const cudaError_t e = [] {
    for (auto* k : {&global_window_kernel<false>, &global_window_kernel<true>}) {
      const cudaError_t r = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (r != cudaSuccess) return r;
    }
    return cudaSuccess;
  }();
  return e;
}

// The cluster size of a launch for which the caller asks none: 16 CTAs,
// the non-portable size (faster than 8 on the H100, PERF.md), where the
// device schedules such a cluster at this launch's threads, else 8.
// Remembered per thread count.
int choose_ctas(long long n) {
  static int chosen[kMaxThreads / 32 + 1] = {};
  const long long threads = window_threads(2 * n, 16);
  int& c = chosen[threads / 32];
  if (c == 0) {
    int clusters = 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t conf = window_config(2 * n, 16, nullptr, &attr);
    const bool ok =
        allow_nonportable() == cudaSuccess &&
        cudaOccupancyMaxActiveClusters(&clusters, global_window_kernel<false>, &conf) ==
            cudaSuccess;
    if (!ok) cudaGetLastError();  // the refusal answers the question: clear it
    c = ok && clusters > 0 ? 16 : 8;
  }
  return c;
}

}  // namespace
#endif  // GUBER_HOST_SHIM

extern "C" {

const char* guber_global_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The cluster size guber_global_window takes for n lanes when given 0.
int guber_global_window_ctas(long long n) { return choose_ctas(n < 0 ? 0 : n); }

// One GLOBAL window in one cluster launch of `ctas` CTAs (1..16, above 8
// the non-portable cluster size; 0 lets choose_ctas pick): the arena
// (limit/duration/remaining/tstamp/expire i64[G], algo i32[G]) and its
// config (limit/duration i64[G], algo i32[G]) updated in place, the control
// block i64[7n + 5kg + 7ku] (ku upsert lanes: phase A0 and a barrier first),
// the sums
// scratch i64[G] (all zero; left all zero), and the read block i64[n, 4]
// (status, limit, remaining, reset) written.  stamps, when not null,
// u64[ctas * 2 * kStamps], takes each CTA's debug stamps.  Returns the
// launch's error, or cudaGetLastError() after it.
int guber_global_window(void* limit, void* duration, void* remaining, void* tstamp,
                        void* expire, void* algo, void* cfg_limit, void* cfg_duration,
                        void* cfg_algo, long long G, const void* control, long long n,
                        long long kg, long long ku, void* sums, long long now, void* read,
                        int ctas, void* stamps, void* stream) {
  if (G < 1 || n < 0 || kg < 0 || ku < 0 || ctas < 0 || ctas > 16) return cudaErrorInvalidValue;
  if (ctas == 0) ctas = choose_ctas(n);
  if (ctas > 8 && allow_nonportable() != cudaSuccess) return allow_nonportable();
  const GArena a{static_cast<int64_t*>(limit),  static_cast<int64_t*>(duration),
                 static_cast<int64_t*>(remaining), static_cast<int64_t*>(tstamp),
                 static_cast<int64_t*>(expire), static_cast<int32_t*>(algo),
                 static_cast<int64_t>(G)};
  const GConfig cfg{static_cast<int64_t*>(cfg_limit), static_cast<int64_t*>(cfg_duration),
                    static_cast<int32_t*>(cfg_algo)};
  const Control c{static_cast<const int64_t*>(control), static_cast<int64_t>(n),
                  static_cast<int64_t>(kg), static_cast<int64_t>(ku)};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t conf =
      window_config(2 * n, ctas, static_cast<cudaStream_t>(stream), &attr);
  auto* kernel = stamps != nullptr ? &global_window_kernel<true> : &global_window_kernel<false>;
  const cudaError_t e =
      cudaLaunchKernelEx(&conf, kernel, a, cfg, c, static_cast<int64_t*>(sums),
                         static_cast<int64_t>(now), static_cast<int64_t*>(read),
                         static_cast<unsigned long long*>(stamps));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}


// The first half of a mesh GLOBAL window in one launch of kStageThreads-
// thread CTAs, a thread a read lane, with no cluster and no barrier across
// CTAs: the control's upserts, its config writes and resets into the
// config and the arena, in place, its lanes' contributed hits added into
// the sums scratch i64[G] (all zero before; left holding them for the
// all-reduce), and the read block i64[n, 4] answered from the arena as
// the writes leave it.  Returns cudaGetLastError() after the launch.
int guber_global_stage_read(void* limit, void* duration, void* remaining, void* tstamp,
                            void* expire, void* algo, void* cfg_limit, void* cfg_duration,
                            void* cfg_algo, long long G, const void* control, long long n,
                            long long kg, long long ku, void* sums, long long now, void* read,
                            void* stream) {
  if (G < 1 || n < 0 || kg < 0 || ku < 0) return cudaErrorInvalidValue;
  long long items = n > ku ? n : ku;
  if (items < 1) items = 1;
  const long long ctas = (items + kStageThreads - 1) / kStageThreads;
  if (ctas > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  const GArena a{static_cast<int64_t*>(limit),  static_cast<int64_t*>(duration),
                 static_cast<int64_t*>(remaining), static_cast<int64_t*>(tstamp),
                 static_cast<int64_t*>(expire), static_cast<int32_t*>(algo),
                 static_cast<int64_t>(G)};
  const GConfig cfg{static_cast<int64_t*>(cfg_limit), static_cast<int64_t*>(cfg_duration),
                    static_cast<int32_t*>(cfg_algo)};
  const Control c{static_cast<const int64_t*>(control), static_cast<int64_t>(n),
                  static_cast<int64_t>(kg), static_cast<int64_t>(ku)};
  global_stage_read_kernel<<<static_cast<unsigned>(ctas), kStageThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      a, cfg, c, static_cast<int64_t*>(sums), static_cast<int64_t>(now),
      static_cast<int64_t*>(read));
  return cudaGetLastError();
}

}  // extern "C"
