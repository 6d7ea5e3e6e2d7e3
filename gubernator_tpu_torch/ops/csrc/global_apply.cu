// The per-op GLOBAL window's two kernels for Hopper (sm_90a), CUDA C++:
// global_stage (phase A of global_phases.cuh) and global_apply (phase C).
//
// Replaces the JAX package's Pallas kernel global_apply_pallas
// (gubernator_tpu/ops/pallas_kernel.py:165; body _apply_kernel :138,
// pallas_call :182), the GUBER_PALLAS=1 lowering of the GLOBAL window's
// apply half, together with the XLA ops the JAX engine runs before it in
// the same executable: the config writes and resets (_apply_config,
// gubernator_tpu/core/engine.py:2645) and the per-slot sum of the lanes'
// hits (kernel.global_accumulate and the mesh psum, engine.py:2665).  The
// per-op engine keeps the JAX order: global_stage writes the window's
// upserts (an owner's broadcast; a launch of their own first, phase A0,
// so the config lanes land after them) and its config and resets, and
// sums its lanes' hits into the engine's scratch;
// the replica reads (kernel.global_read) run as torch ops on the staged
// arena, in stream order; global_apply then applies each touched slot's
// sum under its config, in place, and leaves the scratch all zero.  The
// pair computes, for any int64 input, apply_config, kernel.global_accumulate
// and kernel.global_apply (ops/global_kernel.py global_stage_plain and
// global_apply_plain) on all five algorithm ladders.
//
// What bounds it.  The TPU kernel and this file's earlier design ran every
// row of the [G] arena each window (72 B read and 44 B written a row, out
// of place) to apply hits to at most the window's distinct keys.  Here
// each kernel runs a thread per item it needs: global_stage one per
// config lane and one per lane (56 B of control read, 28 B of config
// written, one 8 B atomic), global_apply one per lane (16 B of control
// read) and a transition per touched row (its 64 B of state and config
// read, 44 B written).  Launch latency sets both kernels' time.
//
// Design.  No barrier is needed inside either kernel (the phases' order is
// the stream's), so each is a plain grid of 256-thread CTAs over its items.
// The touched rows are the contributing lanes' slots: in global_apply each
// contributing lane exchanges its slot's sum for 0 and the one that gets a
// nonzero sum applies it, so no list of touched slots is built and no lane
// order matters.
//
// Mesh mode (several processes, one arena; parallel/distributed.py) adds a
// third kernel, global_apply_rows: phase C' of global_phases.cuh, run
// after the ranks' scratches are all-reduced, applying each nonzero
// reduced sum and leaving the scratch all zero.  A rank's sums then cover
// slots that only another rank's lanes hit, which global_apply (a thread
// per own lane) would never visit; the TPU kernel reads its summed hits
// whole the same way.  What bounds it: the [G] sums read once (8 B a row),
// a touched row's 64 B of state and config read and 44 B written, and its
// ladder; at the JAX default G = 4096, launch latency.  Only rows with a
// nonzero sum load state and config, run the ladder, store the row and
// zero their sum; a zero sum is never stored.  Two instances, one launch
// of one of them, chosen from G and the card:
//
//   - one turn, when a thread a row fits the grid the card holds at once
//     (its SMs times the scan's CTAs an SM takes, about 2^17 rows on an
//     H100): straight-line, each thread loading its own row's sum.  A
//     loop around the ladder cost such a launch a quarter of its time even
//     when it ran once (PERF.md), hence no loop;
//   - the scan over that resident grid (remembered a device): each thread
//     strides through the sums in 16-byte loads, kRowsUnroll of them in
//     flight before any test; a warp that finds no nonzero sum among its
//     loads goes on (one vote), and one that does packs its nonzero rows
//     into a list in shared memory, so that its lanes share the ladders in
//     one pass whichever lanes loaded them.
//
// In the scan, a scratch that is not 16-byte aligned starts with a scalar
// head row, and an odd row left over ends it.

#include <cstdint>
#include <cuda_runtime.h>

#include "global_phases.cuh"

namespace {

constexpr int kApplyThreads = 256;

__global__ void __launch_bounds__(kApplyThreads)
    global_upsert_kernel(GArena a, GConfig cfg, Control c) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p < c.ku) upsert_item(a, cfg, c, p);
}

__global__ void __launch_bounds__(kApplyThreads)
    global_stage_kernel(GArena a, GConfig cfg, Control c, int64_t* sums) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < stage_items(c)) stage_item(a, cfg, c, sums, i);
}

__global__ void __launch_bounds__(kApplyThreads)
    global_apply_kernel(GArena a, GConfig cfg, Control c, int64_t* sums, int64_t now) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < c.n) apply_lane(a, cfg, c, sums, now, i);
}

constexpr int kRowsThreads = 256;
constexpr int kRowsUnroll = 4;

// phase C' in one turn, a thread a row, straight-line: the thread goes
// from its row's 8-byte load to its row's ladder (a 16-byte load shared by
// a lane pair measured 4-7% slower here, PERF.md)
__device__ __forceinline__ void apply_rows_turn(const GArena& a, const GConfig& cfg,
                                                int64_t* sums, int64_t now) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row < a.G) apply_row(a, cfg, sums, now, row);
}

// phase C' as a streaming scan over a grid the card holds at once: the
// scalar head and tail, then the 16-byte vectors; the rows of vector v are
// head + 2 v and head + 2 v + 1, and a thread's vectors in one turn w0 + j
// * stride + lane for j < kRowsUnroll, all loaded before any is tested.  A
// warp with no nonzero sum among its loads goes on (one vote); one with
// some packs them into a list in shared memory (an inclusive scan of the
// lanes' counts), so that lane k applies the rows listed k, k + warpSize,
// ... whichever lanes loaded them, in one ladder pass when they are at
// most warpSize.
__device__ __forceinline__ void apply_rows_scan(const GArena& a, const GConfig& cfg,
                                                int64_t* sums, int64_t now, uint32_t* list) {
  const int lane = static_cast<int>(threadIdx.x) % warpSize;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // a scratch that is not 16-byte aligned starts with a scalar head row
  const int64_t head = (reinterpret_cast<uintptr_t>(sums) & 15) != 0 ? 1 : 0;
  const int64_t nvec = (a.G - head) / 2;
  if (t == 0 && head == 1) apply_row(a, cfg, sums, now, 0);
  if (t == stride - 1 && head + 2 * nvec < a.G) apply_row(a, cfg, sums, now, a.G - 1);
  const auto* vec = reinterpret_cast<const longlong2*>(sums + head);
  for (int64_t w0 = t - lane; w0 < nvec; w0 += kRowsUnroll * stride) {
    longlong2 s[kRowsUnroll];
#pragma unroll
    for (int j = 0; j < kRowsUnroll; ++j) {
      const int64_t v = w0 + j * stride + lane;
      s[j] = v < nvec ? vec[v] : longlong2{0, 0};
    }
    // bit 2 j (2 j + 1) of mine: the first (second) row of vector j
    unsigned mine = 0;
#pragma unroll
    for (int j = 0; j < kRowsUnroll; ++j) {
      mine |= (s[j].x != 0 ? 1u : 0u) << (2 * j);
      mine |= (s[j].y != 0 ? 1u : 0u) << (2 * j + 1);
    }
    if (__ballot_sync(0xFFFFFFFFu, mine != 0) == 0) continue;
    const int count = __popc(mine);
    int incl = count;
    for (int d = 1; d < warpSize; d <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += up;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, warpSize - 1);
    int at = incl - count;
    for (; mine != 0; mine &= mine - 1) {
      const int b = __ffs(static_cast<int>(mine)) - 1;
      list[at++] = static_cast<uint32_t>(2 * ((b >> 1) * stride + lane) + (b & 1));
    }
    __syncwarp();
    for (int k = lane; k < total; k += warpSize) {
      apply_row(a, cfg, sums, now, head + 2 * w0 + list[k]);
    }
    __syncwarp();
  }
}

// phase C': in one turn (kScan false) when a thread a row fits the card at
// once, else the scan; the two are instances, since a loop around the
// ladder costs a one-turn launch time even when it runs once (PERF.md)
template <bool kScan>
__global__ void __launch_bounds__(kRowsThreads)
    global_apply_rows_kernel(GArena a, GConfig cfg, int64_t* sums, int64_t now) {
  if constexpr (kScan) {
    // a warp's nonzero rows of one turn, as offsets past head + 2 w0
    __shared__ uint32_t found[kRowsThreads / 32][64 * kRowsUnroll];
    apply_rows_scan(a, cfg, sums, now, found[threadIdx.x / warpSize]);
  } else {
    apply_rows_turn(a, cfg, sums, now);
  }
}

GArena arena_of(void* limit, void* duration, void* remaining, void* tstamp, void* expire,
                void* algo, long long G) {
  return GArena{static_cast<int64_t*>(limit),  static_cast<int64_t*>(duration),
                static_cast<int64_t*>(remaining), static_cast<int64_t*>(tstamp),
                static_cast<int64_t*>(expire), static_cast<int32_t*>(algo),
                static_cast<int64_t>(G)};
}

unsigned blocks_for(long long items) {
  return static_cast<unsigned>((items + kApplyThreads - 1) / kApplyThreads);
}

}  // namespace

#ifndef GUBER_HOST_SHIM
// global_apply_rows' resident grid on the current device: its SMs times the
// CTAs of the kernel an SM holds at once, remembered a device
static cudaError_t rows_grid_of_device(int* grid) {
  constexpr int kDevices = 64;
  static int known[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  if (known[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, global_apply_rows_kernel<true>,
                                                        kRowsThreads, 0);
    }
    if (e != cudaSuccess) return e;
    known[dev] = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  *grid = known[dev];
  return cudaSuccess;
}
#endif  // GUBER_HOST_SHIM

extern "C" {

const char* guber_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Phases A0 and A of a GLOBAL window: the control block's upserts (a launch
// of their own, when ku > 0), then its config writes and resets into the
// config (limit/duration i64[G], algo i32[G]) and the arena
// (limit/duration/remaining/tstamp/expire i64[G], algo i32[G]), in place,
// and its lanes' contributed hits added into the sums scratch i64[G].
// Returns cudaGetLastError() after the launches.
int guber_global_stage(void* limit, void* duration, void* remaining, void* tstamp,
                       void* expire, void* algo, void* cfg_limit, void* cfg_duration,
                       void* cfg_algo, long long G, const void* control, long long n,
                       long long kg, long long ku, void* sums, void* stream) {
  if (G < 1 || n < 0 || kg < 0 || ku < 0) return cudaErrorInvalidValue;
  const long long items = n + kg;
  if ((items + kApplyThreads - 1) / kApplyThreads > 0x7FFFFFFFll ||
      (ku + kApplyThreads - 1) / kApplyThreads > 0x7FFFFFFFll)
    return cudaErrorInvalidValue;
  const GArena a = arena_of(limit, duration, remaining, tstamp, expire, algo, G);
  const GConfig cfg{static_cast<int64_t*>(cfg_limit), static_cast<int64_t*>(cfg_duration),
                    static_cast<int32_t*>(cfg_algo)};
  const Control c{static_cast<const int64_t*>(control), static_cast<int64_t>(n),
                  static_cast<int64_t>(kg), static_cast<int64_t>(ku)};
  const auto s = static_cast<cudaStream_t>(stream);
  if (ku > 0) {
    global_upsert_kernel<<<blocks_for(ku), kApplyThreads, 0, s>>>(a, cfg, c);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (items > 0) {
    global_stage_kernel<<<blocks_for(items), kApplyThreads, 0, s>>>(
        a, cfg, c, static_cast<int64_t*>(sums));
  }
  return cudaGetLastError();
}

// Phase C of a GLOBAL window: each touched slot's sum applied to its arena
// row under its config, in place, and the sums scratch left all zero.  The
// same control block and scratch as the global_stage before it.  Returns
// cudaGetLastError() after the launch.
int guber_global_apply(void* limit, void* duration, void* remaining, void* tstamp,
                       void* expire, void* algo, void* cfg_limit, void* cfg_duration,
                       void* cfg_algo, long long G, const void* control, long long n,
                       long long kg, long long ku, void* sums, long long now, void* stream) {
  if (G < 1 || n < 0 || kg < 0 || ku < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if ((n + kApplyThreads - 1) / kApplyThreads > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  global_apply_kernel<<<blocks_for(n), kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      arena_of(limit, duration, remaining, tstamp, expire, algo, G),
      GConfig{static_cast<int64_t*>(cfg_limit), static_cast<int64_t*>(cfg_duration),
              static_cast<int32_t*>(cfg_algo)},
      Control{static_cast<const int64_t*>(control), static_cast<int64_t>(n),
              static_cast<int64_t>(kg), static_cast<int64_t>(ku)},
      static_cast<int64_t*>(sums), static_cast<int64_t>(now));
  return cudaGetLastError();
}


// Phase C' of a mesh GLOBAL window, after the ranks' sums scratches were
// all-reduced: every row whose reduced sum is nonzero applied under its
// config, in place, and the scratch left all zero; one launch, a thread a
// row when that fits the card's resident grid, else the scan over that
// grid.  Returns cudaGetLastError() after the launch.
int guber_global_apply_rows(void* limit, void* duration, void* remaining, void* tstamp,
                            void* expire, void* algo, void* cfg_limit, void* cfg_duration,
                            void* cfg_algo, long long G, void* sums, long long now,
                            void* stream) {
  if (G < 1) return cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t e = rows_grid_of_device(&resident);
  if (e != cudaSuccess) return e;
  const GArena a = arena_of(limit, duration, remaining, tstamp, expire, algo, G);
  const GConfig cfg{static_cast<int64_t*>(cfg_limit), static_cast<int64_t*>(cfg_duration),
                    static_cast<int32_t*>(cfg_algo)};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<int64_t*>(sums);
  const long long one_turn = (G + kRowsThreads - 1) / kRowsThreads;
  if (one_turn <= resident) {
    global_apply_rows_kernel<false><<<static_cast<unsigned>(one_turn), kRowsThreads, 0, s>>>(
        a, cfg, sp, static_cast<int64_t>(now));
  } else {
    global_apply_rows_kernel<true><<<static_cast<unsigned>(resident), kRowsThreads, 0, s>>>(
        a, cfg, sp, static_cast<int64_t>(now));
  }
  return cudaGetLastError();
}

}  // extern "C"
