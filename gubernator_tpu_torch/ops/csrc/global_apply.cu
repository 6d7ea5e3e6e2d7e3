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
// after the ranks' scratches are all-reduced, a thread per row of [G]
// applying each nonzero reduced sum and leaving the scratch all zero.  A
// rank's sums then cover slots that only another rank's lanes hit, which
// global_apply (a thread per own lane) would never visit; the TPU kernel
// reads its summed hits whole the same way.  What bounds it: the [G] sums
// read once (8 B a row), a touched row's 64 B of state and config read and
// 44 B written; at the JAX default G = 4096, launch latency.

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

__global__ void __launch_bounds__(kApplyThreads)
    global_apply_rows_kernel(GArena a, GConfig cfg, int64_t* sums, int64_t now) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row < a.G) apply_row(a, cfg, sums, now, row);
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
// config, in place, and the scratch left all zero.  Returns
// cudaGetLastError() after the launch.
int guber_global_apply_rows(void* limit, void* duration, void* remaining, void* tstamp,
                            void* expire, void* algo, void* cfg_limit, void* cfg_duration,
                            void* cfg_algo, long long G, void* sums, long long now,
                            void* stream) {
  if (G < 1 || (G + kApplyThreads - 1) / kApplyThreads > 0x7FFFFFFFll)
    return cudaErrorInvalidValue;
  global_apply_rows_kernel<<<blocks_for(G), kApplyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      arena_of(limit, duration, remaining, tstamp, expire, algo, G),
      GConfig{static_cast<int64_t*>(cfg_limit), static_cast<int64_t*>(cfg_duration),
              static_cast<int32_t*>(cfg_algo)},
      static_cast<int64_t*>(sums), static_cast<int64_t>(now));
  return cudaGetLastError();
}

}  // extern "C"
