// The GLOBAL sub-window for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel global_combined_staged
// (gubernator_tpu/ops/pallas_kernel.py:1381; body _global_kernel :1295, its
// pair-arithmetic ladder _pair_transition :1207).  It computes the int64
// oracle kernel.global_combined (gubernator_tpu/ops/kernel.py:1334, ported
// as gubernator_tpu_torch/ops/kernel.py global_combined) for any int64
// input, on all five algorithm ladders:
//
//   * every read lane (n = S x Bg lanes, all shards' GLOBAL lanes of one
//     window) takes the transition of its clipped arena row, with
//     fresh = is_init | expire < now | algo != row algo, and its hits only
//     when fresh (a cached GLOBAL read answers without spending: the hits
//     reconcile through `summed`);
//   * every arena row takes the transition under its GlobalConfig by the
//     summed hits of all shards (the mesh psum of the JAX package), with
//     fresh = expire < now | config algo != row algo, merged only where
//     summed != 0.
//
// The Pallas kernel carries only the token and leaky ladders; this one runs
// the shared ladder of ladder.cuh, so on GCRA, sliding-window and
// concurrency rows it follows the oracle where the Pallas kernel does not
// (the service refuses GLOBAL on those algorithms either way).
//
// Design.  One thread per read lane and one per arena row, in one launch:
// threads [0, n) read, threads [n, n + G) apply.  Every read must see the
// arena from before the apply (the oracle reads the pre-apply replica), so
// the new arena is written out of place into separate planes, which the
// caller swaps in; no thread writes what another reads.  The pair
// arithmetic of the TPU kernel (a Mosaic workaround for its lack of 64-bit
// vectors) is gone: the ladder runs in int64, wrapping through uint64_t,
// with explicit floor division, the leaky rate and leak divided here
// rather than hoisted.
//
// Bounds on this card.  Each arena row is read once (six planes, its
// config and its summed hits: 72 B) and written once (44 B); each read lane
// reads 33 B, gathers one row (44 B) and writes 32 B.  At G = 4096 and
// n = 2048 that is well under a megabyte, a fraction of a microsecond at
// 3.35 TB/s, and the ladder's few hundred integer operations a lane are
// less still: launch latency sets this kernel's time.
//
// Pad read lanes (slot < 0) answer 0 in all four fields; the JAX kernel
// leaves the transition of row 0 there, which no caller reads.

#include <cstdint>
#include <cuda_runtime.h>

#include "ladder.cuh"

namespace {

constexpr int kGlobalThreads = 256;

struct GArena {
  const int64_t* limit;
  const int64_t* duration;
  const int64_t* remaining;
  const int64_t* tstamp;
  const int64_t* expire;
  const int32_t* algo;

  __device__ Reg load(int64_t row) const {
    return Reg{limit[row], duration[row], remaining[row], tstamp[row], expire[row], algo[row]};
  }
};

struct GArenaOut {
  int64_t* limit;
  int64_t* duration;
  int64_t* remaining;
  int64_t* tstamp;
  int64_t* expire;
  int32_t* algo;

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
  const int64_t* limit;
  const int64_t* duration;
  const int32_t* algo;
};

struct GLanes {
  const int32_t* slot;
  const int64_t* hits;
  const int64_t* limit;
  const int64_t* duration;
  const int32_t* algo;
  const uint8_t* init;
};

__global__ void __launch_bounds__(kGlobalThreads)
    global_combined_kernel(GArena in, GConfig cfg, int64_t G, GLanes lanes, int64_t n,
                           const int64_t* __restrict__ summed, int64_t now, GArenaOut out,
                           int64_t* __restrict__ read) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    // ---- read half: kernel.global_read on lane i ----
    int64_t* o = read + 4 * i;
    const int32_t raw = lanes.slot[i];
    if (raw < 0) {
      o[0] = o[1] = o[2] = o[3] = 0;
      return;
    }
    Reg r = in.load(imin(raw, G - 1));
    Req q;
    q.slot = raw;
    q.valid = true;
    q.agg = false;
    q.init = lanes.init[i] != 0;
    q.limit = lanes.limit[i];
    q.duration = lanes.duration[i];
    q.algo = lanes.algo[i];
    const bool fresh = q.init || r.expire < now || q.algo != r.algo;
    q.hits = fresh ? lanes.hits[i] : 0;
    const Out res = transition(r, q, now, fresh);
    o[0] = res.status;
    o[1] = res.limit;
    o[2] = res.remaining;
    o[3] = res.reset;
  } else if (i < n + G) {
    // ---- apply half: kernel.global_apply on row j ----
    const int64_t j = i - n;
    Reg r = in.load(j);
    const int64_t h = summed[j];
    if (h != 0) {
      Req q;
      q.slot = static_cast<int32_t>(j);
      q.valid = true;
      q.agg = false;
      q.init = false;
      q.hits = h;
      q.limit = cfg.limit[j];
      q.duration = cfg.duration[j];
      q.algo = cfg.algo[j];
      const bool fresh = r.expire < now || q.algo != r.algo;
      transition(r, q, now, fresh);
    }
    out.store(j, r);
  }
}

}  // namespace

extern "C" {

const char* guber_global_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One GLOBAL sub-window: the arena (limit/duration/remaining/tstamp/expire
// i64[G], algo i32[G]), its config (limit/duration i64[G], algo i32[G]),
// n read lanes (slot i32, hits/limit/duration i64, algo i32, is_init u8) and
// the summed hits i64[G].  Writes the new arena into the six out planes
// (which must not alias the arena) and the read block i64[n, 4] (status,
// limit, remaining, reset).  Returns cudaGetLastError() after the launch.
int guber_global_combined(const void* limit, const void* duration, const void* remaining,
                          const void* tstamp, const void* expire, const void* algo,
                          const void* cfg_limit, const void* cfg_duration,
                          const void* cfg_algo, long long G, const void* slot,
                          const void* hits, const void* limit_in, const void* duration_in,
                          const void* algo_in, const void* init, long long n,
                          const void* summed, long long now, void* out_limit,
                          void* out_duration, void* out_remaining, void* out_tstamp,
                          void* out_expire, void* out_algo, void* read, void* stream) {
  if (G < 1 || n < 0) return cudaErrorInvalidValue;
  const long long total = n + G;
  const long long blocks = (total + kGlobalThreads - 1) / kGlobalThreads;
  if (blocks > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  const GArena in{static_cast<const int64_t*>(limit), static_cast<const int64_t*>(duration),
                  static_cast<const int64_t*>(remaining), static_cast<const int64_t*>(tstamp),
                  static_cast<const int64_t*>(expire), static_cast<const int32_t*>(algo)};
  const GConfig cfg{static_cast<const int64_t*>(cfg_limit),
                    static_cast<const int64_t*>(cfg_duration),
                    static_cast<const int32_t*>(cfg_algo)};
  const GLanes lanes{static_cast<const int32_t*>(slot), static_cast<const int64_t*>(hits),
                     static_cast<const int64_t*>(limit_in),
                     static_cast<const int64_t*>(duration_in),
                     static_cast<const int32_t*>(algo_in), static_cast<const uint8_t*>(init)};
  const GArenaOut out{static_cast<int64_t*>(out_limit), static_cast<int64_t*>(out_duration),
                      static_cast<int64_t*>(out_remaining), static_cast<int64_t*>(out_tstamp),
                      static_cast<int64_t*>(out_expire), static_cast<int32_t*>(out_algo)};
  global_combined_kernel<<<static_cast<unsigned>(blocks), kGlobalThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      in, cfg, static_cast<int64_t>(G), lanes, static_cast<int64_t>(n),
      static_cast<const int64_t*>(summed), static_cast<int64_t>(now), out,
      static_cast<int64_t*>(read));
  return cudaGetLastError();
}

}  // extern "C"
