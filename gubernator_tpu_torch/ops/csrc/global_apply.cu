// The per-op GLOBAL apply for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel global_apply_pallas
// (gubernator_tpu/ops/pallas_kernel.py:165; body _apply_kernel :138,
// pallas_call :182), the GUBER_PALLAS=1 lowering of the GLOBAL window's
// apply half.  It computes the int64 oracle kernel.global_apply
// (gubernator_tpu/ops/kernel.py:1304, ported as gubernator_tpu_torch/ops/
// kernel.py global_apply) for any int64 input, on all five algorithm
// ladders: every row of the [G] GLOBAL arena takes the transition under its
// GlobalConfig by the summed hits of all shards, with fresh = expire < now
// | config algo != row algo, merged only where the sum is nonzero.  The
// replica reads (kernel.global_read) stay torch ops before it, in stream
// order, as they are XLA beside the TPU kernel.
//
// Design.  One thread per arena row over all G rows, no grid shape to keep
// (the TPU kernel's 1024-row blocks were a BlockSpec tiling; here the last
// block masks its ragged edge, so G need not be a multiple of anything).
// Each thread reads its state row, its config row and its summed hits,
// runs the shared int64 ladder of ladder.cuh, and writes its row back.  A
// row is read and written only by its own thread, so the kernel runs in
// place (out planes equal to the input planes) as well as out of place;
// the wrapper (ops/global_kernel.py global_apply) writes out of place.
//
// Bounds on this card.  Each row reads 44 B of state, 20 B of config and
// 8 B of summed hits and writes 44 B: at G = 4096 under half a megabyte,
// about 0.14 us at 3.35 TB/s; the ladder's ~200 32-bit operations a row are
// less still.  Launch latency sets the time.

#include <cstdint>
#include <cuda_runtime.h>

#include "ladder.cuh"

namespace {

constexpr int kApplyThreads = 256;

// the six planes of the arena: T = const int64_t for the input, int64_t
// for the output (A likewise for algo)
template <class T, class A>
struct Planes {
  T* limit;
  T* duration;
  T* remaining;
  T* tstamp;
  T* expire;
  A* algo;
};

__global__ void __launch_bounds__(kApplyThreads)
    global_apply_kernel(Planes<const int64_t, const int32_t> in, const int64_t* cfg_limit,
                        const int64_t* cfg_duration, const int32_t* cfg_algo, const int64_t* summed, int64_t G, int64_t now,
                        Planes<int64_t, int32_t> out) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= G) return;
  Reg r{in.limit[j], in.duration[j], in.remaining[j], in.tstamp[j], in.expire[j], in.algo[j]};
  const int64_t h = summed[j];
  if (h != 0) {
    Req q;
    q.slot = static_cast<int32_t>(j);
    q.valid = true;
    q.agg = false;
    q.init = false;
    q.hits = h;
    q.limit = cfg_limit[j];
    q.duration = cfg_duration[j];
    q.algo = cfg_algo[j];
    transition(r, q, now, r.expire < now || q.algo != r.algo);
  }
  out.limit[j] = r.limit;
  out.duration[j] = r.duration;
  out.remaining[j] = r.remaining;
  out.tstamp[j] = r.tstamp;
  out.expire[j] = r.expire;
  out.algo[j] = r.algo;
}

}  // namespace

extern "C" {

const char* guber_apply_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// kernel.global_apply over the G rows of the GLOBAL arena (limit/duration/
// remaining/tstamp/expire i64[G], algo i32[G]) under its config (limit/
// duration i64[G], algo i32[G]) by the summed hits i64[G].  Writes the six
// out planes, which may be the input planes.  Returns cudaGetLastError()
// after the launch.
int guber_global_apply(const void* limit, const void* duration, const void* remaining,
                       const void* tstamp, const void* expire, const void* algo,
                       const void* cfg_limit, const void* cfg_duration, const void* cfg_algo,
                       const void* summed, long long G, long long now, void* out_limit,
                       void* out_duration, void* out_remaining, void* out_tstamp,
                       void* out_expire, void* out_algo, void* stream) {
  if (G < 1) return cudaErrorInvalidValue;
  const long long blocks = (G + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  const Planes<const int64_t, const int32_t> in{
      static_cast<const int64_t*>(limit),  static_cast<const int64_t*>(duration),
      static_cast<const int64_t*>(remaining), static_cast<const int64_t*>(tstamp),
      static_cast<const int64_t*>(expire), static_cast<const int32_t*>(algo)};
  const Planes<int64_t, int32_t> out{
      static_cast<int64_t*>(out_limit),     static_cast<int64_t*>(out_duration),
      static_cast<int64_t*>(out_remaining), static_cast<int64_t*>(out_tstamp),
      static_cast<int64_t*>(out_expire),    static_cast<int32_t*>(out_algo)};
  global_apply_kernel<<<static_cast<unsigned>(blocks), kApplyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int64_t*>(cfg_limit), static_cast<const int64_t*>(cfg_duration),
      static_cast<const int32_t*>(cfg_algo), static_cast<const int64_t*>(summed),
      static_cast<int64_t>(G), static_cast<int64_t>(now), out);
  return cudaGetLastError();
}

}  // extern "C"
