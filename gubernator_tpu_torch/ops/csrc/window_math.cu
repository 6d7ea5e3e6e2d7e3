// The per-op window math for Hopper (sm_90a), CUDA C++.
//
// Replaces the JAX package's Pallas kernel window_step_pallas
// (gubernator_tpu/ops/pallas_kernel.py:239; body _window_math_kernel :209,
// pallas_call :312), the GUBER_PALLAS=1 lowering of one window step.  Like
// it, this kernel computes only kernel.window_math (gubernator_tpu/ops/
// kernel.py:981, ported as gubernator_tpu_torch/ops/kernel.py window_math)
// over lanes that torch ops have already sorted by slot, split into
// virtual segments and gathered (kernel.window_prep); the scatter back to
// the arena and the un-sort stay torch ops (kernel.window_commit).  It is
// int64 throughout, as the oracle is: the TPU kernel's compact32 form
// (times rebased to the window's now in int32, for Mosaic's lack of 64-bit
// vectors) is not ported.
//
// What it computes, per window and at every valid lane, bit for bit:
//
//   * a lane of a covered segment (seg_fold, or a one-lane segment) enters
//     from the gathered register at its segment's first lane and from the
//     closed-form fold (kernel.fold_entering, fold.cuh) at the others, and
//     takes one transition; every covered lane's final register `fin` is
//     that of its segment's last lane (fin is replicated per segment);
//   * a residual irregular segment replays lane by lane from the gathered
//     register, fresh on its first lane as the segment is, and on later
//     lanes on an algorithm switch (the oracle's replay rounds), up to
//     position max_pos; a residual lane past max_pos keeps the first
//     bullet's response, as in the oracle, whose rounds stop there (the
//     prep's max_pos reaches every residual lane, so none does).
//
// Invalid lanes (s_valid false) answer 0 in every field and carry their
// gathered register as fin; window_commit writes no row for them, and the
// oracle's values there are a function of the padding, which no caller
// reads.
//
// Design.  One launch a window, over ceil(B / tile) CTAs of lane tiles
// (the per-op engine steps one shard's window at a time, as the JAX
// package's shard_map body does).  The tile width is a launch parameter
// apart from blockDim: at B = 1024 the default 32-lane tiles put each lane
// on its own thread, one warp a CTA, over 32 SMs, and the host build's
// one-thread CTAs run any width.  No lane waits for another, so there is
// no barrier, and nothing depends on the tile:
//
//   * a covered lane builds its segment's Fold (the shared terms, with
//     every division among them) from its own segment-wide inputs, enters
//     at its position and takes its transition; it then takes its
//     segment's last lane e's transition too, from e's position and
//     request and the same Fold (every lane of a segment carries the same
//     h0, l0, d0, a0, fresh_seg, n_lead, hstar and gathered register), so
//     its fin needs no lane of another CTA.  That doubles a covered lane's
//     enter and transition, not its Fold;
//   * the thread of a residual segment's first lane walks the segment
//     lane by lane, on its own, the next lane's request loaded while the
//     current one transitions; the segment's other lanes are left to it;
//   * a residual lane past max_pos (none, with the prep's max_pos) takes
//     the shared ladder's answer on its own thread.
//
// Bounds on this card.  Per lane the kernel reads 19 inputs and a gathered
// 44 B register (133 B) and writes 4 responses and 6 fin planes (72 B); at
// 1024 lanes that is 0.06 us at 3.35 TB/s.  The arithmetic is a covered
// lane's Fold (about 13 int64 floor divisions) and two transitions, every
// int64 division a few dozen 32-bit instructions, spread over one thread a
// lane; a window's time is the latency of its longest chain: the longest
// residual segment's walk, a transition per lane with the dependent
// divisions of its ladder.  The torch ops around it (the sort, the segment
// scans, the gathers, the scatter) are many launches each and cost far
// more than the kernel.

#include <cstdint>
#include <cuda_runtime.h>

#include "fold.cuh"
#include "ladder.cuh"

namespace {

// threads a CTA at most, and the default tile: lanes a CTA
constexpr int kMathThreads = 256;
constexpr int kMathTile = 32;

// The sorted-lane inputs (kernel.window_prep's outputs that window_math
// takes, in window_step_pallas's order) and the gathered registers.
struct Lanes {
  const uint8_t* valid;
  const int64_t* hits;
  const int64_t* limit;
  const int64_t* duration;
  const int32_t* algo;
  const uint8_t* init;
  const uint8_t* agg;
  const int32_t* pos;
  const int32_t* seg_len;
  const int32_t* seg_start;
  const uint8_t* fold;
  const int64_t* h0;
  const int64_t* l0;
  const int64_t* d0;
  const int32_t* a0;
  const uint8_t* fresh_seg;
  const int32_t* nz;
  const int32_t* n_lead;
  const int64_t* hstar;
  const int64_t* r_limit;
  const int64_t* r_duration;
  const int64_t* r_remaining;
  const int64_t* r_tstamp;
  const int64_t* r_expire;
  const int32_t* r_algo;

  __device__ Req req(int i) const {
    Req q;
    q.slot = 0;
    q.valid = valid[i] != 0;
    q.agg = agg[i] != 0;
    q.init = init[i] != 0;
    q.hits = hits[i];
    q.limit = limit[i];
    q.duration = duration[i];
    q.algo = algo[i];
    return q;
  }
  __device__ Reg reg(int i) const {
    return Reg{r_limit[i], r_duration[i], r_remaining[i], r_tstamp[i], r_expire[i], r_algo[i]};
  }
};

// The responses and final registers, [B] each.
struct MathOut {
  int32_t* status;
  int64_t* limit;
  int64_t* remaining;
  int64_t* reset;
  int64_t* f_limit;
  int64_t* f_duration;
  int64_t* f_remaining;
  int64_t* f_tstamp;
  int64_t* f_expire;
  int32_t* f_algo;

  __device__ void store(int i, const Out& o) const {
    status[i] = o.status;
    limit[i] = o.limit;
    remaining[i] = o.remaining;
    reset[i] = o.reset;
  }
  __device__ void store_fin(int i, const Reg& r) const {
    f_limit[i] = r.limit;
    f_duration[i] = r.duration;
    f_remaining[i] = r.remaining;
    f_tstamp[i] = r.tstamp;
    f_expire[i] = r.expire;
    f_algo[i] = r.algo;
  }
  __device__ Reg fin(int i) const {
    return Reg{f_limit[i], f_duration[i], f_remaining[i], f_tstamp[i], f_expire[i], f_algo[i]};
  }
};

__device__ __forceinline__ bool covered(const Lanes& in, int i) {
  return in.fold[i] != 0 || in.seg_len[i] == 1;
}

// the last lane of lane i's segment (kernel.window_math's eidx)
__device__ __forceinline__ int seg_end(const Lanes& in, int i, int B) {
  return static_cast<int>(clip(static_cast<int64_t>(in.seg_start[i]) + in.seg_len[i] - 1, 0,
                               B - 1));
}

// the closed-form fold of lane i's segment, from its segment-wide inputs
__device__ __forceinline__ Fold seg_fold(const Lanes& in, int i, const Reg& reg, int64_t now) {
  const bool fresh0 = in.fresh_seg[i] != 0 || in.a0[i] != reg.algo;
  return Fold(reg, fresh0, in.h0[i], in.l0[i], in.d0[i], in.a0[i], in.n_lead[i], in.hstar[i],
              now);
}

// the register lane e (a later lane of a folded segment) leaves: its
// entering register from the fold, then its transition
__device__ Reg leaves(const Fold& f, const Lanes& in, int e, int64_t now) {
  Reg r = f.enter(in.pos[e], in.nz[e]);
  transition(r, in.req(e), now, false);
  return r;
}

// a residual segment from its first lane i: the oracle's replay rounds,
// lane after lane, up to position max_pos; then every lane of the segment
// carries the last register as fin
__device__ void walk(const Lanes& in, const MathOut& out, int i, int B, int64_t now,
                     int64_t max_pos, Reg r) {
  bool fr = in.fresh_seg[i] != 0 || in.a0[i] != r.algo;
  const int len = static_cast<int>(imin(in.seg_len[i], B - i));
  const int stop = static_cast<int>(imin(len, imax(max_pos + 1, 0)));
  Req q = in.req(i);
  for (int m = 0; m < stop; ++m) {
    const Req next = in.req(i + imin(m + 1, stop - 1));
    const bool fresh = fr || q.algo != r.algo;
    out.store(i + m, transition(r, q, now, fresh));
    fr = false;
    q = next;
  }
  for (int m = 0; m < len; ++m) out.store_fin(i + m, r);
}

__device__ void math_lane(const Lanes& in, const MathOut& out, int i, int B, int64_t now,
                          int64_t max_pos) {
  const Reg reg = in.reg(i);
  if (!in.valid[i]) {
    out.store(i, Out{0, 0, 0, 0});
    out.store_fin(i, reg);
    return;
  }
  const int64_t pos = in.pos[i];
  if (!covered(in, i)) {
    if (pos == 0) {
      walk(in, out, i, B, now, max_pos, reg);
    } else if (pos > max_pos) {
      Reg ent = seg_fold(in, i, reg, now).enter(pos, in.nz[i]);
      out.store(i, transition(ent, in.req(i), now, false));
    }
    return;
  }
  const Req q = in.req(i);
  const int e = seg_end(in, i, B);
  if (pos == 0) {
    Reg ent = reg;
    out.store(i, transition(ent, q, now, in.fresh_seg[i] != 0 || q.algo != reg.algo));
    out.store_fin(i, e == i ? ent : leaves(seg_fold(in, i, reg, now), in, e, now));
    return;
  }
  const Fold f = seg_fold(in, i, reg, now);
  Reg ent = f.enter(pos, in.nz[i]);
  out.store(i, transition(ent, q, now, false));
  out.store_fin(i, e == i ? ent : leaves(f, in, e, now));
}

__global__ void __launch_bounds__(kMathThreads)
    window_math_kernel(Lanes in, MathOut out, int B, int tile, int64_t now, int64_t max_pos) {
  const int lo = blockIdx.x * tile;
  const int hi = static_cast<int>(imin(static_cast<int64_t>(lo) + tile, B));
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) math_lane(in, out, i, B, now, max_pos);
}

}  // namespace

extern "C" {

const char* guber_math_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the default lanes a CTA (the wrapper's tile when it names none)
int guber_math_default_tile() { return kMathTile; }

// kernel.window_math over one sorted window of B lanes, in CTAs of `tile`
// lanes (tile >= 1; ceil(B / tile) CTAs).  Inputs, all [B]
// (bool as u8): s_valid, s_hits i64, s_limit
// i64, s_duration i64, s_algo i32, s_init, s_agg, pos i32, seg_len i32,
// seg_start_idx i32, seg_fold, h0 i64, l0 i64, d0 i64, a0 i32, fresh_seg,
// nz i32, n_lead i32, hstar i64; the gathered registers (limit, duration,
// remaining, tstamp, expire i64, algo i32).  Writes the sorted responses
// (status i32, limit, remaining, reset i64) and the final registers (five
// i64 planes and algo i32), all [B].  Returns cudaGetLastError() after
// the launch.
int guber_window_math(long long now, long long max_pos, int B, int tile, const void* s_valid,
                      const void* s_hits, const void* s_limit, const void* s_duration,
                      const void* s_algo, const void* s_init, const void* s_agg,
                      const void* pos, const void* seg_len, const void* seg_start_idx,
                      const void* seg_fold, const void* h0, const void* l0, const void* d0,
                      const void* a0, const void* fresh_seg, const void* nz,
                      const void* n_lead, const void* hstar, const void* r_limit,
                      const void* r_duration, const void* r_remaining, const void* r_tstamp,
                      const void* r_expire, const void* r_algo, void* status, void* limit,
                      void* remaining, void* reset, void* f_limit, void* f_duration,
                      void* f_remaining, void* f_tstamp, void* f_expire, void* f_algo,
                      void* stream) {
  if (B < 1 || tile < 1) return cudaErrorInvalidValue;
  const Lanes lanes{
      static_cast<const uint8_t*>(s_valid),    static_cast<const int64_t*>(s_hits),
      static_cast<const int64_t*>(s_limit),    static_cast<const int64_t*>(s_duration),
      static_cast<const int32_t*>(s_algo),     static_cast<const uint8_t*>(s_init),
      static_cast<const uint8_t*>(s_agg),      static_cast<const int32_t*>(pos),
      static_cast<const int32_t*>(seg_len),    static_cast<const int32_t*>(seg_start_idx),
      static_cast<const uint8_t*>(seg_fold),   static_cast<const int64_t*>(h0),
      static_cast<const int64_t*>(l0),         static_cast<const int64_t*>(d0),
      static_cast<const int32_t*>(a0),         static_cast<const uint8_t*>(fresh_seg),
      static_cast<const int32_t*>(nz),         static_cast<const int32_t*>(n_lead),
      static_cast<const int64_t*>(hstar),      static_cast<const int64_t*>(r_limit),
      static_cast<const int64_t*>(r_duration), static_cast<const int64_t*>(r_remaining),
      static_cast<const int64_t*>(r_tstamp),   static_cast<const int64_t*>(r_expire),
      static_cast<const int32_t*>(r_algo)};
  const MathOut outs{static_cast<int32_t*>(status),    static_cast<int64_t*>(limit),
                     static_cast<int64_t*>(remaining), static_cast<int64_t*>(reset),
                     static_cast<int64_t*>(f_limit),   static_cast<int64_t*>(f_duration),
                     static_cast<int64_t*>(f_remaining), static_cast<int64_t*>(f_tstamp),
                     static_cast<int64_t*>(f_expire),  static_cast<int32_t*>(f_algo)};
  const int width = tile < B ? tile : B;
  const int threads = width < kMathThreads ? ((width + 31) / 32) * 32 : kMathThreads;
  const int ctas = (B + width - 1) / width;
  window_math_kernel<<<ctas, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lanes, outs, B, width, static_cast<int64_t>(now), static_cast<int64_t>(max_pos));
  return cudaGetLastError();
}

}  // extern "C"
