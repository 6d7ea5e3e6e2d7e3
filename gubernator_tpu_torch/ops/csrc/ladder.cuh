// The transition ladder shared by the port's CUDA kernels (sm_90a).
//
// kernel.transition of gubernator_tpu_torch/ops/kernel.py (the JAX
// package's int64 oracle, gubernator_tpu/ops/kernel.py) as device code:
// one request applied to one bucket register through the five-algorithm
// ladder, with the integer helpers it needs.  window_drain.cu walks each
// slot's run of lanes through it; global_window.cu runs it once per GLOBAL
// read lane and once per GLOBAL arena row.  One copy, so the drain and the
// GLOBAL sub-window run the same ladder, as the JAX package's
// kernel.transition serves both.
//
// Integer semantics: all int64 arithmetic wraps (done in uint64_t), and
// every `//` of the oracle is a floor division (C truncates).  Any algorithm
// value outside 0..4 takes the token ladder.

#pragma once

#include <cstdint>

namespace {

constexpr int32_t kToken = 0;
constexpr int32_t kLeaky = 1;
constexpr int32_t kGcra = 2;
constexpr int32_t kSliding = 3;
constexpr int32_t kConcurrency = 4;
constexpr int64_t kSlidingPackBits = 15;
constexpr int64_t kSlidingMaxLimit = (1 << 15) - 1;
constexpr int64_t kSlidingWeightQ = 1024;

__device__ __forceinline__ int64_t add(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) + static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t sub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) - static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t mul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) * static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t shl(int64_t a, int s) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) << s);
}
// floor division; every divisor the ladder uses is >= 1
__device__ __forceinline__ int64_t fdiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t clip(int64_t x, int64_t lo, int64_t hi) {
  return imin(imax(x, lo), hi);
}

struct Reg {
  int64_t limit, duration, remaining, tstamp, expire;
  int32_t algo;
};

struct Req {
  int32_t slot;  // clean slot (AGG bit stripped); < 0 on pad lanes
  bool valid, agg, init;
  int64_t hits, limit, duration;
  int32_t algo;
};

struct Out {
  int32_t status;
  int64_t limit, remaining, reset;
};

// A sliding-window register advanced to the window holding now
// (kernel._sliding_roll).
struct Roll {
  int64_t prev1, cur1, ws1, est, sl_L, maxD;
};

__device__ Roll sliding_roll(int64_t R, int64_t T, int64_t D, int64_t L, int64_t now) {
  Roll o;
  o.sl_L = imin(L, kSlidingMaxLimit);
  const int64_t cur = R & kSlidingMaxLimit;
  const int64_t prev = (R >> kSlidingPackBits) & kSlidingMaxLimit;
  o.maxD = imax(D, 1);
  const int64_t k = imax(fdiv(sub(now, T), o.maxD), 0);
  o.prev1 = k == 0 ? prev : (k == 1 ? cur : 0);
  o.cur1 = k == 0 ? cur : 0;
  o.ws1 = add(T, mul(k, o.maxD));
  const int64_t offc = clip(sub(now, o.ws1), 0, o.maxD);
  int64_t pos_q = o.maxD <= kSlidingWeightQ
                      ? fdiv(mul(offc, kSlidingWeightQ), o.maxD)
                      : imin(fdiv(offc, imax(fdiv(o.maxD, kSlidingWeightQ), 1)),
                             kSlidingWeightQ);
  pos_q = clip(pos_q, 0, kSlidingWeightQ);
  o.est = add(fdiv(mul(o.prev1, kSlidingWeightQ - pos_q), kSlidingWeightQ), o.cur1);
  return o;
}

// One request applied to one bucket: kernel.transition, branch for branch
// (reference algorithms.go:24-186 plus the GCRA / sliding / concurrency
// ladders).  Updates r in place and returns the response.
__device__ Out transition(Reg& r, const Req& q, int64_t now, bool fresh) {
  const int64_t h = q.hits;
  const int32_t a = q.algo;
  const bool is_token = a == kToken;
  const bool is_leaky = a == kLeaky;
  const bool is_gcra = a == kGcra;
  const bool is_sliding = a == kSliding;
  const bool is_conc = a == kConcurrency;
  const int64_t L = r.limit, D = r.duration, R = r.remaining, T = r.tstamp, E = r.expire;
  // leaky's rate (stored duration over REQUEST limit, clamped to >= 1) and
  // leaked balance: read by the leaky and GCRA ladders and by AGG lanes
  const int64_t rate = imax(fdiv(D, imax(q.limit, 1)), 1);
  const int64_t R2 = add(R, imin(fdiv(sub(now, T), rate), sub(L, R)));
  Out o;
  Reg n = r;

  if (fresh) {
    // ---- init path (cache miss) ----
    const int64_t rate_q = imax(fdiv(q.duration, imax(q.limit, 1)), 1);
    const int64_t sl_l0 = imin(q.limit, kSlidingMaxLimit);
    const int64_t eff = is_sliding ? sl_l0 : q.limit;
    const bool conc_rel0 = is_conc && h < 0;
    const bool over = h > eff && !conc_rel0;
    const int64_t init_R = conc_rel0 ? eff : (over ? 0 : sub(eff, h));
    n.limit = q.limit;
    n.duration = q.duration;
    n.remaining = is_sliding ? (over ? sl_l0 : imax(h, 0)) : init_R;
    if (is_leaky || is_sliding || is_conc) {
      n.tstamp = now;
    } else if (is_gcra) {
      n.tstamp = over ? add(now, q.duration) : add(now, mul(h, rate_q));
    } else {
      n.tstamp = add(now, q.duration);
    }
    n.expire = add(now, q.duration);
    n.algo = a;
    o.status = over ? 1 : 0;
    o.limit = q.limit;
    o.remaining = init_R;
    if (is_leaky || is_conc) {
      o.reset = 0;
    } else if (is_gcra) {
      o.reset = over ? add(now, rate_q) : add(now, mul(h, rate_q));
    } else {
      o.reset = add(now, q.duration);
    }
  } else if (is_leaky) {
    // ---- leaky bucket hit path: algorithms.go:107-158 ----
    int64_t nR = R2, resp, reset = 0;
    bool hit = false;
    if (R2 == 0) {
      o.status = 1; resp = 0; reset = add(now, rate);
    } else if (h == R2) {
      o.status = 0; resp = 0; nR = 0;
    } else if (h > R2) {
      o.status = 1; resp = R2; reset = add(now, rate);
    } else if (h == 0) {
      o.status = 0; resp = R2;
    } else {
      o.status = 0; resp = sub(R2, h); nR = sub(R2, h); hit = true;
    }
    n.remaining = nR;
    n.tstamp = h != 0 ? now : T;
    n.expire = hit ? add(now, q.duration) : E;
    o.limit = L;
    o.remaining = resp;
    o.reset = reset;
  } else if (is_gcra) {
    // ---- GCRA hit path: TAT arithmetic on the tstamp column ----
    const int64_t base = imax(T, now);
    const int64_t cap = imin(imax(fdiv(sub(add(now, D), base), rate), 0), L);
    const int64_t consumed = add(base, mul(h, rate));
    if (cap == 0) {
      o.status = 1; o.remaining = 0; o.reset = add(now, rate);
    } else if (h == 0) {
      o.status = 0; o.remaining = cap; o.reset = base;
    } else if (h == cap) {
      o.status = 0; o.remaining = 0; o.reset = consumed; n.tstamp = consumed;
    } else if (h > cap) {
      o.status = 1; o.remaining = cap; o.reset = add(now, rate);
    } else {
      o.status = 0; o.remaining = sub(cap, h); o.reset = consumed; n.tstamp = consumed;
    }
    o.limit = L;
  } else if (is_sliding) {
    // ---- sliding window: roll to the window holding now, interpolate ----
    const Roll w = sliding_roll(R, T, D, L, now);
    const int64_t sl_L = w.sl_L, prev1 = w.prev1, cur1 = w.cur1, ws1 = w.ws1;
    const int64_t maxD = w.maxD, est = w.est;
    bool accept = false;
    if (est >= sl_L) {
      o.status = 1; o.remaining = 0;
    } else if (h == 0) {
      o.status = 0; o.remaining = sub(sl_L, est);
    } else if (add(est, h) > sl_L) {
      o.status = 1; o.remaining = sub(sl_L, est);
    } else {
      o.status = 0; o.remaining = sub(sub(sl_L, est), h); accept = true;
    }
    const int64_t cur2 = accept ? add(cur1, h) : cur1;
    n.remaining = static_cast<int64_t>(static_cast<uint64_t>(cur2) |
                                       static_cast<uint64_t>(shl(prev1, kSlidingPackBits)));
    n.tstamp = ws1;
    n.expire = accept ? add(now, q.duration) : E;
    o.limit = L;
    o.reset = add(ws1, maxD);
  } else if (is_conc) {
    // ---- concurrency: acquire (token ladder) or saturating release ----
    bool mut = false;
    int64_t nR = R;
    if (h < 0) {
      nR = add(R, imin(sub(0, h), sub(L, R)));
      o.status = 0; o.remaining = nR; mut = true;
    } else if (R == 0) {
      o.status = 1; o.remaining = 0;
    } else if (h == 0) {
      o.status = 0; o.remaining = R;
    } else if (h > R) {
      o.status = 1; o.remaining = R;
    } else {
      nR = sub(R, h);
      o.status = 0; o.remaining = nR; mut = true;
    }
    n.remaining = nR;
    n.tstamp = mut ? now : T;
    n.expire = mut ? add(now, q.duration) : E;
    o.limit = L;
    o.reset = 0;
  } else {
    // ---- token bucket (and any out-of-range algorithm): algorithms.go:40-65
    if (R == 0) {
      o.status = 1; o.remaining = 0;
    } else if (h == 0) {
      o.status = 0; o.remaining = R;
    } else if (h == R) {
      o.status = 0; o.remaining = 0; n.remaining = 0;
    } else if (h > R) {
      o.status = 1; o.remaining = R;
    } else {
      o.status = 0; o.remaining = sub(R, h); n.remaining = sub(R, h);
    }
    o.limit = L;
    o.reset = T;
  }

  if (q.agg) {
    // ---- aggregated run: n sequential hits=1 transitions in one lane ----
    const int64_t base =
        fresh ? q.limit : (is_token ? R : R2);
    const int64_t aL = fresh ? q.limit : L;
    const int64_t aD = fresh ? q.duration : D;
    const int64_t k = imin(h, base);
    const int64_t aR = sub(base, k);
    const int64_t a_rate = imax(fdiv(aD, imax(q.limit, 1)), 1);
    const bool extended = sub(k, aR == 0 ? 1 : 0) >= 1;
    const int64_t tok_T = fresh ? add(now, q.duration) : T;
    n.limit = aL;
    n.duration = aD;
    n.remaining = aR;
    n.tstamp = is_token ? tok_T : now;
    n.expire = is_token ? (fresh ? add(now, q.duration) : E)
                        : ((fresh || extended) ? add(now, q.duration) : E);
    n.algo = a;
    o.status = k < h ? 1 : 0;
    o.limit = aL;
    o.remaining = base;
    o.reset = is_token ? tok_T : add(now, a_rate);
  }
  r = n;
  return o;
}

}  // namespace
