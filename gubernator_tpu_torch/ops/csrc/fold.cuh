// The closed-form fold of a uniform segment, shared by the port's CUDA
// kernels (sm_90a).
//
// kernel.fold_entering of gubernator_tpu_torch/ops/kernel.py (the JAX
// package's int64 oracle, gubernator_tpu/ops/kernel.py:547) as device code:
// the register a lane of a foldable segment (one config, every nonzero hit
// equal, no AGG lane) enters with, in closed form from the segment's entry
// register, instead of a replay of the lanes before it.  window_drain.cu's
// walk and window_math.cu's per-lane threads take it from here, so both
// fold exactly as the oracle does.

#pragma once

#include <cstdint>

#include "ladder.cuh"

namespace {

// The closed-form ENTERING registers of a foldable segment's lanes
// (kernel.fold_entering), split in two: the constructor computes what the
// whole segment shares (every division among it) from the segment's entry
// register, its first lane's request (h0, l0, d0, a0), its leading
// zero-hit lanes n_lead and its one nonzero hit hstar; enter(pos, nz) then
// gives the lane at position pos, with nz nonzero-hit lanes before it.
struct Fold {
  Reg reg;
  bool fresh0;
  int32_t a0;
  int64_t now, now_d0, hstar, L_eff, D_eff;
  // token and concurrency acquires
  int64_t Rt, Rt_q;
  // leaky
  int64_t leak0, p_sat, Rh, Kf;
  // GCRA
  bool g_on;
  int64_t rate0, g_q, g_baset, entR_gc;
  // sliding
  bool s_on;
  int64_t s_q, s_cur_base, s_prev_ent, entT_sl;
  // concurrency releases
  int64_t c_a, c_ksat;

  __device__ Fold(const Reg& r, bool fresh, int64_t h0, int64_t l0, int64_t d0, int32_t a,
                  int64_t n_lead, int64_t hs, int64_t t)
      : reg(r), fresh0(fresh), a0(a), now(t), now_d0(add(t, d0)), hstar(hs) {
    const bool over0 = fresh0 && h0 > l0;
    L_eff = fresh0 ? l0 : reg.limit;
    D_eff = fresh0 ? d0 : reg.duration;
    const int64_t hs1 = imax(hstar, 1);
    // ---- token: balance only moves on accepts, T/E never move on hits ----
    Rt = fresh0 ? (over0 ? 0 : l0) : reg.remaining;
    Rt_q = fdiv(Rt, hs1);
    // ---- leaky: leading reads re-apply the SAME leak0, saturating ----
    rate0 = imax(fdiv(D_eff, imax(l0, 1)), 1);
    leak0 = fresh0 ? 0 : fdiv(sub(now, reg.tstamp), rate0);
    const int64_t gap = sub(L_eff, reg.remaining);
    p_sat = leak0 > 0 ? fdiv(sub(add(gap, leak0), 1), imax(leak0, 1)) : (1ll << 30);
    Rh = fresh0 ? (over0 ? 0 : l0) : satA(add(n_lead, 1));
    Kf = fdiv(Rh, hs1);
    // ---- GCRA: token-shaped fold on the TAT-derived burst capacity ----
    const int64_t g_base_nf = imax(reg.tstamp, now);
    const int64_t g_rawNF = imax(fdiv(sub(add(now, D_eff), g_base_nf), rate0), 0);
    const int64_t g_rawT = fresh0 ? (over0 ? 0 : fdiv(D_eff, rate0)) : g_rawNF;
    g_on = hstar > 0 && hstar <= L_eff;
    g_q = fdiv(g_rawT, hs1);
    g_baset = fresh0 ? (over0 ? now_d0 : now) : g_base_nf;
    entR_gc = fresh0 ? (over0 ? 0 : sub(l0, h0)) : reg.remaining;
    // ---- sliding: one roll per window, token greedy min over headroom ----
    const Roll w = sliding_roll(reg.remaining, reg.tstamp, D_eff, L_eff, now);
    const bool s_over0 = fresh0 && h0 > w.sl_L;
    const int64_t s_est_base = fresh0 ? (s_over0 ? w.sl_L : 0) : w.est;
    s_on = hstar > 0;
    s_q = fdiv(imax(sub(w.sl_L, s_est_base), 0), hs1);
    s_cur_base = fresh0 ? (s_over0 ? w.sl_L : 0) : w.cur1;
    s_prev_ent = fresh0 ? 0 : w.prev1;
    entT_sl = fresh0 ? now : w.ws1;
    // ---- concurrency: acquires fold like token; releases saturate ----
    c_a = sub(0, hstar);
    const int64_t c_gap = sub(L_eff, reg.remaining);
    c_ksat = c_gap > 0 ? fdiv(sub(add(c_gap, c_a), 1), imax(c_a, 1)) : 0;
  }

  __device__ int64_t satA(int64_t p) const {
    return p >= p_sat ? L_eff : add(reg.remaining, mul(p, leak0));
  }

  __device__ Reg enter(int64_t pos, int64_t nz) const {
    Reg e;
    e.limit = L_eff;
    e.duration = D_eff;
    e.algo = a0;
    const int64_t kt = imin(nz, Rt_q);
    const int64_t entR_tok = sub(Rt, mul(hstar, kt));
    const int64_t T_tok = fresh0 ? now_d0 : reg.tstamp;
    const int64_t E_tok = fresh0 ? now_d0 : reg.expire;
    if (a0 == kLeaky) {
      const int64_t kl = imin(nz, Kf);
      const bool drained = hstar > 0 && Rh == mul(Kf, hstar) && kl == Kf && kl >= 1;
      const int64_t gen = sub(kl, drained ? 1 : 0);
      e.remaining = (!fresh0 && nz == 0) ? satA(pos) : sub(Rh, mul(hstar, kl));
      e.tstamp = (fresh0 || nz > 0) ? now : reg.tstamp;
      e.expire = (fresh0 || gen >= 1) ? now_d0 : reg.expire;
    } else if (a0 == kGcra) {
      const int64_t g_kp = g_on ? imin(nz, g_q) : 0;
      e.remaining = entR_gc;
      e.tstamp = (g_kp > 0 || fresh0) ? add(g_baset, mul(mul(g_kp, hstar), rate0))
                                      : reg.tstamp;
      e.expire = E_tok;
    } else if (a0 == kSliding) {
      const int64_t s_kp = s_on ? imin(nz, s_q) : 0;
      const int64_t cur = add(s_cur_base, mul(s_kp, hstar));
      e.remaining = static_cast<int64_t>(static_cast<uint64_t>(cur) |
                                         static_cast<uint64_t>(shl(s_prev_ent, kSlidingPackBits)));
      e.tstamp = entT_sl;
      e.expire = (fresh0 || s_kp >= 1) ? now_d0 : reg.expire;
    } else if (a0 == kConcurrency) {
      int64_t applied = kt;
      e.remaining = entR_tok;
      if (hstar < 0) {
        applied = nz;
        e.remaining = fresh0 ? L_eff
                             : (nz == 0 ? reg.remaining
                                        : (nz >= c_ksat ? L_eff
                                                        : add(reg.remaining, mul(nz, c_a))));
      }
      e.tstamp = (fresh0 || applied >= 1) ? now : reg.tstamp;
      e.expire = (fresh0 || applied >= 1) ? now_d0 : reg.expire;
    } else {
      e.remaining = entR_tok;
      e.tstamp = T_tok;
      e.expire = E_tok;
    }
    return e;
  }
};

}  // namespace
