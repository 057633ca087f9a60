// Discrete-event simulation kernel of the asyncflow-tpu sweep, for Hopper (sm_90a).
//
// Replaces the TPU kernel asyncflow_tpu/engines/jaxsim/pallas_engine.py,
// PallasEngine._kernel (launched by PallasEngine._get_call through
// pl.pallas_call), cut to this port's slice: one generator; CPU, IO, RAM and
// END segments; weighted endpoint pick; round-robin and least-connection LB;
// all five edge distributions with dropout; RAM admission with the
// strict-FIFO grant cascade; FIFO core handoff; pool overflow; truncation at
// max_iterations.  Its plain twin is engines/torchsim/des_reference.py; the
// two round alike because both evaluate float32 one operation at a time with
// the IEEE logf / expf / cosf / sqrtf (build with --fmad=false, without
// --use_fast_math).
//
// What bounds it on this card: neither bytes nor operations.  A scenario is a
// sequential chain of ~400k events, each depending on the last, and the sweep
// has only as many chains as scenarios (2048 at the headline shape, one warp
// per 32).  The card's memory rate and peak arithmetic rate allow far more
// than such a chain can use; the kernel is bound by the latency of one
// event (the O(P) pool argmin and the data-dependent branch), times the
// events of the longest chain in a warp.
//
// Design: one thread per scenario, 32 threads a block.  The Pallas kernel
// advanced a block of scenarios in lockstep (one event per row per
// iteration, the pool on vector lanes); since every live row handles exactly
// one event per iteration, a thread's own event counter reproduces the
// shared iteration counter, and with it every threefry counter.  The pool
// state lives in scratch allocated by the caller, laid out
// [field][slot][scenario] so that the 32 scenarios of a warp read one
// 128-byte line per slot.  Histogram and throughput rows are written
// straight to the outputs.  The per-server wait counters let the core
// handoff and the RAM cascade skip their pool scans when nobody waits;
// nothing else is specialised.  Speed is later work: a warp per scenario
// with the pool across lanes is the obvious next design.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;
constexpr int kNoTicket = 1 << 30;
constexpr float kTiny = 1e-15f;
constexpr float kTwoPi = 6.28318530717958647692f;

// event codes (engines/torchsim/params.py)
constexpr int EV_IDLE = 0;
constexpr int EV_ARRIVE_LB = 1;
constexpr int EV_ARRIVE_SRV = 2;
constexpr int EV_SEG_END = 3;
constexpr int EV_RESUME = 4;
constexpr int EV_WAIT_CPU = 5;
constexpr int EV_WAIT_RAM = 6;

// segment kinds and hop targets (compiler/plan.py)
constexpr int SEG_END = 0;
constexpr int SEG_CPU = 1;
constexpr int SEG_IO = 2;
constexpr int TARGET_SERVER = 1;
constexpr int TARGET_LB = 2;
constexpr int TARGET_CLIENT = 3;

// distribution ids (engines/torchsim/sampling.py)
constexpr int D_UNIFORM = 0;
constexpr int D_POISSON = 1;
constexpr int D_EXPONENTIAL = 2;
constexpr int D_NORMAL = 3;
constexpr int D_LOGNORMAL = 4;

}  // namespace

// Mirrored field for field by the ctypes.Structure in
// engines/torchsim/des_kernel.py: pointers first, then int32, then float32.
struct DesArgs {
  // inputs, one row per scenario
  const int32_t* k0;      // (S,) key word 0
  const int32_t* k1;      // (S,) key word 1
  const float* lam;       // (S, NW) arrival rate per user window
  const float* em;        // (S, NE) edge mean
  const float* ev;        // (S, NE) edge scale
  const float* ed;        // (S, NE) edge dropout
  // plan tables
  const int32_t* seg_kind;     // (NS*NEP*NSEGP,)
  const float* seg_dur;        // (NS*NEP*NSEGP,)
  const float* ep_ram;         // (NS*NEP,)
  const float* ep_cum;         // (NS*NEP,)
  const int32_t* edge_dist;    // (NE,)
  const int32_t* exit_edge;    // (NS,)
  const int32_t* exit_kind;    // (NS,)
  const int32_t* exit_target;  // (NS,)
  const int32_t* n_endpoints;  // (NS,)
  const int32_t* server_cores; // (NS,)
  const float* server_ram;     // (NS,)
  const int32_t* lb_edge_index;  // (max(EL,1),)
  const int32_t* lb_target;      // (max(EL,1),)
  const int32_t* entry_edges;    // (K,)
  // outputs
  int32_t* hist;   // (S, B)
  int32_t* thr;    // (S, TH)
  float* momf;     // (S, 6)
  int32_t* momi;   // (S, 5)
  int32_t* trunc;  // (S,)
  int32_t* n_events;  // (S,)
  // scratch, [field][slot][scenario] and [field][server][scenario]
  float* req_t;
  int32_t* req_ev;
  int32_t* req_srv;
  int32_t* req_ep;
  int32_t* req_seg;
  float* req_ram;
  int32_t* req_ticket;
  float* req_start;
  int32_t* req_lbslot;
  int32_t* cores_free;
  float* ram_free;
  int32_t* cpu_ticket;
  int32_t* ram_ticket;
  int32_t* cpu_wait_n;
  int32_t* ram_wait_n;
  int32_t* lb_order;
  int32_t* lb_conn;
  // geometry
  int32_t S, P, NS, NE, NEP, NSEGP, EL, NW, B, TH, K;
  int32_t max_iterations;
  int32_t entry_ev, entry_target, lb_algo, has_ram;
  float horizon, window, hist_lo, hist_scale;
};

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// One 20-round threefry2x32 block (pallas_engine.py:_threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  const int rots[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rots[(i % 2) * 4 + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// 24-bit uniform in [0, 1) (pallas_engine.py:_uniform_from_bits).
__device__ __forceinline__ float u24(uint32_t bits) {
  return (float)(int32_t)(bits >> 8) * 5.9604644775390625e-08f;
}

struct Sim {
  const DesArgs& a;
  int sid;
  uint32_t k0, k1;
  // per-scenario scalars (registers)
  float smp_now, smp_window_end, next_arrival;
  int widx;
  int lat_count, n_generated, n_dropped, n_overflow, lb_len;
  float lat_sum, lat_sumsq, lat_min, lat_max;

  __device__ Sim(const DesArgs& args, int s) : a(args), sid(s) {}

  // ---- scratch accessors ----
  __device__ __forceinline__ size_t px(int slot) const { return (size_t)slot * a.S + sid; }
  __device__ __forceinline__ size_t sx(int srv) const { return (size_t)srv * a.S + sid; }
  __device__ __forceinline__ size_t lx(int j) const { return (size_t)j * a.S + sid; }

  // table lookups: an index outside the table reads 0, as the one-hot _tab does
  __device__ __forceinline__ int itab(const int32_t* t, int n, int i) const {
    return (i >= 0 && i < n) ? t[i] : 0;
  }
  __device__ __forceinline__ float ftab(const float* t, int n, int i) const {
    return (i >= 0 && i < n) ? t[i] : 0.0f;
  }
  __device__ __forceinline__ int seg_idx(int s, int ep, int seg) const {
    return (s * a.NEP + ep) * a.NSEGP + seg;
  }
  __device__ __forceinline__ int n_seg_tab() const { return a.NS * a.NEP * a.NSEGP; }

  // ---- randomness: counter (it, site | seq << 10) ----
  __device__ __forceinline__ void pair(uint32_t it, uint32_t site, uint32_t seq, float& u0,
                                       float& u1) const {
    uint32_t x0 = it, x1 = site + (seq << 10);
    threefry2x32(k0, k1, x0, x1);
    u0 = u24(x0);
    u1 = u24(x1);
  }
  __device__ __forceinline__ float one(uint32_t it, uint32_t site, uint32_t seq) const {
    float u0, u1;
    pair(it, site, seq, u0, u1);
    return u0;
  }

  // ---- _edge_draw (no spikes) ----
  __device__ void edge_draw(uint32_t it, uint32_t site, int e, bool& dropped,
                            float& delay) const {
    const bool ok = e >= 0 && e < a.NE;
    const size_t row = (size_t)sid * a.NE + e;
    const float mean = ok ? a.em[row] : 0.0f;
    const float var = ok ? a.ev[row] : 0.0f;
    const float drop_p = ok ? a.ed[row] : 0.0f;
    const int dist = itab(a.edge_dist, a.NE, e);
    float u_drop, u;
    pair(it, site, 0, u_drop, u);
    delay = 0.0f;
    if (dist == D_UNIFORM) {
      delay = u;
    } else if (dist == D_EXPONENTIAL) {
      delay = (-mean) * logf(fmaxf(1.0f - u, kTiny));
    } else if (dist == D_NORMAL || dist == D_LOGNORMAL) {
      float u1, u2;
      pair(it, site + 1, 0, u1, u2);
      const float z = sqrtf(-2.0f * logf(fmaxf(u1, kTiny))) * cosf(kTwoPi * u2);
      const float x = mean + var * z;
      delay = dist == D_NORMAL ? fmaxf(x, 0.0f) : expf(x);
    } else if (dist == D_POISSON) {
      // exp-sum counting process: K ~ Poisson(mean) exactly
      const float limit = fmaxf(mean, kTiny);
      float acc = 0.0f;
      int k = 0;
      for (uint32_t seq = 0;; ++seq) {
        const float u_p = one(it, site + 2, seq);
        acc = acc + (-logf(fmaxf(1.0f - u_p, kTiny)));
        if (acc > limit) break;
        ++k;
      }
      delay = (float)k;
    }
    dropped = u_drop < drop_p;
  }

  // ---- _advance_arrival: window-jump exponential-gap sampler ----
  __device__ void advance_arrival(uint32_t it) {
    const float* lam_row = a.lam + (size_t)sid * a.NW;
    float now = smp_now, wend = smp_window_end, gap = 0.0f;
    int wi = widx, status = 0;
    for (uint32_t dctr = 0; status == 0; ++dctr) {
      if (now >= a.horizon) {
        status = 2;
        break;
      }
      if (now >= wend) {
        wi += 1;
        wend = now + a.window;
      }
      const int wc = min(wi, a.NW - 1);
      const float lam = wc >= 0 ? lam_row[wc] : 0.0f;
      const bool no_users = lam <= 0.0f;
      const float u = fmaxf(one(it, 200, dctr), kTiny);
      const float g = (-logf(fmaxf(1.0f - u, kTiny))) / fmaxf(lam, kTiny);
      const float ahead = now + g;
      if (no_users) {
        now = wend;
      } else if (ahead > a.horizon) {
        status = 2;
      } else if (ahead >= wend) {
        now = wend;
      } else {
        now = ahead;
        gap = g;
        status = 1;
      }
    }
    smp_now = now;
    smp_window_end = wend;
    widx = wi;
    next_arrival = status == 2 ? kInf : next_arrival + gap;
  }

  // ---- _complete ----
  __device__ void complete(float start, float finish) {
    const float lat = finish - start;
    int lbin = (int)((logf(fmaxf(lat, 1e-6f)) - a.hist_lo) * a.hist_scale);
    lbin = min(max(lbin, 0), a.B - 1);
    a.hist[(size_t)sid * a.B + lbin] += 1;
    int tbin = (int)ceilf(finish) - 1;
    tbin = min(max(tbin, 0), a.TH - 1);
    a.thr[(size_t)sid * a.TH + tbin] += 1;
    lat_count += 1;
    lat_sum = lat_sum + lat;
    lat_sumsq = lat_sumsq + lat * lat;
    lat_min = fminf(lat_min, lat);
    lat_max = fmaxf(lat_max, lat);
  }

  // first slot (lowest index) with the least ticket among slots in `ev_code`
  // on server `s`; returns kNoTicket when there is none
  __device__ int head_waiter(int ev_code, int s, int& head) const {
    int best = kNoTicket;
    head = 0;
    for (int j = 0; j < a.P; ++j) {
      const size_t x = px(j);
      if (a.req_ev[x] == ev_code && a.req_srv[x] == s) {
        const int tk = a.req_ticket[x];
        if (tk < best) {
          best = tk;
          head = j;
        }
      }
    }
    return best;
  }

  // ---- _release_ram with the strict-FIFO grant cascade ----
  __device__ void release_ram(int i, int s, float now) {
    if (!a.has_ram) return;
    const size_t xi = px(i);
    a.ram_free[sx(s)] = a.ram_free[sx(s)] + a.req_ram[xi];
    a.req_ram[xi] = 0.0f;
    while (a.ram_wait_n[sx(s)] > 0) {
      int head;
      const int tmin = head_waiter(EV_WAIT_RAM, s, head);
      const size_t xh = px(head);
      if (!(tmin < kNoTicket && a.req_ram[xh] <= a.ram_free[sx(s)])) break;
      a.req_ev[xh] = EV_RESUME;
      a.req_t[xh] = now;
      a.req_ticket[xh] = kNoTicket;
      a.ram_free[sx(s)] = a.ram_free[sx(s)] + (-a.req_ram[xh]);
      a.ram_wait_n[sx(s)] -= 1;
    }
  }

  // ---- _exit_flow ----
  __device__ void exit_flow(uint32_t it, int i, int s, float now) {
    release_ram(i, s, now);
    const int e = itab(a.exit_edge, a.NS, s);
    const int kind = itab(a.exit_kind, a.NS, s);
    const int target = itab(a.exit_target, a.NS, s);
    bool dropped;
    float delay;
    edge_draw(it, 48, e, dropped, delay);
    const float arrive = now + delay;
    const size_t xi = px(i);
    if (dropped) {
      a.req_ev[xi] = EV_IDLE;
      a.req_t[xi] = kInf;
      n_dropped += 1;
    } else if (kind == TARGET_CLIENT) {
      if (arrive < a.horizon) complete(a.req_start[xi], arrive);
      a.req_ev[xi] = EV_IDLE;
      a.req_t[xi] = kInf;
    } else if (kind == TARGET_SERVER) {
      a.req_ev[xi] = EV_ARRIVE_SRV;
      a.req_t[xi] = arrive;
      a.req_srv[xi] = target;
    } else if (kind == TARGET_LB) {
      a.req_ev[xi] = EV_ARRIVE_LB;
      a.req_t[xi] = arrive;
    }
    a.req_lbslot[xi] = -1;
  }

  // ---- _seg_start for CPU, IO and END ----
  __device__ void seg_start(uint32_t it, int i, int s, int ep, int seg, float now) {
    const int sidx = seg_idx(s, ep, seg);
    const int kind = itab(a.seg_kind, n_seg_tab(), sidx);
    const float dur = ftab(a.seg_dur, n_seg_tab(), sidx);
    const size_t xi = px(i);
    if (kind == SEG_CPU) {
      const bool can_take = a.cores_free[sx(s)] > 0 && !(a.cpu_wait_n[sx(s)] > 0);
      if (can_take) {
        a.cores_free[sx(s)] -= 1;
        a.req_ev[xi] = EV_SEG_END;
        a.req_t[xi] = now + dur;
      } else {
        a.cpu_ticket[sx(s)] += 1;
        a.cpu_wait_n[sx(s)] += 1;
        a.req_ev[xi] = EV_WAIT_CPU;
        a.req_t[xi] = kInf;
        a.req_ticket[xi] = a.cpu_ticket[sx(s)];
      }
    } else if (kind == SEG_IO) {
      a.req_ev[xi] = EV_SEG_END;
      a.req_t[xi] = now + dur;
    }
    a.req_seg[xi] = seg;
    if (kind == SEG_END) exit_flow(it, i, s, now);
  }

  // ---- _spawn_branch (one generator) ----
  __device__ void spawn(uint32_t it, float now) {
    n_generated += 1;
    bool alive = true;
    float t_cur = now;
    for (int j = 0; j < a.K; ++j) {
      bool dropped;
      float delay;
      edge_draw(it, 64 + 4 * j, a.entry_edges[j], dropped, delay);
      if (dropped) {
        n_dropped += 1;
        alive = false;
        break;
      }
      t_cur = t_cur + delay;
    }
    if (alive) {
      int slot = -1;
      for (int j = 0; j < a.P; ++j) {
        if (a.req_ev[px(j)] == EV_IDLE) {
          slot = j;
          break;
        }
      }
      if (slot >= 0) {
        const size_t x = px(slot);
        a.req_ev[x] = a.entry_ev;
        a.req_t[x] = t_cur;
        a.req_srv[x] = a.entry_target;
        a.req_start[x] = now;
        a.req_lbslot[x] = -1;
        a.req_ram[x] = 0.0f;
        a.req_ticket[x] = kNoTicket;
      } else {
        n_overflow += 1;
      }
    }
    advance_arrival(it);
  }

  // ---- _arrive_lb_branch with _lb_pick ----
  __device__ void arrive_lb(uint32_t it, int i, float now) {
    if (a.EL == 0) return;
    const size_t xi = px(i);
    if (lb_len <= 0) {
      a.req_ev[xi] = EV_IDLE;
      a.req_t[xi] = kInf;
      n_dropped += 1;
      return;
    }
    int slot;
    if (a.lb_algo == 0) {
      // round robin: take the head, rotate it to the tail of the length-prefix
      slot = a.lb_order[lx(0)];
      for (int j = 0; j < lb_len - 1; ++j) a.lb_order[lx(j)] = a.lb_order[lx(j + 1)];
      a.lb_order[lx(lb_len - 1)] = slot;
    } else {
      // least connections: first minimum of conn * EL + position
      long long best_key = 1LL << 30;
      int best = 0;
      for (int j = 0; j < a.EL; ++j) {
        long long key = 1LL << 30;
        if (j < lb_len) {
          const int o = a.lb_order[lx(j)];
          const int conn = (o >= 0 && o < a.EL) ? a.lb_conn[lx(o)] : 0;
          key = (long long)conn * a.EL + j;
        }
        if (key < best_key) {
          best_key = key;
          best = j;
        }
      }
      slot = a.lb_order[lx(best)];
    }
    const int e = itab(a.lb_edge_index, a.EL, slot);
    bool dropped;
    float delay;
    edge_draw(it, 32, e, dropped, delay);
    if (dropped) {
      a.req_ev[xi] = EV_IDLE;
      a.req_t[xi] = kInf;
      n_dropped += 1;
      return;
    }
    if (slot >= 0 && slot < a.EL) a.lb_conn[lx(slot)] += 1;
    a.req_ev[xi] = EV_ARRIVE_SRV;
    a.req_t[xi] = now + delay;
    a.req_srv[xi] = itab(a.lb_target, a.EL, slot);
    a.req_lbslot[xi] = slot;
  }

  // ---- _arrive_srv_branch: endpoint pick, RAM-first admission ----
  __device__ void arrive_srv(uint32_t it, int i, float now) {
    const size_t xi = px(i);
    const int s = a.req_srv[xi];
    if (a.EL > 0) {
      const int lbslot = a.req_lbslot[xi];
      if (lbslot >= 0 && lbslot < a.EL) a.lb_conn[lx(lbslot)] -= 1;
      a.req_lbslot[xi] = -1;
    }
    const float u = one(it, 4, 0);
    const int nep = itab(a.n_endpoints, a.NS, s);
    int ep = 0;
    for (int k = 0; k < a.NEP; ++k) {
      ep += ftab(a.ep_cum, a.NS * a.NEP, s * a.NEP + k) <= u ? 1 : 0;
    }
    ep = min(ep, nep - 1);
    a.req_ep[xi] = ep;
    if (!a.has_ram) {
      seg_start(it, i, s, ep, 0, now);
      return;
    }
    const float need = ftab(a.ep_ram, a.NS * a.NEP, s * a.NEP + ep);
    a.req_ram[xi] = need;
    const bool waiters = a.ram_wait_n[sx(s)] > 0;
    const bool granted = need <= 0.0f || (!waiters && a.ram_free[sx(s)] >= need);
    if (granted) {
      a.ram_free[sx(s)] = a.ram_free[sx(s)] + (-need);
      seg_start(it, i, s, ep, 0, now);
    } else {
      a.ram_ticket[sx(s)] += 1;
      a.ram_wait_n[sx(s)] += 1;
      a.req_ev[xi] = EV_WAIT_RAM;
      a.req_t[xi] = kInf;
      a.req_ticket[xi] = a.ram_ticket[sx(s)];
    }
  }

  // ---- _cpu_handoff (no deadlines) ----
  __device__ void cpu_handoff(int s, float now) {
    if (a.cpu_wait_n[sx(s)] > 0) {
      int j;
      if (head_waiter(EV_WAIT_CPU, s, j) < kNoTicket) {
        const size_t xj = px(j);
        const float jdur = ftab(a.seg_dur, n_seg_tab(),
                                seg_idx(a.req_srv[xj], a.req_ep[xj], a.req_seg[xj]));
        a.cpu_wait_n[sx(s)] -= 1;
        a.req_ev[xj] = EV_SEG_END;
        a.req_t[xj] = now + jdur;
        a.req_ticket[xj] = kNoTicket;
        return;
      }
    }
    a.cores_free[sx(s)] += 1;
  }

  // ---- _seg_end_branch ----
  __device__ void seg_end(uint32_t it, int i, float now) {
    const size_t xi = px(i);
    const int s = a.req_srv[xi], ep = a.req_ep[xi], seg = a.req_seg[xi];
    if (itab(a.seg_kind, n_seg_tab(), seg_idx(s, ep, seg)) == SEG_CPU) cpu_handoff(s, now);
    seg_start(it, i, s, ep, seg + 1, now);
  }

  // pool argmin over req_t, ties to the lowest slot
  __device__ __forceinline__ void pool_min(int& idx, float& t) const {
    idx = 0;
    t = a.req_t[px(0)];
    for (int j = 1; j < a.P; ++j) {
      const float v = a.req_t[px(j)];
      if (v < t) {
        t = v;
        idx = j;
      }
    }
  }

  __device__ void run() {
    k0 = (uint32_t)a.k0[sid];
    k1 = (uint32_t)a.k1[sid];
    for (int j = 0; j < a.P; ++j) {
      const size_t x = px(j);
      a.req_t[x] = kInf;
      a.req_ev[x] = EV_IDLE;
      a.req_srv[x] = 0;
      a.req_ep[x] = 0;
      a.req_seg[x] = 0;
      a.req_ram[x] = 0.0f;
      a.req_ticket[x] = kNoTicket;
      a.req_start[x] = 0.0f;
      a.req_lbslot[x] = -1;
    }
    for (int s = 0; s < a.NS; ++s) {
      a.cores_free[sx(s)] = a.server_cores[s];
      a.ram_free[sx(s)] = a.server_ram[s];
      a.cpu_ticket[sx(s)] = 0;
      a.ram_ticket[sx(s)] = 0;
      a.cpu_wait_n[sx(s)] = 0;
      a.ram_wait_n[sx(s)] = 0;
    }
    const int el = a.EL > 0 ? a.EL : 1;
    for (int j = 0; j < el; ++j) {
      a.lb_order[lx(j)] = j;
      a.lb_conn[lx(j)] = 0;
    }
    for (int b = 0; b < a.B; ++b) a.hist[(size_t)sid * a.B + b] = 0;
    for (int b = 0; b < a.TH; ++b) a.thr[(size_t)sid * a.TH + b] = 0;
    lb_len = a.EL;
    smp_now = 0.0f;
    smp_window_end = 0.0f;
    widx = -1;
    next_arrival = 0.0f;
    lat_count = n_generated = n_dropped = n_overflow = 0;
    lat_sum = lat_sumsq = lat_max = 0.0f;
    lat_min = kInf;

    advance_arrival(0);
    int nxt_i;
    float nxt_t;
    pool_min(nxt_i, nxt_t);
    int it = 1;
    int events = 0;
    while (it < a.max_iterations) {
      const float now = fminf(nxt_t, next_arrival);
      if (!(now < a.horizon)) break;
      ++events;
      if (nxt_t <= now) {
        // the pool beats an arrival at the same time
        switch (a.req_ev[px(nxt_i)]) {
          case EV_ARRIVE_LB:
            arrive_lb(it, nxt_i, now);
            break;
          case EV_ARRIVE_SRV:
            arrive_srv(it, nxt_i, now);
            break;
          case EV_RESUME:
            if (a.has_ram) {
              const size_t x = px(nxt_i);
              seg_start(it, nxt_i, a.req_srv[x], a.req_ep[x], 0, now);
            }
            break;
          case EV_SEG_END:
            seg_end(it, nxt_i, now);
            break;
          default:
            break;
        }
      } else {
        spawn(it, now);
      }
      pool_min(nxt_i, nxt_t);
      ++it;
    }
    const float t_min = fminf(nxt_t, next_arrival);
    a.trunc[sid] = (it >= a.max_iterations && t_min < a.horizon) ? 1 : 0;
    a.n_events[sid] = events;
    float* mf = a.momf + (size_t)sid * 6;
    mf[0] = lat_sum;
    mf[1] = lat_sumsq;
    mf[2] = lat_min;
    mf[3] = lat_max;
    mf[4] = 0.0f;
    mf[5] = 0.0f;
    int32_t* mi = a.momi + (size_t)sid * 5;
    mi[0] = lat_count;
    mi[1] = n_generated;
    mi[2] = n_dropped;
    mi[3] = n_overflow;
    mi[4] = 0;
  }
};

__global__ void __launch_bounds__(32) des_kernel(const DesArgs args) {
  const int sid = blockIdx.x * blockDim.x + threadIdx.x;
  if (sid >= args.S) return;
  Sim sim(args, sid);
  sim.run();
}

}  // namespace

extern "C" int des_args_size() { return (int)sizeof(DesArgs); }

// Launch on `stream` (a cudaStream_t as a pointer); returns cudaGetLastError().
extern "C" int des_launch(const DesArgs* args, void* stream) {
  const int threads = 32;
  const int blocks = (args->S + threads - 1) / threads;
  des_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
