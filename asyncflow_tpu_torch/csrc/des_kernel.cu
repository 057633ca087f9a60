// Discrete-event simulation kernel of the asyncflow-tpu sweep, for Hopper (sm_90a).
//
// Replaces the TPU kernel asyncflow_tpu/engines/jaxsim/pallas_engine.py,
// PallasEngine._kernel (launched by PallasEngine._get_call through
// pl.pallas_call), every piece of it: one generator or several superposed
// streams (each with its own arrival sampler, entry chain and block of the
// arrival-rate table; the earliest next arrival spawns); CPU, IO, RAM and
// END segments; cache hit/miss mixtures; LLM calls whose sleep and cost
// grow with Poisson output tokens (the exp-sum counting process); io_db
// segments holding one of a server's K FIFO DB connections (acquire, wait,
// hand-off); weighted endpoint pick; round-robin and least-connection LB;
// all five edge distributions with dropout and network spikes (a
// breakpoint table per edge, looked up at the send time); the outage
// timeline (_timeline_branch: an LB slot leaves the rotation with
// _rot_remove and re-enters at its tail with _rot_insert); the per-slot LB
// circuit breaker (_breaker_report, _breaker_server_report,
// _lb_pick_breaker); the overload controls (ready-queue shed in _seg_start,
// token bucket and connection cap in _arrive_srv_branch, dequeue deadline
// in _cpu_handoff with _abandon_branch); RAM admission with the strict-FIFO
// grant cascade; FIFO core handoff; pool overflow; truncation at
// max_iterations.  Its plain twin is engines/torchsim/des_reference.py; the
// two round alike because both evaluate float32 one operation at a time with
// the IEEE logf / expf / cosf / sqrtf (build with --fmad=false, without
// --use_fast_math).
//
// The features are compiled in only where the plan has them, as the
// reference's static _has_* flags do: the kernel is a template on three
// flags, kEvents (timeline and spikes), kControls (the overload controls
// and the breaker) and kWorkload (cache, LLM, DB pools and several
// generators), and des_launch picks the instance from the plan's counts.
// The source is built twice, with DES_WORKLOAD 0 and 1, into two libraries
// (one nvcc each, run in parallel), each holding the four instances of its
// kWorkload; the wrapper loads the library the plan needs.  Inside an
// instance each feature is still guarded by its own plan flag (a table
// count, a has_* flag, the breaker threshold or the generator count), and
// its tables and scratch are null when the plan does not model it.  A plan
// with none of the groups runs the slice-1 code alone: compiled in but never
// taken, the new branches slowed the headline's kernel on the card, as a
// latency-bound thread pays for every instruction and register of its
// loop.  A timeline entry is an iteration of its own: the loop takes it
// before the pool and the pool before an arrival, and the thread's
// iteration counter advances on it as on any event.
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
// beyond that and the two feature groups, nothing is specialised.  Speed is
// later work: a warp per scenario with the pool across lanes is the obvious
// next design.

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
constexpr int EV_WAIT_DB = 7;
constexpr int EV_ABANDON = 8;

// columns of the work output (engines/torchsim/des_reference.py:WORK_KINDS):
// the work of the optional features, counted only in the instances that
// compile them in (a counter on every event slowed the headline's kernel)
enum Work {
  W_TIMELINE,
  W_REFILL,
  W_BREAKER,
  W_ABANDON,
  W_LLM_DRAWS,
  W_CACHE,
  W_DB_WAIT,
  W_DB_GRANT,
  N_WORK
};

// circuit-breaker states
constexpr int CB_CLOSED = 0;
constexpr int CB_OPEN = 1;
constexpr int CB_HALF_OPEN = 2;

// segment kinds and hop targets (compiler/plan.py)
constexpr int SEG_END = 0;
constexpr int SEG_CPU = 1;
constexpr int SEG_IO = 2;
constexpr int SEG_DB = 3;
constexpr int SEG_CACHE = 4;
constexpr int SEG_LLM = 5;
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
  // optional plan tables, null when the feature is not modelled
  const float* spike_times;      // (NB,)
  const float* spike_vals;       // (NB*NE,)
  const float* tl_times;         // (NTL,)
  const int32_t* tl_down;        // (NTL,)
  const int32_t* tl_slot;        // (NTL,)
  const int32_t* queue_cap;      // (NS,)
  const int32_t* conn_cap;       // (NS,)
  const float* rate_limit;       // (NS,)
  const float* rate_burst;       // (NS,)
  const float* queue_timeout;    // (NS,)
  const float* seg_hit_prob;     // (NS*NEP*NSEGP,), cache
  const float* seg_miss_dur;     // (NS*NEP*NSEGP,), cache
  const float* seg_llm_tokens;   // (NS*NEP*NSEGP,), LLM
  const float* seg_llm_tpt;      // (NS*NEP*NSEGP,), LLM
  const float* seg_llm_cost;     // (NS*NEP*NSEGP,), LLM
  const int32_t* db_pool;        // (NS,) connections, 2^30 = unlimited
  const int32_t* gen_entry_edges;   // (G*L,) with G > 1 generators
  const int32_t* gen_entry_len;     // (G,)
  const int32_t* gen_entry_ev;      // (G,)
  const int32_t* gen_entry_target;  // (G,)
  const float* gen_window;          // (G,)
  const int32_t* gen_lam_off;       // (G,) first column of the lam block
  const int32_t* gen_nw;            // (G,) columns of the lam block
  // outputs
  int32_t* hist;   // (S, B)
  int32_t* thr;    // (S, TH)
  float* momf;     // (S, 6)
  int32_t* momi;   // (S, 5)
  int32_t* trunc;  // (S,)
  int32_t* n_events;  // (S,)
  int32_t* work;      // (S, N_WORK)
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
  // optional scratch, null when the feature is not modelled
  float* req_wait_t;      // [slot], deadline
  int32_t* req_cbslot;    // [slot], breaker
  int32_t* req_probe;     // [slot], breaker
  int32_t* srv_conn;      // [server], connection cap
  float* rl_tokens;       // [server], rate limit
  float* rl_last;         // [server], rate limit
  int32_t* cb_state;      // [lb slot], breaker
  float* cb_open_until;   // [lb slot]
  int32_t* cb_consec;     // [lb slot]
  int32_t* cb_probes_out; // [lb slot]
  int32_t* cb_probe_ok;   // [lb slot]
  float* req_llm;         // [slot], LLM cost accrued
  int32_t* db_free;       // [server], DB pool
  int32_t* db_ticket;     // [server]
  int32_t* db_wait_n;     // [server]
  float* gen_now;         // [generator], G > 1: arrival sampler clocks
  float* gen_wend;        // [generator]
  int32_t* gen_widx;      // [generator]
  float* gen_next;        // [generator]
  // geometry
  int32_t S, P, NS, NE, NEP, NSEGP, EL, NW, B, TH, K;
  int32_t max_iterations;
  int32_t entry_ev, entry_target, lb_algo, has_ram;
  int32_t NB, NTL;  // spike breakpoints, timeline entries (0 = none)
  int32_t has_shed, has_conn, has_rl, has_timeout;
  int32_t cb_threshold, cb_probes;  // cb_threshold 0 = no breaker
  int32_t G, L;  // generators, their longest entry chain (L: G > 1 only)
  int32_t has_cache, has_llm, has_db;
  float horizon, window, hist_lo, hist_scale;
  float cb_cooldown;
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

template <bool kEvents, bool kControls, bool kWorkload>
struct Sim {
  const DesArgs& a;
  int sid;
  uint32_t k0, k1;
  // per-scenario scalars (registers); with several generators,
  // next_arrival is the earliest of theirs and gsel its generator
  float smp_now, smp_window_end, next_arrival;
  int widx, gsel;
  int lat_count, n_generated, n_dropped, n_overflow, n_rejected, lb_len, tl_ptr;
  float lat_sum, lat_sumsq, lat_min, lat_max, llm_sum, llm_sumsq;
  int work[N_WORK];  // indexed by constants only, so it stays in registers

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

  // ---- _edge_draw: the delay gains the spike in force at t_send ----
  __device__ void edge_draw(uint32_t it, uint32_t site, int e, float t_send, bool& dropped,
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
    if (kEvents && a.NB > 0) {
      // breakpoint: the last spike time at or before t_send (the first is 0)
      int bp = -1;
      for (int k = 0; k < a.NB; ++k) bp += a.spike_times[k] <= t_send ? 1 : 0;
      delay = delay + ftab(a.spike_vals, a.NB * a.NE, bp * a.NE + e);
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

  // ---- _advance_arrival of generator g of several: its state in scratch,
  // its own block of the rate table, window and draw site 200 + g; then
  // the earliest next arrival over the generators (lowest index on ties) ----
  __device__ void advance_arrival_gen(uint32_t it, int g) {
    const size_t gx = (size_t)g * a.S + sid;
    const float* lam_row = a.lam + (size_t)sid * a.NW + a.gen_lam_off[g];
    const int nw = a.gen_nw[g];
    const float window = a.gen_window[g];
    float now = a.gen_now[gx], wend = a.gen_wend[gx], gap = 0.0f;
    int wi = a.gen_widx[gx], status = 0;
    for (uint32_t dctr = 0; status == 0; ++dctr) {
      if (now >= a.horizon) {
        status = 2;
        break;
      }
      if (now >= wend) {
        wi += 1;
        wend = now + window;
      }
      const int wc = min(wi, nw - 1);
      const float lam = wc >= 0 ? lam_row[wc] : 0.0f;
      const bool no_users = lam <= 0.0f;
      const float u = fmaxf(one(it, 200 + g, dctr), kTiny);
      const float gp = (-logf(fmaxf(1.0f - u, kTiny))) / fmaxf(lam, kTiny);
      const float ahead = now + gp;
      if (no_users) {
        now = wend;
      } else if (ahead > a.horizon) {
        status = 2;
      } else if (ahead >= wend) {
        now = wend;
      } else {
        now = ahead;
        gap = gp;
        status = 1;
      }
    }
    a.gen_now[gx] = now;
    a.gen_wend[gx] = wend;
    a.gen_widx[gx] = wi;
    a.gen_next[gx] = status == 2 ? kInf : a.gen_next[gx] + gap;
    gsel = 0;
    next_arrival = a.gen_next[sid];
    for (int h = 1; h < a.G; ++h) {
      const float v = a.gen_next[(size_t)h * a.S + sid];
      if (v < next_arrival) {
        next_arrival = v;
        gsel = h;
      }
    }
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

  // ---- LB rotation: remove a slot, or re-insert it at the tail ----
  __device__ __forceinline__ int lb_width() const { return a.EL > 0 ? a.EL : 1; }

  // _rot_remove: lanes at and past the slot shift left (those past lb_len
  // too; the last lane keeps its value)
  __device__ void rot_remove(int slot) {
    const int el = lb_width();
    int at = el;
    for (int j = 0; j < el && j < lb_len; ++j) {
      if (a.lb_order[lx(j)] == slot) {
        at = j;
        break;
      }
    }
    if (at >= el) return;
    for (int j = at; j < el - 1; ++j) a.lb_order[lx(j)] = a.lb_order[lx(j + 1)];
    lb_len -= 1;
  }

  // _rot_insert: append at lb_len unless the slot is in the prefix already
  __device__ void rot_insert(int slot) {
    const int el = lb_width();
    for (int j = 0; j < el && j < lb_len; ++j) {
      if (a.lb_order[lx(j)] == slot) return;
    }
    a.lb_order[lx(min(max(lb_len, 0), el - 1))] = slot;
    lb_len = min(lb_len + 1, el);
  }

  // ---- _timeline_branch ----
  __device__ __forceinline__ float timeline_time() const {
    return kEvents && tl_ptr < a.NTL ? a.tl_times[tl_ptr] : kInf;
  }
  __device__ void timeline_pop() {
    work[W_TIMELINE] += 1;
    const int ptr = min(max(tl_ptr, 0), a.NTL - 1);
    const int slot = a.tl_slot[ptr];
    if (slot >= 0) {
      if (a.tl_down[ptr] == 1) {
        rot_remove(slot);
      } else {
        rot_insert(slot);
      }
    }
    tl_ptr += 1;
  }

  // ---- _breaker_report: one success or failure report to LB slot `slot` ----
  __device__ void breaker_report(int slot, bool is_probe, bool failed, float now) {
    work[W_BREAKER] += 1;
    const size_t x = lx(slot);
    const int stt = a.cb_state[x];
    if (is_probe) a.cb_probes_out[x] = max(a.cb_probes_out[x] - 1, 0);
    if (failed) {
      bool opens = is_probe;
      if (!is_probe && stt == CB_CLOSED) {
        const int consec = a.cb_consec[x] + 1;
        opens = consec >= a.cb_threshold;
        a.cb_consec[x] = opens ? 0 : consec;
      }
      if (opens) {
        a.cb_state[x] = CB_OPEN;
        a.cb_open_until[x] = now + a.cb_cooldown;
      }
      return;
    }
    if (!is_probe) {
      if (stt == CB_CLOSED) a.cb_consec[x] = 0;
      return;
    }
    const int ok = a.cb_probe_ok[x] + 1;
    a.cb_probe_ok[x] = ok;
    if (stt == CB_HALF_OPEN && ok >= a.cb_probes) {
      a.cb_state[x] = CB_CLOSED;
      a.cb_consec[x] = 0;
    }
  }

  // ---- _breaker_server_report: once per routed request ----
  __device__ void breaker_server_report(int i, bool failed, float now) {
    if (!kControls || a.cb_threshold <= 0) return;
    const size_t xi = px(i);
    const int slot = a.req_cbslot[xi];
    if (slot < 0) return;
    breaker_report(slot, a.req_probe[xi] > 0, failed, now);
    a.req_cbslot[xi] = -1;
    a.req_probe[xi] = 0;
  }

  // a refusal, shed or abandon: the slot frees, the request counts as
  // rejected and reports a failure; `release` also returns RAM and socket
  __device__ void reject(int i, int s, float now, bool release) {
    if (release) {
      release_ram(i, s, now);
      if (a.has_conn) a.srv_conn[sx(s)] -= 1;
    }
    const size_t xi = px(i);
    a.req_ev[xi] = EV_IDLE;
    a.req_t[xi] = kInf;
    n_rejected += 1;
    breaker_server_report(i, true, now);
  }

  // ---- _exit_flow ----
  __device__ void exit_flow(uint32_t it, int i, int s, float now) {
    release_ram(i, s, now);
    if (kControls && a.has_conn) a.srv_conn[sx(s)] -= 1;
    // departing the routed target is the breaker's success signal
    breaker_server_report(i, false, now);
    const int e = itab(a.exit_edge, a.NS, s);
    const int kind = itab(a.exit_kind, a.NS, s);
    const int target = itab(a.exit_target, a.NS, s);
    bool dropped;
    float delay;
    edge_draw(it, 48, e, now, dropped, delay);
    const float arrive = now + delay;
    const size_t xi = px(i);
    if (kWorkload && a.has_llm && !dropped && kind == TARGET_CLIENT && arrive < a.horizon) {
      // the cost moments of a request that reached the client in time
      const float cost = a.req_llm[xi];
      llm_sum = llm_sum + cost;
      llm_sumsq = llm_sumsq + cost * cost;
    }
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

  // ---- _seg_start for CPU, IO and END, with the ready-queue shed ----
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
        if (kControls && a.has_shed) {
          const int cap = itab(a.queue_cap, a.NS, s);
          if (cap >= 0 && a.cpu_wait_n[sx(s)] >= cap) {
            a.req_seg[xi] = seg;
            reject(i, s, now, true);  // joining a full ready queue: shed
            return;
          }
        }
        a.cpu_ticket[sx(s)] += 1;
        a.cpu_wait_n[sx(s)] += 1;
        a.req_ev[xi] = EV_WAIT_CPU;
        a.req_t[xi] = kInf;
        a.req_ticket[xi] = a.cpu_ticket[sx(s)];
        if (kControls && a.has_timeout) a.req_wait_t[xi] = now;
      }
    } else if (kind == SEG_IO) {
      a.req_ev[xi] = EV_SEG_END;
      a.req_t[xi] = now + dur;
    } else if (kWorkload) {
      seg_start_workload(it, xi, s, sidx, kind, dur, now);
    }
    a.req_seg[xi] = seg;
    if (kind == SEG_END) exit_flow(it, i, s, now);
  }

  // ---- _seg_start for a cache mixture or an LLM call (sleeps), or a DB
  // query (acquire a connection, or wait FIFO for one) ----
  __device__ void seg_start_workload(uint32_t it, size_t xi, int s, int sidx, int kind,
                                     float dur, float now) {
    const int n = n_seg_tab();
    if (a.has_cache && kind == SEG_CACHE) {
      // a miss sleeps the backing store's latency
      work[W_CACHE] += 1;
      if (one(it, 24, 0) >= ftab(a.seg_hit_prob, n, sidx)) {
        dur = ftab(a.seg_miss_dur, n, sidx);
      }
    } else if (a.has_llm && kind == SEG_LLM) {
      // output tokens: the exp-sum counting process on site 25, seq 0, 1, ...
      const float limit = fmaxf(ftab(a.seg_llm_tokens, n, sidx), 1e-6f);
      float acc = 0.0f;
      int tokens = 0;
      for (uint32_t seq = 0;; ++seq) {
        work[W_LLM_DRAWS] += 1;
        acc = acc + (-logf(fmaxf(1.0f - one(it, 25, seq), kTiny)));
        if (acc > limit) break;
        ++tokens;
      }
      const float tk = (float)tokens;
      dur = dur + tk * ftab(a.seg_llm_tpt, n, sidx);
      // a request may make several calls: their costs add up
      a.req_llm[xi] = a.req_llm[xi] + tk * ftab(a.seg_llm_cost, n, sidx);
    } else if (a.has_db && kind == SEG_DB) {
      if (a.db_free[sx(s)] > 0 && !(a.db_wait_n[sx(s)] > 0)) {
        a.db_free[sx(s)] -= 1;
      } else {
        work[W_DB_WAIT] += 1;
        a.db_ticket[sx(s)] += 1;
        a.db_wait_n[sx(s)] += 1;
        a.req_ev[xi] = EV_WAIT_DB;
        a.req_t[xi] = kInf;
        a.req_ticket[xi] = a.db_ticket[sx(s)];
        return;
      }
    } else {
      return;
    }
    a.req_ev[xi] = EV_SEG_END;
    a.req_t[xi] = now + dur;
  }

  // ---- _spawn_branch: the spawning generator's entry chain of `len`
  // edges from draw site `site0` (a stride of 4 an edge), its entry event
  // and target, then its next arrival ----
  __device__ void spawn(uint32_t it, float now) {
    if (kWorkload && a.G > 1) {
      const int g = gsel;
      spawn_chain(it, now, a.gen_entry_edges + g * a.L, a.gen_entry_len[g],
                  600 + 4 * a.L * g, a.gen_entry_ev[g], a.gen_entry_target[g]);
      advance_arrival_gen(it, g);
    } else {
      spawn_chain(it, now, a.entry_edges, a.K, 64, a.entry_ev, a.entry_target);
      advance_arrival(it);
    }
  }

  __device__ void spawn_chain(uint32_t it, float now, const int32_t* chain, int len,
                              int site0, int entry_ev, int entry_target) {
    n_generated += 1;
    bool alive = true;
    float t_cur = now;
    for (int j = 0; j < len; ++j) {
      bool dropped;
      float delay;
      // a spike applies at the time the request reaches this edge
      edge_draw(it, site0 + 4 * j, chain[j], t_cur, dropped, delay);
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
        a.req_ev[x] = entry_ev;
        a.req_t[x] = t_cur;
        a.req_srv[x] = entry_target;
        a.req_start[x] = now;
        a.req_lbslot[x] = -1;
        a.req_ram[x] = 0.0f;
        a.req_ticket[x] = kNoTicket;
        if (kWorkload && a.has_llm) a.req_llm[x] = 0.0f;
      } else {
        n_overflow += 1;
      }
    }
  }

  // does LB slot o admit a request (closed, or half-open with a probe free)?
  __device__ __forceinline__ bool cb_admits(int o) const {
    if (o < 0 || o >= a.EL) return false;
    const int st = a.cb_state[lx(o)];
    return st == CB_CLOSED || (st == CB_HALF_OPEN && a.cb_probes_out[lx(o)] < a.cb_probes);
  }

  // least connections among positions j < lb_len that pass `admit` (every
  // position when admit is false): first minimum of conn * EL + position;
  // returns -1 when no position qualifies
  __device__ int lc_pick(bool breaker) const {
    long long best_key = 1LL << 30;
    int best = -1;
    for (int j = 0; j < a.EL && j < lb_len; ++j) {
      const int o = a.lb_order[lx(j)];
      if (breaker && !cb_admits(o)) continue;
      const int conn = (o >= 0 && o < a.EL) ? a.lb_conn[lx(o)] : 0;
      const long long key = (long long)conn * a.EL + j;
      if (key < best_key) {
        best_key = key;
        best = j;
      }
    }
    return best;
  }

  // ---- _arrive_lb_branch with _lb_pick / _lb_pick_breaker ----
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
    if (kControls && a.cb_threshold > 0) {
      // lazy cooldown expiry over every slot: open slots whose cooldown
      // elapsed turn half-open with fresh probe counts
      for (int j = 0; j < a.EL; ++j) {
        const size_t x = lx(j);
        if (a.cb_state[x] == CB_OPEN && now >= a.cb_open_until[x]) {
          a.cb_state[x] = CB_HALF_OPEN;
          a.cb_probes_out[x] = 0;
          a.cb_probe_ok[x] = 0;
        }
      }
      slot = -1;
      if (a.lb_algo == 0) {
        // round robin: the first admitting member moves to the tail
        for (int j = 0; j < a.EL && j < lb_len; ++j) {
          if (cb_admits(a.lb_order[lx(j)])) {
            slot = a.lb_order[lx(j)];
            break;
          }
        }
        if (slot >= 0) {
          rot_remove(slot);
          rot_insert(slot);
        }
      } else {
        const int best = lc_pick(true);
        if (best >= 0) slot = a.lb_order[lx(best)];
      }
      if (slot < 0) {
        // no member admits: the LB refuses the request
        n_rejected += 1;
        a.req_ev[xi] = EV_IDLE;
        a.req_t[xi] = kInf;
        return;
      }
      const bool probe = a.cb_state[lx(slot)] == CB_HALF_OPEN;
      if (probe) a.cb_probes_out[lx(slot)] += 1;
      a.req_cbslot[xi] = slot;
      a.req_probe[xi] = probe ? 1 : 0;
    } else if (a.lb_algo == 0) {
      // round robin: take the head, rotate it to the tail of the length-prefix
      slot = a.lb_order[lx(0)];
      for (int j = 0; j < lb_len - 1; ++j) a.lb_order[lx(j)] = a.lb_order[lx(j + 1)];
      a.lb_order[lx(lb_len - 1)] = slot;
    } else {
      slot = a.lb_order[lx(max(lc_pick(false), 0))];
    }
    const int e = itab(a.lb_edge_index, a.EL, slot);
    bool dropped;
    float delay;
    edge_draw(it, 32, e, now, dropped, delay);
    if (dropped) {
      // a dropped send on the routing edge is a connection failure
      breaker_server_report(i, true, now);
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

  // ---- _arrive_srv_branch: rate limit, connection cap, endpoint pick,
  // RAM-first admission ----
  __device__ void arrive_srv(uint32_t it, int i, float now) {
    const size_t xi = px(i);
    const int s = a.req_srv[xi];
    if (a.EL > 0) {
      const int lbslot = a.req_lbslot[xi];
      if (lbslot >= 0 && lbslot < a.EL) a.lb_conn[lx(lbslot)] -= 1;
      a.req_lbslot[xi] = -1;
    }
    if (kControls && a.has_rl) {
      // token bucket: lazy refill at arrival, refuse without a whole token
      const float rps = ftab(a.rate_limit, a.NS, s);
      if (rps >= 0.0f) {
        work[W_REFILL] += 1;
        const float refill = (now - a.rl_last[sx(s)]) * fmaxf(rps, 0.0f);
        const float tokens = fminf(ftab(a.rate_burst, a.NS, s), a.rl_tokens[sx(s)] + refill);
        const bool limited = tokens < 1.0f;
        a.rl_tokens[sx(s)] = tokens - (limited ? 0.0f : 1.0f);
        a.rl_last[sx(s)] = now;
        if (limited) {
          reject(i, s, now, false);
          return;
        }
      }
    }
    if (kControls && a.has_conn) {
      // the server refuses an arrival when it holds its cap of residents
      const int cap = itab(a.conn_cap, a.NS, s);
      if (cap >= 0 && a.srv_conn[sx(s)] >= cap) {
        reject(i, s, now, false);
        return;
      }
      a.srv_conn[sx(s)] += 1;
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

  // ---- _cpu_handoff: release a core of s or grant it to the head FIFO
  // waiter; a grantee past its dequeue deadline takes it for zero service
  // as an abandon event at `now` ----
  __device__ void cpu_handoff(int s, float now) {
    if (a.cpu_wait_n[sx(s)] > 0) {
      int j;
      if (head_waiter(EV_WAIT_CPU, s, j) < kNoTicket) {
        const size_t xj = px(j);
        const float jdur = ftab(a.seg_dur, n_seg_tab(),
                                seg_idx(a.req_srv[xj], a.req_ep[xj], a.req_seg[xj]));
        int ev_next = EV_SEG_END;
        float t_next = now + jdur;
        if (kControls && a.has_timeout) {
          const float deadline = ftab(a.queue_timeout, a.NS, s);
          if (deadline >= 0.0f && now - a.req_wait_t[xj] > deadline) {
            ev_next = EV_ABANDON;
            t_next = now;
          }
        }
        a.cpu_wait_n[sx(s)] -= 1;
        a.req_ev[xj] = ev_next;
        a.req_t[xj] = t_next;
        a.req_ticket[xj] = kNoTicket;
        return;
      }
    }
    a.cores_free[sx(s)] += 1;
  }

  // ---- _abandon_branch ----
  __device__ void abandon(int i, float now) {
    const int s = a.req_srv[px(i)];
    cpu_handoff(s, now);
    reject(i, s, now, true);
  }

  // ---- the DB connection handoff of _seg_end_branch: grant it to the
  // head FIFO waiter, whose query runs for its own segment's duration, or
  // release it ----
  __device__ void db_handoff(int s, float now) {
    if (a.db_wait_n[sx(s)] > 0) {
      int j;
      if (head_waiter(EV_WAIT_DB, s, j) < kNoTicket) {
        const size_t xj = px(j);
        const float jdur = ftab(a.seg_dur, n_seg_tab(),
                                seg_idx(a.req_srv[xj], a.req_ep[xj], a.req_seg[xj]));
        work[W_DB_GRANT] += 1;
        a.db_wait_n[sx(s)] -= 1;
        a.req_ev[xj] = EV_SEG_END;
        a.req_t[xj] = now + jdur;
        a.req_ticket[xj] = kNoTicket;
        return;
      }
    }
    a.db_free[sx(s)] += 1;
  }

  // ---- _seg_end_branch: the core handoff, the DB handoff, the next
  // segment ----
  __device__ void seg_end(uint32_t it, int i, float now) {
    const size_t xi = px(i);
    const int s = a.req_srv[xi], ep = a.req_ep[xi], seg = a.req_seg[xi];
    const int kind = itab(a.seg_kind, n_seg_tab(), seg_idx(s, ep, seg));
    if (kind == SEG_CPU) cpu_handoff(s, now);
    if (kWorkload && a.has_db && kind == SEG_DB) db_handoff(s, now);
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
      if (kControls && a.has_timeout) a.req_wait_t[x] = 0.0f;
      if (kControls && a.cb_threshold > 0) {
        a.req_cbslot[x] = -1;
        a.req_probe[x] = 0;
      }
      if (kWorkload && a.has_llm) a.req_llm[x] = 0.0f;
    }
    for (int s = 0; s < a.NS; ++s) {
      a.cores_free[sx(s)] = a.server_cores[s];
      a.ram_free[sx(s)] = a.server_ram[s];
      a.cpu_ticket[sx(s)] = 0;
      a.ram_ticket[sx(s)] = 0;
      a.cpu_wait_n[sx(s)] = 0;
      a.ram_wait_n[sx(s)] = 0;
      if (kControls && a.has_conn) a.srv_conn[sx(s)] = 0;
      if (kControls && a.has_rl) {
        a.rl_tokens[sx(s)] = a.rate_burst[s];
        a.rl_last[sx(s)] = 0.0f;
      }
      if (kWorkload && a.has_db) {
        a.db_free[sx(s)] = a.db_pool[s];
        a.db_ticket[sx(s)] = 0;
        a.db_wait_n[sx(s)] = 0;
      }
    }
    const int el = lb_width();
    for (int j = 0; j < el; ++j) {
      a.lb_order[lx(j)] = j;
      a.lb_conn[lx(j)] = 0;
      if (kControls && a.cb_threshold > 0) {
        a.cb_state[lx(j)] = CB_CLOSED;
        a.cb_open_until[lx(j)] = 0.0f;
        a.cb_consec[lx(j)] = 0;
        a.cb_probes_out[lx(j)] = 0;
        a.cb_probe_ok[lx(j)] = 0;
      }
    }
    for (int b = 0; b < a.B; ++b) a.hist[(size_t)sid * a.B + b] = 0;
    for (int b = 0; b < a.TH; ++b) a.thr[(size_t)sid * a.TH + b] = 0;
    lb_len = a.EL;
    tl_ptr = 0;
    smp_now = 0.0f;
    smp_window_end = 0.0f;
    widx = -1;
    next_arrival = 0.0f;
    lat_count = n_generated = n_dropped = n_overflow = n_rejected = 0;
    lat_sum = lat_sumsq = lat_max = llm_sum = llm_sumsq = 0.0f;
    lat_min = kInf;
    gsel = 0;
#pragma unroll
    for (int k = 0; k < N_WORK; ++k) work[k] = 0;

    if (kWorkload && a.G > 1) {
      // every generator draws its first arrival, in order
      for (int g = 0; g < a.G; ++g) {
        const size_t gx = (size_t)g * a.S + sid;
        a.gen_now[gx] = 0.0f;
        a.gen_wend[gx] = 0.0f;
        a.gen_widx[gx] = -1;
        a.gen_next[gx] = 0.0f;
      }
      for (int g = 0; g < a.G; ++g) advance_arrival_gen(0, g);
    } else {
      advance_arrival(0);
    }
    int nxt_i;
    float nxt_t;
    pool_min(nxt_i, nxt_t);
    int it = 1;
    int events = 0;
    while (it < a.max_iterations) {
      const float t_tl = timeline_time();
      const float now = kEvents ? fminf(fminf(nxt_t, next_arrival), t_tl)
                                : fminf(nxt_t, next_arrival);
      if (!(now < a.horizon)) break;
      ++events;
      if (kEvents && t_tl <= now) {
        // a timeline entry beats the pool and an arrival at the same time
        timeline_pop();
      } else if (nxt_t <= now) {
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
          case EV_ABANDON:
            if (kControls && a.has_timeout) {
              work[W_ABANDON] += 1;
              abandon(nxt_i, now);
            }
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
    const float t_min = kEvents ? fminf(fminf(nxt_t, next_arrival), timeline_time())
                                : fminf(nxt_t, next_arrival);
    a.trunc[sid] = (it >= a.max_iterations && t_min < a.horizon) ? 1 : 0;
    a.n_events[sid] = events;
    float* mf = a.momf + (size_t)sid * 6;
    mf[0] = lat_sum;
    mf[1] = lat_sumsq;
    mf[2] = lat_min;
    mf[3] = lat_max;
    mf[4] = llm_sum;
    mf[5] = llm_sumsq;
    int32_t* mi = a.momi + (size_t)sid * 5;
    mi[0] = lat_count;
    mi[1] = n_generated;
    mi[2] = n_dropped;
    mi[3] = n_overflow;
    mi[4] = n_rejected;
    int32_t* w = a.work + (size_t)sid * N_WORK;
#pragma unroll
    for (int k = 0; k < N_WORK; ++k) w[k] = work[k];
  }
};

constexpr int kThreads = 32;

template <bool kEvents, bool kControls, bool kWorkload>
__global__ void __launch_bounds__(kThreads) des_kernel(const DesArgs args) {
  const int sid = blockIdx.x * blockDim.x + threadIdx.x;
  if (sid >= args.S) return;
  Sim<kEvents, kControls, kWorkload> sim(args, sid);
  sim.run();
}

template <bool kEvents, bool kControls, bool kWorkload>
int launch(const DesArgs& args, cudaStream_t stream) {
  const int blocks = (args.S + kThreads - 1) / kThreads;
  des_kernel<kEvents, kControls, kWorkload><<<blocks, kThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}

#ifndef DES_WORKLOAD
#define DES_WORKLOAD 0
#endif
constexpr bool kLibraryWorkload = DES_WORKLOAD != 0;

}  // namespace

extern "C" int des_args_size() { return (int)sizeof(DesArgs); }

// Does this build hold the instances with the workload group (cache, LLM,
// DB pools, several generators)?
extern "C" int des_workload() { return kLibraryWorkload ? 1 : 0; }

// Launch on `stream` (a cudaStream_t as a pointer), on the instance that
// compiles in the plan's features; returns cudaGetLastError(), or
// kWrongBuild when the plan needs the other build's instances.
extern "C" int des_launch(const DesArgs* args, void* stream) {
  constexpr int kWrongBuild = 1 << 20;
  const bool events = args->NB > 0 || args->NTL > 0;
  const bool controls = args->has_shed || args->has_conn || args->has_rl || args->has_timeout ||
                        args->cb_threshold > 0;
  const bool workload = args->has_cache || args->has_llm || args->has_db || args->G > 1;
  if (workload != kLibraryWorkload) return kWrongBuild;
  const cudaStream_t st = (cudaStream_t)stream;
  constexpr bool w = kLibraryWorkload;
  if (events) {
    return controls ? launch<true, true, w>(*args, st) : launch<true, false, w>(*args, st);
  }
  return controls ? launch<false, true, w>(*args, st) : launch<false, false, w>(*args, st);
}
