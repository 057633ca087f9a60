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
// count, a has_* flag, the breaker threshold or the generator count).  A
// plan with none of the groups runs the slice-1 code alone: compiled in but
// never taken, branches cost a latency-bound event loop every instruction
// and register they add.  A timeline entry is an iteration of its own: the
// loop takes it before the pool and the pool before an arrival, and the
// scenario's iteration counter advances on it as on any event.
//
// What bounds it on this card: neither bytes nor operations.  A scenario is a
// sequential chain of ~400k events, each depending on the last, and the sweep
// has only as many chains as scenarios (2048 at the headline shape).  The
// card's memory rate and peak arithmetic rate allow far more than such a
// chain can use; the kernel is bound by the latency of one event times the
// events of a chain, and by how many chains an SM holds to hide it.
//
// Design: one warp per scenario, up to kWarps scenarios a block.  The
// Pallas kernel advanced a block of scenarios in lockstep (one event per row
// per iteration, the pool on vector lanes); since every live row handles
// exactly one event per iteration, a scenario's own event counter reproduces
// the shared iteration counter, and with it every threefry counter.
//   - The request pool lies across the warp's lanes: slot j belongs to lane
//     j % 32.  The pool argmin is each lane's first minimum over its own
//     slots, then a shuffle reduction on (time, slot) that breaks ties to the
//     lower slot: the first-minimum rule of _argmin_row.  The FIFO head of a
//     core, RAM or DB queue is the same reduction on (ticket, slot); the
//     first free slot is a ballot over rounds of 32 slots.
//   - The event handler runs warp-uniformly: every lane holds the
//     scenario's scalars and computes the same branch on the same values
//     (threefry and logf included), so the warp never diverges.  Every word
//     of state has one owner lane that alone loads and stores it (pool slot
//     j: lane j % 32; the rest: lane 0); the others read it by shuffle, so
//     no lane reads a word another writes and the loop needs no barrier.
//   - Draws whose counters do not depend on the state run on all lanes at
//     once: the exp-sum counting loops (Poisson edges, LLM output tokens)
//     draw 32 terms at a time, one a lane, and add them in counter order as
//     one serial chain, so the float sum is associated as in the twin.
//   - State lives in shared memory: the per-server, per-LB-slot and
//     per-generator records always, and the pool's three scanned fields
//     (time, event and server packed in one word, ticket) where the
//     scenario's share stays within kWarpSharedBudget (16 warps an SM;
//     layout_of), else in global scratch.  The other nine fields of a slot,
//     touched only at the event's own slot, are always in global scratch,
//     where L1 holds them: with them in shared memory too, three of the
//     five paths whose pool fits ran 1.5-3% slower on an H100.
//     A slot's scanned fields are one record and its other fields another,
//     so a handler finds a field at a constant offset from its slot's
//     record; integer address arithmetic, not the memory, is what an event
//     spends most of its instructions on.  The placement is chosen at
//     launch from the plan's pool, servers, LB slots and generators.
// The host build (tests/test_torch_kernel_host.py) compiles this source with
// g++ at one lane a scenario: the reductions, the ballot and the lane-strided
// loops then run serially, so the host checks the algorithm and the card
// checks the 32-lane reductions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e30f;
constexpr int kNoTicket = 1 << 30;
constexpr float kTiny = 1e-15f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kNoSlot = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;

// lanes a scenario runs on: a warp on the card, one in the host build
#ifdef __CUDACC__
constexpr int kLanes = 32;
#else
constexpr int kLanes = 1;
#endif
// scenarios a block at most, and blocks an SM the registers must allow:
// 4 x 4 warps of 32 threads is 16 warps, so at most 128 registers a thread
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kLanes;
constexpr int kMinBlocks = 4;
// shared bytes a scenario may take and still let 16 warps share an SM
// (228 KB an SM, 1 KB of it reserved for each of 4 blocks); a block may use
// 227 KB
constexpr int kWarpSharedBudget = (233472 - kMinBlocks * 1024) / (kMinBlocks * kWarps);
constexpr int kBlockSharedMax = 232448;

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

// A scenario's state: records of P pool slots (the first N_SCAN fields are
// the ones the reductions scan, a record of their own; R_EVSRV holds
// server * 16 + event), of NS servers, of max(EL, 1) LB slots and of G
// generators, each field an int32 or float32 word.
enum PoolField {
  R_T,
  R_EVSRV,
  R_TICKET,
  N_SCAN,
  R_EP = N_SCAN,
  R_SEG,
  R_RAM,
  R_START,
  R_LBSLOT,
  R_WAIT_T,  // deadline
  R_CBSLOT,  // breaker
  R_PROBE,   // breaker
  R_LLM,     // LLM cost accrued
  N_POOL
};
// lane j reads slot j's scanned record: an odd stride keeps the 32 reads in
// 32 banks
static_assert(N_SCAN % 2 == 1, "the scanned record needs an odd stride");
enum SrvField {
  S_CORES,
  S_RAM,
  S_CPU_TICKET,
  S_RAM_TICKET,
  S_CPU_WAIT,
  S_RAM_WAIT,
  S_CONN,     // connection cap
  S_RL_TOK,   // rate limit
  S_RL_LAST,  // rate limit
  S_DB_FREE,  // DB pool
  S_DB_TICKET,
  S_DB_WAIT,
  N_SRV
};
enum LbField {
  L_ORDER,
  L_CONN,
  L_CB_STATE,  // breaker
  L_CB_UNTIL,
  L_CB_CONSEC,
  L_CB_PROBES,
  L_CB_OK,
  N_LB
};
enum GenField { G_NOW, G_WEND, G_WIDX, G_NEXT, N_GEN };

// where the pool lives (DesLayout.placement)
constexpr int PLACE_SCAN_SHARED = 0;  // the scanned fields in shared memory
constexpr int PLACE_GLOBAL = 1;       // every field in global scratch

// the feature groups an instance compiles in (DesLayout.instance)
constexpr int INST_EVENTS = 1;
constexpr int INST_CONTROLS = 2;
constexpr int INST_WORKLOAD = 4;

// des_launch's refusals (cudaError_t values stay far below)
constexpr int kWrongBuild = 1 << 20;
constexpr int kTooLarge = 1 << 21;
constexpr int kNoScratch = 1 << 22;

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
  // the pool fields that do not fit shared memory, (S, global_words): per
  // scenario the scanned records of its slots, if they are here, then the
  // records of their other fields; null when they all fit (des_layout)
  int32_t* pool_scratch;
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

// Where a launch keeps a scenario's state, and the instance it runs
// (des_layout mirrors it as int32[7]).
struct DesLayout {
  int32_t placement;      // PLACE_*
  int32_t warps;          // scenarios a block
  int32_t shared_bytes;   // dynamic shared memory a block
  int32_t shared_fields;  // pool fields in shared memory (the first ones)
  int32_t warp_words;     // shared words a scenario
  int32_t global_words;   // global scratch words a scenario
  int32_t instance;       // INST_* bits of the instance
};

// the dynamic shared memory of a block: kWarps regions of warp_words
extern __shared__ int32_t des_smem[];

namespace {

__host__ __device__ inline int lb_width(const DesArgs& a) { return a.EL > 0 ? a.EL : 1; }

// words of a scenario's server, LB-slot and generator state
__host__ __device__ inline long long state_words(const DesArgs& a) {
  return (long long)N_SRV * a.NS + (long long)N_LB * lb_width(a) + (long long)N_GEN * a.G;
}

// The feature groups the plan needs compiled in.
__host__ __device__ inline int instance_of(const DesArgs& a) {
  const bool events = a.NB > 0 || a.NTL > 0;
  const bool controls =
      a.has_shed || a.has_conn || a.has_rl || a.has_timeout || a.cb_threshold > 0;
  const bool workload = a.has_cache || a.has_llm || a.has_db || a.G > 1;
  return (events ? INST_EVENTS : 0) | (controls ? INST_CONTROLS : 0) |
         (workload ? INST_WORKLOAD : 0);
}

// The placement for this plan: the scanned fields in shared memory where a
// scenario's share fits kWarpSharedBudget, else none; fewer scenarios a
// block only where the state alone is that large.
// Returns 0, or kTooLarge when one scenario's shared state exceeds a block.
__host__ __device__ inline int layout_of(const DesArgs& a, DesLayout& lay) {
  const long long st = state_words(a);
  const long long p = a.P;
  const int fields = 4 * (st + N_SCAN * p) <= kWarpSharedBudget ? N_SCAN : 0;
  const long long words = st + fields * p;
  const long long fit = kBlockSharedMax / (4 * words);
  lay.placement = fields == N_SCAN ? PLACE_SCAN_SHARED : PLACE_GLOBAL;
  lay.warps = (int)(fit < kWarps ? fit : kWarps);
  lay.shared_fields = fields;
  lay.warp_words = (int)words;
  lay.shared_bytes = (int)(4 * words * lay.warps);
  lay.global_words = (int)((N_POOL - fields) * p);
  lay.instance = instance_of(a);
  return lay.warps > 0 ? 0 : kTooLarge;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// four rounds of threefry2x32 with rotations r0..r3
__device__ __forceinline__ void threefry_rounds(uint32_t& x0, uint32_t& x1, int r0, int r1,
                                                int r2, int r3) {
  x0 += x1;
  x1 = rotl32(x1, r0) ^ x0;
  x0 += x1;
  x1 = rotl32(x1, r1) ^ x0;
  x0 += x1;
  x1 = rotl32(x1, r2) ^ x0;
  x0 += x1;
  x1 = rotl32(x1, r3) ^ x0;
}

// One 20-round threefry2x32 block (pallas_engine.py:_threefry2x32), written
// out so that every rotation and key word is a constant of the code.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = 0x1BD11BDAu ^ k0 ^ k1;
  x0 += k0;
  x1 += k1;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1;
  x1 += k2 + 1u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k0 + 2u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0;
  x1 += k1 + 3u;
  threefry_rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1;
  x1 += k2 + 4u;
  threefry_rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// 24-bit uniform in [0, 1) (pallas_engine.py:_uniform_from_bits).
__device__ __forceinline__ float u24(uint32_t bits) {
  return (float)(int32_t)(bits >> 8) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ float* as_float(int32_t* p) { return reinterpret_cast<float*>(p); }

// ---- the lane-parallel pieces: everything else runs warp-uniformly ----

// an unsigned key in the order of the float t (-0.0 and +0.0, which compare
// equal, get one key), and back
__device__ __forceinline__ uint32_t float_key(float t) {
  const uint32_t b = __float_as_uint(t + 0.0f);
  return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}
__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) != 0 ? k ^ 0x80000000u : ~k);
}

// the least (key, slot) of the warp, ties to the lower slot; every lane
// gets it
template <class K>
__device__ __forceinline__ void warp_min(K& key, int& slot) {
  const K least = __reduce_min_sync(kAll, key);
  slot = (int)__reduce_min_sync(kAll, key == least ? (uint32_t)slot : 0xffffffffu);
  key = least;
}

// The draw table (on the card): lane l holds the threefry block of
// iteration tab_it + l / kTableSites at site table_site(l % kTableSites),
// seq 0, so one pass of the warp draws the blocks of kTableIters iterations
// at once.  The sites: the endpoint pick, the LB edge, the exit edge, the
// arrival gap of one generator, the first two entry edges, the cache and
// the LB edge's second block.  Only the instances without the controls and
// workload groups use it: on the card it cut the headline's kernel by a
// tenth and slowed resilience_all's (controls) and two_gen_lb's (several
// generators, whose sites it lacks).
constexpr int kTableSites = 8;
constexpr int kTableIters = kLanes / kTableSites;  // 0 in the host build: no table
__device__ __forceinline__ uint32_t table_site(int k) {
  return k == 0 ? 4 : k == 1 ? 32 : k == 2 ? 48 : k == 3 ? 200 : k == 4 ? 64 : k == 5 ? 68
                                                                  : k == 6 ? 24 : 33;
}
__device__ __forceinline__ int table_slot(uint32_t site) {
  return site == 4 ? 0 : site == 32 ? 1 : site == 48 ? 2 : site == 200 ? 3 : site == 64 ? 4
                                                          : site == 68 ? 5 : site == 24 ? 6
                                                          : site == 33 ? 7 : -1;
}

template <bool kEvents, bool kControls, bool kWorkload>
struct Sim {
  const DesArgs& a;
  int sid, lane;
  // this scenario's state: records of its servers, LB slots and generators
  // (shared memory), and of its pool slots: the scanned fields and the rest
  int32_t *srv_rec, *lb_rec, *gen_rec, *scan_rec, *rest_rec;
  uint32_t k0, k1;
  // iterations the draw table covers in this instance (0: no table)
  static constexpr int kTableSpan = kControls || kWorkload ? 0 : kTableIters;
  uint32_t tab_it;       // the draw table's first iteration
  float tab_u0, tab_u1;  // this lane's block of it
  // per-scenario scalars, the same in every lane; with several generators,
  // next_arrival is the earliest of theirs and gsel its generator
  float smp_now, smp_window_end, next_arrival;
  int widx, gsel;
  int lat_count, n_generated, n_dropped, n_overflow, n_rejected, lb_len, tl_ptr;
  float lat_sum, lat_sumsq, lat_min, lat_max, llm_sum, llm_sumsq;
  int work[N_WORK];  // indexed by constants only, so it stays in registers

  __device__ Sim(const DesArgs& args, int s, int l) : a(args), sid(s), lane(l) {}

  // ---- state accessors: pointers to a word of state.  Each slot, server,
  // LB slot and generator is a record of its fields, so that a handler
  // finds its record once and each field at a constant offset. ----
  __device__ __forceinline__ int32_t* pi(int f, int j) const {
    return f < N_SCAN ? scan_rec + j * N_SCAN + f
                      : rest_rec + j * (N_POOL - N_SCAN) + (f - N_SCAN);
  }
  __device__ __forceinline__ float* pf(int f, int j) const { return as_float(pi(f, j)); }
  __device__ __forceinline__ int32_t* si(int f, int s) const { return srv_rec + s * N_SRV + f; }
  __device__ __forceinline__ int32_t* li(int f, int j) const { return lb_rec + j * N_LB + f; }
  __device__ __forceinline__ int32_t* gi(int f, int g) const { return gen_rec + g * N_GEN + f; }

  // ---- ownership: every word of state has one owner lane, which alone
  // loads and stores it; the other lanes get its value by shuffle.  Pool
  // slot j belongs to lane j % kLanes (owner_of; a lane scans its own slots), the
  // server, LB-slot and generator words to lane 0.  No lane touches another
  // lane's word, so the warp needs no barrier (init_state's one aside). ----
  static __device__ __forceinline__ int owner_of(int slot) { return slot & (kLanes - 1); }
  __device__ __forceinline__ int own_get(const int32_t* p, int owner) const {
    int v = 0;
    if (lane == owner) v = *p;
    return __shfl_sync(kAll, v, owner);
  }
  __device__ __forceinline__ void own_set(int32_t* p, int owner, int v) const {
    if (lane == owner) *p = v;
  }
  __device__ __forceinline__ void own_add(int32_t* p, int owner, int d) const {
    if (lane == owner) *p += d;
  }
  __device__ __forceinline__ int pget(int f, int j) const {
    return own_get(pi(f, j), owner_of(j));
  }
  __device__ __forceinline__ float pgetf(int f, int j) const {
    return __int_as_float(pget(f, j));
  }
  __device__ __forceinline__ void pset(int f, int j, int v) const {
    own_set(pi(f, j), owner_of(j), v);
  }
  __device__ __forceinline__ void psetf(int f, int j, float v) const {
    pset(f, j, __float_as_int(v));
  }
  __device__ __forceinline__ int sget(int f, int s) const { return own_get(si(f, s), 0); }
  __device__ __forceinline__ float sgetf(int f, int s) const {
    return __int_as_float(sget(f, s));
  }
  __device__ __forceinline__ void sset(int f, int s, int v) const { own_set(si(f, s), 0, v); }
  __device__ __forceinline__ void ssetf(int f, int s, float v) const {
    sset(f, s, __float_as_int(v));
  }
  __device__ __forceinline__ void sadd(int f, int s, int d) const { own_add(si(f, s), 0, d); }
  __device__ __forceinline__ int lget(int f, int j) const { return own_get(li(f, j), 0); }
  __device__ __forceinline__ float lgetf(int f, int j) const {
    return __int_as_float(lget(f, j));
  }
  __device__ __forceinline__ void lset(int f, int j, int v) const { own_set(li(f, j), 0, v); }
  __device__ __forceinline__ void lsetf(int f, int j, float v) const {
    lset(f, j, __float_as_int(v));
  }
  __device__ __forceinline__ void ladd(int f, int j, int d) const { own_add(li(f, j), 0, d); }
  __device__ __forceinline__ int gget(int f, int g) const { return own_get(gi(f, g), 0); }
  __device__ __forceinline__ float ggetf(int f, int g) const {
    return __int_as_float(gget(f, g));
  }
  __device__ __forceinline__ void gset(int f, int g, int v) const { own_set(gi(f, g), 0, v); }
  __device__ __forceinline__ void gsetf(int f, int g, float v) const {
    gset(f, g, __float_as_int(v));
  }

  // the event and server of slot j share a word: server * 16 + event
  __device__ __forceinline__ int ev_of(int j) const { return pget(R_EVSRV, j) & 15; }
  __device__ __forceinline__ int srv_of(int j) const { return pget(R_EVSRV, j) >> 4; }
  __device__ __forceinline__ void set_ev(int j, int ev) const {
    if (lane == owner_of(j)) {
      int32_t* p = pi(R_EVSRV, j);
      *p = (*p & ~15) | ev;
    }
  }
  __device__ __forceinline__ void set_ev_srv(int j, int ev, int s) const {
    pset(R_EVSRV, j, s * 16 + ev);
  }
  __device__ __forceinline__ void set_t(int j, float t) const { psetf(R_T, j, t); }
  // the slot frees: idle, never due
  __device__ __forceinline__ void free_slot(int j) const {
    set_ev(j, EV_IDLE);
    set_t(j, kInf);
  }

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
  // the lane of the draw table that holds (it, site, seq), if one does
  __device__ __forceinline__ bool in_table(uint32_t it, uint32_t site, uint32_t seq,
                                           int& src) const {
    const int slot = table_slot(site);
    const uint32_t d = it - tab_it;
    if (kTableSpan == 0 || seq != 0 || slot < 0 || d >= (uint32_t)kTableSpan) return false;
    src = (int)d * kTableSites + slot;
    return true;
  }
  __device__ __forceinline__ void fill_table(uint32_t it) {
    tab_it = it;
    uint32_t x0 = it + (uint32_t)(lane / kTableSites), x1 = table_site(lane % kTableSites);
    threefry2x32(k0, k1, x0, x1);
    tab_u0 = u24(x0);
    tab_u1 = u24(x1);
  }
  __device__ __forceinline__ void pair(uint32_t it, uint32_t site, uint32_t seq, float& u0,
                                       float& u1) const {
    int src;
    if (in_table(it, site, seq, src)) {
      u0 = __shfl_sync(kAll, tab_u0, src);
      u1 = __shfl_sync(kAll, tab_u1, src);
      return;
    }
    uint32_t x0 = it, x1 = site + (seq << 10);
    threefry2x32(k0, k1, x0, x1);
    u0 = u24(x0);
    u1 = u24(x1);
  }
  __device__ __forceinline__ float one(uint32_t it, uint32_t site, uint32_t seq) const {
    int src;
    if (in_table(it, site, seq, src)) return __shfl_sync(kAll, tab_u0, src);
    return block_u0(it, site, seq);
  }
  // the first word of block (it, site, seq) computed here, never read from
  // the draw table: for a seq that differs from lane to lane, where the
  // table's shuffle would run on only some lanes
  __device__ __forceinline__ float block_u0(uint32_t it, uint32_t site, uint32_t seq) const {
    uint32_t x0 = it, x1 = site + (seq << 10);
    threefry2x32(k0, k1, x0, x1);
    return u24(x0);
  }

  // The exp-sum counting process on (it, site, seq = 0, 1, ...): how many
  // terms -log(1 - u) the running sum takes while it stays at or below
  // `limit`.  Lane k draws seq base + k; the terms join one chain in seq
  // order, so the sum is associated as in the twin; it stops at the first
  // crossing (the draw that crosses is the count's + 1st).
  __device__ __forceinline__ int exp_sum_count(uint32_t it, uint32_t site, float limit) const {
    float acc = 0.0f;
    int k = 0;
    for (uint32_t base = 0;; base += kLanes) {
      const float term = -logf(fmaxf(1.0f - block_u0(it, site, base + lane), kTiny));
#pragma unroll
      for (int m = 0; m < kLanes; ++m) {
        acc = acc + __shfl_sync(kAll, term, m);
        if (acc > limit) return k;
        ++k;
      }
    }
  }

  // ---- _edge_draw: the delay gains the spike in force at t_send ----
  __device__ __forceinline__ void edge_draw(uint32_t it, uint32_t site, int e, float t_send,
                                            bool& dropped,
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
      delay = (float)exp_sum_count(it, site + 2, fmaxf(mean, kTiny));
    }
    if (kEvents && a.NB > 0) {
      // breakpoint: the last spike time at or before t_send (the first is 0)
      int bp = -1;
      for (int k = 0; k < a.NB; ++k) bp += a.spike_times[k] <= t_send ? 1 : 0;
      delay = delay + ftab(a.spike_vals, a.NB * a.NE, bp * a.NE + e);
    }
    dropped = u_drop < drop_p;
  }

  // ---- _advance_arrival: window-jump exponential-gap sampler over the
  // rate row `lam_row` of `nw` windows and the draw site `site`; the
  // sampler's clock, window end and window index are updated in place and
  // the gap to the next arrival returned, or -1 when none is left ----
  __device__ __forceinline__ float arrival_gap(uint32_t it, uint32_t site, const float* lam_row,
                                               int nw,
                               float window, float& now, float& wend, int& wi) const {
    for (uint32_t dctr = 0;; ++dctr) {
      if (now >= a.horizon) return -1.0f;
      if (now >= wend) {
        wi += 1;
        wend = now + window;
      }
      const int wc = min(wi, nw - 1);
      const float lam = wc >= 0 ? lam_row[wc] : 0.0f;
      const bool no_users = lam <= 0.0f;
      const float u = fmaxf(one(it, site, dctr), kTiny);
      const float g = (-logf(fmaxf(1.0f - u, kTiny))) / fmaxf(lam, kTiny);
      const float ahead = now + g;
      if (no_users) {
        now = wend;
      } else if (ahead > a.horizon) {
        return -1.0f;
      } else if (ahead >= wend) {
        now = wend;
      } else {
        now = ahead;
        return g;
      }
    }
  }

  __device__ __forceinline__ void advance_arrival(uint32_t it) {
    const float gap = arrival_gap(it, 200, a.lam + (size_t)sid * a.NW, a.NW, a.window,
                                  smp_now, smp_window_end, widx);
    next_arrival = gap < 0.0f ? kInf : next_arrival + gap;
  }

  // ---- _advance_arrival of generator g of several: its state in shared
  // memory, its own block of the rate table, window and draw site 200 + g;
  // then the earliest next arrival over the generators (lowest index on
  // ties) ----
  __device__ __forceinline__ void advance_arrival_gen(uint32_t it, int g) {
    float now = ggetf(G_NOW, g), wend = ggetf(G_WEND, g);
    int wi = gget(G_WIDX, g);
    const float gap = arrival_gap(it, 200 + g, a.lam + (size_t)sid * a.NW + a.gen_lam_off[g],
                                  a.gen_nw[g], a.gen_window[g], now, wend, wi);
    gsetf(G_NOW, g, now);
    gsetf(G_WEND, g, wend);
    gset(G_WIDX, g, wi);
    gsetf(G_NEXT, g, gap < 0.0f ? kInf : ggetf(G_NEXT, g) + gap);
    gsel = 0;
    next_arrival = ggetf(G_NEXT, 0);
    for (int h = 1; h < a.G; ++h) {
      const float v = ggetf(G_NEXT, h);
      if (v < next_arrival) {
        next_arrival = v;
        gsel = h;
      }
    }
  }

  // ---- _complete: only lane 0 touches the histogram and throughput rows ----
  __device__ __forceinline__ void complete(float start, float finish) {
    const float lat = finish - start;
    int lbin = (int)((logf(fmaxf(lat, 1e-6f)) - a.hist_lo) * a.hist_scale);
    lbin = min(max(lbin, 0), a.B - 1);
    int tbin = (int)ceilf(finish) - 1;
    tbin = min(max(tbin, 0), a.TH - 1);
    if (lane == 0) {
      a.hist[(size_t)sid * a.B + lbin] += 1;
      a.thr[(size_t)sid * a.TH + tbin] += 1;
    }
    lat_count += 1;
    lat_sum = lat_sum + lat;
    lat_sumsq = lat_sumsq + lat * lat;
    lat_min = fminf(lat_min, lat);
    lat_max = fmaxf(lat_max, lat);
  }

  // first slot (lowest index) with the least ticket among slots in `ev_code`
  // on server `s`; returns kNoTicket when there is none
  __device__ __forceinline__ int head_waiter(int ev_code, int s, int& head) const {
    const int key = s * 16 + ev_code;
    int best = kNoTicket;
    head = kNoSlot;
    for (int j = lane; j < a.P; j += kLanes) {
      if (*pi(R_EVSRV, j) == key) {
        const int tk = *pi(R_TICKET, j);
        if (tk < best) {
          best = tk;
          head = j;
        }
      }
    }
    warp_min(best, head);
    return best;
  }

  // the lowest idle slot, or -1: a ballot over each round of kLanes slots
  __device__ __forceinline__ int first_idle() const {
    for (int r = 0; r < a.P; r += kLanes) {
      const int j = r + lane;
      const unsigned hit = __ballot_sync(kAll, j < a.P && (*pi(R_EVSRV, j) & 15) == EV_IDLE);
      if (hit != 0) return r + __ffs(hit) - 1;
    }
    return -1;
  }

  // pool argmin over req_t, ties to the lowest slot
  __device__ __forceinline__ void pool_min(int& idx, float& t) const {
    t = __int_as_float(0x7f800000);  // +inf: a lane's first slot always takes it
    idx = kNoSlot;
    for (int j = lane; j < a.P; j += kLanes) {
      const float v = *pf(R_T, j);
      if (v < t) {
        t = v;
        idx = j;
      }
    }
    uint32_t key = float_key(t);
    warp_min(key, idx);
    t = key_float(key);
  }

  // ---- _release_ram with the strict-FIFO grant cascade ----
  __device__ __forceinline__ void release_ram(int i, int s, float now) {
    if (!a.has_ram) return;
    ssetf(S_RAM, s, sgetf(S_RAM, s) + pgetf(R_RAM, i));
    psetf(R_RAM, i, 0.0f);
    while (sget(S_RAM_WAIT, s) > 0) {
      int head;
      if (!(head_waiter(EV_WAIT_RAM, s, head) < kNoTicket)) break;
      if (!(pgetf(R_RAM, head) <= sgetf(S_RAM, s))) break;
      set_ev(head, EV_RESUME);
      set_t(head, now);
      pset(R_TICKET, head, kNoTicket);
      ssetf(S_RAM, s, sgetf(S_RAM, s) + (-pgetf(R_RAM, head)));
      sadd(S_RAM_WAIT, s, -1);
    }
  }

  // ---- LB rotation: remove a slot, or re-insert it at the tail ----

  // _rot_remove: lanes at and past the slot shift left (those past lb_len
  // too; the last lane keeps its value)
  __device__ __forceinline__ void rot_remove(int slot) {
    const int el = lb_width(a);
    int at = el;
    for (int j = 0; j < el && j < lb_len; ++j) {
      if (lget(L_ORDER, j) == slot) {
        at = j;
        break;
      }
    }
    if (at >= el) return;
    for (int j = at; j < el - 1; ++j) lset(L_ORDER, j, lget(L_ORDER, j + 1));
    lb_len -= 1;
  }

  // _rot_insert: append at lb_len unless the slot is in the prefix already
  __device__ __forceinline__ void rot_insert(int slot) {
    const int el = lb_width(a);
    for (int j = 0; j < el && j < lb_len; ++j) {
      if (lget(L_ORDER, j) == slot) return;
    }
    lset(L_ORDER, min(max(lb_len, 0), el - 1), slot);
    lb_len = min(lb_len + 1, el);
  }

  // ---- _timeline_branch ----
  __device__ __forceinline__ float timeline_time() const {
    return kEvents && tl_ptr < a.NTL ? a.tl_times[tl_ptr] : kInf;
  }
  __device__ __forceinline__ void timeline_pop() {
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
  __device__ __forceinline__ void breaker_report(int slot, bool is_probe, bool failed, float now) {
    work[W_BREAKER] += 1;
    const int stt = lget(L_CB_STATE, slot);
    if (is_probe) lset(L_CB_PROBES, slot, max(lget(L_CB_PROBES, slot) - 1, 0));
    if (failed) {
      bool opens = is_probe;
      if (!is_probe && stt == CB_CLOSED) {
        const int consec = lget(L_CB_CONSEC, slot) + 1;
        opens = consec >= a.cb_threshold;
        lset(L_CB_CONSEC, slot, opens ? 0 : consec);
      }
      if (opens) {
        lset(L_CB_STATE, slot, CB_OPEN);
        lsetf(L_CB_UNTIL, slot, now + a.cb_cooldown);
      }
      return;
    }
    if (!is_probe) {
      if (stt == CB_CLOSED) lset(L_CB_CONSEC, slot, 0);
      return;
    }
    const int ok = lget(L_CB_OK, slot) + 1;
    lset(L_CB_OK, slot, ok);
    if (stt == CB_HALF_OPEN && ok >= a.cb_probes) {
      lset(L_CB_STATE, slot, CB_CLOSED);
      lset(L_CB_CONSEC, slot, 0);
    }
  }

  // ---- _breaker_server_report: once per routed request ----
  __device__ __forceinline__ void breaker_server_report(int i, bool failed, float now) {
    if (!kControls || a.cb_threshold <= 0) return;
    const int slot = pget(R_CBSLOT, i);
    if (slot < 0) return;
    breaker_report(slot, pget(R_PROBE, i) > 0, failed, now);
    pset(R_CBSLOT, i, -1);
    pset(R_PROBE, i, 0);
  }

  // a refusal, shed or abandon: the slot frees, the request counts as
  // rejected and reports a failure; `release` also returns RAM and socket
  __device__ __forceinline__ void reject(int i, int s, float now, bool release) {
    if (release) {
      release_ram(i, s, now);
      if (a.has_conn) sadd(S_CONN, s, -1);
    }
    free_slot(i);
    n_rejected += 1;
    breaker_server_report(i, true, now);
  }

  // ---- _exit_flow ----
  __device__ __forceinline__ void exit_flow(uint32_t it, int i, int s, float now) {
    release_ram(i, s, now);
    if (kControls && a.has_conn) sadd(S_CONN, s, -1);
    // departing the routed target is the breaker's success signal
    breaker_server_report(i, false, now);
    const int e = itab(a.exit_edge, a.NS, s);
    const int kind = itab(a.exit_kind, a.NS, s);
    const int target = itab(a.exit_target, a.NS, s);
    bool dropped;
    float delay;
    edge_draw(it, 48, e, now, dropped, delay);
    const float arrive = now + delay;
    if (kWorkload && a.has_llm && !dropped && kind == TARGET_CLIENT && arrive < a.horizon) {
      // the cost moments of a request that reached the client in time
      const float cost = pgetf(R_LLM, i);
      llm_sum = llm_sum + cost;
      llm_sumsq = llm_sumsq + cost * cost;
    }
    if (dropped) {
      free_slot(i);
      n_dropped += 1;
    } else if (kind == TARGET_CLIENT) {
      if (arrive < a.horizon) complete(pgetf(R_START, i), arrive);
      free_slot(i);
    } else if (kind == TARGET_SERVER) {
      set_ev_srv(i, EV_ARRIVE_SRV, target);
      set_t(i, arrive);
    } else if (kind == TARGET_LB) {
      set_ev(i, EV_ARRIVE_LB);
      set_t(i, arrive);
    }
    pset(R_LBSLOT, i, -1);
  }

  // ---- _seg_start for CPU, IO and END, with the ready-queue shed ----
  __device__ __forceinline__ void seg_start(uint32_t it, int i, int s, int ep, int seg, float now) {
    const int sidx = seg_idx(s, ep, seg);
    const int kind = itab(a.seg_kind, n_seg_tab(), sidx);
    const float dur = ftab(a.seg_dur, n_seg_tab(), sidx);
    if (kind == SEG_CPU) {
      const bool can_take = sget(S_CORES, s) > 0 && !(sget(S_CPU_WAIT, s) > 0);
      if (can_take) {
        sadd(S_CORES, s, -1);
        set_ev(i, EV_SEG_END);
        set_t(i, now + dur);
      } else {
        if (kControls && a.has_shed) {
          const int cap = itab(a.queue_cap, a.NS, s);
          if (cap >= 0 && sget(S_CPU_WAIT, s) >= cap) {
            pset(R_SEG, i, seg);
            reject(i, s, now, true);  // joining a full ready queue: shed
            return;
          }
        }
        const int ticket = sget(S_CPU_TICKET, s) + 1;
        sset(S_CPU_TICKET, s, ticket);
        sadd(S_CPU_WAIT, s, 1);
        set_ev(i, EV_WAIT_CPU);
        set_t(i, kInf);
        pset(R_TICKET, i, ticket);
        if (kControls && a.has_timeout) psetf(R_WAIT_T, i, now);
      }
    } else if (kind == SEG_IO) {
      set_ev(i, EV_SEG_END);
      set_t(i, now + dur);
    } else if (kWorkload) {
      seg_start_workload(it, i, s, sidx, kind, dur, now);
    }
    pset(R_SEG, i, seg);
    if (kind == SEG_END) exit_flow(it, i, s, now);
  }

  // ---- _seg_start for a cache mixture or an LLM call (sleeps), or a DB
  // query (acquire a connection, or wait FIFO for one) ----
  __device__ __forceinline__ void seg_start_workload(uint32_t it, int i, int s, int sidx, int kind,
                                                     float dur,
                                     float now) {
    const int n = n_seg_tab();
    if (a.has_cache && kind == SEG_CACHE) {
      // a miss sleeps the backing store's latency
      work[W_CACHE] += 1;
      if (one(it, 24, 0) >= ftab(a.seg_hit_prob, n, sidx)) {
        dur = ftab(a.seg_miss_dur, n, sidx);
      }
    } else if (a.has_llm && kind == SEG_LLM) {
      // output tokens: the exp-sum counting process on site 25, seq 0, 1, ...
      const int tokens = exp_sum_count(it, 25, fmaxf(ftab(a.seg_llm_tokens, n, sidx), 1e-6f));
      work[W_LLM_DRAWS] += tokens + 1;
      const float tk = (float)tokens;
      dur = dur + tk * ftab(a.seg_llm_tpt, n, sidx);
      // a request may make several calls: their costs add up
      psetf(R_LLM, i, pgetf(R_LLM, i) + tk * ftab(a.seg_llm_cost, n, sidx));
    } else if (a.has_db && kind == SEG_DB) {
      if (sget(S_DB_FREE, s) > 0 && !(sget(S_DB_WAIT, s) > 0)) {
        sadd(S_DB_FREE, s, -1);
      } else {
        work[W_DB_WAIT] += 1;
        const int ticket = sget(S_DB_TICKET, s) + 1;
        sset(S_DB_TICKET, s, ticket);
        sadd(S_DB_WAIT, s, 1);
        set_ev(i, EV_WAIT_DB);
        set_t(i, kInf);
        pset(R_TICKET, i, ticket);
        return;
      }
    } else {
      return;
    }
    set_ev(i, EV_SEG_END);
    set_t(i, now + dur);
  }

  // ---- _spawn_branch: the spawning generator's entry chain of `len`
  // edges from draw site `site0` (a stride of 4 an edge), its entry event
  // and target, then its next arrival ----
  __device__ __forceinline__ void spawn(uint32_t it, float now) {
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

  __device__ __forceinline__ void spawn_chain(uint32_t it, float now, const int32_t* chain, int len,
                              int site0, int entry_ev, int entry_target) {
    n_generated += 1;
    float t_cur = now;
    for (int j = 0; j < len; ++j) {
      bool dropped;
      float delay;
      // a spike applies at the time the request reaches this edge
      edge_draw(it, site0 + 4 * j, chain[j], t_cur, dropped, delay);
      if (dropped) {
        n_dropped += 1;
        return;
      }
      t_cur = t_cur + delay;
    }
    const int slot = first_idle();
    if (slot < 0) {
      n_overflow += 1;
      return;
    }
    set_ev_srv(slot, entry_ev, entry_target);
    set_t(slot, t_cur);
    psetf(R_START, slot, now);
    pset(R_LBSLOT, slot, -1);
    psetf(R_RAM, slot, 0.0f);
    pset(R_TICKET, slot, kNoTicket);
    if (kWorkload && a.has_llm) psetf(R_LLM, slot, 0.0f);
  }

  // does LB slot o admit a request (closed, or half-open with a probe free)?
  __device__ __forceinline__ bool cb_admits(int o) const {
    if (o < 0 || o >= a.EL) return false;
    const int state = lget(L_CB_STATE, o);
    return state == CB_CLOSED || (state == CB_HALF_OPEN && lget(L_CB_PROBES, o) < a.cb_probes);
  }

  // least connections among positions j < lb_len that pass `admit` (every
  // position when admit is false): first minimum of conn * EL + position;
  // returns -1 when no position qualifies
  __device__ __forceinline__ int lc_pick(bool breaker) const {
    long long best_key = 1LL << 30;
    int best = -1;
    for (int j = 0; j < a.EL && j < lb_len; ++j) {
      const int o = lget(L_ORDER, j);
      if (breaker && !cb_admits(o)) continue;
      const int conn = (o >= 0 && o < a.EL) ? lget(L_CONN, o) : 0;
      const long long key = (long long)conn * a.EL + j;
      if (key < best_key) {
        best_key = key;
        best = j;
      }
    }
    return best;
  }

  // ---- _arrive_lb_branch with _lb_pick / _lb_pick_breaker ----
  __device__ __forceinline__ void arrive_lb(uint32_t it, int i, float now) {
    if (a.EL == 0) return;
    if (lb_len <= 0) {
      free_slot(i);
      n_dropped += 1;
      return;
    }
    int slot;
    if (kControls && a.cb_threshold > 0) {
      // lazy cooldown expiry over every slot: open slots whose cooldown
      // elapsed turn half-open with fresh probe counts
      for (int j = 0; j < a.EL; ++j) {
        if (lget(L_CB_STATE, j) == CB_OPEN && now >= lgetf(L_CB_UNTIL, j)) {
          lset(L_CB_STATE, j, CB_HALF_OPEN);
          lset(L_CB_PROBES, j, 0);
          lset(L_CB_OK, j, 0);
        }
      }
      slot = -1;
      if (a.lb_algo == 0) {
        // round robin: the first admitting member moves to the tail
        for (int j = 0; j < a.EL && j < lb_len; ++j) {
          if (cb_admits(lget(L_ORDER, j))) {
            slot = lget(L_ORDER, j);
            break;
          }
        }
        if (slot >= 0) {
          rot_remove(slot);
          rot_insert(slot);
        }
      } else {
        const int best = lc_pick(true);
        if (best >= 0) slot = lget(L_ORDER, best);
      }
      if (slot < 0) {
        // no member admits: the LB refuses the request
        n_rejected += 1;
        free_slot(i);
        return;
      }
      const bool probe = lget(L_CB_STATE, slot) == CB_HALF_OPEN;
      if (probe) ladd(L_CB_PROBES, slot, 1);
      pset(R_CBSLOT, i, slot);
      pset(R_PROBE, i, probe ? 1 : 0);
    } else if (a.lb_algo == 0) {
      // round robin: take the head, rotate it to the tail of the length-prefix
      slot = lget(L_ORDER, 0);
      for (int j = 0; j < lb_len - 1; ++j) lset(L_ORDER, j, lget(L_ORDER, j + 1));
      lset(L_ORDER, lb_len - 1, slot);
    } else {
      slot = lget(L_ORDER, max(lc_pick(false), 0));
    }
    const int e = itab(a.lb_edge_index, a.EL, slot);
    bool dropped;
    float delay;
    edge_draw(it, 32, e, now, dropped, delay);
    if (dropped) {
      // a dropped send on the routing edge is a connection failure
      breaker_server_report(i, true, now);
      free_slot(i);
      n_dropped += 1;
      return;
    }
    if (slot >= 0 && slot < a.EL) ladd(L_CONN, slot, 1);
    set_ev_srv(i, EV_ARRIVE_SRV, itab(a.lb_target, a.EL, slot));
    set_t(i, now + delay);
    pset(R_LBSLOT, i, slot);
  }

  // ---- _arrive_srv_branch: rate limit, connection cap, endpoint pick,
  // RAM-first admission ----
  __device__ __forceinline__ void arrive_srv(uint32_t it, int i, float now) {
    const int s = srv_of(i);
    if (a.EL > 0) {
      const int lbslot = pget(R_LBSLOT, i);
      if (lbslot >= 0 && lbslot < a.EL) ladd(L_CONN, lbslot, -1);
      pset(R_LBSLOT, i, -1);
    }
    if (kControls && a.has_rl) {
      // token bucket: lazy refill at arrival, refuse without a whole token
      const float rps = ftab(a.rate_limit, a.NS, s);
      if (rps >= 0.0f) {
        work[W_REFILL] += 1;
        const float refill = (now - sgetf(S_RL_LAST, s)) * fmaxf(rps, 0.0f);
        const float tokens = fminf(ftab(a.rate_burst, a.NS, s), sgetf(S_RL_TOK, s) + refill);
        const bool limited = tokens < 1.0f;
        ssetf(S_RL_TOK, s, tokens - (limited ? 0.0f : 1.0f));
        ssetf(S_RL_LAST, s, now);
        if (limited) {
          reject(i, s, now, false);
          return;
        }
      }
    }
    if (kControls && a.has_conn) {
      // the server refuses an arrival when it holds its cap of residents
      const int cap = itab(a.conn_cap, a.NS, s);
      if (cap >= 0 && sget(S_CONN, s) >= cap) {
        reject(i, s, now, false);
        return;
      }
      sadd(S_CONN, s, 1);
    }
    const float u = one(it, 4, 0);
    const int nep = itab(a.n_endpoints, a.NS, s);
    int ep = 0;
    for (int k = 0; k < a.NEP; ++k) {
      ep += ftab(a.ep_cum, a.NS * a.NEP, s * a.NEP + k) <= u ? 1 : 0;
    }
    ep = min(ep, nep - 1);
    pset(R_EP, i, ep);
    if (!a.has_ram) {
      seg_start(it, i, s, ep, 0, now);
      return;
    }
    const float need = ftab(a.ep_ram, a.NS * a.NEP, s * a.NEP + ep);
    psetf(R_RAM, i, need);
    const bool waiters = sget(S_RAM_WAIT, s) > 0;
    const bool granted = need <= 0.0f || (!waiters && sgetf(S_RAM, s) >= need);
    if (granted) {
      ssetf(S_RAM, s, sgetf(S_RAM, s) + (-need));
      seg_start(it, i, s, ep, 0, now);
    } else {
      const int ticket = sget(S_RAM_TICKET, s) + 1;
      sset(S_RAM_TICKET, s, ticket);
      sadd(S_RAM_WAIT, s, 1);
      set_ev(i, EV_WAIT_RAM);
      set_t(i, kInf);
      pset(R_TICKET, i, ticket);
    }
  }

  // the duration of slot j's current segment
  __device__ __forceinline__ float seg_dur_of(int j) const {
    return ftab(a.seg_dur, n_seg_tab(), seg_idx(srv_of(j), pget(R_EP, j), pget(R_SEG, j)));
  }

  // ---- _cpu_handoff: release a core of s or grant it to the head FIFO
  // waiter; a grantee past its dequeue deadline takes it for zero service
  // as an abandon event at `now` ----
  __device__ __forceinline__ void cpu_handoff(int s, float now) {
    if (sget(S_CPU_WAIT, s) > 0) {
      int j;
      if (head_waiter(EV_WAIT_CPU, s, j) < kNoTicket) {
        int ev_next = EV_SEG_END;
        float t_next = now + seg_dur_of(j);
        if (kControls && a.has_timeout) {
          const float deadline = ftab(a.queue_timeout, a.NS, s);
          if (deadline >= 0.0f && now - pgetf(R_WAIT_T, j) > deadline) {
            ev_next = EV_ABANDON;
            t_next = now;
          }
        }
        sadd(S_CPU_WAIT, s, -1);
        set_ev(j, ev_next);
        set_t(j, t_next);
        pset(R_TICKET, j, kNoTicket);
        return;
      }
    }
    sadd(S_CORES, s, 1);
  }

  // ---- _abandon_branch ----
  __device__ __forceinline__ void abandon(int i, float now) {
    const int s = srv_of(i);
    cpu_handoff(s, now);
    reject(i, s, now, true);
  }

  // ---- the DB connection handoff of _seg_end_branch: grant it to the
  // head FIFO waiter, whose query runs for its own segment's duration, or
  // release it ----
  __device__ __forceinline__ void db_handoff(int s, float now) {
    if (sget(S_DB_WAIT, s) > 0) {
      int j;
      if (head_waiter(EV_WAIT_DB, s, j) < kNoTicket) {
        work[W_DB_GRANT] += 1;
        sadd(S_DB_WAIT, s, -1);
        set_ev(j, EV_SEG_END);
        set_t(j, now + seg_dur_of(j));
        pset(R_TICKET, j, kNoTicket);
        return;
      }
    }
    sadd(S_DB_FREE, s, 1);
  }

  // ---- _seg_end_branch: the core handoff, the DB handoff, the next
  // segment ----
  __device__ __forceinline__ void seg_end(uint32_t it, int i, float now) {
    const int s = srv_of(i), ep = pget(R_EP, i), seg = pget(R_SEG, i);
    const int kind = itab(a.seg_kind, n_seg_tab(), seg_idx(s, ep, seg));
    if (kind == SEG_CPU) cpu_handoff(s, now);
    if (kWorkload && a.has_db && kind == SEG_DB) db_handoff(s, now);
    seg_start(it, i, s, ep, seg + 1, now);
  }

  // every lane zeroes and fills its share of the state; the barrier at the
  // end hands each word to its owner
  __device__ __forceinline__ void init_state() {
    for (int j = lane; j < a.P; j += kLanes) {
      *pf(R_T, j) = kInf;
      *pi(R_EVSRV, j) = EV_IDLE;  // server 0
      *pi(R_TICKET, j) = kNoTicket;
      *pi(R_EP, j) = 0;
      *pi(R_SEG, j) = 0;
      *pf(R_RAM, j) = 0.0f;
      *pf(R_START, j) = 0.0f;
      *pi(R_LBSLOT, j) = -1;
      *pf(R_WAIT_T, j) = 0.0f;
      *pi(R_CBSLOT, j) = -1;
      *pi(R_PROBE, j) = 0;
      *pf(R_LLM, j) = 0.0f;
    }
    for (int s = lane; s < a.NS; s += kLanes) {
      *si(S_CORES, s) = a.server_cores[s];
      *as_float(si(S_RAM, s)) = a.server_ram[s];
      *si(S_CPU_TICKET, s) = 0;
      *si(S_RAM_TICKET, s) = 0;
      *si(S_CPU_WAIT, s) = 0;
      *si(S_RAM_WAIT, s) = 0;
      *si(S_CONN, s) = 0;
      *as_float(si(S_RL_TOK, s)) = kControls && a.has_rl ? a.rate_burst[s] : 0.0f;
      *as_float(si(S_RL_LAST, s)) = 0.0f;
      *si(S_DB_FREE, s) = kWorkload && a.has_db ? a.db_pool[s] : 0;
      *si(S_DB_TICKET, s) = 0;
      *si(S_DB_WAIT, s) = 0;
    }
    for (int j = lane; j < lb_width(a); j += kLanes) {
      *li(L_ORDER, j) = j;
      *li(L_CONN, j) = 0;
      *li(L_CB_STATE, j) = CB_CLOSED;
      *as_float(li(L_CB_UNTIL, j)) = 0.0f;
      *li(L_CB_CONSEC, j) = 0;
      *li(L_CB_PROBES, j) = 0;
      *li(L_CB_OK, j) = 0;
    }
    for (int g = lane; g < a.G; g += kLanes) {
      *as_float(gi(G_NOW, g)) = 0.0f;
      *as_float(gi(G_WEND, g)) = 0.0f;
      *gi(G_WIDX, g) = -1;
      *as_float(gi(G_NEXT, g)) = 0.0f;
    }
    for (int b = lane; b < a.B; b += kLanes) a.hist[(size_t)sid * a.B + b] = 0;
    for (int b = lane; b < a.TH; b += kLanes) a.thr[(size_t)sid * a.TH + b] = 0;
    __syncwarp();
  }

  __device__ __forceinline__ void run(int32_t* shared, int shared_fields) {
    // the pool's scanned fields in shared memory where the layout put them
    // there, the rest after them in this scenario's global scratch
    int32_t* pool_gl = a.pool_scratch + (size_t)sid * (N_POOL - shared_fields) * a.P;
    srv_rec = shared;
    lb_rec = srv_rec + N_SRV * a.NS;
    gen_rec = lb_rec + N_LB * lb_width(a);
    scan_rec = shared_fields == N_SCAN ? shared + state_words(a) : pool_gl;
    rest_rec = shared_fields == N_SCAN ? pool_gl : pool_gl + N_SCAN * a.P;
    k0 = (uint32_t)a.k0[sid];
    k1 = (uint32_t)a.k1[sid];
    init_state();
    lb_len = a.EL;
    tl_ptr = 0;
    tab_it = 0x80000000u;  // covers no iteration yet
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
      if (kTableSpan > 0 && (uint32_t)it - tab_it >= (uint32_t)kTableSpan) fill_table(it);
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
        switch (ev_of(nxt_i)) {
          case EV_ARRIVE_LB:
            arrive_lb(it, nxt_i, now);
            break;
          case EV_ARRIVE_SRV:
            arrive_srv(it, nxt_i, now);
            break;
          case EV_RESUME:
            if (a.has_ram) seg_start(it, nxt_i, srv_of(nxt_i), pget(R_EP, nxt_i), 0, now);
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
    if (lane != 0) return;
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

// one warp a scenario; a block holds blockDim.x / kLanes of them, each with
// its own region of the dynamic shared memory
template <bool kEvents, bool kControls, bool kWorkload>
__global__ void __launch_bounds__(kThreads, kMinBlocks) des_kernel(const DesArgs args) {
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int sid = blockIdx.x * warps + warp;
  if (sid >= args.S) return;
  DesLayout lay;
  layout_of(args, lay);
  Sim<kEvents, kControls, kWorkload> sim(args, sid, threadIdx.x % kLanes);
  sim.run(des_smem + (size_t)warp * lay.warp_words, lay.shared_fields);
}

// Launch the instance on `stream`, or with `occupancy` set, store there the
// blocks an SM holds at this layout instead.
template <bool kEvents, bool kControls, bool kWorkload>
int launch(const DesArgs& args, const DesLayout& lay, cudaStream_t stream, int* occupancy) {
  const int threads = lay.warps * kLanes;
  const int rc = (int)cudaFuncSetAttribute(des_kernel<kEvents, kControls, kWorkload>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           lay.shared_bytes);
  if (rc != 0) return rc;
  if (occupancy != nullptr) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, des_kernel<kEvents, kControls, kWorkload>, threads, lay.shared_bytes);
  }
  const int blocks = (args.S + lay.warps - 1) / lay.warps;
  des_kernel<kEvents, kControls, kWorkload><<<blocks, threads, lay.shared_bytes, stream>>>(args);
  return (int)cudaGetLastError();
}

#ifndef DES_WORKLOAD
#define DES_WORKLOAD 0
#endif
constexpr bool kLibraryWorkload = DES_WORKLOAD != 0;

// The instance that compiles in the plan's features, launched or queried.
int dispatch(const DesArgs& args, cudaStream_t stream, int* occupancy) {
  DesLayout lay;
  if (layout_of(args, lay) != 0) return kTooLarge;
  const bool events = (lay.instance & INST_EVENTS) != 0;
  const bool controls = (lay.instance & INST_CONTROLS) != 0;
  if (((lay.instance & INST_WORKLOAD) != 0) != kLibraryWorkload) return kWrongBuild;
  if (occupancy == nullptr && lay.global_words > 0 && args.pool_scratch == nullptr) {
    return kNoScratch;
  }
  constexpr bool w = kLibraryWorkload;
  if (events) {
    return controls ? launch<true, true, w>(args, lay, stream, occupancy)
                    : launch<true, false, w>(args, lay, stream, occupancy);
  }
  return controls ? launch<false, true, w>(args, lay, stream, occupancy)
                  : launch<false, false, w>(args, lay, stream, occupancy);
}

}  // namespace

extern "C" int des_args_size() { return (int)sizeof(DesArgs); }

// Does this build hold the instances with the workload group (cache, LLM,
// DB pools, several generators)?
extern "C" int des_workload() { return kLibraryWorkload ? 1 : 0; }

// The layout a launch of these arguments takes, as DesLayout's seven int32
// fields; returns 0, or kTooLarge when a scenario's state exceeds a block.
extern "C" int des_layout(const DesArgs* args, int32_t* out) {
  DesLayout lay;
  const int rc = layout_of(*args, lay);
  out[0] = lay.placement;
  out[1] = lay.warps;
  out[2] = lay.shared_bytes;
  out[3] = lay.shared_fields;
  out[4] = lay.warp_words;
  out[5] = lay.global_words;
  out[6] = lay.instance;
  return rc;
}

// Launch on `stream` (a cudaStream_t as a pointer), on the instance that
// compiles in the plan's features; returns cudaGetLastError(), kWrongBuild
// when the plan needs the other build's instances, kTooLarge, or
// kNoScratch when the layout needs global scratch and none was given.
extern "C" int des_launch(const DesArgs* args, void* stream) {
  return dispatch(*args, (cudaStream_t)stream, nullptr);
}

// The blocks an SM holds of the instance and layout these arguments launch
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), stored in *blocks;
// returns as des_launch.
extern "C" int des_occupancy(const DesArgs* args, int32_t* blocks) {
  return dispatch(*args, nullptr, blocks);
}
