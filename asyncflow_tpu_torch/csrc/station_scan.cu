// FIFO station recursions of the scan fast path on Hopper (sm_90a).
//
// Replaces the XLA scans of the reference's fast path
// (asyncflow_tpu/engines/jaxsim/fastpath.py): the max-plus associative
// scan of _lindley_waits (:278), the Kiefer-Wolfowitz lax.scan of
// _kw_waits (:198), the joint RAM-slot and core lax.scan of
// _ram_core_scan (:233), the arrival token bucket's lax.scan,
// _token_bucket_scan (:302), and the overload controls' lax.scans,
// _controlled_station_scan (:331) and _socket_station_scan (:374).  Each
// row of the (S, m) inputs is one station's time-sorted stream of one
// scenario, walked in order with the station's state:
//
//   mode 0 (c = 1)  C_k = max(A_k + S_k, C_{k-1} + S_k),
//                   wait_k = max(0, (C_k - S_k) - A_k);
//   mode 1 (c > 1)  the ascending vector of the c core-free times: wait on
//                   the first, replace it by max(f_0, A_k) + S_k, re-sort;
//   mode 2          the ram_k admission-slot and c core-free vectors:
//                   grant g = max(A, r_0), start s = max(g + pre, w_0)
//                   (g + pre for an empty burst), release s + S + post;
//                   outputs (g - A, s - (g + pre), release);
//   mode 3          the token bucket of ``burst`` tokens refilled at
//                   ``rate`` a second, full at time 0: tok = min(burst,
//                   tokens + (A_k - last) * rate) (three roundings);
//                   accept where valid and tok >= 1, spending one; the
//                   tokens and the clock ``last`` advance on every valid
//                   element, refused ones included; output the accepted
//                   flag (a byte);
//   mode 4          the controlled queue: the c core-free times and a ring
//                   of the last r = max(cap, 1) grants; over enqueue times
//                   e: shed where cap >= 0 and the ring's oldest grant lies
//                   after e; g = max(e, w_0), wait g - e; abandoned where
//                   live (not shed), timeout >= 0 and wait > timeout; a live
//                   element inserts g + S (g if abandoned) and pushes g;
//                   outputs the wait and a flag byte (1 shed, 2 abandoned);
//   mode 5          the socket queue, in arrival order: mode 4's carry and
//                   the sorted vector of the conn connections' exit times
//                   (-inf at first); refused where its first exit lies after
//                   the arrival; the shed and deadline tests on burst
//                   elements only; a live element inserts its exit (e if
//                   shed, g if abandoned, g + S + post if served, a + post
//                   if io-only), a burst one that is not shed takes a core
//                   and pushes g; flag 4 refused.
//
// Invalid elements leave the carry unchanged, so a row may interleave
// other stations' lanes.  Built with --fmad=false: each float operation
// rounds as the plain PyTorch version's does.
//
// Bound: bytes.  An element is read once (arrival, service, validity;
// pre-IO and post-IO in mode 2) and its outputs written once, for a few
// float operations.  A row is sequential, and a K-server FIFO has no cheap
// associative form (a K x K max-plus product a combine), so the
// parallelism is across rows and across the carry vector.  Two walks:
//
// The thread walk (modes 0 and 3, mode 4 with one core; the carry modes past
// kWarpWidthMax entries): one
// thread a row, 16 rows a block (half a warp: the lanes of a warp read
// different rows, one L1 wavefront each, so the wavefronts, not the lanes,
// are the cost, and 16-row blocks spread the 2048 rows over 128 SMs).  It
// moves 16 bytes a lane an instruction: the elements before the row's first
// 16-byte boundary one at a time, then kVec elements at a time as float4 /
// uchar4 vectors (their loads issued together), then the tail; each lane
// prefetches into L1 the lines of its row kAhead elements on.  Mode 0
// carries one float; a carry past kWarpWidthMax entries (a core count the
// schema does not bound) lives in global scratch the wrapper allocates,
// with the shifting insertion (MemVec).  scripts/torch_scan_variants.py
// times other block sizes and prefetch distances (-DSTATION_ROWS,
// -DSTATION_AHEAD).
//
// The controlled and socket modes keep their ring as a circular buffer
// with a head index (the reference's shift only reorders storage: its first
// entry is the buffer's head): in the block's shared memory on the thread
// walk, spread over the warp's lanes on the warp walk (entry j on lane
// j % 32, read by a shuffle from its owner, written by it).  Their walks are
// simple, one element at a time on the thread walk; making them fast is
// later work.
//
// The warp walk (modes 1, 2, 5 and mode 4 past one core, up to
// kWarpWidthMax entries a vector; the socket mode's connections in the
// RAM-core mode's place of the RAM slots): one warp a row, kWarps rows a
// block.  A carry vector wider than kWholeMax entries
// is spread over the lanes: lane l holds entries [l E, (l + 1) E), E the
// smallest power of two that covers the vector over the lanes; a narrower
// one (one core, a pool of two) is held whole on every lane, as RegVec
// held it (a template pair (E, span) a vector, padded with +inf).  The
// insertion is RegVec's selects, unchanged: entry j becomes f[j+1] where
// that is below x, else x where f[j] is (or j is 0), else stays; a spread
// vector's last entry on a lane takes lane l + 1's first with one
// __shfl_down_sync of the vector before x is known.  Every lane computes
// the element's chain (grant, start, release) itself, from a replica of
// the vector's first entry, which it updates as lane 0 does from the
// vector's second entry (broadcast from its owner before x is known).
// Both shuffles read the vector as the element before left it, so they run
// beside the element's chain of about eight dependent float operations,
// not after it.  An invalid element inserts the vector's first entry,
// which leaves it as it was bit for bit, so the walk takes no branch an
// element.  The row's elements come in coalesced, a 128-byte line a load
// instruction (a lane an element, in groups of kGroup on the rows' line
// boundaries; the elements of a row's first and last group outside it
// load as invalid), staged through shared memory (one group walked while
// the next one's loads are in flight in registers) and read back as float4
// broadcasts, four elements a load; a lane keeps the outputs of its own
// element of the group by a select and stores them coalesced.  At 2048
// rows the walk is bound by the SM's shuffle and shared-load pipe (two
// shuffles an element a spread vector), not by the chain.
//
// The warp walk is instantiated for each form of its vectors (a power of
// two entries, whole or spread) that a launch can reach: modes 1 and 4 at
// each core form, mode 2 at each pair of RAM-slot and core forms, mode 5
// at each core form with its connections (at most kRingMax) in the one
// form that holds any of them, spread at kRingPer entries a lane (the
// +inf padding past the live entries leaves the walk's results as they
// are at a narrower form).
//
// The host build (tests/test_torch_fast_host.py) compiles this source with
// g++ at one lane a row (kLanes = 1: one lane holds the whole vector, the
// shuffles are identities), so the host tests hold the same code to the
// plain versions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct StationArgs {
  const float* a;        // (S, m) sorted arrival / enqueue times
  const float* d;        // (S, m) service
  const uint8_t* v;      // (S, m) validity
  const float* pre;      // (S, m) pre-burst IO (mode 2)
  const float* post;     // (S, m) post-burst IO (mode 2)
  float* out0;           // waits; admission waits in mode 2
  float* out1;           // core waits (mode 2)
  float* out2;           // departures (mode 2)
  float* scratch;        // (S, ram_k + cores) carries of the global walk, else unused
  uint8_t* flag;         // (S, m) accepted flags (mode 3); shed, abandoned, refused bits (4, 5)
  const float* e;        // (S, m) enqueue times (mode 5; mode 4's come in a)
  const uint8_t* b;      // (S, m) burst flags (mode 5)
  int64_t S;
  int64_t m;
  int32_t mode;
  int32_t cores;
  int32_t ram_k;
  int32_t cap;    // modes 4, 5: the ready-queue cap (< 0: none)
  int32_t conn;   // mode 5: the connection cap
  float rate;     // mode 3: tokens refilled a second
  float burst;    // mode 3: the bucket's size (and its tokens at time 0)
  float timeout;  // modes 4, 5: the dequeue deadline (< 0: none)
};

namespace {

#ifndef STATION_ROWS
#define STATION_ROWS 16
#endif
#ifndef STATION_AHEAD
#define STATION_AHEAD 256
#endif
constexpr int kRows = STATION_ROWS;    // rows (threads) a block of the thread walk
constexpr int kVec = 16;               // elements a vector step: 4 float4
constexpr int kAhead = STATION_AHEAD;  // elements prefetched ahead (0: none)
constexpr float kInf = 1e30f;
constexpr unsigned kAll = 0xffffffffu;

// lanes a row of the warp walk runs on: a warp on the card, one in the host
// build
#ifdef __CUDACC__
constexpr int kLanes = 32;
#else
constexpr int kLanes = 1;
#endif
constexpr int kWarpWidthMax = 1024;                  // carry entries the warp walk holds
constexpr int kMaxEntries = kWarpWidthMax / kLanes;  // a lane's, at most
constexpr int kWholeMax = 4;                         // vectors whole on every lane up to this
constexpr int kWarps = 4;                            // rows (warps) a block of the warp walk
constexpr int kGroup = 32;                           // elements a group: a 128-byte line
constexpr int kPerLane = kGroup / kLanes;            // of them, a lane's
constexpr int kRingMax = 128;                        // ring entries and connections (4, 5)
constexpr int kRingPer = kRingMax / kLanes;          // ring entries a lane (warp walk)

// which walk a launch takes (station_scan_walk)
constexpr int kWalkThread = 0;
constexpr int kWalkWarp = 1;
constexpr int kWalkGlobal = 2;

__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// ---------------------------------------------------------------------------
// the thread walk
// ---------------------------------------------------------------------------

// An ascending vector of c floats in global scratch, with the shifting
// insertion: replace f[0] by x (never below it) and sort again, x first
// among ties.
struct MemVec {
  float* f;
  int c;

  __device__ __forceinline__ void init(float value = 0.0f) {
    for (int j = 0; j < c; ++j) f[j] = value;
  }
  __device__ __forceinline__ float first() const { return f[0]; }
  __device__ __forceinline__ void insert_first(float x) {
    int i = 1;
    while (i < c && f[i] < x) {
      f[i - 1] = f[i];
      ++i;
    }
    f[i - 1] = x;
  }
};

// A row's state in mode kMode and the step of one element: its outputs
// from (arrival, service, validity, pre-IO, post-IO).
template <int kMode>
struct Station {
  MemVec& wc;
  MemVec& wr;
  float c;  // mode 0: the last completion

  __device__ __forceinline__ void step(float ak, float dk, bool ok, float pk, float qk,
                                       float& o0, float& o1, float& o2) {
    if (kMode == 0) {
      const float svc = ok ? dk : 0.0f;
      const float arr = ok ? ak : 0.0f;
      const float b = ok ? arr + svc : -kInf;
      c = fmaxf(b, c + svc);
      o0 = fmaxf((c - svc) - arr, 0.0f);
    } else if (kMode == 1) {
      if (ok) {
        const float f0 = wc.first();
        o0 = fmaxf(f0 - ak, 0.0f);
        wc.insert_first(fmaxf(f0, ak) + dk);
      } else {
        o0 = 0.0f;
      }
    } else {
      const float g = fmaxf(ak, wr.first());
      const float enq = g + pk;
      const float start = dk > 0.0f ? fmaxf(enq, wc.first()) : enq;
      const float rel = (start + dk) + qk;
      if (ok) {
        if (dk > 0.0f) wc.insert_first(start + dk);
        wr.insert_first(rel);
      }
      o0 = g - ak;
      o1 = start - enq;
      o2 = rel;
    }
  }
};

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ bool lane_of(const uchar4& v, int i) {
  return (i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w) != 0;
}
__device__ __forceinline__ void set_lane(float4& v, int i, float x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

// One row's walk in mode kMode by one thread; wc and wr are its core and
// RAM-slot vectors (unused in mode 0).
template <int kMode>
__device__ __forceinline__ void walk(const StationArgs& a, int64_t row, MemVec& wc, MemVec& wr) {
  const int64_t base = row * a.m;
  const float* __restrict__ A = a.a + base;
  const float* __restrict__ D = a.d + base;
  const uint8_t* __restrict__ V = a.v + base;
  const float* __restrict__ P = kMode == 2 ? a.pre + base : nullptr;
  const float* __restrict__ Q = kMode == 2 ? a.post + base : nullptr;
  float* __restrict__ W0 = a.out0 + base;
  float* __restrict__ W1 = kMode == 2 ? a.out1 + base : nullptr;
  float* __restrict__ W2 = kMode == 2 ? a.out2 + base : nullptr;
  Station<kMode> st{wc, wr, -kInf};

  const auto one = [&](int64_t k) {
    float o0, o1, o2;
    st.step(A[k], D[k], V[k] != 0, kMode == 2 ? P[k] : 0.0f, kMode == 2 ? Q[k] : 0.0f, o0,
            o1, o2);
    W0[k] = o0;
    if (kMode == 2) {
      W1[k] = o1;
      W2[k] = o2;
    }
  };
  // element base + k is 16-byte aligned (as a float) where (base + k) % 4 == 0
  const int64_t lead = (4 - (base & 3)) & 3;
  const int64_t head = lead < a.m ? lead : a.m;
  const int64_t body = head + (a.m - head) / kVec * kVec;
  for (int64_t k = 0; k < head; ++k) one(k);
  for (int64_t k0 = head; k0 < body; k0 += kVec) {
    if (kAhead > 0 && k0 + kAhead < a.m) {
      prefetch_l1(A + k0 + kAhead);
      prefetch_l1(D + k0 + kAhead);
      prefetch_l1(V + k0 + kAhead);
      if (kMode == 2) {
        prefetch_l1(P + k0 + kAhead);
        prefetch_l1(Q + k0 + kAhead);
      }
    }
    float4 av[kVec / 4], dv[kVec / 4], pv[kVec / 4], qv[kVec / 4];
    uchar4 vv[kVec / 4];
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      av[q] = *reinterpret_cast<const float4*>(A + k0 + 4 * q);
      dv[q] = *reinterpret_cast<const float4*>(D + k0 + 4 * q);
      vv[q] = *reinterpret_cast<const uchar4*>(V + k0 + 4 * q);
      if (kMode == 2) {
        pv[q] = *reinterpret_cast<const float4*>(P + k0 + 4 * q);
        qv[q] = *reinterpret_cast<const float4*>(Q + k0 + 4 * q);
      }
    }
    float4 w0[kVec / 4], w1[kVec / 4], w2[kVec / 4];
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float o0, o1, o2;
        st.step(lane_of(av[q], i), lane_of(dv[q], i), lane_of(vv[q], i),
                kMode == 2 ? lane_of(pv[q], i) : 0.0f, kMode == 2 ? lane_of(qv[q], i) : 0.0f,
                o0, o1, o2);
        set_lane(w0[q], i, o0);
        if (kMode == 2) {
          set_lane(w1[q], i, o1);
          set_lane(w2[q], i, o2);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      *reinterpret_cast<float4*>(W0 + k0 + 4 * q) = w0[q];
      if (kMode == 2) {
        *reinterpret_cast<float4*>(W1 + k0 + 4 * q) = w1[q];
        *reinterpret_cast<float4*>(W2 + k0 + 4 * q) = w2[q];
      }
    }
  }
  for (int64_t k = body; k < a.m; ++k) one(k);
}

// The token bucket of one row (mode 3) by one thread: the thread walk's
// head, 16-byte body and tail, a float4 of times and a uchar4 of valid
// flags in, a uchar4 of accepted flags out.
struct Bucket {
  float rate;
  float burst;
  float tokens;
  float last;

  __device__ __forceinline__ bool step(float t, bool v) {
    float tok = fminf(burst, tokens + (t - last) * rate);
    const bool acc = v && tok >= 1.0f;
    tok = tok - (acc ? 1.0f : 0.0f);
    if (v) {
      tokens = tok;
      last = t;
    }
    return acc;
  }
};

__device__ __forceinline__ void bucket_walk(const StationArgs& a, int64_t row) {
  const int64_t base = row * a.m;
  const float* __restrict__ T = a.a + base;
  const uint8_t* __restrict__ V = a.v + base;
  uint8_t* __restrict__ F = a.flag + base;
  Bucket b{a.rate, a.burst, a.burst, 0.0f};
  const int64_t lead = (4 - (base & 3)) & 3;
  const int64_t head = lead < a.m ? lead : a.m;
  const int64_t body = head + (a.m - head) / kVec * kVec;
  for (int64_t k = 0; k < head; ++k) F[k] = b.step(T[k], V[k] != 0) ? 1 : 0;
  for (int64_t k0 = head; k0 < body; k0 += kVec) {
    if (kAhead > 0 && k0 + kAhead < a.m) {
      prefetch_l1(T + k0 + kAhead);
      prefetch_l1(V + k0 + kAhead);
    }
    float4 tv[kVec / 4];
    uchar4 vv[kVec / 4];
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      tv[q] = *reinterpret_cast<const float4*>(T + k0 + 4 * q);
      vv[q] = *reinterpret_cast<const uchar4*>(V + k0 + 4 * q);
    }
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      uchar4 f;
      f.x = b.step(tv[q].x, vv[q].x != 0) ? 1 : 0;
      f.y = b.step(tv[q].y, vv[q].y != 0) ? 1 : 0;
      f.z = b.step(tv[q].z, vv[q].z != 0) ? 1 : 0;
      f.w = b.step(tv[q].w, vv[q].w != 0) ? 1 : 0;
      *reinterpret_cast<uchar4*>(F + k0 + 4 * q) = f;
    }
  }
  for (int64_t k = body; k < a.m; ++k) F[k] = b.step(T[k], V[k] != 0) ? 1 : 0;
}

__global__ void station_scan_kernel(StationArgs a) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.S) return;
  if (a.mode == 3) {
    bucket_walk(a, row);
    return;
  }
  if (a.mode == 0) {
    MemVec none{nullptr, 0};
    walk<0>(a, row, none, none);
    return;
  }
  const int slots = a.mode == 2 ? a.ram_k : 0;
  float* carry = a.scratch + row * (int64_t)(slots + a.cores);
  MemVec wr{carry, slots};
  MemVec wc{carry + slots, a.cores};
  wr.init();
  wc.init();
  if (a.mode == 1) {
    walk<1>(a, row, wc, wc);
  } else {
    walk<2>(a, row, wc, wr);
  }
}

// One core's free time in a register: the one-entry vector.
struct OneCore {
  float f;

  __device__ __forceinline__ float first() const { return f; }
  __device__ __forceinline__ void insert_first(float x) { f = x; }
};

// One row of the controlled (4) or socket (5) mode by one thread, an
// element at a time: the core vector wc, the connections' exit times conn
// (mode 5) and the ring, entry j at ring[j * stride].
template <int kMode, class CoreVec>
__device__ __forceinline__ void control_walk(const StationArgs& a, int64_t row, CoreVec& wc,
                                             MemVec& conn, float* ring, int stride) {
  const int64_t base = row * a.m;
  const float* __restrict__ A = a.a + base;
  const float* __restrict__ E = kMode == 5 ? a.e + base : A;
  const float* __restrict__ D = a.d + base;
  const float* __restrict__ Q = kMode == 5 ? a.post + base : nullptr;
  const uint8_t* __restrict__ B = kMode == 5 ? a.b + base : nullptr;
  const uint8_t* __restrict__ V = a.v + base;
  float* __restrict__ W0 = a.out0 + base;
  uint8_t* __restrict__ F = a.flag + base;
  const bool cap_on = a.cap >= 0;
  const bool to_on = a.timeout >= 0.0f;
  const int r = a.cap > 1 ? a.cap : 1;
  for (int j = 0; j < r; ++j) ring[j * stride] = -kInf;
  int head = 0;
  for (int64_t k = 0; k < a.m; ++k) {
    if (kAhead > 0 && (k & 31) == 0 && k + kAhead < a.m) {
      // the row's lines kAhead elements on, into L1 (the loads below are
      // scalar, one row a thread)
      prefetch_l1(A + k + kAhead);
      prefetch_l1(D + k + kAhead);
      prefetch_l1(V + k + kAhead);
      if (kMode == 5) {
        prefetch_l1(E + k + kAhead);
        prefetch_l1(Q + k + kAhead);
        prefetch_l1(B + k + kAhead);
      }
    }
    const bool ok = V[k] != 0;
    const float ak = A[k], ek = E[k], dk = D[k];
    const bool bk = kMode == 5 ? B[k] != 0 : true;
    const bool refused = kMode == 5 && ok && conn.first() > ak;
    const bool live = ok && !refused;
    const bool shed = live && bk && cap_on && ring[head * stride] > ek;
    const float g = fmaxf(ek, wc.first());
    const float wait = bk ? g - ek : 0.0f;
    const bool through = live && bk && !shed;
    const bool ab = through && to_on && wait > a.timeout;
    if (kMode == 5 && live)
      conn.insert_first(bk ? (shed ? ek : (ab ? g : (g + dk) + Q[k])) : ak + Q[k]);
    if (through) {
      wc.insert_first(g + (ab ? 0.0f : dk));
      ring[head * stride] = g;
      head = head + 1 == r ? 0 : head + 1;
    }
    W0[k] = wait;
    F[k] = (uint8_t)((shed ? 1 : 0) | (ab ? 2 : 0) | (refused ? 4 : 0));
  }
}

// The thread walk of modes 4 and 5: one core in a register (mode 4), or
// the vectors in global scratch (the connections first, then the cores);
// the rows' rings in the block's shared memory, entry j of thread i at
// j * kRows + i.
template <int kMode>
__global__ void control_thread_kernel(StationArgs a) {
  __shared__ float rings[kRingMax * kRows];
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.S) return;
  float* ring = rings + threadIdx.x;
  if (a.scratch == nullptr) {
    OneCore wc{0.0f};
    MemVec none{nullptr, 0};
    control_walk<kMode>(a, row, wc, none, ring, kRows);
    return;
  }
  const int cw = kMode == 5 ? a.conn : 0;
  float* carry = a.scratch + row * (int64_t)(cw + a.cores);
  MemVec conn{carry, cw};
  MemVec wc{carry + cw, a.cores};
  conn.init(-kInf);
  wc.init();
  control_walk<kMode>(a, row, wc, conn, ring, kRows);
}

// ---------------------------------------------------------------------------
// the warp walk
// ---------------------------------------------------------------------------

// A carry vector of the warp walk, ascending, +inf past its live entries:
// over kSpan = kLanes lanes, entries [lane E, (lane + 1) E) on lane
// ``lane``; over kSpan = 1, the whole vector of E entries on every lane
// (RegVec's layout: its insertion takes no shuffle).  Every lane also holds
// a replica of the vector's first entry.
template <int E, int kSpan>
struct LaneVec {
  float f[E];
  float first;

  __device__ __forceinline__ void init(int live, int lane, float value = 0.0f) {
    const int at = kSpan == 1 ? 0 : lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] = at + e < live ? value : INFINITY;
    first = live > 0 ? value : INFINITY;
  }
  // the vector's second entry, from its owner lane; +inf where the vector
  // is one entry wide
  __device__ __forceinline__ float second() const {
    if (kSpan * E == 1) return INFINITY;
    if (kSpan == 1) return f[E >= 2 ? 1 : 0];
    return E >= 2 ? __shfl_sync(kAll, f[E >= 2 ? 1 : 0], 0) : __shfl_sync(kAll, f[0], 1);
  }
  // lane + 1's first entry (not read on the last lane, nor over one lane)
  __device__ __forceinline__ float next_lane() const {
    return kSpan == 1 ? INFINITY : __shfl_down_sync(kAll, f[0], 1);
  }
  // RegVec's insertion of x (never below the first entry) over the whole
  // vector, from ``second`` and ``next`` (second() and next_lane() before
  // it).  Inserting the first entry itself leaves the vector as it is, bit
  // for bit: no entry lies below it.
  __device__ __forceinline__ void insert_first(float x, float second, float next, int lane) {
    const bool head = kSpan == 1 || lane == 0;
    const bool last = kSpan == 1 || lane == kLanes - 1;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool shift = e + 1 < E ? f[e + 1 < E ? e + 1 : e] < x : (!last && next < x);
      const float nx = e + 1 < E ? f[e + 1 < E ? e + 1 : e] : next;
      const float here = ((e == 0 && head) || f[e] < x) ? x : f[e];
      f[e] = shift ? nx : here;
    }
    first = second < x ? second : x;
  }
};

// The ring of the last r grants on the warp walk: entry j on lane
// j % kLanes, in its slot j / kLanes; ``head`` (the oldest entry) and r on
// every lane.
struct LaneRing {
  float f[kRingPer];
  int head;
  int r;

  __device__ __forceinline__ void init(int cap) {
#pragma unroll
    for (int i = 0; i < kRingPer; ++i) f[i] = -kInf;
    head = 0;
    r = cap > 1 ? cap : 1;
  }
  // the oldest entry, from its owner lane (one lane: indexed directly)
  __device__ __forceinline__ float oldest() const {
    if constexpr (kLanes == 1) return f[head];
    const int slot = head / kLanes;
    float x = f[0];
#pragma unroll
    for (int i = 1; i < kRingPer; ++i) x = i == slot ? f[i] : x;
    return __shfl_sync(kAll, x, head % kLanes);
  }
  // where ``on`` (the same on every lane): the oldest entry becomes g
  __device__ __forceinline__ void push(bool on, float g, int lane) {
    const int next = head + 1 == r ? 0 : head + 1;
    if constexpr (kLanes == 1) {
      if (on) f[head] = g;
    } else {
      const int slot = head / kLanes;
      const bool mine = on && head % kLanes == lane;
#pragma unroll
      for (int i = 0; i < kRingPer; ++i) f[i] = mine && i == slot ? g : f[i];
    }
    head = on ? next : head;
  }
};

// How a vector of ``width`` entries lies in the warp walk: up to
// kWholeMax entries whole on every lane, E the smallest power of two that
// covers it (one lane in the host build: always whole); wider, over the
// warp's lanes, E the smallest power of two with kLanes E >= width.
struct Form {
  int entries;
  int span;
};

int pow2_at_least(int width) {
  int e = 1;
  while (e < width) e *= 2;
  return e;
}

Form form_of(int width) {
  if (width <= kWholeMax || kLanes == 1) return {pow2_at_least(width), 1};
  return {pow2_at_least((width + kLanes - 1) / kLanes), kLanes};
}

// The output slot of element p of a group on its owner lane p % kLanes.
__device__ __forceinline__ int own_slot(int p) { return kPerLane == 1 ? 0 : p / kLanes; }

// One row a warp in mode kMode (1, 2, 4 or 5): the RAM-slot vector of ER
// entries a lane over SR lanes (mode 2; the connections' exit times in mode
// 5), the core vector of EC over SC, and the ring (modes 4, 5).  Every
// group of kGroup elements is walked whole: its elements outside the row
// load as invalid, which leave the carry as it is, and their outputs are
// not stored.  An invalid element (or, for the cores, an empty burst; in
// modes 4 and 5 an element that takes no core or connection) inserts the
// vector's first entry, so the walk has no branch an element.
template <int kMode, int ER, int SR, int EC, int SC>
__global__ void __launch_bounds__(kWarps * kLanes) station_scan_warp_kernel(StationArgs a) {
  constexpr bool kTwo = kMode == 2 || kMode == 5;  // a second vector, pre / enqueue and post
  constexpr bool kFlags = kMode == 4 || kMode == 5;
  // a warp's group: arrival, service, pre-IO (mode 5: enqueue) and post-IO
  // as four rows of kGroup floats, the validity bytes and the burst bytes
  __shared__ float4 stage_f[kWarps][4][kGroup / 4];
  __shared__ uchar4 stage_v[kWarps][kGroup / 4];
  __shared__ uchar4 stage_b[kWarps][kGroup / 4];
  const int lane = (int)(threadIdx.x % kLanes);
  const int w = (int)(threadIdx.x / kLanes);
  const int64_t row = (int64_t)blockIdx.x * kWarps + w;
  if (row >= a.S) return;  // the whole warp
  const int64_t m = a.m;
  const int64_t base = row * m;
  const float* __restrict__ A = a.a + base;
  const float* __restrict__ D = a.d + base;
  const uint8_t* __restrict__ V = a.v + base;
  const float* __restrict__ P = kMode == 2 ? a.pre + base : kMode == 5 ? a.e + base : nullptr;
  const float* __restrict__ Q = kTwo ? a.post + base : nullptr;
  const uint8_t* __restrict__ B = kMode == 5 ? a.b + base : nullptr;
  float* __restrict__ W0 = a.out0 + base;
  float* __restrict__ W1 = kMode == 2 ? a.out1 + base : nullptr;
  float* __restrict__ W2 = kMode == 2 ? a.out2 + base : nullptr;
  uint8_t* __restrict__ F = kFlags ? a.flag + base : nullptr;
  float* sf = reinterpret_cast<float*>(stage_f[w]);
  uint8_t* sv = reinterpret_cast<uint8_t*>(stage_v[w]);
  uint8_t* sb = reinterpret_cast<uint8_t*>(stage_b[w]);

  LaneVec<EC, SC> wc;
  LaneVec<ER, SR> wr;
  wc.init(a.cores, lane);
  wr.init(kMode == 2 ? a.ram_k : kMode == 5 ? a.conn : 0, lane, kMode == 5 ? -kInf : 0.0f);
  LaneRing ring;
  ring.init(a.cap);
  const bool cap_on = a.cap >= 0;
  const bool to_on = a.timeout >= 0.0f;

  // groups start on the rows' 128-byte lines: the first one holds
  // (base % kGroup) elements before the row
  const int64_t lead = base % kGroup;
  float xa[kPerLane], xd[kPerLane], xp[kPerLane], xq[kPerLane];
  uint8_t xv[kPerLane], xb[kPerLane];
  const auto load = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int64_t k = k0 + lane + i * kLanes;
      const bool in = k >= 0 && k < m;
      xa[i] = in ? A[k] : 0.0f;
      xd[i] = in ? D[k] : 0.0f;
      xv[i] = in ? V[k] : 0;
      if constexpr (kTwo) {
        xp[i] = in ? P[k] : 0.0f;
        xq[i] = in ? Q[k] : 0.0f;
      }
      if constexpr (kMode == 5) xb[i] = in ? B[k] : 0;
    }
  };
  float o0[kPerLane], o1[kPerLane], o2[kPerLane];
  uint8_t of[kPerLane];
  load(-lead);
  for (int64_t k0 = -lead; k0 < m; k0 += kGroup) {
    // stage this group, then set the next group's loads in flight
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int p = lane + i * kLanes;
      sf[p] = xa[i];
      sf[kGroup + p] = xd[i];
      if constexpr (kTwo) {
        sf[2 * kGroup + p] = xp[i];
        sf[3 * kGroup + p] = xq[i];
      }
      sv[p] = xv[i];
      if constexpr (kMode == 5) sb[p] = xb[i];
    }
    __syncwarp();
    if (k0 + kGroup < m) load(k0 + kGroup);
#pragma unroll
    for (int q = 0; q < kGroup / 4; ++q) {
      const float4 a4 = stage_f[w][0][q];
      const float4 d4 = stage_f[w][1][q];
      const uchar4 v4 = stage_v[w][q];
      float4 p4{}, q4{};
      uchar4 b4{};
      if constexpr (kTwo) {
        p4 = stage_f[w][2][q];
        q4 = stage_f[w][3][q];
      }
      if constexpr (kMode == 5) b4 = stage_b[w][q];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 4 * q + i;
        const float ak = lane_of(a4, i);
        const float dk = lane_of(d4, i);
        const bool ok = lane_of(v4, i);
        // off the carry chain: the vectors' second entries and each lane's
        // neighbour entry, before the insertion's value is known
        const float c2 = wc.second();
        const float cn = wc.next_lane();
        float e0, e1 = 0.0f, e2 = 0.0f;
        uint8_t fl = 0;
        if constexpr (kMode == 1) {
          const float f0 = wc.first;
          e0 = ok ? fmaxf(f0 - ak, 0.0f) : 0.0f;
          wc.insert_first(ok ? fmaxf(f0, ak) + dk : f0, c2, cn, lane);
        } else if constexpr (kMode == 2) {
          const float r2 = wr.second();
          const float rn = wr.next_lane();
          const float g = fmaxf(ak, wr.first);
          const float enq = g + lane_of(p4, i);
          const float start = dk > 0.0f ? fmaxf(enq, wc.first) : enq;
          const float rel = (start + dk) + lane_of(q4, i);
          wc.insert_first(ok && dk > 0.0f ? start + dk : wc.first, c2, cn, lane);
          wr.insert_first(ok ? rel : wr.first, r2, rn, lane);
          e0 = g - ak;
          e1 = start - enq;
          e2 = rel;
        } else {
          // mode 4 reads its enqueue times in a; mode 5 its arrivals in a,
          // its enqueue times, trailing IO and burst flags besides
          const float ek = kMode == 5 ? lane_of(p4, i) : ak;
          const bool bk = kMode == 5 ? lane_of(b4, i) : true;
          const float oldest = ring.oldest();
          float r2 = 0.0f, rn = 0.0f;
          if constexpr (kMode == 5) {
            r2 = wr.second();
            rn = wr.next_lane();
          }
          const bool refused = kMode == 5 && ok && wr.first > ak;
          const bool live = ok && !refused;
          const bool shed = live && bk && cap_on && oldest > ek;
          const float g = fmaxf(ek, wc.first);
          const float wait = bk ? g - ek : 0.0f;
          const bool through = live && bk && !shed;
          const bool ab = through && to_on && wait > a.timeout;
          if constexpr (kMode == 5) {
            const float pk = lane_of(q4, i);
            const float exit_t = bk ? (shed ? ek : (ab ? g : (g + dk) + pk)) : ak + pk;
            wr.insert_first(live ? exit_t : wr.first, r2, rn, lane);
          }
          wc.insert_first(through ? g + (ab ? 0.0f : dk) : wc.first, c2, cn, lane);
          ring.push(through, g, lane);
          e0 = wait;
          fl = (uint8_t)((shed ? 1 : 0) | (ab ? 2 : 0) | (refused ? 4 : 0));
        }
        // the element's outputs, kept by its owner lane
        if (p % kLanes == lane) {
          o0[own_slot(p)] = e0;
          if constexpr (kMode == 2) {
            o1[own_slot(p)] = e1;
            o2[own_slot(p)] = e2;
          }
          if constexpr (kFlags) of[own_slot(p)] = fl;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int64_t k = k0 + lane + i * kLanes;
      if (k >= 0 && k < m) {
        W0[k] = o0[i];
        if constexpr (kMode == 2) {
          W1[k] = o1[i];
          W2[k] = o2[i];
        }
        if constexpr (kFlags) F[k] = of[i];
      }
    }
    __syncwarp();  // the stage is rewritten next group
  }
}

// Launch the warp walk's instance for the RAM-slot form r and the core
// form c.
template <int kMode, int ER, int SR, int EC, int SC>
int launch_warp_walk(const StationArgs& a, Form r, Form c, void* stream) {
  // mode 2's RAM slots take their own form; mode 5's connections come in
  // at their one form
  if constexpr (kMode == 2 && SR == 1 && kLanes > 1) {
    if (r.span != 1) return launch_warp_walk<kMode, ER, kLanes, EC, SC>(a, r, c, stream);
  }
  if constexpr (kMode == 2 && ER < (SR == kLanes ? kMaxEntries : kWholeMax)) {
    if (r.entries > ER) return launch_warp_walk<kMode, 2 * ER, SR, EC, SC>(a, r, c, stream);
  }
  if constexpr (SC == 1 && kLanes > 1) {
    if (c.span != 1) return launch_warp_walk<kMode, ER, SR, EC, kLanes>(a, r, c, stream);
  }
  if constexpr (EC < (SC == kLanes ? kMaxEntries : kWholeMax)) {
    if (c.entries > EC) return launch_warp_walk<kMode, ER, SR, 2 * EC, SC>(a, r, c, stream);
  }
  const int threads = kWarps * kLanes;
  const int64_t blocks = (a.S + kWarps - 1) / kWarps;
  const auto kernel = station_scan_warp_kernel<kMode, ER, SR, EC, SC>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int station_scan_args_size() { return (int)sizeof(StationArgs); }

// Lanes a row of the warp walk runs on (1 in the host build) and the widest
// carry vector it holds.
int station_scan_lanes() { return kLanes; }
int station_scan_warp_width_max() { return kWarpWidthMax; }

// The walk a launch takes: 0 one thread a row (modes 0 and 3, mode 4 with
// one core), 1 one warp a row (modes 1, 2, 4 and 5 with both vectors up to
// kWarpWidthMax entries), 2 one thread a row with the carry in global
// scratch of ram_k + cores floats a row (wider; ram_k is the connection cap
// in mode 5).
int station_scan_walk(int mode, int cores, int ram_k) {
  if (mode == 0 || mode == 3 || (mode == 4 && cores == 1)) return kWalkThread;
  const int width = (mode == 2 || mode == 5) && ram_k > cores ? ram_k : cores;
  return width <= kWarpWidthMax ? kWalkWarp : kWalkGlobal;
}

// How the warp walk holds a vector of ``width`` floats: the entries a lane
// holds, and the lanes the vector spans (1: whole on every lane).
int station_scan_lane_entries(int width) { return form_of(width).entries; }
int station_scan_lane_span(int width) { return form_of(width).span; }

// Launch on ``stream``; returns the launch's cudaError_t (0 on success),
// or -1 for arguments the kernel does not take.
int station_scan_launch(const StationArgs* args, void* stream) {
  const StationArgs a = *args;
  if (a.S <= 0 || a.m <= 0 || a.a == nullptr || a.v == nullptr) return -1;
  if (a.mode == 3 ? a.flag == nullptr : (a.d == nullptr || a.out0 == nullptr)) return -1;
  if (a.mode < 0 || a.mode > 5 || a.cores < 1) return -1;
  if (a.mode == 2 && (a.ram_k < 1 || a.pre == nullptr || a.post == nullptr ||
                      a.out1 == nullptr || a.out2 == nullptr))
    return -1;
  if ((a.mode == 4 || a.mode == 5) && (a.flag == nullptr || a.cap > kRingMax)) return -1;
  if (a.mode == 5 && (a.conn < 1 || a.conn > kRingMax || a.e == nullptr ||
                      a.post == nullptr || a.b == nullptr))
    return -1;
  const int second = a.mode == 5 ? a.conn : a.ram_k;
  const int walk = station_scan_walk(a.mode, a.cores, second);
  if (walk == kWalkGlobal && a.scratch == nullptr) return -1;
  const int threads = kRows;
  const int64_t blocks = (a.S + threads - 1) / threads;
  if (walk == kWalkWarp) {
    const Form c = form_of(a.cores);
    if (a.mode == 1) return launch_warp_walk<1, 1, 1, 1, 1>(a, Form{1, 1}, c, stream);
    if (a.mode == 2) return launch_warp_walk<2, 1, 1, 1, 1>(a, form_of(a.ram_k), c, stream);
    if (a.mode == 4) return launch_warp_walk<4, 1, 1, 1, 1>(a, Form{1, 1}, c, stream);
    return launch_warp_walk<5, kRingPer, kLanes, 1, 1>(a, Form{kRingPer, kLanes}, c, stream);
  }
  if (a.mode == 4 || a.mode == 5) {
    // one core (mode 4) in a register, else the carry in global scratch
    const auto kernel = a.mode == 4 ? control_thread_kernel<4> : control_thread_kernel<5>;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  } else {
    station_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
