// FIFO station recursions of the scan fast path on Hopper (sm_90a).
//
// Replaces the XLA scans of the reference's fast path
// (asyncflow_tpu/engines/jaxsim/fastpath.py): the max-plus associative
// scan of _lindley_waits (:278), the Kiefer-Wolfowitz lax.scan of
// _kw_waits (:198) and the joint RAM-slot and core lax.scan of
// _ram_core_scan (:233).  Each row of the (S, m) inputs is one station's
// time-sorted stream of one scenario; one thread walks its row in order,
// carrying the station's state:
//
//   mode 0 (c = 1)  C_k = max(A_k + S_k, C_{k-1} + S_k),
//                   wait_k = max(0, (C_k - S_k) - A_k);
//   mode 1 (c > 1)  the ascending vector of the c core-free times: wait on
//                   the first, replace it by max(f_0, A_k) + S_k, re-sort;
//   mode 2          the ram_k admission-slot and c core-free vectors:
//                   grant g = max(A, r_0), start s = max(g + pre, w_0)
//                   (g + pre for an empty burst), release s + S + post;
//                   outputs (g - A, s - (g + pre), release).
//
// Invalid elements leave the carry unchanged, so a row may interleave
// other stations' lanes.  Built with --fmad=false: each float operation
// rounds as the plain PyTorch version's does.
//
// Bound: bytes.  An element is read once (arrival, service, validity;
// pre-IO and post-IO in mode 2) and its outputs written once, for a few
// float operations.  Each row is one thread's sequential walk, so a launch
// of S rows runs S threads: the 2048 rows of a full sweep cannot hide
// latency by occupancy, and the lanes of a warp read different rows, so a
// warp instruction touches one L1 line a lane (one L1 wavefront each).
// The walk therefore moves 16 bytes a lane an instruction: it takes the
// elements before the row's first 16-byte boundary one at a time, then
// kVec elements at a time as float4 / uchar4 vectors (their loads issued
// together, a quarter of the wavefronts of scalar ones), then the tail.
// A block holds kRows = 16 rows, half a warp, so the 2048 rows span 128
// SMs and each SM's L1 serves 16 lanes: the wavefronts, not the lanes,
// are the cost (full 32-row blocks put twice the lanes on half the SMs and
// run slower).  Each lane prefetches into L1 the lines of its row kAhead
// elements on.  scripts/torch_scan_variants.py times other block sizes
// and prefetch distances (-DSTATION_ROWS, -DSTATION_AHEAD).
//
// Carries: the core-free vector (up to kRegCores floats) and the RAM-slot
// vector (up to kRegSlots) live in registers, padded with +inf and kept
// sorted by selects alone (no dynamic index, so the array never leaves
// registers); a wider carry lives in global scratch the wrapper allocates
// (station_scan_scratch_floats says when), with the shifting insertion.

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
  float* scratch;        // (S, width) carries, or null for registers
  int64_t S;
  int64_t m;
  int32_t mode;
  int32_t cores;
  int32_t ram_k;
};

namespace {

#ifndef STATION_ROWS
#define STATION_ROWS 16
#endif
#ifndef STATION_AHEAD
#define STATION_AHEAD 256
#endif
constexpr int kRows = STATION_ROWS;    // rows (threads) a block
constexpr int kVec = 16;               // elements a vector step: 4 float4
constexpr int kAhead = STATION_AHEAD;  // elements prefetched ahead (0: none)
constexpr int kRegCores = 8;           // core-free vectors in registers up to this
constexpr int kRegSlots = 32;          // RAM-slot vectors in registers up to this
constexpr float kInf = 1e30f;

__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// An ascending vector of N floats in registers, +inf past its live
// entries.  insert_first(x) replaces f[0] by x (never below it) and sorts
// again: entry j takes f[j + 1] where that is below x, else x where f[j]
// is (or j is 0), else keeps f[j].  Ties leave x first, as the shifting
// insertion does.
template <int N>
struct RegVec {
  float f[N];

  __device__ __forceinline__ void init(int live) {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = j < live ? 0.0f : INFINITY;
  }
  __device__ __forceinline__ float first() const { return f[0]; }
  __device__ __forceinline__ void insert_first(float x) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float next = j + 1 < N ? f[j + 1] : INFINITY;
      const float here = (j == 0 || f[j] < x) ? x : f[j];
      f[j] = next < x ? next : here;
    }
  }
};

// The same vector of c floats in global scratch, with the shifting
// insertion.
struct MemVec {
  float* f;
  int c;

  __device__ __forceinline__ void init() {
    for (int j = 0; j < c; ++j) f[j] = 0.0f;
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
template <int kMode, class Cores, class Slots>
struct Station {
  Cores& wc;
  Slots& wr;
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

// One row's walk in mode kMode; wc and wr are its core and RAM-slot
// vectors (unused in mode 0).
template <int kMode, class Cores, class Slots>
__device__ __forceinline__ void walk(const StationArgs& a, int64_t row, Cores& wc, Slots& wr) {
  const int64_t base = row * a.m;
  const float* __restrict__ A = a.a + base;
  const float* __restrict__ D = a.d + base;
  const uint8_t* __restrict__ V = a.v + base;
  const float* __restrict__ P = kMode == 2 ? a.pre + base : nullptr;
  const float* __restrict__ Q = kMode == 2 ? a.post + base : nullptr;
  float* __restrict__ W0 = a.out0 + base;
  float* __restrict__ W1 = kMode == 2 ? a.out1 + base : nullptr;
  float* __restrict__ W2 = kMode == 2 ? a.out2 + base : nullptr;
  Station<kMode, Cores, Slots> st{wc, wr, -kInf};

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

__global__ void station_scan_kernel(StationArgs a) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.S) return;
  if (a.mode == 0) {
    RegVec<1> none;
    walk<0>(a, row, none, none);
    return;
  }
  if (a.scratch == nullptr) {
    RegVec<kRegCores> wc;
    wc.init(a.cores);
    if (a.mode == 1) {
      walk<1>(a, row, wc, wc);
      return;
    }
    RegVec<kRegSlots> wr;
    wr.init(a.ram_k);
    walk<2>(a, row, wc, wr);
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

}  // namespace

extern "C" {

int station_scan_args_size() { return (int)sizeof(StationArgs); }

// Floats of global scratch a row needs: 0 where the carry fits registers.
int station_scan_scratch_floats(int mode, int cores, int ram_k) {
  if (mode == 0) return 0;
  if (mode == 1) return cores <= kRegCores ? 0 : cores;
  return cores <= kRegCores && ram_k <= kRegSlots ? 0 : cores + ram_k;
}

// Launch on ``stream``; returns the launch's cudaError_t (0 on success),
// or -1 for arguments the kernel does not take.
int station_scan_launch(const StationArgs* args, void* stream) {
  const StationArgs a = *args;
  if (a.S <= 0 || a.m <= 0 || a.a == nullptr || a.d == nullptr || a.v == nullptr ||
      a.out0 == nullptr)
    return -1;
  if (a.mode < 0 || a.mode > 2 || a.cores < 1) return -1;
  if (a.mode == 2 && (a.ram_k < 1 || a.pre == nullptr || a.post == nullptr ||
                      a.out1 == nullptr || a.out2 == nullptr))
    return -1;
  if (a.scratch == nullptr && station_scan_scratch_floats(a.mode, a.cores, a.ram_k) > 0)
    return -1;
  const int threads = kRows;
  const int64_t blocks = (a.S + threads - 1) / threads;
  station_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
