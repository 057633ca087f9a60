// Round robin under an outage timeline on Hopper (sm_90a): each alive
// request's LB slot, or -1 where no target is healthy.
//
// Replaces the reference fast path's _routed_slots and _advance_timeline
// (asyncflow_tpu/engines/jaxsim/fastpath.py:1037-1065, :1008-1035): a
// lax.scan over every time-ordered arrival of a scenario (87,840 on the
// headline's width) that carries the rotation, with a lax.while_loop
// inside it that applies the down and up marks whose time has come.  Here
// the scan is not carried over step by step: between two marks the
// rotation only turns, one place a pick, so every pick is closed-form
// once each segment's start rank and starting rotation are known.
//
// Mark j applies before an arrival at t when tl_time[j] <= t, and marks
// apply in table order, so segment j + 1 (after mark j) starts at the
// running maximum over i <= j of the count of alive arrivals with
// t < tl_time[i]; segment 0 starts at rank 0.  An empty rotation takes no
// pick and does not turn; an up mark appends its slot at the tail unless
// present, a down mark removes it if present (rotation.py's discipline).
//
// Two kernels:
//   table: one block a scenario.  Its threads count, for every mark, the
//      alive lanes with t < tl_time (eight marks a pass over the row, in
//      registers, then one shared atomic add a mark a thread); then one
//      thread walks the marks in shared memory, turning the rotation by
//      each segment's size (mod its length) and applying the mark, and
//      writes table (S, NTL + 1, 2 + EL) int32: each segment's start rank,
//      its rotation's length and the rotation (-1 past the length);
//   lanes: one thread a lane on a (lane blocks, scenarios) grid: the lane's
//      segment is the last whose start is at most its int64 arrival rank
//      (a binary search of the row's table), and its slot is
//      rot[(rank - start) % length], or -1 where the length is 0 or the
//      lane is dead (dead lanes rank after every alive one).
//
// Bound: bytes.  The table pass reads t and alive (5 B a lane), the lanes
// pass the rank and alive and writes the slot (13 B a lane); the marks'
// compares and the search are a few operations a lane.  This is the
// simple form: the row is read once a group of eight marks.

#include <cuda_runtime.h>
#include <stdint.h>

struct LbRouteArgs {
  const float* t;           // table: (S, n) arrival times
  const uint8_t* alive;     // (S, n)
  const int64_t* rank;      // lanes: (S, n) arrival rank, dead lanes last
  const float* tl_time;     // (NTL,) mark times, in table order
  const int32_t* tl_down;   // (NTL,) 1 = down, 0 = up
  const int32_t* tl_slot;   // (NTL,) LB slot of the mark, or -1 (none)
  int32_t* table;           // (S, NTL + 1, 2 + EL)
  int32_t* slot;            // lanes: (S, n) out
  int64_t S;
  int64_t n;
  int32_t NTL;
  int32_t EL;
  int32_t mode;
};

// the table kernel's counts (NTL unsigned), mark times (NTL floats) and
// rotation with its scratch copy (2 EL ints)
extern __shared__ uint32_t route_smem[];

namespace {

constexpr int kTableMode = 0;
constexpr int kLanesMode = 1;
constexpr int kThreads = 256;
constexpr int kMarksAPass = 8;
constexpr int kMaxRows = 65535;   // scenarios a lanes launch (gridDim.y)
constexpr int kMaxMarks = 4096;   // marks (shared memory)
constexpr int kMaxSlots = 1024;   // LB slots (shared memory)

__global__ void table_kernel(LbRouteArgs a) {
  const int ntl = a.NTL, el = a.EL;
  const unsigned nt = blockDim.x, tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  uint32_t* counts = route_smem;
  float* times = reinterpret_cast<float*>(route_smem + ntl);
  int32_t* rot = reinterpret_cast<int32_t*>(route_smem + 2 * ntl);
  int32_t* tmp = rot + el;
#ifdef __CUDACC__
  for (int j = (int)tid; j < ntl; j += (int)nt) {
    counts[j] = 0u;
    times[j] = a.tl_time[j];
  }
  __syncthreads();
#else
  // the host build runs the threads one after another: the first sets up
  if (tid == 0) {
    for (int j = 0; j < ntl; ++j) {
      counts[j] = 0u;
      times[j] = a.tl_time[j];
    }
  }
#endif
  const float* t = a.t + row * a.n;
  const uint8_t* alive = a.alive + row * a.n;
  for (int j0 = 0; j0 < ntl; j0 += kMarksAPass) {
    uint32_t c[kMarksAPass];
#pragma unroll
    for (int q = 0; q < kMarksAPass; ++q) c[q] = 0u;
    for (int64_t i = tid; i < a.n; i += nt) {
      if (alive[i] == 0) continue;
      const float ti = t[i];
#pragma unroll
      for (int q = 0; q < kMarksAPass; ++q)
        c[q] += (j0 + q < ntl && ti < times[j0 + q]) ? 1u : 0u;
    }
#pragma unroll
    for (int q = 0; q < kMarksAPass; ++q)
      if (j0 + q < ntl && c[q] != 0u) atomicAdd(&counts[j0 + q], c[q]);
  }
#ifdef __CUDACC__
  __syncthreads();
  if (tid != 0) return;
#else
  if (tid != nt - 1) return;
#endif
  // the walk: segment j starts where mark j - 1 has applied
  const int w = 2 + el;
  int32_t* out = a.table + row * (int64_t)(ntl + 1) * w;
  int len = el;
  for (int i = 0; i < el; ++i) rot[i] = i;
  uint32_t start = 0u;
  for (int j = 0; j <= ntl; ++j) {
    int32_t* seg = out + (int64_t)j * w;
    seg[0] = (int32_t)start;
    seg[1] = len;
    for (int i = 0; i < el; ++i) seg[2 + i] = i < len ? rot[i] : -1;
    if (j == ntl) break;
    const uint32_t next = counts[j] > start ? counts[j] : start;
    // the segment's picks turn the rotation, one place each
    if (len > 0) {
      const int k = (int)((next - start) % (uint32_t)len);
      if (k != 0) {
        for (int i = 0; i < len; ++i) tmp[i] = rot[(i + k) % len];
        for (int i = 0; i < len; ++i) rot[i] = tmp[i];
      }
    }
    start = next;
    const int s = a.tl_slot[j];
    if (s < 0) continue;
    int at = -1;
    for (int i = 0; i < len; ++i)
      if (rot[i] == s) at = i;
    if (a.tl_down[j] == 1) {
      if (at >= 0) {
        for (int i = at; i + 1 < len; ++i) rot[i] = rot[i + 1];
        --len;
      }
    } else if (at < 0 && len < el) {
      rot[len] = s;
      ++len;
    }
  }
}

__global__ void lanes_kernel(LbRouteArgs a) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n) return;
  const int64_t i = (int64_t)blockIdx.y * a.n + lane;
  int32_t out = -1;
  if (a.alive[i] != 0) {
    const int64_t r = a.rank[i];
    const int w = 2 + a.EL;
    const int32_t* tab = a.table + (int64_t)blockIdx.y * (a.NTL + 1) * w;
    // the last segment whose start is at most r (segment 0 starts at 0)
    int lo = 0, hi = a.NTL;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if ((int64_t)tab[(int64_t)mid * w] <= r)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int32_t* seg = tab + (int64_t)lo * w;
    const int32_t len = seg[1];
    if (len > 0) out = seg[2 + (int)((r - (int64_t)seg[0]) % len)];
  }
  a.slot[i] = out;
}

}  // namespace

extern "C" {

int lb_route_args_size() { return (int)sizeof(LbRouteArgs); }

// Launch on ``stream``; returns the launch's cudaError_t if it is not 0, or
// -1 for arguments the kernel does not take.
int lb_route_launch(const LbRouteArgs* args, void* stream) {
  LbRouteArgs a = *args;
  if (a.S <= 0 || a.n <= 0 || a.n > 0x7FFFFFFFll || a.table == nullptr) return -1;
  if (a.NTL < 0 || a.NTL > kMaxMarks || a.EL < 1 || a.EL > kMaxSlots) return -1;
  if (a.mode == kTableMode) {
    if (a.t == nullptr || a.alive == nullptr ||
        (a.NTL > 0 && (a.tl_time == nullptr || a.tl_down == nullptr || a.tl_slot == nullptr)))
      return -1;
    const size_t smem = (size_t)2 * a.NTL * sizeof(uint32_t) + (size_t)2 * a.EL * sizeof(int32_t);
    const dim3 grid((unsigned)a.S);
    const dim3 block(kThreads);
    table_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.mode != kLanesMode || a.rank == nullptr || a.alive == nullptr || a.slot == nullptr)
    return -1;
  const LbRouteArgs whole = a;
  const int64_t lane_blocks = (a.n + kThreads - 1) / kThreads;
  for (int64_t r0 = 0; r0 < whole.S; r0 += kMaxRows) {
    const int64_t rows = whole.S - r0 < kMaxRows ? whole.S - r0 : kMaxRows;
    a = whole;
    a.S = rows;
    a.alive = whole.alive + r0 * whole.n;
    a.rank = whole.rank + r0 * whole.n;
    a.slot = whole.slot + r0 * whole.n;
    a.table = whole.table + r0 * (int64_t)(whole.NTL + 1) * (2 + whole.EL);
    const dim3 grid((unsigned)lane_blocks, (unsigned)rows);
    const dim3 block(kThreads);
    lanes_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
