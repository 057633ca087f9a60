// Round robin under an outage timeline, and least connections, on Hopper
// (sm_90a): each alive request's LB slot, or -1 where no target is healthy.
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
// Three kernels:
//   route_count: a (row blocks, scenarios) grid of 256 threads; a block counts,
//      over its stretch of the row, the alive lanes with t < tl_time of
//      every mark.  It reads t as float4 and alive as uchar4 (16 and 4 bytes
//      a lane, coalesced) after a scalar head up to the row's first 16-byte
//      boundary of t, four vectors a thread at once, and counts kMarksAPass
//      marks in registers a pass (one pass for the fast paths' timelines;
//      more re-read the block's stretch, from L1 or L2); each warp reduces a
//      mark's count with one __reduce_add_sync and adds it to the block's in
//      shared memory with one atomic; the block writes its counts to
//      partial (S, row blocks, NTL) uint32, every mark's, no atomic;
//   route_marks: one thread a scenario sums its row blocks' counts and walks the
//      marks, turning the rotation by each segment's size (mod its length)
//      and applying the mark, the rotation kept in the table it writes:
//      table (S, NTL + 1, 2 + EL) int32, each segment's start rank, its
//      rotation's length and the rotation (-1 past the length);
//   lanes: one thread a lane on a (lane blocks, scenarios) grid: the lane's
//      segment is the last whose start is at most its int64 arrival rank
//      (a binary search of the row's table), and its slot is
//      rot[(rank - start) % length], or -1 where the length is 0 or the
//      lane is dead (dead lanes rank after every alive one).
// A table launch runs route_count (none without marks) and route_marks; a
// lanes launch runs lanes.
//
// Least connections (mode 2) replaces _routed_slots_lc (:1067-1127), a
// lax.scan over the time-ordered arrivals carrying, per LB slot, a ring of
// R outstanding delivery times; an arrival's connection count on a slot is
// how many of its ring's entries lie after it, it picks the rotation's
// first position with the fewest (the first minimum of count * EL + pos),
// and unless its candidate send on that slot drops, its candidate delivery
// time replaces the smallest entry of that slot's ring.  A pick depends on
// every earlier delivery, so the scan is walked as it is: one warp a row
// (lc: a block of one warp a scenario), and only the chain carried from
// one arrival to the next is made short.  Every lane keeps the rotation
// (each slot's position in it) and makes the same pick, with no shuffle;
// slot k's ring entry j lies on lane j % 32, in a register for the
// payloads' shape (2 slots, rings of at most 32) or, for any other, in the
// lane's own column of shared memory; a slot's count is a ballot's
// popcount.  Arrivals come in time
// order, so a ring entry at or before an arrival never counts again: while
// the picked slot holds one, the smallest entry is such a dead one, and
// the delivery may replace any dead entry (only counts are read), found in
// the count's own ballot; only a ring of live entries takes the warp
// minimum of its entries (each lane's smallest, as an ordered integer).
// An arrival's chain is thus a ballot, a popcount, a few integer steps and
// a select, with no shared-memory round trip.  A group of 32 arrivals'
// times and flags is read into registers and its candidate deliveries and
// drops into shared memory, coalesced, one group ahead in the registers
// form (their loads leave the carry's chain).  Bound: bytes (t, ok and EL
// candidates of 5 B an arrival read once, the pick written once) or the EL
// x R compares an arrival.
//
// Bound: bytes.  The table pass reads t and alive (5 B a lane), the lanes
// pass the rank and alive and writes the slot (13 B a lane); the marks'
// compares and the search are a few operations a lane.  The count spreads
// a row over kUnitsABlock four-lane units a block, so the 2048 x 28,323
// lanes of event_inj_lb's chunk run as 8,192 blocks that stream the row at
// the card's bandwidth.  The host build (tests/test_torch_fast_host.py)
// runs a block's threads one after another, one lane a warp (kLanes = 1).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct LbRouteArgs {
  const float* t;           // table: (S, n) arrival times
  const uint8_t* alive;     // (S, n)
  const int64_t* rank;      // lanes: (S, n) arrival rank, dead lanes last
  const float* tl_time;     // (NTL,) mark times, in table order
  const int32_t* tl_down;   // (NTL,) 1 = down, 0 = up
  const int32_t* tl_slot;   // (NTL,) LB slot of the mark, or -1 (none)
  uint32_t* partial;        // table: (S, row blocks, NTL) counts of the row's blocks
  int32_t* table;           // (S, NTL + 1, 2 + EL)
  int32_t* slot;            // lanes, lc: (S, n) out
  const float* deliv;       // lc: (S, n, EL) candidate delivery times, time order
  const uint8_t* drop;      // lc: (S, n, EL) candidate drops
  int64_t S;
  int64_t n;
  int32_t NTL;
  int32_t EL;
  int32_t mode;
  int32_t R;                // lc: ring entries a slot
};

// the count kernel's counts of the block (NTL unsigned)
extern __shared__ uint32_t route_smem[];

namespace {

constexpr int kTableMode = 0;
constexpr int kLanesMode = 1;
constexpr int kLcMode = 2;
constexpr int kLcSlots = 32;      // LB slots least connections takes
constexpr int kLcRing = 128;      // ring entries a slot it takes
constexpr int kLcRegSlots = 2;    // LB slots of least connections' registers form
constexpr int kAbsent = 1 << 30;  // least connections' key of a slot outside the rotation
constexpr int kThreads = 256;
constexpr int kMarksAPass = 16;   // marks counted in registers a pass
constexpr int kUnroll = 4;        // four-lane units a thread loads at once
constexpr int kUnitsABlock = kThreads * kUnroll * 2;  // units of a row a count block
constexpr int kMaxRows = 65535;   // scenarios a launch on a (.., scenarios) grid (gridDim.y)
constexpr int kMaxMarks = 4096;   // marks (shared memory)
constexpr int kMaxSlots = 1024;   // LB slots
constexpr unsigned kAll = 0xffffffffu;
constexpr float kInf = 1e30f;

// lanes a warp reduces over: a warp on the card, one in the host build
#ifdef __CUDACC__
constexpr int kLanes = 32;
#else
constexpr int kLanes = 1;
#endif
constexpr unsigned kLaneMask = kLanes == 32 ? 0xFFFFFFFFu : (1u << kLanes) - 1u;

// a row's four-lane units from its first 16-byte boundary of t (head
// lanes before it; the tail after the last unit); alive is 4-byte aligned
// there too, as the launch checks
struct RowUnits {
  int64_t head;
  int64_t units;
};

__device__ __forceinline__ RowUnits row_units(const float* t, int64_t n) {
  const int64_t lead = (4 - (int64_t)((reinterpret_cast<uintptr_t>(t) >> 2) & 3)) & 3;
  const int64_t head = lead < n ? lead : n;
  return {head, (n - head) / 4};
}

// count blocks a row takes: enough for the most units any row has
__host__ __device__ __forceinline__ int64_t row_blocks(int64_t n) {
  const int64_t units = n / 4 + 1;
  return (units + kUnitsABlock - 1) / kUnitsABlock;
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ bool lane_of(const uchar4& v, int i) {
  return (i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w) != 0;
}

// One block's counts of the alive lanes of its stretch of the row with
// t < tl_time, kM marks a pass (kM a power of two up to kMarksAPass).
template <int kM>
__global__ void __launch_bounds__(kThreads) route_count_kernel(LbRouteArgs a) {
  const int ntl = a.NTL;
  const int tid = (int)threadIdx.x;
  const int nt = (int)blockDim.x;
  const int64_t row = blockIdx.y;
  const int64_t b = blockIdx.x;
  uint32_t* counts = route_smem;
#ifdef __CUDACC__
  for (int j = tid; j < ntl; j += nt) counts[j] = 0u;
  __syncthreads();
#else
  // the host build runs the threads one after another: the first sets up
  if (tid == 0)
    for (int j = 0; j < ntl; ++j) counts[j] = 0u;
#endif
  const float* t = a.t + row * a.n;
  const uint8_t* alive = a.alive + row * a.n;
  const RowUnits ru = row_units(t, a.n);
  const int64_t u0 = b * kUnitsABlock;
  const int64_t u1 = u0 + kUnitsABlock < ru.units ? u0 + kUnitsABlock : ru.units;
  // the scalar lanes: the head and the tail, on the first block
  const int64_t tail0 = ru.head + 4 * ru.units;
  int64_t lone = -1;
  if (b == 0) {
    if (tid < ru.head) lone = tid;
    else if (tid >= 4 && tail0 + (tid - 4) < a.n) lone = tail0 + (tid - 4);
  }
  for (int j0 = 0; j0 < ntl; j0 += kM) {
    float tm[kM];
    uint32_t c[kM];
#pragma unroll
    for (int q = 0; q < kM; ++q) {
      // a mark past the table counts nothing
      tm[q] = j0 + q < ntl ? a.tl_time[j0 + q] : -INFINITY;
      c[q] = 0u;
    }
    for (int64_t u = u0 + tid; u < u1; u += (int64_t)kUnroll * nt) {
      float4 tv[kUnroll];
      uchar4 av[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int64_t ur = u + (int64_t)r * nt;
        if (ur < u1) {
          const int64_t i = ru.head + 4 * ur;
          tv[r] = *reinterpret_cast<const float4*>(t + i);
          av[r] = *reinterpret_cast<const uchar4*>(alive + i);
        } else {
          tv[r] = float4{};
          av[r] = uchar4{};
        }
      }
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool al = lane_of(av[r], i);
          const float ti = lane_of(tv[r], i);
#pragma unroll
          for (int q = 0; q < kM; ++q) c[q] += (al && ti < tm[q]) ? 1u : 0u;
        }
      }
    }
    if (lone >= 0 && alive[lone] != 0) {
      const float ti = t[lone];
#pragma unroll
      for (int q = 0; q < kM; ++q) c[q] += ti < tm[q] ? 1u : 0u;
    }
    const bool lead = tid % kLanes == 0;
#pragma unroll
    for (int q = 0; q < kM; ++q) {
      const uint32_t sum = __reduce_add_sync(kAll, c[q]);
      if (lead && j0 + q < ntl && sum != 0u) atomicAdd(&counts[j0 + q], sum);
    }
  }
#ifdef __CUDACC__
  __syncthreads();
  const int first = tid, step = nt;
#else
  if (tid != nt - 1) return;
  const int first = 0, step = 1;
#endif
  uint32_t* out = a.partial + (row * gridDim.x + b) * ntl;
  for (int j = first; j < ntl; j += step) out[j] = counts[j];
}

// One thread a scenario: the marks' walk over its row blocks' counts.
// Segment j + 1 starts at the running maximum of the counts (the row's
// alive lanes before mark i, i <= j); its rotation is segment j's turned
// by the segment's picks, then mark j applied.
__global__ void route_marks_kernel(LbRouteArgs a) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.S) return;
  const int ntl = a.NTL, el = a.EL;
  const int w = 2 + el;
  const int64_t nb = row_blocks(a.n);
  const uint32_t* part = a.partial + row * nb * ntl;
  int32_t* out = a.table + row * (int64_t)(ntl + 1) * w;
  out[0] = 0;
  out[1] = el;
  for (int i = 0; i < el; ++i) out[2 + i] = i;
  uint32_t start = 0u;
  int len = el;
  for (int j = 0; j < ntl; ++j) {
    const int32_t* cur = out + (int64_t)j * w;
    int32_t* nx = out + (int64_t)(j + 1) * w;
    uint32_t count = 0u;
    for (int64_t bb = 0; bb < nb; ++bb) count += part[bb * ntl + j];
    const uint32_t next = count > start ? count : start;
    // the segment's picks turn the rotation, one place each
    const int k = len > 0 ? (int)((next - start) % (uint32_t)len) : 0;
    for (int i = 0; i < len; ++i) nx[2 + i] = cur[2 + (i + k) % len];
    start = next;
    const int s = a.tl_slot[j];
    if (s >= 0) {
      int at = -1;
      for (int i = 0; i < len; ++i)
        if (nx[2 + i] == s) at = i;
      if (a.tl_down[j] == 1) {
        if (at >= 0) {
          for (int i = at; i + 1 < len; ++i) nx[2 + i] = nx[3 + i];
          --len;
        }
      } else if (at < 0 && len < el) {
        nx[2 + len] = s;
        ++len;
      }
    }
    nx[0] = (int32_t)start;
    nx[1] = len;
    for (int i = len; i < el; ++i) nx[2 + i] = -1;
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

// float x as an unsigned integer in the same order (no NaN)
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) != 0u ? ~u : (u | 0x80000000u);
}

// The lanes whose ring entry q lies within the ring of r entries (entry
// q kLanes + lane), as a ballot's mask.
__device__ __forceinline__ unsigned lc_valid(int r, int q) {
  const int n = r - q * kLanes;
  return n >= kLanes ? kLaneMask : n <= 0 ? 0u : (1u << n) - 1u;
}

// The next group's arrivals, loaded while the current group walks: a
// lane's arrival time, flag and drops (bit k: the send on slot k drops),
// and kA of the group's candidate deliveries (entry lane + q kLanes of the
// group's kLanes x EL block).
template <int kA>
struct LcGroup {
  float t;
  bool ok;
  unsigned drops;
  float c[kA];
};

template <int kA>
__device__ __forceinline__ void lc_fetch(LcGroup<kA>& g, const float* t, const uint8_t* ok,
                                         const float* deliv, const uint8_t* drop, int64_t n,
                                         int el, int64_t k0, int lane) {
  const int cnt = n - k0 < kLanes ? (int)(n - k0) : kLanes;
  g.t = lane < cnt ? t[k0 + lane] : kInf;
  g.ok = lane < cnt && ok[k0 + lane] != 0;
  g.drops = 0u;
  if (lane < cnt)
    for (int k = 0; k < el; ++k) g.drops |= drop[(k0 + lane) * el + k] != 0 ? 1u << k : 0u;
#pragma unroll
  for (int q = 0; q < kA; ++q) {
    const int i = lane + q * kLanes;
    if (q < el && i < cnt * el) g.c[q] = deliv[k0 * el + i];
  }
}

// Least connections: a block of one warp a scenario.  Every lane holds the
// whole carried state but the rings: each slot's key base (its position in
// the rotation times 32 plus the slot, or kAbsent) and the rotation's
// length, updated alike on every lane, so every lane makes the same pick,
// the least of count * EL * 32 + base (the first minimum of count * EL +
// pos, the slot in its low 5 bits), with no shuffle.  Slot k's ring entry j
// lies on lane j % kLanes, at q = j / kLanes.  Two forms:
//   kRegs: exactly kSlots slots and rings of at most kLanes entries, the
//      ring a register a slot (ring[k]); a slot's count is the popcount of
//      one ballot; a group is loaded one group ahead, and an arrival's
//      candidates of every slot are read before its pick;
//   else: at most kSlots slots and any ring, in the lane's own column of
//      shared memory (col[(k per + q) kLanes]), which no other lane reads;
//      a count is one ballot a q.
// The delivery replaces the slot's smallest entry: while the slot holds a
// dead entry (at or before the arrival), the smallest is dead, and every
// dead entry stays dead for every later arrival (arrivals come in time
// order), so any one may take it, as only the counts are read: the first
// lane's at the first q holding one, from the count's own ballots.  A slot
// of live entries only takes the least (ordered(entry), lane) by one warp
// minimum and a ballot.  A group of kLanes arrivals is read coalesced:
// times and flags into registers (an arrival's by shuffle), the candidates
// into shared memory (kLanes x EL floats) and each arrival's drops as a
// word of bits.
template <int kSlots, bool kRegs>
__global__ void __launch_bounds__(kLanes, 1) lc_kernel(LbRouteArgs a) {
  constexpr int kA = kRegs ? kSlots : 1;
  const int el = kRegs ? kSlots : a.EL;
  const int r = a.R, ntl = a.NTL;
  const int per = (r + kLanes - 1) / kLanes;
  const int lane = (int)threadIdx.x;
  const unsigned lane_bit = 1u << lane;
  const int el32 = el * 32;
  const int64_t row = blockIdx.x;
  const int64_t n = a.n;
  const float* t = a.t + row * n;
  const uint8_t* ok = a.alive + row * n;
  const float* deliv = a.deliv + row * n * el;
  const uint8_t* drop = a.drop + row * n * el;
  int32_t* out = a.slot + row * n;
  float* cand = reinterpret_cast<float*>(route_smem);
  unsigned* cdrop = reinterpret_cast<unsigned*>(cand + kLanes * el);
  float* col = reinterpret_cast<float*>(cdrop + kLanes) + lane;
  float ring[kRegs ? kSlots : 1];
  const unsigned valid = lc_valid(r, 0);  // the lanes whose entry lies in the ring
  int base[kSlots];  // position in the rotation * 32 + slot, or kAbsent
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    base[k] = k < el ? k * 32 + k : kAbsent;
    if constexpr (kRegs) {
      ring[k] = -kInf;
    } else if (k < el) {
      for (int q = 0; q < per; ++q) col[(k * per + q) * kLanes] = -kInf;
    }
  }
  int len = el;
  int ptr = 0;  // the next mark
  float next_t = ntl > 0 ? a.tl_time[0] : 0.0f;
  LcGroup<kA> g;
  if constexpr (kRegs) lc_fetch(g, t, ok, deliv, drop, n, el, 0, lane);
  for (int64_t k0 = 0; k0 < n; k0 += kLanes) {
    const int cnt = n - k0 < kLanes ? (int)(n - k0) : kLanes;
    __syncwarp();  // every lane is done with the last group's candidates
    float my_t;
    bool my_ok;
    if constexpr (kRegs) {
      my_t = g.t;
      my_ok = g.ok;
      cdrop[lane] = g.drops;
#pragma unroll
      for (int q = 0; q < kA; ++q) {
        const int i = lane + q * kLanes;
        if (i < cnt * el) cand[i] = g.c[q];
      }
      if (k0 + kLanes < n) lc_fetch(g, t, ok, deliv, drop, n, el, k0 + kLanes, lane);
    } else {
      my_t = lane < cnt ? t[k0 + lane] : kInf;
      my_ok = lane < cnt && ok[k0 + lane] != 0;
      unsigned bits = 0u;
      if (lane < cnt)
        for (int k = 0; k < el; ++k) bits |= drop[(k0 + lane) * el + k] != 0 ? 1u << k : 0u;
      cdrop[lane] = bits;
      for (int i = lane; i < cnt * el; i += kLanes) cand[i] = deliv[k0 * el + i];
    }
    __syncwarp();
    const unsigned okbits = __ballot_sync(kAll, my_ok);
    int my_pick = -1;  // the pick of arrival k0 + lane
    // every group walks kLanes arrivals: past the row's end a lane's
    // arrival is dead at kInf, which picks nothing and leaves the rings
    // as they are (the marks it applies come after the row's last arrival)
    float ta = __shfl_sync(kAll, my_t, 0);
#pragma unroll 8
    for (int p = 0; p < kLanes; ++p) {
      // the next arrival's time, fetched a step ahead (off the chain)
      const float ta_next = __shfl_sync(kAll, my_t, (p + 1) & (kLanes - 1));
      // the marks whose time has come, in table order
      while (ptr < ntl && next_t <= ta) {
        const int s = a.tl_slot[ptr];
        if (s >= 0 && s < el) {
          int at = kAbsent;  // the slot's base
#pragma unroll
          for (int k = 0; k < kSlots; ++k)
            if (k == s) at = base[k];
          if (a.tl_down[ptr] == 1) {
            if (at < kAbsent) {
              // the slots after it move up one place
#pragma unroll
              for (int k = 0; k < kSlots; ++k)
                base[k] = k == s ? kAbsent : base[k] < kAbsent && base[k] > at ? base[k] - 32
                                                                                : base[k];
              --len;
            }
          } else if (at == kAbsent) {
#pragma unroll
            for (int k = 0; k < kSlots; ++k)
              if (k == s) base[k] = len * 32 + k;
            ++len;
          }
        }
        ++ptr;
        next_t = ptr < ntl ? a.tl_time[ptr] : 0.0f;
      }
      // the candidates of every slot, read before the pick in the
      // registers form (off the chain)
      const unsigned drops = cdrop[p];
      float dk[kRegs ? kSlots : 1];
      if constexpr (kRegs) {
#pragma unroll
        for (int k = 0; k < kSlots; ++k) dk[k] = cand[p * el + k];
      }
      // each slot's count, a ballot of its live entries (after ta) a q,
      // and the least key
      unsigned live[kRegs ? kSlots : 1];
      int best = kAbsent;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (k < el) {
          int c = 0;
          if constexpr (kRegs) {
            live[k] = __ballot_sync(kAll, ring[k] > ta);
            c = __popc(live[k]);
          } else {
            for (int q = 0; q < per; ++q)
              c += __popc(__ballot_sync(kAll, col[(k * per + q) * kLanes] > ta));
          }
          const int key = c * el32 + base[k];
          best = key < best ? key : best;
        }
      }
      // a dead arrival, or an empty rotation, picks -1; the rest runs
      // without a branch (slot is a slot of the rotation where it picks)
      const bool take = ((okbits >> p) & 1u) != 0u && best < kAbsent;
      const int slot = best & 31;
      const int picked = take ? slot : -1;
      {
        float d;
        if constexpr (kRegs) {
          d = dk[0];
#pragma unroll
          for (int k = 1; k < kSlots; ++k) d = k == slot ? dk[k] : d;
        } else {
          d = cand[p * el + (take ? slot : 0)];
        }
        // the lanes holding a dead entry at the first q holding one
        int at = -1;
        unsigned holders = 0u;
        if constexpr (kRegs) {
          unsigned lv = live[0];
#pragma unroll
          for (int k = 1; k < kSlots; ++k) lv = k == slot ? live[k] : lv;
          holders = ~lv & valid;
          at = holders != 0u ? 0 : -1;
        } else if (take) {
          for (int q = 0; q < per && at < 0; ++q) {
            holders = ~__ballot_sync(kAll, col[(slot * per + q) * kLanes] > ta) &
                      lc_valid(r, q);
            at = holders != 0u ? q : at;
          }
        }
        if (take && at < 0) {
          // every entry is live: this lane's smallest, then the warp's
          unsigned mine = 0xFFFFFFFFu;
#pragma unroll
          for (int k = 0; k < kSlots; ++k) {
            if (k == slot) {
              if constexpr (kRegs) {
                const unsigned u = ordered(ring[k]);
                if (lane < r && u < mine) {
                  mine = u;
                  at = 0;
                }
              } else {
                for (int q = 0; q < per; ++q) {
                  const unsigned u = ordered(col[(k * per + q) * kLanes]);
                  if (q * kLanes + lane < r && u < mine) {
                    mine = u;
                    at = q;
                  }
                }
              }
            }
          }
          const unsigned least = __reduce_min_sync(kAll, mine);
          holders = __ballot_sync(kAll, at >= 0 && mine == least);
        }
        // the first holder lane writes the delivery, unless it dropped
        const bool put = take && ((drops >> slot) & 1u) == 0u &&
                         (holders & (0u - holders)) == lane_bit;
        if constexpr (kRegs) {
#pragma unroll
          for (int k = 0; k < kSlots; ++k) ring[k] = put && k == slot ? d : ring[k];
        } else if (put) {
          col[(slot * per + at) * kLanes] = d;
        }
      }
      my_pick = lane == p ? picked : my_pick;
      ta = ta_next;
    }
    if (lane < cnt) out[k0 + lane] = my_pick;
  }
}

using LcKernel = void (*)(LbRouteArgs);

// Whether least connections over EL slots with rings of R entries takes
// the registers form: the payloads' shape, kLcRegSlots slots and a ring a
// lane at most; every other shape takes the shared-memory form of
// kLcSlots.
__host__ __device__ __forceinline__ bool lc_in_registers(int el, int r) {
  return el == kLcRegSlots && r <= kLanes;
}

// shared memory of the instance: the group's candidates and drops, and the
// rings where they are not in registers
size_t lc_smem(int el, int r) {
  const int per = (r + kLanes - 1) / kLanes;
  const size_t group = (size_t)kLanes * el * sizeof(float) + (size_t)kLanes * sizeof(unsigned);
  return group + (lc_in_registers(el, r) ? 0 : (size_t)el * per * kLanes * sizeof(float));
}

// the count kernel's instance for kM marks a pass
template <int kM>
int launch_count(const LbRouteArgs& a, void* stream) {
  const dim3 grid((unsigned)row_blocks(a.n), (unsigned)a.S);
  const dim3 block(kThreads);
  const size_t smem = (size_t)a.NTL * sizeof(uint32_t);
  route_count_kernel<kM><<<grid, block, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lb_route_args_size() { return (int)sizeof(LbRouteArgs); }

// Count blocks a row of n lanes takes: the partial counts a table launch
// needs are (S, lb_route_row_blocks(n), NTL) uint32.
int64_t lb_route_row_blocks(int64_t n) { return row_blocks(n); }

// Launch on ``stream``; returns the launch's cudaError_t if it is not 0, or
// -1 for arguments the kernel does not take.
int lb_route_launch(const LbRouteArgs* args, void* stream) {
  LbRouteArgs a = *args;
  if (a.S <= 0 || a.n <= 0 || a.n > 0x7FFFFFFFll) return -1;
  if (a.table == nullptr && a.mode != kLcMode) return -1;
  if (a.NTL < 0 || a.NTL > kMaxMarks || a.EL < 1 || a.EL > kMaxSlots) return -1;
  const LbRouteArgs whole = a;
  if (a.mode == kTableMode) {
    if (a.t == nullptr || a.alive == nullptr ||
        (a.NTL > 0 && (a.tl_time == nullptr || a.tl_down == nullptr || a.tl_slot == nullptr ||
                       a.partial == nullptr)))
      return -1;
    // t's 16-byte boundaries are alive's 4-byte ones
    const uintptr_t t_at = reinterpret_cast<uintptr_t>(a.t);
    if ((t_at & 3) != 0 || ((t_at >> 2) & 3) != (reinterpret_cast<uintptr_t>(a.alive) & 3))
      return -1;
    const int64_t nb = row_blocks(a.n);
    for (int64_t r0 = 0; a.NTL > 0 && r0 < whole.S; r0 += kMaxRows) {
      a = whole;
      a.S = whole.S - r0 < kMaxRows ? whole.S - r0 : kMaxRows;
      a.t = whole.t + r0 * whole.n;
      a.alive = whole.alive + r0 * whole.n;
      a.partial = whole.partial + r0 * nb * whole.NTL;
      const int marks = a.NTL < kMarksAPass ? a.NTL : kMarksAPass;
      const int rc = marks <= 1   ? launch_count<1>(a, stream)
                     : marks <= 2 ? launch_count<2>(a, stream)
                     : marks <= 4 ? launch_count<4>(a, stream)
                     : marks <= 8 ? launch_count<8>(a, stream)
                                  : launch_count<kMarksAPass>(a, stream);
      if (rc != 0) return rc;
    }
    a = whole;
    const dim3 grid((unsigned)((a.S + 127) / 128));
    const dim3 block(128);
    route_marks_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.mode == kLcMode) {
    if (a.t == nullptr || a.alive == nullptr || a.deliv == nullptr || a.drop == nullptr ||
        a.slot == nullptr || a.EL > kLcSlots || a.R < 1 || a.R > kLcRing ||
        (a.NTL > 0 && (a.tl_time == nullptr || a.tl_down == nullptr || a.tl_slot == nullptr)))
      return -1;
    const LcKernel lc = lc_in_registers(a.EL, a.R) ? lc_kernel<kLcRegSlots, true>
                                                   : lc_kernel<kLcSlots, false>;
    const size_t smem = lc_smem(a.EL, a.R);
    const dim3 grid((unsigned)a.S);
    const dim3 block(kLanes);
    lc<<<grid, block, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.mode != kLanesMode || a.rank == nullptr || a.alive == nullptr || a.slot == nullptr)
    return -1;
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
