// The fast path's gauge grid on Hopper (sm_90a): a group of gauge sites'
// intervals scattered onto the sample ticks, +amount at the bucket of each
// interval's start and -amount at the bucket of its end, into the sites'
// columns of the (S, rows, G) float32 grid; a cumulative sum over the rows
// then gives each tick's gauge value.
//
// Replaces the reference fast path's _gauge_intervals
// (asyncflow_tpu/engines/jaxsim/fastpath.py:1138-1144): XLA's scatter-add of
// both endpoints of every lane at every gauge site (no Pallas kernel stands
// behind it).  A lane's bucket is ceil(t * scale) clipped to [0, rows - 1],
// scale the float32 reciprocal of the grid's period (XLA folds the division
// by the constant period into that multiply), so "never" (1e30) lands in the
// last row.
//
// A launch takes a group of sites that share their operands, and forms each
// lane's intervals itself, with the float32 operations, in the order, of the
// torch expressions of the engine's sites (gauge_grid.py's plain versions):
//   site   one site: [t0, t1) where on, +amount (a scalar or a lane's);
//   queue  a server's ready queue and pre-IO sleep at one visit, from the
//          enqueue time e, the wait w, the pre-IO p and the visit's
//          validity vb: ready [e, e + w) where vb & w > 0, pre-IO
//          [e - p, e) where vb & p > 0;
//   trail  a server's trailing IO sleep and RAM, from the trailing IO's
//          start, the departure dep, the arrival t, the RAM wait w_ram
//          (none: 0), the server's lanes mine and each lane's RAM: IO
//          [start, dep) where mine & dep > start, RAM [t + w_ram, dep)
//          where mine & ram > 0, +ram;
//   slots  the LB's edges: [t0, t1) where ok, into the column of the
//          lane's slot, rank % K (the arrival rank, int64) or the slot
//          itself (int32 or int64; outside [0, K): no interval).
// Each interval gives two adds, its start's and its end's, each keyed by
// (the group's column index, bucket).
//
// Lanes of a row come in arrival order, so neighbouring lanes mostly share
// a bucket and a plain scatter serialises on one address.  A thread takes
// four consecutive lanes (float4, uchar4-word and 16-byte index loads where
// the launch's rows are 16-byte aligned) and first merges them in
// registers: runs of equal keys, each run's sum offered once, in the round
// of the lane after it; the LB's slots alternate lane by lane, so there
// each key's sum is offered in the round of its first lane.  In each round
// the warp takes the key of its first offering lane, sums that key's offers
// with a butterfly of shuffles and adds the sum once, then the next key, up
// to kGroups keys (a series' warp holds one to three buckets); past them (a
// fine grid's many) each lane adds its own offer.  The amounts the fast
// path adds are queue lengths and connection counts (+-1) and RAM in whole
// MB, whose float32 sums are exact in any order, so the grid equals the
// plain scatter bit for bit; a fractional amount agrees within float32
// rounding.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (the headline's
// series run, the nine launches a chunk): grouping the offers with
// __match_any_sync and summing each group serially through shared memory
// took 17 ms a chunk, the shuffle loop 13, and the runs, the slots' merge
// in any order and the rows cut into slices (below) 12.
//
// Two forms, chosen per launch by the grid's rows and the group's columns:
//   shared (rows <= kSharedRows and rows x columns <= kSharedCells: the
//     stride grids of streamed series): a (slices, scenarios) grid, a row's
//     lanes cut into slices of whole tiles so that the card runs many
//     waves of blocks and the last, part-empty wave costs little; a
//     block zeroes its columns in shared memory, walks its slice a tile of
//     kThreads x 4 lanes at a time, adds into shared memory, and adds each
//     column to the grid once, each nonzero row by one thread (atomically
//     where a row has several slices);
//   global (the fine grids): a (lane tiles, scenarios) grid whose warps add
//     straight into the grid's columns with global atomics.
// Bound: bytes.  Each operand is read once (site 9 B a lane, 13 with a
// lane's amount; queue 13; trail 17, 21 with the RAM wait; slots 17 with an
// int64 rank); the columns are read and written once a row.
// The host build (tests/test_torch_fast_host.py) runs one thread a block
// and one lane a warp, so the shared form's phases run in order there.

#include <cuda_runtime.h>

#include <cstdint>

// The launch's arguments, mirrored by gauge_grid._GaugeGridArgs (outside the
// unnamed namespace: the exported launch takes it).
struct GaugeGridArgs {
  // the group's float operands, (S, n) each, in the form's order: site t0,
  // t1, amount (null: amount_scalar); queue e, w, p; trail start, dep, t,
  // w_ram (null: none), ram; slots t0, t1
  const float* f[5];
  const uint8_t* on;  // (S, n) bool: site on, queue vb, trail mine, slots ok
  const void* idx;    // slots: (S, n) rank or slot, idx_bytes each
  float* grid;        // (S, rows, G)
  int64_t S, n;
  int32_t rows, G, form, ncols;
  int32_t cols[32];   // the grid's column of each of the group's columns
  int32_t idx_bytes;  // 4 (int32) or 8 (int64)
  int32_t idx_mod;    // slots: the lane's slot is idx % ncols (the rank)
  float scale;        // float32 reciprocal of the grid's period
  float amount_scalar;
};

extern __shared__ float gauge_smem[];

namespace {

constexpr int kSite = 0, kQueue = 1, kTrail = 2, kSlots = 3;

#ifdef __CUDACC__
constexpr int kThreads = 256;  // threads a block
constexpr int kWarp = 32;
#else
constexpr int kThreads = 1;
constexpr int kWarp = 1;
#endif
// consecutive lanes a thread (a multiple of 4); 8 and 12 ran slower on the
// headline's series run (the merge's rounds and registers grow with it)
constexpr int kLanes = 4;
constexpr int kTile = kThreads * kLanes;   // lanes a block's trip
// keys a warp merges in a round; the rest add one by one
constexpr int kGroups = 3;
// rows a group's columns may hold in shared memory, and the cells in all
// (48 KiB: the default limit of a block's dynamic shared memory)
constexpr int kSharedRows = 2048;
constexpr int kSharedCells = 12288;
constexpr int64_t kMaxRows = 65535;  // scenarios a launch (gridDim.y)
// the shared form's blocks in all, and the fewest tiles a block's slice
constexpr int64_t kTargetBlocks = 8192;
constexpr int64_t kMinTiles = 8;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int bucket(float t, float scale, int last) {
  float b = ceilf(t * scale);
  b = fminf(fmaxf(b, 0.0f), (float)last);
  return (int)b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

__device__ __forceinline__ int lane_id() { return kWarp == 1 ? 0 : (int)(threadIdx.x % kWarp); }

// A thread's consecutive lanes of an operand row from lane i0: vectors of
// four where aligned, else one lane at a time (past n: zero).
__device__ __forceinline__ void load_lanes(const float* p, int64_t i0, int64_t n, bool vec,
                                           float (&x)[kLanes]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < kLanes; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i0 + c);
      x[c] = v.x;
      x[c + 1] = v.y;
      x[c + 2] = v.z;
      x[c + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) x[j] = i0 + j < n ? p[i0 + j] : 0.0f;
}

__device__ __forceinline__ void load_lanes(const uint8_t* p, int64_t i0, int64_t n, bool vec,
                                           bool (&x)[kLanes]) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < kLanes; c += 4) {
      const uchar4 v = *reinterpret_cast<const uchar4*>(p + i0 + c);
      x[c] = v.x != 0;
      x[c + 1] = v.y != 0;
      x[c + 2] = v.z != 0;
      x[c + 3] = v.w != 0;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) x[j] = i0 + j < n && p[i0 + j] != 0;
}

// the lanes' slots (-1: none) from their ranks or slots, the row starting
// at lane rb of the operand
__device__ __forceinline__ void load_slots(const GaugeGridArgs& a, int64_t rb, int64_t i0,
                                           bool vec, int (&slot)[kLanes]) {
  int64_t v[kLanes];
  if (a.idx_bytes == 8) {
    const int64_t* p = static_cast<const int64_t*>(a.idx) + rb;
    if (vec) {
#pragma unroll
      for (int c = 0; c < kLanes; c += 2) {
        const longlong2 q = *reinterpret_cast<const longlong2*>(p + i0 + c);
        v[c] = q.x;
        v[c + 1] = q.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) v[j] = i0 + j < a.n ? p[i0 + j] : -1;
    }
  } else {
    const int32_t* p = static_cast<const int32_t*>(a.idx) + rb;
    if (vec) {
#pragma unroll
      for (int c = 0; c < kLanes; c += 4) {
        const int4 q = *reinterpret_cast<const int4*>(p + i0 + c);
        v[c] = q.x;
        v[c + 1] = q.y;
        v[c + 2] = q.z;
        v[c + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) v[j] = i0 + j < a.n ? p[i0 + j] : -1;
    }
  }
  const int64_t k = a.ncols;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    int64_t s = v[j];
    if (a.idx_mod) s = ((s % k) + k) % k;  // Python's modulo of the rank
    slot[j] = s >= 0 && s < k ? (int)s : -1;
  }
}

// Adds of a thread's lanes in a tile: for each of the group's (at most two)
// intervals a lane forms, its column index, its ends and its amount (0
// where the lane adds nothing).
struct Quad {
  int col[2][kLanes];
  float t0[2][kLanes], t1[2][kLanes], v[2][kLanes];
};

// The thread's intervals: lanes i0 .. i0 + kLanes - 1 of the row starting at lane rb
// of each operand.
template <int kForm>
__device__ __forceinline__ void form_intervals(const GaugeGridArgs& a, int64_t rb, int64_t i0,
                                               bool vec, Quad& q) {
  const int64_t n = a.n;
  bool on[kLanes];
  load_lanes(a.on + rb, i0, n, vec, on);
  if constexpr (kForm == kSite) {
    float amt[kLanes];
    load_lanes(a.f[0] + rb, i0, n, vec, q.t0[0]);
    load_lanes(a.f[1] + rb, i0, n, vec, q.t1[0]);
    if (a.f[2] != nullptr) load_lanes(a.f[2] + rb, i0, n, vec, amt);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      q.col[0][j] = 0;
      q.v[0][j] = on[j] ? (a.f[2] != nullptr ? amt[j] : a.amount_scalar) : 0.0f;
    }
  } else if constexpr (kForm == kQueue) {
    float e[kLanes], w[kLanes], p[kLanes];
    load_lanes(a.f[0] + rb, i0, n, vec, e);
    load_lanes(a.f[1] + rb, i0, n, vec, w);
    load_lanes(a.f[2] + rb, i0, n, vec, p);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      q.col[0][j] = 0;
      q.t0[0][j] = e[j];
      q.t1[0][j] = e[j] + w[j];
      q.v[0][j] = on[j] && w[j] > 0.0f ? 1.0f : 0.0f;
      q.col[1][j] = 1;
      q.t0[1][j] = e[j] - p[j];
      q.t1[1][j] = e[j];
      q.v[1][j] = on[j] && p[j] > 0.0f ? 1.0f : 0.0f;
    }
  } else if constexpr (kForm == kTrail) {
    float st[kLanes], dep[kLanes], t[kLanes], wr[kLanes], ram[kLanes];
    load_lanes(a.f[0] + rb, i0, n, vec, st);
    load_lanes(a.f[1] + rb, i0, n, vec, dep);
    load_lanes(a.f[2] + rb, i0, n, vec, t);
    if (a.f[3] != nullptr) load_lanes(a.f[3] + rb, i0, n, vec, wr);
    load_lanes(a.f[4] + rb, i0, n, vec, ram);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      q.col[0][j] = 0;
      q.t0[0][j] = st[j];
      q.t1[0][j] = dep[j];
      q.v[0][j] = on[j] && dep[j] > st[j] ? 1.0f : 0.0f;
      q.col[1][j] = 1;
      q.t0[1][j] = a.f[3] != nullptr ? t[j] + wr[j] : t[j];
      q.t1[1][j] = dep[j];
      q.v[1][j] = on[j] && ram[j] > 0.0f ? ram[j] : 0.0f;
    }
  } else {
    int slot[kLanes];
    load_lanes(a.f[0] + rb, i0, n, vec, q.t0[0]);
    load_lanes(a.f[1] + rb, i0, n, vec, q.t1[0]);
    load_slots(a, rb, i0, vec, slot);
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      q.col[0][j] = slot[j] < 0 ? 0 : slot[j];
      q.v[0][j] = on[j] && slot[j] >= 0 ? 1.0f : 0.0f;
    }
  }
}

// One stream of adds (an interval's starts, or its ends) of the thread's
// four lanes, keys col x rows + bucket (-1: no add), merged: the thread's
// runs of equal keys, then the warp's offers of each round.  ``add(key,
// value)`` adds into the group's columns.  Every lane of the warp calls it.
template <bool kAnyOrder, class Add>
__device__ __forceinline__ void merge_stream(const int (&key)[kLanes], const float (&val)[kLanes],
                                             Add add) {
  // the thread's own merge: offer k of round r (-1: none) and its sum
  int ok[kLanes + 1];
  float ov[kLanes + 1];
  if constexpr (kAnyOrder) {
    // each key's sum offered once, in the round of its first lane (the
    // LB's slots alternate lane by lane, so equal keys need not be
    // neighbours)
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      ok[j] = key[j];
      ov[j] = val[j];
    }
#pragma unroll
    for (int j = 1; j < kLanes; ++j) {
      bool merged = false;
#pragma unroll
      for (int i = 0; i < j; ++i) {
        if (!merged && ok[i] >= 0 && ok[i] == ok[j]) {
          ov[i] += ov[j];
          merged = true;
        }
      }
      if (merged) ok[j] = -1;
    }
    ok[kLanes] = -1;
    ov[kLanes] = 0.0f;
  } else {
    // runs of equal keys: a run's sum offered in the round of the lane
    // after it (the last run in round kLanes)
    int ck = -1;
    float cv = 0.0f;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      ok[j] = -1;
      ov[j] = 0.0f;
      if (key[j] < 0) continue;
      if (key[j] == ck) {
        cv += val[j];
      } else {
        ok[j] = ck;
        ov[j] = cv;
        ck = key[j];
        cv = val[j];
      }
    }
    ok[kLanes] = ck;
    ov[kLanes] = cv;
  }
  const int me = lane_id();
#pragma unroll
  for (int r = kAnyOrder ? 0 : 1; r < (kAnyOrder ? kLanes : kLanes + 1); ++r) {
    const int k = ok[r];
    unsigned rest = __ballot_sync(kAll, k >= 0);
    // the first kGroups keys among the offers: each summed by the warp
    // (a butterfly of shuffles over the lanes that offer it) and added
    // once, by its first lane
    for (int g = 0; rest != 0u && g < kGroups; ++g) {
      const int first = __ffs(rest) - 1;
      const int gk = __shfl_sync(kAll, k, first);
      const bool in = k == gk && k >= 0;
      const float sum = warp_sum(in ? ov[r] : 0.0f);
      if (me == first) add(gk, sum);
      rest &= ~__ballot_sync(kAll, in);
    }
    // past them (a fine grid's many buckets): each lane adds its own
    if ((rest >> me) & 1u) add(k, ov[r]);
  }
}

// The thread's lanes from lane i0 of row ``row``: their intervals' adds,
// merged, through ``add``.
template <int kForm, class Add>
__device__ __forceinline__ void tile_adds(const GaugeGridArgs& a, int64_t row, int64_t i0,
                                          bool vec, Add add) {
  constexpr int kIntervals = kForm == kQueue || kForm == kTrail ? 2 : 1;
  Quad q;
  form_intervals<kForm>(a, row * a.n, i0, vec, q);
  const int last = a.rows - 1;
#pragma unroll
  for (int i = 0; i < kIntervals; ++i) {
    int k0[kLanes], k1[kLanes];
    float v0[kLanes], v1[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const bool live = i0 + j < a.n && q.v[i][j] != 0.0f;
      const int base = q.col[i][j] * a.rows;
      k0[j] = live ? base + bucket(q.t0[i][j], a.scale, last) : -1;
      k1[j] = live ? base + bucket(q.t1[i][j], a.scale, last) : -1;
      v0[j] = q.v[i][j];
      v1[j] = -q.v[i][j];
    }
    constexpr bool kAny = kForm == kSlots;
    merge_stream<kAny>(k0, v0, add);
    merge_stream<kAny>(k1, v1, add);
  }
}

__device__ __forceinline__ bool aligned_rows(const GaugeGridArgs& a) {
  // every row of every operand starts on a 16-byte boundary
  if ((a.n & 3) != 0) return false;
  uintptr_t bits = reinterpret_cast<uintptr_t>(a.on) & 3u;
  for (int i = 0; i < 5; ++i) bits |= reinterpret_cast<uintptr_t>(a.f[i]) & 15u;
  bits |= reinterpret_cast<uintptr_t>(a.idx) & 15u;
  return bits == 0;
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) gauge_shared_kernel(GaugeGridArgs a) {
  // block (slice, row): the slice's share of the row's tiles
  const int64_t row = blockIdx.y;
  const int64_t tiles = (a.n + kTile - 1) / kTile;
  const int64_t first = tiles * blockIdx.x / gridDim.x;
  const int64_t last = tiles * (blockIdx.x + 1) / gridDim.x;
  const int cells = a.rows * a.ncols;
  for (int r = threadIdx.x; r < cells; r += kThreads) gauge_smem[r] = 0.0f;
  __syncthreads();
  const bool vec = aligned_rows(a);
  auto add = [&](int key, float v) { atomicAdd(gauge_smem + key, v); };
  // every thread runs the same trips, so whole warps vote
  for (int64_t t = first; t < last; ++t) {
    const int64_t i0 = t * kTile + (int64_t)threadIdx.x * kLanes;
    tile_adds<kForm>(a, row, i0, vec && i0 + kLanes <= a.n, add);
  }
  __syncthreads();
  float* out = a.grid + row * (int64_t)a.rows * a.G;
  for (int r = threadIdx.x; r < a.rows; r += kThreads) {
    for (int c = 0; c < a.ncols; ++c) {
      const float v = gauge_smem[c * a.rows + r];
      if (v == 0.0f) continue;
      // one slice a row adds alone; several add atomically
      float* cell = out + (int64_t)r * a.G + a.cols[c];
      if (gridDim.x == 1)
        *cell += v;
      else
        atomicAdd(cell, v);
    }
  }
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) gauge_global_kernel(GaugeGridArgs a) {
  const int64_t row = blockIdx.y;
  const int64_t i0 = (int64_t)blockIdx.x * kTile + (int64_t)threadIdx.x * kLanes;
  float* out = a.grid + row * (int64_t)a.rows * a.G;
  auto add = [&](int key, float v) {
    const int c = key / a.rows;
    atomicAdd(out + (int64_t)(key - c * a.rows) * a.G + a.cols[c], v);
  };
  tile_adds<kForm>(a, row, i0, aligned_rows(a) && i0 + kLanes <= a.n, add);
}

// Lane slices a row of the shared form: enough blocks for several waves of
// the card (kTargetBlocks in all), each slice at least kMinTiles tiles.
int64_t shared_slices(int64_t s, int64_t n) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  int64_t k = (kTargetBlocks + s - 1) / s;
  if (k > tiles / kMinTiles) k = tiles / kMinTiles;
  return k < 1 ? 1 : k;
}

template <int kForm>
int launch_form(GaugeGridArgs a, cudaStream_t stream) {
  const bool shared = (int64_t)a.rows <= kSharedRows &&
                      (int64_t)a.rows * a.ncols <= kSharedCells;
  const GaugeGridArgs whole = a;
  for (int64_t r0 = 0; r0 < whole.S; r0 += kMaxRows) {
    a = whole;
    a.S = whole.S - r0 < kMaxRows ? whole.S - r0 : kMaxRows;
    const int64_t lanes = r0 * whole.n;
    for (int i = 0; i < 5; ++i) a.f[i] = whole.f[i] ? whole.f[i] + lanes : nullptr;
    a.on = whole.on + lanes;
    a.idx = whole.idx ? static_cast<const char*>(whole.idx) + lanes * whole.idx_bytes : nullptr;
    a.grid = whole.grid + r0 * (int64_t)whole.rows * whole.G;
    const dim3 block(kThreads);
    if (shared) {
      const dim3 grid((unsigned)shared_slices(whole.S, a.n), (unsigned)a.S);
      const size_t smem = (size_t)a.rows * a.ncols * sizeof(float);
      gauge_shared_kernel<kForm><<<grid, block, smem, (cudaStream_t)stream>>>(a);
    } else {
      const dim3 grid((unsigned)((a.n + kTile - 1) / kTile), (unsigned)a.S);
      gauge_global_kernel<kForm><<<grid, block, 0, (cudaStream_t)stream>>>(a);
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

int gauge_grid_args_size() { return (int)sizeof(GaugeGridArgs); }

// Rows and cells (rows x the group's columns) up to which a launch takes
// the shared form.
int gauge_grid_shared_rows() { return kSharedRows; }
int gauge_grid_shared_cells() { return kSharedCells; }

// Launch on ``stream``; returns the launch's cudaError_t if it is not 0, or
// -1 for arguments the kernel does not take.
int gauge_grid_launch(const GaugeGridArgs* args, void* stream) {
  const GaugeGridArgs a = *args;
  if (a.S <= 0 || a.n <= 0 || a.rows < 1 || a.G < 1 || a.on == nullptr || a.grid == nullptr)
    return -1;
  const int want = a.form == kSlots ? 0 : (a.form == kSite ? 1 : 2);
  if (a.form < kSite || a.form > kSlots || a.ncols < 1 || a.ncols > 32) return -1;
  if (want != 0 && a.ncols != want) return -1;
  for (int c = 0; c < a.ncols; ++c)
    if (a.cols[c] < 0 || a.cols[c] >= a.G) return -1;
  const int needs = a.form == kSite ? 2 : (a.form == kQueue ? 3 : (a.form == kTrail ? 3 : 2));
  for (int i = 0; i < needs; ++i)
    if (a.f[i] == nullptr) return -1;
  if (a.form == kTrail && a.f[4] == nullptr) return -1;
  if (a.form == kSlots && (a.idx == nullptr || (a.idx_bytes != 4 && a.idx_bytes != 8)))
    return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a.form) {
    case kSite: return launch_form<kSite>(a, s);
    case kQueue: return launch_form<kQueue>(a, s);
    case kTrail: return launch_form<kTrail>(a, s);
    default: return launch_form<kSlots>(a, s);
  }
}

}  // extern "C"
