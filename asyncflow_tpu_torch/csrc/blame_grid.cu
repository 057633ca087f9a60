// The fast path's blame grid on Hopper (sm_90a): every latency credit of a
// chunk's lanes summed into the (S, n_cells, nbb) float32 grid of seconds a
// (component x phase cell, coarse latency bin), keyed by each lane's coarse
// bin, and the lanes' latencies into the (S, nbb) totals beside it.
//
// Replaces the reference fast path's blame scatter
// (asyncflow_tpu/engines/jaxsim/fastpath.py:2259-2267): XLA's scatter-add of
// every credit candidate into the grid at (cell, target) and of the latency
// at target (no Pallas kernel stands behind it).  A lane's target is its
// coarse bin where its request succeeded, else out of range (>= nbb or < 0):
// its credits drop.
//
// Inputs: C credits, each (S, n) float32 seconds with the credit's
// predicate folded in as 0.0, and its cell, one for every lane (static) or
// each lane's own from a small table indexed by the lane's uint8 slot (the
// LB hop's edge); the lanes' int16 targets; the lanes' latencies, which the
// wrapper passes as the last credit, into the latency row.
//
// The sum must give the same bits on every launch, which float atomics into
// one cell from many threads do not.  So every add into a cell has a fixed
// place in a fixed order, and every sum is a float64 sum rounded to float32
// once:
//   - the wrapper maps the cells the credits can reach to "rows" (a used
//     cell each, then the latency row);
//   - a (slices, scenarios) grid of blocks of kThreads threads: a block
//     takes a slice of a row's lanes and walks it in segments of kSeg
//     lanes, adding into one float64 row set in shared memory;
//   - a segment is sorted once, stably, by the key (bin, slot): a counting
//     sort in shared memory (each warp's lanes in rounds of 32 in lane
//     order, its counts a key by __match_any_sync and the popcount of the
//     lower peers, the warps' counts and the keys' starts summed in
//     integers), the slot the first per-lane credit's (where the keys would
//     outnumber kMaxKeys, sorted by slot and then by bin: the same order);
//     a static credit sums the runs of a bin, which are unions of
//     consecutive (bin, slot) runs, and the per-lane credit the (bin,
//     slot) runs;
//   - for each credit the segment's values are staged in shared memory
//     (coalesced loads, the next credit's loads in flight meanwhile) and
//     each thread sums its stretch of kPer consecutive sorted positions in
//     order in float64, split where the key changes; a run inside one
//     stretch is added by its thread; a run over several stretches by the
//     thread holding its end, from the open run's sums of the threads
//     before (a segmented scan across the block: five shuffle steps in a
//     warp, the warps' ends in order), so no two threads add into one
//     cell in one phase and every add has its place;
//   - the block writes its row set as a float64 partial of the slice; a
//     second kernel sums a row's partials in slice order and writes each
//     cell rounded once.
// Rows that do not fit the row set of one launch go in passes of rows
// (u_lo .. u_hi), each a launch of both kernels.  The wrapper maps a
// per-lane credit's slots to distinct rows (slots of one cell share a
// slot), so that each (bin, slot) run adds into a cell of its own.
//
// Bound: bytes (each credit, slot, bin and latency read once, the grid
// written once).  A value costs about one shared store, one shared gather
// and one float64 add, and a stretch of kPer values a credit about 12
// shuffles: the sort is paid once a segment, not once a credit.  The
// latency of a credit's pass (two barriers, the scan's steps) is the
// limit, not the bytes: segments of 4,096 lanes (kPer 16) took the
// headline's call in 7.1 ms, of 2,048 in 9.2 and of 1,024 in 8.1
// (scripts/torch_blame_times.py --against).
//
// The plain version (blame_grid.py) sums each credit in float64 with
// scatter_add_, credit by credit, and rounds once: the same sums in another
// order, so a cell may differ from it by one float32 ulp where the float64
// sums round to either side of a float32 tie.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                  // sorted positions a thread's stretch
constexpr int kSeg = kThreads * kPer;     // lanes a segment, sorted once
constexpr int kRounds = kSeg / kThreads;  // rounds of 32 lanes a warp's sort
constexpr int kMaxKeys = 512;             // keys of one counting pass
// a sorted position in registers: bin << kBinShift | slot << kLaneBits | lane
constexpr int kLaneBits = 12;
constexpr int kBinShift = kLaneBits + 8;
static_assert(kSeg <= 1 << kLaneBits, "a segment's lanes fit kLaneBits");
constexpr int kFinishThreads = 256;
// the shared memory of a launch's float64 row set (rows x nbb doubles)
constexpr int kRowBytes = 32 * 1024;
constexpr unsigned kAll = 0xffffffffu;

}  // namespace

struct BlameGridArgs {
  const uint64_t* secs;     // C pointers to (S, n) float32 seconds
  const uint64_t* slots;    // C pointers to (S, n) uint8 slots, 0: a static cell
  const int32_t* cand_row;  // C: a static credit's row, or where its rows start in slot_row
  const int32_t* slot_row;  // the per-lane credits' rows, by slot
  const int32_t* row_cell;  // each row's cell of the grid, -1: the latency row
  const int16_t* target;    // (S, n) coarse bins
  double* partial;          // (S, n_slices, u_hi - u_lo, nbb) scratch
  float* grid;              // (S, n_cells, nbb), zeroed by the caller
  float* lat_out;           // (S, nbb)
  int64_t S, n;
  int32_t C, n_cells, nbb, rows, u_lo, u_hi, n_slices, slice_len;
};

namespace {

// The block's shared memory past its row set.
struct Stage {
  float vals[kSeg];                    // a credit's values, by lane of the segment
  int32_t key[kSeg];                   // each lane's (bin, slot) key
  uint16_t perm[2][kSeg];              // the sorted order (lanes), and a pass's
  int16_t bin[kSeg];                   // each lane's bin, nbb where it drops
  uint8_t slot[kSeg];                  // each lane's slot of the sort
  uint16_t cnt[kWarps][kMaxKeys];      // a pass's counts, then bases, a warp a key
  int32_t start[kMaxKeys];             // a pass's keys' first positions
  double wsum[kWarps];                 // each warp's open run's sum at its end
  int32_t wflag[kWarps];               // whether that run starts in the warp
  int32_t kslots;                      // slots of the sort in the segment
};

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// One stable counting pass: positions 0 .. kSeg - 1 of order ``src`` (the
// identity where null) by key_of(lane), the sorted lanes into ``dst``.
template <class KeyOf>
__device__ __forceinline__ void count_pass(Stage& st, const uint16_t* src, uint16_t* dst,
                                           int n_keys, KeyOf key_of) {
  const int warp = threadIdx.x >> 5, lane = lane_id();
  for (int k = lane; k < n_keys; k += 32) st.cnt[warp][k] = 0;
  __syncwarp();
  int keys[kRounds], local[kRounds], lanes[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = warp * (kSeg / kWarps) + r * 32 + lane;
    const int l = src == nullptr ? p : (int)src[p];
    const int key = key_of(l);
    const unsigned peers = __match_any_sync(kAll, key);
    const int leader = __ffs(peers) - 1;
    int old = 0;
    if (lane == leader) {
      old = st.cnt[warp][key];
      st.cnt[warp][key] = (uint16_t)(old + __popc(peers));
    }
    old = __shfl_sync(kAll, old, leader);
    keys[r] = key;
    lanes[r] = l;
    local[r] = old + __popc(peers & ((1u << lane) - 1u));
    __syncwarp();
  }
  __syncthreads();
  // each key's warps' bases, then the keys' starts (integers: exact)
  for (int k = threadIdx.x; k < n_keys; k += kThreads) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = st.cnt[w][k];
      st.cnt[w][k] = (uint16_t)run;
      run += c;
    }
    st.start[k] = run;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    constexpr int kEach = kMaxKeys / 32;
    int sum = 0;
    for (int i = 0; i < kEach; ++i) {
      const int k = lane * kEach + i;
      if (k < n_keys) sum += st.start[k];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += y;
    }
    int at = incl - sum;
    for (int i = 0; i < kEach; ++i) {
      const int k = lane * kEach + i;
      if (k < n_keys) {
        const int c = st.start[k];
        st.start[k] = at;
        at += c;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    dst[st.start[keys[r]] + st.cnt[warp][keys[r]] + local[r]] = (uint16_t)lanes[r];
  __syncthreads();
}

// Sort the segment's lanes by (bin, slot) of the slot tensor ``slp`` (none:
// by bin): st.perm[0] the order, st.key each lane's key, st.kslots the
// slots.  The bins are staged.
__device__ __forceinline__ void sort_segment(Stage& st, const uint8_t* slp, int64_t at,
                                             int64_t live_n, int nbb) {
  if (threadIdx.x == 0) st.kslots = 1;
  __syncthreads();
  int top = 0;
  for (int l = threadIdx.x; l < kSeg; l += kThreads) {
    const int s = slp != nullptr && l < live_n ? (int)slp[at + l] : 0;
    st.slot[l] = (uint8_t)s;
    top = max(top, s);
  }
  top = __reduce_max_sync(kAll, top);
  if (lane_id() == 0 && top > 0) atomicMax(&st.kslots, top + 1);
  __syncthreads();
  const int ks = st.kslots;
  const int dead = nbb * ks;
  for (int l = threadIdx.x; l < kSeg; l += kThreads) {
    const int b = st.bin[l];
    st.key[l] = b < nbb ? b * ks + st.slot[l] : dead;
  }
  __syncthreads();
  if (dead + 1 <= kMaxKeys) {
    count_pass(st, nullptr, st.perm[0], dead + 1, [&](int l) { return st.key[l]; });
  } else {
    count_pass(st, nullptr, st.perm[1], ks, [&](int l) { return (int)st.slot[l]; });
    count_pass(st, st.perm[1], st.perm[0], nbb + 1, [&](int l) { return (int)st.bin[l]; });
  }
}

// A thread's stretch: its sorted positions, each packed as bin <<
// kBinShift | slot << kLaneBits | lane (a dropped lane: bin nbb, slot 0),
// and the positions before and after it (-1 at the segment's ends).  One
// register a position: the stretch, a credit's values in flight and the
// float64 sums stay in registers.
struct Stretch {
  int pos[kPer];
  int prev, next;
};

// The run structure of a stretch under a run key (the packed position
// shifted right by ``shift``: kBinShift, a bin's runs; kLaneBits, the
// (bin, slot) runs), and the segmented scan's steps, which depend on it
// alone.
struct Runs {
  unsigned cut;   // bit i: a run starts at position i > 0 of the stretch
  bool cont_prev, cont_next, single;
  unsigned take;  // bit i: scan step i adds the value from lane - 2^i
  bool starts;    // the open run through this stretch starts in the warp
};

__device__ __forceinline__ Runs runs_of(const Stretch& s, int shift) {
  Runs r;
  r.cut = 0;
#pragma unroll
  for (int i = 1; i < kPer; ++i)
    if ((s.pos[i] >> shift) != (s.pos[i - 1] >> shift)) r.cut |= 1u << i;
  r.single = r.cut == 0;
  r.cont_prev = (s.prev >> shift) == (s.pos[0] >> shift);  // -1 >> shift is -1
  r.cont_next = (s.next >> shift) == (s.pos[kPer - 1] >> shift);
  const int lane = lane_id();
  int f = r.single && r.cont_prev ? 0 : 1;
  r.take = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int d = 1 << i;
    const int g = __shfl_up_sync(kAll, f, d);
    if (lane >= d && f == 0) r.take |= 1u << i;
    if (lane >= d) f |= g;
  }
  r.starts = f != 0;
  return r;
}

// One credit's pass over the segment's staged values: row_of(pos) maps a
// run's packed position to its row in the pass (< 0: none, or dropped).
template <class RowOf>
__device__ __forceinline__ void credit_pass(Stage& st, double* acc, int nbb, const Stretch& s,
                                            const Runs& r, RowOf row_of) {
  const auto add = [&](int pos, double x) {
    const int b = pos >> kBinShift;
    const int u = row_of(pos);
    if (u >= 0 && b < nbb) acc[u * nbb + b] += x;
  };
  double run = 0.0, head = 0.0;
  bool open_head = r.cont_prev;  // the leading run continues a run before
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if ((r.cut >> i) & 1u) {
      if (open_head) {
        head = run;
        open_head = false;
      } else {
        add(s.pos[i - 1], run);
      }
      run = 0.0;
    }
    run = run + (double)st.vals[s.pos[i] & (kSeg - 1)];
  }
  const bool head_here = open_head;  // the stretch is one run continuing one before
  if (!r.cont_next) {
    if (head_here) {
      head = run;
    } else {
      add(s.pos[kPer - 1], run);
    }
  }
  // the open run's sum through each stretch: a segmented scan
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  double v = run;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const double y = __shfl_up_sync(kAll, v, 1 << i);
    if (r.take & (1u << i)) v = y + v;
  }
  if (lane == 31) {
    st.wsum[warp] = v;
    st.wflag[warp] = r.starts;
  }
  __syncthreads();
  double into = 0.0;  // the open run's sum at the warp's start
  for (int w = 0; w < warp; ++w) into = st.wflag[w] ? st.wsum[w] : into + st.wsum[w];
  const double through = r.starts ? v : into + v;
  double before = __shfl_up_sync(kAll, through, 1);
  if (lane == 0) before = into;
  // the run that ends in this stretch and began before it: its last holder
  if (r.cont_prev && !(r.single && r.cont_next)) add(s.pos[0], before + head);
}

// Two blocks an SM: the shared memory (the stage and a row set, ~104 KB a
// block) allows no more, and registers beyond 128 a thread would allow
// fewer.
__global__ void __launch_bounds__(kThreads, 2) blame_partial_kernel(const BlameGridArgs a) {
  extern __shared__ double smem[];
  const int rows = a.u_hi - a.u_lo;
  const int cells = rows * a.nbb;
  double* acc = smem;  // [rows][nbb]
  Stage& st = *reinterpret_cast<Stage*>(smem + cells);
  for (int k = threadIdx.x; k < cells; k += kThreads) acc[k] = 0.0;
  const int64_t row = blockIdx.y;
  const int slice = blockIdx.x;
  const int64_t lo = (int64_t)slice * a.slice_len;
  const int64_t hi = lo + a.slice_len < a.n ? lo + a.slice_len : a.n;
  const int64_t base = row * a.n;
  // the sort's slots: the first per-lane credit's
  const uint8_t* sort_slots = nullptr;
  for (int c = 0; c < a.C && sort_slots == nullptr; ++c)
    sort_slots = reinterpret_cast<const uint8_t*>(a.slots[c]);
  const auto in_pass = [&](int c) {
    if (a.slots[c] != 0) return true;
    const int u = a.cand_row[c] - a.u_lo;
    return u >= 0 && u < rows;
  };
  for (int64_t seg0 = lo; seg0 < hi; seg0 += kSeg) {
    const int64_t live_n = hi - seg0 < kSeg ? hi - seg0 : kSeg;
    const int64_t at = base + seg0;
    __syncthreads();  // the last segment's stage is read no more
    for (int l = threadIdx.x; l < kSeg; l += kThreads) {
      const int t = l < live_n ? (int)a.target[at + l] : -1;
      st.bin[l] = (int16_t)(t >= 0 && t < a.nbb ? t : a.nbb);
    }
    const uint8_t* sorted_by = sort_slots;
    sort_segment(st, sorted_by, at, live_n, a.nbb);
    Stretch s;
    const auto packed = [&](int p) {
      const int l = st.perm[0][p];
      const int b = st.bin[l];
      return b << kBinShift | (b < a.nbb ? (int)st.slot[l] : 0) << kLaneBits | l;
    };
    const auto load_stretch = [&]() {
#pragma unroll
      for (int i = 0; i < kPer; ++i) s.pos[i] = packed(threadIdx.x * kPer + i);
      s.prev = threadIdx.x == 0 ? -1 : packed(threadIdx.x * kPer - 1);
      s.next = threadIdx.x == kThreads - 1 ? -1 : packed(threadIdx.x * kPer + kPer);
    };
    load_stretch();
    Runs by_bin = runs_of(s, kBinShift), by_slot = runs_of(s, kLaneBits);
    // a credit's values, kPer a thread in flight while the one before is summed
    float next[kPer];
    const auto fetch = [&](int c) {
      const float* sp = reinterpret_cast<const float*>(a.secs[c]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int l = threadIdx.x + i * kThreads;
        next[i] = l < live_n ? sp[at + l] : 0.0f;
      }
    };
    int c = 0;
    while (c < a.C && !in_pass(c)) ++c;
    if (c < a.C) fetch(c);
    while (c < a.C) {
      const uint8_t* slp = reinterpret_cast<const uint8_t*>(a.slots[c]);
      if (slp != nullptr && slp != sorted_by) {
        // another per-lane credit's slots: sort again
        sorted_by = slp;
        sort_segment(st, sorted_by, at, live_n, a.nbb);
        load_stretch();
        by_bin = runs_of(s, kBinShift);
        by_slot = runs_of(s, kLaneBits);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) st.vals[threadIdx.x + i * kThreads] = next[i];
      __syncthreads();
      int c_next = c + 1;
      while (c_next < a.C && !in_pass(c_next)) ++c_next;
      if (c_next < a.C) fetch(c_next);
      if (slp == nullptr) {
        const int u = a.cand_row[c] - a.u_lo;
        credit_pass(st, acc, a.nbb, s, by_bin, [&](int) { return u; });
      } else {
        const int first = a.cand_row[c];
        credit_pass(st, acc, a.nbb, s, by_slot, [&](int pos) {
          const int u = a.slot_row[first + ((pos >> kLaneBits) & 0xff)] - a.u_lo;
          return u >= 0 && u < rows ? u : -1;
        });
      }
      __syncthreads();  // the values and the warps' sums are read no more
      c = c_next;
    }
  }
  __syncthreads();
  double* out = a.partial + (row * a.n_slices + slice) * (int64_t)cells;
  for (int k = threadIdx.x; k < cells; k += kThreads) out[k] = acc[k];
}

}  // namespace

__global__ void __launch_bounds__(kFinishThreads) blame_finish_kernel(const BlameGridArgs a) {
  const int rows = a.u_hi - a.u_lo;
  const int64_t cells = (int64_t)rows * a.nbb;
  const int64_t k = (int64_t)blockIdx.x * kFinishThreads + threadIdx.x;
  if (k >= a.S * cells) return;
  const int64_t row = k / cells;
  const int64_t j = k - row * cells;
  const double* p = a.partial + row * a.n_slices * cells + j;
  double s = 0.0;
  for (int sl = 0; sl < a.n_slices; ++sl) s += p[sl * cells];
  const int u = a.u_lo + (int)(j / a.nbb);
  const int b = (int)(j % a.nbb);
  const int cell = a.row_cell[u];
  if (cell < 0) {
    a.lat_out[row * a.nbb + b] = (float)s;
  } else {
    a.grid[(row * a.n_cells + cell) * a.nbb + b] = (float)s;
  }
}

extern "C" {

int blame_grid_args_size() { return (int)sizeof(BlameGridArgs); }

// Rows of a pass and lanes a segment (a slice is a whole number of
// segments), for the wrapper's scratch and slices.
int blame_grid_pass_rows(int nbb) { return nbb > 0 ? kRowBytes / (nbb * 8) : 0; }
int blame_grid_segment_lanes() { return kSeg; }

// One pass (rows u_lo .. u_hi) on ``stream``: both kernels.  Returns the
// launches' cudaError_t if it is not 0, or -1 for arguments they do not take.
int blame_grid_launch(const BlameGridArgs* args, void* stream) {
  const BlameGridArgs a = *args;
  if (a.S <= 0 || a.n <= 0 || a.C < 1 || a.nbb < 1 || a.n_slices < 1 || a.slice_len < 1 ||
      a.u_lo < 0 || a.u_hi <= a.u_lo || a.u_hi > a.rows || a.secs == nullptr ||
      a.slots == nullptr || a.cand_row == nullptr || a.row_cell == nullptr ||
      a.target == nullptr || a.partial == nullptr || a.grid == nullptr ||
      a.lat_out == nullptr || (int64_t)a.n_slices * a.slice_len < a.n || a.nbb >= kMaxKeys)
    return -1;
  const int64_t row_bytes = (int64_t)(a.u_hi - a.u_lo) * a.nbb * 8;
  if (row_bytes > kRowBytes) return -1;
  const int64_t bytes = row_bytes + (int64_t)sizeof(Stage);
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        blame_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kRowBytes + (int)sizeof(Stage));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)a.n_slices, (unsigned)a.S);
  const dim3 block(kThreads);
  blame_partial_kernel<<<grid, block, (size_t)bytes, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = a.S * (int64_t)(a.u_hi - a.u_lo) * a.nbb;
  const dim3 fgrid((unsigned)((total + kFinishThreads - 1) / kFinishThreads));
  blame_finish_kernel<<<fgrid, kFinishThreads, 0, s>>>(a);
  e = cudaGetLastError();
  return e == cudaSuccess ? 0 : (int)e;
}

}  // extern "C"
