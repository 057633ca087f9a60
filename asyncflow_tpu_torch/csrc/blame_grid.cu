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
//   - a (slices, scenarios) grid of blocks of kWarps warps: a block takes a
//     slice of a row's lanes, and its warp w the tiles of 32 lanes w, w +
//     kWarps, ...; each warp adds into its own float64 rows in shared
//     memory, so no two warps add into one place;
//   - in a tile, the warp sorts its 32 lanes by key (a row's bin; a bitonic
//     network of shuffles over (key, lane) words, once a tile for every
//     static credit); each lane then reads the credit of the lane it holds
//     in key order, and a segmented scan of shuffles (a fixed tree of five
//     steps) sums each key's run; the run's last lane adds the sum into its
//     warp's row.  So a key's adds come in tile order, each a fixed tree of
//     the tile's lanes;
//   - the block then sums its warps' rows in warp order into a float64
//     partial of the slice; a second kernel sums a row's partials in slice
//     order and writes each cell rounded once.
// Rows that do not fit the shared memory of one launch go in passes of rows
// (u_lo .. u_hi), each a launch of both kernels.
//
// The plain version (blame_grid.py) sums each credit in float64 with
// scatter_add_, credit by credit, and rounds once: the same sums in another
// order, so a cell may differ from it by one float32 ulp where the float64
// sums round to either side of a float32 tie.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFinishThreads = 256;
// the shared memory a partial launch may take (rows x nbb x kWarps doubles)
constexpr int kSharedBytes = 96 * 1024;

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

// The 32 lanes' (key << 5 | lane) words in ascending order (a bitonic
// network); a key of kDead sorts last.
__device__ __forceinline__ unsigned sort_lanes(unsigned v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned other = __shfl_xor_sync(0xffffffffu, v, j);
      v = (((lane & j) == 0) == ((lane & k) == 0)) ? min(v, other) : max(v, other);
    }
  }
  return v;
}

// A tile's order: the source lane a lane holds, its key, the first lane of
// its key's run and whether it ends the run.
struct TileOrder {
  int src, key, first;
  bool last;
};

__device__ __forceinline__ TileOrder tile_order(int key, int lane) {
  const unsigned v = sort_lanes(((unsigned)key << 5) | (unsigned)lane, lane);
  TileOrder o;
  o.src = (int)(v & 31u);
  o.key = (int)(v >> 5);
  const int prev = __shfl_up_sync(0xffffffffu, o.key, 1);
  const int next = __shfl_down_sync(0xffffffffu, o.key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != o.key);
  o.first = 31 - __clz(heads & ((2u << lane) - 1u));
  o.last = lane == 31 || next != o.key;
  return o;
}

// The sum of x over the lanes of a run up to this one: five shuffle steps,
// a fixed tree.
__device__ __forceinline__ double run_scan(double x, int lane, int first) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane - d >= first) x += y;
  }
  return x;
}

constexpr int kDead = 0x7FFF;

__global__ void __launch_bounds__(kThreads) blame_partial_kernel(const BlameGridArgs a) {
  extern __shared__ double acc[];  // [kWarps][u_hi - u_lo][nbb]
  const int rows = a.u_hi - a.u_lo;
  const int cells = rows * a.nbb;
  for (int k = threadIdx.x; k < kWarps * cells; k += kThreads) acc[k] = 0.0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.y;
  const int slice = blockIdx.x;
  const int64_t lo = (int64_t)slice * a.slice_len;
  const int64_t hi = lo + a.slice_len < a.n ? lo + a.slice_len : a.n;
  const int64_t base = row * a.n;
  double* mine = acc + warp * cells;
  constexpr int64_t kStep = kWarps * 32;
  // the next tile's targets are read while this tile is summed
  int next_tgt = lo + warp * 32 + lane < hi ? (int)a.target[base + lo + warp * 32 + lane] : -1;
  for (int64_t t0 = lo + (int64_t)warp * 32; t0 < hi; t0 += kStep) {
    const int64_t i = t0 + lane;
    const bool valid = i < hi;
    const int tgt = next_tgt;
    next_tgt = i + kStep < hi ? (int)a.target[base + i + kStep] : -1;
    const bool live = tgt >= 0 && tgt < a.nbb;
    const TileOrder o = tile_order(live ? tgt : kDead, lane);
    const bool src_valid = t0 + o.src < hi;
    for (int c = 0; c < a.C; ++c) {
      const float* sp = reinterpret_cast<const float*>(a.secs[c]);
      const uint8_t* slp = reinterpret_cast<const uint8_t*>(a.slots[c]);
      if (slp == nullptr) {
        const int u = a.cand_row[c] - a.u_lo;
        if (u < 0 || u >= rows) continue;  // the same for the whole warp
        const double v = src_valid ? (double)sp[base + t0 + o.src] : 0.0;
        const double x = run_scan(v, lane, o.first);
        if (o.last && o.key != kDead) mine[u * a.nbb + o.key] += x;
      } else {
        const int s = valid ? (int)slp[base + i] : 0;
        const int u = a.slot_row[a.cand_row[c] + s] - a.u_lo;
        const bool on = live && u >= 0 && u < rows;
        const TileOrder q = tile_order(on ? u * a.nbb + tgt : kDead, lane);
        const double v = t0 + q.src < hi ? (double)sp[base + t0 + q.src] : 0.0;
        const double x = run_scan(v, lane, q.first);
        if (q.last && q.key != kDead) mine[q.key] += x;
      }
    }
  }
  __syncthreads();
  double* out = a.partial + (row * a.n_slices + slice) * (int64_t)cells;
  for (int k = threadIdx.x; k < cells; k += kThreads) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += acc[w * cells + k];
    out[k] = s;
  }
}

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

// Rows of a pass and lanes a block's warps take a tile, for the wrapper's
// scratch and slices.
int blame_grid_pass_rows(int nbb) { return nbb > 0 ? kSharedBytes / (kWarps * nbb * 8) : 0; }
int blame_grid_tile_lanes() { return kWarps * 32; }

// One pass (rows u_lo .. u_hi) on ``stream``: both kernels.  Returns the
// launches' cudaError_t if it is not 0, or -1 for arguments they do not take.
int blame_grid_launch(const BlameGridArgs* args, void* stream) {
  const BlameGridArgs a = *args;
  if (a.S <= 0 || a.n <= 0 || a.C < 1 || a.nbb < 1 || a.n_slices < 1 || a.slice_len < 1 ||
      a.u_lo < 0 || a.u_hi <= a.u_lo || a.u_hi > a.rows || a.secs == nullptr ||
      a.slots == nullptr || a.cand_row == nullptr || a.row_cell == nullptr ||
      a.target == nullptr || a.partial == nullptr || a.grid == nullptr ||
      a.lat_out == nullptr || (int64_t)a.n_slices * a.slice_len < a.n)
    return -1;
  const int64_t bytes = (int64_t)kWarps * (a.u_hi - a.u_lo) * a.nbb * 8;
  if (bytes > kSharedBytes) return -1;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        blame_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
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
