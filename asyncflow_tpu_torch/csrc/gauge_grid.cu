// The fast path's gauge grid on Hopper (sm_90a): one gauge site's intervals
// scattered onto the sample ticks, +amount at the bucket of each interval's
// start and -amount at the bucket of its end, into the site's column of the
// (S, rows, G) float32 grid; a cumulative sum over the rows then gives each
// tick's gauge value.
//
// Replaces the reference fast path's _gauge_intervals
// (asyncflow_tpu/engines/jaxsim/fastpath.py:1138-1144): XLA's scatter-add of
// both endpoints of every lane at every gauge site (no Pallas kernel stands
// behind it).  A lane's bucket is ceil(t * scale) clipped to [0, rows - 1],
// scale the float32 reciprocal of the grid's period (XLA folds the division
// by the constant period into that multiply), so "never" (1e30) lands in the
// last row.
//
// Lanes of a row come in arrival order, so neighbouring lanes mostly share a
// bucket and a plain scatter serialises on one address.  Each warp therefore
// first asks whether every lane it adds shares the first one's bucket: if so
// it sums the warp's amounts in registers (a butterfly of shuffles) and one
// lane adds the sum; otherwise each lane adds its own.  The amounts the fast
// path adds are queue lengths and connection counts (+-1) and RAM in whole
// MB, whose float32 sums are exact in any order, so the grid equals the plain
// scatter bit for bit; a fractional amount agrees within float32 rounding.
//
// Two forms, chosen per launch by the grid's rows:
//   shared (rows <= kSharedRows, the stride grids of streamed series): one
//     block a scenario row; the block zeroes its column in shared memory,
//     walks the row's lanes kThreads at a time (coalesced loads of t0, t1,
//     on and the amount), adds into shared memory, and adds the column to
//     the grid once, each nonzero row by one thread;
//   global (the fine grids): a (lane blocks, scenarios) grid whose warps add
//     straight into the grid's column with global atomics.
// Bound: bytes.  t0, t1 and on (9 B a lane, 13 with a per-lane amount) are
// read once; the column is read and written once a row.
// The host build (tests/test_torch_fast_host.py) runs one thread a block
// and one lane a warp, so the shared form's phases run in order there.

#include <cuda_runtime.h>

#include <cstdint>

// The launch's arguments, mirrored by gauge_grid._GaugeGridArgs (outside the
// unnamed namespace: the exported launch takes it).
struct GaugeGridArgs {
  const float* t0;       // (S, n) interval starts
  const float* t1;       // (S, n) interval ends
  const uint8_t* on;     // (S, n) bool: the lane adds its interval
  const float* amount;   // (S, n) per-lane amounts, or null for amount_scalar
  float* grid;           // (S, rows, G), column col receives the site
  int64_t S, n;
  int32_t rows, G, col;
  float scale;           // float32 reciprocal of the grid's period
  float amount_scalar;
};

extern __shared__ float gauge_smem[];

namespace {

#ifdef __CUDACC__
constexpr int kThreads = 512;  // threads a block
constexpr int kWarp = 32;
#else
constexpr int kThreads = 1;
constexpr int kWarp = 1;
#endif
// rows a block's column may hold in shared memory (8 KiB, so the column
// never limits the blocks an SM holds)
constexpr int kSharedRows = 2048;
constexpr int64_t kMaxRows = 65535;  // scenarios a global-form launch (gridDim.y)

__device__ __forceinline__ int bucket(float t, float scale, int last) {
  float b = ceilf(t * scale);
  b = fminf(fmaxf(b, 0.0f), (float)last);
  return (int)b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Add v at bucket b for every lane with `on`, the warp's adds merged into one
// where every such lane shares the first one's bucket.  Every lane of the
// warp calls it (the shuffles and votes need the whole warp).
__device__ __forceinline__ void warp_add(float* base, int64_t stride, int b, float v, bool on) {
  const unsigned act = __ballot_sync(0xffffffffu, on);
  if (act == 0u) return;
  const int leader = __ffs(act) - 1;
  const int lb = __shfl_sync(0xffffffffu, b, leader);
  if (__all_sync(0xffffffffu, !on || b == lb)) {
    const float sum = warp_sum(on ? v : 0.0f);
    const int lane = kWarp == 1 ? 0 : (int)(threadIdx.x % kWarp);
    if (lane == leader) atomicAdd(base + (int64_t)lb * stride, sum);
  } else if (on) {
    atomicAdd(base + (int64_t)b * stride, v);
  }
}

__global__ void __launch_bounds__(kThreads) gauge_shared_kernel(GaugeGridArgs a) {
  const int64_t row = blockIdx.x;
  for (int r = threadIdx.x; r < a.rows; r += kThreads) gauge_smem[r] = 0.0f;
  __syncthreads();
  const float* t0 = a.t0 + row * a.n;
  const float* t1 = a.t1 + row * a.n;
  const uint8_t* on = a.on + row * a.n;
  const float* amount = a.amount ? a.amount + row * a.n : nullptr;
  const int last = a.rows - 1;
  // every thread runs the same trips, so whole warps vote
  for (int64_t i0 = 0; i0 < a.n; i0 += kThreads) {
    const int64_t i = i0 + threadIdx.x;
    const bool in = i < a.n;
    const bool add = in && on[i] != 0;
    const float v = add ? (amount ? amount[i] : a.amount_scalar) : 0.0f;
    const int b0 = add ? bucket(t0[i], a.scale, last) : 0;
    const int b1 = add ? bucket(t1[i], a.scale, last) : 0;
    warp_add(gauge_smem, 1, b0, v, add);
    warp_add(gauge_smem, 1, b1, -v, add);
  }
  __syncthreads();
  float* col = a.grid + row * (int64_t)a.rows * a.G + a.col;
  for (int r = threadIdx.x; r < a.rows; r += kThreads) {
    const float v = gauge_smem[r];
    if (v != 0.0f) col[(int64_t)r * a.G] += v;
  }
}

__global__ void __launch_bounds__(kThreads) gauge_global_kernel(GaugeGridArgs a) {
  const int64_t row = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < a.n;
  const int64_t at = row * a.n + i;
  const bool add = in && a.on[at] != 0;
  const float v = add ? (a.amount ? a.amount[at] : a.amount_scalar) : 0.0f;
  const int last = a.rows - 1;
  const int b0 = add ? bucket(a.t0[at], a.scale, last) : 0;
  const int b1 = add ? bucket(a.t1[at], a.scale, last) : 0;
  float* col = a.grid + row * (int64_t)a.rows * a.G + a.col;
  warp_add(col, a.G, b0, v, add);
  warp_add(col, a.G, b1, -v, add);
}

}  // namespace

extern "C" {

int gauge_grid_args_size() { return (int)sizeof(GaugeGridArgs); }

// Rows up to which a launch takes the shared form.
int gauge_grid_shared_rows() { return kSharedRows; }

// Launch on ``stream``; returns the launch's cudaError_t if it is not 0, or
// -1 for arguments the kernel does not take.
int gauge_grid_launch(const GaugeGridArgs* args, void* stream) {
  GaugeGridArgs a = *args;
  if (a.S <= 0 || a.n <= 0 || a.rows < 1 || a.G < 1 || a.col < 0 || a.col >= a.G) return -1;
  if (a.t0 == nullptr || a.t1 == nullptr || a.on == nullptr || a.grid == nullptr) return -1;
  if (a.rows <= kSharedRows) {
    const dim3 grid((unsigned)a.S);
    const dim3 block(kThreads);
    const size_t smem = (size_t)a.rows * sizeof(float);
    gauge_shared_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const GaugeGridArgs whole = a;
  for (int64_t r0 = 0; r0 < whole.S; r0 += kMaxRows) {
    a = whole;
    a.S = whole.S - r0 < kMaxRows ? whole.S - r0 : kMaxRows;
    a.t0 = whole.t0 + r0 * whole.n;
    a.t1 = whole.t1 + r0 * whole.n;
    a.on = whole.on + r0 * whole.n;
    a.amount = whole.amount ? whole.amount + r0 * whole.n : nullptr;
    a.grid = whole.grid + r0 * (int64_t)whole.rows * whole.G;
    const dim3 grid((unsigned)((a.n + kThreads - 1) / kThreads), (unsigned)a.S);
    const dim3 block(kThreads);
    gauge_global_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
