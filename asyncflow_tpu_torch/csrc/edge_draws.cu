// The scan fast path's per-lane draws on Hopper (sm_90a): the fused edge
// hop, the arrival gaps with their prefix sum, and plain uniforms.
//
// Replaces the XLA work of the reference's fast path
// (asyncflow_tpu/engines/jaxsim/fastpath.py): the edge hop with its lane
// epilogue (_edge_hop :818, _edge_hop_dyn :855, _add_spike :793 and the
// gauge and drop sums of _journey), the arrival gaps and their cumsum
// (_arrivals_stream), and the raw draw_uniform streams.  XLA materialises
// every threefry round of a draw and every pass of the epilogue; here one
// thread takes 16 consecutive lanes of one scenario end to end and writes
// only what the journey reads next.
//
// Lane i of a stream is threefry2x32 of the counter (0, i) under the
// stream's key, its 32 bits the two output words XORed; the uniform is
// bitcast((bits >> 9) | 0x3f800000) - 1.  A hop drops the lane where
// u < p, draws its delay from (u - p) / max(1 - p, TINY) (a normal or
// lognormal law reads z = sqrt(2) erfinv(u') from the z stream, with XLA's
// float32 erfinv polynomial), then adds the network spike active at the
// send time.  A gap is -log1p(-u) with XLA's CPU log1p, so the arrivals
// take the reference's values; XLA's CPU cumsum is a recursive scan of
// 16-lane blocks, and this kernel computes every level of it in one pass a
// row (gap_sum_kernel).  Built with --fmad=false: every float
// operation rounds on its own, as the plain PyTorch version's does; the
// multiply-adds XLA fuses in its log1p are fmaf here, and float64 steps
// rounded once in the plain version (equal on every uniform).
//
// Modes:
//   0 uniform: out (S, n) = u, or the gap -log1p(-u) with `gap` (of the
//      given uniforms x_in (S, n) where given: the check of log1p_xla);
//   1 hop: in t_send, alive (S, n); gate = alive & t_send < horizon;
//      out t_next = ok ? t_send + delay : t_send and ok = gate & !dropped
//      (S, n), with the rank the LB slot rank % K of a gated lane (else
//      slot 0), or with the slot (S, n) int32 that LB slot itself (a gated
//      lane of slot -1 has no healthy target: dropped at the LB, it sends
//      nothing), and the slot's target server (S, n); under edge fault
//      windows the row of the fault table active at the send time
//      (max(searchsorted(fault_t, t_send, right) - 1, 0), on the
//      scenario's own row of (S, NF) or on the shared (NF,), the row's
//      tables staged in the block's shared memory where they fit, found by
//      a binary search of fixed steps, a thread's four lanes at a time)
//      boosts the
//      drop probability, p = clip(drop + boost, 0, 1), and multiplies the
//      law's delay by its factor before the spike is added (two roundings,
//      as XLA's _edge_hop); per scenario the drop
//      count (gate & dropped, and the LB's drops) and each edge slot's
//      gauge span, the sum over
//      ok lanes of max(min(t_send + delay, h) - min(t_send, h), 0), in
//      float64 in a fixed order (a thread's lanes, the block's threads, the
//      row's blocks) and rounded once; a hop with no span output (the
//      least-connections candidates, whose sums belong to the lanes that
//      pick the slot) writes only t_next and ok, with no epilogue;
//   2 gaps: out (S, ld_out) = 0, then the inclusive prefix sums of the
//      drawn gaps in XLA's order, n of them.
//
// Grid (lane blocks, scenarios), 128 threads a block, 16 lanes a thread:
// 32-bit lane indices and no division.  Rows whose start is 16-byte
// aligned move float4 / uint4; others move scalars.  The gaps' prefix sum
// takes a block of kTileBlocks threads a row instead (gap_sum_kernel): its
// value at lane i is lane i's sum within its 16-lane block plus P_2 of the
// block before, where P_L of an entry is its sum within its level-L block
// plus P_{L+1} of the block before that, each from block totals at or
// before i, so one streaming pass over the row, tile by tile, computes
// every level in XLA's order and writes each lane once (XLA's recursion,
// run level by level, wrote and read back every level and every partial
// sum).
//
// Bound: operations.  A lane costs one threefry block (two with a normal
// law) of about 86 integer operations, against 10 bytes moved by a hop
// lane (22 on the LB hop by rank, 18 by slot): at the card's int32 rate a
// block is ~3x the static hop's bytes' time at 3.35 TB/s.  A gap lane adds
// XLA's log1p (about 37 float operations) and its prefix sum's adds, and
// writes 4 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

struct EdgeDrawArgs {
  const int32_t* ukey;       // (S, 2) key words of the uniform stream
  const int32_t* zkey;       // (S, 2) key words of the normal stream, or null
  const float* x_in;         // uniform: (S, n) uniforms to take the gaps of, or null
  const float* t_send;       // hop: (S, n) send times
  const uint8_t* alive;      // hop: (S, n)
  const int64_t* rank;       // hop: (S, n) arrival rank (LB slot rank % K), or null
  const int32_t* slot;       // hop: (S, n) LB slot, -1 for none healthy, or null
  const int32_t* lb_edge;    // (K,) edge of each LB slot
  const int32_t* lb_target;  // (K,) server of each LB slot
  const float* mean;         // (S, NE)
  const float* var;          // (S, NE)
  const float* drop;         // (S, NE)
  const int32_t* dist;       // (NE,) delay law of each edge
  const float* spike_t;      // (NB,) spike breakpoints (first 0), or null
  const float* spike_v;      // (NB, NE) active spike of each edge
  const float* fault_t;      // (NF,) or (S, NF) fault breakpoints (first 0), or null
  const float* fault_lat;    // (NF, NE) or (S, NF, NE) latency factor of each edge
  const float* fault_drop;   // (NF, NE) or (S, NF, NE) dropout boost of each edge
  float* out;                // uniform: (S, n); hop: t_next (S, n); gaps: (S, ld_out), 1 + n used
  uint8_t* ok;               // hop: (S, n)
  int32_t* target;           // hop with rank: (S, n)
  double* partial;           // hop: (S, lane blocks, K + 1)
  float* span;               // hop: (S, K)
  int64_t* dropped;          // hop: (S,)
  int64_t S;
  int64_t n;       // lanes a row
  int64_t ld_out;  // gaps: the output's row stride, n + 1 or more
  float horizon;
  int32_t NE;
  int32_t NB;
  int32_t K;     // hop: edge slots (1 for a static edge)
  int32_t edge;  // hop: the static edge, or -1 with rank
  int32_t mode;
  int32_t gap;   // uniform: write the gap -log1p(-u)
  int32_t NF;    // hop: fault breakpoints (0 without edge faults)
  int32_t fault_per_row;  // hop: the fault tables have a row a scenario
};

// per-thread gauge accumulators of the hop, (K, threads) doubles, and the
// drop counters, (threads,) ints after them
extern __shared__ double edge_smem[];

namespace {

constexpr int kUniformMode = 0;
constexpr int kHopMode = 1;
constexpr int kGapsMode = 2;
constexpr int kThreads = 128;
constexpr int kLanes = 16;  // lanes a thread: one block of XLA's cumsum
constexpr int kLaneBlock = kThreads * kLanes;
constexpr int kMaxRows = 65535;  // scenarios a launch (gridDim.y)
// the gap prefix sum: a tile of kTileBlocks level-1 blocks (4096 lanes, one
// level-3 block of XLA's recursion) a step; levels up to 16^8 = 2^32 lanes
// (every n a launch takes); its threads a row: a level-1 block each on the
// card, one in the host build (it runs a block's threads one after another,
// so one thread takes every step of the tile in turn)
constexpr int kTileBlocks = 256;
constexpr int kTileLanes = kTileBlocks * kLanes;
constexpr int kMaxLevels = 8;
#ifdef __CUDACC__
constexpr int kRowThreads = kTileBlocks;
#else
constexpr int kRowThreads = 1;
#endif
constexpr int kMaxSlots = 32;    // LB slots (shared memory)
// the hop's dynamic shared memory: its sums' accumulators, then its row's
// fault tables where they fit (else its lanes read them in global memory)
constexpr size_t kHopSmem = 48 * 1024;

constexpr int kUniform = 0;
constexpr int kExponential = 2;
constexpr int kNormal = 3;  // 4 is the lognormal law
constexpr float kTiny = 1e-15f;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 with 20 rounds (jax.random's threefry_2x32)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t x0,
                                                  uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rots[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rots[(i % 2) * 4 + j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ float uniform_of(uint32_t k0, uint32_t k1, uint32_t i) {
  const uint32_t bits = threefry_bits(k0, k1, 0u, i);
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// a multiply-add that XLA's CPU code fuses, rounded once.  The plain
// version computes it as float64 a * b + c rounded to float32 (the product
// is exact in float64); the two agree on all 2**23 uniforms' gaps
// (chip_smoke.py checks it), and fmaf is the cheaper of the two here.
__device__ __forceinline__ float fma_xla(float a, float b, float c) {
  return fmaf(a, b, c);
}

// XLA's CPU float32 log (Eigen's plog, Cephes' polynomial), with the
// multiply-adds its compiler fuses
__device__ float log_xla(float v) {
  const uint32_t b = __float_as_uint(fmaxf(v, 1.17549435e-38f));  // the smallest normal
  float x = __uint_as_float((b & 0x807FFFFFu) | 0x3F000000u);      // mantissa in [0.5, 1)
  float e = 1.0f + (float)((int32_t)(b >> 23) - 0x7F);
  const bool below = x < 0.707106781186547524f;
  const float keep = below ? x : 0.0f;
  x = x - 1.0f;
  e = e - (below ? 1.0f : 0.0f);
  x = x + keep;
  const float x2 = x * x;
  const float x3 = x2 * x;
  float y = fma_xla(x, 7.0376836292E-2f, -1.1514610310E-1f);
  float y1 = fma_xla(x, -1.2420140846E-1f, 1.4249322787E-1f);
  float y2 = fma_xla(x, 2.0000714765E-1f, -2.4999993993E-1f);
  y = fma_xla(y, x, 1.1676998740E-1f);
  y1 = fma_xla(y1, x, -1.6668057665E-1f);
  y2 = fma_xla(y2, x, 3.3333331174E-1f);
  y = fma_xla(y, x3, y1);
  y = fma_xla(y, x3, y2);
  y = fma_xla(y, x3, -2.12194440e-4f * e);
  x = x - 0.5f * x2;
  x = x + y;
  x = x + 0.693359375f * e;
  const float inf = __uint_as_float(0x7F800000u);
  if (v == 0.0f) return -inf;
  if (v == inf) return inf;
  if (!(v > 0.0f)) return __uint_as_float(0x7FFFFFFFu);
  return x;
}

// XLA's CPU float32 log1p: Cephes' rational form below sqrt(2) - 1, with
// its Horner steps fused, else log(1 + x)
__device__ float log1p_xla(float x) {
  const float p[7] = {4.5270000862445199635215E-5f, 4.9854102823193375972212E-1f,
                      6.5787325942061044846969E0f,  2.9911919328553073277375E1f,
                      6.0949667980987787057556E1f,  5.7112963590585538103336E1f,
                      2.0039553499201281259648E1f};
  const float q[7] = {1.0f,
                      1.5062909083469192043167E1f,
                      8.3047565967967209469434E1f,
                      2.2176239823732856465394E2f,
                      3.0909872225312059774938E2f,
                      2.1642788614495947685003E2f,
                      6.0118660497603843919306E1f};
  if (!(fabsf(x) < 0.41421356237309504880f)) return log_xla(x + 1.0f);
  const float x2 = x * x;
  float num = 0.0f;
  float den = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    num = fma_xla(num, x, p[i]);
    den = fma_xla(den, x, q[i]);
  }
  float r = num / den;
  r = (x * x2) * r;
  r = -0.5f * x2 + r;
  return x + r;
}

// XLA's float32 erf_inv (Giles' polynomial), one operation at a time
__device__ __forceinline__ float erfinv_xla(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1pf(-x * x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = (lt ? lt5[i] : ge5[i]) + p * w;
  return fabsf(x) == 1.0f ? x * 3.40282347e+38f : p * x;
}

__device__ __forceinline__ float normal_of(uint32_t k0, uint32_t k1, uint32_t i) {
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float u = fmaxf(uniform_of(k0, k1, i) * 2.0f + lo, lo);
  return 1.41421354f * erfinv_xla(u);
}

// 4 floats of a chunk from p (cnt of them valid; the rest read as 0): one
// float4 where p is 16-byte aligned and all 4 are valid, else scalars
__device__ __forceinline__ void load4(const float* p, int cnt, float v[4]) {
  if (cnt >= 4 && ((uintptr_t)p & 15u) == 0) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < cnt ? p[i] : 0.0f;
}

__device__ __forceinline__ void store4(float* p, int cnt, const float v[4]) {
  if (cnt >= 4 && ((uintptr_t)p & 15u) == 0) {
    float4 f;
    f.x = v[0];
    f.y = v[1];
    f.z = v[2];
    f.w = v[3];
    *reinterpret_cast<float4*>(p) = f;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < cnt) p[i] = v[i];
}

__device__ __forceinline__ void store4i(int32_t* p, int cnt, const int32_t v[4]) {
  if (cnt >= 4 && ((uintptr_t)p & 15u) == 0) {
    int4 f;
    f.x = v[0];
    f.y = v[1];
    f.z = v[2];
    f.w = v[3];
    *reinterpret_cast<int4*>(p) = f;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < cnt) p[i] = v[i];
}

__device__ __forceinline__ void load4i(const int32_t* p, int cnt, int32_t v[4]) {
  if (cnt >= 4 && ((uintptr_t)p & 15u) == 0) {
    const int4 f = *reinterpret_cast<const int4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < cnt ? p[i] : 0;
}

// 4 ranks of a chunk as 32-bit slots' numerators: two 16-byte loads where
// aligned
__device__ __forceinline__ void load4_rank(const int64_t* p, int cnt, uint32_t v[4]) {
  if (cnt >= 4 && ((uintptr_t)p & 15u) == 0) {
    const longlong2 a = reinterpret_cast<const longlong2*>(p)[0];
    const longlong2 b = reinterpret_cast<const longlong2*>(p)[1];
    v[0] = (uint32_t)a.x;
    v[1] = (uint32_t)a.y;
    v[2] = (uint32_t)b.x;
    v[3] = (uint32_t)b.y;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < cnt ? (uint32_t)p[i] : 0u;
}

// a thread's 16 mask bytes as 16 bits (bit i: byte i nonzero): one uint4
// where aligned
__device__ __forceinline__ uint32_t load_mask16(const uint8_t* p, int cnt) {
  uint32_t bits = 0;
  if (cnt == kLanes && ((uintptr_t)p & 15u) == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < kLanes; ++i)
      bits |= (((words[i / 4] >> (8 * (i % 4))) & 0xFFu) != 0u ? 1u : 0u) << i;
    return bits;
  }
  for (int i = 0; i < cnt; ++i)
    if (p[i] != 0) bits |= 1u << i;
  return bits;
}

__device__ __forceinline__ void store_mask16(uint8_t* p, int cnt, uint32_t bits) {
  if (cnt == kLanes && ((uintptr_t)p & 15u) == 0) {
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kLanes; ++i) words[i / 4] |= ((bits >> i) & 1u) << (8 * (i % 4));
    uint4 w;
    w.x = words[0];
    w.y = words[1];
    w.z = words[2];
    w.w = words[3];
    *reinterpret_cast<uint4*>(p) = w;
    return;
  }
  for (int i = 0; i < cnt; ++i) p[i] = (uint8_t)((bits >> i) & 1u);
}

// the fault search's first step: the largest power of two <= nf (its steps
// top, top / 2, .., 1 reach 2 top - 1 >= nf breakpoints)
__host__ __device__ __forceinline__ int fault_top(int nf) {
  int top = 1;
  while (2 * top <= nf) top *= 2;
  return top;
}

// bytes of the hop's sums' accumulators (K doubles and an int a thread)
__host__ __device__ __forceinline__ size_t hop_sums_bytes(bool sums, int K) {
  return sums ? (size_t)K * kThreads * sizeof(double) + kThreads * sizeof(int) : 0;
}

// floats of a row's fault tables staged: the nf breakpoints padded to
// 2 fault_top(nf), nf x ne factors and as many boosts
__host__ __device__ __forceinline__ size_t fault_floats(int nf, int ne) {
  return 2 * (size_t)fault_top(nf) + 2 * (size_t)nf * ne;
}

// whether the hop stages its row's fault tables in shared memory, beside
// its sums' accumulators
__host__ __device__ __forceinline__ bool fault_staged(bool sums, int K, int nf, int ne) {
  return hop_sums_bytes(sums, K) + fault_floats(nf, ne) * sizeof(float) <= kHopSmem;
}

// the thread's row, its first lane and how many of its 16 lanes the row
// holds; false past the row's end
__device__ __forceinline__ bool thread_lanes(int64_t n, uint32_t& row, uint32_t& lane0,
                                             int& cnt) {
  row = blockIdx.y;
  lane0 = (blockIdx.x * blockDim.x + threadIdx.x) * (uint32_t)kLanes;
  if ((int64_t)lane0 >= n) return false;
  const int64_t left = n - (int64_t)lane0;
  cnt = left < kLanes ? (int)left : kLanes;
  return true;
}

__global__ void uniform_kernel(EdgeDrawArgs a) {
  uint32_t row, lane0;
  int cnt;
  if (!thread_lanes(a.n, row, lane0, cnt)) return;
  const uint32_t k0 = a.ukey != nullptr ? (uint32_t)a.ukey[2 * row] : 0u;
  const uint32_t k1 = a.ukey != nullptr ? (uint32_t)a.ukey[2 * row + 1] : 0u;
  const size_t base = (size_t)row * (size_t)a.n + lane0;
#pragma unroll 1
  for (int c = 0; c < kLanes; c += 4) {
    float v[4];
    if (a.x_in != nullptr) load4(a.x_in + base + c, cnt - c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float u =
          a.x_in != nullptr ? v[i] : uniform_of(k0, k1, lane0 + (uint32_t)(c + i));
      v[i] = a.gap ? -log1p_xla(-u) : u;
    }
    store4(a.out + base + c, cnt - c, v);
  }
}

// Enter one block total at level 4 of XLA's recursion (of ``levels``);
// returns that entry's inclusive prefix.  Each level L >= 4 keeps its
// open block's running sum acc[L], its entries cnt[L] and its offset
// off[L], the prefix of the block before it (0 for the first, as XLA's
// zero pad adds); a block's 16th entry completes it, and its total enters
// level L + 1, whose prefix is the next block's offset.  The top level
// (one block) adds no offset.
__device__ __forceinline__ float enter_total(float t, int levels, float* acc, float* off,
                                             int* cnt) {
  float first = 0.0f;
  int below = 0;  // the level whose completed block this entry is, or 0
  for (int L = 4; L <= levels; ++L) {
    acc[L] = acc[L] + t;
    const float p = L == levels ? acc[L] : acc[L] + off[L];
    if (below == 0) first = p;
    else off[below] = p;
    if (L == levels || ++cnt[L] < kLanes) break;
    t = acc[L];
    acc[L] = 0.0f;
    cnt[L] = 0;
    below = L;
  }
  return first;
}

// One row a block: the gaps and their inclusive prefix sums in
// XLA's order, written once after a leading zero.  The row is walked in
// tiles of kTileLanes lanes, one level-3 block of XLA's recursion: each
// thread sums its level-1 blocks of 16 lanes in order (the lanes past n
// zero, as XLA pads); kTileBlocks / 16 threads scan the tile's 16-entry
// level-2 blocks of those totals; one thread scans the tile's level-2
// totals (level 3: the tile's own block) and carries levels 4 and up from
// tile to tile (enter_total); each thread then sets its level-1 block's
// offset, the prefix of the block before it (P_2 of block b - 1: its
// level-2 sum plus its level-2 block's offset, the prefix P_3 of the
// level-2 block before that), and each lane adds it to its sum.  Every
// add is one of XLA's, in its order; no level is written to device
// memory.
__global__ void __launch_bounds__(kRowThreads) gap_sum_kernel(EdgeDrawArgs a) {
  __shared__ float4 loc[kTileLanes / 4];  // the tile's level-1 sums
  __shared__ float sums[kTileBlocks];      // level-1 totals, then level-2 sums
  __shared__ float offset[kTileBlocks];    // each level-1 block's offset
  __shared__ float off2[kTileBlocks / kLanes];  // each level-2 block's offset
  __shared__ float off1;                   // the tile's first level-1 block's offset
  const unsigned tid = threadIdx.x;
  const size_t row = blockIdx.y;
  const int64_t n = a.n;
  int levels = 1;  // XLA's: the least L with 16^L >= n
  for (int64_t span = kLanes; span < n; span *= kLanes) ++levels;
  const uint32_t k0 = (uint32_t)a.ukey[2 * row];
  const uint32_t k1 = (uint32_t)a.ukey[2 * row + 1];
  float* out = a.out + row * (size_t)a.ld_out;
  if (tid == 0) out[0] = 0.0f;
  // thread 0's carry from tile to tile: levels 4 and up, the offset of the
  // tile's level-3 block (P_4 of the tile before), the prefix P_3 of the
  // last level-2 block and P_2 of the last level-1 block
  float acc[kMaxLevels + 1], off[kMaxLevels + 1];
  int cnt[kMaxLevels + 1];
  if (tid == 0) {
    for (int L = 0; L <= kMaxLevels; ++L) {
      acc[L] = 0.0f;
      off[L] = 0.0f;
      cnt[L] = 0;
    }
  }
  float off3 = 0.0f;
  float last_p3 = 0.0f;
  float last_p2 = 0.0f;
  for (int64_t tile0 = 0; tile0 < n; tile0 += kTileLanes) {
    // level 1: each block of 16 lanes summed in order, its sums to the tile
    for (int b = (int)tid; b < kTileBlocks; b += kRowThreads) {
      const int64_t lane0 = tile0 + (int64_t)b * kLanes;
      const int64_t left = n - lane0;
      const int cnt1 = left <= 0 ? 0 : left < kLanes ? (int)left : kLanes;
      float acc1 = 0.0f;
#pragma unroll 1
      for (int c = 0; c < kLanes && c < cnt1; c += 4) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float gap = c + i < cnt1
                                ? -log1p_xla(-uniform_of(k0, k1, (uint32_t)(lane0 + c + i)))
                                : 0.0f;
          acc1 = acc1 + gap;
          v[i] = acc1;
        }
        float4 f;
        f.x = v[0];
        f.y = v[1];
        f.z = v[2];
        f.w = v[3];
        loc[b * (kLanes / 4) + c / 4] = f;
      }
      sums[b] = acc1;
    }
    __syncthreads();
    // level 2: each block of 16 level-1 totals summed in order, in place
    for (int j = (int)tid; j < kTileBlocks / kLanes; j += kRowThreads) {
      float acc2 = 0.0f;
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        acc2 = acc2 + sums[j * kLanes + i];
        sums[j * kLanes + i] = acc2;
      }
    }
    __syncthreads();
    // level 3, the tile's block, in order: each level-2 block's offset; the
    // tile's total then enters level 4
    if (tid == 0) {
      if (levels >= 3) {
        float acc3 = 0.0f;
        for (int j = 0; j < kTileBlocks / kLanes; ++j) {
          off2[j] = last_p3;
          acc3 = acc3 + sums[j * kLanes + kLanes - 1];
          last_p3 = levels == 3 ? acc3 : acc3 + off3;
        }
        if (levels >= 4) off3 = enter_total(acc3, levels, acc, off, cnt);
      }
      off1 = last_p2;
      const float p2 = sums[kTileBlocks - 1];
      last_p2 = levels >= 3 ? p2 + off2[kTileBlocks / kLanes - 1] : p2;
    }
    __syncthreads();
    // each level-1 block's offset: P_2 of the block before it
    for (int b = (int)tid; b < kTileBlocks; b += kRowThreads) {
      float x = off1;
      if (b > 0) x = levels >= 3 ? sums[b - 1] + off2[(b - 1) / kLanes] : sums[b - 1];
      offset[b] = x;
    }
    __syncthreads();
    // each lane: its level-1 sum plus its block's offset (levels 2 and up)
    const float* tile = reinterpret_cast<const float*>(loc);
    for (int i = (int)tid; i < kTileLanes && tile0 + i < n; i += kRowThreads) {
      const float v = tile[i];
      out[1 + tile0 + i] = levels == 1 ? v : v + offset[i / kLanes];
    }
    __syncthreads();  // the tile's shared memory is rewritten next tile
  }
}

// kFault: the hop reads fault tables (a separate instance, so that a hop
// without them runs the code it ran before they existed); kSums: the hop
// sums its spans and drops (the epilogue), else it writes t_next and ok
// only; kStaged: it reads the tables from its row's copy in shared memory
// (fault_staged), else where they lie, in global memory
template <bool kFault, bool kSums, bool kStaged>
__global__ void hop_kernel(EdgeDrawArgs a) {
  const int K = a.K;
  const unsigned nt = blockDim.x, tid = threadIdx.x;
  double* acc = edge_smem;                                       // (K, threads)
  int* drops = reinterpret_cast<int*>(edge_smem + (size_t)K * nt);  // (threads,)
  if (kSums)
    for (int k = 0; k < K; ++k) acc[k * nt + tid] = 0.0;
  // the block's row of the fault tables (or the shared tables); staged,
  // copied to shared memory once: the breakpoints padded with NaN (which no
  // time passes) to 2 top entries, then the factors, then the boosts
  const int top = kFault ? fault_top(a.NF) : 0;
  const size_t frow = kFault && a.fault_per_row ? (size_t)blockIdx.y : 0;
  const size_t cells = (size_t)a.NF * a.NE;
  const float* gt = kFault ? a.fault_t + frow * a.NF : nullptr;
  const float* glat = kFault ? a.fault_lat + frow * cells : nullptr;
  const float* gdrop = kFault ? a.fault_drop + frow * cells : nullptr;
  float* st = !kStaged ? nullptr
              : kSums  ? reinterpret_cast<float*>(drops + nt)
                       : reinterpret_cast<float*>(edge_smem);
  const float* ft = kStaged ? st : gt;
  const float* flat = kStaged ? st + 2 * top : glat;
  const float* fdrop = kStaged ? st + 2 * top + cells : gdrop;
  if constexpr (kStaged) {
    const float nan = __uint_as_float(0x7FC00000u);
#ifdef __CUDACC__
    const size_t first = tid, step = nt;
#else
    // the host build runs the threads one after another: the first stages
    const size_t first = 0, step = 1;
    if (tid == 0)
#endif
    {
      for (size_t j = first; j < (size_t)(2 * top); j += step)
        st[j] = j < (size_t)a.NF ? gt[j] : nan;
      for (size_t j = first; j < cells; j += step) {
        st[2 * top + j] = glat[j];
        st[2 * top + cells + j] = gdrop[j];
      }
    }
#ifdef __CUDACC__
    __syncthreads();
#endif
  }
  int my_drops = 0;
  uint32_t row, lane0;
  int cnt;
  if (thread_lanes(a.n, row, lane0, cnt)) {
    const size_t base = (size_t)row * (size_t)a.n + lane0;
    const uint32_t k0 = (uint32_t)a.ukey[2 * row], k1 = (uint32_t)a.ukey[2 * row + 1];
    const uint32_t z0 = a.zkey != nullptr ? (uint32_t)a.zkey[2 * row] : 0u;
    const uint32_t z1 = a.zkey != nullptr ? (uint32_t)a.zkey[2 * row + 1] : 0u;
    const float h = a.horizon;
    const float* mean = a.mean + (size_t)row * a.NE;
    const float* var = a.var + (size_t)row * a.NE;
    const float* drop = a.drop + (size_t)row * a.NE;
    const uint32_t alive = load_mask16(a.alive + base, cnt);
    const bool lb = a.rank != nullptr || a.slot != nullptr;
    uint32_t okbits = 0;
#pragma unroll 1
    for (int c = 0; c < kLanes; c += 4) {
      float t[4];
      int32_t tgt[4] = {0, 0, 0, 0};
      uint32_t rk[4] = {0u, 0u, 0u, 0u};
      int32_t sl[4] = {0, 0, 0, 0};
      load4(a.t_send + base + c, cnt - c, t);
      if (a.rank != nullptr) load4_rank(a.rank + base + c, cnt - c, rk);
      if (a.slot != nullptr) load4i(a.slot + base + c, cnt - c, sl);
      // the four lanes' fault rows at their send times: the last breakpoint
      // <= ts, -1 as 0, from fi, the count of breakpoints <= ts
      // (searchsorted right), by a binary search of fixed steps top, top /
      // 2, .., 1 (floor(log2(NF)) + 1 compares and adds; on the padded row
      // where staged, else bounded by NF), the four searches interleaved
      int fi[4] = {0, 0, 0, 0};
      if (kFault) {
        for (int step = top; step > 0; step >>= 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = fi[i] + step - 1;
            if constexpr (kStaged)
              fi[i] += ft[j] <= t[i] ? step : 0;
            else
              fi[i] += j < a.NF && ft[j] <= t[i] ? step : 0;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) fi[i] = fi[i] > 0 ? fi[i] - 1 : 0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lane = c + i;
        if (lane >= cnt) continue;
        const float ts = t[i];
        bool gate = ((alive >> lane) & 1u) && ts < h;
        int slot = 0;
        int e = a.edge;
        if (lb) {
          if (a.slot != nullptr && gate && sl[i] < 0) {
            // no healthy target: dropped at the LB
            my_drops += 1;
            gate = false;
          }
          if (gate) slot = a.slot != nullptr ? sl[i] : (int)(rk[i] % (uint32_t)K);
          e = a.lb_edge[slot];
          tgt[i] = a.lb_target[slot];
        }
        const float u = uniform_of(k0, k1, lane0 + (uint32_t)lane);
        float p = drop[e];
        float factor = 1.0f;
        if (kFault) {
          factor = flat[fi[i] * a.NE + e];
          p = fminf(fmaxf(p + fdrop[fi[i] * a.NE + e], 0.0f), 1.0f);
        }
        const float m = mean[e];
        const int law = a.dist[e];
        const float u_lat = (u - p) / fmaxf(1.0f - p, kTiny);
        float d;
        if (law == kUniform) {
          d = u_lat;
        } else if (law == kExponential) {
          d = -m * logf(fmaxf(1.0f - u_lat, kTiny));
        } else {
          const float z = normal_of(z0, z1, lane0 + (uint32_t)lane);
          const float x = m + var[e] * z;
          d = law == kNormal ? fmaxf(x, 0.0f) : expf(x);
        }
        if (kFault) d = d * factor;
        if (a.spike_t != nullptr) {
          // searchsorted(spike_t, ts, right) - 1, -1 wrapping to the last row
          int idx = -1;
          for (int j = 0; j < a.NB; ++j) idx += a.spike_t[j] <= ts ? 1 : 0;
          if (idx < 0) idx = a.NB - 1;
          d = d + a.spike_v[(size_t)idx * a.NE + e];
        }
        const bool dropped = u < p;
        const bool ok = gate && !dropped;
        const float t_end = ts + d;
        if (ok) {
          okbits |= 1u << lane;
          if (kSums) acc[slot * nt + tid] += (double)fmaxf(fminf(t_end, h) - fminf(ts, h), 0.0f);
        }
        my_drops += (gate && dropped) ? 1 : 0;
        t[i] = ok ? t_end : ts;
      }
      store4(a.out + base + c, cnt - c, t);
      if (lb) store4i(a.target + base + c, cnt - c, tgt);
    }
    store_mask16(a.ok + base, cnt, okbits);
  }
  if (!kSums) return;
  drops[tid] = my_drops;
  // the block's sums: each column by one thread, over the block's threads
  // in order (the host build runs threads one after another: the last sums)
#ifdef __CUDACC__
  __syncthreads();
  if ((int)tid > K) return;
  const int k_first = (int)tid, k_last = (int)tid;
#else
  if (tid != nt - 1) return;
  const int k_first = 0, k_last = K;
#endif
  double* part = a.partial + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (size_t)(K + 1);
  for (int k = k_first; k <= k_last; ++k) {
    double sum = 0.0;
    if (k < K) {
      for (unsigned j = 0; j < nt; ++j) sum += acc[k * nt + j];
    } else {
      int64_t count = 0;
      for (unsigned j = 0; j < nt; ++j) count += drops[j];
      sum = (double)count;
    }
    part[k] = sum;
  }
}

// the hop's per-scenario sums: each row's lane blocks in order
__global__ void hop_reduce_kernel(EdgeDrawArgs a) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.S) return;
  const int K = a.K;
  const int64_t nblk = (a.n + kLaneBlock - 1) / kLaneBlock;
  const double* part = a.partial + (size_t)row * nblk * (K + 1);
  for (int k = 0; k <= K; ++k) {
    double s = 0.0;
    for (int64_t b = 0; b < nblk; ++b) s += part[b * (K + 1) + k];
    if (k < K)
      a.span[row * K + k] = (float)s;
    else
      a.dropped[row] = (int64_t)s;
  }
}

}  // namespace

extern "C" {

int edge_draws_args_size() { return (int)sizeof(EdgeDrawArgs); }

int edge_draws_lane_block() { return kLaneBlock; }

// Launch on ``stream``; returns the first launch's cudaError_t that is not
// 0, or -1 for arguments the kernel does not take.
int edge_draws_launch(const EdgeDrawArgs* args, void* stream) {
  EdgeDrawArgs a = *args;
  if (a.S <= 0 || a.n <= 0 || a.n > 0xFFFF0000ll) return -1;
  size_t smem = 0;
  if (a.mode == kUniformMode) {
    if (a.out == nullptr || (a.ukey == nullptr) == (a.x_in == nullptr)) return -1;
  } else if (a.mode == kHopMode) {
    if (a.out == nullptr || a.ok == nullptr || a.t_send == nullptr || a.alive == nullptr ||
        a.ukey == nullptr || a.mean == nullptr || a.var == nullptr || a.drop == nullptr ||
        a.dist == nullptr)
      return -1;
    // the sums' outputs, all or none (none: no epilogue)
    if ((a.span == nullptr) != (a.partial == nullptr) ||
        (a.span == nullptr) != (a.dropped == nullptr))
      return -1;
    if (a.rank != nullptr && a.slot != nullptr) return -1;
    if (a.rank != nullptr || a.slot != nullptr) {
      if (a.edge >= 0 || a.K < 1 || a.K > kMaxSlots || a.lb_edge == nullptr ||
          a.lb_target == nullptr || a.target == nullptr)
        return -1;
    } else if (a.edge < 0 || a.edge >= a.NE || a.K != 1) {
      return -1;
    }
    if (a.spike_t != nullptr && (a.spike_v == nullptr || a.NB < 1)) return -1;
    if (a.fault_t != nullptr && (a.fault_lat == nullptr || a.fault_drop == nullptr || a.NF < 1))
      return -1;
    smem = hop_sums_bytes(a.span != nullptr, a.K);
    if (a.fault_t != nullptr && fault_staged(a.span != nullptr, a.K, a.NF, a.NE))
      smem += fault_floats(a.NF, a.NE) * sizeof(float);  // the staged tables
  } else if (a.mode == kGapsMode) {
    if (a.out == nullptr || a.ukey == nullptr || a.ld_out < a.n + 1) return -1;
  } else {
    return -1;
  }
  const int64_t blocks = (a.n + kLaneBlock - 1) / kLaneBlock;
  if (blocks > 0x7FFFFFFFll) return -1;
  const int64_t total_rows = a.S;
  const EdgeDrawArgs whole = a;
  for (int64_t r0 = 0; r0 < total_rows; r0 += kMaxRows) {
    const int64_t rows = total_rows - r0 < kMaxRows ? total_rows - r0 : kMaxRows;
    // the chunk's rows as rows 0.. of its own arguments
    a = whole;
    a.S = rows;
    a.ukey = whole.ukey != nullptr ? whole.ukey + 2 * r0 : nullptr;
    a.zkey = whole.zkey != nullptr ? whole.zkey + 2 * r0 : nullptr;
    if (whole.x_in != nullptr) a.x_in = whole.x_in + r0 * whole.n;
    if (whole.mode == kGapsMode) {
      a.out = whole.out + r0 * whole.ld_out;
    } else {
      a.out = whole.out + r0 * whole.n;
    }
    if (whole.mode == kHopMode) {
      a.t_send = whole.t_send + r0 * whole.n;
      a.alive = whole.alive + r0 * whole.n;
      a.ok = whole.ok + r0 * whole.n;
      if (whole.rank != nullptr) a.rank = whole.rank + r0 * whole.n;
      if (whole.slot != nullptr) a.slot = whole.slot + r0 * whole.n;
      if (whole.target != nullptr) a.target = whole.target + r0 * whole.n;
      a.mean = whole.mean + r0 * whole.NE;
      a.var = whole.var + r0 * whole.NE;
      a.drop = whole.drop + r0 * whole.NE;
      if (whole.partial != nullptr) a.partial = whole.partial + r0 * blocks * (whole.K + 1);
      if (whole.fault_t != nullptr && whole.fault_per_row) {
        a.fault_t = whole.fault_t + r0 * whole.NF;
        a.fault_lat = whole.fault_lat + r0 * whole.NF * whole.NE;
        a.fault_drop = whole.fault_drop + r0 * whole.NF * whole.NE;
      }
      if (whole.span != nullptr) {
        a.span = whole.span + r0 * whole.K;
        a.dropped = whole.dropped + r0;
      }
    }
    const dim3 grid((unsigned)blocks, (unsigned)rows);
    const dim3 block(kThreads);
    if (a.mode == kUniformMode) {
      uniform_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
    } else if (a.mode == kGapsMode) {
      // a block a row
      const dim3 gap_grid(1u, (unsigned)rows);
      const dim3 gap_block(kRowThreads);
      gap_sum_kernel<<<gap_grid, gap_block, 0, (cudaStream_t)stream>>>(a);
    } else {
      const bool sums = a.span != nullptr;
      const bool staged = a.fault_t != nullptr && fault_staged(sums, a.K, a.NF, a.NE);
      const auto hop =
          a.fault_t == nullptr
              ? (sums ? hop_kernel<false, true, false> : hop_kernel<false, false, false>)
          : staged ? (sums ? hop_kernel<true, true, true> : hop_kernel<true, false, true>)
                   : (sums ? hop_kernel<true, true, false> : hop_kernel<true, false, false>);
      hop<<<grid, block, smem, (cudaStream_t)stream>>>(a);
      if (sums) {
        const dim3 rgrid((unsigned)((rows + kThreads - 1) / kThreads));
        hop_reduce_kernel<<<rgrid, block, 0, (cudaStream_t)stream>>>(a);
      }
    }
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
