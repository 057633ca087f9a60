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
// multiply-adds XLA fuses (in its log1p, a normal law's mean + var * z,
// and a delay's last multiply with the spike or the send time it is added
// to) are fmaf / __fmaf_rn here, and float64 steps rounded once in the
// plain version (draws.fma_xla: equal on every input).
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
//      tables staged in the block's shared memory where they fit) boosts
//      the drop probability, p = clip(drop + boost, 0, 1), and multiplies
//      the law's delay by its factor before the spike is added (the
//      factor's product rounded with the add after it, as the jitted
//      _edge_hop rounds them: lane_delay); per scenario the drop count (gate &
//      dropped, and the LB's drops) and each edge slot's gauge span, the
//      sum over ok lanes of max(min(t_send + delay, h) - min(t_send, h), 0),
//      in float64 in a fixed order (a thread's 16 consecutive lanes, the
//      block's threads, the row's blocks) and rounded once;
//   2 gaps: out (S, ld_out) = 0, then the inclusive prefix sums of the
//      drawn gaps in XLA's order, n of them;
//   3 candidates (least connections): each lane's hop over every one of
//      the K slots' edges (lb_edge), slot k with its own keys (ukey, zkey
//      (S, K, 2)), out t_next and ok (S, n, K); no sums (they belong to the
//      lanes that pick a slot).  The fault and spike rows depend on the
//      send time only: searched once a lane for every slot.
//
// Grid (lane blocks, scenarios), 128 threads a block, 16 lanes a thread,
// 32-bit lane indices and no division.  A block's 2048 lanes are drawn in
// one of two ways.  Where the lane arrays start on 16-byte boundaries (4-byte
// for the masks), thread j takes lanes 16 j .. 16 j + 15, moving each chunk
// of four as one vector: the uniform mode row by row, and the hop over one
// slot where every row of the launch does (n a multiple of 4), its span
// summed in a register as it draws.  Else (rows of widths not a multiple of
// 16 lanes start off a boundary, where 16 consecutive lanes a thread moved
// them as scalars, each warp's access spread over 2 KiB; and the hop over
// several slots, whose sums as they are drawn would be a shared
// read-modify-write a lane) thread j takes lanes j, j + 128, .., j + 1920:
// a warp's loads and stores are 32 consecutive lanes, coalesced at any
// start, and the hop's sums keep their order through shared memory: each
// lane writes its span (and its slot) there, and thread j then sums lanes
// 16 j .. 16 j + 15 in order (16-byte chunks swizzled within each 128-byte
// row, so both sides fall on distinct banks).  The block stages its slot
// table (each slot's drop, mean, var, edge and law, target, and
// the candidates' keys), the spike breakpoints with each slot's spike
// column, and the fault tables in shared memory
// where they fit; the spike and fault rows are found by binary searches of
// fixed steps, a thread's four lanes at a time.  The gaps' prefix sum
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
// lane (22 on the LB hop by rank, 18 by slot; a candidate lane 5 + 5 a
// slot, against a block a slot): at the card's int32 rate a block is ~3x
// the static hop's bytes' time at 3.35 TB/s.  A gap lane adds XLA's log1p
// (about 37 float operations) and its prefix sum's adds, and writes 4
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

struct EdgeDrawArgs {
  const int32_t* ukey;       // (S, 2) key words of the uniform stream (candidates: (S, K, 2))
  const int32_t* zkey;       // (S, 2) key words of the normal stream (or (S, K, 2)), or null
  const float* x_in;         // uniform: (S, n) uniforms to take the gaps of, or null
  const float* t_send;       // hop: (S, n) send times
  const uint8_t* alive;      // hop: (S, n)
  const int64_t* rank;       // hop: (S, n) arrival rank (LB slot rank % K), or null
  const int32_t* slot;       // hop: (S, n) LB slot, -1 for none healthy, or null
  const int32_t* lb_edge;    // (K,) edge of each LB slot (or candidate)
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
  float* out;  // uniform: (S, n); hop: t_next (S, n), candidates (S, n, K); gaps: (S, ld_out)
  uint8_t* ok;               // hop: (S, n); candidates: (S, n, K)
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
  int32_t K;     // hop: edge slots (1 for a static edge); candidates: slots
  int32_t edge;  // hop: the static edge, or -1 with rank
  int32_t mode;
  int32_t gap;   // uniform: write the gap -log1p(-u)
  int32_t NF;    // hop: fault breakpoints (0 without edge faults)
  int32_t fault_per_row;  // hop: the fault tables have a row a scenario
};

// the hop's dynamic shared memory (hop_smem), 16-byte aligned
extern __shared__ uint4 edge_smem[];

namespace {

constexpr int kUniformMode = 0;
constexpr int kHopMode = 1;
constexpr int kGapsMode = 2;
constexpr int kCandidatesMode = 3;
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
// the hop's lane forms (hop_kernel's kForm)
constexpr int kStrided = 0;
constexpr int kConsecutive = 1;
constexpr int kCandidates = 2;
// the hop's dynamic shared memory (hop_smem): its slot table and sums'
// buffers, then its spike and fault tables where they fit (else its lanes
// read them in global memory)
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
// version computes it in float64 (the product exact, the sum rounded to
// odd) and rounds that to float32: equal to fmaf on every input.
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

// XLA's float32 erf_inv (Giles' polynomial) as the jitted reference runs
// it: its log1p XLA's, its Horner steps fused
__device__ __forceinline__ float erfinv_xla(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1p_xla(-x * x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fma_xla(p, w, lt ? lt5[i] : ge5[i]);
  return fabsf(x) == 1.0f ? x * 3.40282347e+38f : p * x;
}

// the normal draw over sqrt(2): XLA's simplifier reassociates a law's
// var * (sqrt(2) * erfinv) to (var * sqrt(2)) * erfinv
__device__ __forceinline__ float normal_erfinv(uint32_t k0, uint32_t k1, uint32_t i) {
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float u = fmaxf(uniform_of(k0, k1, i) * 2.0f + lo, lo);
  return erfinv_xla(u);
}

// XLA's CPU float32 exp (Cephes' expf) with the multiply-adds its compiler
// fuses: the clamp, n = floor(x log2(e) + 1/2) in [-127, 127], x - n ln 2
// in two steps, the polynomial, 1 + (r + p r^2), times 2^n
__device__ float exp_xla(float v) {
  float x = fminf(fmaxf(v, -87.8000030517578125f), 88.8000030517578125f);
  if (v != v) x = v;
  const float fx = fminf(fmaxf(floorf(fma_xla(x, 1.44269502f, 0.5f)), -127.0f), 127.0f);
  x = fma_xla(-fx, 0.693359375f, x);
  x = fma_xla(-fx, -2.12194440e-4f, x);
  float y = 1.9875691500e-4f;
  y = fma_xla(y, x, 1.3981999507e-3f);
  y = fma_xla(y, x, 8.3334519073e-3f);
  y = fma_xla(y, x, 4.1665795894e-2f);
  y = fma_xla(y, x, 1.6666665459e-1f);
  y = fma_xla(y, x, 5.0000001201e-1f);
  y = fma_xla(y, x * x, x) + 1.0f;
  return y * __uint_as_float((uint32_t)((int32_t)fx + 127) << 23);
}

// the fault search's first step: the largest power of two <= nf (its steps
// top, top / 2, .., 1 reach 2 top - 1 >= nf breakpoints)
__host__ __device__ __forceinline__ int fault_top(int nf) {
  int top = 1;
  while (2 * top <= nf) top *= 2;
  return top;
}

// floats of a row's fault tables staged: the nf breakpoints padded to
// 2 fault_top(nf), nf x ne factors and as many boosts
__host__ __device__ __forceinline__ size_t fault_floats(int nf, int ne) {
  return 2 * (size_t)fault_top(nf) + 2 * (size_t)nf * ne;
}

// The hop's dynamic shared memory, byte offsets from its start: the sums'
// per-thread accumulators (K x threads doubles) and the block's lane spans
// (kLaneBlock floats), the slot table (each slot's drop, mean and var bits
// and its edge x 8 + law; the candidates' keys, or the sums' targets), the
// sums' drop counts (threads ints) and lane slots (kLaneBlock bytes), then
// the spike breakpoints with each slot's spike column (nb x (1 + K)
// floats) and the row's fault tables (fault_floats), each where it fits.
struct HopSmem {
  size_t acc, span, par, key, tgt, drops, slots, spike, fault, total;
  bool spike_staged, fault_staged;
};

__host__ __device__ __forceinline__ HopSmem hop_smem(bool sums, int K, int nb, int nf, int ne) {
  HopSmem m;
  size_t at = 0;
  m.acc = at;
  if (sums) at += (size_t)K * kThreads * sizeof(double);
  m.span = at;
  if (sums) at += kLaneBlock * sizeof(float);
  m.par = at;
  at += (size_t)K * sizeof(uint4);
  m.key = at;
  if (!sums) at += (size_t)K * sizeof(uint4);
  m.tgt = at;
  if (sums) at += ((size_t)K * sizeof(int32_t) + 15) & ~(size_t)15;
  m.drops = at;
  if (sums) at += kThreads * sizeof(int);
  m.slots = at;
  if (sums) at += kLaneBlock;
  m.spike = at;
  const size_t spike = (size_t)nb * (1 + (size_t)K) * sizeof(float);
  m.spike_staged = nb > 0 && at + spike <= kHopSmem;
  if (m.spike_staged) at += spike;
  m.fault = at;
  const size_t fault = nf > 0 ? fault_floats(nf, ne) * sizeof(float) : 0;
  m.fault_staged = nf > 0 && at + fault <= kHopSmem;
  if (m.fault_staged) at += fault;
  m.total = at;
  return m;
}

// whether p lies on a boundary of `bytes` (a power of two)
__host__ __device__ __forceinline__ bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// a lane's word in the block's span buffer: 16-byte chunks swizzled within
// each 128-byte row (chunk c at c ^ ((c >> 3) & 7)), so that a warp's 32
// consecutive lanes and a quarter warp's 16-byte reads of 16 consecutive
// lanes a thread each fall on distinct banks
__device__ __forceinline__ uint32_t span_word(uint32_t w) {
  const uint32_t c = w >> 2;
  return ((c ^ ((c >> 3) & 7u)) << 2) | (w & 3u);
}

// A row whose out (and x_in) starts on a 16-byte boundary: each thread
// draws 16 consecutive lanes, a chunk of four moved as one float4; else
// lanes 128 apart, a warp's accesses 32 consecutive lanes
__global__ void uniform_kernel(EdgeDrawArgs a) {
  const uint32_t row = blockIdx.y;
  const uint32_t blk0 = blockIdx.x * (uint32_t)kLaneBlock;
  const unsigned tid = threadIdx.x;
  const size_t base = (size_t)row * (size_t)a.n;
  const uint32_t k0 = a.ukey != nullptr ? (uint32_t)a.ukey[2 * row] : 0u;
  const uint32_t k1 = a.ukey != nullptr ? (uint32_t)a.ukey[2 * row + 1] : 0u;
  const bool consec =
      aligned(a.out + base, 16) && (a.x_in == nullptr || aligned(a.x_in + base, 16));
#pragma unroll 1
  for (int g = 0; g < kLanes; g += 4) {
    uint32_t lane[4];
    bool in[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lane[i] = consec ? blk0 + tid * (uint32_t)kLanes + (uint32_t)(g + i)
                       : blk0 + tid + (uint32_t)(kThreads * (g + i));
      in[i] = (int64_t)lane[i] < a.n;
    }
    const bool vec = consec && in[3];
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a.x_in != nullptr) {
      if (vec) {
        const float4 f = *reinterpret_cast<const float4*>(a.x_in + base + lane[0]);
        v[0] = f.x;
        v[1] = f.y;
        v[2] = f.z;
        v[3] = f.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (in[i]) v[i] = a.x_in[base + lane[i]];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!vec && !in[i]) continue;
      const float u = a.x_in != nullptr ? v[i] : uniform_of(k0, k1, lane[i]);
      v[i] = a.gap ? -log1p_xla(-u) : u;
    }
    if (vec) {
      float4 f;
      f.x = v[0];
      f.y = v[1];
      f.z = v[2];
      f.w = v[3];
      *reinterpret_cast<float4*>(a.out + base + lane[0]) = f;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (in[i]) a.out[base + lane[i]] = v[i];
    }
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

// One lane's delay over the edge of a slot's parameters p (the bits of its
// drop, mean and var, and its edge x 8 + law) and whether its uniform drops
// it, under the fault row's factor and boost (kFault), as a product d x f
// whose last multiply is not yet rounded (f = 1 where the delay's last
// step is no multiply): XLA's CPU compiler contracts the exponential's
// -m * log(..), or a fault's factor, into the add that consumes it (the
// spike, or the send time), so the jitted reference rounds the two once
// and the caller adds with __fmaf_rn.  With ``select`` (several laws among
// the LB's slots) the law's delay is rounded first, as the reference's
// lane-by-lane select rounds it; a normal law's m + var * z is fused.
// Each operation in the order of the plain version.
template <bool kFault>
__device__ __forceinline__ float lane_delay(uint32_t k0, uint32_t k1, uint32_t z0, uint32_t z1,
                                            uint32_t lane, const uint4 p, float factor,
                                            float boost, bool select, float& f,
                                            bool& dropped) {
  const float u = uniform_of(k0, k1, lane);
  float pd = __uint_as_float(p.x);
  if (kFault) pd = fminf(fmaxf(pd + boost, 0.0f), 1.0f);
  const float m = __uint_as_float(p.y);
  const uint32_t law = p.w & 7u;
  const float u_lat = (u - pd) / fmaxf(1.0f - pd, kTiny);
  float d;
  f = 1.0f;
  if (law == kUniform) {
    d = u_lat;
  } else if (law == kExponential) {
    d = -m;
    f = log_xla(fmaxf(1.0f - u_lat, kTiny));
    if (select) {
      d = d * f;
      f = 1.0f;
    }
  } else {
    const float e = normal_erfinv(z0, z1, lane);
    const float x = __fmaf_rn(__uint_as_float(p.z) * 1.41421354f, e, m);
    d = law == kNormal ? fmaxf(x, 0.0f) : exp_xla(x);
  }
  if (kFault) {
    d = d * f;
    f = factor;
  }
  dropped = u < pd;
  return d;
}

// kFault: the hop reads fault tables (a separate instance, so that a hop
// without them runs the code it ran before they existed); kStaged: it reads
// them from its row's copy in shared memory (hop_smem), else where they
// lie, in global memory; kForm: the hop over one slot a lane with its sums
// (mode 1), its lanes 128 apart a thread (kStrided) or, where the launch's
// rows all start on 16-byte boundaries and it has one slot, 16 consecutive
// (kConsecutive), or least connections' candidates (mode 3, kCandidates: every
// slot's hop of each lane, no sums, lanes 128 apart)
template <bool kFault, bool kStaged, int kForm>
__global__ void __launch_bounds__(kThreads) hop_kernel(EdgeDrawArgs a) {
  constexpr bool kCands = kForm == kCandidates;
  constexpr bool kConsec = kForm == kConsecutive;
  const int K = a.K;
  const unsigned nt = blockDim.x, tid = threadIdx.x;
  const uint32_t row = blockIdx.y;
  const uint32_t blk0 = blockIdx.x * (uint32_t)kLaneBlock;
  const int64_t n = a.n;
  const int nb = a.spike_t != nullptr ? a.NB : 0;
  const int ne = a.NE;
  const HopSmem m = hop_smem(!kCands, K, nb, kFault ? a.NF : 0, ne);
  char* smem = reinterpret_cast<char*>(edge_smem);
  double* acc = reinterpret_cast<double*>(smem + m.acc);    // (K, threads)
  float* spans = reinterpret_cast<float*>(smem + m.span);   // (kLaneBlock,), swizzled
  uint4* par = reinterpret_cast<uint4*>(smem + m.par);      // (K,)
  uint4* key = reinterpret_cast<uint4*>(smem + m.key);      // (K,): u, then z key words
  int32_t* tgt = reinterpret_cast<int32_t*>(smem + m.tgt);  // (K,)
  int* drops = reinterpret_cast<int*>(smem + m.drops);      // (threads,)
  uint8_t* slots = reinterpret_cast<uint8_t*>(smem + m.slots);  // (kLaneBlock,)
  float* sp = reinterpret_cast<float*>(smem + m.spike);     // (nb,), then (K, nb)
  const bool lb = a.rank != nullptr || a.slot != nullptr;
  const float* mean = a.mean + (size_t)row * ne;
  const float* var = a.var + (size_t)row * ne;
  const float* drop = a.drop + (size_t)row * ne;
  // the block's row of the fault tables (or the shared tables); staged,
  // copied to shared memory once: the breakpoints padded with NaN (which no
  // time passes) to 2 top entries, then the factors, then the boosts
  const int top = kFault ? fault_top(a.NF) : 0;
  const size_t frow = kFault && a.fault_per_row ? (size_t)row : 0;
  const size_t cells = (size_t)a.NF * ne;
  const float* gt = kFault ? a.fault_t + frow * a.NF : nullptr;
  const float* glat = kFault ? a.fault_lat + frow * cells : nullptr;
  const float* gdrop = kFault ? a.fault_drop + frow * cells : nullptr;
  float* st = kStaged ? reinterpret_cast<float*>(smem + m.fault) : nullptr;
  const float* ft = kStaged ? st : gt;
  const float* flat = kStaged ? st + 2 * top : glat;
  const float* fdrop = kStaged ? st + 2 * top + cells : gdrop;
  const float* spike_t = m.spike_staged ? sp : a.spike_t;
  {
#ifdef __CUDACC__
    const size_t first = tid, step = nt;
#else
    // the host build runs the threads one after another: the first stages
    const size_t first = 0, step = 1;
    if (tid == 0)
#endif
    {
      for (size_t k = first; k < (size_t)K; k += step) {
        const int e = kCands || lb ? a.lb_edge[k] : a.edge;
        uint4 p;
        p.x = __float_as_uint(drop[e]);
        p.y = __float_as_uint(mean[e]);
        p.z = __float_as_uint(var[e]);
        p.w = (uint32_t)e * 8u + (uint32_t)a.dist[e];
        par[k] = p;
        if (!kCands) tgt[k] = lb ? a.lb_target[k] : 0;
        if (kCands) {
          const size_t w = ((size_t)row * K + k) * 2;
          uint4 kk;
          kk.x = (uint32_t)a.ukey[w];
          kk.y = (uint32_t)a.ukey[w + 1];
          kk.z = a.zkey != nullptr ? (uint32_t)a.zkey[w] : 0u;
          kk.w = a.zkey != nullptr ? (uint32_t)a.zkey[w + 1] : 0u;
          key[k] = kk;
        }
      }
      if (m.spike_staged) {
        for (size_t j = first; j < (size_t)nb; j += step) sp[j] = a.spike_t[j];
        for (size_t j = first; j < (size_t)nb * K; j += step) {
          const size_t k = j / nb;
          const int e = kCands || lb ? a.lb_edge[k] : a.edge;
          sp[nb + j] = a.spike_v[(j - k * nb) * ne + e];
        }
      }
      if (kStaged) {
        const float nan = __uint_as_float(0x7FC00000u);
        for (size_t j = first; j < (size_t)(2 * top); j += step)
          st[j] = j < (size_t)a.NF ? gt[j] : nan;
        for (size_t j = first; j < cells; j += step) {
          st[2 * top + j] = glat[j];
          st[2 * top + cells + j] = gdrop[j];
        }
      }
    }
#ifdef __CUDACC__
    __syncthreads();
#endif
  }
  // several laws among the LB's slots: each lane's law's delay is rounded
  // (the reference selects it lane by lane)
  bool select = false;
  if (!kCands && lb)
    for (int k = 1; k < K; ++k) select = select || (par[k].w & 7u) != (par[0].w & 7u);
  // the spike a lane adds: row si of slot k's column (edge e)
  auto spike_of = [&](int si, int k, uint32_t e) {
    return m.spike_staged ? sp[nb + k * nb + si] : a.spike_v[(size_t)si * ne + e];
  };
  const size_t base = (size_t)row * (size_t)n;
  const float h = a.horizon;
  const uint32_t k0 = kCands ? 0u : (uint32_t)a.ukey[2 * row];
  const uint32_t k1 = kCands ? 0u : (uint32_t)a.ukey[2 * row + 1];
  const uint32_t z0 = !kCands && a.zkey != nullptr ? (uint32_t)a.zkey[2 * row] : 0u;
  const uint32_t z1 = !kCands && a.zkey != nullptr ? (uint32_t)a.zkey[2 * row + 1] : 0u;
  // the lanes a thread: 16 consecutive (kConsecutive), their chunks of four
  // moved as vectors and their spans summed in a register as they are
  // drawn; else lanes 128 apart, their spans and slots left in shared
  // memory and summed after the loop
  double own = 0.0;  // the consecutive lanes' sum (one slot)
  int my_drops = 0;
#pragma unroll 1
  for (int g = 0; g < kLanes; g += 4) {
    // four lanes: consecutive, or 128 apart (each a warp's 32 consecutive
    // lanes)
    uint32_t lane[4];
    bool in[4], live[4];
    float t[4];
    uint32_t rk[4] = {0u, 0u, 0u, 0u};
    int32_t sl[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lane[i] = kConsec ? blk0 + tid * (uint32_t)kLanes + (uint32_t)(g + i)
                        : blk0 + tid + (uint32_t)(kThreads * (g + i));
      in[i] = (int64_t)lane[i] < n;
    }
    const bool vec = kConsec && in[3];
    if (vec) {
      const size_t at = base + lane[0];
      const float4 f = *reinterpret_cast<const float4*>(a.t_send + at);
      t[0] = f.x;
      t[1] = f.y;
      t[2] = f.z;
      t[3] = f.w;
      const uint32_t al = *reinterpret_cast<const uint32_t*>(a.alive + at);
#pragma unroll
      for (int i = 0; i < 4; ++i) live[i] = ((al >> (8 * i)) & 0xFFu) != 0u;
      if (!kCands && a.rank != nullptr) {
        const longlong2 r0 = reinterpret_cast<const longlong2*>(a.rank + at)[0];
        const longlong2 r1 = reinterpret_cast<const longlong2*>(a.rank + at)[1];
        rk[0] = (uint32_t)r0.x;
        rk[1] = (uint32_t)r0.y;
        rk[2] = (uint32_t)r1.x;
        rk[3] = (uint32_t)r1.y;
      }
      if (!kCands && a.slot != nullptr) {
        const int4 q = *reinterpret_cast<const int4*>(a.slot + at);
        sl[0] = q.x;
        sl[1] = q.y;
        sl[2] = q.z;
        sl[3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        t[i] = in[i] ? a.t_send[base + lane[i]] : 0.0f;
        live[i] = in[i] && a.alive[base + lane[i]] != 0;
        if (!kCands && in[i] && a.rank != nullptr) rk[i] = (uint32_t)a.rank[base + lane[i]];
        if (!kCands && in[i] && a.slot != nullptr) sl[i] = a.slot[base + lane[i]];
      }
    }
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
    // their spike rows: searchsorted(spike_t, ts, right) - 1, -1 wrapping
    // to the last row, by the same fixed steps bounded by NB
    int si[4] = {0, 0, 0, 0};
    if (nb > 0) {
      for (int step = fault_top(nb); step > 0; step >>= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = si[i] + step - 1;
          si[i] += j < nb && spike_t[j] <= t[i] ? step : 0;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) si[i] = si[i] > 0 ? si[i] - 1 : nb - 1;
    }
    if constexpr (kCands) {
      // every slot's hop of the four lanes, slot k with its own keys
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        const uint4 p = par[k];
        const uint4 kk = key[k];
        const uint32_t e = p.w >> 3;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!in[i]) continue;
          const float ts = t[i];
          const bool gate = live[i] && ts < h;
          bool dropped;
          float f;
          float d = lane_delay<kFault>(kk.x, kk.y, kk.z, kk.w, lane[i], p,
                                       kFault ? flat[fi[i] * ne + e] : 1.0f,
                                       kFault ? fdrop[fi[i] * ne + e] : 0.0f, false, f,
                                       dropped);
          d = nb > 0 ? __fmaf_rn(d, f, spike_of(si[i], k, e)) : d * f;
          const bool ok = gate && !dropped;
          const size_t o = (base + lane[i]) * (size_t)K + (size_t)k;
          // the reference stacks the slots' delays before it adds the send
          // time: the delay is rounded first
          a.out[o] = ok ? ts + d : ts;
          a.ok[o] = ok ? 1u : 0u;
        }
      }
    } else {
      // the consecutive lanes' outputs, stored after the four
      float o[4] = {t[0], t[1], t[2], t[3]};
      uint32_t okw = 0u;  // the four ok bytes
      int32_t tg[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!in[i]) continue;
        const float ts = t[i];
        bool gate = live[i] && ts < h;
        int slot = 0;
        if (lb) {
          if (a.slot != nullptr && gate && sl[i] < 0) {
            // no healthy target: dropped at the LB
            my_drops += 1;
            gate = false;
          }
          if (gate) slot = a.slot != nullptr ? sl[i] : (int)(rk[i] % (uint32_t)K);
        }
        const uint4 p = par[slot];
        const uint32_t e = p.w >> 3;
        bool dropped;
        float f;
        float d = lane_delay<kFault>(k0, k1, z0, z1, lane[i], p,
                                     kFault ? flat[fi[i] * ne + e] : 1.0f,
                                     kFault ? fdrop[fi[i] * ne + e] : 0.0f, select, f,
                                     dropped);
        if (nb > 0) {
          d = __fmaf_rn(d, f, spike_of(si[i], slot, e));
          f = 1.0f;
        }
        const bool ok = gate && !dropped;
        const float t_end = __fmaf_rn(d, f, ts);
        // the lane's span (0 where not sent) for its slot: added to the
        // thread's sum in lane order, or left with its slot for the sums
        const float span = ok ? fmaxf(fminf(t_end, h) - fminf(ts, h), 0.0f) : 0.0f;
        if constexpr (kConsec) {
          o[i] = ok ? t_end : ts;
          okw |= (ok ? 1u : 0u) << (8 * i);
          if (lb) tg[i] = tgt[slot];
          own += (double)span;
        } else {
          a.out[base + lane[i]] = ok ? t_end : ts;
          a.ok[base + lane[i]] = ok ? 1u : 0u;
          if (lb) a.target[base + lane[i]] = tgt[slot];
          const uint32_t w = lane[i] - blk0;
          spans[span_word(w)] = span;
          slots[w] = (uint8_t)slot;
        }
        my_drops += (gate && dropped) ? 1 : 0;
      }
      if constexpr (kConsec) {
        if (vec) {
          const size_t at = base + lane[0];
          float4 f;
          f.x = o[0];
          f.y = o[1];
          f.z = o[2];
          f.w = o[3];
          *reinterpret_cast<float4*>(a.out + at) = f;
          *reinterpret_cast<uint32_t*>(a.ok + at) = okw;
          if (lb) {
            int4 q;
            q.x = tg[0];
            q.y = tg[1];
            q.z = tg[2];
            q.w = tg[3];
            *reinterpret_cast<int4*>(a.target + at) = q;
          }
        } else {
          // the row's last lanes
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (!in[i]) continue;
            a.out[base + lane[i]] = o[i];
            a.ok[base + lane[i]] = (uint8_t)((okw >> (8 * i)) & 1u);
            if (lb) a.target[base + lane[i]] = tg[i];
          }
        }
      }
    }
  }
  if constexpr (!kCands) {
    drops[tid] = my_drops;
    if (kConsec) acc[tid] = own;
    // each thread's sums over its 16 consecutive lanes, in order (a lane
    // not sent adds 0 to slot 0), where its lanes were 128 apart; the host
    // build runs the threads one after another: the last sums every
    // thread's lanes, then the block's
#ifdef __CUDACC__
    if (!kConsec) __syncthreads();
    const unsigned th_first = tid, th_last = kConsec ? tid : tid + 1;
#else
    if (tid != nt - 1) return;
    const unsigned th_first = 0, th_last = kConsec ? 0 : nt;
#endif
    for (unsigned th = th_first; th < th_last; ++th) {
      const uint32_t w0 = th * (uint32_t)kLanes;
      const int64_t left = n - (int64_t)blk0 - (int64_t)w0;
      const int cnt = left <= 0 ? 0 : left < kLanes ? (int)left : kLanes;
      float v[kLanes];
#pragma unroll
      for (int q = 0; q < kLanes / 4; ++q) {
        const float4 c = *reinterpret_cast<const float4*>(spans + span_word(w0 + 4 * q));
        v[4 * q] = c.x;
        v[4 * q + 1] = c.y;
        v[4 * q + 2] = c.z;
        v[4 * q + 3] = c.w;
      }
      // (unrolled, so that v and the slot words stay in registers)
      if (K == 1) {
        double s = 0.0;
#pragma unroll
        for (int i = 0; i < kLanes; ++i)
          if (i < cnt) s += (double)v[i];
        acc[th] = s;
      } else {
        const uint4 sw = *reinterpret_cast<const uint4*>(slots + w0);
        const uint32_t words[4] = {sw.x, sw.y, sw.z, sw.w};
        for (int k = 0; k < K; ++k) acc[k * nt + th] = 0.0;
#pragma unroll
        for (int i = 0; i < kLanes; ++i) {
          const int k = (int)((words[i / 4] >> (8 * (i % 4))) & 0xFFu);
          if (i < cnt) acc[k * nt + th] += (double)v[i];
        }
      }
    }
    // the block's sums: each column by one thread, over the block's threads
    // in order
#ifdef __CUDACC__
    __syncthreads();
    if ((int)tid > K) return;
    const int k_first = (int)tid, k_last = (int)tid;
#else
    const int k_first = 0, k_last = K;
#endif
    double* part = a.partial + ((size_t)row * gridDim.x + blockIdx.x) * (size_t)(K + 1);
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
}

// the hop's instance of a lane form
template <bool kFault, bool kStaged>
void (*hop_instance(int form))(EdgeDrawArgs) {
  return form == kCandidates    ? hop_kernel<kFault, kStaged, kCandidates>
         : form == kConsecutive ? hop_kernel<kFault, kStaged, kConsecutive>
                                : hop_kernel<kFault, kStaged, kStrided>;
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
  const bool hop_mode = a.mode == kHopMode || a.mode == kCandidatesMode;
  const bool cands = a.mode == kCandidatesMode;
  HopSmem m{};
  if (a.mode == kUniformMode) {
    if (a.out == nullptr || (a.ukey == nullptr) == (a.x_in == nullptr)) return -1;
  } else if (hop_mode) {
    if (a.out == nullptr || a.ok == nullptr || a.t_send == nullptr || a.alive == nullptr ||
        a.ukey == nullptr || a.mean == nullptr || a.var == nullptr || a.drop == nullptr ||
        a.dist == nullptr || a.K < 1 || a.K > kMaxSlots)
      return -1;
    if (cands) {
      // every slot's edge, no LB lanes and no sums
      if (a.lb_edge == nullptr || a.edge >= 0 || a.rank != nullptr || a.slot != nullptr ||
          a.target != nullptr || a.span != nullptr || a.partial != nullptr ||
          a.dropped != nullptr)
        return -1;
    } else {
      if (a.span == nullptr || a.partial == nullptr || a.dropped == nullptr) return -1;
      if (a.rank != nullptr && a.slot != nullptr) return -1;
      if (a.rank != nullptr || a.slot != nullptr) {
        if (a.edge >= 0 || a.lb_edge == nullptr || a.lb_target == nullptr ||
            a.target == nullptr)
          return -1;
      } else if (a.edge < 0 || a.edge >= a.NE || a.K != 1) {
        return -1;
      }
    }
    if (a.spike_t != nullptr && (a.spike_v == nullptr || a.NB < 1)) return -1;
    if (a.fault_t != nullptr && (a.fault_lat == nullptr || a.fault_drop == nullptr || a.NF < 1))
      return -1;
    m = hop_smem(!cands, a.K, a.spike_t != nullptr ? a.NB : 0,
                 a.fault_t != nullptr ? a.NF : 0, a.NE);
    if (m.total > kHopSmem) return -1;
  } else if (a.mode == kGapsMode) {
    if (a.out == nullptr || a.ukey == nullptr || a.ld_out < a.n + 1) return -1;
  } else {
    return -1;
  }
  const size_t smem = m.total;
  // the hop's lanes 16 consecutive a thread where it has one slot and every
  // row of every lane array starts on a 16-byte boundary (4-byte for the
  // masks): n a multiple of 4 and the arrays so aligned
  const int form =
      cands ? kCandidates
      : a.K == 1 && a.n % 4 == 0 && aligned(a.t_send, 16) && aligned(a.out, 16) &&
              aligned(a.alive, 4) && aligned(a.ok, 4) &&
              (a.rank == nullptr || aligned(a.rank, 16)) &&
              (a.slot == nullptr || aligned(a.slot, 16)) &&
              (a.target == nullptr || aligned(a.target, 16))
          ? kConsecutive
          : kStrided;
  const int64_t blocks = (a.n + kLaneBlock - 1) / kLaneBlock;
  if (blocks > 0x7FFFFFFFll) return -1;
  const int64_t total_rows = a.S;
  const EdgeDrawArgs whole = a;
  // a row's key words and outputs a lane: K of each for the candidates
  const int64_t per = cands ? whole.K : 1;
  for (int64_t r0 = 0; r0 < total_rows; r0 += kMaxRows) {
    const int64_t rows = total_rows - r0 < kMaxRows ? total_rows - r0 : kMaxRows;
    // the chunk's rows as rows 0.. of its own arguments
    a = whole;
    a.S = rows;
    a.ukey = whole.ukey != nullptr ? whole.ukey + 2 * per * r0 : nullptr;
    a.zkey = whole.zkey != nullptr ? whole.zkey + 2 * per * r0 : nullptr;
    if (whole.x_in != nullptr) a.x_in = whole.x_in + r0 * whole.n;
    if (whole.mode == kGapsMode) {
      a.out = whole.out + r0 * whole.ld_out;
    } else {
      a.out = whole.out + r0 * whole.n * per;
    }
    if (hop_mode) {
      a.t_send = whole.t_send + r0 * whole.n;
      a.alive = whole.alive + r0 * whole.n;
      a.ok = whole.ok + r0 * whole.n * per;
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
      const auto hop = a.fault_t == nullptr ? hop_instance<false, false>(form)
                       : m.fault_staged     ? hop_instance<true, true>(form)
                                            : hop_instance<true, false>(form);
      hop<<<grid, block, smem, (cudaStream_t)stream>>>(a);
      if (!cands) {
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
