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
// scenario, walked with the station's state:
//
//   mode 0 (c = 1)  C_k = max(A_k + S_k, C_{k-1} + S_k) as the inclusive
//                   max-plus scan of e_k = (S_k, A_k + S_k) under
//                   (a1, b1) o (a2, b2) = (a1 + a2, max(b2, b1 + a2)), in
//                   the reference's associative_scan tree (no multiply,
//                   so no fused multiply-add can enter),
//                   wait_k = max(0, (C_k - S_k) - A_k);
//   mode 1 (c > 1)  the ascending vector of the c core-free times: wait on
//                   the first, replace it by max(f_0, A_k) + S_k, re-sort;
//   mode 2          the ram_k admission-slot and c core-free vectors:
//                   grant g = max(A, r_0), start s = max(g + pre, w_0)
//                   (g + pre for an empty burst), release s + S + post;
//                   outputs (g - A, s - (g + pre), release);
//   mode 3          the token bucket of ``burst`` tokens refilled at
//                   ``rate`` a second, full at time 0: tok = min(burst,
//                   fmaf(A_k - last, rate, tokens)) (the refill's
//                   multiply and add rounded once, as the jitted
//                   reference's fused multiply-add rounds them);
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
// Invalid elements leave the carry unchanged (in mode 0 they are the
// scan's identity, (0, -inf), but their positions shape its tree), so a
// row may interleave other stations' lanes.  Built with --fmad=false: each
// float operation rounds as the plain PyTorch version's does.
//
// Bound: bytes.  An element is read once (arrival, service, validity;
// pre-IO and post-IO in mode 2) and its outputs written once, for a few
// float operations.  A K-server FIFO has no cheap associative form (a K x
// K max-plus product a combine), so the carry modes' parallelism is across
// rows and across the carry vector; the one-server scan's is the
// reference's tree.  The walks:
//
// The tree walk (mode 0): a block of kTreeThreads a row, walked in tiles
// of kTreeTile elements, a thread a run of kTreeRun consecutive elements:
// its loads as 16-byte vectors (scalars on a row off a 16-byte boundary),
// its run's tree in registers, the tile's tree of runs in shared memory
// (a warp's levels under __syncwarp, the top levels by one thread), each
// run's prefix before it folded from the carry and its path's left
// siblings, then the run's down-sweep in registers and its waits stored as
// vectors.  The carry from tile to tile is a binary counter of whole
// aligned blocks of tiles, kept by one thread.  A tile costs two barriers
// (its levels are double-buffered by the tile's parity); at 2048 rows
// the grid is 2048 blocks.  Runs of 8: at 16 and 32 elements the run's
// register arrays went to local memory (448 and 912 bytes a thread) and
// the headline's scan took 2.8 and 3.4 ms against 0.82 (builds of this
// file with other run lengths, timed by scripts/torch_scan_variants.py
// --against).  The reference's order is described at tree_walk_kernel.
//
// The thread walk (the carry modes past kWarpWidthMax entries: the global
// walk): one thread a row, 16 rows a block (half a warp: the lanes of a warp read
// different rows, one L1 wavefront each, so the wavefronts, not the lanes,
// are the cost, and 16-row blocks spread the 2048 rows over 128 SMs).  It
// moves 16 bytes a lane an instruction: the elements before the row's first
// 16-byte boundary one at a time, then kVec elements at a time as float4 /
// uchar4 vectors (their loads issued together), then the tail; each lane
// prefetches into L1 the lines of its row kAhead elements on.  The carry
// (past kWarpWidthMax entries: a core count the schema does not bound)
// lives in global scratch the wrapper allocates, with the shifting
// insertion (MemVec).  scripts/torch_scan_variants.py
// times other block sizes and prefetch distances (-DSTATION_ROWS,
// -DSTATION_AHEAD).
//
// The controlled and socket modes keep their ring as a circular buffer
// with a head index (the reference's shift only reorders storage: its first
// entry is the buffer's head): in the block's shared memory on the global
// walk, spread over the warp's lanes on the warp walk (entry j on lane
// j % 32, read by a shuffle from its owner, written by it); their lane walk
// keeps it as a shifting FIFO (below).
//
// The warp walk (modes 1 and 2, modes 4 and 5 past the lane walk's shapes,
// up to kWarpWidthMax entries a vector; the socket mode's connections in
// the RAM-core mode's place of the RAM slots): one warp a row, kWarps rows
// a block.  A carry vector wider than kWholeMax entries is spread over the
// lanes: lane l holds entries [l E, (l + 1) E), E the smallest power of
// two that covers the vector over the lanes; a narrower
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
// are at a narrower form).  Modes 4 and 5 take it only past the lane
// walk's shapes.
//
// The token bucket (mode 3) a warp a row, its chain on the valid elements
// only.  The clock ``last`` is the time of the row's previous valid
// element: it depends on validity alone, so each valid element's elapsed
// time t - last is computed off the chain, a lane an element (the
// previous valid lane found in the line's ballot, the line's last valid
// time carried to the next line), and written compacted (a popcount of the
// ballot below the lane) to the warp's stage.  The chain then walks only
// the line's valid elements, every lane alike: y = min(burst,
// fmaf(dt, rate, tokens)), tokens = y >= 1 ? y - 1 : y, storing the tokens
// before each step;
// each lane recomputes its own y from them (the same operands, so the same
// bits) for its accepted flag.  A line with no valid element costs a
// ballot and a store of zero flags, so a row's invalid tail (the fast path
// sorts the valid elements first) is nearly free.  The row comes in lines
// of 32 elements on its 128-byte boundaries, a lane an element, coalesced,
// kBucketLines lines in flight while the previous ones are walked.
//
// The lane walk (modes 4 and 5 up to kLaneWhole ring entries and cores, and
// in mode 5 connections): a lane a row, 32 rows a warp, a warp a block.
// Every vector is whole in the lane's registers: the connections and the
// cores as
// RegVec's selects, the ring as a shifting FIFO whose oldest entry is
// always its first (a push shifts the entries below max(cap, 1) - 1 down
// and writes the grant at max(cap, 1) - 1, by bit selects against masks
// set once), so no element takes a shuffle or an index into registers and
// the warp issues one instruction for 32 rows' elements.  At 2048 rows that
// is 64 warps, one on each of 64 schedulers, with no other warp to hide an
// element's dependent instructions: the walk is bound by their latency
// (about 90 instructions an element in mode 5, 13 of them on the chain
// through the first connection's exit; mode 4 has no connections, no
// refusal and no burst flags, so its chain runs from the oldest grant's
// shed test through the grant, the wait and the deadline to the core's
// insertion and the ring's push).  The rows come in
// groups of 32 elements on the tensor's 128-byte boundaries, each lane
// copying its own row's group asynchronously (cp.async, 16 bytes a copy)
// into one of two shared stages while the other is walked; a row's 16-byte
// chunk c lies at c ^ (row & 7) (a byte input's half h at h ^ ((row >> 2)
// & 1)), so the lanes' 16-byte reads of 8 rows at a time hit no bank
// twice.  Each lane stores its own outputs, a chunk's four waits and four
// flags at a time (element by element in a chunk that the row shares with
// its neighbour).  A group in which no row has a valid element leaves the
// carry as it is and takes no chain.  The lane walk needs every input and
// output on a 16-byte boundary (the wrapper copies an input that is not).
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
constexpr int kLaneWhole = 8;   // connections, ring entries and cores of the lane walk
constexpr int kBucketLines = 8;  // lines of kLanes elements the bucket keeps in flight

// which walk a launch takes (station_scan_walk)
constexpr int kWalkTree = 0;
constexpr int kWalkWarp = 1;
constexpr int kWalkGlobal = 2;
constexpr int kWalkLane = 3;

__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// ---------------------------------------------------------------------------
// the tree walk (mode 0)
// ---------------------------------------------------------------------------

// An element or block aggregate of Lindley's max-plus scan: x -> max(b, x +
// a).  A prefix (a left operand) only ever needs its b.
struct Agg {
  float a, b;
};

// The reference's combine, left o right: (a1 + a2, max(b2, b1 + a2)).
__device__ __forceinline__ Agg agg_of(Agg l, Agg r) { return {l.a + r.a, fmaxf(r.b, l.b + r.a)}; }
// The b of prefix o r.
__device__ __forceinline__ float prefix_of(float p, Agg r) { return fmaxf(r.b, p + r.a); }

constexpr int kTreeRun = 8;        // elements a run: a thread's, in registers
constexpr int kTreeRunLevels = 3;  // log2(kTreeRun)
constexpr int kTreeRuns = 256;   // runs a tile
constexpr int kTreeLevels = 8;   // log2(kTreeRuns)
constexpr int kTreeTile = kTreeRun * kTreeRuns;
constexpr int kTreeStack = 48;   // the binary counter's blocks (rows up to 2^48 tiles)
#ifdef __CUDACC__
constexpr int kTreeThreads = kTreeRuns;  // a thread a run
#else
constexpr int kTreeThreads = 1;  // the host build: one thread runs every run in turn
#endif
constexpr int kTreeRunsPer = kTreeRuns / kTreeThreads;

// Where run level s (blocks of 2^s runs) starts in a tile's level array.
__device__ __forceinline__ int tree_off(int s) { return 2 * kTreeRuns - ((2 * kTreeRuns) >> s); }

// A run's registers between its up-sweep and its down-sweep: the services
// and arrivals (for the waits), and the left operands the down-sweep needs:
// at each level of the run's tree the even entries (level L's at
// left[kTreeRun - (kTreeRun >> L) + j]: the even elements, then the even
// blocks of 2, 4, ...).
struct TreeRun {
  float svc[kTreeRun], arr[kTreeRun];
  Agg left[kTreeRun - 1];
};

// Load run r's elements (the row's elements k0 .. k0 + kTreeRun - 1, those
// past m the identity), keep what the down-sweep needs and return the
// run's aggregate: a balanced tree of its pairs, as the reference's levels.
__device__ __forceinline__ Agg tree_up(const StationArgs& a, const float* A, const float* D,
                                       const uint8_t* V, int64_t k0, bool vec, TreeRun& t) {
  float av[kTreeRun], dv[kTreeRun];
  bool ok[kTreeRun];
  if (vec && k0 + kTreeRun <= a.m) {
#pragma unroll
    for (int q = 0; q < kTreeRun / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(A + k0 + 4 * q);
      const float4 y = *reinterpret_cast<const float4*>(D + k0 + 4 * q);
      const uchar4 w = *reinterpret_cast<const uchar4*>(V + k0 + 4 * q);
      av[4 * q] = x.x, av[4 * q + 1] = x.y, av[4 * q + 2] = x.z, av[4 * q + 3] = x.w;
      dv[4 * q] = y.x, dv[4 * q + 1] = y.y, dv[4 * q + 2] = y.z, dv[4 * q + 3] = y.w;
      ok[4 * q] = w.x != 0, ok[4 * q + 1] = w.y != 0, ok[4 * q + 2] = w.z != 0;
      ok[4 * q + 3] = w.w != 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTreeRun; ++i) {
      const bool in = k0 + i < a.m;
      av[i] = in ? A[k0 + i] : 0.0f;
      dv[i] = in ? D[k0 + i] : 0.0f;
      ok[i] = in && V[k0 + i] != 0;
    }
  }
  Agg cur[kTreeRun];
#pragma unroll
  for (int i = 0; i < kTreeRun; ++i) {
    t.svc[i] = ok[i] ? dv[i] : 0.0f;
    t.arr[i] = ok[i] ? av[i] : 0.0f;
    cur[i] = {t.svc[i], ok[i] ? t.arr[i] + t.svc[i] : -kInf};
  }
#pragma unroll
  for (int L = 0; L < kTreeRunLevels; ++L) {
    const int n = kTreeRun >> L;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      t.left[kTreeRun - n + j] = cur[2 * j];
      cur[j] = agg_of(cur[2 * j], cur[2 * j + 1]);
    }
  }
  return cur[0];
}

// The run's prefixes from ``in``, the prefix before its first element, and
// ``out``, the prefix through its last: the reference's down-sweep, an
// even entry 2j of a level ``(prefix through entry j - 1 of the level
// above) o e(2j)``, an odd one the level above's; then the waits.
__device__ __forceinline__ void tree_down(const StationArgs& a, float* W, int64_t k0, bool vec,
                                          const TreeRun& t, float in, float out) {
  float o[kTreeRun];
  o[0] = out;
#pragma unroll
  for (int L = kTreeRunLevels - 1; L >= 0; --L) {
    const int n = kTreeRun >> L;
#pragma unroll
    for (int j = n / 2 - 1; j >= 0; --j) {
      o[2 * j + 1] = o[j];
      o[2 * j] = prefix_of(j == 0 ? in : o[j - 1], t.left[kTreeRun - n + j]);
    }
  }
  float w[kTreeRun];
#pragma unroll
  for (int i = 0; i < kTreeRun; ++i) w[i] = fmaxf((o[i] - t.svc[i]) - t.arr[i], 0.0f);
  if (vec && k0 + kTreeRun <= a.m) {
#pragma unroll
    for (int q = 0; q < kTreeRun / 4; ++q) {
      float4 x;
      x.x = w[4 * q], x.y = w[4 * q + 1], x.z = w[4 * q + 2], x.w = w[4 * q + 3];
      *reinterpret_cast<float4*>(W + k0 + 4 * q) = x;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTreeRun; ++i)
      if (k0 + i < a.m) W[k0 + i] = w[i];
  }
}

// Lindley's waits in the reference's tree order (_lindley_waits'
// associative_scan): a block a row, walked in tiles of kTreeTile elements.
// The prefix at k is the left fold, largest first, of the aligned
// power-of-two blocks of k + 1, each block's aggregate a balanced tree.
// In a tile at offset o (a multiple of kTreeTile) the blocks of element
// o + i < o + kTreeTile - 1 are those of o (whole tiles: the carry) and
// then those of i + 1 within the tile; so a run's prefix before it is the
// carry folded with the left siblings of its path in the tile's tree of
// runs, and the run's own prefixes are the reference's down-sweep from
// there.  The tile's last element takes the carry of the tiles through it:
// a binary counter of the aggregates of whole aligned blocks of tiles,
// merged ``lower o upper`` where two have one size, folded from the
// largest.  The first tile's carry is the identity (b = -inf), which
// leaves every b as it is bit for bit.  Every add and max is the
// reference's, on the same operands in the same order.
__global__ void __launch_bounds__(kTreeThreads) tree_walk_kernel(StationArgs a) {
  __shared__ Agg lev[2][2 * kTreeRuns];  // a tile's levels of runs, by tile parity
  __shared__ float edge[2];              // the prefix through a tile's end, by parity
  __shared__ Agg stack[kTreeStack];      // the counter's blocks, largest first
  __shared__ int stack_lvl[kTreeStack];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int64_t base = row * a.m;
  const float* A = a.a + base;
  const float* D = a.d + base;
  const uint8_t* V = a.v + base;
  float* W = a.out0 + base;
  const bool vec = (((uintptr_t)A | (uintptr_t)D | (uintptr_t)W | (uintptr_t)V) & 15u) == 0u;
  int depth = 0;  // thread 0's
  TreeRun run[kTreeRunsPer];
  int parity = 0;
  for (int64_t tile0 = 0; tile0 < a.m; tile0 += kTreeTile, parity ^= 1) {
    Agg* L = lev[parity];
    // each run's aggregate, then the levels of blocks of 2 .. 32 runs, a
    // warp's own
    for (int q = 0; q < kTreeRunsPer; ++q) {
      const int r = tid + q * kTreeThreads;
      L[r] = tree_up(a, A, D, V, tile0 + (int64_t)r * kTreeRun, vec, run[q]);
    }
    __syncwarp();
    for (int s = 1; s <= 5; ++s) {
      for (int q = 0; q < kTreeRunsPer; ++q) {
        const int t = tid + q * kTreeThreads;
        const int lane = t & 31;
        if (lane < (32 >> s)) {
          const int j = (t >> 5) * (32 >> s) + lane;
          L[tree_off(s) + j] = agg_of(L[tree_off(s - 1) + 2 * j], L[tree_off(s - 1) + 2 * j + 1]);
        }
      }
      __syncwarp();
    }
    __syncthreads();
    // thread 0: the levels of 64 .. 256 runs, then the tile enters the
    // counter and its end prefix is the counter's fold
    if (tid == 0) {
      for (int s = 6; s <= kTreeLevels; ++s)
        for (int j = 0; j < (kTreeRuns >> s); ++j)
          L[tree_off(s) + j] = agg_of(L[tree_off(s - 1) + 2 * j], L[tree_off(s - 1) + 2 * j + 1]);
      Agg top = L[tree_off(kTreeLevels)];
      int lvl = 0;
      while (depth > 0 && stack_lvl[depth - 1] == lvl) {
        top = agg_of(stack[depth - 1], top);
        --depth;
        ++lvl;
      }
      stack[depth] = top;
      stack_lvl[depth] = lvl;
      ++depth;
      float f = stack[0].b;
      for (int i = 1; i < depth; ++i) f = prefix_of(f, stack[i]);
      edge[parity] = f;
    }
    __syncthreads();
    // each run: its prefix before it and through it, then its own
    const float carry = tile0 == 0 ? -kInf : edge[parity ^ 1];
    for (int q = 0; q < kTreeRunsPer; ++q) {
      const int r = tid + q * kTreeThreads;
      float in = carry;
      for (int s = kTreeLevels - 1; s >= 0; --s)
        if ((r >> s) & 1) in = prefix_of(in, L[tree_off(s) + (r >> s) - 1]);
      float out = edge[parity];
      if (r + 1 < kTreeRuns) {
        out = carry;
        for (int s = kTreeLevels - 1; s >= 0; --s)
          if (((r + 1) >> s) & 1) out = prefix_of(out, L[tree_off(s) + ((r + 1) >> s) - 1]);
      }
      tree_down(a, W, tile0 + (int64_t)r * kTreeRun, vec, run[q], in, out);
    }
  }
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

// A row's state in mode kMode (1 or 2) and the step of one element: its
// outputs from (arrival, service, validity, pre-IO, post-IO).
template <int kMode>
struct Station {
  MemVec& wc;
  MemVec& wr;

  __device__ __forceinline__ void step(float ak, float dk, bool ok, float pk, float qk,
                                       float& o0, float& o1, float& o2) {
    if (kMode == 1) {
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

// One row's walk in mode kMode (1 or 2) by one thread, the global walk;
// wc and wr are its core and RAM-slot vectors.
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
  Station<kMode> st{wc, wr};

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

// One row of the controlled (4) or socket (5) mode by one thread, an
// element at a time: the core vector wc, the connections' exit times conn
// (mode 5) and the ring, entry j at ring[j * stride].
template <int kMode>
__device__ __forceinline__ void control_walk(const StationArgs& a, int64_t row, MemVec& wc,
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

// The global walk of modes 4 and 5 (a core vector past kWarpWidthMax):
// the vectors in global scratch (the connections first, then the cores);
// the rows' rings in the block's shared memory, entry j of thread i at
// j * kRows + i.
template <int kMode>
__global__ void control_thread_kernel(StationArgs a) {
  __shared__ float rings[kRingMax * kRows];
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.S) return;
  float* ring = rings + threadIdx.x;
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

// ---------------------------------------------------------------------------
// the token bucket a warp a row
// ---------------------------------------------------------------------------

// the lanes below ``lane`` (none in the host build)
__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// the highest set bit of a mask that is not 0
__device__ __forceinline__ int top_bit(unsigned x) {
#ifdef __CUDACC__
  return 31 - __clz(x);
#else
  return 31 - __builtin_clz(x);
#endif
}

// One row of the token bucket (mode 3) a warp, kWarps rows a block, in
// lines of kLanes elements (a lane an element), kBucketLines lines loaded
// while the ones before them are walked.
__global__ void __launch_bounds__(kWarps * kLanes) bucket_warp_kernel(StationArgs a) {
  // a warp's line: its valid elements' refills, compacted, and the tokens
  // before each of them, four past the line's widest (the walk's last
  // step of four may run past its valid elements)
  constexpr int kStage = (kLanes + 4 + 3) / 4;
  __shared__ float4 stage_inc[kWarps][kStage];
  __shared__ float4 stage_tok[kWarps][kStage];
  const int lane = (int)(threadIdx.x % kLanes);
  const int w = (int)(threadIdx.x / kLanes);
  const int64_t row = (int64_t)blockIdx.x * kWarps + w;
  if (row >= a.S) return;  // the whole warp
  const int64_t m = a.m;
  const int64_t base = row * m;
  const float* __restrict__ T = a.a + base;
  const uint8_t* __restrict__ V = a.v + base;
  uint8_t* __restrict__ F = a.flag + base;
  float* sinc = reinterpret_cast<float*>(stage_inc[w]);
  float* stok = reinterpret_cast<float*>(stage_tok[w]);
  for (int j = lane; j < 4 * kStage; j += kLanes) sinc[j] = stok[j] = 0.0f;
  __syncwarp();
  const unsigned below = lanes_below(lane);
  const float rate = a.rate;
  const float burst = a.burst;
  float tokens = burst;
  float last = 0.0f;
  constexpr int kSpan = kBucketLines * kLanes;  // elements a step
  // lines start on the rows' 128-byte boundaries: the first one holds
  // (base % kLanes) elements before the row, which load as invalid
  const int64_t lead = base % kLanes;
  float xt[kBucketLines];
  uint8_t xv[kBucketLines];
  const auto load = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < kBucketLines; ++i) {
      const int64_t k = k0 + i * kLanes + lane;
      const bool in = k >= 0 && k < m;
      xt[i] = in ? T[k] : 0.0f;
      xv[i] = in ? V[k] : 0;
    }
  };
  load(-lead);
  for (int64_t k0 = -lead; k0 < m; k0 += kSpan) {
    float ct[kBucketLines];
    uint8_t cv[kBucketLines];
#pragma unroll
    for (int i = 0; i < kBucketLines; ++i) {
      ct[i] = xt[i];
      cv[i] = xv[i];
    }
    if (k0 + kSpan < m) load(k0 + kSpan);
#pragma unroll
    for (int i = 0; i < kBucketLines; ++i) {
      const bool ok = cv[i] != 0;
      const unsigned valid = __ballot_sync(kAll, ok);
      uint8_t accepted = 0;
      if (valid != 0u) {
        // off the chain: the refill since the row's previous valid element,
        // at the element's place among the line's valid ones
        const unsigned prior = valid & below;
        const float t_prior = __shfl_sync(kAll, ct[i], prior != 0u ? top_bit(prior) : 0);
        const float inc = ct[i] - (prior != 0u ? t_prior : last);
        const int at = __popc(prior);
        if (ok) sinc[at] = inc;
        last = __shfl_sync(kAll, ct[i], top_bit(valid));
        __syncwarp();
        // the chain, over the line's valid elements only, four steps at a
        // time: the next four refills load before this four's steps, and
        // the tokens before each step store after them, so no shared
        // access waits on the chain; steps past the valid elements run on
        // stale refills, and the tokens come back from before the first
        const int n = __popc(valid);
        float4 next = stage_inc[w][0];
        for (int j = 0; j < n; j += 4) {
          const float4 inc4 = next;
          next = stage_inc[w][j / 4 + 1];
          float4 before;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            set_lane(before, u, tokens);
            const float y = fminf(burst, __fmaf_rn(lane_of(inc4, u), rate, tokens));
            tokens = y >= 1.0f ? y - 1.0f : y;
          }
          stage_tok[w][j / 4] = before;
        }
        if ((n & 3) != 0) tokens = stok[n];
        __syncwarp();
        if (ok) accepted = fminf(burst, __fmaf_rn(inc, rate, stok[at])) >= 1.0f ? 1 : 0;
        __syncwarp();  // the stage is rewritten next line
      }
      const int64_t k = k0 + i * kLanes + lane;
      if (k >= 0 && k < m) F[k] = accepted;
    }
  }
}

// ---------------------------------------------------------------------------
// the lane walk
// ---------------------------------------------------------------------------

// Copy 16 bytes to shared memory, the first ``valid`` of them from src and
// the rest zero, asynchronously on the card.
__device__ __forceinline__ void copy16_async(void* dst, const void* src, int valid) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid));
#elif !defined(__CUDACC__)
  std::memset(dst, 0, 16);
  if (valid > 0) std::memcpy(dst, src, valid);
#endif
}
// close this lane's copies issued since the last commit as one group
__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// wait for all but this lane's newest group of copies
__device__ __forceinline__ void copy_wait_all_but_one() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::);
#endif
}

// The ring of the last r = max(cap, 1) grants as a shifting FIFO of
// kLaneWhole registers: its oldest entry is always f[0]; a push moves f[j +
// 1] to f[j] below r - 1 and writes the grant at r - 1 (and above it, where
// nothing is read), by bit selects against masks set once.
struct ShiftRing {
  float f[kLaneWhole];
  uint32_t keep[kLaneWhole];  // all ones where f[j + 1] moves down on a push

  __device__ __forceinline__ void init(int cap) {
    const int r = cap > 1 ? cap : 1;
#pragma unroll
    for (int j = 0; j < kLaneWhole; ++j) {
      f[j] = -kInf;
      keep[j] = j + 1 < r ? 0xffffffffu : 0u;
    }
  }
  __device__ __forceinline__ void push(bool on, float g) {
    const uint32_t gb = __float_as_uint(g);
#pragma unroll
    for (int j = 0; j < kLaneWhole; ++j) {
      const uint32_t nb =
          j + 1 < kLaneWhole ? __float_as_uint(f[j + 1 < kLaneWhole ? j + 1 : j]) : gb;
      const float next = __uint_as_float((nb & keep[j]) | (gb & ~keep[j]));
      f[j] = on ? next : f[j];
    }
  }
};

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Where a lane's row keeps a group's 16-byte chunk c of a float input and
// its 16-byte half h of a byte input in the stage: no two of 8 lanes'
// 16-byte reads share a bank.
__device__ __forceinline__ int chunk_at(int lane, int c) { return c ^ (lane & 7); }
__device__ __forceinline__ int half_at(int lane, int h) { return h ^ ((lane >> 2) & 1); }

// One row a lane, kLanes rows a warp, a warp a block: the controlled scan
// (kMode 4) or the socket scan (kMode 5), with the ring, the EC cores and
// (mode 5) the connections (kLaneWhole entries) whole in the lane's
// registers.  Every row of the warp walks its groups of kGroup elements on
// the tensor's 128-byte boundaries in step: group i of row R holds the
// elements (R m / kGroup + i) kGroup - R m + [0, kGroup) of it, those
// outside the row invalid and not stored.  Each lane copies its own row's
// groups into the stage (16 bytes a copy) and stores its own outputs (a
// chunk's waits and flags a store each, element by element at the row's
// two ends).  Mode 4 stages only what it reads: its enqueue times (in a),
// services and validity; every element of it is a burst, so its chain has
// no refusal test, no burst select and no exit time.
template <int kMode, int EC>
__global__ void __launch_bounds__(kLanes) lane_walk_kernel(StationArgs a) {
  constexpr bool kSocket = kMode == 5;
  constexpr int kChunks = kGroup / 4;  // 16-byte chunks of a float input a group
  constexpr int kHalves = kGroup / 16;  // 16-byte halves of a byte input a group
  // float inputs: arrival, enqueue, service, post-IO (mode 4: enqueue,
  // service); byte inputs: validity, burst flags (mode 4: validity)
  constexpr int kF = kSocket ? 4 : 2;
  constexpr int kB = kSocket ? 2 : 1;
  constexpr int kE = kSocket ? 1 : 0;  // the stage rows of the enqueue times,
  constexpr int kD = kSocket ? 2 : 1;  // the services
  constexpr int kQ = kSocket ? 3 : 1;  // and the post-IO (mode 5)
  // two stages of each lane's group of the float and byte inputs
  __shared__ float4 stage_f[2][kF][kLanes][kChunks];
  __shared__ uint4 stage_b[2][kB][kLanes][kHalves];
  const int lane = (int)(threadIdx.x % kLanes);
  const int64_t row = (int64_t)blockIdx.x * kLanes + lane;
  const bool mine = row < a.S;
  const int64_t m = a.m;
  const int64_t total = a.S * m;
  const float* const src_f[4] = {a.a, kSocket ? a.e : a.d, a.d, a.post};
  const uint8_t* const src_b[2] = {a.v, a.b};
  // this lane's row: its first group's first element (of the tensor's),
  // and the elements of that group before the row
  const int64_t first = mine ? row * m / kGroup * kGroup : 0;
  const int lead = mine ? (int)(row * m - first) : 0;
  const int64_t groups = (m + kGroup - 1) / kGroup + 1;  // the most any row spans

  // group i of this lane's row into stage ``buf``, zeros past the tensor
  const auto stage = [&](int buf, int64_t i) {
    const int64_t at = first + i * kGroup;
    const int64_t left = mine ? total - at : 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t rest = left - 4 * c;
      const int n = rest <= 0 ? 0 : rest >= 4 ? 4 : (int)rest;
#pragma unroll
      for (int f = 0; f < kF; ++f)
        copy16_async(&stage_f[buf][f][lane][chunk_at(lane, c)],
                     n > 0 ? src_f[f] + at + 4 * c : src_f[f], 4 * n);
    }
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const int64_t rest = left - 16 * h;
      const int n = rest <= 0 ? 0 : rest >= 16 ? 16 : (int)rest;
#pragma unroll
      for (int f = 0; f < kB; ++f)
        copy16_async(&stage_b[buf][f][lane][half_at(lane, h)],
                     n > 0 ? src_b[f] + at + 16 * h : src_b[f], n);
    }
    copy_commit();
  };

  LaneVec<kSocket ? kLaneWhole : 1, 1> conn;
  LaneVec<EC, 1> wc;
  ShiftRing ring;
  conn.init(a.conn, 0, -kInf);
  wc.init(a.cores, 0);
  ring.init(a.cap);
  const bool cap_on = a.cap >= 0;
  const bool to_on = a.timeout >= 0.0f;
  const float timeout = a.timeout;

  stage(0, 0);
  for (int64_t i = 0; i < groups; ++i) {
    const int buf = (int)(i & 1);
    if (i + 1 < groups) {
      stage(buf ^ 1, i + 1);
    } else {
      copy_commit();  // an empty group: the wait below still means group i
    }
    copy_wait_all_but_one();
    __syncwarp();
    // this row's group: the elements [lo, hi) lie in the row
    const int64_t at = first + i * kGroup;
    const int64_t k0 = i * kGroup - lead;
    const int lo = !mine || k0 >= 0 ? 0 : (int)-k0;
    const int hi = !mine ? 0 : m - k0 >= kGroup ? kGroup : (int)(m - k0);
    uint32_t any = 0;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      const uint4 v = stage_b[buf][0][lane][half_at(lane, h)];
      any |= v.x | v.y | v.z | v.w;
    }
    // the chunk's outputs, 16 bytes of waits and 4 flag bytes, to the
    // row's outputs where the chunk lies in it, else element by element
    const auto store = [&](int c, const float4& w4, uint32_t flw) {
      const int j = 4 * c;
      if (j >= lo && j + 4 <= hi) {
        *reinterpret_cast<float4*>(a.out0 + at + j) = w4;
        *reinterpret_cast<uint32_t*>(a.flag + at + j) = flw;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u >= lo && j + u < hi) {
            a.out0[at + j + u] = lane_of(w4, u);
            a.flag[at + j + u] = (uint8_t)(flw >> (8 * u));
          }
        }
      }
    };
    // kFull walks the chain, else no row has a valid element here and the
    // carry stays
    const auto walk = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll 1
      for (int c = 0; c < kChunks; ++c) {
        const int at4 = chunk_at(lane, c);
        const float4 a4 = stage_f[buf][0][lane][at4];
        const uint32_t vw = reinterpret_cast<const uint32_t*>(
            &stage_b[buf][0][lane][half_at(lane, c / 4)])[c % 4];
        uint32_t flw = 0;
        float4 w4{};
        const float4 e4 = stage_f[buf][kE][lane][at4];
        uint32_t bw = 0xffffffffu;  // mode 4: every element a burst
        if constexpr (kSocket)
          bw = reinterpret_cast<const uint32_t*>(
              &stage_b[buf][kB - 1][lane][half_at(lane, c / 4)])[c % 4];
        float4 d4{}, p4{};
        if constexpr (kFull) {
          d4 = stage_f[buf][kD][lane][at4];
          if constexpr (kSocket) p4 = stage_f[buf][kQ][lane][at4];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * c + u;
          const float ak = lane_of(a4, u);
          const float ek = lane_of(e4, u);
          const bool bk = !kSocket || ((bw >> (8 * u)) & 0xffu) != 0u;
          if constexpr (kFull) {
            const bool ok = j >= lo && j < hi && ((vw >> (8 * u)) & 0xffu) != 0u;
            const float dk = lane_of(d4, u);
            const bool refused = kSocket && ok && conn.first > ak;
            const bool live = ok && !refused;
            const bool shed = live && bk && cap_on && ring.f[0] > ek;
            const float g = fmaxf(ek, wc.first);
            const float wait = bk ? g - ek : 0.0f;
            const bool through = live && bk && !shed;
            const bool ab = through && to_on && wait > timeout;
            if constexpr (kSocket) {
              const float pk = lane_of(p4, u);
              const float exit_t = bk ? (shed ? ek : (ab ? g : (g + dk) + pk)) : ak + pk;
              conn.insert_first(live ? exit_t : conn.first, conn.second(), INFINITY, 0);
            }
            wc.insert_first(through ? g + (ab ? 0.0f : dk) : wc.first, wc.second(),
                            INFINITY, 0);
            ring.push(through, g);
            set_lane(w4, u, wait);
            flw |= ((shed ? 1u : 0u) | (ab ? 2u : 0u) | (refused ? 4u : 0u)) << (8 * u);
          } else {
            set_lane(w4, u, bk ? fmaxf(ek, wc.first) - ek : 0.0f);
          }
        }
        store(c, w4, flw);
      }
    };
    if (__ballot_sync(kAll, hi > lo && any != 0u) != 0u) {
      walk(Flag<true>{});
    } else {
      walk(Flag<false>{});
    }
    __syncwarp();  // the stage is rewritten next group
  }
}

// Launch the lane walk's instance of mode kMode: one core in a register,
// or up to kLaneWhole (two instances a mode keep the library's build time
// down; a narrower vector pads with +inf).
template <int kMode, int EC>
int launch_lane_walk(const StationArgs& a, void* stream) {
  if constexpr (EC == 1) {
    if (a.cores > 1) return launch_lane_walk<kMode, kLaneWhole>(a, stream);
  }
  const int threads = kLanes;
  const int64_t blocks = (a.S + kLanes - 1) / kLanes;
  const auto kernel = lane_walk_kernel<kMode, EC>;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
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

// The walk a launch takes: 0 a block a row in the reference's tree (mode
// 0), 1 one warp a row (mode 3; modes 1, 2, 4 and 5 with both vectors up to
// kWarpWidthMax entries), 2 one thread a row with the carry in global scratch of ram_k +
// cores floats a row (wider; ram_k is the connection cap in mode 5), 3 one
// lane a row (modes 4 and 5 with their ring, cores and, in mode 5,
// connections up to kLaneWhole entries each).
int station_scan_walk(int mode, int cores, int ram_k, int cap) {
  if (mode == 0) return kWalkTree;
  if (mode == 3) return kWalkWarp;
  if ((mode == 4 || (mode == 5 && ram_k <= kLaneWhole)) && cap <= kLaneWhole &&
      cores <= kLaneWhole)
    return kWalkLane;
  const int width = (mode == 2 || mode == 5) && ram_k > cores ? ram_k : cores;
  return width <= kWarpWidthMax ? kWalkWarp : kWalkGlobal;
}

// The widest connection vector, ring and core vector of the lane walk.
int station_scan_lane_whole() { return kLaneWhole; }

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
  const int walk = station_scan_walk(a.mode, a.cores, second, a.cap);
  if (walk == kWalkGlobal && a.scratch == nullptr) return -1;
  if (walk == kWalkLane) {
    // every input and output on a 16-byte boundary
    const uintptr_t at = (uintptr_t)a.a | (uintptr_t)a.e | (uintptr_t)a.d | (uintptr_t)a.post |
                         (uintptr_t)a.v | (uintptr_t)a.b | (uintptr_t)a.out0 | (uintptr_t)a.flag;
    if ((at & 15u) != 0u) return -1;
    return a.mode == 4 ? launch_lane_walk<4, 1>(a, stream) : launch_lane_walk<5, 1>(a, stream);
  }
  if (a.mode == 0) {
    const int threads = kTreeThreads;
    const int64_t blocks = a.S;
    tree_walk_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.mode == 3) {
    const int threads = kWarps * kLanes;
    const int64_t blocks = (a.S + kWarps - 1) / kWarps;
    bucket_warp_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
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
    // the carry in global scratch
    const auto kernel = a.mode == 4 ? control_thread_kernel<4> : control_thread_kernel<5>;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  } else {
    station_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
