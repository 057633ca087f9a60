// The scan fast path's per-lane draws on Hopper (sm_90a).
//
// Replaces the XLA draws of the reference's fast path
// (asyncflow_tpu/engines/jaxsim/fastpath.py): jax.random.uniform /
// jax.random.normal over (n,) lanes and the fused dropout + delay hop of
// _edge_hop (:818) and _edge_hop_dyn (:855).  XLA materialises every
// threefry round of such a draw; here one thread computes one lane of one
// scenario end to end and writes only the result.
//
// Lane i of a scenario's stream is threefry2x32 of the counter (0, i)
// under the stream's key, its 32 bits the two output words XORed; the
// uniform is bitcast((bits >> 9) | 0x3f800000) - 1.  A hop drops the lane
// where u < p and draws its delay from (u - p) / max(1 - p, TINY); a
// normal or lognormal law reads z = sqrt(2) erfinv(u') from the z stream,
// u' uniform on [nextafter(-1, 0), 1), with XLA's float32 erfinv
// polynomial.  Built with --fmad=false so that every float operation
// rounds as the plain PyTorch version's does.
//
// Bound: operations.  A lane costs one threefry block (two with a normal
// law) of about 85 integer operations and a few float ones, against 4-9
// bytes written: at the card's int32 rate (132 SMs x 64 lanes a clock) a
// block is ~5x its bytes' time at 3.35 TB/s.  The design keeps every
// intermediate in registers; lanes of a scenario are consecutive threads,
// so stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

struct EdgeDrawArgs {
  const int32_t* ukey;   // (S, 2) key words of the uniform stream, or null (u_in)
  const int32_t* zkey;   // (S, 2) key words of the normal stream, or null
  const float* u_in;     // (S, n) given uniforms, or null
  const int32_t* eidx;   // (S, n) each lane's edge, or null (static edge)
  const float* mean;     // (S, NE)
  const float* var;      // (S, NE)
  const float* drop;     // (S, NE)
  const int32_t* dist;   // (NE,) delay law of each edge
  float* u_out;          // (S, n) uniforms (mode 0)
  uint8_t* dropped;      // (S, n) (mode 1)
  float* delay;          // (S, n) (mode 1)
  int64_t S;
  int64_t n;
  int32_t NE;
  int32_t edge;  // the static edge, or -1 with eidx
  int32_t mode;  // 0: uniforms; 1: edge hop
};

namespace {

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

__device__ __forceinline__ float uniform_of(const int32_t* key, int64_t s, int64_t i) {
  const uint32_t bits = threefry_bits((uint32_t)key[2 * s], (uint32_t)key[2 * s + 1], 0u,
                                      (uint32_t)i);
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
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

__device__ __forceinline__ float normal_of(const int32_t* key, int64_t s, int64_t i) {
  const float lo = -0.99999994f;  // nextafter(-1, 0)
  const float u = fmaxf(uniform_of(key, s, i) * 2.0f + lo, lo);
  return 1.41421354f * erfinv_xla(u);
}

__global__ void edge_draws_kernel(EdgeDrawArgs a) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.S * a.n) return;
  const int64_t s = idx / a.n;
  const int64_t i = idx - s * a.n;
  const float u = a.u_in != nullptr ? a.u_in[idx] : uniform_of(a.ukey, s, i);
  if (a.mode == 0) {
    a.u_out[idx] = u;
    return;
  }
  const int e = a.eidx != nullptr ? a.eidx[idx] : a.edge;
  const int64_t pe = s * a.NE + e;
  const float p = a.drop[pe];
  const float m = a.mean[pe];
  const int law = a.dist[e];
  const float u_lat = (u - p) / fmaxf(1.0f - p, kTiny);
  float d;
  if (law == kUniform) {
    d = u_lat;
  } else if (law == kExponential) {
    d = -m * logf(fmaxf(1.0f - u_lat, kTiny));
  } else {
    const float z = normal_of(a.zkey, s, i);
    const float x = m + a.var[pe] * z;
    d = law == kNormal ? fmaxf(x, 0.0f) : expf(x);
  }
  a.dropped[idx] = u < p ? 1 : 0;
  a.delay[idx] = d;
}

}  // namespace

extern "C" {

int edge_draws_args_size() { return (int)sizeof(EdgeDrawArgs); }

// Launch on ``stream``; returns the launch's cudaError_t (0 on success),
// or -1 for arguments the kernel does not take.
int edge_draws_launch(const EdgeDrawArgs* args, void* stream) {
  const EdgeDrawArgs a = *args;
  if (a.S <= 0 || a.n <= 0 || a.n > 0xFFFFFFFFll) return -1;
  if (a.mode == 0 && (a.u_out == nullptr || a.ukey == nullptr)) return -1;
  if (a.mode == 1) {
    if (a.dropped == nullptr || a.delay == nullptr || a.mean == nullptr ||
        a.var == nullptr || a.drop == nullptr || a.dist == nullptr)
      return -1;
    if ((a.ukey == nullptr) == (a.u_in == nullptr)) return -1;
    if ((a.eidx == nullptr) == (a.edge < 0)) return -1;
  }
  if (a.mode != 0 && a.mode != 1) return -1;
  const int threads = 256;
  const int64_t blocks = (a.S * a.n + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFll) return -1;
  edge_draws_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
