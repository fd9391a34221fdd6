// Mamba-1 selective-scan recurrence, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ssm_scan_pallas
// (src/repro/kernels/ssm_scan.py).  Same function: over the sequence axis of
// decay/bx [B,S,di,N] (f32), h_t = decay_t * h_{t-1} + bx_t from h0 [B,di,N];
// h_all [B,S,di,N] holds every state and h_last [B,di,N] the last, both f32.
//
// Bound: memory.  The call must read decay and bx (4*B*S*di*N bytes each)
// and h0, and write h_all and h_last; it does two flops per element.  At
// falcon-mamba-7b's prefill in the auxiliary group (B=11, S=128, di=8192,
// N=16) that is 2.23 GB, 0.665 ms at 3.35 TB/s.
//
// Design.  The TPU carried h in VMEM across a sequential grid axis over S
// and ran a Blelloch scan inside each 128-row block, because its vector
// unit wants wide data-parallel stages and it asserted S % 128 == 0 and
// di % 256 == 0.  Hopper has no order between blocks but plenty of lanes:
// the B*di*N channels are independent, so one thread owns V consecutive
// channels (a float4 where di*N allows it) and walks S with h in registers.
// There is no carry between blocks and no scan tree.  Lanes run along the
// contiguous di*N axis, so every step's loads and stores are coalesced.  The
// loads of kUnroll steps start before their arithmetic, so that each thread
// keeps several loads in flight rather than one: at B=2 there are few
// threads per SM to hide the memory latency with.  Any S, di and N work; the
// last vector is masked.
//
// The update is __fadd_rn(__fmul_rn(d, h), x): no FMA contraction, so the
// kernel rounds exactly as the plain version (a multiply, then an add) and
// matches it bit for bit.
//
// Backward (repro_ssm_scan_bwd).  The TPU had no kernel for it: JAX
// differentiates its reverse associative scan in XLA.  Given G = dL/dh_all
// and g = dL/dh_last (either may be absent), the adjoint lam of the state
// runs backward over S:
//   lam_{S-1} = G_{S-1} + g,   lam_t = G_t + decay_{t+1} * lam_{t+1},
//   d_bx_t = lam_t,   d_decay_t = lam_t * h_{t-1} (h_{-1} = h0),
//   d_h0 = decay_0 * lam_0.
// Same layout as the forward: one thread walks S backward for a float4 of
// channels with lam in registers, each step's loads kUnroll steps ahead,
// no FMA contraction (matches ssm_scan_bwd_ref bit for bit).  Bound:
// memory, 20 bytes an element (reads decay, h_all and G, writes d_decay
// and d_bx); at falcon-mamba-7b's train chunk [2,256,8192,16] 1.34 GB,
// 0.401 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ float step(float d, float h, float x) {
  return __fadd_rn(__fmul_rn(d, h), x);
}

__device__ __forceinline__ float4 step(float4 d, float4 h, float4 x) {
  return make_float4(step(d.x, h.x, x.x), step(d.y, h.y, x.y), step(d.z, h.z, x.z),
                     step(d.w, h.w, x.w));
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float4 mul(float4 a, float4 b) {
  return make_float4(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z), mul(a.w, b.w));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z), add(a.w, b.w));
}
template <typename Vec> __device__ __forceinline__ Vec splat(float v);
template <> __device__ __forceinline__ float splat<float>(float v) { return v; }
template <> __device__ __forceinline__ float4 splat<float4>(float v) {
  return make_float4(v, v, v, v);
}

// One thread per vector of V channels of one batch row; blockIdx.y = b.
// n_vec = di*N / V vectors per sequence position.
template <typename Vec>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const Vec* __restrict__ decay, const Vec* __restrict__ bx,
                const Vec* __restrict__ h0, Vec* __restrict__ h_all,
                Vec* __restrict__ h_last, int S, int n_vec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const size_t b = blockIdx.y;
  const size_t row = (size_t)n_vec;
  const size_t base = b * (size_t)S * row + i;
  const Vec* dp = decay + base;
  const Vec* xp = bx + base;
  Vec* hp = h_all + base;
  Vec h = h0[b * row + i];
  for (int s0 = 0; s0 < S; s0 += kUnroll) {
    Vec d[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u < S) {
        d[u] = dp[(size_t)(s0 + u) * row];
        x[u] = xp[(size_t)(s0 + u) * row];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u < S) {
        h = step(d[u], h, x[u]);
        hp[(size_t)(s0 + u) * row] = h;
      }
    }
  }
  h_last[b * row + i] = h;
}

template <typename Vec>
int launch(const void* decay, const void* bx, const void* h0, void* h_all, void* h_last,
           int B, int S, int n_vec, cudaStream_t stream) {
  const dim3 grid((n_vec + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<Vec><<<grid, kThreads, 0, stream>>>(
      static_cast<const Vec*>(decay), static_cast<const Vec*>(bx),
      static_cast<const Vec*>(h0), static_cast<Vec*>(h_all), static_cast<Vec*>(h_last), S,
      n_vec);
  return (int)cudaGetLastError();
}

// The backward walk; G and g may be null (no gradient reached that output).
template <typename Vec>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const Vec* __restrict__ decay, const Vec* __restrict__ h_all,
                    const Vec* __restrict__ h0, const Vec* __restrict__ G,
                    const Vec* __restrict__ g, Vec* __restrict__ d_decay,
                    Vec* __restrict__ d_bx, Vec* __restrict__ d_h0, int S, int n_vec) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  const size_t b = blockIdx.y;
  const size_t row = (size_t)n_vec;
  const size_t base = b * (size_t)S * row + i;
  const Vec* dp = decay + base;
  const Vec* hp = h_all + base;
  const Vec* gp = G ? G + base : nullptr;
  Vec* ddp = d_decay + base;
  Vec* dbp = d_bx + base;
  const Vec h_init = h0[b * row + i];
  Vec lam = g ? g[b * row + i] : splat<Vec>(0.f);
  Vec dnext = splat<Vec>(1.f);  // decay_{t+1}; 1 at t = S-1 (1 * lam is exact)
  for (int s0 = S - 1; s0 >= 0; s0 -= kUnroll) {
    Vec d[kUnroll], hprev[kUnroll], gs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 - u;
      if (s >= 0) {
        d[u] = dp[(size_t)s * row];
        hprev[u] = s > 0 ? hp[(size_t)(s - 1) * row] : h_init;
        if (gp) gs[u] = gp[(size_t)s * row];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 - u;
      if (s >= 0) {
        lam = gp ? add(gs[u], mul(dnext, lam)) : mul(dnext, lam);
        dbp[(size_t)s * row] = lam;
        ddp[(size_t)s * row] = mul(lam, hprev[u]);
        dnext = d[u];
      }
    }
  }
  d_h0[b * row + i] = mul(dnext, lam);
}

template <typename Vec>
int launch_bwd(const void* decay, const void* h_all, const void* h0, const void* G,
               const void* g, void* d_decay, void* d_bx, void* d_h0, int B, int S,
               int n_vec, cudaStream_t stream) {
  const dim3 grid((n_vec + kThreads - 1) / kThreads, B);
  ssm_scan_bwd_kernel<Vec><<<grid, kThreads, 0, stream>>>(
      static_cast<const Vec*>(decay), static_cast<const Vec*>(h_all),
      static_cast<const Vec*>(h0), static_cast<const Vec*>(G), static_cast<const Vec*>(g),
      static_cast<Vec*>(d_decay), static_cast<Vec*>(d_bx), static_cast<Vec*>(d_h0), S, n_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// channels = di * N.  Every pointer is 16-byte aligned (the wrapper checks),
// so float4 vectors are taken whenever channels % 4 == 0.
extern "C" int repro_ssm_scan(const void* decay, const void* bx, const void* h0, void* h_all,
                              void* h_last, int B, int S, int channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels % 4 == 0)
    return launch<float4>(decay, bx, h0, h_all, h_last, B, S, channels / 4, s);
  return launch<float>(decay, bx, h0, h_all, h_last, B, S, channels, s);
}

// The backward: G (dL/dh_all) and g (dL/dh_last) may be null.  Same
// alignment contract as the forward.
extern "C" int repro_ssm_scan_bwd(const void* decay, const void* h_all, const void* h0,
                                  const void* G, const void* g, void* d_decay, void* d_bx,
                                  void* d_h0, int B, int S, int channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels % 4 == 0)
    return launch_bwd<float4>(decay, h_all, h0, G, g, d_decay, d_bx, d_h0, B, S,
                              channels / 4, s);
  return launch_bwd<float>(decay, h_all, h0, G, g, d_decay, d_bx, d_h0, B, S, channels, s);
}
