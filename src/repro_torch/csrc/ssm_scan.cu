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
