// Grouped (per-expert) SwiGLU FFN over the MoE capacity buffer, written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel grouped_ffn_pallas
// (src/repro/kernels/grouped_ffn.py).  Same function:
//   out[e] = (silu(buf[e] . wg[e]) * (buf[e] . wu[e])) . wd[e]
// with buf [E,C,D], wg/wu [E,D,F] and wd [E,F,D], all bf16 or all f32.  g and
// u are accumulated in f32, h = silu(g) * u is kept in f32, h . wd is
// accumulated in f32, and the output is in buf's dtype.  Any C, D and F: the
// ragged edges of every tile are masked (the TPU kernel asserted
// C % 128 == 0 and F % 512 == 0).  A zero row of buf gives an exactly zero
// output row, which the MoE combine relies on.
//
// Bound: memory, at the serving path's shapes.  moonshot-v1-16b-a3b has
// E=64, D=2048, F=1408 in bf16: every call reads all 64 experts' weights
// (1.11e9 bytes) against 6*E*C*D*F operations, 8.9e9 at decode (C=8) and
// 1.9e11 at a prefill with C=168.  At 3.35 TB/s and 989 TFLOP/s the bytes
// bound both (0.33 and 0.36 ms).
//
// Design: form (b), two launches per call.
//   1. gate_up pass: h[e] = silu(buf[e] . wg[e]) * (buf[e] . wu[e]), written
//      as f32 to a workspace [E,C,F] that the wrapper allocates;
//   2. down pass:    out[e] = h[e] . wd[e], written in buf's dtype.
// Both passes are one tiled-product kernel.  A block owns one expert and a
// BM x 64 tile of the output.  It walks the reduction axis in chunks of 32,
// staged in shared memory as f32, and each of its 128 threads keeps a
// (BM/8) x 4 tile of f32 accumulators in registers (two such tiles in the
// gate_up pass, which shares each chunk of buf between wg and wu).  Each
// output's whole reduction stays in one thread, in a fixed order, so the
// result is deterministic and needs no atomics.  BM is 8, 32 or 64, picked
// from C: a decode call (C=8) reads every weight once and computes no
// padded row.  Weight rows are read with 16-byte vector loads when their
// length allows (F, resp. D, a multiple of 8 bf16 or 4 f32 values).  h
// costs E*C*F*4 bytes of device memory traffic each way (2.9 MB at decode),
// small beside the weights.  The products are FMAs in f32 on the CUDA
// cores, so f32 inputs get full f32 (no TF32).  Tensor cores (mma/wgmma),
// TMA and skipping experts that received no rows are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 16 column groups x 8 row groups
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // reduction chunk staged in shared memory
constexpr int kTN = 4;         // output columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [m0, m0+BM) x columns [k0, k0+kBK) of A (row-major, rows of K values)
// into As[k][m] as f32, zero outside [0,M) x [0,K).  Consecutive threads read
// consecutive columns; the odd pitch BM+1 keeps the transposed stores off
// shared bank conflicts.
template <typename TA, int BM>
__device__ __forceinline__ void load_a(const TA* __restrict__ A, int M, int K, int m0, int k0,
                                       float (*As)[BM + 1]) {
  for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
    const int r = i / kBK;
    const int c = i - r * kBK;
    const int gm = m0 + r, gk = k0 + c;
    As[c][r] = (gm < M && gk < K) ? to_f32(A[(size_t)gm * K + gk]) : 0.f;
  }
}

// Rows [k0, k0+kBK) x columns [n0, n0+kBN) of B (row-major, rows of N values)
// into Bs[k][n] as f32, zero outside [0,K) x [0,N).  With vec (N a multiple
// of the 16-byte vector width, and a 16-byte aligned base, which the wrapper
// checks) every vector lies wholly inside or wholly outside the matrix.
template <typename TB>
__device__ __forceinline__ void load_b(const TB* __restrict__ B, int K, int N, int k0, int n0,
                                       bool vec, float (*Bs)[kBN]) {
  constexpr int kVec = 16 / sizeof(TB);  // 8 bf16 or 4 f32 values
  if (vec) {
    constexpr int kPerRow = kBN / kVec;
    for (int i = threadIdx.x; i < kBK * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int c = (i - r * kPerRow) * kVec;
      const int gk = k0 + r, gn = n0 + c;
      float v[kVec];
      if (gk < K && gn < N) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(B + (size_t)gk * N + gn));
        const TB* e = reinterpret_cast<const TB*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = to_f32(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        *reinterpret_cast<float4*>(&Bs[r][c + j]) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i - r * kBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f32(B[(size_t)gk * N + gn]) : 0.f;
    }
  }
}

// One pass over every expert e = blockIdx.z:
//   NB == 2: out[e] = silu(A[e] . B0[e]) * (A[e] . B1[e])   (the gate_up pass)
//   NB == 1: out[e] = A[e] . B0[e]                          (the down pass)
// with A[e] [M,K], B*[e] [K,N] and out[e] [M,N], all row-major.
template <typename TA, typename TB, typename TO, int BM, int NB>
__global__ void __launch_bounds__(kThreads)
grouped_ffn_pass(const TA* __restrict__ A, const TB* __restrict__ B0,
                 const TB* __restrict__ B1, TO* __restrict__ out, int M, int K, int N,
                 int vec) {
  constexpr int kTM = BM / 8;
  __shared__ float As[kBK][BM + 1];
  __shared__ __align__(16) float Bs[NB][kBK][kBN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x & 15;  // columns n0 + tx*kTN ...
  const int ty = threadIdx.x >> 4;  // rows m0 + ty*kTM ...
  A += (size_t)e * M * K;
  B0 += (size_t)e * K * N;
  if constexpr (NB == 2) B1 += (size_t)e * K * N;
  out += (size_t)e * M * N;

  float acc[NB][kTM][kTN];
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[p][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_a<TA, BM>(A, M, K, m0, k0, As);
    load_b<TB>(B0, K, N, k0, n0, vec != 0, Bs[0]);
    if constexpr (NB == 2) load_b<TB>(B1, K, N, k0, n0, vec != 0, Bs[1]);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[k][ty * kTM + i];
#pragma unroll
      for (int p = 0; p < NB; ++p) {
        const float4 b = *reinterpret_cast<const float4*>(&Bs[p][k][tx * kTN]);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          acc[p][i][0] = fmaf(a[i], b.x, acc[p][i][0]);
          acc[p][i][1] = fmaf(a[i], b.y, acc[p][i][1]);
          acc[p][i][2] = fmaf(a[i], b.z, acc[p][i][2]);
          acc[p][i][3] = fmaf(a[i], b.w, acc[p][i][3]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites As / Bs
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (m < M && n < N) {
        float v;
        if constexpr (NB == 2) {
          const float g = acc[0][i][j];
          v = g / (1.f + expf(-g)) * acc[1][i][j];  // silu(g) * u
        } else {
          v = acc[0][i][j];
        }
        out[(size_t)m * N + n] = from_f32<TO>(v);
      }
    }
  }
}

template <typename T, int BM>
int run(const T* buf, const T* wg, const T* wu, const T* wd, float* h, T* out, int E, int C,
        int D, int F, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kThreads);
  const dim3 grid_gu((C + BM - 1) / BM, (F + kBN - 1) / kBN, E);
  grouped_ffn_pass<T, T, float, BM, 2><<<grid_gu, block, 0, stream>>>(
      buf, wg, wu, h, C, D, F, F % kVec == 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_down((C + BM - 1) / BM, (D + kBN - 1) / kBN, E);
  grouped_ffn_pass<float, T, T, BM, 1><<<grid_down, block, 0, stream>>>(
      h, wd, static_cast<const T*>(nullptr), out, C, F, D, D % kVec == 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* buf, const void* wg, const void* wu, const void* wd, void* h, void* out,
           int E, int C, int D, int F, cudaStream_t stream) {
  const T* b = static_cast<const T*>(buf);
  const T* g = static_cast<const T*>(wg);
  const T* u = static_cast<const T*>(wu);
  const T* d = static_cast<const T*>(wd);
  float* hw = static_cast<float*>(h);
  T* o = static_cast<T*>(out);
  if (C <= 8) return run<T, 8>(b, g, u, d, hw, o, E, C, D, F, stream);
  if (C <= 32) return run<T, 32>(b, g, u, d, hw, o, E, C, D, F, stream);
  return run<T, 64>(b, g, u, d, hw, o, E, C, D, F, stream);
}

}  // namespace

extern "C" int repro_grouped_ffn(const void* buf, const void* wg, const void* wu,
                                 const void* wd, void* h, void* out, int E, int C, int D,
                                 int F, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(buf, wg, wu, wd, h, out, E, C, D, F, s);
  return launch<float>(buf, wg, wu, wd, h, out, E, C, D, F, s);
}
