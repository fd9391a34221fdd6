// GQA decode attention over a KV cache, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention.py).  Same function: one query token
// per sequence against its cache, online softmax in f32, scale 1/sqrt(dh),
// optional sliding window len - window <= pos < len, output in v's dtype,
// and 0 for an empty window (the softmax denominator is clamped at 1e-20).
//
// Bound: memory.  The call must read the K and V rows below cache_len[b]
// (inside the window) once, plus q, and write out: at the serving path's
// shapes (llama3.2-1b: Hkv=8, dh=64, bf16, ~150 valid rows, B<=16) that is
// a few MB per call, a few microseconds at 3.35 TB/s, so launch overhead
// dominates a call this small.
//
// Design.  The TPU walked S on a sequential grid axis with (m, l, acc)
// carried in VMEM scratch.  Here one block owns one (batch, kv_head) pair;
// the G = H / Hkv query heads of that kv head share every K/V row the block
// loads, so each row leaves device memory once.  The block loops over the
// valid positions in tiles of kTile rows (the loop replaces the sequential
// grid axis): K and V tiles are staged in shared memory as f32 with 16-byte
// vector loads, every thread computes a few of the G x kTile scores, one warp
// per head folds the tile into the running (m, l), and every thread updates
// a few of the G x dh accumulators.  The loop starts at the window's first
// valid row and stops at cache_len[b], so the padded tail is never read and
// S need not be a multiple of any tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [0, n) of one kv head (row r at src + r * row_stride) into
// shared memory as f32 with row pitch ld = dh + 1 (the odd pitch keeps the
// score loop's column reads on distinct banks).  dh * sizeof(T) is a multiple
// of 16 and src is 16-byte aligned (checked by the Python wrapper).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, size_t row_stride,
                                          float* dst, int n, int dh, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs_per_row = dh / kVec;
  for (int i = threadIdx.x; i < n * vecs_per_row; i += blockDim.x) {
    const int r = i / vecs_per_row;
    const int c = (i - r * vecs_per_row) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * ld + c;
#pragma unroll
    for (int j = 0; j < kVec; ++j) d[j] = to_f32(e[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cache_len,
                        T* __restrict__ out, int S, int H, int Hkv, int dh,
                        int window, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int ld = dh + 1;
  float* k_s = smem;                 // [kTile][ld]
  float* v_s = k_s + kTile * ld;     // [kTile][ld]
  float* q_s = v_s + kTile * ld;     // [G][dh]
  float* acc_s = q_s + G * dh;       // [G][dh]
  float* p_s = acc_s + G * dh;       // [G][kTile]  scores, then probabilities
  float* m_s = p_s + G * kTile;      // [G] running max
  float* l_s = m_s + G;              // [G] running denominator
  float* c_s = l_s + G;              // [G] this tile's rescale factor

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  const int len = cache_len[b];
  const int hi = min(len, S);
  const int lo = window > 0 ? max(len - window, 0) : 0;

  // q [B,1,H,dh]: the G heads of kv head h are contiguous (head = h*G + g)
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * dh;
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  // caches [B,S,Hkv,dh]: row s of head h sits at base + s * Hkv * dh
  const size_t row_stride = (size_t)Hkv * dh;
  const size_t base = ((size_t)b * S * Hkv + h) * dh;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    __syncthreads();  // previous tile's readers are done with k_s/v_s/p_s
    load_tile(k + base + t0 * row_stride, row_stride, k_s, n, dh, ld);
    load_tile(v + base + t0 * row_stride, row_stride, v_s, n, dh, ld);
    __syncthreads();

    for (int i = threadIdx.x; i < G * kTile; i += blockDim.x) {
      const int g = i / kTile;
      const int t = i - g * kTile;
      float s = -INFINITY;
      if (t < n) {
        const float* qr = q_s + g * dh;
        const float* kr = k_s + t * ld;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += nwarps) {
      float* pr = p_s + g * kTile;
      float tmax = -INFINITY;
      for (int t = lane; t < kTile; t += 32) tmax = fmaxf(tmax, pr[t]);
      tmax = warp_max(tmax);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, tmax);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = (pr[t] == -INFINITY) ? 0.f : expf(pr[t] - m_safe);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = (m_old == -INFINITY) ? 0.f : expf(m_old - m_safe);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
      const int g = i / dh;
      const int d = i - g * dh;
      const float* pr = p_s + g * kTile;
      float a = acc_s[i] * c_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], v_s[t * ld + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)h * G) * dh;
  for (int i = threadIdx.x; i < G * dh; i += blockDim.x) {
    ob[i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / dh], 1e-20f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* cache_len, void* out,
           int B, int S, int H, int Hkv, int dh, int window, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t floats = 2 * (size_t)kTile * (dh + 1) + 2 * (size_t)G * dh +
                        (size_t)G * kTile + 3 * (size_t)G;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale = (float)(1.0 / sqrt((double)dh));
  decode_attention_kernel<T><<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      cache_len, static_cast<T*>(out), S, H, Hkv, dh, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* cache_len, void* out, int B, int S,
                                      int H, int Hkv, int dh, int window, int is_bf16,
                                      void* stream) {
  const int* cl = static_cast<const int*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, cl, out, B, S, H, Hkv, dh, window, s);
  return launch<float>(q, k, v, cl, out, B, S, H, Hkv, dh, window, s);
}
