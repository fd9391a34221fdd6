// GQA decode attention over a KV cache, written by hand for Hopper (sm_90a):
// split-K flash-decoding.
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention.py).  Same function: one query token
// per sequence against its cache, online softmax in f32, scale 1/sqrt(dh),
// optional sliding window len - window <= pos < len, output in v's dtype,
// and 0 for an empty window (the softmax denominator is clamped at 1e-20).
// Two optional extras serve a cache whose sequence is split across ranks: a
// per-slot lower bound start[b] on the rows (the rows are then max(start,
// len - window) <= pos < len, so a shard can state its part of a window in
// its own row numbers), and an f32 output lse[b, head], the log-sum-exp of
// the scaled scores over those rows (-inf for an empty window), from which
// the shards' partial outputs merge.  Both are null on every other call.
//
// Bound: memory, and at short caches latency.  The call must read the K and
// V rows inside [lo, hi) once, plus q, and write out.  At the serving path's
// shapes (llama3.2-1b: B=11, Hkv=8, dh=64, bf16, ~150 valid rows) that is
// 3.3 MB, a microsecond at 3.35 TB/s, so the time is the number of
// dependent memory round trips and the launch.  At a long cache (32k rows)
// it is 0.74 GB and the bytes decide.
//
// Design.  The TPU walked S on a sequential grid axis with (m, l, acc) in
// VMEM.  Here the grid is (b * Hkv + kv_head, split, head group): a split is
// a fixed run of rows_per_split cache rows, picked on the host from B, Hkv
// and S (never from cache_len, which stays on the device) so that a long
// cache fills the 132 SMs several times over, while a short one (at most
// 512 rows) stays one split and needs no merge.  A block whose rows lie
// wholly outside [lo, hi) does no loads.  The G = H / Hkv query heads of a
// kv head (at most kMaxG of them; grid.z covers more) share the block, so
// each K/V row leaves device memory once.
//
// Inside a block every warp works alone: it owns the row tiles warp,
// warp + 4, ... of the block's rows and streams them through its own ring in
// shared memory with 16-byte cp.async copies (rows past the data are
// zero-filled), so all of a short split's loads are in flight at once and a
// long split keeps the next tiles in flight.  The rows stay in their own
// dtype in shared memory.  No __syncthreads falls inside the loop.  At the
// end the four warps' (m, l, acc) are merged in shared memory in warp order.
//
// Two warp kernels share that frame.  bf16 with dh 64, 80 or 128 takes the
// tensor cores (decode_attention_tc, 16-row tiles): q . K^T and P . V are
// mma.sync m16n8k16 with the heads as M, the softmax runs on the
// accumulator fragments and P is fed back as a hi/lo bf16 pair.  f32 (whose
// checks need full f32) and other head widths take the CUDA cores
// (decode_attention_kernel, 8-row tiles): four lanes score a row, the
// tile's softmax runs in registers with shuffles, each lane accumulates
// p . V for its pairs of dims.  At long caches the CUDA-core form is held
// back by its shuffles and shared-memory reads, not by the bytes (PERF.md).
//
// Combine.  With one split the block writes the output.  Otherwise each
// block writes an f32 partial (acc[G][dh], m, l) to a workspace the wrapper
// allocates, and the last block of each (b, kv_head, head group) to arrive
// (an atomic ticket on an int counter, which it resets to 0) merges the
// partials in split order.  No float atomics: the result is the same bits on
// every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;   // rows of one warp tile: four lanes score a row
constexpr int kMaxG = 8;   // query heads one block holds

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

// two neighbouring values of a staged row as f32
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as a bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// STAGES slots per warp: 4, or 2 where four would not fit (f32, dh > 128)
template <typename T, int DJ> __host__ __device__ constexpr int stages_for() {
  return (sizeof(T) == 4 && DJ > 2) ? 2 : 4;
}

// Bytes of shared memory before q: the warps' rings while they stream, then
// the warps' merged states ([kWarps][kMaxG][dh + 2] f32) and the split
// weights ([kMaxG][nsplit] f32 and L[kMaxG]) of the last block's merge.
__host__ __device__ inline int region_bytes(int ring_bytes, int dh, int nsplit) {
  const int merge = (kWarps * kMaxG * (dh + 2) + kMaxG * (nsplit + 1)) * 4;
  return ((ring_bytes > merge ? ring_bytes : merge) + 15) & ~15;
}

// The block's end, after every warp has written its state (acc[dh], m, l
// for each of its heads) to red = smem as [kWarps][kMaxG][dh + 2] and the
// block has synchronised: merge the warps in order; with one split write
// the output, else write this split's partial, and let the last block of
// the (pair, head group) to arrive merge the splits in order.
template <typename T>
__device__ __forceinline__ void merge_and_store(unsigned char* smem, T* __restrict__ out,
                                                float* __restrict__ part,
                                                int* __restrict__ tickets,
                                                float* __restrict__ lse, int* last_block,
                                                int pair, int split, int nsplit, int G, int g0,
                                                int Gb, int b, int h, int H, int dh) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rp = dh + 2;
  float* red = reinterpret_cast<float*>(smem);
  T* ob = out + ((size_t)b * H + (size_t)h * G + g0) * dh;
  for (int i = threadIdx.x; i < Gb * dh; i += kThreads) {
    const int g = i / dh;
    const int d = i - g * dh;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red[(w * kMaxG + g) * rp + dh]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* rw = red + (w * kMaxG + g) * rp;
      const float c = (rw[dh] == -INFINITY) ? 0.f : expf(rw[dh] - M);
      L = fmaf(c, rw[dh + 1], L);
      A = fmaf(c, rw[d], A);
    }
    if (nsplit == 1) {
      ob[i] = from_f32<T>(A / fmaxf(L, 1e-20f));
      if (lse != nullptr && d == 0)
        lse[(size_t)b * H + (size_t)h * G + g0 + g] = L > 0.f ? M + logf(L) : -INFINITY;
    } else {
      float* pp = part + ((size_t)(pair * nsplit + split) * G + g0 + g) * rp;
      pp[d] = A;
      if (d == 0) {
        pp[dh] = M;
        pp[dh + 1] = L;
      }
    }
  }
  if (nsplit == 1) return;

  // the last block of this (pair, head group) merges the splits, in order
  __threadfence();
  __syncthreads();
  int* ticket = tickets + pair * gridDim.z + blockIdx.z;
  if (threadIdx.x == 0) *last_block = atomicAdd(ticket, 1) == nsplit - 1;
  __syncthreads();
  if (!*last_block) return;
  __threadfence();
  // per head: the splits' weights exp(m_s - M) into shared memory (one warp
  // a head, lanes over splits), then every (g, d) sums its splits in order
  const float* p0 = part + (size_t)pair * nsplit * G * rp;
  const size_t sstride = (size_t)G * rp;
  float* wts = red + kWarps * kMaxG * rp;  // [kMaxG][nsplit], then L[kMaxG]
  float* Ls = wts + kMaxG * nsplit;
  for (int g = warp; g < Gb; g += kWarps) {
    const float* pg = p0 + (g0 + g) * rp;
    float M = -INFINITY;
    for (int sp = lane; sp < nsplit; sp += 32) M = fmaxf(M, __ldcg(pg + sp * sstride + dh));
    M = warp_max(M);
    float L = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const float ms = __ldcg(pg + sp * sstride + dh);
      const float c = (ms == -INFINITY) ? 0.f : expf(ms - M);
      wts[g * nsplit + sp] = c;
      L = fmaf(c, __ldcg(pg + sp * sstride + dh + 1), L);
    }
    L = warp_sum(L);
    if (lane == 0) {
      Ls[g] = L;
      if (lse != nullptr)
        lse[(size_t)b * H + (size_t)h * G + g0 + g] = L > 0.f ? M + logf(L) : -INFINITY;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Gb * dh; i += kThreads) {
    const int g = i / dh;
    const int d = i - g * dh;
    const float* pd = p0 + (g0 + g) * rp + d;
    const float* wg = wts + g * nsplit;
    float A = 0.f;
    int sp = 0;
    for (; sp + 4 <= nsplit; sp += 4) {  // four loads in flight
      const float a0 = __ldcg(pd + sp * sstride);
      const float a1 = __ldcg(pd + (sp + 1) * sstride);
      const float a2 = __ldcg(pd + (sp + 2) * sstride);
      const float a3 = __ldcg(pd + (sp + 3) * sstride);
      A = fmaf(wg[sp], a0, A);
      A = fmaf(wg[sp + 1], a1, A);
      A = fmaf(wg[sp + 2], a2, A);
      A = fmaf(wg[sp + 3], a3, A);
    }
    for (; sp < nsplit; ++sp) A = fmaf(wg[sp], __ldcg(pd + sp * sstride), A);
    ob[i] = from_f32<T>(A / fmaxf(Ls[g], 1e-20f));
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// DJ = ceil(dh / 64): the dim pairs of the accumulator each lane owns
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ cache_len,
                        const int* __restrict__ start, T* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ tickets,
                        float* __restrict__ lse, int S, int H, int Hkv, int dh, int window,
                        int rows_per_split, float scale) {
  constexpr int STAGES = stages_for<T, DJ>();
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;

  const int G = H / Hkv;
  const int pair = blockIdx.x;  // b * Hkv + kv head
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int g0 = blockIdx.z * kMaxG;
  const int Gb = min(kMaxG, G - g0);
  const int b = pair / Hkv;
  const int h = pair - b * Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int pitch = dh * (int)sizeof(T) + 16;  // staged row, padded off bank conflicts
  const int nc = dh / kVec;                    // 16-byte chunks of a row
  const int slot_bytes = 2 * kRows * pitch;    // K rows then V rows
  unsigned char* ring = smem + (size_t)warp * STAGES * slot_bytes;
  float* q_s = reinterpret_cast<float*>(smem + region_bytes(STAGES * kWarps * slot_bytes, dh, nsplit));

  const int len = cache_len[b];
  const int hi = min(len, S);
  int lo = window > 0 ? max(len - window, 0) : 0;
  if (start != nullptr) lo = max(lo, start[b]);
  const int rs = max(lo, split * rows_per_split);
  const int re = min(hi, (split + 1) * rows_per_split);
  const int ntiles = rs < re ? (re - rs + kRows - 1) / kRows : 0;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;

  const T* qb = q + ((size_t)b * H + (size_t)h * G + g0) * dh;
  for (int i = threadIdx.x; i < Gb * dh; i += kThreads) q_s[i] = to_f32(qb[i]);

  // caches [B,S,Hkv,dh]: row s of kv head h sits at base + s * Hkv * dh
  const size_t row_stride = (size_t)Hkv * dh;
  const T* kb = k + ((size_t)b * S * Hkv + h) * dh;
  const T* vb = v + ((size_t)b * S * Hkv + h) * dh;

  // this warp's local tile i (global tile warp + 4 i) into slot i % STAGES
  auto fetch = [&](int i) {
    if (i < mine) {
      const int t0 = rs + (warp + i * kWarps) * kRows;
      unsigned char* slot = ring + (size_t)(i % STAGES) * slot_bytes;
      for (int c = lane; c < 2 * kRows * nc; c += 32) {
        const int kv = c / (kRows * nc);
        const int rem = c - kv * kRows * nc;
        const int r = rem / nc;
        const int ch = rem - r * nc;
        const bool ok = t0 + r < re;
        const T* src = (kv ? vb : kb) + (ok ? (size_t)(t0 + r) * row_stride : 0) + ch * kVec;
        cp_async16(slot + (kv * kRows + r) * pitch + ch * 16, src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) fetch(i);
  __syncthreads();  // q_s

  // lane owns the dim pairs d = 2 * lane + 64 * j, j < DJ
  float m[kMaxG], l[kMaxG], acc[kMaxG][DJ][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[g][j][0] = acc[g][j][1] = 0.f;
  }

  const int row = lane >> 2;   // the tile row this lane scores
  const int quarter = lane & 3;
  const int cpq = (nc + 3) / 4;
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    fetch(i + STAGES - 1);  // into the slot read in iteration i - 1
    const unsigned char* slot = ring + (size_t)(i % STAGES) * slot_bytes;
    const int t0 = rs + (warp + i * kWarps) * kRows;

    // scores: four lanes a row, a quarter of dh each
    float p[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) p[g] = 0.f;
    const unsigned char* krow = slot + row * pitch;
    for (int j = 0; j < cpq; ++j) {
      const int ch = quarter * cpq + j;
      if (ch < nc) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + ch * 16);
        const T* e = reinterpret_cast<const T*>(&raw);
        float kf[kVec];
#pragma unroll
        for (int x = 0; x < kVec; ++x) kf[x] = to_f32(e[x]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < Gb) {
            const float4* qr = reinterpret_cast<const float4*>(q_s + g * dh + ch * kVec);
#pragma unroll
            for (int x = 0; x < kVec / 4; ++x) {
              const float4 qv = qr[x];
              p[g] = fmaf(qv.x, kf[4 * x], p[g]);
              p[g] = fmaf(qv.y, kf[4 * x + 1], p[g]);
              p[g] = fmaf(qv.z, kf[4 * x + 2], p[g]);
              p[g] = fmaf(qv.w, kf[4 * x + 3], p[g]);
            }
          }
        }
      }
    }

    // the tile's softmax in registers: p[g] becomes this row's probability
    const bool valid = t0 + row < re;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < Gb) {
        float sg = p[g];
        sg += __shfl_xor_sync(0xffffffffu, sg, 1);
        sg += __shfl_xor_sync(0xffffffffu, sg, 2);
        sg = valid ? sg * scale : -INFINITY;
        float mx = sg;
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[g], mx);  // finite: row t0 is valid
        p[g] = valid ? expf(sg - m_new) : 0.f;
        float ps = p[g];
        ps += __shfl_xor_sync(0xffffffffu, ps, 4);
        ps += __shfl_xor_sync(0xffffffffu, ps, 8);
        ps += __shfl_xor_sync(0xffffffffu, ps, 16);
        const float corr = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
        l[g] = l[g] * corr + ps;
        m[g] = m_new;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc[g][j][0] *= corr;
          acc[g][j][1] *= corr;
        }
      }
    }

    // p . V: each V row is read once, as one pair a lane per j
    const unsigned char* vrows = slot + kRows * pitch;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float2 vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = 2 * lane + 64 * j;
        vv[j] = d < dh ? load_pair(reinterpret_cast<const T*>(vrows + r * pitch) + d)
                       : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < Gb) {
          const float pr = __shfl_sync(0xffffffffu, p[g], r * 4);
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc[g][j][0] = fmaf(pr, vv[j].x, acc[g][j][0]);
            acc[g][j][1] = fmaf(pr, vv[j].y, acc[g][j][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it below

  // merge the four warps' states, in warp order
  const int rp = dh + 2;  // acc[dh], m, l
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][kMaxG][rp]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < Gb) {
      float* rw = red + (warp * kMaxG + g) * rp;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = 2 * lane + 64 * j;
        if (d < dh) {
          rw[d] = acc[g][j][0];
          rw[d + 1] = acc[g][j][1];
        }
      }
      if (lane == 0) {
        rw[dh] = m[g];
        rw[dh + 1] = l[g];
      }
    }
  }
  __syncthreads();
  merge_and_store<T>(smem, out, part, tickets, lse, &last_block, pair, split, nsplit, G, g0, Gb, b,
                     h, H, dh);
}

template <typename T, int DJ>
int run(const void* q, const void* k, const void* v, const int* cache_len, const int* start,
        void* out, float* part, int* tickets, float* lse, int B, int S, int H, int Hkv, int dh,
        int window, int splits, int rows_per_split, cudaStream_t stream) {
  constexpr int STAGES = stages_for<T, DJ>();
  const int pitch = dh * (int)sizeof(T) + 16;
  const size_t smem =
      region_bytes(kWarps * STAGES * 2 * kRows * pitch, dh, splits) + (size_t)kMaxG * dh * 4;
  auto kernel = decode_attention_kernel<T, DJ>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = H / Hkv;
  const dim3 grid(B * Hkv, splits, (G + kMaxG - 1) / kMaxG);
  const float scale = (float)(1.0 / sqrt((double)dh));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), cache_len,
      start, static_cast<T*>(out), part, tickets, lse, S, H, Hkv, dh, window, rows_per_split,
      scale);
  return (int)cudaGetLastError();
}

// The bf16 path for dh 64, 80 and 128: the same grid, rings and
// merge, with both products on the tensor cores.  A warp tile is 16 cache
// rows.  S = q . K^T is mma m16n8k16 with the block's heads as M (rows past
// Gb zero), the tile's rows as N and dh as K (q's fragments stay in
// registers, K's come by ldmatrix); the softmax runs on the accumulator
// fragments (two shuffles per reduction); P . V is m16n8k16 with P as the A
// operand straight from those registers, as a hi/lo bf16 pair (about 16
// mantissa bits of the f32 p), and V by ldmatrix.trans.
constexpr int kTcRows = 16;
constexpr int kTcStages = 3;

__host__ __device__ constexpr int tc_pitch(int dh) { return dh * 2 + 16; }

template <int KS>  // KS = dh / 16
__global__ void __launch_bounds__(kThreads)
decode_attention_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ cache_len,
                    const int* __restrict__ start, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets,
                    float* __restrict__ lse, int S, int H, int Hkv, int window,
                    int rows_per_split, float scale) {
  constexpr int dh = 16 * KS;
  constexpr int kPitch = tc_pitch(dh);
  constexpr int kNC = dh / 8;                    // 16-byte chunks of a row
  constexpr int kSlot = 2 * kTcRows * kPitch;    // K rows then V rows
  constexpr int kND = dh / 8;                    // 8-dim tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;

  const int G = H / Hkv;
  const int pair = blockIdx.x;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int g0 = blockIdx.z * kMaxG;
  const int Gb = min(kMaxG, G - g0);
  const int b = pair / Hkv;
  const int h = pair - b * Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  unsigned char* ring = smem + (size_t)warp * kTcStages * kSlot;
  // q's [16][kPitch] tile borrows the last warp's last slot, which no copy
  // touches until every warp holds its q fragments
  unsigned char* q_s = smem + (size_t)(kWarps * kTcStages - 1) * kSlot;

  const int len = cache_len[b];
  const int hi = min(len, S);
  int lo = window > 0 ? max(len - window, 0) : 0;
  if (start != nullptr) lo = max(lo, start[b]);
  const int rs = max(lo, split * rows_per_split);
  const int re = min(hi, (split + 1) * rows_per_split);
  const int ntiles = rs < re ? (re - rs + kTcRows - 1) / kTcRows : 0;
  const int mine = ntiles > warp ? (ntiles - warp + kWarps - 1) / kWarps : 0;

  // q's 16 x dh bf16 tile, rows past the block's heads zero
  const __nv_bfloat16* qb = q + ((size_t)b * H + (size_t)h * G + g0) * dh;
  for (int i = threadIdx.x; i < 16 * kNC; i += kThreads) {
    const int r = i / kNC, ch = i - (i / kNC) * kNC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < Gb) val = *reinterpret_cast<const uint4*>(qb + r * dh + ch * 8);
    *reinterpret_cast<uint4*>(q_s + r * kPitch + ch * 16) = val;
  }

  const size_t row_stride = (size_t)Hkv * dh;
  const __nv_bfloat16* kb = k + ((size_t)b * S * Hkv + h) * dh;
  const __nv_bfloat16* vb = v + ((size_t)b * S * Hkv + h) * dh;
  auto fetch = [&](int i) {
    if (i < mine) {
      const int t0 = rs + (warp + i * kWarps) * kTcRows;
      unsigned char* slot = ring + (size_t)(i % kTcStages) * kSlot;
      for (int c = lane; c < 2 * kTcRows * kNC; c += 32) {
        const int kv = c / (kTcRows * kNC);
        const int rem = c - kv * kTcRows * kNC;
        const int r = rem / kNC;
        const int ch = rem - r * kNC;
        const bool ok = t0 + r < re;
        const __nv_bfloat16* src =
            (kv ? vb : kb) + (ok ? (size_t)(t0 + r) * row_stride : 0) + ch * 8;
        cp_async16(slot + (kv * kTcRows + r) * kPitch + ch * 16, src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) fetch(i);
  __syncthreads();  // q_s

  // ldmatrix addressing: this lane gives row lane % 8 of matrix lane / 8
  const int mi = lane >> 3, mr = lane & 7;
  uint32_t qa[KS][4];  // A fragments of q: (heads 0-7 | 8-15) x (k 0-7 | 8-15)
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qa[ks], smem_u32(q_s + ((mi & 1) * 8 + mr) * kPitch + (ks * 2 + (mi >> 1)) * 16));
  __syncthreads();  // q_s is a ring slot again

  // this lane's head g = lane / 4 (rows g + 8 are padding); its accumulator
  // columns 2t, 2t + 1 of each 8-wide tile
  const int t = lane & 3;
  float m = -INFINITY, l = 0.f;
  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kTcStages - 2>();
    __syncwarp();
    fetch(i + kTcStages - 1);
    const unsigned char* krows = ring + (size_t)(i % kTcStages) * kSlot;
    const unsigned char* vrows = krows + kTcRows * kPitch;
    const int t0 = rs + (warp + i * kWarps) * kTcRows;

    // S = q . K^T over the tile's 16 rows: two 8-row tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4];  // (rows 0-7 | 8-15) x (k 0-7 | 8-15) as B fragments
      ldmatrix_x4(kf, smem_u32(krows + ((mi >> 1) * 8 + mr) * kPitch + (ks * 2 + (mi & 1)) * 16));
      mma_bf16(sc[0], qa[ks], kf[0], kf[1]);
      mma_bf16(sc[1], qa[ks], kf[2], kf[3]);
    }

    // the tile's softmax for head g: rows 2t, 2t + 1, 8 + 2t, 9 + 2t
    float s4[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = t0 + (j >> 1) * 8 + 2 * t + (j & 1);
      s4[j] = r < re ? s4[j] * scale : -INFINITY;
      mx = fmaxf(mx, s4[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);  // finite: row t0 is valid
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s4[j] = s4[j] == -INFINITY ? 0.f : expf(s4[j] - m_new);
      ps += s4[j];
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    const float corr = (m == -INFINITY) ? 0.f : expf(m - m_new);
    l = l * corr + ps;
    m = m_new;

    // P . V: P (heads x 16 rows) as hi and lo bf16 A fragments
    uint32_t ph[4], pl[4];
    ph[0] = pack_bf16(s4[0], s4[1]);
    ph[2] = pack_bf16(s4[2], s4[3]);
    ph[1] = ph[3] = pl[1] = pl[3] = 0u;  // heads 8-15: padding
    {
      const __nv_bfloat162 h0 = *reinterpret_cast<const __nv_bfloat162*>(&ph[0]);
      const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&ph[2]);
      pl[0] = pack_bf16(s4[0] - __low2float(h0), s4[1] - __high2float(h0));
      pl[2] = pack_bf16(s4[2] - __low2float(h2), s4[3] - __high2float(h2));
    }
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= corr;
      o[nd][1] *= corr;
    }
#pragma unroll
    for (int nd = 0; nd < kND; nd += 2) {
      uint32_t vf[4];  // (rows 0-7 | 8-15) x (dims nd | nd + 1) as B fragments
      ldmatrix_x4_trans(vf, smem_u32(vrows + ((mi & 1) * 8 + mr) * kPitch + (nd + (mi >> 1)) * 16));
      mma_bf16(o[nd], ph, vf[0], vf[1]);
      mma_bf16(o[nd], pl, vf[0], vf[1]);
      mma_bf16(o[nd + 1], ph, vf[2], vf[3]);
      mma_bf16(o[nd + 1], pl, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it below

  const int rp = dh + 2;
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][kMaxG][rp]
  const int g = lane >> 2;
  if (g < Gb) {
    float* rw = red + (warp * kMaxG + g) * rp;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      rw[nd * 8 + 2 * t] = o[nd][0];
      rw[nd * 8 + 2 * t + 1] = o[nd][1];
    }
    if (t == 0) {
      rw[dh] = m;
      rw[dh + 1] = l;
    }
  }
  __syncthreads();
  merge_and_store<__nv_bfloat16>(smem, out, part, tickets, lse, &last_block, pair, split, nsplit,
                                 G, g0, Gb, b, h, H, dh);
}

template <int KS>
int run_tc(const void* q, const void* k, const void* v, const int* cache_len, const int* start,
           void* out, float* part, int* tickets, float* lse, int B, int S, int H, int Hkv,
           int window, int splits, int rows_per_split, cudaStream_t stream) {
  constexpr int dh = 16 * KS;
  const size_t smem = region_bytes(kWarps * kTcStages * 2 * kTcRows * tc_pitch(dh), dh, splits);
  auto kernel = decode_attention_tc<KS>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int G = H / Hkv;
  const dim3 grid(B * Hkv, splits, (G + kMaxG - 1) / kMaxG);
  const float scale = (float)(1.0 / sqrt((double)dh));
  typedef __nv_bfloat16 bf;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                           static_cast<const bf*>(v), cache_len, start,
                                           static_cast<bf*>(out), part, tickets, lse, S, H,
                                           Hkv, window, rows_per_split, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* cl, const int* st, void* out,
           float* part, int* tickets, float* lse, int B, int S, int H, int Hkv, int dh, int window,
           int splits, int rows, cudaStream_t s) {
  if (dh <= 64)
    return run<T, 1>(q, k, v, cl, st, out, part, tickets, lse, B, S, H, Hkv, dh, window, splits,
                     rows, s);
  if (dh <= 128)
    return run<T, 2>(q, k, v, cl, st, out, part, tickets, lse, B, S, H, Hkv, dh, window, splits,
                     rows, s);
  return run<T, 4>(q, k, v, cl, st, out, part, tickets, lse, B, S, H, Hkv, dh, window, splits,
                   rows, s);
}

}  // namespace

// start and lse may be null (no lower bound, no log-sum-exp output)
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* cache_len, const void* start, void* out,
                                      void* part, void* tickets, void* lse, int B, int S, int H,
                                      int Hkv, int dh, int window, int splits,
                                      int rows_per_split, int is_bf16, void* stream) {
  const int* cl = static_cast<const int*>(cache_len);
  const int* st = static_cast<const int*>(start);
  float* p = static_cast<float*>(part);
  int* t = static_cast<int*>(tickets);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (dh) {  // the tensor-core path: dh 64, 80 or 128
      case 64:
        return run_tc<4>(q, k, v, cl, st, out, p, t, ls, B, S, H, Hkv, window, splits,
                         rows_per_split, s);
      case 80:
        return run_tc<5>(q, k, v, cl, st, out, p, t, ls, B, S, H, Hkv, window, splits,
                         rows_per_split, s);
      case 128:
        return run_tc<8>(q, k, v, cl, st, out, p, t, ls, B, S, H, Hkv, window, splits,
                         rows_per_split, s);
      default: break;
    }
    return launch<__nv_bfloat16>(q, k, v, cl, st, out, p, t, ls, B, S, H, Hkv, dh, window,
                                 splits, rows_per_split, s);
  }
  return launch<float>(q, k, v, cl, st, out, p, t, ls, B, S, H, Hkv, dh, window, splits,
                       rows_per_split, s);
}
