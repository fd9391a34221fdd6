// Multi-head latent attention (MLA) decode over a latent cache, written by
// hand for Hopper (sm_90a): split-K flash decoding with all the query heads
// of a slot reading each latent row once.
//
// Replaces no Pallas kernel: the JAX package has no latent attention.  The
// port's plain version is repro_torch/kernels/ref.py:mla_decode_attention_ref.
// The function: the absorbed query of each slot, q [B,H,576] (the query
// without rope multiplied into the 512-wide latent through the key
// expansion, then the rope part), against that slot's first len[b] rows of
// the latent cache [B,S,576] (the RMS-normed latent, then the rope'd key
// part), the caller's softmax scale (1/sqrt(192), the expanded head's), and
// V = each row's first 512 values: out [B,H,512] in bf16, 0 for an empty
// slot (the denominator is clamped at 1e-20).
//
// Precision: q . row takes the bf16 operands with f32 accumulation, the
// online softmax runs in f32 and P enters P . V as a hi/lo bf16 pair (about
// 16 mantissa bits of the f32 p) with f32 accumulation, as the
// prefill_attention and decode_attention kernels do.
//
// Bound: memory.  A decode step must read every slot's rows below its
// length once: 1,152 bytes a row-layer.  At 64 slots of 7,200 rows that is
// 531 MB a layer, 158 us at 3.35 TB/s, against 15.0 GFLOP of tensor-core
// work (2 x 16 x (576 + 512) a row; 30 GFLOP with the hi/lo P . V), 30 us at
// 989 TFLOP/s (kernels/costs.py:mla_decode_attention).
//
// Design.  The grid is (split, slot): a split is a run of rows_per_split
// rows, chosen on the host from B and S alone (the lengths stay on the
// device), so that the blocks fill the 132 SMs several times over.  A block
// of four warps streams its split's rows in 32-row tiles through a
// two-stage cp.async ring (16-byte copies; rows at or past the slot's
// length are zero-filled, never read), 101.6 KB of shared memory, two
// blocks an SM.  The 16 heads are the M of mma.sync m16n8k16.  Scores:
// warp w holds the A fragments of q's columns [144 w, 144 w + 144) in
// registers for the whole block and computes that slice's partial scores
// of the 16 heads x 32 rows (four 8-row tiles, nine k-steps); the four
// partials meet in shared memory and every warp sums them in warp order,
// so all four hold the same scores, bit for bit, and run the same online
// softmax (exp2 with the scale folded in).  P . V: warp w owns V's columns
// [128 w, 128 w + 128), fed by ldmatrix.trans from the same tile, P as A
// fragments straight from its registers.  So each latent row leaves device
// memory once and the tensor cores see it twice.
//
// Combine.  With one split the block writes the output.  Otherwise each
// block writes an f32 partial (acc[16][512], m, l) to a workspace the
// wrapper allocates, and the last block of the slot to arrive (an atomic
// ticket on an int counter, which it resets to 0) merges the splits in
// order.  No float atomics: every call gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 16;                   // M: the query heads (at most)
constexpr int kWidth = 576;                  // a latent row: 512 + 64 rope
constexpr int kVWidth = 512;                 // V: a row's first 512 values
constexpr int kRows = 32;                    // rows a tile
constexpr int kStages = 2;                   // ring slots
constexpr int kPitch = kWidth * 2 + 16;      // bytes a row in shared memory
constexpr int kNC = kWidth / 8;              // 16-byte chunks of a row
constexpr int kKS = kWidth / 16 / kWarps;    // k-steps of a warp's q slice
constexpr int kND = kVWidth / 8 / kWarps;    // 8-wide V column tiles a warp
constexpr int kNT = kRows / 8;               // 8-row score tiles
constexpr int kRedPitch = kRows + 8;         // floats a head's partial scores
constexpr int kPart = kVWidth + 2;           // a head's split partial: acc, m, l
constexpr int kRingBytes = kStages * kRows * kPitch;
constexpr int kQBytes = kHeads * kPitch;
constexpr int kRedBytes = kWarps * kHeads * kRedPitch * 4;
constexpr int kSmemBytes = kRingBytes + kQBytes + kRedBytes;
constexpr int kMaxSplits = kWarps * kRedPitch - 1;  // the merge's weights fit red

typedef __nv_bfloat16 bf16;

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
// what a bf16x2 register's two halves leave of (lo, hi), again as bf16x2
__device__ __forceinline__ uint32_t pack_rest(float lo, float hi, uint32_t packed) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  return pack_bf16(lo - __low2float(h), hi - __high2float(h));
}
// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = smem_u32(smem);
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

__global__ void __launch_bounds__(kThreads, 2)
mla_decode_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ latent,
                        const int* __restrict__ cache_len, bf16* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ tickets, int H, int S,
                        int rows_per_split, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  unsigned char* ring = smem;
  unsigned char* q_s = smem + kRingBytes;
  float* red = reinterpret_cast<float*>(q_s + kQBytes);  // [kWarps][kHeads][kRedPitch]

  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = max(min(cache_len[b], S), 0);
  const int rs = split * rows_per_split;
  const int re = min(len, rs + rows_per_split);
  const int n = rs < re ? (re - rs + kRows - 1) / kRows : 0;

  // q's 16 x 576 tile, heads past H zero
  const bf16* qb = q + (size_t)b * H * kWidth;
  for (int c = threadIdx.x; c < kHeads * kNC; c += kThreads) {
    const int r = c / kNC, ch = c - (c / kNC) * kNC;
    const bool ok = r < H;
    cp_async16(q_s + r * kPitch + ch * 16, qb + (ok ? (size_t)r * kWidth : 0) + ch * 8, ok);
  }
  cp_async_commit();

  // tile i (rows rs + 32 i ...) into ring slot i % kStages
  const bf16* lb = latent + (size_t)b * S * kWidth;
  auto fetch = [&](int i) {
    if (i < n) {
      const int r0 = rs + i * kRows;
      unsigned char* slot = ring + (i % kStages) * kRows * kPitch;
      for (int c = threadIdx.x; c < kRows * kNC; c += kThreads) {
        const int r = c / kNC, ch = c - (c / kNC) * kNC;
        const bool ok = r0 + r < re;
        cp_async16(slot + r * kPitch + ch * 16, lb + (ok ? (size_t)(r0 + r) * kWidth : 0) + ch * 8,
                   ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);

  // ldmatrix addressing: this lane gives row lane % 8 of matrix lane / 8;
  // accumulator rows (heads) g and g + 8, columns 2t, 2t + 1 of each 8-wide tile
  const int mi = lane >> 3, mr = lane & 7;
  const int g = lane >> 2, tq = lane & 3;

  cp_async_wait<kStages - 1>();  // the q tile
  __syncthreads();
  uint32_t qa[kKS][4];  // A fragments of this warp's q slice
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks)
    ldmatrix_x4(qa[ks], smem_u32(q_s + ((mi & 1) * 8 + mr) * kPitch +
                                 ((warp * kKS + ks) * 2 + (mi >> 1)) * 16));

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float* rw = red + warp * kHeads * kRedPitch;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    fetch(i + kStages - 1);
    const unsigned char* tile = ring + (i % kStages) * kRows * kPitch;

    // this warp's slice of q . row for the 16 heads x 32 rows
    float sc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int kg = warp * kKS + ks;
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t kf[4];  // (rows 0-7 | 8-15) x (k 0-7 | 8-15) as B fragments
        ldmatrix_x4(kf, smem_u32(tile + (j * 16 + (mi >> 1) * 8 + mr) * kPitch +
                                 (kg * 2 + (mi & 1)) * 16));
        mma_bf16(sc[2 * j], qa[ks], kf[0], kf[1]);
        mma_bf16(sc[2 * j + 1], qa[ks], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int c = nt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(rw + g * kRedPitch + c) = make_float2(sc[nt][0], sc[nt][1]);
      *reinterpret_cast<float2*>(rw + (g + 8) * kRedPitch + c) = make_float2(sc[nt][2], sc[nt][3]);
    }
    __syncthreads();

    // the whole scores: the four slices summed in warp order; rows past the
    // slot's length masked
    const int r0 = rs + i * kRows;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int c = nt * 8 + 2 * tq;
      float2 s0 = *reinterpret_cast<const float2*>(red + g * kRedPitch + c);
      float2 s1 = *reinterpret_cast<const float2*>(red + (g + 8) * kRedPitch + c);
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float2 a = *reinterpret_cast<const float2*>(red + (w * kHeads + g) * kRedPitch + c);
        const float2 d = *reinterpret_cast<const float2*>(red + (w * kHeads + g + 8) * kRedPitch + c);
        s0.x += a.x;
        s0.y += a.y;
        s1.x += d.x;
        s1.y += d.y;
      }
      const bool ok0 = r0 + c < re, ok1 = r0 + c + 1 < re;
      sc[nt][0] = ok0 ? s0.x : -INFINITY;
      sc[nt][1] = ok1 ? s0.y : -INFINITY;
      sc[nt][2] = ok0 ? s1.x : -INFINITY;
      sc[nt][3] = ok1 ? s1.y : -INFINITY;
    }

    // online softmax on the fragments: heads g (0, 1) and g + 8 (2, 3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // row r0 is valid, so the maxima are finite
    const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
    const float c0 = exp2f(m0 * scale_log2 - ms0);  // 0 on the first tile
    const float c1 = exp2f(m1 * scale_log2 - ms1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      sc[nt][0] = exp2f(fmaf(sc[nt][0], scale_log2, -ms0));
      sc[nt][1] = exp2f(fmaf(sc[nt][1], scale_log2, -ms0));
      sc[nt][2] = exp2f(fmaf(sc[nt][2], scale_log2, -ms1));
      sc[nt][3] = exp2f(fmaf(sc[nt][3], scale_log2, -ms1));
      rs0 += sc[nt][0] + sc[nt][1];
      rs1 += sc[nt][2] + sc[nt][3];
    }
    l0 = l0 * c0 + rs0;  // this lane's part of the row sums
    l1 = l1 * c1 + rs1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= c0;
      o[nd][1] *= c0;
      o[nd][2] *= c1;
      o[nd][3] *= c1;
    }

    // P . V over this warp's 128 columns: P (16 heads x 16 rows a step) as
    // hi and lo bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t ph[4], pl[4];
      ph[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      ph[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      ph[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      ph[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      pl[0] = pack_rest(sc[2 * kk][0], sc[2 * kk][1], ph[0]);
      pl[1] = pack_rest(sc[2 * kk][2], sc[2 * kk][3], ph[1]);
      pl[2] = pack_rest(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2]);
      pl[3] = pack_rest(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3]);
#pragma unroll
      for (int nd = 0; nd < kND; nd += 2) {
        uint32_t vf[4];  // (rows 0-7 | 8-15) x (dims nd | nd + 1) as B fragments
        ldmatrix_x4_trans(vf, smem_u32(tile + (kk * 16 + (mi & 1) * 8 + mr) * kPitch +
                                       (warp * kND + nd + (mi >> 1)) * 16));
        mma_bf16(o[nd], ph, vf[0], vf[1]);
        mma_bf16(o[nd], pl, vf[0], vf[1]);
        mma_bf16(o[nd + 1], ph, vf[2], vf[3]);
        mma_bf16(o[nd + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (nsplit == 1) {
    const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
    bf16* ob = out + (size_t)b * H * kVWidth;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const int c = (warp * kND + nd) * 8 + 2 * tq;
      if (g < H)
        *reinterpret_cast<uint32_t*>(ob + (size_t)g * kVWidth + c) =
            pack_bf16(o[nd][0] / d0, o[nd][1] / d0);
      if (g + 8 < H)
        *reinterpret_cast<uint32_t*>(ob + (size_t)(g + 8) * kVWidth + c) =
            pack_bf16(o[nd][2] / d1, o[nd][3] / d1);
    }
    return;
  }

  // this split's partial; then the last block of the slot merges the splits
  float* pp = part + ((size_t)b * nsplit + split) * kHeads * kPart;
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) {
    const int c = (warp * kND + nd) * 8 + 2 * tq;
    *reinterpret_cast<float2*>(pp + g * kPart + c) = make_float2(o[nd][0], o[nd][1]);
    *reinterpret_cast<float2*>(pp + (g + 8) * kPart + c) = make_float2(o[nd][2], o[nd][3]);
  }
  if (warp == 0 && tq == 0) {
    pp[g * kPart + kVWidth] = m0;
    pp[g * kPart + kVWidth + 1] = l0;
    pp[(g + 8) * kPart + kVWidth] = m1;
    pp[(g + 8) * kPart + kVWidth + 1] = l1;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_block = atomicAdd(tickets + b, 1) == nsplit - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // per head: the splits' weights exp2((m_s - M) scale_log2) into shared
  // memory (one warp a head, lanes over splits), then every (head, column)
  // sums its splits in order
  const float* p0 = part + (size_t)b * nsplit * kHeads * kPart;
  const size_t sstride = (size_t)kHeads * kPart;
  float* wts = red;  // [kHeads][nsplit], then L[kHeads]
  float* Ls = wts + kHeads * nsplit;
  for (int h = warp; h < kHeads; h += kWarps) {
    const float* ph = p0 + h * kPart;
    float M = -INFINITY;
    for (int sp = lane; sp < nsplit; sp += 32) M = fmaxf(M, __ldcg(ph + sp * sstride + kVWidth));
    M = warp_max(M);
    float L = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const float ms = __ldcg(ph + sp * sstride + kVWidth);
      const float c = ms == -INFINITY ? 0.f : exp2f((ms - M) * scale_log2);
      wts[h * nsplit + sp] = c;
      L = fmaf(c, __ldcg(ph + sp * sstride + kVWidth + 1), L);
    }
    L = warp_sum(L);
    if (lane == 0) Ls[h] = L;
  }
  __syncthreads();
  bf16* ob = out + (size_t)b * H * kVWidth;
  for (int i = threadIdx.x; i < H * kVWidth; i += kThreads) {
    const int h = i / kVWidth;
    const int d = i - h * kVWidth;
    const float* pd = p0 + h * kPart + d;
    const float* wh = wts + h * nsplit;
    float A = 0.f;
    int sp = 0;
    for (; sp + 4 <= nsplit; sp += 4) {  // four loads in flight
      const float a0 = __ldcg(pd + sp * sstride);
      const float a1 = __ldcg(pd + (sp + 1) * sstride);
      const float a2 = __ldcg(pd + (sp + 2) * sstride);
      const float a3 = __ldcg(pd + (sp + 3) * sstride);
      A = fmaf(wh[sp], a0, A);
      A = fmaf(wh[sp + 1], a1, A);
      A = fmaf(wh[sp + 2], a2, A);
      A = fmaf(wh[sp + 3], a3, A);
    }
    for (; sp < nsplit; ++sp) A = fmaf(wh[sp], __ldcg(pd + sp * sstride), A);
    ob[i] = __float2bfloat16(A / fmaxf(Ls[h], 1e-20f));
  }
  if (threadIdx.x == 0) tickets[b] = 0;
}

}  // namespace

// q [B,H,576], latent [B,S,576] and out [B,H,512] bf16; cache_len int32 [B];
// part (f32 [B][splits][16][514]) and tickets (int32 [B], zero) only read
// when splits > 1.  H <= 16, splits <= kMaxSplits.
extern "C" int repro_mla_decode_attention(const void* q, const void* latent, const void* cache_len,
                                          void* out, void* part, void* tickets, int B, int H,
                                          int S, int splits, int rows_per_split, float scale,
                                          void* stream) {
  if (H < 1 || H > kHeads || splits < 1 || splits > kMaxSplits || B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  auto kernel = mla_decode_attention_tc;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, B);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(latent),
      static_cast<const int*>(cache_len), static_cast<bf16*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), H, S, rows_per_split, (float)(1.4426950408889634 * scale));
  return (int)cudaGetLastError();
}
