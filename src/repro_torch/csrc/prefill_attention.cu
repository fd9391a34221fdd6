// GQA prefill attention, written by hand for Hopper (sm_90a): flash
// attention over a whole prompt, causal or not, with a sliding window.
//
// Replaces no Pallas kernel: the JAX package computes this attention in XLA
// (src/repro/models/attention.py:chunked_attention), and the port's plain
// version is repro_torch/models/attention.py:chunked_attention, whose
// function this kernel computes: q [B,Sq,H,dh], k [B,Sk,Hkv,dh] and v
// [B,Sk,Hkv,dv] (dv = dh, but for multi-head latent attention's prefill:
// dh 192, dv 128) with H % Hkv == 0, each query head reading kv head h /
// (H / Hkv) in place; the
// mask from int64 positions shared by the batch (a key attends only when
// kv_pos < 2**30, and, causal, q_pos >= kv_pos; with a window, q_pos - kv_pos
// < window), so padded queries (-1), padded keys (2**30), a prefix resumed
// from a cache (Sk > Sq) and cross-attention (no causal mask) all come from
// the positions; scale 1/sqrt(dh); a row with no key attended gives 0 (the
// denominator is clamped at 1e-20); output [B,Sq,H,dv] rounded once to
// bf16, or f32 on request for checks.
//
// Precision: the same work as the plain version, in other rounding orders.
// S = q . K^T takes the bf16 operands with f32 accumulation (each product is
// exact, as in the f32 einsum of the upcast operands); the scale, the masks
// and the online softmax (m, l) run in f32; P enters P . V as a hi/lo bf16
// pair (about 16 mantissa bits of the f32 p) with f32 accumulation, as
// decode_attention_tc does.
//
// Bound: the tensor cores.  A causal prefill of 2,048 tokens with 48 query
// heads of 128 (nemotron-4-15b) does 4 * 48 * 128 * 2,098,176 = 51.6 GFLOP a
// layer on the unmasked pairs (kernels/costs.py:prefill_attention), 52 us at
// 989 TFLOP/s, against 59 MB of q, k, v and out (18 us at 3.35 TB/s).  The
// hi/lo P . V makes it 77 GFLOP of tensor-core work.
//
// Design.  One block per (query tile of 64 rows, query head, batch row),
// the tiles issued longest-first: block x takes query tile nqt - 1 - x / (B
// H), so under a causal mask the blocks that see the most keys start first
// and the short ones fill the tail.  Four warps, each owning 16 query rows
// whose q fragments it holds in registers for the whole block (211
// registers a thread at dh 128, two blocks an SM: 8 warps of 128 rows in
// one block synchronise at every key tile and ran 10% slower).  The block
// first reads the positions: the min and max of its queries', then, per
// 64-key tile, whether the tile is wholly masked (skipped: no load, no
// product), wholly unmasked, or partial (masked element-wise: the tiles that
// cross the diagonal, a window edge, a sentinel or the end of the keys), and
// compacts the tiles to visit into a list in shared memory.  The visited K
// and V tiles of the block's kv head stream through a two-stage cp.async
// ring (16-byte copies, rows past Sk zero-filled).  Both products are
// mma.sync m16n8k16 (bf16 in, f32 accumulate): S for the warp's 16 rows x 64
// keys stays in registers, the online softmax runs on those fragments (exp2
// with the scale folded in, two shuffles a row reduction), and P feeds P . V
// straight from the same registers as A fragments, V coming by
// ldmatrix.trans.  The output is staged through the warp's rows of the q
// tile and written with 16-byte stores.  Nothing is atomic: every call gives
// the same bits, and a row's result depends only on its own q, its head's
// K/V and its position, not on B, H, G or which tiles the block skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;     // query rows a block
constexpr int kBN = 64;              // keys a tile
constexpr int kStages = 2;           // K/V ring slots
constexpr int kSentinel = 1 << 30;   // a padded key's position
constexpr int kPartial = 1 << 30;    // list entry flag: mask element-wise

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int pitch_of(int dh) { return dh * 2 + 16; }

// q tile, K ring, V ring (rows dv wide), then the visit list (an int a key
// tile)
__host__ __device__ inline size_t smem_bytes_of(int dh, int dv, int nkt) {
  return (size_t)(kBM + kStages * kBN) * pitch_of(dh) + (size_t)kStages * kBN * pitch_of(dv) +
         (size_t)nkt * 4;
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

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// KS = dh / 16, KV = dv / 16; TO = bf16 (the path) or float (checks)
template <int KS, int KV, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
prefill_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const long long* __restrict__ q_pos,
                     const long long* __restrict__ kv_pos, TO* __restrict__ out, int B, int Sq,
                     int Sk, int H, int Hkv, int causal, int window, float scale_log2) {
  constexpr int dh = 16 * KS;
  constexpr int dv = 16 * KV;
  constexpr int kPitch = pitch_of(dh);
  constexpr int kVPitch = pitch_of(dv);
  constexpr int kNC = dh / 8;   // 16-byte chunks of a q or K row
  constexpr int kVNC = dv / 8;  // of a V row
  constexpr int kND = dv / 8;   // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + kBM * kPitch;
  unsigned char* v_s = k_s + kStages * kBN * kPitch;
  int* list = reinterpret_cast<int*>(v_s + kStages * kBN * kVPitch);
  __shared__ int q_lo, q_hi, n_visit;

  const int nqt = (Sq + kBM - 1) / kBM;
  const int nkt = (Sk + kBN - 1) / kBN;
  const int bh = blockIdx.x % (B * H);
  const int qt = nqt - 1 - blockIdx.x / (B * H);  // longest first
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // rows of q [B,Sq,H,dh], k [B,Sk,Hkv,dh] and v [B,Sk,Hkv,dv] for this
  // (b, head)
  const size_t q_stride = (size_t)H * dh;
  const size_t kv_stride = (size_t)Hkv * dh;
  const size_t v_stride = (size_t)Hkv * dv;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * dh;
  const bf16* kb = k + ((size_t)b * Sk * Hkv + hk) * dh;
  const bf16* vb = v + ((size_t)b * Sk * Hkv + hk) * dv;

  // the q tile, rows past Sq zero
  for (int c = threadIdx.x; c < kBM * kNC; c += kThreads) {
    const int r = c / kNC, ch = c - (c / kNC) * kNC;
    const bool ok = q0 + r < Sq;
    cp_async16(q_s + r * kPitch + ch * 16, qb + (ok ? (size_t)(q0 + r) * q_stride : 0) + ch * 8,
               ok);
  }
  cp_async_commit();

  // the queries' lowest and highest positions (rows past Sq left out)
  if (threadIdx.x == 0) {
    q_lo = INT_MAX;
    q_hi = INT_MIN;
  }
  __syncthreads();
  if (warp < kBM / 32) {
    const int r = q0 + threadIdx.x;
    const int p = r < Sq ? (int)q_pos[r] : 0;
    const int lo = warp_min(r < Sq ? p : INT_MAX);
    const int hi = warp_max(r < Sq ? p : INT_MIN);
    if (lane == 0) {
      atomicMin(&q_lo, lo);
      atomicMax(&q_hi, hi);
    }
  }
  __syncthreads();

  // each key tile: 0 wholly masked, 1 wholly unmasked, 2 partial
  const int qlo = q_lo, qhi = q_hi;
  for (int t = warp; t < nkt; t += kWarps) {
    int lo = INT_MAX, hi = INT_MIN, valid = 0;
    for (int j = lane; j < kBN; j += 32) {
      const int key = t * kBN + j;
      const long long p = key < Sk ? kv_pos[key] : kSentinel;
      if (p < kSentinel) {
        lo = min(lo, (int)p);
        hi = max(hi, (int)p);
        ++valid;
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) valid += __shfl_xor_sync(0xffffffffu, valid, o);
    if (lane == 0) {
      int flag = 2;
      if (valid == 0 || (causal && lo > qhi) || (window > 0 && qlo - hi >= window))
        flag = 0;
      else if (valid == kBN && (!causal || qlo >= hi) && (window <= 0 || qhi - lo < window))
        flag = 1;
      list[t] = flag;
    }
  }
  __syncthreads();
  // warp 0 compacts the tiles to visit, in order, in place
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < nkt; base += 32) {
      const int t = base + lane;
      const int flag = t < nkt ? list[t] : 0;
      const unsigned vis = __ballot_sync(0xffffffffu, flag != 0);
      if (flag) list[count + __popc(vis & ((1u << lane) - 1u))] = t | (flag == 2 ? kPartial : 0);
      count += __popc(vis);
      __syncwarp();
    }
    if (lane == 0) n_visit = count;
  }
  __syncthreads();
  const int n = n_visit;

  // visited tile i into ring slot i % kStages
  auto fetch = [&](int i) {
    if (i < n) {
      const int k0 = (list[i] & (kPartial - 1)) * kBN;
      unsigned char* ks = k_s + (i % kStages) * kBN * kPitch;
      unsigned char* vs = v_s + (i % kStages) * kBN * kVPitch;
      if constexpr (KS == KV) {  // K and V rows alike: one loop
        for (int c = threadIdx.x; c < kBN * kNC; c += kThreads) {
          const int r = c / kNC, ch = c - (c / kNC) * kNC;
          const bool ok = k0 + r < Sk;
          const size_t off = (ok ? (size_t)(k0 + r) * kv_stride : 0) + ch * 8;
          cp_async16(ks + r * kPitch + ch * 16, kb + off, ok);
          cp_async16(vs + r * kPitch + ch * 16, vb + off, ok);
        }
      } else {
        for (int c = threadIdx.x; c < kBN * kNC; c += kThreads) {
          const int r = c / kNC, ch = c - (c / kNC) * kNC;
          const bool ok = k0 + r < Sk;
          cp_async16(ks + r * kPitch + ch * 16,
                     kb + (ok ? (size_t)(k0 + r) * kv_stride : 0) + ch * 8, ok);
        }
        for (int c = threadIdx.x; c < kBN * kVNC; c += kThreads) {
          const int r = c / kVNC, ch = c - (c / kVNC) * kVNC;
          const bool ok = k0 + r < Sk;
          cp_async16(vs + r * kVPitch + ch * 16,
                     vb + (ok ? (size_t)(k0 + r) * v_stride : 0) + ch * 8, ok);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);

  // ldmatrix addressing: this lane gives row lane % 8 of matrix lane / 8
  const int mi = lane >> 3, mr = lane & 7;
  // this lane's accumulator rows g and g + 8 of the warp's 16, columns 2t,
  // 2t + 1 of each 8-wide tile
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = q0 + warp * 16 + g;
  const int qp0 = (int)q_pos[min(row0, Sq - 1)];
  const int qp1 = (int)q_pos[min(row0 + 8, Sq - 1)];

  cp_async_wait<kStages - 2>();  // the q tile and the first key tile
  __syncthreads();
  uint32_t qa[KS][4];  // A fragments: (rows 0-7 | 8-15) x (k 0-7 | 8-15)
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldmatrix_x4(qa[ks], smem_u32(q_s + (warp * 16 + (mi & 1) * 8 + mr) * kPitch +
                                 (ks * 2 + (mi >> 1)) * 16));

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with slot i - 1
    fetch(i + kStages - 1);
    const unsigned char* ks = k_s + (i % kStages) * kBN * kPitch;
    const unsigned char* vs = v_s + (i % kStages) * kBN * kVPitch;
    const int entry = list[i];

    // S = q . K^T: the warp's 16 rows x 64 keys as eight 8-key tiles
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks2 = 0; ks2 < KS; ++ks2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kf[4];  // (keys 0-7 | 8-15) x (k 0-7 | 8-15) as B fragments
        ldmatrix_x4(kf, smem_u32(ks + (j * 16 + (mi >> 1) * 8 + mr) * kPitch +
                                 (ks2 * 2 + (mi & 1)) * 16));
        mma_bf16(sc[2 * j], qa[ks2], kf[0], kf[1]);
        mma_bf16(sc[2 * j + 1], qa[ks2], kf[2], kf[3]);
      }
    }

    if (entry & kPartial) {  // mask element-wise
      const int k0 = (entry & (kPartial - 1)) * kBN;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + nt * 8 + 2 * tq + e;
          const long long kp = key < Sk ? kv_pos[key] : kSentinel;
          const bool any = kp < kSentinel;
          const int p = (int)kp;
          if (!(any && (!causal || qp0 >= p) && (window <= 0 || qp0 - p < window)))
            sc[nt][e] = -INFINITY;
          if (!(any && (!causal || qp1 >= p) && (window <= 0 || qp1 - p < window)))
            sc[nt][2 + e] = -INFINITY;
        }
      }
    }

    // online softmax on the fragments: rows g (0, 1) and g + 8 (2, 3)
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // scaled maxima, 0 while a row has no key: exp2(-inf - 0) = 0
    const float ms0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
    const float ms1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
    const float c0 = exp2f(m0 * scale_log2 - ms0);  // exactly 1 where the max held
    const float c1 = exp2f(m1 * scale_log2 - ms1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
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

    // P . V: P (16 rows x 16 keys a step) as hi and lo bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
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
        uint32_t vf[4];  // (keys 0-7 | 8-15) x (dims nd | nd + 1) as B fragments
        ldmatrix_x4_trans(vf, smem_u32(vs + (kk * 16 + (mi & 1) * 8 + mr) * kVPitch +
                                       (nd + (mi >> 1)) * 16));
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
  const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
  const size_t o_stride = (size_t)H * dv;
  TO* ob = out + ((size_t)b * Sq * H + h) * dv;
  if constexpr (sizeof(TO) == 2) {
    // through the warp's own rows of the q tile, then 16-byte stores
    unsigned char* st = q_s + warp * 16 * kPitch;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const int c = (nd * 8 + 2 * tq) * 2;
      *reinterpret_cast<uint32_t*>(st + g * kPitch + c) = pack_bf16(o[nd][0] / d0, o[nd][1] / d0);
      *reinterpret_cast<uint32_t*>(st + (g + 8) * kPitch + c) =
          pack_bf16(o[nd][2] / d1, o[nd][3] / d1);
    }
    __syncwarp();
    for (int c = lane; c < 16 * kVNC; c += 32) {
      const int r = c / kVNC, ch = c - (c / kVNC) * kVNC;
      const int row = q0 + warp * 16 + r;
      if (row < Sq)
        *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(ob + (size_t)row * o_stride) +
                                  ch * 16) = *reinterpret_cast<const uint4*>(st + r * kPitch + ch * 16);
    }
  } else {
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const int c = nd * 8 + 2 * tq;
      if (row0 < Sq)
        *reinterpret_cast<float2*>(ob + (size_t)row0 * o_stride + c) =
            make_float2(o[nd][0] / d0, o[nd][1] / d0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<float2*>(ob + (size_t)(row0 + 8) * o_stride + c) =
            make_float2(o[nd][2] / d1, o[nd][3] / d1);
    }
  }
}

template <int KS, int KV, typename TO>
int run(const void* q, const void* k, const void* v, const void* q_pos, const void* kv_pos,
        void* out, int B, int Sq, int Sk, int H, int Hkv, int causal, int window,
        cudaStream_t stream) {
  constexpr int dh = 16 * KS;
  const int nqt = (Sq + kBM - 1) / kBM;
  const int nkt = (Sk + kBN - 1) / kBN;
  const size_t smem = smem_bytes_of(dh, 16 * KV, nkt);
  auto kernel = prefill_attention_tc<KS, KV, TO>;
  if (smem > 48 * 1024) {  // per call: the attribute is the current device's
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)dh));
  kernel<<<(unsigned)nqt * B * H, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const long long*>(q_pos), static_cast<const long long*>(kv_pos),
      static_cast<TO*>(out), B, Sq, Sk, H, Hkv, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch(const void* q, const void* k, const void* v, const void* qp, const void* kp, void* out,
           int B, int Sq, int Sk, int H, int Hkv, int dh, int dv, int causal, int window,
           cudaStream_t s) {
  if (dv == dh) {
    switch (dh) {
      case 64:
        return run<4, 4, TO>(q, k, v, qp, kp, out, B, Sq, Sk, H, Hkv, causal, window, s);
      case 80:
        return run<5, 5, TO>(q, k, v, qp, kp, out, B, Sq, Sk, H, Hkv, causal, window, s);
      case 128:
        return run<8, 8, TO>(q, k, v, qp, kp, out, B, Sq, Sk, H, Hkv, causal, window, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (dh == 192 && dv == 128)  // multi-head latent attention's prefill
    return run<12, 8, TO>(q, k, v, qp, kp, out, B, Sq, Sk, H, Hkv, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v bf16; q_pos [Sq] and kv_pos [Sk] int64; out bf16, or f32 when out_f32
extern "C" int repro_prefill_attention(const void* q, const void* k, const void* v,
                                       const void* q_pos, const void* kv_pos, void* out, int B,
                                       int Sq, int Sk, int H, int Hkv, int dh, int dv, int causal,
                                       int window, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return launch<float>(q, k, v, q_pos, kv_pos, out, B, Sq, Sk, H, Hkv, dh, dv, causal, window,
                         s);
  return launch<bf16>(q, k, v, q_pos, kv_pos, out, B, Sq, Sk, H, Hkv, dh, dv, causal, window, s);
}
