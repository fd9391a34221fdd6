// Grouped (per-expert) SwiGLU FFN over the MoE capacity buffer, written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel grouped_ffn_pallas
// (src/repro/kernels/grouped_ffn.py).  Same function:
//   out[e] = (silu(buf[e] . wg[e]) * (buf[e] . wu[e])) . wd[e]
// with buf [E,C,D], wg/wu [E,D,F] and wd [E,F,D], all bf16 or all f32; g and
// u are accumulated in f32, h = silu(g) * u is formed in f32, h . wd is
// accumulated in f32, and the output is in buf's dtype.  An optional
// counts [E] (int32, on the device) gives the rows of buf[e] in use: rows
// >= counts[e] are read as zeros and written as exact zeros, and an expert
// with count 0 reads none of its weights.  A zero row of buf gives an
// exactly zero output row, which the MoE combine relies on.  Any E, C, D
// and F (the TPU kernel asserted C % 128 == 0 and F % 512 == 0).
//
// Bound: memory, at the serving path's shapes.  moonshot-v1-16b-a3b has
// E=64, D=2048, F=1408 in bf16: 3*D*F*2 = 17.3 MB of weights an expert.  At
// decode (B=11, top-6: 66 choices) about 41 experts are routed, 0.71 GB; a
// prefill (C=168) routes rows to every expert, 1.11 GB against
// 6*E*n*D*F = 1.5e11 operations for the ~132 routed rows an expert.  At
// 3.35 TB/s and 989 TFLOP/s the bytes bound both.
//
// Design: two passes, launched back to back.
//   1. gate_up: h[e] = silu(buf[e] . wg[e]) * (buf[e] . wu[e]);
//   2. down:    out[e] = h[e] . wd[e].
// The bf16 path (D and F multiples of 8) runs on the tensor cores with A and
// B swapped: the weights are the M operand, 64-row tiles of F (gate_up) and
// of D (down; 128-row tiles at prefill-sized C, which halves the re-reads of
// the down pass's token operand), and the routed tokens are the N operand,
// padded to a multiple of 8 up to C.  A block owns one expert and one weight
// tile and covers all of the expert's routed rows (up to 192 of them in one
// pass over the weights: 8 at decode, at most 168 at moonshot's prefill), so
// every weight byte of a routed expert is read once per call and no padded
// 8-row tile is computed.  The weights and the tokens stream through a ring
// of STAGES >= 3 slots in shared memory with 16-byte cp.async.cg copies
// (XOR-swizzled rows, zero-filled past the data), so STAGES - 1
// tiles are in flight while the block multiplies the oldest.  The products
// are mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix, .trans
// for the weights, which are MN-major ([D,F] with F contiguous, [F,D] with D
// contiguous).  mma.sync rather than wgmma: at decode the bytes bound the
// call, and mma.sync's fragment layout can be checked element by element
// against the PTX documentation without a debugger.  At prefill-sized C the
// SM's own work (token fragments re-read by every M-warp, one block an SM)
// holds it above the bound; wgmma would take that on (PERF.md).  The gate_up epilogue writes h as a hi/lo bf16 pair
// (h_hi = bf16(h), h_lo = bf16(h - h_hi); the same 4 bytes a value as f32
// h), and the down pass multiplies both into one f32 accumulator, keeping
// ~16 mantissa bits of h.  Every sum runs in a fixed order: the result is
// the same bits on every call, and no atomics are used.
//
// f32 inputs, and bf16 with D or F not a multiple of 8 (rows that 16-byte
// copies cannot tile), take the CUDA-core kernel: each output's reduction
// in one thread with f32 FMAs (full f32, no TF32), chunks staged in shared
// memory as f32, rows >= counts[e] masked, blocks past them write zeros
// and exit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + expf(-g)) * u; }

// rows of expert e in use: counts[e] clamped to [0, rows], or all rows
__device__ __forceinline__ int rows_used(const int* counts, int e, int rows) {
  return counts ? min(max(counts[e], 0), rows) : rows;
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32, and bf16 with D or F not a multiple of 8)
// ---------------------------------------------------------------------------
constexpr int kThreads = 128;  // 16 column groups x 8 row groups
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // reduction chunk staged in shared memory
constexpr int kTN = 4;         // output columns per thread

// Rows [m0, m0+BM) x columns [k0, k0+kBK) of A (row-major, rows of K values)
// into As[k][m] as f32, zero outside [0,rows) x [0,K).  Consecutive threads
// read consecutive columns; the odd pitch BM+1 keeps the transposed stores
// off shared bank conflicts.
template <typename TA, int BM>
__device__ __forceinline__ void load_a(const TA* __restrict__ A, int rows, int K, int m0, int k0,
                                       float (*As)[BM + 1]) {
  for (int i = threadIdx.x; i < BM * kBK; i += kThreads) {
    const int r = i / kBK;
    const int c = i - r * kBK;
    const int gm = m0 + r, gk = k0 + c;
    As[c][r] = (gm < rows && gk < K) ? to_f32(A[(size_t)gm * K + gk]) : 0.f;
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
// with A[e] [M,K], B*[e] [K,N] and out[e] [M,N], all row-major; rows of A[e]
// at or past counts[e] are zeros, and their output rows are written as 0.
template <typename TA, typename TB, typename TO, int BM, int NB>
__global__ void __launch_bounds__(kThreads)
grouped_ffn_pass(const TA* __restrict__ A, const TB* __restrict__ B0,
                 const TB* __restrict__ B1, TO* __restrict__ out,
                 const int* __restrict__ counts, int M, int K, int N, int vec) {
  constexpr int kTM = BM / 8;
  __shared__ float As[kBK][BM + 1];
  __shared__ __align__(16) float Bs[NB][kBK][kBN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x & 15;  // columns n0 + tx*kTN ...
  const int ty = threadIdx.x >> 4;  // rows m0 + ty*kTM ...
  const int rows = rows_used(counts, e, M);
  A += (size_t)e * M * K;
  B0 += (size_t)e * K * N;
  if constexpr (NB == 2) B1 += (size_t)e * K * N;
  out += (size_t)e * M * N;

  if (m0 >= rows) {  // no row of this tile is in use: zeros, no weight read
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int m = m0 + i / kBN, n = n0 + i % kBN;
      if (m < M && n < N) out[(size_t)m * N + n] = from_f32<TO>(0.f);
    }
    return;
  }

  float acc[NB][kTM][kTN];
#pragma unroll
  for (int p = 0; p < NB; ++p)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[p][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_a<TA, BM>(A, rows, K, m0, k0, As);
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
          v = silu_mul(acc[0][i][j], acc[1][i][j]);
        } else {
          v = acc[0][i][j];
        }
        out[(size_t)m * N + n] = from_f32<TO>(m < rows ? v : 0.f);
      }
    }
  }
}

template <typename T, int BM>
int run_cuda_cores(const T* buf, const T* wg, const T* wu, const T* wd, float* h, T* out,
                   const int* counts, int E, int C, int D, int F, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kThreads);
  const dim3 grid_gu((C + BM - 1) / BM, (F + kBN - 1) / kBN, E);
  grouped_ffn_pass<T, T, float, BM, 2><<<grid_gu, block, 0, stream>>>(
      buf, wg, wu, h, counts, C, D, F, F % kVec == 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_down((C + BM - 1) / BM, (D + kBN - 1) / kBN, E);
  grouped_ffn_pass<float, T, T, BM, 1><<<grid_down, block, 0, stream>>>(
      h, wd, static_cast<const T*>(nullptr), out, counts, C, F, D, D % kVec == 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cuda_cores(const T* b, const T* g, const T* u, const T* d, float* h, T* o,
                      const int* counts, int E, int C, int D, int F, cudaStream_t s) {
  if (C <= 8) return run_cuda_cores<T, 8>(b, g, u, d, h, o, counts, E, C, D, F, s);
  if (C <= 32) return run_cuda_cores<T, 32>(b, g, u, d, h, o, counts, E, C, D, F, s);
  return run_cuda_cores<T, 64>(b, g, u, d, h, o, counts, E, C, D, F, s);
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16, D and F multiples of 8)
// ---------------------------------------------------------------------------
constexpr int kTcBK = 64;        // reduction depth per ring slot
constexpr int kTokBytes = 128;   // a staged token row: kTcBK bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk ch of row r in a tile of row_bytes-byte rows
// (a multiple of 128); the XOR puts the same chunk of eight consecutive rows
// in eight distinct bank groups, for the copies and for ldmatrix
__device__ __forceinline__ int swz(int r, int ch, int row_bytes) {
  return r * row_bytes + ((ch ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// d += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A block's layout: WM x WN warps; warp (wm, wn) owns weight rows
// [16 wm, 16 wm + 16) of the block's 16 WM and the 8-token tiles wn,
// wn + WN, ...  (NT of them): 8 * WN * NT tokens per pass over the weights.
template <bool GATE_UP, int WM, int WN, int NT>
__host__ __device__ constexpr int tc_stage_bytes() {
  // weight tiles (kTcBK rows of 16 WM values) then token tiles
  return (GATE_UP ? 2 : 1) * kTcBK * 32 * WM + (GATE_UP ? 1 : 2) * NT * WN * 8 * kTokBytes;
}

// One pass over expert e = blockIdx.y, weight rows [m0, m0 + 16 WM):
//   GATE_UP: A0 = wg, A1 = wu [K=D, M=F]; B0 = buf [C, K];
//            out0/out1[e][c][m] = hi/lo of silu(sum_k A0[k][m] B0[c][k])
//                                          * (sum_k A1[k][m] B0[c][k])
//   down:    A0 = wd [K=F, M=D]; B0/B1 = h_hi/h_lo [C, K];
//            out0[e][c][m] = sum_k A0[k][m] (B0[c][k] + B1[c][k])
// for rows c < counts[e]; the down pass writes rows c >= counts[e] as 0.
template <bool GATE_UP, int WM, int WN, int NT, int STAGES>
__global__ void __launch_bounds__(32 * WM * WN)
grouped_ffn_tc(const bf16* __restrict__ A0, const bf16* __restrict__ A1,
               const bf16* __restrict__ B0, const bf16* __restrict__ B1,
               bf16* __restrict__ out0, bf16* __restrict__ out1,
               const int* __restrict__ counts, int C, int K, int M) {
  constexpr int kThreadsT = 32 * WM * WN;
  constexpr int kBM = 16 * WM;                  // weight rows per block
  constexpr int kWBytes = 2 * kBM;              // a staged weight row
  constexpr int kWChunks = kWBytes / 16;
  constexpr int kNA = GATE_UP ? 2 : 1;          // weight operands
  constexpr int kNB = GATE_UP ? 1 : 2;          // token operands
  constexpr int kBNt = NT * WN * 8;             // token rows per pass over the weights
  constexpr int kWTile = kTcBK * kWBytes;
  constexpr int kStage = tc_stage_bytes<GATE_UP, WM, WN, NT>();
  extern __shared__ __align__(128) unsigned char smem[];

  const int e = blockIdx.y;
  const int m0 = blockIdx.x * kBM;
  const int n_e = rows_used(counts, e, C);
  A0 += (size_t)e * K * M;
  if constexpr (GATE_UP) A1 += (size_t)e * K * M;
  B0 += (size_t)e * C * K;
  if constexpr (!GATE_UP) B1 += (size_t)e * C * K;
  out0 += (size_t)e * C * M;
  if constexpr (GATE_UP) out1 += (size_t)e * C * M;

  if constexpr (!GATE_UP) {  // rows past the count: exact zeros
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < (C - n_e) * kBM; i += kThreadsT) {
      const int c = n_e + i / kBM, m = m0 + i % kBM;
      if (m < M) out0[(size_t)c * M + m] = zero;
    }
  }
  if (n_e == 0) return;  // no routed row: the expert's weights stay unread

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int kt_n = (K + kTcBK - 1) / kTcBK;

  for (int n0 = 0; n0 < n_e; n0 += kBNt) {
    const int ntiles = min(kBNt, n_e - n0 + 7) / 8;  // 8-token tiles in use
    const int nrows = ntiles * 8;

    float acc[kNA][NT][4];
#pragma unroll
    for (int a = 0; a < kNA; ++a)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[a][j][x] = 0.f;

    // reduction slot kt into ring slot kt % STAGES (an empty group past K)
    auto fetch = [&](int kt) {
      if (kt < kt_n) {
        unsigned char* st = smem + (size_t)(kt % STAGES) * kStage;
        const int k0 = kt * kTcBK;
        for (int i = threadIdx.x; i < kNA * kTcBK * kWChunks; i += kThreadsT) {
          const int a = i / (kTcBK * kWChunks);  // powers of two: shifts and masks
          const int r = (i / kWChunks) % kTcBK;
          const int ch = i % kWChunks;
          const int gk = k0 + r, gm = m0 + ch * 8;
          const bool ok = gk < K && gm < M;  // M % 8 == 0: a chunk is wholly in or out
          const bf16* src = (a ? A1 : A0) + (ok ? (size_t)gk * M + gm : 0);
          cp_async16(st + a * kWTile + swz(r, ch, kWBytes), src, ok);
        }
        unsigned char* bt = st + kNA * kWTile;
#pragma unroll
        for (int bsel = 0; bsel < kNB; ++bsel) {
          for (int i = threadIdx.x; i < nrows * 8; i += kThreadsT) {
            const int r = i / 8;
            const int ch = i % 8;
            const int c = n0 + r, gk = k0 + ch * 8;
            const bool ok = c < n_e && gk < K;  // rows past the count read as zeros
            const bf16* src = (bsel ? B1 : B0) + (ok ? (size_t)c * K + gk : 0);
            cp_async16(bt + bsel * kBNt * kTokBytes + swz(r, ch, kTokBytes), src, ok);
          }
        }
      }
      cp_async_commit();
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) fetch(s);

    // this lane's ldmatrix rows: matrix lane / 8, row lane % 8
    const int mi = lane >> 3, mr = lane & 7;
    for (int kt = 0; kt < kt_n; ++kt) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();      // slot kt landed for every thread; slot kt - 1 is free
      fetch(kt + STAGES - 1);
      const unsigned char* st = smem + (size_t)(kt % STAGES) * kStage;
      const unsigned char* bt = st + kNA * kWTile;
#pragma unroll
      for (int ks = 0; ks < kTcBK / 16; ++ks) {
        // A (16 weight rows x 16 k) from the [k][m] tile: matrices
        // (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7), (k 8-15, m 8-15)
        uint32_t a[kNA][4];
        const int kr = ks * 16 + (mi >> 1) * 8 + mr;
        const int mch = wm * 2 + (mi & 1);
#pragma unroll
        for (int x = 0; x < kNA; ++x)
          ldmatrix_x4_trans(a[x], smem_u32(st + x * kWTile + swz(kr, mch, kWBytes)));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int nt = wn + WN * j;
          if (nt < ntiles) {
            // B (16 k x 8 tokens) from the [token][k] tile: matrices k 0-7, k 8-15
            const int nr = nt * 8 + mr;
            const int kch = ks * 2 + (mi & 1);
#pragma unroll
            for (int bsel = 0; bsel < kNB; ++bsel) {
              uint32_t b[2];
              ldmatrix_x2(b, smem_u32(bt + bsel * kBNt * kTokBytes + swz(nr, kch, kTokBytes)));
              if constexpr (GATE_UP) {
                mma_bf16(acc[0][j], a[0], b);
                mma_bf16(acc[1][j], a[1], b);
              } else {
                mma_bf16(acc[0][j], a[0], b);  // h_hi, then h_lo
              }
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next pass's copies overwrite the ring

    // accumulator element x of tile j: weight row g (+8 for x >= 2),
    // token 2t (+1 for odd x)
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nt = wn + WN * j;
      if (nt < ntiles) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int m = m0 + wm * 16 + g + (x >> 1) * 8;
          const int c = n0 + nt * 8 + 2 * t + (x & 1);
          if (m < M && c < n_e) {
            const size_t idx = (size_t)c * M + m;
            if constexpr (GATE_UP) {
              const float hv = silu_mul(acc[0][j][x], acc[1][j][x]);
              const bf16 hh = __float2bfloat16(hv);
              out0[idx] = hh;
              out1[idx] = __float2bfloat16(hv - __bfloat162float(hh));
            } else {
              out0[idx] = __float2bfloat16(acc[0][j][x]);
            }
          }
        }
      }
    }
  }
}

template <bool GATE_UP, int WM, int WN, int NT, int STAGES>
int launch_tc(const bf16* A0, const bf16* A1, const bf16* B0, const bf16* B1, bf16* out0,
              bf16* out1, const int* counts, int E, int C, int K, int M, cudaStream_t stream) {
  auto kernel = grouped_ffn_tc<GATE_UP, WM, WN, NT, STAGES>;
  const int smem = STAGES * tc_stage_bytes<GATE_UP, WM, WN, NT>();
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((M + 16 * WM - 1) / (16 * WM), E);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(A0, A1, B0, B1, out0, out1, counts, C, K, M);
  return (int)cudaGetLastError();
}

// gate_up on 4 x WN_GU warps (64 weight rows a block, NT_GU token tiles a
// warp), down on WM_DN x WN_DN warps (16 WM_DN weight rows, NT_DN tiles)
template <int WN_GU, int NT_GU, int WM_DN, int WN_DN, int NT_DN, int STAGES_DN>
int run_tc(const bf16* buf, const bf16* wg, const bf16* wu, const bf16* wd, float* h, bf16* out,
           const int* counts, int E, int C, int D, int F, cudaStream_t stream) {
  bf16* h_hi = reinterpret_cast<bf16*>(h);  // the [E,C,F] 4-byte workspace
  bf16* h_lo = h_hi + (size_t)E * C * F;    // holds the two bf16 planes
  int err = launch_tc<true, 4, WN_GU, NT_GU, 4>(wg, wu, buf, nullptr, h_hi, h_lo, counts, E, C,
                                                D, F, stream);
  if (err != 0) return err;
  return launch_tc<false, WM_DN, WN_DN, NT_DN, STAGES_DN>(wd, nullptr, h_hi, h_lo, out, nullptr,
                                                          counts, E, C, F, D, stream);
}

}  // namespace

extern "C" int repro_grouped_ffn(const void* buf, const void* wg, const void* wu,
                                 const void* wd, void* h, void* out, const void* counts, int E,
                                 int C, int D, int F, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cn = static_cast<const int*>(counts);
  float* hw = static_cast<float*>(h);
  if (is_bf16) {
    const bf16* b = static_cast<const bf16*>(buf);
    const bf16* g = static_cast<const bf16*>(wg);
    const bf16* u = static_cast<const bf16*>(wu);
    const bf16* d = static_cast<const bf16*>(wd);
    bf16* o = static_cast<bf16*>(out);
    if (D % 8 || F % 8) return launch_cuda_cores<bf16>(b, g, u, d, hw, o, cn, E, C, D, F, s);
    // decode-sized C: 8 warps, 64-row weight tiles, several blocks an SM.
    // Prefill-sized C (up to 192 tokens a pass): one block an SM holds the
    // accumulators, so it takes 16 warps to hide the latency of its
    // per-slot barrier, and the down pass takes 128-row weight tiles,
    // halving the re-reads of its token operand
    if (C <= 16) return run_tc<2, 1, 4, 2, 1, 4>(b, g, u, d, hw, o, cn, E, C, D, F, s);
    if (C <= 64) return run_tc<2, 4, 4, 2, 4, 4>(b, g, u, d, hw, o, cn, E, C, D, F, s);
    return run_tc<4, 6, 8, 2, 12, 3>(b, g, u, d, hw, o, cn, E, C, D, F, s);
  }
  return launch_cuda_cores<float>(static_cast<const float*>(buf), static_cast<const float*>(wg),
                                  static_cast<const float*>(wu), static_cast<const float*>(wd),
                                  hw, static_cast<float*>(out), cn, E, C, D, F, s);
}
