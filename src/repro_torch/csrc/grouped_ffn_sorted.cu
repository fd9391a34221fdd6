// Grouped (per-expert) SwiGLU FFN over expert-sorted rows, written by hand
// for Hopper (sm_90a) with wgmma fed by TMA.
//
// Replaces no Pallas kernel: the JAX package runs the MoE's experts over an
// [E, C, D] capacity buffer (grouped_ffn_pallas, whose port is
// csrc/grouped_ffn.cu).  This kernel serves the dropless layer's prefill,
// where every expert takes a few hundred of a prompt's routed rows:
//   ys[r] = (silu(xs[r] . wg[e]) * (xs[r] . wu[e])) . wd[e]
// for offsets[e] <= r < offsets[e + 1], with xs and ys [R, D] (R = T.K
// choices sorted by expert), wg/wu [E, D, F], wd [E, F, D], all bf16, and
// offsets int32 [E + 1] on the device (the exclusive cumsum of the per-expert
// counts).  g and u are accumulated in f32, h = silu(g) * u is formed in f32
// and kept as a hi/lo bf16 pair (h_hi = bf16(h), h_lo = bf16(h - h_hi): the
// 4 bytes of an f32 h, about 16 mantissa bits), h . wd multiplies both planes
// into one f32 accumulator, and ys is rounded once to bf16: the numbers of
// grouped_ffn.cu's tensor-core path.
//
// Bound: the tensor cores.  moonlight-16b-a3b's 7,168-token prefill routes
// R = 43,008 rows a layer over E = 64 experts (D 2,048, F 1,408): 6 R D F =
// 0.74 TFLOP, 0.99 with the down pass's second plane (1.0 ms at 989 TFLOP/s),
// against 1.11 GB of weights read once and 0.84 GB of rows, h (written, then
// read) and output: 0.58 ms at 3.35 TB/s together.
//
// Design.  Two passes, launched back to back on the caller's stream:
//   1. gate_up: h[r] = silu(xs[r] . wg[e]) * (xs[r] . wu[e]), tiles of
//      128 rows x 128 columns of F, gate and up both;
//   2. down:    ys[r] = (h_hi[r] + h_lo[r]) . wd[e], tiles of 128 rows x 256
//      columns of D.
// The rows are the M operand: a tile holds 128 rows of one expert, from
// offsets[e] + 128 m on, and never spans two experts (its rows past the
// expert's end are computed on whatever follows, zeros past R, and not
// stored).  The grid is the host-known bound (ceil(R / 128) + E) x the
// column tiles, expert-major, so an expert's tiles run together and its
// weights stay in the 50 MB L2; each block finds its (expert, row tile) from
// offsets with one warp's scan, and blocks past the last tile exit, so the
// launch needs no host sync.  A block is three warpgroups: one producer
// thread issues the TMA loads (128-byte swizzled tiles, rows past R or K and
// columns past N zero-filled) into a ring of stages guarded by full/empty
// mbarriers; two consumer warpgroups, 64 rows each, run wgmma
// (m64n128k16 / m64n256k16, bf16 in, f32 accumulate) with the rows K-major
// and the weights MN-major (trans-b) straight from the swizzled tiles, one
// k-tile's group in flight while the next is issued.  The epilogue writes
// the accumulators from registers.  Each output is summed by one warpgroup
// in a fixed order, with no atomics: the same bits on every call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;           // rows a tile: two consumer warpgroups of 64
constexpr int kBK = 64;            // reduction depth a stage: one 128-byte row
constexpr int kThreads = 384;      // the producer warpgroup, then two consumers
constexpr int kATile = kBM * kBK * 2;   // a 128-row operand tile, 16 KB
constexpr int kChunk = kBK * 64 * 2;    // 64 K rows x 64 columns of weights, 8 KB

// gate_up: 128 columns of F, one row operand (xs), two weight operands (wg,
// wu), 4 stages; down: 256 columns of D, two row operands (h_hi, h_lo), one
// weight operand (wd), 3 stages; 192 KB of ring either way
template <bool GATE_UP> struct Tile {
  static constexpr int BN = GATE_UP ? 128 : 256;
  static constexpr int NA = GATE_UP ? 1 : 2;
  static constexpr int NB = GATE_UP ? 2 : 1;
  static constexpr int STAGES = GATE_UP ? 4 : 3;
  static constexpr int BTILE = kBK * BN * 2;
  static constexpr int STAGE = NA * kATile + NB * BTILE;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;  // + barriers, alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + expf(-g)) * u; }

// --- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA --------------------------------------------------------------------
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------
// A shared-memory matrix descriptor of a 128-byte swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// rows, K-major: 128-byte rows, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t row_desc(uint32_t addr) { return smem_desc(addr, 16, 1024); }
// weights, MN-major: 64-column chunks kChunk bytes apart (leading), 8-row
// groups of K 1024 bytes apart (stride)
__device__ __forceinline__ uint64_t weight_desc(uint32_t addr) {
  return smem_desc(addr, kChunk, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator registers across an async wgmma
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a . b over m64n128k16 (a K-major, b MN-major: trans-b 1)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d += a . b over m64n256k16 (a K-major, b MN-major: trans-b 1)
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// The block's tile: expert e, rows [row0, min(row0 + kBM, row_end)), or e =
// -1 past the last tile.  Warp 0 scans ceil(count / kBM) over the experts.
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets, int E, int slot,
                                          int* info) {
  const int lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < E; base += 32) {
    const int e = base + lane;
    const int lo = e < E ? offsets[e] : 0;
    const int hi = e < E ? offsets[e + 1] : 0;
    const int n = (hi - lo + kBM - 1) / kBM;
    int inc = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const int first = carry + inc - n;
    const bool mine = e < E && slot >= first && slot < first + n;
    if (__ballot_sync(0xffffffffu, mine)) {
      if (mine) {
        info[0] = e;
        info[1] = lo + (slot - first) * kBM;
        info[2] = hi;
      }
      return;
    }
    carry += __shfl_sync(0xffffffffu, inc, 31);
  }
  if (lane == 0) info[0] = -1;
}

// One pass over block (slot, column tile):
//   GATE_UP: a0 = xs [R, K=D]; b0/b1 = wg/wu [E, K, N=F];
//            out0/out1 [R, N] = hi/lo of silu(a0 . b0) * (a0 . b1)
//   down:    a0/a1 = h_hi/h_lo [R, K=F]; b0 = wd [E, K, N=D];
//            out0 [R, N] = a0 . b0 + a1 . b0
// for the rows of the block's expert.
template <bool GATE_UP>
__global__ void __launch_bounds__(kThreads, 1)
grouped_ffn_sorted_wgmma(const __grid_constant__ CUtensorMap a0, const __grid_constant__ CUtensorMap a1,
                         const __grid_constant__ CUtensorMap b0, const __grid_constant__ CUtensorMap b1,
                         const int* __restrict__ offsets, bf16* __restrict__ out0,
                         bf16* __restrict__ out1, int E, int K, int N) {
  using P = Tile<GATE_UP>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int info[3];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + P::STAGES * P::STAGE;   // STAGES barriers, then STAGES more
  const uint32_t empty = full + 8 * P::STAGES;

  const int n_tiles = (N + P::BN - 1) / P::BN;
  const int slot = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * P::BN;
  if (threadIdx.x < 32) find_tile(offsets, E, slot, info);
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int e = info[0];
  if (e < 0) return;  // past the last tile
  const int row0 = info[1], row_end = info[2];
  const int kt_n = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % P::STAGES;
        mbar_wait(empty + 8 * s, ((kt / P::STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, P::STAGE);
        const uint32_t st = base + s * P::STAGE;
        const int k0 = kt * kBK;
        tma_2d(st, &a0, k0, row0, bar);
        if constexpr (!GATE_UP) tma_2d(st + kATile, &a1, k0, row0, bar);
        const uint32_t bt = st + P::NA * kATile;
#pragma unroll
        for (int c = 0; c < P::BN / 64; ++c) {
          tma_3d(bt + c * kChunk, &b0, n0 + 64 * c, k0, e, bar);
          if constexpr (GATE_UP) tma_3d(bt + P::BTILE + c * kChunk, &b1, n0 + 64 * c, k0, e, bar);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;                 // rows [64 cw, 64 cw + 64) of the tile
    constexpr int kAcc = GATE_UP ? 64 : 128;
    float acc[P::NB][kAcc];
#pragma unroll
    for (int b = 0; b < P::NB; ++b)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[b][i] = 0.f;

    for (int kt = 0; kt < kt_n; ++kt) {
      const int s = kt % P::STAGES;
      mbar_wait(full + 8 * s, (kt / P::STAGES) & 1);
      const uint32_t st = base + s * P::STAGE;
      const uint32_t at = st + cw * (kATile / 2);
      const uint32_t bt = st + P::NA * kATile;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        const uint64_t bd0 = weight_desc(bt + k * 2048);   // 16 K rows of 128 bytes
        if constexpr (GATE_UP) {
          const uint64_t ad = row_desc(at + k * 32);       // 16 K values of 2 bytes
          wgmma_n128(acc[0], ad, bd0);
          wgmma_n128(acc[1], ad, weight_desc(bt + P::BTILE + k * 2048));
        } else {
          wgmma_n256(acc[0], row_desc(at + k * 32), bd0);             // h_hi
          wgmma_n256(acc[0], row_desc(at + kATile + k * 32), bd0);    // h_lo
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-tile's products are done: free its slot
#pragma unroll
      for (int b = 0; b < P::NB; ++b) fence_regs(acc[b]);
      if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % P::STAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int b = 0; b < P::NB; ++b) fence_regs(acc[b]);

    // accumulator 4 j + x: row lane / 4 (+8 for x >= 2) of the warp's 16,
    // column 8 j + 2 (lane % 4) (+1 for odd x)
    const int lane = threadIdx.x & 31;
    const int r_top = row0 + 64 * cw + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < P::BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r_top + 8 * half;
        if (r < row_end && col < N) {
          const int x = 4 * j + 2 * half;
          const size_t idx = (size_t)r * N + col;
          if constexpr (GATE_UP) {
            const float h0 = silu_mul(acc[0][x], acc[1][x]);
            const float h1 = silu_mul(acc[0][x + 1], acc[1][x + 1]);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
            *reinterpret_cast<__nv_bfloat162*>(out0 + idx) = hi;
            *reinterpret_cast<__nv_bfloat162*>(out1 + idx) = __floats2bfloat162_rn(
                h0 - __low2float(hi), h1 - __high2float(hi));
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out0 + idx) =
                __floats2bfloat162_rn(acc[0][x], acc[0][x + 1]);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda.so.1 PyTorch has loaded (no link-time libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a bf16 tensor of `rank` dims (innermost first) read in 128-byte swizzled
// boxes of 64 x box1 (x 1): rows of a matrix, or one expert's weights
bool tensor_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, cuuint32_t box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GATE_UP>
int launch_pass(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& b0,
                const CUtensorMap& b1, const int* offsets, bf16* out0, bf16* out1, int slots,
                int E, int K, int N, cudaStream_t stream) {
  using P = Tile<GATE_UP>;
  auto kernel = grouped_ffn_sorted_wgmma<GATE_UP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = slots * ((N + P::BN - 1) / P::BN);
  kernel<<<grid, kThreads, P::SMEM, stream>>>(a0, a1, b0, b1, offsets, out0, out1, E, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// xs [R, D], wg/wu [E, D, F], wd [E, F, D], offsets int32 [E + 1], h the
// 4-byte workspace [2, R, F] (the h_hi and h_lo planes), ys [R, D]; bf16,
// D and F multiples of 8, 16-byte aligned.  Returns a cudaError_t
// (cudaErrorInvalidValue where a tensor map cannot be made).
extern "C" int repro_grouped_ffn_sorted(const void* xs, const void* wg, const void* wu,
                                        const void* wd, const void* offsets, void* h, void* ys,
                                        int R, int E, int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* h_hi = static_cast<bf16*>(h);
  bf16* h_lo = h_hi + (size_t)R * F;
  const cuuint64_t rows_x[2] = {(cuuint64_t)D, (cuuint64_t)R};
  const cuuint64_t rows_h[2] = {(cuuint64_t)F, (cuuint64_t)R};
  const cuuint64_t w_up[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t w_down[3] = {(cuuint64_t)D, (cuuint64_t)F, (cuuint64_t)E};
  const cuuint64_t st_x[1] = {(cuuint64_t)D * 2};
  const cuuint64_t st_h[1] = {(cuuint64_t)F * 2};
  const cuuint64_t st_up[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  const cuuint64_t st_down[2] = {(cuuint64_t)D * 2, (cuuint64_t)F * D * 2};
  CUtensorMap m_x, m_g, m_u, m_hi, m_lo, m_d;
  if (!tensor_map(&m_x, xs, 2, rows_x, st_x, kBM) || !tensor_map(&m_g, wg, 3, w_up, st_up, kBK) ||
      !tensor_map(&m_u, wu, 3, w_up, st_up, kBK) || !tensor_map(&m_hi, h_hi, 2, rows_h, st_h, kBM) ||
      !tensor_map(&m_lo, h_lo, 2, rows_h, st_h, kBM) ||
      !tensor_map(&m_d, wd, 3, w_down, st_down, kBK))
    return (int)cudaErrorInvalidValue;
  const int* off = static_cast<const int*>(offsets);
  const int slots = (R + kBM - 1) / kBM + E;   // every expert's row tiles fit
  int err = launch_pass<true>(m_x, m_x, m_g, m_u, off, h_hi, h_lo, slots, E, D, F, s);
  if (err != 0) return err;
  return launch_pass<false>(m_hi, m_lo, m_d, m_d, off, static_cast<bf16*>(ys), nullptr, slots, E,
                            F, D, s);
}
