// Order-preserving masked stream compaction, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel masked_compact_pallas
// (src/repro/kernels/masked_compact.py:70, pallas_call at :81).  Same
// function: the rows of tokens[b] whose mask is set are packed in order into
// out[b, :K]; rows past capacity K are dropped; idx[b, j] is the source
// position of slot j (-1 for an empty slot, whose out row is zero);
// count[b] = min(kept, K).  It is a byte copy, so out matches the plain
// version bit for bit; no float is ever accumulated.
//
// Bound: bytes.  The call must read the mask and the kept rows that fit under
// K, and write every out row (zeros too), idx and count.  It does no
// arithmetic on the rows.
//
// Design.  The first port ran one block per batch row, walking S serially in
// 256-row tiles: 11 blocks on 132 SMs at the payload's [11,128,2048], with
// each lane holding one 16-byte load in flight.  Here the grid runs over
// (b, tile of source rows, chunk of the row's bytes), and the host's plan
// (kernels/masked_compact.py:masked_compact_plan) picks the tile (32-256
// rows) and the chunk count from the shapes alone so that the card holds
// several blocks an SM.  A block needs its base, the kept rows before its
// tile, and the row's total; nothing is carried between blocks:
//   - short rows: the block counts the mask before its tile and after it
//     itself, reading it from L2 as 16-byte words (__vsetne4 marks each
//     nonzero byte, __popc counts them);
//   - long rows (plan.long_rows): recounting the prefix in every block grows
//     as S^2 / tile, so a count pass (one warp a tile) first writes each
//     tile's kept rows into a [B, n_tiles] int32 workspace, and each block
//     sums the counts before its tile.
// The recount reads the mask from L2, which all of a row's blocks share:
// measured on the card it costs less than the count pass's extra launch
// until a row's blocks recount some 32 MB of mask in all (at S = 32768:
// 32-row tiles in two chunks, or 64-row tiles in four), so the plan takes
// the count pass only beyond that (PERF.md).  The counts are integers, so both give the same
// bits on every call.  Inside the tile a
// warp ballot plus popcount gives each kept row its offset, a scan of the
// per-warp totals in shared memory the tile's order.  The block then moves
// its chunk of each kept row, every lane issuing kUnroll independent 16-byte
// loads before its stores (narrower vectors where the row width or a pointer
// is not 16-byte aligned).  The empty slots [count, K) are cut into n_tiles
// ranges, one per tile, so the zero tail is written by all of row b's blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one thread per row of the largest tile
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // vector loads in flight per lane before its stores

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This thread's share of the nonzero bytes in p[lo, hi): an unaligned head
// and tail byte by byte, the body as 16-byte words.
__device__ __forceinline__ int count_set(const uint8_t* __restrict__ p, int lo, int hi) {
  if (lo >= hi) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p + lo);
  const uintptr_t e = reinterpret_cast<uintptr_t>(p + hi);
  const uintptr_t a16 = (a + 15) & ~uintptr_t(15);
  const uintptr_t e16 = e & ~uintptr_t(15);
  int n = 0;
  if (a16 >= e16) {  // no whole word inside
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) n += p[i] != 0;
    return n;
  }
  const int head = (int)(a16 - a), tail = (int)(e - e16);
  if ((int)threadIdx.x < head) n += p[lo + threadIdx.x] != 0;
  if ((int)threadIdx.x < tail) n += p[hi - tail + threadIdx.x] != 0;
  const uint4* w = reinterpret_cast<const uint4*>(a16);
  const int nw = (int)((e16 - a16) >> 4);
  for (int i = threadIdx.x; i < nw; i += kThreads) {
    const uint4 v = w[i];
    n += __popc(__vsetne4(v.x, 0u)) + __popc(__vsetne4(v.y, 0u)) +
         __popc(__vsetne4(v.z, 0u)) + __popc(__vsetne4(v.w, 0u));
  }
  return n;
}

// Long rows, first pass: one warp per tile writes the tile's kept rows to
// ws[b * n_tiles + t].  Grid: B * ceil(n_tiles / kWarps) blocks.
__global__ void __launch_bounds__(kThreads)
tile_count_kernel(const uint8_t* __restrict__ mask, int* __restrict__ ws, int S, int T,
                  int n_tiles) {
  const int groups = (n_tiles + kWarps - 1) / kWarps;
  const int b = blockIdx.x / groups;
  const int t = (blockIdx.x % groups) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= n_tiles) return;
  const uint8_t* mb = mask + (size_t)b * S;
  const int lo = min(t * T, S), hi = min(lo + T, S);
  int n = 0;
  for (int s = lo + lane; s < hi; s += 32) n += mb[s] != 0;
  n = warp_sum(n);
  if (lane == 0) ws[(size_t)b * n_tiles + t] = n;
}

// Block (b, t, c) with blockIdx.x = (b * n_tiles + t) * chunks + c: the kept
// rows of source rows [t*T, t*T + T) and empty slots [z0, z1), vectors
// [v0, v0 + w) of each row.
template <typename V, bool kLongRows>
__global__ void __launch_bounds__(kThreads)
masked_compact_kernel(const uint8_t* __restrict__ tokens, const uint8_t* __restrict__ mask,
                      const int* __restrict__ ws, uint8_t* __restrict__ out,
                      int* __restrict__ idx, int* __restrict__ count, int S, int row_bytes,
                      int K, int T, int n_tiles, int chunks) {
  __shared__ int red[2][kWarps];
  __shared__ int warp_n[kWarps];
  __shared__ int tile_src[kThreads];  // source position of the tile's j-th kept row

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x % chunks;
  const int bt = blockIdx.x / chunks;
  const int t = bt % n_tiles, b = bt / n_tiles;
  const int lo = min(t * T, S), hi = min(lo + T, S);
  const uint8_t* mb = mask + (size_t)b * S;

  // kept rows before the tile and from the tile on, this thread's share
  int before = 0, after = 0;
  if (kLongRows) {
    const int* wb = ws + (size_t)b * n_tiles;
    for (int i = threadIdx.x; i < n_tiles; i += kThreads) {
      const int v = wb[i];
      if (i < t) before += v; else after += v;
    }
  } else {
    before = count_set(mb, 0, lo);
    after = count_set(mb, lo, S);
  }
  const int s = lo + threadIdx.x;
  const bool keep = s < hi && mb[s] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  before = warp_sum(before);
  after = warp_sum(after);
  if (lane == 0) {
    red[0][warp] = before;
    red[1][warp] = after;
    warp_n[warp] = __popc(ballot);
  }
  __syncthreads();
  int base = 0, total = 0, warp_off = 0, tile_n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    base += red[0][w];
    total += red[1][w];
    const int cw = warp_n[w];
    warp_off += (w < warp) ? cw : 0;
    tile_n += cw;
  }
  total += base;
  if (keep) tile_src[warp_off + __popc(ballot & ((1u << lane) - 1u))] = s;
  __syncthreads();

  const int cnt = min(total, K);
  const int n_copy = max(0, min(tile_n, K - base));
  const int z = K - cnt;  // empty slots, cut into one range per tile
  const int z0 = cnt + (int)((long long)z * t / n_tiles);
  const int z1 = cnt + (int)((long long)z * (t + 1) / n_tiles);
  int* ib = idx + (size_t)b * K;
  if (c == 0) {
    for (int j = threadIdx.x; j < n_copy; j += kThreads) ib[base + j] = tile_src[j];
    for (int j = z0 + threadIdx.x; j < z1; j += kThreads) ib[j] = -1;
    if (t == 0 && threadIdx.x == 0) count[b] = cnt;
  }

  const int nv = row_bytes / (int)sizeof(V);
  const int per = (nv + chunks - 1) / chunks;
  const int v0 = min(c * per, nv);
  const int w = min(v0 + per, nv) - v0;
  if (w <= 0) return;
  const V* tb = reinterpret_cast<const V*>(tokens + (size_t)b * S * row_bytes) + v0;
  V* ob = reinterpret_cast<V*>(out + (size_t)b * K * row_bytes) + v0;

  const int n = n_copy * w;
  for (int e0 = threadIdx.x; e0 < n; e0 += kUnroll * kThreads) {
    V r[kUnroll];
    size_t dst[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u * kThreads;
      if (e < n) {
        const int j = e / w, col = e - j * w;
        r[u] = tb[(size_t)tile_src[j] * nv + col];
        dst[u] = (size_t)(base + j) * nv + col;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (e0 + u * kThreads < n) ob[dst[u]] = r[u];
  }
  const int nz = (z1 - z0) * w;
  const V zero{};
  for (int e = threadIdx.x; e < nz; e += kThreads) {
    const int j = e / w, col = e - j * w;
    ob[(size_t)(z0 + j) * nv + col] = zero;
  }
}

template <typename V>
int launch(const void* tokens, const void* mask, void* out, void* idx, void* count, void* ws,
           int B, int S, int row_bytes, int K, int T, int n_tiles, int chunks,
           cudaStream_t stream) {
  const auto* tk = static_cast<const uint8_t*>(tokens);
  const auto* mk = static_cast<const uint8_t*>(mask);
  auto* ob = static_cast<uint8_t*>(out);
  auto* ib = static_cast<int*>(idx);
  auto* cb = static_cast<int*>(count);
  auto* wk = static_cast<int*>(ws);
  const int blocks = B * n_tiles * chunks;
  if (wk != nullptr) {
    const int groups = (n_tiles + kWarps - 1) / kWarps;
    tile_count_kernel<<<B * groups, kThreads, 0, stream>>>(mk, wk, S, T, n_tiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    masked_compact_kernel<V, true><<<blocks, kThreads, 0, stream>>>(
        tk, mk, wk, ob, ib, cb, S, row_bytes, K, T, n_tiles, chunks);
  } else {
    masked_compact_kernel<V, false><<<blocks, kThreads, 0, stream>>>(
        tk, mk, nullptr, ob, ib, cb, S, row_bytes, K, T, n_tiles, chunks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ws: NULL for the short-row branch, else an int32 workspace of B * n_tiles.
// The plan must satisfy 1 <= T <= 256, n_tiles * T >= max(S, K, 1) and
// 1 <= chunks; the wrapper checks it.  The widest vector that divides the
// row and both row buffers' alignment moves the bytes.
extern "C" int repro_masked_compact(const void* tokens, const void* mask, void* out,
                                    void* idx, void* count, void* ws, int B, int S,
                                    int row_bytes, int K, int T, int n_tiles, int chunks,
                                    void* stream) {
  if (T < 1 || T > kThreads || chunks < 1 || n_tiles < 1 ||
      (long long)n_tiles * T < (long long)(S > K ? S : K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)tokens | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0)
    return launch<uint4>(tokens, mask, out, idx, count, ws, B, S, row_bytes, K, T, n_tiles,
                         chunks, s);
  if (align % 4 == 0)
    return launch<uint32_t>(tokens, mask, out, idx, count, ws, B, S, row_bytes, K, T,
                            n_tiles, chunks, s);
  if (align % 2 == 0)
    return launch<uint16_t>(tokens, mask, out, idx, count, ws, B, S, row_bytes, K, T,
                            n_tiles, chunks, s);
  return launch<uint8_t>(tokens, mask, out, idx, count, ws, B, S, row_bytes, K, T, n_tiles,
                         chunks, s);
}

// Message for a code returned by any kernel's launch function.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
