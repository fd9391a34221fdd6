// Order-preserving masked stream compaction, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel masked_compact_pallas
// (src/repro/kernels/masked_compact.py).  Same function: the rows of
// tokens[b] whose mask is set are packed in order into out[b, :K]; rows past
// capacity K are dropped; idx[b, j] is the source position of slot j (-1 for
// an empty slot, whose out row is zero); count[b] = min(kept, K).
//
// Bound: memory.  The call must read the mask, read the kept rows that fit
// under K, and write out, idx and count.  It does no arithmetic on the rows.
//
// Design.  The TPU had no warp shuffles, so it turned the scatter into a
// one-hot matmul with a running count carried in SMEM across a sequential
// grid.  Here it is the GPU form that kernel's docstring names: one block per
// batch row walks S in tiles of kThreads positions; a warp ballot plus
// popcount gives each kept row its offset inside its warp, a scan of the
// per-warp totals in shared memory gives the warp's offset inside the tile,
// and the running base carried across tiles gives the global slot.  Each warp
// then copies whole kept rows with 16-byte vector loads where the row width
// allows.  The copy is a byte copy, so out matches the plain version bit for
// bit; no float is ever accumulated.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename V>
__global__ void __launch_bounds__(kThreads)
masked_compact_kernel(const uint8_t* __restrict__ tokens, const uint8_t* __restrict__ mask,
                      uint8_t* __restrict__ out, int* __restrict__ idx,
                      int* __restrict__ count, int S, int row_bytes, int K) {
  __shared__ int warp_total[kWarps];
  __shared__ int tile_src[kThreads];  // source position of the tile's j-th kept row

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nv = row_bytes / (int)sizeof(V);
  const uint8_t* mb = mask + (size_t)b * S;
  const uint8_t* tb = tokens + (size_t)b * S * row_bytes;
  uint8_t* ob = out + (size_t)b * K * row_bytes;
  int* ib = idx + (size_t)b * K;

  int base = 0;  // kept rows before this tile; identical in every thread
  for (int s0 = 0; s0 < S; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    const bool keep = s < S && mb[s] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int warp_off = 0, tile_n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_total[w];
      warp_off += (w < warp) ? c : 0;
      tile_n += c;
    }
    if (keep) tile_src[warp_off + __popc(ballot & ((1u << lane) - 1u))] = s;
    __syncthreads();

    const int n_copy = max(0, min(tile_n, K - base));
    for (int j = threadIdx.x; j < n_copy; j += kThreads) ib[base + j] = tile_src[j];
    for (int j = warp; j < n_copy; j += kWarps) {
      const V* src = reinterpret_cast<const V*>(tb + (size_t)tile_src[j] * row_bytes);
      V* dst = reinterpret_cast<V*>(ob + (size_t)(base + j) * row_bytes);
      for (int e = lane; e < nv; e += 32) dst[e] = src[e];
    }
    base += tile_n;
    __syncthreads();  // tile_src and warp_total are rewritten next tile
  }

  const int cnt = min(base, K);
  for (int j = cnt + threadIdx.x; j < K; j += kThreads) ib[j] = -1;
  V* zero = reinterpret_cast<V*>(ob + (size_t)cnt * row_bytes);
  const size_t n_zero = (size_t)(K - cnt) * nv;
  const V z{};
  for (size_t e = threadIdx.x; e < n_zero; e += kThreads) zero[e] = z;
  if (threadIdx.x == 0) count[b] = cnt;
}

template <typename V>
int launch(const void* tokens, const void* mask, void* out, void* idx, void* count, int B,
           int S, int row_bytes, int K, cudaStream_t stream) {
  masked_compact_kernel<V><<<B, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(tokens), static_cast<const uint8_t*>(mask),
      static_cast<uint8_t*>(out), static_cast<int*>(idx), static_cast<int*>(count), S,
      row_bytes, K);
  return (int)cudaGetLastError();
}

}  // namespace

// The widest vector that divides the row and both row buffers' alignment.
extern "C" int repro_masked_compact(const void* tokens, const void* mask, void* out,
                                    void* idx, void* count, int B, int S, int row_bytes,
                                    int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)tokens | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0) return launch<uint4>(tokens, mask, out, idx, count, B, S, row_bytes, K, s);
  if (align % 4 == 0) return launch<uint32_t>(tokens, mask, out, idx, count, B, S, row_bytes, K, s);
  if (align % 2 == 0) return launch<uint16_t>(tokens, mask, out, idx, count, B, S, row_bytes, K, s);
  return launch<uint8_t>(tokens, mask, out, idx, count, B, S, row_bytes, K, s);
}

// Message for a code returned by either kernel's launch function.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
