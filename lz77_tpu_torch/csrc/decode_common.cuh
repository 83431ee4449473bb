// Shared by the two token-replay kernels (decode_walk.cu, K3, and
// decode_walk_packed.cu, K6): where every token starts in the output.
//
// A decode token word is off | len<<16 | next<<24 and produces len + 1
// bytes, so token i starts at the exclusive prefix sum of len + 1.  The sum
// runs as two stream-ordered kernels: per-block sums over SCAN_CHUNK tokens,
// then one block that turns the sums into block starts and the grand total.
// A consumer re-scans its own block of tokens from the block's start.  The
// kernels are static: each source that includes this header links its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lz77 {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;  // tokens per block

// Inclusive scan of v over a thread block of NWARPS warps; *total is the
// block's sum.  warp_sums holds NWARPS ints of shared memory.
template <int NWARPS>
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < NWARPS; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    all += s;
  }
  __syncthreads();  // warp_sums may be written again
  *total = all;
  return v + before;
}

// Output bytes of token i (0 past the last token).
__device__ __forceinline__ int token_size(const int32_t* toks, int T,
                                          long long i) {
  return i < T ? (int)(((uint32_t)toks[i] >> 16) & 0xFFu) + 1 : 0;
}

// sums[b] <- output bytes of tokens [b * SCAN_CHUNK, (b + 1) * SCAN_CHUNK).
static __global__ void __launch_bounds__(SCAN_THREADS) token_sums_kernel(
    const int32_t* __restrict__ toks, int T, int32_t* __restrict__ sums) {
  __shared__ int ws[SCAN_THREADS / 32];
  const long long base = (long long)blockIdx.x * SCAN_CHUNK + threadIdx.x;
  int s = 0;
  for (int it = 0; it < SCAN_ITEMS; ++it)
    s += token_size(toks, T, base + it * SCAN_THREADS);
  int total;
  block_inclusive_scan<SCAN_THREADS / 32>(s, ws, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// One block: sums[b] <- sum of sums[0..b), *cnt <- sum of all.
static __global__ void __launch_bounds__(SCAN_THREADS) token_starts_kernel(
    int32_t* __restrict__ sums, int nb, int32_t* __restrict__ cnt) {
  __shared__ int ws[SCAN_THREADS / 32];
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += SCAN_THREADS) {
    const int i = b0 + threadIdx.x;
    const int v = i < nb ? sums[i] : 0;
    int total;
    const int inc = block_inclusive_scan<SCAN_THREADS / 32>(v, ws, &total);
    if (i < nb) sums[i] = carry + inc - v;
    carry += total;
  }
  if (threadIdx.x == 0) *cnt = carry;
}

// Launch both: sums (ceil(T / SCAN_CHUNK) ints) <- the start of every block
// of tokens, *cnt <- sum(len + 1) over all T tokens.  Returns the block
// count through *nb_out.
static inline cudaError_t launch_token_starts(const int32_t* toks, int T,
                                       int32_t* sums, int32_t* cnt,
                                       cudaStream_t stream, int* nb_out) {
  const int nb = (int)(((long long)T + SCAN_CHUNK - 1) / SCAN_CHUNK);
  *nb_out = nb;
  if (nb > 0) {
    token_sums_kernel<<<nb, SCAN_THREADS, 0, stream>>>(toks, T, sums);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  token_starts_kernel<<<1, SCAN_THREADS, 0, stream>>>(sums, nb, cnt);
  return cudaGetLastError();
}

}  // namespace lz77
