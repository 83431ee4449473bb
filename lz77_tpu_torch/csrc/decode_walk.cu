// K3: token replay into bytes (decode).
//
// Replaces the TPU kernel lz77_tpu/ops/decode_walk.py::_kernel.  Same
// contract as ops/decode_walk.py::walk_decode: token word is
// off | len<<16 | next<<24; a token copies `len` bytes from `off` behind the
// write cursor with byte-serial semantics (lz77.c:178-188: an overlapping
// copy, off < len, repeats the off-byte pattern), then writes `next`.
//
// The replay is serial only through its copy chains, so it runs as parent
// pointers over the output bytes, in stream-ordered kernels:
//   1. token_sums / token_starts (decode_common.cuh, shared with K6):
//      exclusive scan of len+1 over the tokens (per-block sums, then one
//      block scans the sums): every token's start.
//   2. decode_iota / decode_init: every byte starts as its own root; a warp
//      takes 32 tokens and walks their bytes in order (coalesced), finds
//      each byte's token by a shuffle search over the 32 starts, and writes
//      the literal's value, or for copy byte q the parent
//      start - off + (q mod off).  That parent lies before the token for
//      every off >= 1, so overlapping copies cost no hop and a chain hops
//      from token to strictly earlier token.
//   3. decode_jump, up to 1 + bits(T) rounds: ptr[j] <- ptr[ptr[j]], in
//      place.  A racing read sees some ancestor, which is as good; each
//      round at least halves every chain.  A round that changes nothing
//      clears the way for the rest to return at once (a flag per round), so
//      the cost follows this stream's deepest chain, not the bound.
//   4. decode_gather: out[j] = out[ptr[j]] (roots are literals, history
//      bytes, or zero for a malformed source).
// `buf` holds wp history bytes and then the output (window priming), and
// indices into it are what ptr holds, so a source may reach back to -wp.
// Malformed input cannot fault: a token that does not fit out_cap writes
// nothing, and a copy with off == 0 or a source before the history reads 0
// (the wrapper zeroes buf).

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

using lz77::FULL;
constexpr int THREADS = lz77::SCAN_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = lz77::SCAN_ITEMS;
constexpr int CHUNK = lz77::SCAN_CHUNK;  // tokens per thread block

__global__ void __launch_bounds__(THREADS) decode_iota_kernel(
    int32_t* __restrict__ ptr, long long n) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j < n) ptr[j] = (int32_t)j;
}

__global__ void __launch_bounds__(THREADS) decode_init_kernel(
    const int32_t* __restrict__ toks, int T,
    const int32_t* __restrict__ block_starts, uint8_t* __restrict__ buf,
    int32_t* __restrict__ ptr, int wp, long long out_cap) {
  __shared__ int ws[WARPS];
  const int lane = threadIdx.x & 31;
  long long run = block_starts[blockIdx.x];
  for (int it = 0; it < ITEMS; ++it) {
    const long long i =
        (long long)blockIdx.x * CHUNK + it * THREADS + threadIdx.x;
    const uint32_t w = i < T ? (uint32_t)toks[i] : 0u;
    const int off = (int)(w & 0xFFFFu);
    const int ln = (int)((w >> 16) & 0xFFu);
    const int sz = i < T ? ln + 1 : 0;
    int total;
    const int inc = lz77::block_inclusive_scan<WARPS>(sz, ws, &total);
    const long long start = run + inc - sz;
    run += total;
    // this warp's 32 tokens cover output positions [g0, g1); a dead token
    // (past T) has size 0 and start g1, so the search never lands on it
    const long long g0 = __shfl_sync(FULL, start, 0);
    const long long g1 = __shfl_sync(FULL, start + sz, 31);
    for (long long jb = g0; jb < g1; jb += 32) {  // uniform: all lanes shuffle
      const long long j = jb + lane;
      int k = 0;  // largest token of the 32 with start <= j
      for (int step = 16; step; step >>= 1) {
        const int c = k + step;
        const long long s = __shfl_sync(FULL, start, c & 31);
        if (c < 32 && s <= j) k = c;
      }
      const long long st = __shfl_sync(FULL, start, k);
      const int o = __shfl_sync(FULL, off, k);
      const int l = __shfl_sync(FULL, ln, k);
      const uint32_t wk = __shfl_sync(FULL, w, k);
      if (j < g1 && st + l < out_cap) {  // the whole token fits
        const int q = (int)(j - st);
        if (q == l) {
          buf[wp + j] = (uint8_t)(wk >> 24);
        } else if (o != 0) {
          const long long src = st - o + q % o;
          if (src >= -(long long)wp) ptr[wp + j] = (int32_t)(wp + src);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) decode_jump_kernel(
    int32_t* ptr, long long lo, long long hi, const int32_t* prev_changed,
    int32_t* changed) {
  if (prev_changed != nullptr && *prev_changed == 0) return;  // converged
  const long long j = lo + (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= hi) return;
  const int32_t p = ptr[j];
  const int32_t pp = ptr[p];
  if (pp != p) {
    ptr[j] = pp;
    // millions of stores to one word serialise in L2: store only while the
    // (per-SM cached) flag still reads 0
    if (*changed == 0) *changed = 1;
  }
}

__global__ void __launch_bounds__(THREADS) decode_gather_kernel(
    uint8_t* buf, const int32_t* __restrict__ ptr, long long lo,
    long long hi) {
  const long long j = lo + (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j < hi) buf[j] = buf[ptr[j]];  // a root keeps its own byte
}

}  // namespace

#define LZ77_CHECK_LAUNCH()                          \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return (int)e_;           \
  } while (0)

// buf: wp history bytes then out_cap output bytes, zeroed past the history.
// sums: ceil(T / 2048) int32; ptr: wp + out_cap int32; flags: rounds int32,
// zeroed.  cnt receives sum(len + 1) over all T tokens.
extern "C" int lz77_walk_decode(
    const void* toks, int T, void* buf, int wp, long long out_cap, void* cnt,
    void* sums, void* ptr, void* flags, int rounds, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  int nb;
  if (cudaError_t e = lz77::launch_token_starts(
          (const int32_t*)toks, T, (int32_t*)sums, (int32_t*)cnt, stream, &nb))
    return (int)e;
  if (nb == 0 || out_cap <= 0) return 0;
  const long long n = (long long)wp + out_cap;
  const unsigned all_blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const unsigned out_blocks = (unsigned)((out_cap + THREADS - 1) / THREADS);
  decode_iota_kernel<<<all_blocks, THREADS, 0, stream>>>((int32_t*)ptr, n);
  LZ77_CHECK_LAUNCH();
  decode_init_kernel<<<nb, THREADS, 0, stream>>>(
      (const int32_t*)toks, T, (const int32_t*)sums, (uint8_t*)buf,
      (int32_t*)ptr, wp, out_cap);
  LZ77_CHECK_LAUNCH();
  int32_t* changed = (int32_t*)flags;
  for (int r = 0; r < rounds; ++r) {
    decode_jump_kernel<<<out_blocks, THREADS, 0, stream>>>(
        (int32_t*)ptr, wp, n, r ? changed + r - 1 : nullptr, changed + r);
    LZ77_CHECK_LAUNCH();
  }
  decode_gather_kernel<<<out_blocks, THREADS, 0, stream>>>(
      (uint8_t*)buf, (const int32_t*)ptr, wp, n);
  LZ77_CHECK_LAUNCH();
  return 0;
}
