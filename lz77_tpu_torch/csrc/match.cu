// K1: exact longest match (L) and smallest distance (O) per position.
//
// Replaces the TPU kernel lz77_tpu/ops/pallas_bitplane.py::_kernel.  Same
// contract as ops/match.py::find_matches; byte-domain distance sweep.
//
// One thread block handles TILE consecutive positions of one input block g,
// one thread per position.  The tile, its d_limit-byte window and its
// (la-1)-byte lookahead are staged in dynamic shared memory from the three
// per-block arrays (halo | block | right extension), so the sweep's loads
// are shared-memory byte loads.  A thread walks distances 1..min(d_limit,
// p + avail) in ascending order, keeps strictly longer runs (so the smallest
// distance wins ties) and stops as soon as its cap is reached.  A distance
// can only beat the current best if it matches both the first byte and the
// byte at index `best`, so those two are tested before the run loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 512;

__global__ void __launch_bounds__(TILE) match_kernel(
    const uint8_t* __restrict__ blocks,     // (G, B)
    const uint8_t* __restrict__ halos,      // (G, dlim), tail-aligned
    const uint8_t* __restrict__ rights,     // (G, depth)
    const int32_t* __restrict__ avails,     // (G,)
    const int32_t* __restrict__ valid_exts, // (G,)
    int32_t* __restrict__ L,                // (G, B)
    int32_t* __restrict__ O,                // (G, B)
    int B, int dlim, int depth) {
  extern __shared__ uint8_t s[];
  const int g = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  // s[i] holds block coordinate t0 - dlim + i, for i in [0, span)
  const int span = dlim + TILE + depth;
  const uint8_t* blk = blocks + (size_t)g * B;
  const uint8_t* hal = halos + (size_t)g * dlim;
  const uint8_t* rgt = rights + (size_t)g * depth;
  for (int i = threadIdx.x; i < span; i += TILE) {
    const int j = t0 - dlim + i;
    uint8_t v = 0;
    if (j < 0) {
      v = hal[dlim + j];  // j >= -dlim because t0 >= 0
    } else if (j < B) {
      v = blk[j];
    } else if (j < B + depth) {
      v = rgt[j - B];
    }
    s[i] = v;
  }
  __syncthreads();

  const int p = t0 + threadIdx.x;
  if (p >= B) return;
  const int cap = min(depth, valid_exts[g] - p - 1);
  int best = 0, best_o = 0;
  if (cap > 0) {
    const int dmax = min(dlim, p + avails[g]);
    const uint8_t* x = s + dlim + threadIdx.x;  // x[i] = byte at p + i
    const uint8_t c0 = x[0];
    uint8_t cb = c0;  // x[best]
    for (int d = 1; d <= dmax; ++d) {
      const uint8_t* y = x - d;
      if (y[0] == c0 && y[best] == cb) {
        int r = 1;
        while (r < cap && y[r] == x[r]) ++r;
        if (r > best) {
          best = r;
          best_o = d;
          if (best == cap) break;  // saturated: nothing can be longer
          cb = x[best];
        }
      }
    }
  }
  L[(size_t)g * B + p] = best;
  O[(size_t)g * B + p] = best_o;
}

}  // namespace

extern "C" int lz77_match(
    const void* blocks, const void* halos, const void* rights,
    const void* avails, const void* valid_exts, void* L, void* O,
    int G, int B, int dlim, int depth, void* stream) {
  if (G <= 0 || B <= 0) return 0;
  const size_t smem = (size_t)dlim + TILE + depth;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + TILE - 1) / TILE, G);
  match_kernel<<<grid, TILE, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const uint8_t*)halos, (const uint8_t*)rights,
      (const int32_t*)avails, (const int32_t*)valid_exts,
      (int32_t*)L, (int32_t*)O, B, dlim, depth);
  return (int)cudaGetLastError();
}
