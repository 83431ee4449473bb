// K4: exact longest match (L) and smallest distance (O) per position,
// distance-chunk form.
//
// Replaces the TPU kernel lz77_tpu/ops/pallas_match.py::_kernel.  Same
// contract as ops/match.py::find_matches and the same answers as K1
// (match.cu); the decomposition is the other one: a warp shares a position
// and splits a chunk of 32 consecutive distances over its lanes.
//
// One thread block handles TILE consecutive positions of one input block g.
// The tile, its d_limit-byte window and its (la-1)-byte lookahead are staged
// in dynamic shared memory exactly as in match.cu (plus zeroed slack, so the
// word-wide loads below may run a few bytes past the last real byte).  Each
// warp takes TILE / WARPS positions in turn.  For a position, chunk c gives
// lane r the distance d = 32*c + r + 1; the lane finds the run length of
// x[p..] against x[p-d..] four bytes at a time (the unaligned source word is
// two aligned shared-memory words funnel-shifted together; XOR; the first
// set bit names the first differing byte), caps it, and keeps the largest
// order-preserving key
//     key = run * (dlim + 2) + (dlim + 1 - d)     (0 when run == 0)
// so a longer run wins and, among equal runs, the smaller distance.  A lane
// whose distance is beyond min(dlim, p + avail) never loads and never wins.
// Chunks are visited with distances ascending, so once any lane has reached
// the cap no later chunk can win and the loop stops.  One warp max over the
// lanes' keys gives the position's (L, O); results are written 32 positions
// at a time, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 512;
constexpr int PER_WARP = TILE / WARPS;  // 64: two rounds of 32 positions
constexpr int SLACK = 8;                // zero bytes after the staged span

// Four bytes starting at byte index i >= 0 of the 4-aligned shared array,
// little endian; reads the aligned word holding byte i and the next one.
__device__ __forceinline__ uint32_t load4(const uint32_t* sw, int i) {
  return __funnelshift_r(sw[i >> 2], sw[(i >> 2) + 1], (i & 3) * 8);
}

__global__ void __launch_bounds__(THREADS) match_chunk_kernel(
    const uint8_t* __restrict__ blocks,     // (G, B)
    const uint8_t* __restrict__ halos,      // (G, dlim), tail-aligned
    const uint8_t* __restrict__ rights,     // (G, depth)
    const int32_t* __restrict__ avails,     // (G,)
    const int32_t* __restrict__ valid_exts, // (G,)
    int32_t* __restrict__ L,                // (G, B)
    int32_t* __restrict__ O,                // (G, B)
    int B, int dlim, int depth) {
  extern __shared__ uint32_t sw[];
  uint8_t* s = reinterpret_cast<uint8_t*>(sw);
  const int g = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  // s[i] holds block coordinate t0 - dlim + i, for i in [0, span); zeros after
  const int span = dlim + TILE + depth;
  const int padded = ((span + 3) & ~3) + SLACK;
  const uint8_t* blk = blocks + (size_t)g * B;
  const uint8_t* hal = halos + (size_t)g * dlim;
  const uint8_t* rgt = rights + (size_t)g * depth;
  for (int i = threadIdx.x; i < padded; i += THREADS) {
    const int j = t0 - dlim + i;
    uint8_t v = 0;
    if (i < span) {
      if (j < 0) {
        v = hal[dlim + j];  // j >= -dlim because t0 >= 0
      } else if (j < B) {
        v = blk[j];
      } else if (j < B + depth) {
        v = rgt[j - B];
      }
    }
    s[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int avail = avails[g], valid_ext = valid_exts[g];
  const int kmul = dlim + 2;
  for (int round = 0; round < PER_WARP; round += 32) {
    const int base = t0 + warp * PER_WARP + round;  // warp-uniform
    if (base >= B) break;
    int my_key = 0;  // the key of position base + lane, once found
    for (int k = 0; k < 32; ++k) {
      const int p = base + k;
      if (p >= B) break;  // warp-uniform
      const int cap = min(depth, valid_ext - p - 1);
      int best = 0;
      if (cap > 0) {
        const int dmax = min(dlim, p + avail);
        const int xi = dlim + (p - t0);  // s[xi + i] = byte at p + i
        const int cap_key = cap * kmul;
        for (int c = 0; c * 32 < dmax; ++c) {
          const int d = c * 32 + lane + 1;
          if (d <= dmax) {
            int run = cap;
            for (int i = 0; i < cap; i += 4) {
              const uint32_t diff = load4(sw, xi + i) ^ load4(sw, xi - d + i);
              if (diff) {
                run = min(cap, i + ((__ffs(diff) - 1) >> 3));
                break;
              }
            }
            if (run > 0) best = max(best, run * kmul + (dlim + 1 - d));
          }
          if (__any_sync(FULL, best >= cap_key)) break;
        }
        best = __reduce_max_sync(FULL, best);
      }
      if (lane == k) my_key = best;
    }
    const int p = base + lane;
    if (p < B) {
      const int len = my_key / kmul;
      L[(size_t)g * B + p] = len;
      O[(size_t)g * B + p] = len > 0 ? (dlim + 1) - my_key % kmul : 0;
    }
  }
}

}  // namespace

extern "C" int lz77_match_chunk(
    const void* blocks, const void* halos, const void* rights,
    const void* avails, const void* valid_exts, void* L, void* O,
    int G, int B, int dlim, int depth, void* stream) {
  if (G <= 0 || B <= 0) return 0;
  const size_t span = (size_t)dlim + TILE + depth;
  const size_t smem = ((span + 3) & ~(size_t)3) + SLACK;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        match_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + TILE - 1) / TILE, G);
  match_chunk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const uint8_t*)halos, (const uint8_t*)rights,
      (const int32_t*)avails, (const int32_t*)valid_exts,
      (int32_t*)L, (int32_t*)O, B, dlim, depth);
  return (int)cudaGetLastError();
}
