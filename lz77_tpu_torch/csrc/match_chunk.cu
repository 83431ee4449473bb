// K4: exact longest match (L) and smallest distance (O) per position,
// distance-chunk form.
//
// Replaces the TPU kernel lz77_tpu/ops/pallas_match.py::_kernel.  Same
// contract as ops/match.py::find_matches and the same answers as K1
// (match.cu); the decomposition is the other one: a warp shares a position
// and splits a chunk of 256 consecutive distances over its lanes.
//
// The kernel is bound by operations (up to d_limit compares a position
// against about 1 B read and 8 B written), so the design spends as few
// issue slots a distance as it can: four distances are filtered by one
// byte-wise compare within a word, and a run is measured only for a
// distance that could still win.
//
// One thread block handles TILE consecutive positions of one input block g.
// The tile, its d_limit-byte window and its (la-1)-byte lookahead are staged
// in dynamic shared memory by match_common.cuh's stage_window, as in
// match.cu (plus zeroed slack, so the word-wide loads below may run a few
// bytes past the last real byte); load4, zero_bytes and run_length are that
// header's too.  Each
// warp takes TILE / WARPS positions in turn.  For a position p:
//   * its own bytes x[p ..] are the same for every lane and every chunk:
//     the first 16 are read once into registers, deeper ones (la > 17) stay
//     in shared memory;
//   * the sources of four consecutive distances start at four consecutive
//     bytes, one aligned word of the window.  Lane r of chunk c takes the
//     words 64c + r and 64c + 32 + r before the position's own (two words a
//     lane halve what a chunk costs in ballot, branch and loop).  For each,
//     one shared-memory load XORed with x[0] repeated four times leaves a
//     zero byte for every distance whose first byte matches.  A distance
//     can only beat the best run so far if it also matches at index `best`,
//     so the (unaligned) word `best` bytes further on is XORed with x[best]
//     the same way (K1's second filter, match.cu), the two are ORed, and
//     one zero-byte test marks the distances that pass both.  (__vcmpeq4
//     computes the same masks but is emulated on this card, and two of them
//     cost more than the one test.)  The first and the last chunk also mask
//     the distances below 1 and beyond min(d_limit, p + avail);
//   * only for a byte the test marks does a lane measure the run, nearest
//     distance first, four bytes at a time (XOR of the hoisted word with
//     the unaligned source word, two aligned words funnel-shifted; the
//     first set bit names the first differing byte), capped, and forms the
//     order-preserving key
//         key = run << 16 | (65535 - d)             (0 when no run)
//     so a longer run wins and, among equal runs, the smaller distance;
//   * `best` is the warp's: a ballot of "some lane's key beats the best"
//     follows every chunk and only then one warp max renews the best key,
//     `best` and x[best].  Chunks are visited with distances ascending, so
//     once the best run has reached the cap no later chunk can win and the
//     loop stops.
// Results are written 32 positions at a time, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

using lz77::load4;
using lz77::run_length;
using lz77::XREG;
using lz77::zero_bytes;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 512;
constexpr int PER_WARP = TILE / WARPS;  // 64: two rounds of 32 positions
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
  // s[i] holds block coordinate t0 - dlim + i, then zeros
  lz77::stage_window(s, blocks + (size_t)g * B, halos + (size_t)g * dlim,
                     rights + (size_t)g * depth, t0, TILE, B, dlim, depth,
                     THREADS);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int avail = avails[g], valid_ext = valid_exts[g];
  for (int round = 0; round < PER_WARP; round += 32) {
    const int base = t0 + warp * PER_WARP + round;  // warp-uniform
    if (base >= B) break;
    uint32_t my_key = 0;  // the key of position base + lane, once found
    for (int k = 0; k < 32; ++k) {
      const int p = base + k;
      if (p >= B) break;  // warp-uniform
      const int cap = min(depth, valid_ext - p - 1);
      uint32_t best_key = 0;  // the warp's, the same in every lane
      if (cap > 0) {
        const int dmax = min(dlim, p + avail);
        const int xi = dlim + (p - t0);  // s[xi + i] = byte at p + i
        const int a = xi & 3, w0 = xi >> 2;
        uint32_t X[XREG];  // the position's first bytes, read once
#pragma unroll
        for (int q = 0; q < XREG; ++q)
          X[q] = 4 * q < cap ? load4(sw, xi + 4 * q) : 0u;
        // word w0 - t holds the sources of distances a + 4t - 3 .. a + 4t
        // (byte j: distance a + 4t - j); t runs up to the word that holds
        // distance dmax
        const int tmax = (dmax + 3 - a) >> 2;
        const uint32_t c0s = (X[0] & 0xFFu) * 0x01010101u;  // x[0], four times
        uint32_t cbs = c0s;                                 // x[best]
        int best = 0, bq = 0, bs = 0;  // bq, bs: best / 4 and 8 * (best % 4)
        const int nsteps = (tmax >> 6) + 1;  // a step is 64 words of window
        const uint32_t cap_key = (uint32_t)cap << 16;
        for (int c = 0; c < nsteps; ++c) {
          const bool edge = c == 0 || c == nsteps - 1;
          uint32_t m[2];  // 0x80 in byte j of m[h]: distance a + 4t - j may win
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = 64 * c + 32 * h + lane;
            const int wi = max(w0 - t, 0);  // t > tmax is masked below
            // a zero byte j of z: that distance matches x[0] at index 0 and
            // x[best] at index best, the only way to beat the best run
            const uint32_t z =
                (sw[wi] ^ c0s) |
                (__funnelshift_r(sw[wi + bq], sw[wi + bq + 1], bs) ^ cbs);
            m[h] = zero_bytes(z);
            if (edge) {
              // keep 1 <= distance <= dmax: j <= a + 4t - 1, j >= a + 4t - dmax
              const int hi = a + 4 * t - 1, lo = a + 4 * t - dmax;
              if (hi < 3) m[h] &= (1u << (8 * (hi + 1))) - 1u;
              if (lo > 0) m[h] &= lo > 3 ? 0u : 0xFFFFFFFFu << (8 * lo);
            }
          }
          uint32_t key = 0;
          if (m[0] | m[1]) {  // rare: some distance passed both filters
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int t = 64 * c + 32 * h + lane;
              // nearest distance first; a run at the cap ends the lane's
              // search, its other distances are larger
              for (uint32_t mm = m[h]; mm && key < cap_key;) {
                const int j = (31 - __clz(mm)) >> 3;
                mm &= ~(0x80u << (8 * j));
                const int d = a + 4 * t - j;
                const int run = run_length(sw, X, xi, xi - d, cap);
                key = max(key, ((uint32_t)run << 16) | (uint32_t)(0xFFFF - d));
              }
            }
          }
          if (__any_sync(FULL, key > best_key)) {
            best_key = __reduce_max_sync(FULL, max(key, best_key));
            best = (int)(best_key >> 16);
            if (best >= cap) break;  // nothing later can be longer or nearer
            cbs = s[xi + best] * 0x01010101u;
            bq = best >> 2;
            bs = 8 * (best & 3);
          }
        }
      }
      if (lane == k) my_key = best_key;
    }
    const int p = base + lane;
    if (p < B) {
      L[(size_t)g * B + p] = (int32_t)(my_key >> 16);
      O[(size_t)g * B + p] = my_key ? (int32_t)(0xFFFFu - (my_key & 0xFFFFu)) : 0;
    }
  }
}

}  // namespace

extern "C" int lz77_match_chunk(
    const void* blocks, const void* halos, const void* rights,
    const void* avails, const void* valid_exts, void* L, void* O,
    int G, int B, int dlim, int depth, void* stream) {
  if (G <= 0 || B <= 0) return 0;
  const size_t smem = lz77::staged_bytes(dlim, TILE, depth);
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
