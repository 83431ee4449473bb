// K1: exact longest match (L) and smallest distance (O) per position.
//
// Replaces the TPU kernel lz77_tpu/ops/pallas_bitplane.py::_kernel.  Same
// contract as ops/match.py::find_matches; byte-domain distance sweep.
//
// What bounds it: operations, not bytes.  A position reads about one byte
// and writes eight, but is compared against up to d_limit distances, so the
// kernel is bound by issued instructions and the shared-memory pipe.  The
// design spends as few of both as it can a distance, and keeps one position
// a thread so that a thread stops the moment its own run reaches the cap
// (distance 1 on a run of zeros).
//
// One thread block handles TILE consecutive positions of one input block g,
// one thread per position.  The tile, its d_limit-byte window and its
// (la-1)-byte lookahead are staged in dynamic shared memory from the three
// per-block arrays (halo | block | right extension), plus zeroed slack.  A
// thread then runs match_common.cuh's sweep_position: four distances a step
// from one aligned window word, XORed with the position's first byte
// repeated four times and ORed with the same test at index `best` (the
// second filter, whose unaligned word slides down one aligned word a step);
// one zero-byte test marks the distances that pass both, and only those
// measure their run, four bytes at a time, nearest first.  Eight steps
// share one test and one branch.  A step costs two 32-bit shared-memory
// loads and a handful of integer instructions where a distance at a time
// took eight byte loads and some thirty-four instructions for the same
// four distances.  A warp's 32 positions read 8 or 9 consecutive words a
// step: a broadcast, no bank conflict.  Results are written coalesced.
//
// A sharded encode's window axis gives each mesh member a range of
// distances [d_lo, d_hi) (match_common.cuh's sweep_range): its first step
// is the word that holds d_lo, masked below it as step 0 is masked below 1,
// and its tile stages only the d_hi - 1 window bytes it can reach.  The full
// range is a separate instantiation, the code K5 runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

constexpr int TILE = 512;

// RANGED: distances d_lo .. d_hi - 1 only (the window axis of a sharded
// encode splits the distances between mesh members), with only the
// win = min(dlim, d_hi - 1) window bytes they reach staged.  Otherwise
// 1 .. dlim, the code K5 shares.
template <bool RANGED>
__global__ void __launch_bounds__(TILE) match_kernel(
    const uint8_t* __restrict__ blocks,     // (G, B)
    const uint8_t* __restrict__ halos,      // (G, dlim), tail-aligned
    const uint8_t* __restrict__ rights,     // (G, depth)
    const int32_t* __restrict__ avails,     // (G,)
    const int32_t* __restrict__ valid_exts, // (G,)
    int32_t* __restrict__ L,                // (G, B)
    int32_t* __restrict__ O,                // (G, B)
    int B, int dlim, int depth, int d_lo, int win) {
  extern __shared__ uint32_t sw[];
  const int g = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  // byte i of sw holds block coordinate t0 - win + i
  lz77::stage_window(reinterpret_cast<uint8_t*>(sw), blocks + (size_t)g * B,
                     halos + (size_t)g * dlim, rights + (size_t)g * depth, t0,
                     TILE, B, dlim, depth, TILE, RANGED ? win : dlim);
  __syncthreads();

  const int p = t0 + threadIdx.x;
  if (p >= B) return;
  const int cap = min(depth, valid_exts[g] - p - 1);
  int2 r = make_int2(0, 0);
  if (cap > 0) {
    if (RANGED) {
      r = lz77::sweep_range(sw, win + threadIdx.x, cap, d_lo,
                            min(win, p + avails[g]));
    } else {
      r = lz77::sweep_position(sw, dlim + threadIdx.x, cap,
                               min(dlim, p + avails[g]));
    }
  }
  L[(size_t)g * B + p] = r.x;
  O[(size_t)g * B + p] = r.y;
}

template <bool RANGED>
int launch(const void* blocks, const void* halos, const void* rights,
           const void* avails, const void* valid_exts, void* L, void* O,
           int G, int B, int dlim, int depth, int d_lo, int win,
           cudaStream_t stream) {
  const size_t smem = lz77::staged_bytes(win, TILE, depth);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        match_kernel<RANGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + TILE - 1) / TILE, G);
  match_kernel<RANGED><<<grid, TILE, smem, stream>>>(
      (const uint8_t*)blocks, (const uint8_t*)halos, (const uint8_t*)rights,
      (const int32_t*)avails, (const int32_t*)valid_exts,
      (int32_t*)L, (int32_t*)O, B, dlim, depth, d_lo, win);
  return (int)cudaGetLastError();
}

}  // namespace

// Distances [d_lo, d_hi), 1 <= d_lo < d_hi <= dlim + 1; the full range
// runs the unranged kernel.
extern "C" int lz77_match(
    const void* blocks, const void* halos, const void* rights,
    const void* avails, const void* valid_exts, void* L, void* O,
    int G, int B, int dlim, int depth, int d_lo, int d_hi, void* stream) {
  if (G <= 0 || B <= 0) return 0;
  if (d_lo <= 1 && d_hi > dlim) {
    return launch<false>(blocks, halos, rights, avails, valid_exts, L, O, G,
                         B, dlim, depth, 1, dlim, (cudaStream_t)stream);
  }
  return launch<true>(blocks, halos, rights, avails, valid_exts, L, O, G, B,
                      dlim, depth, d_lo, min(dlim, d_hi - 1),
                      (cudaStream_t)stream);
}
