// K5: match sweep + greedy parse walk + token pack in one kernel.
//
// Replaces the TPU kernel lz77_tpu/ops/fused_walk.py::_kernel.  Same
// contract as ops/fused_walk.py::sweep_walk: from the raw bytes of a batch
// of G consecutive blocks and a parse entry, write the exact serial token
// words off | len<<ob | next<<(ob+lb), their count and the exit entry.  The
// match tables (L, O) never reach device memory.
//
// What bounds it: the sweep's operations (up to d_limit compares a
// position, as in K1) and a serial chain of hand-offs, one a tile, each a
// round trip through device memory (about 0.3 us).  The sweep is K1's
// (match_common.cuh's sweep_position: four distances a step, one thread a
// position); the chain is made short by making tiles long.
//
// One thread block of THREADS threads handles one tile: `tile` consecutive
// positions of one input block g (a launch argument, 4096 by default: an
// 8 MiB batch is 2,048 tiles and 2,048 hops).  Tiles never straddle blocks
// (each block has its own halo, right extension, avail and valid_ext), so
// the last tile of a block may be short; they are numbered in span order
// (g, tile in block), and only tiles that start before valid_total are
// launched.
//   1. A tile takes its number from an atomic ticket, so its predecessor in
//      span order always holds an SM already: waiting on it cannot deadlock.
//   2. Sweep: halo | block | right extension staged in shared memory as in
//      K1, then the tile's positions in passes of THREADS, one thread a
//      position; length and distance go to two shared arrays.
//   3. Maps, as K2's walk_maps on shared memory: thread e < la walks the
//      tile from entry offset e and keeps its exit position and token count.
//   4. Hand-off: one thread waits for the state its predecessor publishes —
//      the span position of the next token start and the running token
//      total, packed into one 64-bit word so that a single store publishes
//      both — looks its own entry up in the maps and publishes the state for
//      its successor before it emits anything.  Tile 0 reads the batch's
//      entry instead, clamped to [0, la); the last tile writes the count and
//      the exit entry.  The maps and the emit walk lie off the chain.
//   5. Emit: the same thread walks the tile from its true entry and records
//      the token starts (16-bit, in shared memory); then the block's threads
//      pack one token each in turn and store it at the tile's offset, so the
//      stores are coalesced.
// The state carries an absolute span position, not an offset into the next
// tile: a tile shorter than la can be jumped over whole, and then simply
// passes the state on.
//
// The byte after a match is the byte at p + len of the flat span (the next
// block's first bytes when the match ends at the block's end) and, past the
// span, the last block's right extension: what K2 sees through build_lox.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MAX_LA = 256;
constexpr int MAX_TILE = 16384;  // positions, exits and counts fit 16 bits

typedef unsigned long long u64;

// Dynamic shared memory of a tile: the staged window (first, 4-aligned),
// then distance and token start (16-bit) a position, the two maps, and the
// length (8-bit) a position.
size_t tile_smem(int tile, int dlim, int depth) {
  return (size_t)lz77::staged_bytes(dlim, tile, depth) + 4 * (size_t)tile +
         4 * (size_t)MAX_LA + tile;
}

__global__ void __launch_bounds__(THREADS) sweepwalk_kernel(
    const uint8_t* __restrict__ blocks,     // (G, B)
    const uint8_t* __restrict__ halos,      // (G, dlim), tail-aligned
    const uint8_t* __restrict__ rights,     // (G, depth)
    const int32_t* __restrict__ avails,     // (G,)
    const int32_t* __restrict__ valid_exts, // (G,)
    const int32_t* __restrict__ entry_in,   // (1,)
    u64* sync,  // zeroed: [0] ticket, [1 + m] state entering tile m
    uint32_t* __restrict__ tokens, int32_t* __restrict__ count_out,
    int32_t* __restrict__ exit_out,
    int G, int B, int dlim, int depth, int la, int vt, int tile, int tpb,
    int n_tiles, int ob, int lb) {
  extern __shared__ uint32_t sw[];  // staged window: byte i at t0 - dlim + i
  uint8_t* s = reinterpret_cast<uint8_t*>(sw);
  uint16_t* sO = (uint16_t*)(s + lz77::staged_bytes(dlim, tile, depth));
  uint16_t* sStart = sO + tile;        // [tile] token starts of the true walk
  uint16_t* sExit = sStart + tile;     // [MAX_LA] exit position by entry
  uint16_t* sCnt = sExit + MAX_LA;     // [MAX_LA] token count by entry
  uint8_t* sL = (uint8_t*)(sCnt + MAX_LA);  // [tile] match length
  __shared__ int sh_m, sh_cnt;
  __shared__ uint32_t sh_total;

  const int tid = threadIdx.x;
  if (tid == 0) sh_m = (int)atomicAdd(sync, 1ULL);
  __syncthreads();
  const int m = sh_m;
  const int g = m / tpb;
  const int t0 = (m - g * tpb) * tile;
  const long long base = (long long)g * B + t0;  // span position of the tile
  // token starts of this tile: local positions [0, end); end >= 1
  const int end = (int)min((long long)min(tile, B - t0), (long long)vt - base);

  lz77::stage_window(s, blocks + (size_t)g * B, halos + (size_t)g * dlim,
                     rights + (size_t)g * depth, t0, tile, B, dlim, depth,
                     THREADS);
  __syncthreads();

  const int avail = avails[g], valid_ext = valid_exts[g];
  for (int q = tid; q < end; q += THREADS) {
    const int p = t0 + q;
    const int cap = min(depth, valid_ext - p - 1);
    int2 r = make_int2(0, 0);
    if (cap > 0) {
      r = lz77::sweep_position(sw, dlim + q, cap, min(dlim, p + avail));
    }
    sL[q] = (uint8_t)r.x;
    sO[q] = (uint16_t)r.y;
  }
  __syncthreads();

  if (tid < la) {
    int p = tid, c = 0;
    while (p < end) {
      p += sL[p] + 1;
      ++c;
    }
    sExit[tid] = (uint16_t)p;  // < tile + la
    sCnt[tid] = (uint16_t)c;
  }
  __syncthreads();

  if (tid == 0) {
    long long p_abs;
    uint32_t total = 0;
    if (m == 0) {
      p_abs = min(max(*entry_in, 0), la - 1);
    } else {
      volatile u64* src = sync + 1 + m;
      u64 v;
      while ((v = *src) == 0) {
      }
      p_abs = (long long)(v & 0xFFFFFFFFu) - 1;
      total = (uint32_t)(v >> 32);
    }
    // The walk before this tile stopped at p_abs >= base, less than la past
    // the end of the tile it stopped in; at or past this tile's end means
    // the tile was jumped over.
    const long long e = p_abs - base;
    int cnt = 0;
    long long p_out = p_abs;
    if (e < end) {
      cnt = sCnt[e];
      p_out = base + sExit[e];
    }
    if (m + 1 < n_tiles) {
      *(volatile u64*)(sync + 2 + m) =
          ((u64)(total + cnt) << 32) | (u64)(p_out + 1);
    } else {
      *count_out = (int32_t)(total + cnt);
      *exit_out = (int32_t)(p_out - vt);
    }
    int k = 0;
    for (long long p = e; p < end; p += sL[p] + 1) sStart[k++] = (uint16_t)p;
    sh_cnt = cnt;
    sh_total = total;
  }
  __syncthreads();

  for (int k = tid; k < sh_cnt; k += THREADS) {
    const int p = sStart[k];
    const int ln = sL[p];
    const int j = t0 + p + ln;  // block coordinate of the next byte
    uint32_t nxt;
    if (j < B) {
      nxt = s[dlim + p + ln];
    } else {
      const long long q = (long long)g * B + j;
      const long long N = (long long)G * B;
      nxt = q < N ? blocks[q]
                  : (q - N < depth ? rights[(size_t)(G - 1) * depth + (q - N)]
                                   : 0);
    }
    tokens[sh_total + k] =
        (uint32_t)sO[p] | ((uint32_t)ln << ob) | (nxt << (ob + lb));
  }
}

}  // namespace

extern "C" int lz77_sweepwalk(
    const void* blocks, const void* halos, const void* rights,
    const void* avails, const void* valid_exts, const void* entry, void* sync,
    void* tokens, void* count, void* exit_out, int G, int B, int dlim,
    int depth, int la, int valid_total, int tile, int n_tiles, int ob, int lb,
    void* stream) {
  if (n_tiles <= 0) return 0;
  if (tile < 1 || tile > MAX_TILE || la < 2 || la > 255)
    return (int)cudaErrorInvalidValue;
  const int tpb = (B + tile - 1) / tile;
  const size_t smem = tile_smem(tile, dlim, depth);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweepwalk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweepwalk_kernel<<<n_tiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const uint8_t*)halos, (const uint8_t*)rights,
      (const int32_t*)avails, (const int32_t*)valid_exts,
      (const int32_t*)entry, (u64*)sync, (uint32_t*)tokens, (int32_t*)count,
      (int32_t*)exit_out, G, B, dlim, depth, la, valid_total, tile, tpb,
      n_tiles, ob, lb);
  return (int)cudaGetLastError();
}
