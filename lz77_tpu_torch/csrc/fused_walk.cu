// K5: match sweep + greedy parse walk + token pack in one kernel.
//
// Replaces the TPU kernel lz77_tpu/ops/fused_walk.py::_kernel.  Same
// contract as ops/fused_walk.py::sweep_walk: from the raw bytes of a batch
// of G consecutive blocks and a parse entry, write the exact serial token
// words off | len<<ob | next<<(ob+lb), their count and the exit entry.  The
// match tables (L, O) never reach device memory.
//
// One thread block handles one tile: TILE consecutive positions of one input
// block g.  Tiles never straddle blocks (each block has its own halo, right
// extension, avail and valid_ext), so the last tile of a block may be short;
// they are numbered in span order (g, tile in block), and only tiles that
// start before valid_total are launched.
//   1. A tile takes its number from an atomic ticket, so its predecessor in
//      span order always holds an SM already: waiting on it cannot deadlock.
//   2. Sweep, as K1 (match.cu): halo | block | right extension staged in
//      shared memory, one thread per position, distances ascending; length
//      and distance go to two small shared arrays.
//   3. Maps, as K2's walk_maps on shared memory: thread e < la walks the
//      tile from entry offset e and keeps its exit position and token count.
//   4. Hand-off: one thread waits for the state its predecessor publishes —
//      the span position of the next token start and the running token
//      total, packed into one 64-bit word so that a single store publishes
//      both — looks its own entry up in the maps and publishes the state for
//      its successor before it emits anything.  Tile 0 reads the batch's
//      entry instead, clamped to [0, la); the last tile writes the count and
//      the exit entry.
//   5. Emit: the same thread walks the tile from its true entry and records
//      the token starts; then thread k packs token k and stores it at the
//      tile's offset, so the stores are coalesced.
// The state carries an absolute span position, not an offset into the next
// tile: a tile shorter than la can be jumped over whole, and then simply
// passes the state on.
//
// The byte after a match is the byte at p + len of the flat span (the next
// block's first bytes when the match ends at the block's end) and, past the
// span, the last block's right extension: what K2 sees through build_lox.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 512;
constexpr int MAX_LA = 256;

typedef unsigned long long u64;

__global__ void __launch_bounds__(TILE) sweepwalk_kernel(
    const uint8_t* __restrict__ blocks,     // (G, B)
    const uint8_t* __restrict__ halos,      // (G, dlim), tail-aligned
    const uint8_t* __restrict__ rights,     // (G, depth)
    const int32_t* __restrict__ avails,     // (G,)
    const int32_t* __restrict__ valid_exts, // (G,)
    const int32_t* __restrict__ entry_in,   // (1,)
    u64* sync,  // zeroed: [0] ticket, [1 + m] state entering tile m
    uint32_t* __restrict__ tokens, int32_t* __restrict__ count_out,
    int32_t* __restrict__ exit_out,
    int G, int B, int dlim, int depth, int la, int vt, int tpb, int n_tiles,
    int ob, int lb) {
  extern __shared__ __align__(8) uint8_t smem[];
  uint16_t* sO = (uint16_t*)smem;      // [TILE] match distance
  uint16_t* sExit = sO + TILE;         // [MAX_LA] exit position by entry
  uint16_t* sCnt = sExit + MAX_LA;     // [MAX_LA] token count by entry
  uint16_t* sStart = sCnt + MAX_LA;    // [TILE] token starts of the true walk
  uint8_t* sL = (uint8_t*)(sStart + TILE);  // [TILE] match length
  uint8_t* s = sL + TILE;              // staged span, as in match.cu
  __shared__ int sh_m, sh_cnt;
  __shared__ uint32_t sh_total;

  const int tid = threadIdx.x;
  if (tid == 0) sh_m = (int)atomicAdd(sync, 1ULL);
  __syncthreads();
  const int m = sh_m;
  const int g = m / tpb;
  const int t0 = (m - g * tpb) * TILE;
  const long long base = (long long)g * B + t0;  // span position of the tile
  // token starts of this tile: local positions [0, end); end >= 1
  const int end = (int)min((long long)min(TILE, B - t0), (long long)vt - base);

  // s[i] holds block coordinate t0 - dlim + i, for i in [0, span)
  const int span = dlim + TILE + depth;
  const uint8_t* blk = blocks + (size_t)g * B;
  const uint8_t* hal = halos + (size_t)g * dlim;
  const uint8_t* rgt = rights + (size_t)g * depth;
  for (int i = tid; i < span; i += TILE) {
    const int j = t0 - dlim + i;
    uint8_t v = 0;
    if (j < 0) {
      v = hal[dlim + j];
    } else if (j < B) {
      v = blk[j];
    } else if (j < B + depth) {
      v = rgt[j - B];
    }
    s[i] = v;
  }
  __syncthreads();

  if (tid < end) {
    const int p = t0 + tid;
    const int cap = min(depth, valid_exts[g] - p - 1);
    int best = 0, best_o = 0;
    if (cap > 0) {
      const int dmax = min(dlim, p + avails[g]);
      const uint8_t* x = s + dlim + tid;  // x[i] = byte at p + i
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
    sL[tid] = (uint8_t)best;
    sO[tid] = (uint16_t)best_o;
  }
  __syncthreads();

  if (tid < la) {
    int p = tid, c = 0;
    while (p < end) {
      p += sL[p] + 1;
      ++c;
    }
    sExit[tid] = (uint16_t)p;  // < TILE + la
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

  if (tid < sh_cnt) {
    const int p = sStart[tid];
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
    tokens[sh_total + tid] =
        (uint32_t)sO[p] | ((uint32_t)ln << ob) | (nxt << (ob + lb));
  }
}

}  // namespace

extern "C" int lz77_sweepwalk(
    const void* blocks, const void* halos, const void* rights,
    const void* avails, const void* valid_exts, const void* entry, void* sync,
    void* tokens, void* count, void* exit_out, int G, int B, int dlim,
    int depth, int la, int valid_total, int n_tiles, int ob, int lb,
    void* stream) {
  if (n_tiles <= 0) return 0;
  const int tpb = (B + TILE - 1) / TILE;
  const size_t smem = 2 * (size_t)(TILE + MAX_LA + MAX_LA + TILE) + TILE +
                      (size_t)dlim + TILE + depth;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweepwalk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweepwalk_kernel<<<n_tiles, TILE, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)blocks, (const uint8_t*)halos, (const uint8_t*)rights,
      (const int32_t*)avails, (const int32_t*)valid_exts,
      (const int32_t*)entry, (u64*)sync, (uint32_t*)tokens, (int32_t*)count,
      (int32_t*)exit_out, G, B, dlim, depth, la, valid_total, tpb, n_tiles,
      ob, lb);
  return (int)cudaGetLastError();
}
