// The token replay that K3 (decode_walk.cu) and K6 (decode_walk_packed.cu)
// both launch: where every token starts, then one tiled kernel that replays
// the tokens into packed output words, all tiles at once, and checks them.
//
// A decode token word is off | len<<16 | next<<24: it copies `len` bytes
// from `off` behind the write cursor with byte-serial semantics
// (lz77.c:178-188: an overlapping copy, off < len, repeats the off-byte
// pattern), then writes `next`, len + 1 bytes in all.  An optional priming
// window of `wp` history bytes stands before output position 0 (streamed
// decode: the previous stages' last bytes).
//
// What the contract moves is 4 B per token in and 1 B per byte out; what
// bounds a replay on this card is its chains of copies.  So the replay runs
// as parent pointers over the output bytes, a tile of them at a time in
// shared memory, so that no per-byte array lies in device memory and a tile
// resolves its chains without leaving the SM:
//   1. token_scan_kernel: every block of SCAN_CHUNK tokens stores its byte
//      count; the last block to finish (a counter in `sync`) turns the
//      counts into block starts and the grand total (*cnt).  One launch.
//   2. replay_kernel, one thread block per tile of `tile_words` output
//      words.  A tile takes its number from an atomic ticket, finds the
//      first block of tokens that reaches into it by a search over the block
//      starts, re-scans those blocks, and gives every byte of the tile one
//      32-bit entry in shared memory:
//        LIT | value           a literal (or 0 for a byte no token covers),
//        parent index >= 0     a copy whose source start - off + (q mod off)
//                              lies in the tile (overlaps cost no hop),
//        EXT | distance        a copy whose source lies `distance` bytes
//                              before the tile's first byte: in an earlier
//                              tile's output, or in the window.
//      Pointer jumping, entry[j] <- entry[entry[j]] while entry[j] >= 0, in
//      place in shared memory, ends with every entry a root.  A racing read
//      sees some ancestor's entry, which is as good; every round at least
//      halves the chains.
//   3. The hand-off, in tile order.  An external source lies at most
//      2^off_bits - 1 behind its token and the token starts at most 254
//      bytes before the tile, so only the last
//      `tail` = min(2^off_bits + 256, tile) bytes before a tile can be its
//      source.  A tile resolves, packs and stores its own tail first,
//      fences, and raises its flag; the tile after it waits for that flag
//      alone, and only if one of its roots lies in earlier output.  A root
//      in the window is final before launch (the window is "tile -1"), so
//      tile 0 never waits.  The rest of the tile follows after the flag is
//      up.  (Where the tail is the whole tile a source may lie several
//      tiles back and a flag must mean that everything before is final:
//      then every tile but the first waits.)  External bytes of earlier
//      tiles are read from the output words in device memory (L2 holds
//      them) with loads that bypass L1.  The ticket makes sure that a
//      tile's predecessor is resident or done, so the wait cannot hang.
//   The check rides in step 2: the tile that holds a token's first byte
//   rejects it if len > 0 and off == 0, off > start + wp, off > d_limit or
//   len > len_limit, and a rejected stream turns *cnt into -1.  (d_limit
//   is at most 2^off_bits - 1, which is what keeps the hand-off exact.)
// Every word of the output is written (zero past the count, and the bytes
// of the last word past the count).  A token that does not fit the output
// whole writes nothing; a copy with off == 0 or a source before the window
// reads 0.  The kernels are static: each source that includes this header
// links its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lz77 {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;  // tokens per block

// sync words (int32, zeroed by the wrapper): the tiles' ticket, the scan's
// count of finished blocks, then one flag a tile
constexpr int SYNC_TICKET = 0, SYNC_SCANNED = 1, SYNC_FLAGS = 2;

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

// sums[b] <- output bytes of tokens [b * SCAN_CHUNK, (b + 1) * SCAN_CHUNK);
// the last block to finish turns sums into block starts (exclusive) and
// writes the total to *cnt.
static __global__ void __launch_bounds__(SCAN_THREADS) token_scan_kernel(
    const int32_t* __restrict__ toks, int T, int32_t* sums, int nb,
    int32_t* __restrict__ cnt, int32_t* sync) {
  __shared__ int ws[SCAN_THREADS / 32];
  __shared__ int last;
  const long long base = (long long)blockIdx.x * SCAN_CHUNK + threadIdx.x;
  int s = 0;
  for (int it = 0; it < SCAN_ITEMS; ++it)
    s += token_size(toks, T, base + it * SCAN_THREADS);
  int total;
  block_inclusive_scan<SCAN_THREADS / 32>(s, ws, &total);
  if (threadIdx.x == 0) {
    sums[blockIdx.x] = total;
    __threadfence();  // the sum is visible before the count says so
    last = atomicAdd(sync + SYNC_SCANNED, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int carry = 0;
  for (int b0 = 0; b0 < nb; b0 += SCAN_THREADS) {
    const int i = b0 + threadIdx.x;
    const int v = i < nb ? __ldcg(sums + i) : 0;
    const int inc = block_inclusive_scan<SCAN_THREADS / 32>(v, ws, &total);
    if (i < nb) sums[i] = carry + inc - v;
    carry += total;
  }
  if (threadIdx.x == 0) *cnt = carry;
}

constexpr int REPLAY_THREADS = 1024;
constexpr int REPLAY_WARPS = REPLAY_THREADS / 32;
constexpr uint32_t LIT = 0x80000000u;      // | byte value
constexpr uint32_t EXT = 0xC0000000u;      // | distance before the tile
constexpr uint32_t EXT_BIT = 0x40000000u;  // set in EXT, clear in LIT
constexpr uint32_t DIST_MASK = 0x3FFFFu;   // distance <= 65535 + 254

struct ReplayArgs {
  const int32_t* toks;
  int T;
  const int32_t* block_starts;  // token_scan_kernel's sums
  int nb;
  uint32_t* out;        // read back by later tiles
  long long out_cap;    // bytes: tokens must fit whole below it
  long long out_words;  // words of `out`, >= ceil(out_cap / 4)
  const uint8_t* win;   // wp history bytes (positions -wp..-1)
  int wp;
  int32_t* sync;
  int32_t* cnt;         // -1 if a token breaks a limit
  int tile_words, tail_words, d_limit, len_limit;
};

// Spin until the tile before tile m has stored its tail (no-op for m == 0).
__device__ __forceinline__ void wait_for_tile_before(const int32_t* flags,
                                                     int m) {
  if (m > 0 && threadIdx.x == 0) {
    const volatile int32_t* f = flags + (m - 1);
    while (*f == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Resolve, pack and store the tile's words [w_lo, w_hi), one word a thread
// at a time (coalesced): a root's value, or for an external root the byte
// an earlier tile stored or the window's.  b0 is the tile's first byte.
__device__ __forceinline__ void store_words(const ReplayArgs& a,
                                            const uint32_t* ent, long long b0,
                                            int w_lo, int w_hi) {
  const uint8_t* out8 = reinterpret_cast<const uint8_t*>(a.out);
  // byte b0 - d for d <= b0 is earlier output, else window byte wp + b0 - d:
  // one base pointer each, chosen without a branch, so the four loads of
  // a word are in flight together
  const uint8_t* win_end = a.win + a.wp;  // (null + 0 when there is none)
  const long long word0 = b0 >> 2;
  w_hi = (int)min((long long)w_hi, a.out_words - word0);
#pragma unroll 4
  for (int w = w_lo + threadIdx.x; w < w_hi; w += REPLAY_THREADS) {
    const uint4 e4 = reinterpret_cast<const uint4*>(ent)[w];
    const uint32_t e[4] = {e4.x, e4.y, e4.z, e4.w};
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t v = e[k] & 0xFFu;
      if (e[k] & EXT_BIT) {
        const long long src = b0 - (long long)(e[k] & DIST_MASK);
        v = __ldcg((src >= 0 ? out8 : win_end) + src);
      }
      word |= v << (8 * k);
    }
    a.out[word0 + w] = word;
  }
}

static __global__ void __launch_bounds__(REPLAY_THREADS) replay_kernel(
    const ReplayArgs a) {
  extern __shared__ __align__(16) uint32_t ent[];  // 4 * tile_words entries
  __shared__ int ws[REPLAY_WARPS];
  __shared__ int sh_m;
  const int tid = threadIdx.x;
  if (tid == 0) sh_m = atomicAdd(a.sync + SYNC_TICKET, 1);
  __syncthreads();
  const int m = sh_m;
  int32_t* flags = a.sync + SYNC_FLAGS;
  const int TB = 4 * a.tile_words;               // bytes of a tile
  const long long b0 = (long long)m * TB;        // the tile's first byte
  const long long b1 = b0 + TB;

  for (int j = tid; j < TB; j += REPLAY_THREADS) ent[j] = LIT;
  // the last block of tokens that starts at or before b0 (block 0 starts at
  // 0); all threads search alike, the loads are broadcast
  int b = 0;  // block_starts[b] <= b0 < block_starts[hi]
  for (int hi = a.nb; hi - b > 1;) {
    const int mid = (b + hi) >> 1;
    if (__ldg(a.block_starts + mid) <= b0) b = mid; else hi = mid;
  }
  __syncthreads();

  int bad = 0;
  for (; b < a.nb; ++b) {
    long long run = __ldg(a.block_starts + b);
    if (run >= b1) break;  // block-uniform
    for (int it = 0; it < SCAN_CHUNK / REPLAY_THREADS; ++it) {
      const long long i =
          (long long)b * SCAN_CHUNK + it * REPLAY_THREADS + tid;
      const uint32_t w = i < a.T ? (uint32_t)a.toks[i] : 0u;
      const int off = (int)(w & 0xFFFFu);
      const int ln = (int)((w >> 16) & 0xFFu);
      const int sz = i < a.T ? ln + 1 : 0;
      int total;
      const int inc = block_inclusive_scan<REPLAY_WARPS>(sz, ws, &total);
      const long long st = run + inc - sz;  // the token's first byte
      run += total;
      // the check, by the tile that holds the token's first byte
      if (sz && ln && st >= b0 && st < b1 && st < a.out_cap &&
          (off == 0 || off > st + a.wp || off > a.d_limit ||
           ln > a.len_limit))
        bad = 1;
      // the token's bytes are [st, st + ln]; it counts if it fits whole
      if (sz == 0 || st + ln >= a.out_cap || st + ln < b0 || st >= b1)
        continue;
      if (st + ln < b1) ent[st + ln - b0] = LIT | (w >> 24);
      if (off == 0) continue;  // malformed: the copy reads 0
      const int q0 = st < b0 ? (int)(b0 - st) : 0;
      const int q1 = (int)min((long long)ln, b1 - st);
      int r = q0 % off;  // q mod off, kept by counting
      for (int q = q0; q < q1; ++q) {
        const long long src = st - off + r;
        uint32_t e = LIT;  // a source before the window reads 0
        if (src >= b0) {
          e = (uint32_t)(src - b0);
        } else if (src >= -(long long)a.wp) {
          e = EXT | (uint32_t)(b0 - src);
        }
        ent[st + q - b0] = e;
        if (++r == off) r = 0;
      }
    }
  }
  if (__syncthreads_or(bad) && tid == 0) *a.cnt = -1;

  // pointer jumping until every entry is a root; on the last round every
  // entry read is final, so that round also tells where roots in earlier
  // tiles' output lie (a root in the window needs no wait)
  const int tail_lo = TB - 4 * a.tail_words;  // first byte of the tail
  int ext_tail, ext_rest;
  for (;;) {
    int pending = 0;
    ext_tail = ext_rest = 0;
    for (int j = tid; j < TB; j += REPLAY_THREADS) {
      uint32_t e = ent[j];
      if ((int32_t)e >= 0) {
        e = ent[e];
        ent[j] = e;
        pending |= (int32_t)e >= 0;
      }
      if ((e & EXT_BIT) && (long long)(e & DIST_MASK) <= b0) {
        if (j >= tail_lo) ext_tail = 1; else ext_rest = 1;
      }
    }
    if (!__syncthreads_or(pending)) break;
  }
  ext_tail = __syncthreads_or(ext_tail);
  ext_rest = __syncthreads_or(ext_rest);

  // the tail first: it is all a later tile can read
  const bool waited = ext_tail || a.tail_words == a.tile_words;
  if (waited) wait_for_tile_before(flags, m);
  store_words(a, ent, b0, a.tile_words - a.tail_words, a.tile_words);
  __threadfence();
  __syncthreads();
  if (tid == 0) *(volatile int32_t*)(flags + m) = 1;
  if (a.tail_words == a.tile_words) return;
  if (ext_rest && !waited) wait_for_tile_before(flags, m);
  store_words(a, ent, b0, 0, a.tile_words - a.tail_words);
}

// Both launches.  sums: max(1, ceil(T / SCAN_CHUNK)) int32; sync:
// SYNC_FLAGS + ceil(out_words / tile_words) int32, zeroed; tile_words a
// multiple of 64 (a tile takes 16 * tile_words bytes of shared memory).
// a.block_starts, a.nb, a.sync, a.cnt and a.tail_words are filled here.
static inline cudaError_t launch_replay(ReplayArgs a, int32_t* sums,
                                        int32_t* sync, int32_t* cnt,
                                        int off_bits, cudaStream_t stream) {
  if (a.tile_words <= 0 || a.tile_words % 64 || off_bits < 0 ||
      off_bits > 16 || a.d_limit >= (1 << off_bits))
    return cudaErrorInvalidValue;
  const int nb = (int)(((long long)a.T + SCAN_CHUNK - 1) / SCAN_CHUNK);
  token_scan_kernel<<<nb > 0 ? nb : 1, SCAN_THREADS, 0, stream>>>(
      a.toks, a.T, sums, nb, cnt, sync);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.out_words <= 0) return e;
  a.block_starts = sums;
  a.nb = nb;
  a.sync = sync;
  a.cnt = cnt;
  a.tail_words = ((1 << off_bits) + 256) / 4;
  if (a.tail_words > a.tile_words) a.tail_words = a.tile_words;
  const long long n_tiles = (a.out_words + a.tile_words - 1) / a.tile_words;
  const size_t smem = (size_t)a.tile_words * 16;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(replay_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  replay_kernel<<<(unsigned)n_tiles, REPLAY_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace lz77
