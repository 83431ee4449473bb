// K6: token replay into packed words (decode), tiled parallel form.
//
// Replaces the TPU kernel lz77_tpu/ops/decode_walk.py::_kernel_packed.  Same
// contract as ops/decode_walk.py::walk_decode_packed: token word is
// off | len<<16 | next<<24; a token copies `len` bytes from `off` behind the
// write cursor with byte-serial semantics (lz77.c:178-188), then writes
// `next`; the output is the byte stream packed four to an int32 word,
// little endian, and the byte count.  No priming window.
//
// What the contract moves is 4 B per token in and 1 B per byte out; what
// bounds a replay on this card is the chain of copies, so the kernel is
// built to resolve as much of every chain as it can without leaving the SM
// and to keep what is left of the serial order short.  It is K3's replay
// (decode_walk.cu: parent pointers, pointer jumping) with the pointers held
// in shared memory, a tile of the output at a time, so no per-byte array
// ever lies in device memory:
//   1. token_sums / token_starts (decode_common.cuh, shared with K3): every
//      block of 2048 tokens gets its first output position.
//   2. decode_packed_kernel, one thread block per tile of `tile_words`
//      output words, all tiles at once.  A tile takes its number from an
//      atomic ticket, finds the first block of tokens that reaches into it
//      by a search over the block starts, re-scans those blocks, and gives
//      every byte of the tile one 32-bit entry in shared memory:
//        LIT | value           a literal (or 0 for a byte no token covers),
//        parent index >= 0     a copy whose source start - off + (q mod off)
//                              lies in the tile (overlaps cost no hop),
//        EXT | distance        a copy whose source lies `distance` bytes
//                              before the tile's first byte.
//      Pointer jumping, entry[j] <- entry[entry[j]] while entry[j] >= 0, in
//      place in shared memory, ends with every entry a root: a value, or a
//      byte of earlier output.  A racing read sees some ancestor's entry,
//      which is as good; every round at least halves the chains.
//   3. The hand-off, in tile order.  An external source lies at most
//      2^off_bits - 1 behind the copy's token and that token starts at most
//      254 bytes before the tile, so only the last
//      `tail` = min(2^off_bits + 256, tile) bytes of the output before a
//      tile can be its source.  A tile therefore resolves, packs and stores
//      its own tail first, fences, and raises its flag; the tile after it
//      waits for that flag alone.  A tail with no external entry does not
//      wait for the tile before: the chain is broken there.  The rest of the
//      tile follows after the flag is up.  (Where 2^off_bits + 256 exceeds
//      the tile, the tail is the whole tile and every tile waits.)
//      External bytes are read from the output words in device memory (L2
//      holds them: they were written microseconds ago) with loads that
//      bypass L1.  The ticket makes sure a tile's predecessor is resident
//      or done, so the wait cannot hang.
// Every word of the output is written (zero past the count, and the bytes
// of the last word past the count), so the wrapper need not clear it.  A
// token that does not fit the output whole writes nothing; a copy with
// off == 0 or a source before position 0 reads 0.  The wrapper rejects such
// tokens before the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t LIT = 0x80000000u;      // | byte value
constexpr uint32_t EXT = 0xC0000000u;      // | distance before the tile
constexpr uint32_t EXT_BIT = 0x40000000u;  // set in EXT, clear in LIT
constexpr uint32_t DIST_MASK = 0x3FFFFu;   // distance <= 65535 + 254

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
// an earlier tile stored.  b0 is the tile's first byte.
__device__ __forceinline__ void store_words(
    const uint32_t* ent, uint32_t* out, long long b0, int w_lo, int w_hi,
    long long out_cap_words) {
  const uint8_t* out8 = reinterpret_cast<const uint8_t*>(out);
  const long long word0 = b0 >> 2;
  w_hi = (int)min((long long)w_hi, out_cap_words - word0);
  for (int w = w_lo + threadIdx.x; w < w_hi; w += THREADS) {
    const uint4 e4 = reinterpret_cast<const uint4*>(ent)[w];
    const uint32_t e[4] = {e4.x, e4.y, e4.z, e4.w};
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t v = e[k] & 0xFFu;
      if (e[k] & EXT_BIT)
        v = __ldcg(out8 + (b0 - (long long)(e[k] & DIST_MASK)));
      word |= v << (8 * k);
    }
    out[word0 + w] = word;
  }
}

__global__ void __launch_bounds__(THREADS) decode_packed_kernel(
    const int32_t* __restrict__ toks, int T,
    const int32_t* __restrict__ block_starts, int nb,
    uint32_t* out,             // read back by later tiles: no __restrict__
    long long out_cap_words,
    int32_t* sync,             // zeroed: [0] ticket, [1 + m] tile m's flag
    int tile_words, int tail_words) {
  extern __shared__ __align__(16) uint32_t ent[];  // 4 * tile_words entries
  __shared__ int ws[WARPS];
  __shared__ int sh_m;
  const int tid = threadIdx.x;
  if (tid == 0) sh_m = atomicAdd(sync, 1);
  __syncthreads();
  const int m = sh_m;
  int32_t* flags = sync + 1;
  const int TB = 4 * tile_words;                 // bytes of a tile
  const long long b0 = (long long)m * TB;        // the tile's first byte
  const long long b1 = b0 + TB;
  const long long out_cap = 4 * out_cap_words;   // bytes

  for (int j = tid; j < TB; j += THREADS) ent[j] = LIT;
  // the last block of tokens that starts at or before b0 (block 0 starts at
  // 0); all threads search alike, the loads are broadcast
  int b = 0;  // block_starts[b] <= b0 < block_starts[hi]
  for (int hi = nb; hi - b > 1;) {
    const int mid = (b + hi) >> 1;
    if (__ldg(block_starts + mid) <= b0) b = mid; else hi = mid;
  }
  __syncthreads();

  for (; b < nb; ++b) {
    long long run = __ldg(block_starts + b);
    if (run >= b1) break;  // block-uniform
    for (int it = 0; it < lz77::SCAN_CHUNK / THREADS; ++it) {
      const long long i = (long long)b * lz77::SCAN_CHUNK + it * THREADS + tid;
      const uint32_t w = i < T ? (uint32_t)toks[i] : 0u;
      const int off = (int)(w & 0xFFFFu);
      const int ln = (int)((w >> 16) & 0xFFu);
      const int sz = i < T ? ln + 1 : 0;
      int total;
      const int inc = lz77::block_inclusive_scan<WARPS>(sz, ws, &total);
      const long long st = run + inc - sz;  // the token's first byte
      run += total;
      // the token's bytes are [st, st + ln]; it counts if it fits whole
      if (sz == 0 || st + ln >= out_cap || st + ln < b0 || st >= b1) continue;
      if (st + ln < b1) ent[st + ln - b0] = LIT | (w >> 24);
      if (off == 0) continue;  // malformed: the copy reads 0
      const int q0 = st < b0 ? (int)(b0 - st) : 0;
      const int q1 = (int)min((long long)ln, b1 - st);
      int r = q0 % off;  // q mod off, kept by counting
      for (int q = q0; q < q1; ++q) {
        const long long src = st - off + r;
        uint32_t e = LIT;  // a source before position 0 reads 0
        if (src >= b0) {
          e = (uint32_t)(src - b0);
        } else if (src >= 0) {
          e = EXT | (uint32_t)(b0 - src);
        }
        ent[st + q - b0] = e;
        if (++r == off) r = 0;
      }
    }
  }
  __syncthreads();

  // pointer jumping until every entry is a root; on the last round every
  // entry read is final, so that round also tells where external roots lie
  const int tail_lo = TB - 4 * tail_words;  // first byte of the tail
  int ext_tail, ext_rest;
  for (;;) {
    int pending = 0;
    ext_tail = ext_rest = 0;
    for (int j = tid; j < TB; j += THREADS) {
      uint32_t e = ent[j];
      if ((int32_t)e >= 0) {
        e = ent[e];
        ent[j] = e;
        pending |= (int32_t)e >= 0;
      }
      if (e & EXT_BIT) {
        if (j >= tail_lo) ext_tail = 1; else ext_rest = 1;
      }
    }
    if (!__syncthreads_or(pending)) break;
  }
  ext_tail = __syncthreads_or(ext_tail);
  ext_rest = __syncthreads_or(ext_rest);

  // the tail first: it is all a later tile can read.  Where the tail is
  // the whole tile a source may lie several tiles back, and a flag has to
  // mean that everything before is final: then every tile waits.
  bool waited = false;
  if (ext_tail || tail_words == tile_words) {
    wait_for_tile_before(flags, m);
    waited = true;
  }
  store_words(ent, out, b0, tile_words - tail_words, tile_words,
              out_cap_words);
  __threadfence();
  __syncthreads();
  if (tid == 0) *(volatile int32_t*)(flags + m) = 1;
  if (tail_words == tile_words) return;
  if (ext_rest && !waited) wait_for_tile_before(flags, m);
  store_words(ent, out, b0, 0, tile_words - tail_words, out_cap_words);
}

}  // namespace

// out: out_cap_words int32 (every word is written); cnt: one int32, receives
// sum(len + 1) over all T tokens; sums: ceil(T / 2048) int32; sync:
// 1 + ceil(out_cap_words / tile_words) int32, zeroed.  tile_words is a
// multiple of 64 (a tile takes 16 * tile_words bytes of shared memory).
extern "C" int lz77_walk_decode_packed(
    const void* toks, int T, void* out, long long out_cap_words, void* cnt,
    void* sums, void* sync, int off_bits, int tile_words, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  int nb;
  if (cudaError_t e = lz77::launch_token_starts(
          (const int32_t*)toks, T, (int32_t*)sums, (int32_t*)cnt, stream, &nb))
    return (int)e;
  if (out_cap_words <= 0) return 0;
  if (tile_words <= 0 || tile_words % 64) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (out_cap_words + tile_words - 1) / tile_words;
  int tail_words = ((1 << off_bits) + 256) / 4;
  if (tail_words > tile_words) tail_words = tile_words;
  const size_t smem = (size_t)tile_words * 16;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_packed_kernel<<<(unsigned)n_tiles, THREADS, smem, stream>>>(
      (const int32_t*)toks, T, (const int32_t*)sums, nb, (uint32_t*)out,
      out_cap_words, (int32_t*)sync, tile_words, tail_words);
  return (int)cudaGetLastError();
}
