// K6: token replay into packed words (decode), serial form.
//
// Replaces the TPU kernel lz77_tpu/ops/decode_walk.py::_kernel_packed.  Same
// contract as ops/decode_walk.py::walk_decode_packed: token word is
// off | len<<16 | next<<24; a token copies `len` bytes from `off` behind the
// write cursor with byte-serial semantics (lz77.c:178-188), then writes
// `next`; the output is the byte stream packed four to an int32 word,
// little endian, and the byte count.  No priming window.
//
// This kernel keeps the serial replay (K3, decode_walk.cu, is the parallel
// one).  One thread block:
//   * the ring of the last RB = max(2^(off_bits+1), 8192) decoded bytes lives
//     in dynamic shared memory as words, indexed (p >> 2) & (RB/4 - 1).
//     RB >= 2 * max_off, and the replay never runs more than RB/2 + one
//     token ahead of what has been written out, so a slot is reused only
//     after its bytes were flushed and are out of every match's reach;
//   * all threads stage CHUNK token words into shared memory at a time;
//   * warp 0 replays them in order.  A copy with off >= 4 goes a word at a
//     time: lane j takes destination word (p >> 2) + j and builds it from
//     the two ring words that hold its source bytes (__funnelshift_r); up
//     to min(32, off / 4) lanes work at once, so no lane reads a byte this
//     step writes.  The first word is blended with the bytes already there;
//     the last may run up to 3 bytes past the token's end, onto positions
//     that are rewritten in order before anything reads them.  off == 1
//     splats one byte (b * 0x01010101) the same way with all 32 lanes;
//     off 2 and 3 go byte by byte.  The literal is one byte store.  (A
//     variant in which lane 0 alone replayed short copies, with no warp
//     barrier between tokens, measured the same time a token: the replay is
//     bound by the instructions one warp issues per token, see PERF.md.)
//   * when the replay is RB/2 ahead (or the chunk is used up) the whole
//     block writes the finished ring words to global memory, coalesced.
// Ring indices are masked, so malformed tokens cannot fault; the wrapper
// rejects them before the launch.  Output words past the count are left as
// the wrapper made them (zero); the bytes of the last word past the count
// are written as zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 2048;        // token words staged at a time
constexpr int MIN_RING = 8192;     // bytes

// The destination word `d` of a copy at distance `off` >= 4: its four source
// bytes, from the two ring words that hold them.
__device__ __forceinline__ uint32_t source_word(const uint32_t* ring,
                                                uint32_t wmask, uint32_t d,
                                                uint32_t off) {
  const uint32_t sa = d * 4u - off;  // source byte address (mod 2^32)
  const uint32_t sw = sa >> 2;
  return __funnelshift_r(ring[sw & wmask], ring[(sw + 1) & wmask],
                         8 * (sa & 3u));
}

__global__ void __launch_bounds__(THREADS) decode_packed_kernel(
    const int32_t* __restrict__ toks, int T, uint32_t* __restrict__ out,
    int out_cap_words, int32_t* __restrict__ cnt, int ring_bytes) {
  extern __shared__ uint32_t smem[];
  uint32_t* tok = smem;            // CHUNK token words
  uint32_t* ring = smem + CHUNK;   // ring_bytes / 4 words
  uint8_t* ring8 = reinterpret_cast<uint8_t*>(ring);
  __shared__ uint32_t sh_p;
  __shared__ int sh_i;
  const uint32_t wmask = (uint32_t)(ring_bytes >> 2) - 1u;
  const uint32_t bmask = (uint32_t)ring_bytes - 1u;
  const int lane = threadIdx.x & 31;
  const bool replayer = threadIdx.x < 32;

  // positions are bytes of output, below 2^31 (the wrapper sees to it)
  uint32_t p = 0;        // write cursor (replay warp)
  uint32_t flushed = 0;  // bytes written out so far, a multiple of 4
  int base = 0;          // first token of the staged chunk
  int i = 0;             // next token within the chunk (replay warp)
  int n = 0;             // tokens in the staged chunk
  bool stage = true;
  while (base < T) {
    if (stage) {
      n = min(CHUNK, T - base);
      for (int t = threadIdx.x; t < n; t += THREADS)
        tok[t] = (uint32_t)toks[base + t];
      i = 0;
    }
    __syncthreads();
    if (replayer) {
      const uint32_t limit = flushed + (uint32_t)(ring_bytes >> 1);
      while (i < n && p < limit) {
        const uint32_t w = tok[i++];
        const uint32_t off = w & 0xFFFFu;
        const uint32_t ln = (w >> 16) & 0xFFu;
        const uint32_t qe = p + ln;
        if (ln > 0) {
          if (off >= 4u || off == 1u) {
            uint32_t bb = 0;
            if (off == 1u) bb = ring8[(p - 1u) & bmask] * 0x01010101u;
            const uint32_t width = off == 1u ? 32u : min(32u, off >> 2);
            const uint32_t we = (qe + 3u) >> 2;  // one past the last word
            // bytes of the first word below p are kept
            const uint32_t keep = (1u << (8 * (p & 3u))) - 1u;
            uint32_t wd = p >> 2;                // next destination word
            while (wd < we) {
              const uint32_t nl = min(width, we - wd);
              if ((uint32_t)lane < nl) {
                const uint32_t d = wd + lane;
                uint32_t v = off == 1u ? bb : source_word(ring, wmask, d, off);
                if (d == (p >> 2) && keep)
                  v = (ring[d & wmask] & keep) | (v & ~keep);
                ring[d & wmask] = v;
              }
              __syncwarp();
              wd += nl;
            }
          } else {
            // off 2, 3 (or a malformed 0): byte-serial, one lane
            if (lane == 0) {
              for (uint32_t q = p; q < qe; ++q)
                ring8[q & bmask] = ring8[(q - off) & bmask];
            }
            __syncwarp();
          }
        }
        if (lane == 0) ring8[qe & bmask] = (uint8_t)(w >> 24);
        __syncwarp();
        p = qe + 1u;
      }
      if (lane == 0) {
        sh_p = p;
        sh_i = i;
      }
    }
    __syncthreads();
    // the whole block writes the finished words out
    const uint32_t done = sh_p;
    const uint32_t upto = min(done >> 2, (uint32_t)out_cap_words);
    for (uint32_t wd = (flushed >> 2) + threadIdx.x; wd < upto; wd += THREADS)
      out[wd] = ring[wd & wmask];
    flushed = done & ~3u;
    stage = sh_i >= n;
    if (stage) base += n;
    __syncthreads();  // ring slots and the token buffer may be reused now
  }
  if (threadIdx.x == 0) {
    const uint32_t done = T > 0 ? sh_p : 0u;
    if ((done & 3u) && (done >> 2) < (uint32_t)out_cap_words)
      out[done >> 2] = ring[(done >> 2) & wmask] &
                       ((1u << (8 * (done & 3u))) - 1u);
    *cnt = (int32_t)done;
  }
}

}  // namespace

// out: out_cap_words int32, zeroed; cnt: one int32.  The ring takes
// max(2^(off_bits+1), 8192) bytes of shared memory beside the token buffer.
extern "C" int lz77_walk_decode_packed(
    const void* toks, int T, void* out, int out_cap_words, void* cnt,
    int off_bits, void* stream) {
  int ring_bytes = 1 << (off_bits + 1);
  if (ring_bytes < MIN_RING) ring_bytes = MIN_RING;
  const size_t smem = (size_t)CHUNK * 4 + ring_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  decode_packed_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)toks, T, (uint32_t*)out, out_cap_words, (int32_t*)cnt,
      ring_bytes);
  return (int)cudaGetLastError();
}
