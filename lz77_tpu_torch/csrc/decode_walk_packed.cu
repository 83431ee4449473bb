// K6: token replay into packed words (decode), tiled parallel form.
//
// Replaces the TPU kernel lz77_tpu/ops/decode_walk.py::_kernel_packed.  Same
// contract as ops/decode_walk.py::walk_decode_packed: token word is
// off | len<<16 | next<<24; a token copies `len` bytes from `off` behind the
// write cursor with byte-serial semantics (lz77.c:178-188), then writes
// `next`; the output is the byte stream packed four to an int32 word,
// little endian, and the byte count.  No priming window.
//
// The replay is decode_common.cuh's, the one K3 launches with a window:
// the token-start scan, then one thread block per tile of `tile_words`
// output words with the tile's parent pointers in shared memory, pointer
// jumping without leaving the SM, all tiles at once, and a hand-off in tile
// order of only the last 2^off_bits + 256 bytes before a tile.  What bounds
// it on this card is the chains of copies and the hand-off, not the 4 B in
// per token and 1 B out per byte of its contract.  Tokens are checked as
// K3's are (with no window and d_limit = 2^off_bits - 1): a corrupt list
// turns the count into -1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

// out: out_cap_words int32 (every word is written); cnt: one int32,
// receives sum(len + 1) over all T tokens, or -1; sums: max(1, ceil(T /
// 2048)) int32; sync: 2 + ceil(out_cap_words / tile_words) int32, zeroed.
extern "C" int lz77_walk_decode_packed(
    const void* toks, int T, void* out, long long out_cap_words, void* cnt,
    void* sums, void* sync, int off_bits, int tile_words, void* stream_) {
  lz77::ReplayArgs a{};
  a.toks = (const int32_t*)toks;
  a.T = T;
  a.out = (uint32_t*)out;
  a.out_cap = 4 * out_cap_words;
  a.out_words = out_cap_words;
  a.tile_words = tile_words;
  a.d_limit = (1 << off_bits) - 1;
  a.len_limit = 255;
  return (int)lz77::launch_replay(a, (int32_t*)sums, (int32_t*)sync,
                                  (int32_t*)cnt, off_bits,
                                  (cudaStream_t)stream_);
}
