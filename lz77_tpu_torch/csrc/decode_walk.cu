// K3: token replay into bytes (decode), with a priming window and the
// stream's checks.
//
// Replaces the TPU kernel lz77_tpu/ops/decode_walk.py::_kernel.  Same
// contract as ops/decode_walk.py::walk_decode: token word is
// off | len<<16 | next<<24; a token copies `len` bytes from `off` behind the
// write cursor with byte-serial semantics (lz77.c:178-188), then writes
// `next`; `wp` history bytes prime the positions -wp..-1.  The output is
// bytes: the wrapper hands the kernel a buffer of whole words, so the
// window lives in a tensor of its own and every store is a 4-byte word.
//
// The replay is decode_common.cuh's, which K6 launches too: the token-start
// scan, then one tiled kernel with the pointers in shared memory and a
// tile-to-tile hand-off of only the last 2^off_bits + 256 bytes; the window
// is the tile before tile 0, final before the launch.  Two launches a call
// whatever the token count, and device-memory scratch of the per-block
// token sums, one flag a tile and two counters.  The tile that holds a
// token's first byte checks it against the stream's limits, so a corrupt
// stream turns the count into -1 and the wrapper need not check on the
// host.  The kernel is bound by the latency of its chains and its hand-off,
// not by the 4 B in per token and 1 B out per byte of its contract.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"

// out: out_words int32 (every word is written, zero past the count);
// win: wp bytes (may be null when wp == 0); cnt: one int32, receives
// sum(len + 1) over all T tokens, or -1 when a token that starts below
// out_cap breaks a limit; sums: max(1, ceil(T / 2048)) int32; sync:
// 2 + ceil(out_words / tile_words) int32, zeroed.
extern "C" int lz77_walk_decode(
    const void* toks, int T, void* out, long long out_cap, long long out_words,
    const void* win, int wp, void* cnt, void* sums, void* sync, int off_bits,
    int d_limit, int len_limit, int tile_words, void* stream_) {
  lz77::ReplayArgs a{};
  a.toks = (const int32_t*)toks;
  a.T = T;
  a.out = (uint32_t*)out;
  a.out_cap = out_cap;
  a.out_words = out_words;
  a.win = (const uint8_t*)win;
  a.wp = wp;
  a.tile_words = tile_words;
  a.d_limit = d_limit;
  a.len_limit = len_limit;
  return (int)lz77::launch_replay(a, (int32_t*)sums, (int32_t*)sync,
                                  (int32_t*)cnt, off_bits,
                                  (cudaStream_t)stream_);
}
