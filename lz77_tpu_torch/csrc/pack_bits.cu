// Token pack at any width and bit phase (the fused encode's last step).
//
// Replaces no TPU kernel: the JAX package's fused pipeline cuts each token
// word to its low width/8 bytes and so refuses every width that is not a
// byte multiple; this kernel is what lets the walk route encode them.  Same
// contract as ops/parse_walk.py::pack_bits: the first `total` token words
// (each `width` bits, 9 <= width <= 32) are written LSB-first from bit
// `phase` (0..7) of the output on, bits outside the tokens zero; the exit
// phase (phase + total * width) & 7 goes to `phase_out`, so the next batch
// takes it on the device without a host round trip.
//
// Bound by bytes: 4 B read a token, width/8 B written.  One thread an
// output word gathers the tokens that cover it (a word meets at most
// ceil(31 / width) + 1 <= 5 tokens), so every store is a whole, coalesced
// word and no two threads touch one.  The grid is sized on the host for
// the batch's most tokens; threads past the batch's bits return at once,
// so the device count is never read on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) pack_bits_kernel(
    const uint32_t* __restrict__ tokens, const int32_t* __restrict__ total_p,
    int width, const int32_t* __restrict__ phase_p, int phase_host,
    uint32_t* __restrict__ out, int32_t* __restrict__ phase_out) {
  const long long w = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long total = *total_p;
  const int phase = phase_p ? *phase_p : phase_host;
  const long long bits = phase + total * width;
  if (w == 0) *phase_out = (int)(bits & 7);
  const long long w0 = 32 * w;
  if (w0 >= bits) return;
  const uint32_t mask = width == 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
  // the first token that ends past the word's first bit
  long long i = (w0 > phase ? w0 - phase : 0) / width;
  int start = (int)(phase + i * width - w0);  // in (-width, 32)
  uint32_t acc = 0;
  for (; i < total && start < 32; ++i, start += width) {
    const uint64_t v = tokens[i] & mask;
    acc |= start >= 0 ? (uint32_t)(v << start) : (uint32_t)(v >> -start);
  }
  out[w] = acc;
}

}  // namespace

// tokens: >= total uint32 words; total, phase_out: one int32 each; phase:
// one int32, or null for `phase_host`; out: max_words uint32, max_words >=
// ceil((phase + total * width) / 32) for every total the batch can have.
extern "C" int lz77_pack_bits(const void* tokens, const void* total,
                              int width, const void* phase, int phase_host,
                              void* out, void* phase_out, long long max_words,
                              void* stream_) {
  if (width < 9 || width > 32 || phase_host < 0 || phase_host > 7 ||
      max_words < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (max_words + THREADS - 1) / THREADS;
  pack_bits_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream_>>>(
      (const uint32_t*)tokens, (const int32_t*)total, width,
      (const int32_t*)phase, phase_host, (uint32_t*)out,
      (int32_t*)phase_out);
  return (int)cudaGetLastError();
}
