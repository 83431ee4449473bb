// K2: greedy parse walk + token pack over LOX words.
//
// Replaces the TPU kernel lz77_tpu/ops/parse_walk.py::_kernel.  Same
// contract as ops/parse_walk.py::walk_parse_pack: walk p <- p + len(p) + 1
// from `entry` while p < valid_total, emit off | len<<ob | next<<(ob+lb)
// per step (next is the byte at p + len), return count and p - valid_total.
//
// Parallel form in three stream-ordered kernels.  The span is cut into M
// sub-blocks of s bytes; a walk leaves a sub-block at most la-1 bytes past
// its end, so its state between sub-blocks is an entry offset in [0, la).
//   1. walk_maps:    thread (m, e) walks sub-block m from entry e and stores
//                    its exit offset and its token count.
//   2. walk_compose: one thread follows the maps from the batch's entry:
//                    true entry and output offset of every sub-block, total
//                    count, exit entry.
//   3. walk_emit:    thread m walks sub-block m from its true entry and
//                    writes packed token words at its offset.
// LOX word: next_char<<24 | len<<16 | off.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ int lox_len(int32_t w) { return (w >> 16) & 0xFF; }

__global__ void walk_maps_kernel(
    const int32_t* __restrict__ lox, int vt, int s, int la, int M,
    uint8_t* __restrict__ exit_map, int32_t* __restrict__ cnt_map) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)M * la) return;
  const int m = (int)(idx / la);
  const int e = (int)(idx - (long long)m * la);
  const long long base = (long long)m * s;
  const long long end = min(base + s, (long long)vt);
  long long p = base + e;
  int c = 0;
  while (p < end) {
    p += lox_len(lox[p]) + 1;
    ++c;
  }
  exit_map[idx] = (uint8_t)(p - end);  // < la: a step is at most la bytes
  cnt_map[idx] = c;
}

__global__ void walk_compose_kernel(
    const uint8_t* __restrict__ exit_map, const int32_t* __restrict__ cnt_map,
    int la, int M, const int32_t* __restrict__ entry_in,
    int32_t* __restrict__ entries, int32_t* __restrict__ offsets,
    int32_t* __restrict__ count_out, int32_t* __restrict__ exit_out) {
  int e = min(max(*entry_in, 0), la - 1);
  int total = 0;
  for (int m = 0; m < M; ++m) {
    const long long k = (long long)m * la + e;
    entries[m] = e;
    offsets[m] = total;
    total += cnt_map[k];
    e = exit_map[k];
  }
  *count_out = total;
  *exit_out = e;  // with M == 0 (empty span) the entry passes through
}

__global__ void walk_emit_kernel(
    const int32_t* __restrict__ lox, int vt, int s, int M,
    const int32_t* __restrict__ entries, const int32_t* __restrict__ offsets,
    int ob, int lb, uint32_t* __restrict__ tokens) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= M) return;
  const long long base = (long long)m * s;
  const long long end = min(base + s, (long long)vt);
  long long p = base + entries[m];
  uint32_t* out = tokens + offsets[m];
  while (p < end) {
    const int32_t w = lox[p];
    const int ln = lox_len(w);
    const uint32_t off = (uint32_t)w & 0xFFFFu;
    const uint32_t nxt = (uint32_t)lox[p + ln] >> 24;
    *out++ = off | ((uint32_t)ln << ob) | (nxt << (ob + lb));
    p += ln + 1;
  }
}

}  // namespace

extern "C" int lz77_walk_parse_pack(
    const void* lox, const void* entry, void* exit_map, void* cnt_map,
    void* entries, void* offsets, void* tokens, void* count, void* exit_out,
    int valid_total, int sub_block, int la, int ob, int lb, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  const int M = (valid_total + sub_block - 1) / sub_block;
  if (M > 0) {
    const long long n = (long long)M * la;
    walk_maps_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                       stream>>>(
        (const int32_t*)lox, valid_total, sub_block, la, M,
        (uint8_t*)exit_map, (int32_t*)cnt_map);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  walk_compose_kernel<<<1, 1, 0, stream>>>(
      (const uint8_t*)exit_map, (const int32_t*)cnt_map, la, M,
      (const int32_t*)entry, (int32_t*)entries, (int32_t*)offsets,
      (int32_t*)count, (int32_t*)exit_out);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (M > 0) {
    walk_emit_kernel<<<(M + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
        (const int32_t*)lox, valid_total, sub_block, M,
        (const int32_t*)entries, (const int32_t*)offsets, ob, lb,
        (uint32_t*)tokens);
    e = cudaGetLastError();
  }
  return (int)e;
}
