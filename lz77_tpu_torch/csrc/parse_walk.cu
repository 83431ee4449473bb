// K2: greedy parse walk + token pack over LOX words.
//
// Replaces the TPU kernel lz77_tpu/ops/parse_walk.py::_kernel.  Same
// contract as ops/parse_walk.py::walk_parse_pack: walk p <- p + len(p) + 1
// from `entry` while p < valid_total, emit off | len<<ob | next<<(ob+lb)
// per step (next is the byte at p + len), return count and p - valid_total.
// LOX word: next_char<<24 | len<<16 | off.
//
// What the contract moves is 4 B read per input byte and 4 B written per
// token; what bounds the walk is its chain of dependent loads.  So the span
// is cut into M sub-blocks of s bytes (a walk leaves a sub-block at most
// la-1 bytes past its end, so its state between sub-blocks is an entry
// offset in [0, la)), every chain step chases shared memory, and the
// serial parts are kept short:
//   1. walk_maps:  one thread block a sub-block stages the length bytes of
//                  its LOX words in shared memory (coalesced, WIN words at a
//                  time), and thread e walks it from entry e: the map
//                  e -> (exit offset, token count).
//   2. walk_scan:  one thread block composes the maps, which are functions
//                  on [0, la) carrying a count, and associative: chunks of
//                  C maps in shared memory; groups of GROUP maps composed
//                  by one thread an entry, the group maps scanned in
//                  log2(C / GROUP) rounds (Hillis-Steele), then one thread
//                  a group applies its maps from the group's true entry.
//                  Out: every sub-block's true entry and token offset, the
//                  total count and the exit entry.  No thread walks more
//                  than GROUP maps in a row.
//   3. walk_emit:  one thread block a sub-block stages its LOX words and
//                  the la-1 words after them; one thread walks from the
//                  true entry and only records token starts in shared
//                  memory; then all threads pack the token words and store
//                  them coalesced at the sub-block's offset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 4096;         // LOX words staged a round
constexpr int EMIT_THREADS = 128;
constexpr int SCAN_THREADS = 1024;
constexpr int GROUP = 32;         // maps composed by one thread in a row
constexpr int SCAN_ENTRIES = 32768;  // C * la: maps a chunk holds
constexpr int GROUP_ENTRIES = SCAN_ENTRIES / GROUP + 256;  // ceil(C/G) * la

__device__ __forceinline__ int lox_len(int32_t w) { return (w >> 16) & 0xFF; }

// blockDim.x = 32 * ceil(la / 32) (>= 128): thread e < la walks from entry e
__global__ void walk_maps_kernel(
    const int32_t* __restrict__ lox, int vt, int s, int la,
    uint8_t* __restrict__ exit_map, int32_t* __restrict__ cnt_map) {
  __shared__ uint8_t lens[WIN];
  const int tid = threadIdx.x;
  const long long m = blockIdx.x;
  const long long base = m * s;
  const long long end = min(base + s, (long long)vt);
  long long p = base + tid;
  int c = 0;
  for (long long w0 = base; w0 < end; w0 += WIN) {
    const long long w1 = min(w0 + WIN, end);
    __syncthreads();  // the last window's walks are done with it
#pragma unroll 8
    for (long long i = w0 + tid; i < w1; i += blockDim.x)
      lens[i - w0] = (uint8_t)lox_len(lox[i]);
    __syncthreads();
    if (tid < la)
      while (p < w1) {
        p += lens[p - w0] + 1;
        ++c;
      }
  }
  if (tid < la) {
    // < la for a LOX whose lengths are < la, as the contract says
    exit_map[m * la + tid] = (uint8_t)min(p - end, (long long)la - 1);
    cnt_map[m * la + tid] = c;
  }
}

// Shared memory of walk_scan: one chunk of maps, and two buffers of group
// maps for the rounds of the scan.
struct ScanSmem {
  int32_t cnt[SCAN_ENTRIES];
  int32_t gcnt[2][GROUP_ENTRIES];
  uint8_t ex[SCAN_ENTRIES];
  uint8_t gex[2][GROUP_ENTRIES];
};

__global__ void __launch_bounds__(SCAN_THREADS) walk_scan_kernel(
    const uint8_t* __restrict__ exit_map, const int32_t* __restrict__ cnt_map,
    int la, int M, int C, const int32_t* __restrict__ entry_in,
    int32_t* __restrict__ entries, int32_t* __restrict__ offsets,
    int32_t* __restrict__ count_out, int32_t* __restrict__ exit_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem_raw);
  const int tid = threadIdx.x;
  int e_in = min(max(*entry_in, 0), la - 1);
  int o_in = 0;
  for (int c0 = 0; c0 < M; c0 += C) {
    const int n = min(C, M - c0);
    const int ng = (n + GROUP - 1) / GROUP;
    __syncthreads();  // the last chunk is read out
#pragma unroll 8
    for (int i = tid; i < n * la; i += SCAN_THREADS) {
      sm.ex[i] = exit_map[(long long)c0 * la + i];
      sm.cnt[i] = cnt_map[(long long)c0 * la + i];
    }
    __syncthreads();
    // group maps: (group j, entry e) through the group's maps
    for (int i = tid; i < ng * la; i += SCAN_THREADS) {
      const int j = i / la, e = i - j * la;
      int x = e, c = 0;
      for (int k = j * GROUP; k < min(n, (j + 1) * GROUP); ++k) {
        c += sm.cnt[k * la + x];
        x = sm.ex[k * la + x];
      }
      sm.gex[0][i] = (uint8_t)x;
      sm.gcnt[0][i] = c;
    }
    // inclusive scan of the group maps: S_j <- S_j o S_{j-d}
    int cur = 0;
    for (int d = 1; d < ng; d <<= 1) {
      __syncthreads();
      for (int i = tid; i < ng * la; i += SCAN_THREADS) {
        const int j = i / la;
        if (j < d) {
          sm.gex[cur ^ 1][i] = sm.gex[cur][i];
          sm.gcnt[cur ^ 1][i] = sm.gcnt[cur][i];
        } else {
          const int e = i - j * la;
          const int x = sm.gex[cur][(j - d) * la + e];
          sm.gex[cur ^ 1][i] = sm.gex[cur][j * la + x];
          sm.gcnt[cur ^ 1][i] =
              sm.gcnt[cur][(j - d) * la + e] + sm.gcnt[cur][j * la + x];
        }
      }
      cur ^= 1;
    }
    __syncthreads();
    // each group from its true entry: its maps' entries and offsets
    for (int j = tid; j < ng; j += SCAN_THREADS) {
      int x = e_in, o = o_in;
      if (j > 0) {
        x = sm.gex[cur][(j - 1) * la + e_in];
        o += sm.gcnt[cur][(j - 1) * la + e_in];
      }
      for (int k = j * GROUP; k < min(n, (j + 1) * GROUP); ++k) {
        entries[c0 + k] = x;
        offsets[c0 + k] = o;
        o += sm.cnt[k * la + x];
        x = sm.ex[k * la + x];
      }
    }
    // every thread carries the chunk's exit alike
    o_in += sm.gcnt[cur][(ng - 1) * la + e_in];
    e_in = sm.gex[cur][(ng - 1) * la + e_in];
  }
  if (tid == 0) {
    *count_out = o_in;
    *exit_out = e_in;  // with M == 0 (empty span) the entry passes through
  }
}

__global__ void __launch_bounds__(EMIT_THREADS) walk_emit_kernel(
    const int32_t* __restrict__ lox, int vt, int s, int la,
    const int32_t* __restrict__ entries, const int32_t* __restrict__ offsets,
    int ob, int lb, uint32_t* __restrict__ tokens) {
  __shared__ int32_t words[WIN + 256];  // a window and its la-1 overhang
  __shared__ uint16_t starts[WIN];      // token starts, window-relative
  __shared__ int sh_k;
  const int tid = threadIdx.x;
  const long long m = blockIdx.x;
  const long long base = m * s;
  const long long end = min(base + s, (long long)vt);
  long long p = base + entries[m];  // thread 0's walk
  long long out = offsets[m];
  for (long long w0 = base; w0 < end; w0 += WIN) {
    const long long w1 = min(w0 + WIN, end);
    const int n = (int)(w1 - w0) + la - 1;  // lox holds vt + la words
    __syncthreads();  // the last window is packed
#pragma unroll 8
    for (int i = tid; i < n; i += EMIT_THREADS) words[i] = lox[w0 + i];
    __syncthreads();
    if (tid == 0) {
      int k = 0;
      while (p < w1) {
        starts[k++] = (uint16_t)(p - w0);
        p += lox_len(words[p - w0]) + 1;
      }
      sh_k = k;
    }
    __syncthreads();
    const int k = sh_k;
    for (int i = tid; i < k; i += EMIT_THREADS) {
      const int q = starts[i];
      const int32_t w = words[q];
      const int ln = lox_len(w);
      const uint32_t nxt = (uint32_t)words[min(q + ln, n - 1)] >> 24;
      tokens[out + i] = ((uint32_t)w & 0xFFFFu) | ((uint32_t)ln << ob) |
                        (nxt << (ob + lb));
    }
    out += k;
  }
}

}  // namespace

// exit_map, cnt_map: M * la uint8 / int32; entries, offsets: M int32,
// M = ceil(valid_total / sub_block); tokens: >= count int32.
extern "C" int lz77_walk_parse_pack(
    const void* lox, const void* entry, void* exit_map, void* cnt_map,
    void* entries, void* offsets, void* tokens, void* count, void* exit_out,
    int valid_total, int sub_block, int la, int ob, int lb, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (la < 2 || la > 255 || sub_block < 1) return (int)cudaErrorInvalidValue;
  const int M = (int)(((long long)valid_total + sub_block - 1) / sub_block);
  cudaError_t e;
  if (M > 0) {
    const int threads = max(128, (la + 31) / 32 * 32);
    walk_maps_kernel<<<(unsigned)M, threads, 0, stream>>>(
        (const int32_t*)lox, valid_total, sub_block, la, (uint8_t*)exit_map,
        (int32_t*)cnt_map);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const size_t smem = sizeof(ScanSmem);
  e = cudaFuncSetAttribute(walk_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  walk_scan_kernel<<<1, SCAN_THREADS, smem, stream>>>(
      (const uint8_t*)exit_map, (const int32_t*)cnt_map, la, M,
      SCAN_ENTRIES / la, (const int32_t*)entry, (int32_t*)entries,
      (int32_t*)offsets, (int32_t*)count, (int32_t*)exit_out);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (M > 0) {
    walk_emit_kernel<<<(unsigned)M, EMIT_THREADS, 0, stream>>>(
        (const int32_t*)lox, valid_total, sub_block, la,
        (const int32_t*)entries, (const int32_t*)offsets, ob, lb,
        (uint32_t*)tokens);
    e = cudaGetLastError();
  }
  return (int)e;
}
