// X-V, X-S, X-F, X-Q: the co-issue probe's four kernels.
//
// Replace the TPU kernels of experiments/coissue.py: _kernel_v (X-V),
// _kernel_s (X-S), _kernel_f (X-F) and _kernel_q (X-Q).  The probe asks
// whether a latency-bound chain of dependent scalar loads can hide behind
// throughput-bound slab work inside one kernel.  On the TPU that is one
// program on one TensorCore, so here every kernel runs as ONE thread block
// on one SM: the question is about one SM's units.
//
//   V  nv steps of vec_body over the whole (8, 32, 128) int32 slab in
//      shared memory: y = (x ^ roll(x, 1, lanes)) | (x & roll(x, 1, rows));
//      x = y + 1.  VEC_THREADS threads, 64 elements each: every thread
//      reads its element and its two roll neighbours (lane - 1 mod 128,
//      row - 1 mod 32) into registers, a barrier, the stores, a barrier.
//      All 8 slabs are updated (the TPU kernel's output is slab 0 alone,
//      but it updates all 8; the probe times all 8).  The function's bound
//      is integer issue at one SM: two instructions an element a step (one
//      three-input LOP3 for (x ^ a) | (x & b), one IADD).  This design's
//      limit is shared memory, at 32 words a clock for its four accesses
//      an element a step (three loads, a store); a slab held in registers
//      would not meet it.
//   S  ns dependent steps on a (4096,) table in shared memory, the seed in
//      its first half: w = tab[p]; tab[(t + 2048) % 4096] = w | (ln << 8)
//      with ln = (w >> 16) & 0xFF; t += 1; p = (p + ln + 1) % 2048.  One
//      thread: every load's address is the previous load's value, so the
//      bound is the latency of the chain, one shared-memory load-to-use a
//      step, and nothing a design can spread over threads.
//   F  the Hopper form of "one basic block, the scheduler is free to
//      interleave": the two chains on different warps of one block.  The
//      VEC_THREADS vector threads run the nv bodies and synchronise on
//      the named barrier 1 (bar.sync 1, VEC_THREADS) alone; one extra warp
//      copies the seed and its lane 0 runs the nv * k scalar steps, never
//      waiting on a barrier of the vector warps.  The SM's warp schedulers
//      interleave the warps, so the time shows whether the chain hides
//      behind the slab work.  (The chain on thread 0 behind a barrier each
//      iteration gives the same output but would time the barrier.)
//   Q  the nv vector loop, then the ns scalar loop on thread 0: the two
//      nests in sequence, the probe's yardstick for "no overlap".
//
// The TPU kernels read the slab from uninitialised memory; these read it
// from `init` (the wrapper passes zeros unless told otherwise).  All
// arithmetic is uint32_t: int32 wraps on the TPU, and signed overflow is
// undefined in C++; the logical shift of the TPU kernel is an unsigned
// shift here.  Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB = 8;
constexpr int RR = 32;
constexpr int LANES = 128;
constexpr int SCH = 2048;
constexpr int N = SLAB * RR * LANES;            // 32,768 elements
constexpr int VEC_THREADS = 512;
constexpr int PER = N / VEC_THREADS;            // elements a vector thread
constexpr int ROWS_A_PASS = VEC_THREADS / LANES;
constexpr int SLAB_BYTES = N * 4;               // 131,072
constexpr int TABLE_BYTES = 2 * SCH * 4;        // 16,384

__device__ __forceinline__ void vec_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(VEC_THREADS) : "memory");
}

__device__ __forceinline__ void load_slab(uint32_t* v, const uint32_t* init,
                                          int tid) {
  for (int i = tid; i < N; i += VEC_THREADS) v[i] = init[i];
  vec_barrier();
}

__device__ __forceinline__ void store_slab(uint32_t* out, const uint32_t* v,
                                           int tid) {
  for (int i = tid; i < N; i += VEC_THREADS) out[i] = v[i];
}

// One vec_body over all 8 slabs.  Thread tid owns lane l = tid % 128 of the
// rows tid / 128 + 4 j (a row is slab * 32 + r), so its elements are
// tid + 512 j and a warp reads 32 consecutive words, as do its neighbour
// reads: no bank conflicts.  The neighbours are one lane left (e - 1, or
// e + 127 at lane 0) and one row up (e - 128, or e + 31 * 128 at r == 0,
// which only the threads of rows 4 j meet, at every 8th j): offsets from
// the element's own index, so the addresses cost no registers a j.
__device__ __forceinline__ void vec_body(uint32_t* v, int tid) {
  const int l = tid & (LANES - 1);
  const int dl = ((l - 1) & (LANES - 1)) - l;
  const int wrap = tid < LANES ? RR * LANES : 0;
  uint32_t y[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + j * VEC_THREADS;
    const int up = e - LANES + (j % (RR / ROWS_A_PASS) == 0 ? wrap : 0);
    const uint32_t x = v[e];
    y[j] = ((x ^ v[e + dl]) | (x & v[up])) + 1u;
  }
  vec_barrier();
#pragma unroll
  for (int j = 0; j < PER; ++j) v[tid + j * VEC_THREADS] = y[j];
  vec_barrier();
}

__device__ __forceinline__ void load_table(uint32_t* tab, const uint32_t* seed,
                                           int tid, int nthreads) {
  for (int i = tid; i < SCH; i += nthreads) tab[i] = seed[i];
}

// `steps` walk-like dependent steps from (t, p); returns t + p.
__device__ __forceinline__ uint32_t scal_steps(uint32_t* tab, long long steps) {
  uint32_t t = 0, p = 0;
#pragma unroll 8
  for (long long i = 0; i < steps; ++i) {
    const uint32_t w = tab[p];
    const uint32_t ln = (w >> 16) & 0xFFu;
    tab[(t + SCH) & (2 * SCH - 1)] = w | (ln << 8);
    t += 1u;
    p = (p + ln + 1u) & (SCH - 1);
  }
  return t + p;
}

__global__ void __launch_bounds__(VEC_THREADS)
coissue_v_kernel(const uint32_t* init, uint32_t* out, int nv) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  load_slab(smem, init, tid);
  for (int i = 0; i < nv; ++i) vec_body(smem, tid);
  store_slab(out, smem, tid);
}

__global__ void coissue_s_kernel(const uint32_t* seed, uint32_t* out,
                                 long long steps) {
  extern __shared__ uint32_t smem[];
  load_table(smem, seed, threadIdx.x, blockDim.x);
  __syncthreads();
  if (threadIdx.x == 0) out[0] = scal_steps(smem, steps);
}

__global__ void __launch_bounds__(VEC_THREADS + 32)
coissue_f_kernel(const uint32_t* seed, const uint32_t* init, uint32_t* out,
                 uint32_t* out2, int nv, long long steps) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem + N;
  const int tid = threadIdx.x;
  if (tid < VEC_THREADS) {
    load_slab(smem, init, tid);
    for (int i = 0; i < nv; ++i) vec_body(smem, tid);
    store_slab(out, smem, tid);
  } else {  // the scalar warp: no barrier of the vector warps
    load_table(tab, seed, tid - VEC_THREADS, 32);
    __syncwarp();
    if (tid == VEC_THREADS) out2[0] = scal_steps(tab, steps);
  }
}

__global__ void __launch_bounds__(VEC_THREADS)
coissue_q_kernel(const uint32_t* seed, const uint32_t* init, uint32_t* out,
                 uint32_t* out2, int nv, long long steps) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem + N;
  const int tid = threadIdx.x;
  load_table(tab, seed, tid, VEC_THREADS);
  load_slab(smem, init, tid);  // its barrier covers the table too
  for (int i = 0; i < nv; ++i) vec_body(smem, tid);
  store_slab(out, smem, tid);
  if (tid == 0) out2[0] = scal_steps(tab, steps);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

}  // namespace

// init: (8, 32, 128) int32; out: the whole slab after nv steps.
extern "C" int lz77_coissue_v(const void* init, void* out, int nv,
                              void* stream) {
  cudaError_t e = allow_smem(coissue_v_kernel, SLAB_BYTES);
  if (e != cudaSuccess) return (int)e;
  coissue_v_kernel<<<1, VEC_THREADS, SLAB_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)init, (uint32_t*)out, nv);
  return (int)cudaGetLastError();
}

// seed: (2048,) int32; out: one int32, t + p after `steps` steps.
extern "C" int lz77_coissue_s(const void* seed, void* out, long long steps,
                              void* stream) {
  coissue_s_kernel<<<1, 32, TABLE_BYTES, (cudaStream_t)stream>>>(
      (const uint32_t*)seed, (uint32_t*)out, steps);
  return (int)cudaGetLastError();
}

// out: the whole slab after nv steps; out2: t + p after `steps` (nv * k).
extern "C" int lz77_coissue_f(const void* seed, const void* init, void* out,
                              void* out2, int nv, long long steps,
                              void* stream) {
  cudaError_t e = allow_smem(coissue_f_kernel, SLAB_BYTES + TABLE_BYTES);
  if (e != cudaSuccess) return (int)e;
  coissue_f_kernel<<<1, VEC_THREADS + 32, SLAB_BYTES + TABLE_BYTES,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)seed, (const uint32_t*)init, (uint32_t*)out,
      (uint32_t*)out2, nv, steps);
  return (int)cudaGetLastError();
}

extern "C" int lz77_coissue_q(const void* seed, const void* init, void* out,
                              void* out2, int nv, long long steps,
                              void* stream) {
  cudaError_t e = allow_smem(coissue_q_kernel, SLAB_BYTES + TABLE_BYTES);
  if (e != cudaSuccess) return (int)e;
  coissue_q_kernel<<<1, VEC_THREADS, SLAB_BYTES + TABLE_BYTES,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)seed, (const uint32_t*)init, (uint32_t*)out,
      (uint32_t*)out2, nv, steps);
  return (int)cudaGetLastError();
}
