// X-V, X-S, X-F, X-Q: the co-issue probe's four kernels.
//
// Replace the TPU kernels of experiments/coissue.py: _kernel_v (X-V),
// _kernel_s (X-S), _kernel_f (X-F) and _kernel_q (X-Q).  The probe asks
// whether a latency-bound chain of dependent scalar loads can hide behind
// throughput-bound slab work inside one kernel.  On the TPU that is one
// program on one TensorCore, so here every kernel runs as ONE thread block
// on one SM: the question is about one SM's units.
//
//   V  nv steps of vec_body over the whole (8, 32, 128) int32 slab:
//      y = (x ^ roll(x, 1, lanes)) | (x & roll(x, 1, rows)); x = y + 1.
//      Both rolls stay inside a slab, so each slab lives in the registers
//      of one warp: warp w holds slab w, thread t its lanes 4t..4t+3 of
//      all 32 rows (128 registers).  The row roll moves no data: the rows
//      are updated in place from 31 down to 0, so the row above is still
//      the old one, and row 0 takes the old row 31 saved first.  The lane
//      roll stays in the thread for lanes 4t+1..4t+3 (updated from 4t+3
//      down, so each left neighbour is still old); lane 4t takes lane
//      4t-1's old word from thread t-1 by one __shfl_sync a row (thread 0
//      from thread 31).  No shared memory, no barrier in a body (one
//      before the loop, see vec_loop).  All 8 slabs are updated (the TPU
//      kernel's output is slab 0 alone, but it updates all 8; the probe
//      times all 8).  The function's bound is issue at one SM: two
//      instructions an element a step (one three-input LOP3 for
//      (x ^ a) | (x & b), one add), four warp schedulers issuing 32 lanes
//      a clock each; the LOP3s alone fill the SM's 64 INT32 lanes as long,
//      and ptxas gives the add to the FMA lanes (VIADD).  The design adds
//      one shuffle for every 8 of them, on another pipe.
//   S  ns dependent steps on a (4096,) table in shared memory, the seed in
//      its first half: w = tab[p]; tab[(t + 2048) % 4096] = w | (ln << 8)
//      with ln = (w >> 16) & 0xFF; t += 1; p = (p + ln + 1) % 2048.  One
//      thread: every load's address is the previous load's value, so the
//      bound is the latency of the chain, one shared-memory load-to-use a
//      step, and nothing a design can spread over threads.
//   F  the Hopper form of "one basic block, the scheduler is free to
//      interleave": the two chains on different warps of one block.  The
//      8 slab warps run V's nv bodies with no barrier between them and
//      the chain (only their own one before the loop); a 9th warp
//      copies the seed into the table and its lane 0 runs the nv * k
//      scalar steps.  The SM's warp schedulers interleave the warps, so
//      the time shows whether the chain hides behind the slab's integer
//      issue; the chain's shared-memory loads have that pipe to themselves
//      but for V's shuffles.
//   Q  the nv slab bodies, a __syncthreads(), then the ns scalar steps on
//      thread 0: the two nests in sequence, the probe's yardstick for "no
//      overlap".  Without the barrier warp 0 would start the chain while
//      the other warps are still in their bodies.
//
// The TPU kernels read the slab from uninitialised memory; these read it
// from `init` (the wrapper passes zeros unless told otherwise).  All
// arithmetic is uint32_t: int32 wraps on the TPU, and signed overflow is
// undefined in C++; the logical shift of the TPU kernel is an unsigned
// shift here.  Every index into a thread's slab array is a compile-time
// constant (full unrolling), or the array would go to local memory.  Each
// entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLAB = 8;
constexpr int RR = 32;
constexpr int LANES = 128;
constexpr int SCH = 2048;
constexpr int PER = LANES / 32;                 // lanes a thread, each row
constexpr int VEC_THREADS = SLAB * 32;          // one warp a slab
constexpr unsigned FULL = 0xFFFFFFFFu;

// Thread tid's words: slab tid / 32, lanes 4 (tid % 32) .. + 3 of each
// row, one 16-byte vector a row; a warp's row is 512 contiguous bytes.
__device__ __forceinline__ void load_slab(uint32_t (&x)[RR][PER],
                                          const uint32_t* init, int tid) {
  const uint4* src = reinterpret_cast<const uint4*>(init) +
                     (tid >> 5) * (RR * LANES / 4) + (tid & 31);
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const uint4 v = src[r * (LANES / 4)];
    x[r][0] = v.x;
    x[r][1] = v.y;
    x[r][2] = v.z;
    x[r][3] = v.w;
  }
}

__device__ __forceinline__ void store_slab(uint32_t* out,
                                           const uint32_t (&x)[RR][PER],
                                           int tid) {
  uint4* dst = reinterpret_cast<uint4*>(out) + (tid >> 5) * (RR * LANES / 4) +
               (tid & 31);
#pragma unroll
  for (int r = 0; r < RR; ++r)
    dst[r * (LANES / 4)] = make_uint4(x[r][0], x[r][1], x[r][2], x[r][3]);
}

// One vec_body over this warp's slab, in place; `left` is lane - 1 mod 32.
__device__ __forceinline__ void vec_body(uint32_t (&x)[RR][PER], int left) {
  uint32_t last[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) last[j] = x[RR - 1][j];
#pragma unroll
  for (int r = RR - 1; r >= 0; --r) {
    const uint32_t w = __shfl_sync(FULL, x[r][PER - 1], left);
#pragma unroll
    for (int j = PER - 1; j >= 0; --j) {
      const uint32_t a = j ? x[r][j - 1] : w;
      const uint32_t b = r ? x[r - 1][j] : last[j];
      x[r][j] = ((x[r][j] ^ a) | (x[r][j] & b)) + 1u;
    }
  }
}

// nv bodies on this warp's slab, from init to out; all VEC_THREADS slab
// threads call it.  Two slab warps share each SM sub-partition's INT32
// lanes (the LOP3s) and FMA lanes (the adds), and the loop's steady speed
// depends on how their two instruction streams interleave.  So V, F and Q
// run this one compiled copy of the loop (not inlined: ptxas would schedule
// each kernel's copy differently), and the slab warps start it together
// (without the barrier the interleaving, and the time, changed from launch
// to launch).
__device__ __noinline__ void vec_loop(const uint32_t* init, uint32_t* out,
                                      int nv, int tid) {
  uint32_t x[RR][PER];
  load_slab(x, init, tid);
  const int left = (tid + 31) & 31;
  asm volatile("bar.sync 1, %0;" ::"n"(VEC_THREADS) : "memory");
#pragma unroll 1
  for (int i = 0; i < nv; ++i) vec_body(x, left);
  store_slab(out, x, tid);
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

__global__ void __launch_bounds__(VEC_THREADS, 1)
coissue_v_kernel(const uint32_t* init, uint32_t* out, int nv) {
  vec_loop(init, out, nv, threadIdx.x);
}

__global__ void coissue_s_kernel(const uint32_t* seed, uint32_t* out,
                                 long long steps) {
  extern __shared__ uint32_t smem[];
  load_table(smem, seed, threadIdx.x, blockDim.x);
  __syncthreads();
  if (threadIdx.x == 0) out[0] = scal_steps(smem, steps);
}

__global__ void __launch_bounds__(VEC_THREADS + 32, 1)
coissue_f_kernel(const uint32_t* seed, const uint32_t* init, uint32_t* out,
                 uint32_t* out2, int nv, long long steps) {
  __shared__ uint32_t tab[2 * SCH];
  const int tid = threadIdx.x;
  if (tid < VEC_THREADS) {
    vec_loop(init, out, nv, tid);
  } else {  // the scalar warp: no barrier of the slab warps
    load_table(tab, seed, tid - VEC_THREADS, 32);
    __syncwarp();
    if (tid == VEC_THREADS) out2[0] = scal_steps(tab, steps);
  }
}

__global__ void __launch_bounds__(VEC_THREADS, 1)
coissue_q_kernel(const uint32_t* seed, const uint32_t* init, uint32_t* out,
                 uint32_t* out2, int nv, long long steps) {
  __shared__ uint32_t tab[2 * SCH];
  const int tid = threadIdx.x;
  load_table(tab, seed, tid, VEC_THREADS);
  vec_loop(init, out, nv, tid);
  __syncthreads();  // every body done (and the table loaded) before the chain
  if (tid == 0) out2[0] = scal_steps(tab, steps);
}

}  // namespace

// init: (8, 32, 128) int32; out: the whole slab after nv steps.
extern "C" int lz77_coissue_v(const void* init, void* out, int nv,
                              void* stream) {
  coissue_v_kernel<<<1, VEC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)init, (uint32_t*)out, nv);
  return (int)cudaGetLastError();
}

// seed: (2048,) int32; out: one int32, t + p after `steps` steps.
extern "C" int lz77_coissue_s(const void* seed, void* out, long long steps,
                              void* stream) {
  coissue_s_kernel<<<1, 32, 2 * SCH * sizeof(uint32_t),
                     (cudaStream_t)stream>>>((const uint32_t*)seed,
                                             (uint32_t*)out, steps);
  return (int)cudaGetLastError();
}

// out: the whole slab after nv steps; out2: t + p after `steps` (nv * k).
extern "C" int lz77_coissue_f(const void* seed, const void* init, void* out,
                              void* out2, int nv, long long steps,
                              void* stream) {
  coissue_f_kernel<<<1, VEC_THREADS + 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)seed, (const uint32_t*)init, (uint32_t*)out,
      (uint32_t*)out2, nv, steps);
  return (int)cudaGetLastError();
}

extern "C" int lz77_coissue_q(const void* seed, const void* init, void* out,
                              void* out2, int nv, long long steps,
                              void* stream) {
  coissue_q_kernel<<<1, VEC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)seed, (const uint32_t*)init, (uint32_t*)out,
      (uint32_t*)out2, nv, steps);
  return (int)cudaGetLastError();
}
