// K1 at the wide windows: the same (L, O) as match.cu's distance sweep,
// found by walking the earlier positions whose 4-gram is equal, nearest
// first.
//
// Same contract as ops/match.py::match_sweep for an unranged call: per
// position p, the longest run within min(dlim, p + avail) distances, capped
// at min(depth, valid_ext - p - 1), and the nearest distance on ties.  The
// sweep pays dlim / 4 word steps a position whatever the data; here a
// position pays one hop for each earlier position that can still beat its
// best run.  ops/match.py::match_chain_plain follows every step below.
//
// Pre-pass.  Each input block's span, halo | block | right extension (N =
// dlim + B + depth bytes, span index t = dlim + block coordinate), gets
// four tables Dk (k = 1..4, uint16): the distance to the nearest earlier
// span index with the same k-gram, 0 where there is none within 65,535
// (any distance the walk may take is at most dlim <= 65,535).  The span's
// 4-grams are packed into one word a position (bytes past the span read
// 0); four stable LSD counting-sort passes over the positions take the
// gram's byte 0, 1, 2, 3 as their digit, so after pass j equal (j+1)-grams
// are neighbours in position order and D(j+1) is each one's distance to
// the neighbour before it.  A pass is three launches: a tile's digit
// histogram, one block a span that scans the histograms digit-major, and a
// stable scatter (within a warp __match_any_sync ranks equal digits, the
// warps' counts in shared memory rank them across the tile).
//
// Walk.  A thread block takes a tile of WALK_TILE positions and stages
// it, its window and its lookahead in shared memory as match.cu stages
// them (byte i holds span index t0 + i).  Its threads take the positions
// from a queue in shared memory, a lane the next one as soon as its own
// ends, so a warp's lanes stay busy however unequal their walks (with one
// position a thread, a warp ran 2.4-7x its mean lane's hops).  A position
// first takes its short run: the largest k <= min(cap, 3) whose Dk lies
// within the limit, at that distance.  Where cap >= 4 and D4 lies within
// it, the walk follows D4's links from the position's own 4-gram, nearest
// first; a candidate measures its run (run_length) only if it matches
// byte `best`, and replaces the best with a strictly longer run, so the
// nearest of the longest wins.  Once the best is b >= 4 from candidate q,
// every distance that can still win matches bytes 0 .. b, so it lies on
// the chain of every node q + j, j <= b - 4: the walk goes on along the
// sparsest of four such chains (sparsest_chain), a candidate being
// node - j.  It stops at the cap, at a link beyond the limit, or at the
// end of the chain.  A position that would take a hop more than `budget`
// leaves its best run and the distance it reached to a second launch
// (rest), which sweeps such positions a thread each with
// match_common.cuh's word sweep from that distance, seeded with the best
// run: no position costs more than its budget and the sweep, and a tile
// whose positions all pass the budget is swept by as many threads as the
// sweep kernel gives it (a lane stalled its warp for the sweep, and a
// block's threads sweeping its tile's positions in turn took 4-7x the
// sweep kernel's time on whole files).  Positions walked, hops and budget
// fallbacks are summed a thread block and added once a block to three
// device counters.
//
// Every kernel of the route is named match_kernel, in a namespace a stage,
// so a trace reads the pre-pass as a part of the match layer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "match_common.cuh"

namespace {

// The walk: a thread block's threads take the WALK_TILE positions of its
// tile from a queue in shared memory (16 a thread on average), so a lane
// whose position ends takes the next and a warp's lanes stay busy however
// unequal their chains are.
constexpr int WALK_THREADS = 256;
constexpr int WALK_TILE = 4096;
constexpr int THREADS = 256;       // the pre-pass's thread blocks
constexpr int DIGITS = 256;        // a pass's digit: one byte of the gram
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int NO_LINK = 65535;     // Dk's largest distance

// Byte t of the span (halo | block | right extension), 0 past it.
__device__ __forceinline__ uint32_t span_byte(
    const uint8_t* __restrict__ blk, const uint8_t* __restrict__ hal,
    const uint8_t* __restrict__ rgt, int t, int B, int dlim, int depth) {
  if (t < dlim) return hal[t];
  if (t < dlim + B) return blk[t - dlim];
  if (t < dlim + B + depth) return rgt[t - dlim - B];
  return 0;
}

namespace grams {
// gram[g][t]: span bytes t .. t+3, byte t lowest.
__global__ void __launch_bounds__(THREADS) match_kernel(
    const uint8_t* __restrict__ blocks, const uint8_t* __restrict__ halos,
    const uint8_t* __restrict__ rights, uint32_t* __restrict__ gram, int B,
    int dlim, int depth, int N) {
  const int g = blockIdx.y;
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= N) return;
  const uint8_t* blk = blocks + (size_t)g * B;
  const uint8_t* hal = halos + (size_t)g * dlim;
  const uint8_t* rgt = rights + (size_t)g * depth;
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w |= span_byte(blk, hal, rgt, t + j, B, dlim, depth) << (8 * j);
  gram[(size_t)g * N + t] = w;
}
}  // namespace grams

// The element at sorted index i of span g before a pass: perm_in's, or i
// itself before the first pass.
__device__ __forceinline__ int element(const int32_t* __restrict__ perm_in,
                                       size_t base, int i) {
  return perm_in ? perm_in[base + i] : i;
}

namespace hist {
// hist[g][digit][tile]: how many of the tile's elements have that digit.
__global__ void __launch_bounds__(THREADS) match_kernel(
    const uint32_t* __restrict__ gram, const int32_t* __restrict__ perm_in,
    int32_t* __restrict__ hist, int N, int ntiles, int sort_tile,
    int shift) {
  __shared__ int cnt[DIGITS];
  const int g = blockIdx.y, tile = blockIdx.x;
  const size_t base = (size_t)g * N;
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int end = min(N, (tile + 1) * sort_tile);
  for (int i = tile * sort_tile + threadIdx.x; i < end; i += THREADS) {
    const int t = element(perm_in, base, i);
    atomicAdd(&cnt[(gram[base + t] >> shift) & 0xFF], 1);
  }
  __syncthreads();
  hist[((size_t)g * DIGITS + threadIdx.x) * ntiles + tile] = cnt[threadIdx.x];
}
}  // namespace hist

namespace scan {
// Exclusive prefix sum of span g's n = DIGITS * ntiles counts, in place:
// each (digit, tile)'s first output index.
__global__ void __launch_bounds__(SCAN_THREADS) match_kernel(
    int32_t* __restrict__ hist, int n) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  int32_t* h = hist + (size_t)blockIdx.x * n;
  const int per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += h[i];
  // inclusive scan of the threads' sums: within a warp, then its warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += v;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = inc - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = h[i];
    h[i] = run;
    run += v;
  }
}
}  // namespace scan

namespace scatter {
// The stable counting sort's scatter: the tile's elements in order, 256 a
// round, each to its digit's next output index.
__global__ void __launch_bounds__(THREADS) match_kernel(
    const uint32_t* __restrict__ gram, const int32_t* __restrict__ perm_in,
    int32_t* __restrict__ perm_out, const int32_t* __restrict__ hist, int N,
    int ntiles, int sort_tile, int shift) {
  __shared__ int next[DIGITS];          // the digit's next output index
  __shared__ int wcnt[WARPS][DIGITS];   // this round's count a warp a digit
  const int g = blockIdx.y, tile = blockIdx.x;
  const size_t base = (size_t)g * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  next[threadIdx.x] = hist[((size_t)g * DIGITS + threadIdx.x) * ntiles + tile];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) wcnt[w][threadIdx.x] = 0;
  __syncthreads();
  const int begin = tile * sort_tile, end = min(N, begin + sort_tile);
  for (int r = begin; r < end; r += THREADS) {
    const int i = r + threadIdx.x;
    const bool live = i < end;
    int t = 0, d = DIGITS + lane;  // a lane past the end groups with none
    if (live) {
      t = element(perm_in, base, i);
      d = (gram[base + t] >> shift) & 0xFF;
    }
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d);
    const int rank = __popc(peers & below);
    if (live && rank == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    if (live) {
      int at = next[d] + rank;
      for (int w = 0; w < warp; ++w) at += wcnt[w][d];
      perm_out[base + at] = t;
    }
    __syncthreads();
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sum += wcnt[w][threadIdx.x];
      wcnt[w][threadIdx.x] = 0;
    }
    next[threadIdx.x] += sum;
    __syncthreads();
  }
}
}  // namespace scatter

namespace links {
// Dk[g][t]: t's distance to the element before it in the order sorted by
// the k-gram (`mask` keeps its bytes) if their grams are equal and it is
// at most NO_LINK, else 0.  The sorts are stable, so that element is the
// nearest earlier one with the same gram.
__global__ void __launch_bounds__(THREADS) match_kernel(
    const uint32_t* __restrict__ gram, const int32_t* __restrict__ perm,
    uint16_t* __restrict__ Dk, int N, uint32_t mask) {
  const int g = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N) return;
  const size_t base = (size_t)g * N;
  const int t = perm[base + i];
  int d = 0;
  if (i > 0) {
    const int u = perm[base + i - 1];
    if (((gram[base + t] ^ gram[base + u]) & mask) == 0 && t - u <= NO_LINK)
      d = t - u;
  }
  Dk[base + t] = (uint16_t)d;
}
}  // namespace links

// The chain the walk follows once candidate q (span index) has set the
// best run b >= 4: that of node q + j for the offset j among b - 4,
// 2 (b - 4) / 3, (b - 4) / 3 and 0 whose link is longest (none within
// NO_LINK counts longest; the first of equals).  Every distance that can
// still win matches bytes 0 .. b, so it lies on each of those chains, and
// the sparsest has the fewest hops.  .x = j, .y = that node's link.
template <typename Link>
__device__ __forceinline__ int2 sparsest_chain(Link link, int q, int b) {
  const int m = b - 4;
  const int js[4] = {m, 2 * m / 3, m / 3, 0};
  int2 r = make_int2(m, link(q + m));
  int score = r.y ? r.y : NO_LINK + 1;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const int d = link(q + js[i]);
    const int sc = d ? d : NO_LINK + 1;
    if (sc > score) {
      score = sc;
      r = make_int2(js[i], d);
    }
  }
  return r;
}

namespace walk {
// A lane at the hop budget leaves its best run in L, O, the distance it
// stopped at in rest[] and its position in later[] (the tile's own stretch
// of each, global scratch); the tile's count goes to n_rest[] for rest's
// sweeps.
__global__ void __launch_bounds__(WALK_THREADS) match_kernel(
    const uint8_t* __restrict__ blocks,     // (G, B)
    const uint8_t* __restrict__ halos,      // (G, dlim), tail-aligned
    const uint8_t* __restrict__ rights,     // (G, depth)
    const int32_t* __restrict__ avails,     // (G,)
    const int32_t* __restrict__ valid_exts, // (G,)
    const uint16_t* __restrict__ D,         // (4, G, N)
    int32_t* __restrict__ L,                // (G, B)
    int32_t* __restrict__ O,                // (G, B)
    int32_t* __restrict__ rest,             // (G, N) scratch
    int32_t* __restrict__ later,            // (G, N) scratch
    int32_t* __restrict__ n_rest,           // (G, tiles) scratch
    unsigned long long* __restrict__ counters,  // 3, or null
    int G, int B, int dlim, int depth, int budget) {
  constexpr int T = WALK_THREADS, TN = WALK_TILE;
  extern __shared__ uint32_t sw[];
  __shared__ int queue, n_later;
  __shared__ int sums[T / 32][3];
  const uint8_t* s = reinterpret_cast<const uint8_t*>(sw);
  const int g = blockIdx.y;
  const int t0 = blockIdx.x * TN;
  const int N = dlim + B + depth;
  const size_t table = (size_t)G * N;
  const uint16_t* Dg = D + (size_t)g * N;
  const uint16_t* D4 = Dg + 3 * table;
  int32_t* Lg = L + (size_t)g * B + t0;
  int32_t* Og = O + (size_t)g * B + t0;
  int32_t* rst = rest + (size_t)g * N + t0;
  int32_t* lst = later + (size_t)g * N + t0;
  // byte i of sw holds span index t0 + i (block coordinate t0 - dlim + i)
  lz77::stage_window(reinterpret_cast<uint8_t*>(sw), blocks + (size_t)g * B,
                     halos + (size_t)g * dlim, rights + (size_t)g * depth, t0,
                     TN, B, dlim, depth, T);
  if (threadIdx.x == 0) {
    queue = T;
    n_later = 0;
  }
  __syncthreads();
  auto link = [&](int t) -> int { return __ldg(D4 + t); };

  const int end = min(TN, B - t0);
  const int avail = avails[g], vext = valid_exts[g];
  int walked = 0, hops = 0, fell = 0;
  int q = threadIdx.x;  // the lane's position, tile-local
  bool fresh = true;
  int P = 0, xi = 0, cap = 0, lim = 0, best = 0, bo = 0;
  int node = 0, off = 0, dl = 0, n = 0;
  uint32_t X[lz77::XREG];  // the position's first bytes
  while (q < end) {
    bool done = true;
    if (fresh) {
      // a new position: its short run, then the walk if D4 lies in reach
      const int p = t0 + q;
      cap = min(depth, vext - p - 1);
      lim = min(dlim, p + avail);
      P = dlim + p;
      xi = dlim + q;
      best = bo = n = 0;
      if (cap > 0 && lim > 0) {
        // an equal k-gram is an equal (k-1)-gram, nearer or as near
        for (int k = 1; k <= 3 && k <= cap; ++k) {
          const int d = Dg[(k - 1) * table + P];
          if (d == 0 || d > lim) break;
          best = k;
          bo = d;
        }
        if (cap >= 4) {
          dl = link(P);
          if (dl != 0 && dl <= lim) {
            ++walked;
#pragma unroll
            for (int k = 0; k < lz77::XREG; ++k)
              X[k] = 4 * k < cap ? lz77::load4(sw, xi + 4 * k) : 0u;
            node = P;
            off = 0;
            done = fresh = false;
          }
        }
      }
    } else {
      // one hop: node's link, its candidate node - off
      const int nnode = node - dl;
      const int dist = P - nnode + off;
      if (dist <= lim) {
        if (n == budget) {
          ++fell;
          rst[q] = dist;
          lst[atomicAdd(&n_later, 1)] = q;
        } else {
          ++n;
          node = nnode;
          int nd = link(node);  // the next link, read ahead
          if (s[xi - dist + best] == s[xi + best]) {
            const int run = lz77::run_length(sw, X, xi, xi - dist, cap);
            if (run > best) {
              best = run;
              bo = dist;
              nd = 0;
              if (best < cap) {
                const int2 c = sparsest_chain(link, P - dist, best);
                off = c.x;
                node = P - dist + off;
                nd = c.y;
              }
            }
          }
          dl = nd;
          done = nd == 0;
        }
      }
    }
    if (done) {
      hops += n;
      Lg[q] = best;
      Og[q] = bo;
      q = atomicAdd(&queue, 1);
      fresh = true;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) n_rest[g * gridDim.x + blockIdx.x] = n_later;
  if (!counters) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  walked = __reduce_add_sync(0xFFFFFFFFu, walked);
  hops = __reduce_add_sync(0xFFFFFFFFu, hops);
  fell = __reduce_add_sync(0xFFFFFFFFu, fell);
  if (lane == 0) {
    sums[warp][0] = walked;
    sums[warp][1] = hops;
    sums[warp][2] = fell;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long tot = 0;
    for (int w = 0; w < T / 32; ++w) tot += sums[w][threadIdx.x];
    if (tot) atomicAdd(counters + threadIdx.x, tot);
  }
}
}  // namespace walk

namespace rest {
// The sweeps of the positions walk left at the budget: a thread a
// position, a thread block a tile's WALK_THREADS of them (blockIdx.z-th),
// its window staged as walk stages it; each sweeps from the distance its
// walk reached, seeded with its best run, its second filter on a byte
// that differs from its first (sweep_steps' `distinct`: positions left
// at the budget are mostly in runs of one byte value).  Spread so, a tile whose every
// position passed the budget takes the sweep's time, not 16 times it.
__global__ void __launch_bounds__(WALK_THREADS) match_kernel(
    const uint8_t* __restrict__ blocks, const uint8_t* __restrict__ halos,
    const uint8_t* __restrict__ rights, const int32_t* __restrict__ avails,
    const int32_t* __restrict__ valid_exts, int32_t* __restrict__ L,
    int32_t* __restrict__ O, const int32_t* __restrict__ rest,
    const int32_t* __restrict__ later, const int32_t* __restrict__ n_rest,
    int B, int dlim, int depth) {
  extern __shared__ uint32_t sw[];
  const int g = blockIdx.y;
  const int t0 = blockIdx.x * WALK_TILE;
  const int first = blockIdx.z * WALK_THREADS;
  const int count = n_rest[g * gridDim.x + blockIdx.x];
  if (first >= count) return;
  const int N = dlim + B + depth;
  lz77::stage_window(reinterpret_cast<uint8_t*>(sw), blocks + (size_t)g * B,
                     halos + (size_t)g * dlim, rights + (size_t)g * depth, t0,
                     WALK_TILE, B, dlim, depth, WALK_THREADS);
  __syncthreads();
  const int i = first + threadIdx.x;
  if (i >= count) return;
  const int q = later[(size_t)g * N + t0 + i], p = t0 + q;
  const size_t at = (size_t)g * B + p;
  const int2 r = lz77::sweep_range(
      sw, dlim + q, min(depth, valid_exts[g] - p - 1),
      rest[(size_t)g * N + p], min(dlim, p + avails[g]), L[at], O[at],
      true);
  L[at] = r.x;
  O[at] = r.y;
}
}  // namespace rest

}  // namespace

// K1's wide-window route.  Scratch from the caller: gram and perm_a,
// perm_b (G, N) 32-bit (the permutations serve the walk afterwards), hist
// (G, 256, ceil(N / sort_tile)) int32, D (4, G, N) uint16, N = dlim + B +
// depth < 2^31; sort_tile a positive multiple of 256; counters: 3 uint64
// (positions walked, hops, fallbacks) added to, or null; budget >= 0 hops
// a position.
extern "C" int lz77_match_chain(
    const void* blocks, const void* halos, const void* rights,
    const void* avails, const void* valid_exts, void* L, void* O,
    void* gram, void* perm_a, void* perm_b, void* hist, void* D,
    void* counters, int G, int B, int dlim, int depth, int budget,
    int sort_tile, void* stream_) {
  if (G <= 0 || B <= 0) return 0;
  if (dlim < 1 || dlim > NO_LINK || depth < 1 || budget < 0 ||
      sort_tile < THREADS || sort_tile % THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const int N = dlim + B + depth;
  const int ntiles = (N + sort_tile - 1) / sort_tile;
  const dim3 each((N + THREADS - 1) / THREADS, G), tiles(ntiles, G);
  uint32_t* gw = (uint32_t*)gram;
  uint16_t* Dt = (uint16_t*)D;
  grams::match_kernel<<<each, THREADS, 0, stream>>>(
      (const uint8_t*)blocks, (const uint8_t*)halos, (const uint8_t*)rights,
      gw, B, dlim, depth, N);
  const int32_t* in = nullptr;
  int32_t* out = (int32_t*)perm_a;
  for (int j = 0; j < 4; ++j) {
    hist::match_kernel<<<tiles, THREADS, 0, stream>>>(
        gw, in, (int32_t*)hist, N, ntiles, sort_tile, 8 * j);
    scan::match_kernel<<<G, SCAN_THREADS, 0, stream>>>((int32_t*)hist,
                                                       DIGITS * ntiles);
    scatter::match_kernel<<<tiles, THREADS, 0, stream>>>(
        gw, in, out, (const int32_t*)hist, N, ntiles, sort_tile, 8 * j);
    const uint32_t mask = j == 3 ? 0xFFFFFFFFu : (1u << (8 * (j + 1))) - 1u;
    links::match_kernel<<<each, THREADS, 0, stream>>>(
        gw, out, Dt + (size_t)j * G * N, N, mask);
    in = out;
    out = out == (int32_t*)perm_a ? (int32_t*)perm_b : (int32_t*)perm_a;
  }
  const size_t smem = lz77::staged_bytes(dlim, WALK_TILE, depth);
  if (smem > 48 * 1024) {
    for (const void* k : {(const void*)walk::match_kernel,
                          (const void*)rest::match_kernel}) {
      cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  // rest[], later[] and n_rest[]: the pre-pass's permutations and
  // histograms, done with
  int32_t* rst = (int32_t*)perm_a;
  int32_t* lst = (int32_t*)perm_b;
  int32_t* cnt = (int32_t*)hist;
  const int wtiles = (B + WALK_TILE - 1) / WALK_TILE;
  walk::match_kernel<<<dim3(wtiles, G), WALK_THREADS, smem, stream>>>(
      (const uint8_t*)blocks, (const uint8_t*)halos, (const uint8_t*)rights,
      (const int32_t*)avails, (const int32_t*)valid_exts, Dt, (int32_t*)L,
      (int32_t*)O, rst, lst, cnt, (unsigned long long*)counters, G, B, dlim,
      depth, budget);
  rest::match_kernel<<<dim3(wtiles, G, WALK_TILE / WALK_THREADS),
                       WALK_THREADS, smem, stream>>>(
      (const uint8_t*)blocks, (const uint8_t*)halos, (const uint8_t*)rights,
      (const int32_t*)avails, (const int32_t*)valid_exts, (int32_t*)L,
      (int32_t*)O, rst, lst, cnt, B, dlim, depth);
  return (int)cudaGetLastError();
}
