// Shared by the match kernels K1 (match.cu), K4 (match_chunk.cu) and K5
// (fused_walk.cu): word-wide reads of a window staged in shared memory, and
// the one-position sweep K1 and K5 both run.
//
// Coordinates.  A thread block stages the bytes of its tile, the d_limit
// bytes before it and the (la-1) bytes after it in a 4-aligned shared array
// (plus SLACK zero bytes, so a word read may run a few bytes past the last
// real one); a sweep over a range of distances that ends below d_limit
// stages only the window it can reach.  A position's own bytes start at byte index xi; with
// a = xi % 4 and w0 = xi / 4, the aligned word w0 - t holds the sources of
// the four distances a + 4t - 3 .. a + 4t (its byte j: distance a + 4t - j).
//
// The sweep (sweep_position) is the serial loop
//     for d = 1 .. dmax:  if run(d) > best: best, best_o = run(d), d;
//                         stop once best == cap
// (distances ascending, strictly longer wins, so the nearest distance wins
// ties) taken a word at a time.  A step reads the aligned word w0 - t, XORs
// it with x[0] repeated four times and ORs in the same test against x[best]
// for the word `best` bytes further on; one zero-byte test then marks the
// distances that pass both filters, the only ones that can beat the best
// run.  The second filter's word is unaligned, but it slides down by exactly
// one aligned word a step: the word read for step t is the upper half of
// step t + 1's funnel shift, so a step costs two shared-memory loads and is
// reloaded only when `best` changes.  The kernels are bound by integer
// instructions, so steps go in groups of GROUP under one test and one
// branch; a group filters with the `best` that was current when it began
// (a smaller `best` passes a superset of the distances that can win, so
// the answer is the serial loop's), and its marks become one mask in
// distance order, so a single loop measures the marked runs nearest first,
// updates the answer after each as the serial loop would and stops at the
// cap.  Edge masks are needed in the first step (distances below 1, or
// below the range's first distance) and the last (beyond dmax) only.

#pragma once

#include <stdint.h>

namespace lz77 {

constexpr int SLACK = 8;  // zero bytes after the staged span
constexpr int XREG = 4;   // words of a position kept in registers

// Four bytes starting at byte index i >= 0 of the 4-aligned shared array,
// little endian; reads the aligned word holding byte i and the next one.
__device__ __forceinline__ uint32_t load4(const uint32_t* sw, int i) {
  return __funnelshift_r(sw[i >> 2], sw[(i >> 2) + 1], (i & 3) * 8);
}

// 0x80 in every byte of the result whose byte of z is zero, 0 elsewhere.
// (__vcmpeq4 gives the same mask but is emulated on Hopper.)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t z) {
  return ~(((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z | 0x7F7F7F7Fu);
}

// Nonzero iff some byte of z is zero (the bits it sets may be wrong above a
// zero byte; zero_bytes gives the exact mask).  One instruction cheaper.
__device__ __forceinline__ uint32_t has_zero_byte(uint32_t z) {
  return (z - 0x01010101u) & ~z & 0x80808080u;
}

// Length of the common prefix of the position's bytes (byte index xi; the
// first 4 * XREG of them are in X) and the bytes at index src, at most cap.
__device__ __forceinline__ int run_length(const uint32_t* sw,
                                          const uint32_t (&X)[XREG], int xi,
                                          int src, int cap) {
#pragma unroll
  for (int q = 0; q < XREG; ++q) {
    if (4 * q < cap) {
      const uint32_t diff = X[q] ^ load4(sw, src + 4 * q);
      if (diff) return min(cap, 4 * q + ((__ffs(diff) - 1) >> 3));
    }
  }
  for (int i = 4 * XREG; i < cap; i += 4) {
    const uint32_t diff = load4(sw, xi + i) ^ load4(sw, src + i);
    if (diff) return min(cap, i + ((__ffs(diff) - 1) >> 3));
  }
  return cap;
}

// Stage the bytes of block coordinates [t0 - win, t0 + tile + depth) of
// input block g (halo | block | right extension, zeros past them) at
// s[0 ..), then SLACK zero bytes; `threads` threads take a byte each in turn.
// win <= dlim is the window a tile needs: dlim, or less for a sweep whose
// distances end below it.
__device__ __forceinline__ void stage_window(
    uint8_t* s, const uint8_t* __restrict__ blk,
    const uint8_t* __restrict__ hal, const uint8_t* __restrict__ rgt, int t0,
    int tile, int B, int dlim, int depth, int threads, int win) {
  const int span = win + tile + depth;
  const int padded = ((span + 3) & ~3) + SLACK;
  for (int i = threadIdx.x; i < padded; i += threads) {
    const int j = t0 - win + i;
    uint8_t v = 0;
    if (i < span) {
      if (j < 0) {
        v = hal[dlim + j];  // j >= -win >= -dlim because t0 >= 0
      } else if (j < B) {
        v = blk[j];
      } else if (j < B + depth) {
        v = rgt[j - B];
      }
    }
    s[i] = v;
  }
}

// The whole window: byte i of s holds block coordinate t0 - dlim + i.
__device__ __forceinline__ void stage_window(
    uint8_t* s, const uint8_t* __restrict__ blk,
    const uint8_t* __restrict__ hal, const uint8_t* __restrict__ rgt, int t0,
    int tile, int B, int dlim, int depth, int threads) {
  stage_window(s, blk, hal, rgt, t0, tile, B, dlim, depth, threads, dlim);
}

// Shared bytes a staged tile takes: the span rounded up to words + SLACK.
__host__ __device__ __forceinline__ int staged_bytes(int dlim, int tile,
                                                     int depth) {
  return ((dlim + tile + depth + 3) & ~3) + SLACK;
}

// Word steps a group takes in sweep_position: the steps of a group are all
// filtered with the `best` of the group's start and tested with one
// branch, and their marks are measured in one loop.
constexpr int GROUP = 8;

// The sweep from word step tf (whose bytes j outside first_mask lie below
// the first distance) to the step that holds dmax: the longest run (at most
// cap >= 1) of the position at byte index xi and the nearest distance that
// gives it: .x = run, .y = distance (0, 0 when nothing matches).  See the
// note at the top; sweep_position and sweep_range below choose tf.
__device__ __forceinline__ int2 sweep_steps(const uint32_t* sw, int xi,
                                            int cap, int tf,
                                            uint32_t first_mask, int dmax) {
  const uint8_t* s = reinterpret_cast<const uint8_t*>(sw);
  const int a = xi & 3, w0 = xi >> 2;
  uint32_t X[XREG];  // the position's first bytes, read once
#pragma unroll
  for (int q = 0; q < XREG; ++q) X[q] = 4 * q < cap ? load4(sw, xi + 4 * q) : 0u;
  // Step t's byte j is distance a + 4t - j.  The last step, tmax, holds
  // distance dmax; its bytes j < lo lie beyond dmax.
  const int tmax = (dmax + 3 - a) >> 2;
  const int lo = a + 4 * tmax - dmax;  // 0..3
  const uint32_t last_mask = 0xFFFFFFFFu << (8 * lo);
  const uint32_t c0s = (X[0] & 0xFFu) * 0x01010101u;  // x[0], four times
  uint32_t cbs = c0s;                                 // x[best], four times
  int best = 0, best_o = 0, bq = 0, bs = 0;  // bq, bs: best / 4, 8 (best % 4)
  uint32_t up = sw[w0 - tf + 1];  // sw[w0 - t + bq + 1] at step t

  // The filter word of step t: a zero byte j, that distance matches x[0]
  // at index 0 and x[best] at index best.
  auto filter = [&](int t) -> uint32_t {
    const uint32_t lw = sw[w0 - t + bq];
    const uint32_t z = (sw[w0 - t] ^ c0s) | (__funnelshift_r(lw, up, bs) ^ cbs);
    up = lw;
    return z;
  };
  // Measure the marked distances a + 4t - 3 + b (bit b of m, nearest
  // first) against the best run; true once it has reached the cap.  Then
  // renew the filter for the step after `last`.
  auto runs = [&](int t, uint32_t m, int last) -> bool {
    if (!m) return false;
    do {
      const int d = a + 4 * t - 4 + __ffs(m);
      m &= m - 1;
      const int run = run_length(sw, X, xi, xi - d, cap);
      if (run > best) {
        best = run;
        best_o = d;
        if (best == cap) return true;
      }
    } while (m);
    cbs = s[xi + best] * 0x01010101u;
    bq = best >> 2;
    bs = 8 * (best & 3);
    up = sw[w0 - last + bq];
    return false;
  };
  // Bit 3 - j of the result for every byte j of u that has its top bit
  // set (u from zero_bytes or has_zero_byte): bit b is distance a + 4t - 3 + b.
  auto nibble = [](uint32_t u) -> uint32_t {
    return __umulhi(u, 0x10080402u) & 0xFu;
  };
  // has_zero_byte's marks: a bit above a zero byte may be set wrongly,
  // which only measures one run more.
  auto marks = [&](uint32_t z) -> uint32_t { return nibble(has_zero_byte(z)); };

  uint32_t m0 = zero_bytes(filter(tf)) & first_mask;
  if (tmax == tf) m0 &= last_mask;
  if (runs(tf, nibble(m0), tf)) return make_int2(best, best_o);
  int t = tf + 1;
  for (; t + GROUP <= tmax; t += GROUP) {
    uint32_t z[GROUP];
    uint32_t h = 0;
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      z[k] = filter(t + k);
      h |= has_zero_byte(z[k]);
    }
    if (h) {  // some distance of the group passed both filters
      uint32_t m = 0;
#pragma unroll
      for (int k = 0; k < GROUP; ++k) m |= marks(z[k]) << (4 * k);
      if (runs(t, m, t + GROUP - 1)) return make_int2(best, best_o);
    }
  }
  for (; t < tmax; ++t) {
    if (runs(t, marks(filter(t)), t)) return make_int2(best, best_o);
  }
  if (tmax > tf) runs(tmax, nibble(zero_bytes(filter(tmax)) & last_mask), tmax);
  return make_int2(best, best_o);
}

// Distances 1 .. dmax (dmax >= 1): step 0's bytes j >= a are distances
// below 1.
__device__ __forceinline__ int2 sweep_position(const uint32_t* sw, int xi,
                                               int cap, int dmax) {
  return sweep_steps(sw, xi, cap, 0, (1u << (8 * (xi & 3))) - 1u, dmax);
}

// Distances dmin .. dmax (dmin >= 1; (0, 0) when dmax < dmin): the first
// step is tf = (dmin + 2 - a) / 4, the last whose bytes are not all at or
// above dmin, and only its k = a + 4 tf - dmin + 1 (0..3) lowest bytes are
// (for dmin = 1 that is step 0 with k = a: sweep_position).
__device__ __forceinline__ int2 sweep_range(const uint32_t* sw, int xi,
                                            int cap, int dmin, int dmax) {
  if (dmax < dmin) return make_int2(0, 0);
  const int a = xi & 3;
  const int tf = (dmin + 2 - a) >> 2;
  const int k = a + 4 * tf - dmin + 1;
  return sweep_steps(sw, xi, cap, tf, (1u << (8 * k)) - 1u, dmax);
}

}  // namespace lz77
