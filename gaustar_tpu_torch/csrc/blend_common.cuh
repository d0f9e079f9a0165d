// What csrc/blend_fwd.cu and csrc/blend_bwd.cu share: the blend's constants,
// its per-(pixel, pair) power and alpha, the work list of (tile, segment)
// items, and the layout of the forward's test bits.
//
// The work list. Each tile's depth-ordered pair list is cut into segments of
// SEG consecutive pairs, and a work item is one (tile, segment). The caller
// passes `ends` [3, n_tiles] int32 (ops/blend_cuda.py:split_plan): over the
// tiles, the inclusive cumsums of each tile's segments, of its bit words
// (WORD pairs each) and of its recorded chain states (segments - 1). Item i
// is in the first tile whose segment end exceeds i (a binary search). Tile
// t's bit words start at ends[1][t] - words(count) and its states at
// ends[2][t] - (segments(count) - 1).
//
// The test bits, bits[word][pixel] (word-major, so that a warp's 32 pixels
// store one 128-byte line): bit b of the tile's word w is set iff its pair
// w * WORD + b passes, at the pixel, the part of the blend's test that does
// not depend on T: power <= 0 and min(0.99, op e^power) >= 1/255. The
// kernels that re-read a set bit recompute power and alpha through the same
// functions as the test, so they see the same values.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace blend {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int ROWS = 8;
constexpr int NWARP = PIX / 32;
// Pairs per work item. 256 makes staging a segment one pair per thread of a
// 256-thread block (one coalesced copy per field row, (6 + C) x 1 KB of
// shared memory) and 8 bit words per pixel. At full width (975k pairs over
// 808 busy tiles) that is about 4,600 items, and the longest tile (16k
// pairs) becomes 63 of them. Shorter segments would record more chain
// states (2 + 2C floats per pixel per segment) and cost a barrier per few
// pairs in the serial walks; longer ones would lengthen the walk of each
// gradient block and make each barrier wait longer for the slowest warp.
constexpr int SEG = 256;
constexpr int WORD = 32;
constexpr int SEG_WORDS = SEG / WORD;
// Set bits of one word a pixel of a serial walk (the forward chain, the
// backward scan) takes per step: their loads and alphas are independent, so
// the step overlaps their latencies, and only the short T chain is serial.
// (On the H100 4 beat 1 and 8.)
constexpr int GROUP = 4;
// Threads (pixels) per block of the serial walks: a tile's 256 pixels go to
// PIX / SERIAL blocks, so that each barrier per segment waits for the
// slower of 2 warps, not the slowest of 8. (32 sped up the longest tile but
// slowed the whole camera at high opacity, with twice the blocks.)
constexpr int SERIAL = 64;
constexpr int SERIAL_BLOCKS = PIX / SERIAL;
// float32 roundings of the double constants, as PyTorch compares a float32
// tensor with a Python float.
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;
constexpr float T_STOP = (float)1e-4;

__device__ __forceinline__ int segments(int count) { return (count + SEG - 1) / SEG; }
__device__ __forceinline__ int words(int count) { return (count + WORD - 1) / WORD; }
__device__ __forceinline__ int state_row(int ch) { return ch < 3 ? ch : 6; }

// The Gaussian's exponent at the pixel (dx, dy out): one expression for
// every kernel, so that every kernel rounds it alike.
__device__ __forceinline__ float pair_power(float x, float y, float A, float B, float C, float px,
                                            float py, float& dx, float& dy) {
  dx = x - px;
  dy = y - py;
  return -0.5f * (A * dx * dx + C * dy * dy) - B * dx * dy;
}

__device__ __forceinline__ float pair_alpha(float op, float G) { return fminf(op * G, ALPHA_MAX); }

// 4-byte asynchronous copies from device to shared memory (cp.async): the
// next segment is staged while the current one is walked.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// The tile of work item `item`: the first tile whose inclusive segment end
// exceeds it, or n_tiles past the last item.
__device__ __forceinline__ int item_tile(const int* __restrict__ seg_end, int n_tiles, int item) {
  int lo = 0, hi = n_tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_end[mid] > item) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

}  // namespace blend
