// Tile blend forward for NVIDIA Hopper (sm_90a): front-to-back alpha blending
// of each 16x16 tile's depth-ordered (gaussian, tile) pairs.
//
// Replaces: gaustar_tpu/ops/blend_pallas.py:_fwd_kernel -> _fwd_tile
//           (pallas_call in _blend_fwd_raw).
//
// What bounds it on the H100: not its float rate and not its memory. The
// pairs of a tile are a list as long as 16,000 at full width against a
// median of about 700, and a tile's pixels must be composited in list
// order. A design that gives each tile one block and walks the list pair by
// pair is set by the longest tile alone: one SM walks it while the others
// idle. Yet 98% of the (pixel, pair) evaluations only find that the pair is
// skipped (power > 0 or alpha < 1/255), a test that does not depend on T.
//
// Design: split the independent test from the dependent chain.
//   1. blend_test_kernel: one block per (tile, segment of SEG pairs) work
//      item, all in parallel over the card; each pixel's pass/skip bits for
//      the segment go to a scratch buffer, which the wrapper keeps for the
//      backward (csrc/blend_bwd.cu reads them and runs no test of its own).
//   2. blend_chain_kernel: SERIAL-thread blocks, PIX / SERIAL per tile, one
//      thread per pixel. A pixel walks only its set bits, front to back. For
//      each it recomputes power and alpha with the test's own functions and
//      then does exactly the walk's work: the sticky T (1 - alpha) < 1e-4
//      stop, the colour sums and n_contrib. So every composited pair is the
//      same operations in the same order as in the plain version, and
//      colour, T, n_contrib and the done flag come out equal to it. The
//      block stages each segment's fields and its pixels' bit words in
//      shared memory (cp.async, the next segment while the current one is
//      walked, one barrier per segment) and leaves once its pixels are done.
//      A warp steps through each word together (__any_sync), a pixel taking
//      up to GROUP set bits per step in straight-line code: their power and
//      alpha side by side, then the chain through them.
//      What set this shape, measured on the full-width camera: left to
//      diverge, the pixels' bit loops of a warp ran one after another (2.9
//      ms); stepped together, one set bit per step cost ~500 cycles of
//      dependent latency, and branches around each slot of a group kept the
//      compiler from overlapping them (0.67 ms with them, 0.50 without); a
//      barrier per segment over 8 warps waited for the busiest (0.48 ms,
//      0.29 ms over 2 warps).
// Empty tiles write the constant empty state. Tensor cores are not used: no
// product dominates, the work is one expf and a few compares per (pixel,
// pair), and a matrix-unit channel sum would change colour's rounding.
// Built with -fmad=false so every product and sum rounds as the plain
// PyTorch version's do, which keeps n_contrib exact between the two.
#include "blend_common.cuh"

namespace blend {
namespace {

// A power below which op e^power < 1/255 for certain, so the test can skip
// expf: ln(ALPHA_MIN / op) less a margin (1e-3 in power, 0.1% in e^power)
// far wider than the few-ulp error of logf, expf and the product. op <= 0
// never passes (+inf skips all); a NaN op gives NaN, which skips nothing.
__device__ __forceinline__ float alpha_cut(float op) {
  return op > 0.f ? logf(ALPHA_MIN / op) - 1e-3f : (op <= 0.f ? INFINITY : op);
}

// How far from the pair's centre, in rows, a pixel can pass its test: the
// rows where power >= cut. For the conic M = [[A, B], [B, C]] that is
// |dy| <= sqrt(-2 cut A / det M), widened by 1% and half a row. The float
// power of a pixel further out stays below the cut as long as M is not too
// elongated ((A + C)^2 < 1000 det M keeps its rounding error under 0.04% of
// -2 power); otherwise any row may pass. A cut >= 0 passes no pixel.
__device__ __forceinline__ float row_reach(float A, float B, float C, float cut) {
  if (!(cut < 0.f)) return cut >= 0.f ? -1.f : INFINITY;
  const float det = A * C - B * B;
  if (!(A > 0.f && det > 0.f && (A + C) * (A + C) < 1000.f * det)) return INFINITY;
  return sqrtf(-2.f * cut * A / det) * 1.01f + 0.5f;
}

// The blend's T-independent test, exactly as the plain version's walk
// decides it: skip if power > 0, skip if alpha < 1/255.
__device__ __forceinline__ bool pair_passes(float power, float op, float cut) {
  if (power < cut || power > 0.f) return false;
  return !(pair_alpha(op, expf(power)) < ALPHA_MIN);
}

// Phase 1: one block per work item, one thread per pixel. The block stages
// its segment's six geometric fields (with the expf cut) in shared memory,
// each pixel tests every pair of the segment, and the bits go out one word
// per 32 pairs. Nothing here depends on T, so every item runs in parallel;
// this is where almost all of the blend's evaluations are. A warp (two pixel
// rows) skips the pairs whose row_reach misses its rows, and a pixel skips
// expf below the pair's alpha_cut; neither changes a bit. Pixels outside the
// image get zero bits.
__global__ void __launch_bounds__(PIX) blend_test_kernel(
    const float* __restrict__ pair_data, long long stride, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const int* __restrict__ ends, int n_tiles, int grid_x,
    int tile_base, int width, int height, unsigned* __restrict__ bits) {
  __shared__ float4 s_geo[SEG];  // x, y, conic A, conic B
  __shared__ float4 s_opa[SEG];  // conic C, opacity, alpha_cut, row_reach
  const int tid = threadIdx.x;
  const int tile = item_tile(ends, n_tiles, blockIdx.x);
  if (tile >= n_tiles) return;
  const int count = tile_count[tile];
  const int seg = blockIdx.x - (ends[tile] - segments(count));
  const int n = min(SEG, count - seg * SEG);
  if (tid < n) {
    const float* p = pair_data + tile_start[tile] + (long long)seg * SEG + tid;
    const float A = p[2 * stride], B = p[3 * stride], C = p[4 * stride], op = p[5 * stride];
    const float cut = alpha_cut(op);
    s_geo[tid] = make_float4(p[0], p[stride], A, B);
    s_opa[tid] = make_float4(C, op, cut, row_reach(A, B, C, cut));
  }
  __syncthreads();
  const int gt = tile + tile_base;  // the tile's place in the image
  const int ix = (gt % grid_x) * TILE + tid % TILE;
  const int iy = (gt / grid_x) * TILE + tid / TILE;
  const bool inside = ix < width && iy < height;
  const float px = (float)ix;
  const float py = (float)iy;
  const float warp_row = (float)((gt / grid_x) * TILE + 2 * (tid >> 5));  // a warp is two pixel rows
  unsigned* out = bits + ((size_t)(ends[n_tiles + tile] - words(count)) + seg * SEG_WORDS) * PIX + tid;
  for (int w = 0; w * WORD < n; ++w) {
    unsigned word = 0;
    if (inside) {
      const int m = min(WORD, n - w * WORD);
      for (int b = 0; b < m; ++b) {
        const float4 g = s_geo[w * WORD + b];
        const float4 h = s_opa[w * WORD + b];
        if (warp_row + 1.f < g.y - h.w || warp_row > g.y + h.w) continue;  // the warp's rows are out of reach
        float dx, dy;
        const float power = pair_power(g.x, g.y, g.z, g.w, h.x, px, py, dx, dy);
        if (pair_passes(power, h.y, h.z)) word |= 1u << b;
      }
    }
    out[(size_t)w * PIX] = word;
  }
}

template <int CH>
__global__ void __launch_bounds__(SERIAL) blend_chain_kernel(
    const float* __restrict__ pair_data, long long stride, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const int* __restrict__ ends, int n_tiles, int grid_x,
    int tile_base, int width, int height, const unsigned* __restrict__ bits, float* __restrict__ out) {
  constexpr int NF = 6 + CH;
  __shared__ float s_pair[2][NF][SEG];
  __shared__ unsigned s_bits[2][SEG_WORDS][SERIAL];

  const int tile = blockIdx.x / SERIAL_BLOCKS;
  const int t = threadIdx.x;
  const int tid = (blockIdx.x % SERIAL_BLOCKS) * SERIAL + t;  // the pixel
  const int count = tile_count[tile];
  float* o = out + (size_t)tile * ROWS * PIX;
  if (count == 0) {
    for (int r = 0; r < ROWS; ++r) o[r * PIX + tid] = (r == 3) ? 1.f : 0.f;
    return;
  }
  const float* pairs = pair_data + tile_start[tile];
  const int nseg = segments(count);
  const int nword = words(count);
  const unsigned* tb = bits + (size_t)(ends[n_tiles + tile] - nword) * PIX + tid;
  const int gt = tile + tile_base;
  const int ix = (gt % grid_x) * TILE + tid % TILE;
  const int iy = (gt / grid_x) * TILE + tid / TILE;
  const float px = (float)ix;
  const float py = (float)iy;
  bool done = ix >= width || iy >= height;

  float T = 1.f;
  float col[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) col[c] = 0.f;
  int last = 0;

  // Segment seg into buffer buf: its pairs' fields, and this pixel's bit
  // words.
  auto stage = [&](int seg, int buf) {
    for (int i = t; i < SEG && seg * SEG + i < count; i += SERIAL) {
#pragma unroll
      for (int f = 0; f < NF; ++f) cp_async4(&s_pair[buf][f][i], pairs + f * stride + seg * SEG + i);
    }
#pragma unroll
    for (int w = 0; w < SEG_WORDS; ++w) {
      const int word = seg * SEG_WORDS + w;
      if (word < nword) cp_async4(&s_bits[buf][w][t], tb + (size_t)word * PIX);
      else s_bits[buf][w][t] = 0u;
    }
    cp_async_commit();
  };
  stage(0, 0);

  for (int seg = 0; seg < nseg; ++seg) {
    const int buf = seg & 1;
    cp_async_wait_all();
    // Barrier: the segment is staged and the other buffer's readers are
    // done; and the block's early exit.
    if (__syncthreads_count(done) == SERIAL) break;
    if (seg + 1 < nseg) stage(seg + 1, buf ^ 1);
#pragma unroll 1
    for (int w = 0; w < SEG_WORDS; ++w) {
      unsigned b = done ? 0u : s_bits[buf][w][t];
      // The warp steps through the word together (__any_sync), a pixel
      // taking up to GROUP of its set bits per step: their fields, power and
      // alpha side by side, then the chain through them in list order.
      while (__any_sync(0xffffffffu, b != 0u)) {
        // Straight-line code over the GROUP slots (an empty slot reads pair
        // 0 and is ignored), so that their loads and expf interleave.
        int k[GROUP];
        bool ok[GROUP];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          ok[g] = b != 0u;
          k[g] = ok[g] ? w * WORD + __ffs(b) - 1 : 0;
          b &= b - 1;
        }
        float alpha[GROUP], feat[GROUP][CH];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const int j = k[g];
          float dx, dy;
          const float power = pair_power(s_pair[buf][0][j], s_pair[buf][1][j], s_pair[buf][2][j],
                                         s_pair[buf][3][j], s_pair[buf][4][j], px, py, dx, dy);
          alpha[g] = pair_alpha(s_pair[buf][5][j], expf(power));
#pragma unroll
          for (int c = 0; c < CH; ++c) feat[g][c] = s_pair[buf][6 + c][j];
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const float test_t = T * (1.f - alpha[g]);
          const bool live = ok[g] && !done;
          const bool inc = live && !(test_t < T_STOP);
          done = done || (live && test_t < T_STOP);
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const float sum = col[c] + feat[g][c] * alpha[g] * T;
            col[c] = inc ? sum : col[c];
          }
          T = inc ? test_t : T;
          last = inc ? seg * SEG + k[g] + 1 : last;
        }
        if (done) b = 0u;
      }
    }
  }
  cp_async_wait_all();

  o[0 * PIX + tid] = col[0];
  o[1 * PIX + tid] = col[1];
  o[2 * PIX + tid] = col[2];
  o[3 * PIX + tid] = T;
  o[4 * PIX + tid] = (float)last;
  o[5 * PIX + tid] = done ? 1.f : 0.f;
  o[6 * PIX + tid] = CH == 4 ? col[CH - 1] : 0.f;
  o[7 * PIX + tid] = 0.f;
}

template <int CH>
int launch(const float* pair_data, long long stride, const int* tile_start, const int* tile_count,
           const int* ends, int n_tiles, int n_items, int grid_x, int tile_base, int width, int height,
           unsigned* bits, float* out, cudaStream_t s) {
  if (n_items > 0) {
    blend_test_kernel<<<n_items, PIX, 0, s>>>(pair_data, stride, tile_start, tile_count, ends, n_tiles,
                                              grid_x, tile_base, width, height, bits);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  blend_chain_kernel<CH><<<n_tiles * SERIAL_BLOCKS, SERIAL, 0, s>>>(pair_data, stride, tile_start, tile_count, ends,
                                                 n_tiles, grid_x, tile_base, width, height, bits, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace blend

// pair_data [F, stride] float32 SoA (F >= 6 + channels); tile_start,
// tile_count [n_tiles] int32, whose lists lie in the stride columns; tile t
// of the call is tile t + tile_base of the image's grid_x-wide grid (a strip
// of a larger image blends with its first tile's index); ends
// [3, n_tiles] int32 and n_items, at least the number of work items, from
// split_plan with segments of `seg` pairs (must be blend::SEG); bits, the
// test-bit scratch, [words of split_plan, 256] 32-bit words; out
// [n_tiles, 8, 256] float32. Launches the test and the chain kernels on
// `stream` and returns the first launch error (cudaError_t), or 0.
extern "C" int blend_fwd(const float* pair_data, long long stride, const int* tile_start,
                         const int* tile_count, const int* ends, int n_tiles, int n_items, int seg,
                         int grid_x, int tile_base, int width, int height, int channels, unsigned* bits,
                         float* out, void* stream) {
  if (seg != blend::SEG) return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 3)
    return blend::launch<3>(pair_data, stride, tile_start, tile_count, ends, n_tiles, n_items, grid_x,
                            tile_base, width, height, bits, out, s);
  if (channels == 4)
    return blend::launch<4>(pair_data, stride, tile_start, tile_count, ends, n_tiles, n_items, grid_x,
                            tile_base, width, height, bits, out, s);
  return (int)cudaErrorInvalidValue;
}
