// Tile blend backward for NVIDIA Hopper (sm_90a): back-to-front re-walk of
// each tile's included pairs, producing per-pair-slot gradients.
//
// Replaces: gaustar_tpu/ops/blend_pallas.py:_bwd_kernel -> _bwd_tile
//           (pallas_call in _blend_bwd_raw; glue in _raw_bwd_rule).
//
// What bounds it on the H100: as in the forward, not its float rate and not
// its memory but the longest tile. Each pixel carries a chain back to front
// over its included pairs (T recovered as T / (1 - alpha), the colour suffix
// sums), and each pair's gradient is a sum over the tile's 256 pixels. With
// one block per tile walking every position up to the tile's largest
// n_contrib, the tile of 16,000 pairs sets the kernel's time alone, though
// only 3% of the positions it walks are included pairs.
//
// Design: record the chain where a block can pick it up, then spread the
// gradients over many blocks. The T-independent test is not run again: the
// caller passes the forward's test bits (csrc/blend_fwd.cu), which keeping
// for the backward costs 4 bytes per pixel per 32 pairs of memory and saves
// the test kernel's time.
//   A. blend_scan_kernel: for each tile with more than one segment, PIX /
//      SERIAL blocks, one thread per pixel. A pixel walks back to front over
//      its included pairs
//      only (test bit set and position <= n_contrib, the walk's own rule),
//      carrying the chain (T, the last included alpha, and per channel the
//      suffix colour sum and the last colour), and at every segment boundary
//      it records that state: 2 + 2C floats per pixel. Staging, steps and
//      groups as in the forward chain.
//   B. blend_grad_kernel: one block per (tile, segment) work item, all in
//      parallel. It starts from the state recorded at its segment's back
//      end (or the final T and zeros for the tile's last segment), walks its
//      segment back to front and runs the walk's arithmetic for every
//      included (pixel, pair). A warp skips the pairs none of its pixels
//      include; for the rest it sums the 6 + C values over its 32 pixels
//      (shuffles), and the block sums the 8 warp partials in shared memory,
//      32 slots per round, and writes each slot once: no atomics,
//      deterministic gradients, and the autograd boundary stays at
//      pair_data. Items no pixel reaches (past every n_contrib) return.
//      What holds it now: its warps wait at each round's barrier for the
//      block's busiest warp, most of their time, and the same pixel rows
//      stay the busiest from word to word. Fewer barriers (two words per
//      round), a reduce-scatter of 16 shuffles, and sums over only the
//      including pixels in shared memory were each measured no faster.
// The scan and the per-pixel values of B are the same operations in the same
// order as the plain version's walk; only the 256-pixel sums are taken in
// another order. Slots never written keep the zeros the wrapper allocated.
// Tensor cores are not used, as in the forward. Built with -fmad=false.
#include "blend_common.cuh"

namespace blend {
namespace {

// One back-to-front step of the chain over an included pair of opacity
// alpha and colours col: T before the pair, the suffix colour sums, and the
// last included pair. The scan and the gradient kernel both step through it.
// Where `step` is false, nothing changes (a select, not a branch).
template <int CH>
__device__ __forceinline__ void chain_back(bool step, float alpha, const float (&col)[CH], float& T,
                                           float (&acc)[CH], float (&last_c)[CH], float& last_alpha) {
  const float t = T / (1.f - alpha);
  T = step ? t : T;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const float a = last_alpha * last_c[c] + (1.f - last_alpha) * acc[c];
    acc[c] = step ? a : acc[c];
    last_c[c] = step ? col[c] : last_c[c];
  }
  last_alpha = step ? alpha : last_alpha;
}

// The included-pair bits of word w of a segment starting at list position
// `base`, for a pixel with n_contrib nc: bits at positions < nc.
__device__ __forceinline__ unsigned included(const unsigned* word_ptr, int base, int w, int nc) {
  const int rem = nc - (base + w * WORD);
  if (rem <= 0) return 0u;
  const unsigned b = *word_ptr;
  return rem < WORD ? b & ((1u << rem) - 1u) : b;
}

template <int CH>
__global__ void __launch_bounds__(SERIAL) blend_scan_kernel(
    const float* __restrict__ pair_data, long long stride, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const int* __restrict__ ends, int n_tiles, int grid_x,
    int tile_base, const float* __restrict__ fwd, const unsigned* __restrict__ bits, float* __restrict__ states) {
  constexpr int NF = 6 + CH;
  constexpr int NS = 2 + 2 * CH;
  __shared__ float s_pair[2][NF][SEG];
  __shared__ unsigned s_bits[2][SEG_WORDS][SERIAL];

  const int tile = blockIdx.x / SERIAL_BLOCKS;
  const int t = threadIdx.x;
  const int tid = (blockIdx.x % SERIAL_BLOCKS) * SERIAL + t;  // the pixel
  const int count = tile_count[tile];
  const int nseg = segments(count);
  if (nseg <= 1) return;  // no boundary to record
  const float* pairs = pair_data + tile_start[tile];
  const int nword = words(count);
  const unsigned* tb = bits + (size_t)(ends[n_tiles + tile] - nword) * PIX + tid;
  float* st = states + (size_t)(ends[2 * n_tiles + tile] - (nseg - 1)) * NS * PIX + tid;
  const float* f = fwd + (size_t)tile * ROWS * PIX;
  const int nc = (int)f[4 * PIX + tid];
  const int gt = tile + tile_base;  // the tile's place in the image
  const float px = (float)((gt % grid_x) * TILE + tid % TILE);
  const float py = (float)((gt / grid_x) * TILE + tid / TILE);

  float T = f[3 * PIX + tid];
  float acc[CH], last_c[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = last_c[c] = 0.f;
  float last_alpha = 0.f;

  // Segment seg into buffer buf, as the forward chain stages it.
  auto stage = [&](int seg, int buf) {
    for (int i = t; i < SEG && seg * SEG + i < count; i += SERIAL) {
#pragma unroll
      for (int fl = 0; fl < NF; ++fl) cp_async4(&s_pair[buf][fl][i], pairs + fl * stride + seg * SEG + i);
    }
#pragma unroll
    for (int w = 0; w < SEG_WORDS; ++w) {
      const int word = seg * SEG_WORDS + w;
      if (word < nword) cp_async4(&s_bits[buf][w][t], tb + (size_t)word * PIX);
      else s_bits[buf][w][t] = 0u;
    }
    cp_async_commit();
  };
  stage(nseg - 1, (nseg - 1) & 1);

  for (int seg = nseg - 1; seg >= 1; --seg) {
    const int buf = seg & 1;
    cp_async_wait_all();
    __syncthreads();  // the segment is staged and the other buffer's readers are done
    if (seg > 1) stage(seg - 1, buf ^ 1);
#pragma unroll 1
    for (int w = SEG_WORDS - 1; w >= 0; --w) {
      const int rem = nc - (seg * SEG + w * WORD);  // included: positions < n_contrib
      unsigned b = rem <= 0 ? 0u : s_bits[buf][w][t];
      if (rem < WORD) b &= (1u << max(rem, 0)) - 1u;
      // The warp steps through the word together, back to front, a pixel
      // taking up to GROUP included pairs per step, as the forward chain
      // does front to back.
      while (__any_sync(0xffffffffu, b != 0u)) {
        // Straight-line code over the GROUP slots (an empty slot reads pair
        // 0 and is ignored), so that their loads and expf interleave.
        int k[GROUP];
        bool ok[GROUP];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          ok[g] = b != 0u;
          const int j = 31 - __clz(b | 1u);
          b &= ~(1u << j);
          k[g] = ok[g] ? w * WORD + j : 0;
        }
        float alpha[GROUP], col[GROUP][CH];
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const int j = k[g];
          float dx, dy;
          const float power = pair_power(s_pair[buf][0][j], s_pair[buf][1][j], s_pair[buf][2][j],
                                         s_pair[buf][3][j], s_pair[buf][4][j], px, py, dx, dy);
          alpha[g] = pair_alpha(s_pair[buf][5][j], expf(power));
#pragma unroll
          for (int c = 0; c < CH; ++c) col[g][c] = s_pair[buf][6 + c][j];
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) chain_back<CH>(ok[g], alpha[g], col[g], T, acc, last_c, last_alpha);
      }
    }
    // The state at the back end of segment seg - 1.
    float* s = st + (size_t)(seg - 1) * NS * PIX;
    s[0] = T;
    s[PIX] = last_alpha;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      s[(2 + c) * PIX] = acc[c];
      s[(2 + CH + c) * PIX] = last_c[c];
    }
  }
  cp_async_wait_all();
}

template <int CH>
__global__ void __launch_bounds__(PIX) blend_grad_kernel(
    const float* __restrict__ pair_data, long long stride, const int* __restrict__ tile_start,
    const int* __restrict__ tile_count, const int* __restrict__ ends, int n_tiles, int grid_x,
    int tile_base, const float* __restrict__ fwd, const float* __restrict__ dout, const unsigned* __restrict__ bits,
    const float* __restrict__ states, float* __restrict__ grads) {
  constexpr int NF = 6 + CH;
  constexpr int NS = 2 + 2 * CH;
  __shared__ float s_pair[NF][SEG];
  __shared__ float s_red[NWARP][WORD][NF];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = item_tile(ends, n_tiles, blockIdx.x);
  if (tile >= n_tiles) return;
  const int count = tile_count[tile];
  const int nseg = segments(count);
  const int seg = blockIdx.x - (ends[tile] - nseg);
  const int base = seg * SEG;
  const float* f = fwd + (size_t)tile * ROWS * PIX;
  const int nc = (int)f[4 * PIX + tid];
  if (!__syncthreads_or(nc > base)) return;  // no pixel includes a pair of this segment

  const int n = min(SEG, count - base);
  const long long start = tile_start[tile] + (long long)base;
  if (tid < n) {
#pragma unroll
    for (int fl = 0; fl < NF; ++fl) s_pair[fl][tid] = pair_data[fl * stride + start + tid];
  }
  const float* g = dout + (size_t)tile * ROWS * PIX;
  const float t_final = f[3 * PIX + tid];
  const float d_t = g[3 * PIX + tid];
  float d_c[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) d_c[c] = g[state_row(c) * PIX + tid];
  const int gt = tile + tile_base;  // the tile's place in the image
  const float px = (float)((gt % grid_x) * TILE + tid % TILE);
  const float py = (float)((gt / grid_x) * TILE + tid / TILE);

  float T, last_alpha;
  float acc[CH], last_c[CH];
  if (seg == nseg - 1) {
    T = t_final;
    last_alpha = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c] = last_c[c] = 0.f;
  } else {
    const float* s = states + ((size_t)(ends[2 * n_tiles + tile] - (nseg - 1)) + seg) * NS * PIX + tid;
    T = s[0];
    last_alpha = s[PIX];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      acc[c] = s[(2 + c) * PIX];
      last_c[c] = s[(2 + CH + c) * PIX];
    }
  }
  const unsigned* tb = bits + ((size_t)(ends[n_tiles + tile] - words(count)) + seg * SEG_WORDS) * PIX + tid;

  for (int w = (n - 1) / WORD; w >= 0; --w) {
    const unsigned mine = included(tb + (size_t)w * PIX, base, w, nc);
    // Barrier: the segment is staged and the previous round's readers of
    // s_red are done; a round no pixel includes leaves its zeros.
    if (!__syncthreads_or(mine != 0u)) continue;
    const unsigned warp_bits = __reduce_or_sync(0xffffffffu, mine);
    if (!((warp_bits >> lane) & 1u)) {
#pragma unroll
      for (int fl = 0; fl < NF; ++fl) s_red[warp][lane][fl] = 0.f;
    }
    for (unsigned wb = warp_bits; wb;) {
      const int j = 31 - __clz(wb);
      wb ^= 1u << j;
      const int k = w * WORD + j;
      // Straight-line code: a pixel that does not include the position
      // keeps its chain (selects) and gives zeros.
      const bool inc = (mine >> j) & 1u;
      float dx, dy;
      const float A = s_pair[2][k], B = s_pair[3][k], C = s_pair[4][k];
      const float op = s_pair[5][k];
      const float power = pair_power(s_pair[0][k], s_pair[1][k], A, B, C, px, py, dx, dy);
      const float G = expf(power);
      const float alpha = pair_alpha(op, G);
      float col[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) col[c] = s_pair[6 + c][k];
      chain_back<CH>(inc, alpha, col, T, acc, last_c, last_alpha);
      const float wgt = alpha * T;
      float dl_da = 0.f;
      float gv[NF];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        dl_da = dl_da + (col[c] - acc[c]) * d_c[c];
        gv[6 + c] = inc ? wgt * d_c[c] : 0.f;
      }
      dl_da = dl_da * T;
      dl_da = dl_da + (-t_final / (1.f - alpha)) * d_t;
      const float q = G * dl_da;
      gv[0] = inc ? -op * q * (A * dx + B * dy) : 0.f;
      gv[1] = inc ? -op * q * (C * dy + B * dx) : 0.f;
      gv[2] = inc ? -0.5f * op * q * dx * dx : 0.f;
      gv[3] = inc ? -op * q * dx * dy : 0.f;
      gv[4] = inc ? -0.5f * op * q * dy * dy : 0.f;
      gv[5] = inc ? q : 0.f;
#pragma unroll
      for (int fl = 0; fl < NF; ++fl) {
        float v = gv[fl];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) s_red[warp][j][fl] = v;
      }
    }
    __syncthreads();
    for (int e = tid; e < WORD * NF; e += PIX) {
      const int j = e / NF;
      const int fl = e - j * NF;
      if (w * WORD + j < n) {
        float s = 0.f;
#pragma unroll
        for (int v = 0; v < NWARP; ++v) s += s_red[v][j][fl];
        grads[fl * stride + start + w * WORD + j] = s;
      }
    }
  }
}

template <int CH>
int launch(const float* pair_data, long long stride, const int* tile_start, const int* tile_count,
           const int* ends, int n_tiles, int n_items, int grid_x, int tile_base, const float* fwd,
           const float* dout, const unsigned* bits, float* states, float* grads, cudaStream_t s) {
  blend_scan_kernel<CH><<<n_tiles * SERIAL_BLOCKS, SERIAL, 0, s>>>(pair_data, stride, tile_start, tile_count, ends, n_tiles,
                                                grid_x, tile_base, fwd, bits, states);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_items > 0) {
    blend_grad_kernel<CH><<<n_items, PIX, 0, s>>>(pair_data, stride, tile_start, tile_count, ends, n_tiles,
                                                  grid_x, tile_base, fwd, dout, bits, states, grads);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace blend

// pair_data [F, stride] float32 SoA (F >= 6 + channels); tile_start,
// tile_count [n_tiles] int32, whose lists lie in the stride columns; tile t
// of the call is tile t + tile_base of the image's grid_x-wide grid, as in
// blend_fwd; ends [3, n_tiles] int32 and n_items from split_plan with segments of `seg`
// pairs (must be blend::SEG); fwd (the forward's raw state) and dout (its
// cotangent) [n_tiles, 8, 256] float32; bits [words of split_plan, 256]
// 32-bit words, the test bits that blend_fwd wrote for these inputs; states
// [states of split_plan, 2 + 2 channels, 256] float32 scratch; grads
// [F, stride] float32, zeroed by the caller. Launches on `stream` and
// returns the first launch error (cudaError_t), or 0.
extern "C" int blend_bwd(const float* pair_data, long long stride, const int* tile_start,
                         const int* tile_count, const int* ends, int n_tiles, int n_items, int seg,
                         int grid_x, int tile_base, int channels, const float* fwd, const float* dout,
                         const unsigned* bits, float* states, float* grads, void* stream) {
  if (seg != blend::SEG) return (int)cudaErrorInvalidValue;
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 3)
    return blend::launch<3>(pair_data, stride, tile_start, tile_count, ends, n_tiles, n_items, grid_x,
                            tile_base, fwd, dout, bits, states, grads, s);
  if (channels == 4)
    return blend::launch<4>(pair_data, stride, tile_start, tile_count, ends, n_tiles, n_items, grid_x,
                            tile_base, fwd, dout, bits, states, grads, s);
  return (int)cudaErrorInvalidValue;
}
