// Tile blend backward for NVIDIA Hopper (sm_90a): back-to-front re-walk of
// each tile's included pairs, producing per-pair-slot gradients.
//
// Replaces: gaustar_tpu/ops/blend_pallas.py:_bwd_kernel -> _bwd_tile
//           (pallas_call in _blend_bwd_raw; glue in _raw_bwd_rule).
//
// What bounds it on the H100: like the forward, a per-pixel sequential chain
// (one expf, one division and ~40 float operations per included pair) plus,
// per pair, a reduction of 6 + C values over the tile's 256 pixels. Its work
// is set by the busiest tiles; device memory moves little (pair data read
// once, two 8 x 256 states read once, each gradient slot written once).
//
// Design: the reference's backward.cu:400-557 form. One 256-thread block per
// tile, one thread per pixel, walking positions from the tile's largest
// n_contrib down to 1; each pixel recovers T as T / (1 - alpha) from its saved
// final T and skips positions past its own n_contrib. Every pair slot belongs
// to exactly one tile, so instead of backward.cu's per-gaussian atomics the
// block reduces its pixels' contributions per slot (warp shuffles, then the 8
// warp partials through shared memory, 32 slots per round) and writes each
// slot once: no atomics, deterministic gradients, and the autograd boundary
// stays at pair_data as in the JAX package. A warp whose pixels all skip a
// pair writes zeros without shuffling. Slots never walked keep the zeros the
// wrapper allocated. Built with -fmad=false, like the forward.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int ROWS = 8;
constexpr int NWARP = PIX / 32;
constexpr int BATCH = 32;  // pair slots staged and reduced per round
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;

__device__ __forceinline__ int state_row(int ch) { return ch < 3 ? ch : 6; }

template <int CH>
__global__ void __launch_bounds__(PIX) blend_bwd_kernel(
    const float* __restrict__ pair_data, long long stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    int grid_x, int width, int height, const float* __restrict__ fwd,
    const float* __restrict__ dout, float* __restrict__ grads) {
  constexpr int NF = 6 + CH;
  __shared__ float s_pair[NF][BATCH];
  __shared__ float s_red[NWARP][BATCH][NF];
  __shared__ int s_max;

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tile_count[tile] == 0) return;
  const long long start = tile_start[tile];

  const float* f = fwd + (size_t)tile * ROWS * PIX;
  const float* g = dout + (size_t)tile * ROWS * PIX;
  const float t_final = f[3 * PIX + tid];
  const int nc = (int)f[4 * PIX + tid];
  const float d_t = g[3 * PIX + tid];
  float d_c[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) d_c[c] = g[state_row(c) * PIX + tid];
  const float px = (float)((tile % grid_x) * TILE + tid % TILE);
  const float py = (float)((tile / grid_x) * TILE + tid / TILE);

  if (tid == 0) s_max = 0;
  __syncthreads();
  const int warp_max = __reduce_max_sync(0xffffffffu, nc);
  if (lane == 0) atomicMax(&s_max, warp_max);
  __syncthreads();
  const int walk = s_max;  // positions 1 .. walk cover every included pair

  float T = t_final;
  float acc[CH], last_c[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = last_c[c] = 0.f;
  float last_alpha = 0.f;

  for (int hi = walk; hi > 0; hi -= BATCH) {
    const int lo = max(hi - BATCH, 0);
    const int n = hi - lo;
    __syncthreads();  // the previous round's readers of s_pair / s_red are done
    if (tid < n) {
#pragma unroll
      for (int fl = 0; fl < NF; ++fl) s_pair[fl][tid] = pair_data[fl * stride + start + lo + tid];
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float gv[NF];
#pragma unroll
      for (int fl = 0; fl < NF; ++fl) gv[fl] = 0.f;
      bool inc = false;
      if (lo + j + 1 <= nc) {
        const float dx = s_pair[0][j] - px;
        const float dy = s_pair[1][j] - py;
        const float A = s_pair[2][j], B = s_pair[3][j], C = s_pair[4][j];
        const float op = s_pair[5][j];
        const float power = -0.5f * (A * dx * dx + C * dy * dy) - B * dx * dy;
        if (power <= 0.f) {
          const float G = expf(power);
          const float alpha = fminf(op * G, ALPHA_MAX);
          if (alpha >= ALPHA_MIN) {
            inc = true;
            T = T / (1.f - alpha);
            const float w = alpha * T;
            float dl_da = 0.f;
#pragma unroll
            for (int c = 0; c < CH; ++c) {
              const float col = s_pair[6 + c][j];
              acc[c] = last_alpha * last_c[c] + (1.f - last_alpha) * acc[c];
              last_c[c] = col;
              dl_da = dl_da + (col - acc[c]) * d_c[c];
              gv[6 + c] = w * d_c[c];
            }
            dl_da = dl_da * T;
            last_alpha = alpha;
            dl_da = dl_da + (-t_final / (1.f - alpha)) * d_t;
            const float q = G * dl_da;
            gv[0] = -op * q * (A * dx + B * dy);
            gv[1] = -op * q * (C * dy + B * dx);
            gv[2] = -0.5f * op * q * dx * dx;
            gv[3] = -op * q * dx * dy;
            gv[4] = -0.5f * op * q * dy * dy;
            gv[5] = q;
          }
        }
      }
      if (__any_sync(0xffffffffu, inc)) {
#pragma unroll
        for (int fl = 0; fl < NF; ++fl) {
          float v = gv[fl];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) s_red[warp][j][fl] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int fl = 0; fl < NF; ++fl) s_red[warp][j][fl] = 0.f;
      }
    }
    __syncthreads();
    for (int e = tid; e < n * NF; e += PIX) {
      const int j = e / NF;
      const int fl = e - j * NF;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) s += s_red[w][j][fl];
      grads[fl * stride + start + lo + j] = s;
    }
  }
}

}  // namespace

// pair_data [F, stride] float32 SoA (F >= 6 + channels); tile_start,
// tile_count [n_tiles] int32; fwd (the forward's raw state) and dout (its
// cotangent) [n_tiles, 8, 256] float32; grads [F, stride] float32, zeroed by
// the caller. Launches on `stream` and returns cudaGetLastError().
extern "C" int blend_bwd(const float* pair_data, long long stride, const int* tile_start,
                         const int* tile_count, int n_tiles, int grid_x, int width, int height,
                         int channels, const float* fwd, const float* dout, float* grads,
                         void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 3) {
    blend_bwd_kernel<3><<<n_tiles, PIX, 0, s>>>(pair_data, stride, tile_start, tile_count,
                                                grid_x, width, height, fwd, dout, grads);
  } else if (channels == 4) {
    blend_bwd_kernel<4><<<n_tiles, PIX, 0, s>>>(pair_data, stride, tile_start, tile_count,
                                                grid_x, width, height, fwd, dout, grads);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
