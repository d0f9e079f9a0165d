// Tile blend forward for NVIDIA Hopper (sm_90a): front-to-back alpha blending
// of each 16x16 tile's depth-ordered (gaussian, tile) pairs.
//
// Replaces: gaustar_tpu/ops/blend_pallas.py:_fwd_kernel -> _fwd_tile
//           (pallas_call in _blend_fwd_raw).
//
// What bounds it on the H100: the per-pixel walk is a sequential chain of
// dependent float operations and one expf per (pixel, pair), and its length
// differs from tile to tile, so the kernel is bound by the latency of that
// chain and by the busiest tiles, not by the H100's float rate or by its
// memory (each pair's 10 floats are read once per tile from device memory;
// the 8 x 256 float state is written once).
//
// Design: the reference CUDA rasterizer's own form (forward.cu:261-374), not
// the TPU kernel's closed-form chunk scans. One 256-thread block per tile, one
// thread per pixel. Pairs are staged through shared memory in batches of 256
// (one coalesced load per field row), each pixel runs a sequential loop that
// breaks at the 1e-4 stop, and the block leaves as soon as every pixel is done
// (__syncthreads_count). Empty tiles write the constant empty state and return.
// Built with -fmad=false so every product and sum rounds as the plain
// PyTorch version's do, which keeps n_contrib exact between the two.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int ROWS = 8;
// float32 roundings of the double constants, as PyTorch compares a float32
// tensor with a Python float.
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;
constexpr float T_STOP = (float)1e-4;

template <int CH>
__global__ void __launch_bounds__(PIX) blend_fwd_kernel(
    const float* __restrict__ pair_data, long long stride,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    int grid_x, int width, int height, float* __restrict__ out) {
  constexpr int NF = 6 + CH;
  __shared__ float s_pair[NF][PIX];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int count = tile_count[tile];
  float* o = out + (size_t)tile * ROWS * PIX;
  if (count == 0) {
    for (int r = 0; r < ROWS; ++r) o[r * PIX + tid] = (r == 3) ? 1.f : 0.f;
    return;
  }
  const long long start = tile_start[tile];
  const int ix = (tile % grid_x) * TILE + tid % TILE;
  const int iy = (tile / grid_x) * TILE + tid / TILE;
  const float px = (float)ix;
  const float py = (float)iy;
  bool done = ix >= width || iy >= height;

  float T = 1.f;
  float col[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) col[c] = 0.f;
  int last = 0;

  for (int base = 0; base < count; base += PIX) {
    // Barrier for the batch buffer, and the block's early exit.
    if (__syncthreads_count(done) == PIX) break;
    const int n = min(PIX, count - base);
    if (tid < n) {
#pragma unroll
      for (int f = 0; f < NF; ++f) s_pair[f][tid] = pair_data[f * stride + start + base + tid];
    }
    __syncthreads();
    if (done) continue;
    for (int j = 0; j < n; ++j) {
      const float dx = s_pair[0][j] - px;
      const float dy = s_pair[1][j] - py;
      const float A = s_pair[2][j], B = s_pair[3][j], C = s_pair[4][j];
      const float power = -0.5f * (A * dx * dx + C * dy * dy) - B * dx * dy;
      if (power > 0.f) continue;
      const float alpha = fminf(s_pair[5][j] * expf(power), ALPHA_MAX);
      if (alpha < ALPHA_MIN) continue;
      const float test_t = T * (1.f - alpha);
      if (test_t < T_STOP) {
        done = true;
        break;
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) col[c] = col[c] + s_pair[6 + c][j] * alpha * T;
      T = test_t;
      last = base + j + 1;
    }
  }

  o[0 * PIX + tid] = col[0];
  o[1 * PIX + tid] = col[1];
  o[2 * PIX + tid] = col[2];
  o[3 * PIX + tid] = T;
  o[4 * PIX + tid] = (float)last;
  o[5 * PIX + tid] = done ? 1.f : 0.f;
  o[6 * PIX + tid] = CH == 4 ? col[CH - 1] : 0.f;
  o[7 * PIX + tid] = 0.f;
}

}  // namespace

// pair_data [F, stride] float32 SoA (F >= 6 + channels); tile_start,
// tile_count [n_tiles] int32; out [n_tiles, 8, 256] float32. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int blend_fwd(const float* pair_data, long long stride, const int* tile_start,
                         const int* tile_count, int n_tiles, int grid_x, int width, int height,
                         int channels, float* out, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels == 3) {
    blend_fwd_kernel<3><<<n_tiles, PIX, 0, s>>>(pair_data, stride, tile_start, tile_count,
                                                grid_x, width, height, out);
  } else if (channels == 4) {
    blend_fwd_kernel<4><<<n_tiles, PIX, 0, s>>>(pair_data, stride, tile_start, tile_count,
                                                grid_x, width, height, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
