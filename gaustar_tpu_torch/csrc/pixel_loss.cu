// The refine step's pixel losses for NVIDIA Hopper (sm_90a): masked L1,
// masked SSIM, depth L1 and the mask term of one channels-major render, as
// four means, and their backward.
//
// Replaces no Pallas kernel: the JAX package's SSIM is plain jnp
// (gaustar_tpu/ops/losses.py:ssim_map_cm), which XLA fuses. The port ran
// it as PyTorch's shift-and-add (ops/losses.py:_sep_filter_bhw): the 11x11
// window as 22 taps over a [15, H, W] stack, each tap one or two
// elementwise kernels over 98 MB at 1600x1024, and autograd replaying all
// of it backwards, about 280 launches and 13.5 ms of device time a render.
//
// What bounds it on the H100: neither bytes nor operations. A render's
// inputs are 52 MB (prediction and ground truth, 3 + 1 channels each,
// float32), 0.016 ms at 3.35 TB/s; forward and backward together are about
// 1,058 operations a pixel (benchmark/bounds.py:SSIM_OPS_PER_PIXEL), 0.026
// ms at 67 TFLOP/s. What the shift-and-add paid for was moving the stack
// through device memory once a tap and the host's launches.
//
// Design: the stencil never leaves the SM.
//   1. pixel_loss_fwd_kernel: one 256-thread block per 32x32 output tile.
//      For each channel it stages x = pred * m and y = gt * m (m the margin
//      mask, read from the margins on the device; the ground truth read in
//      its own [H, W, 3] layout) with a 5-pixel halo in shared memory, runs
//      the horizontal pass of the five maps (x, y, x^2, y^2, xy) into shared
//      memory, and the vertical pass in registers, each thread a column of
//      4 rows. The SSIM value, L1, depth and mask terms and the three
//      counts go to per-thread sums, then to one partial per block.
//   2. pixel_loss_reduce_kernel: one block sums the partials in a fixed
//      order and divides by the clamped counts.
//   3. pixel_loss_bwd_kernel: the same tiling over the three saved partials
//      of each channel (below), filtered by the mirrored window, then the
//      gradient of each pixel, with the L1, depth and mask terms' signs.
// The backward's SSIM term is the window's adjoint applied to
// m(q) dS/dmu1(q), m(q) dS/de11(q) and m(q) dS/de12(q) (e11 = K*x^2,
// e12 = K*xy): dx(p) = K'Q1(p) + 2 x(p) K'Q2(p) + y(p) K'Q3(p). The forward
// saves those nine maps (59 MB a render, written and read once: 0.035 ms)
// rather than the backward recomputing the moments with a 10-pixel halo,
// which would double the staged area and the forward's work for a saving
// below the launch's own cost.
// Float32 throughout, the whole 11x11 window, no atomics: every sum is
// taken in a fixed order, so a run repeats bit for bit.
#include <cuda_runtime.h>

namespace pixel_loss {
namespace {

constexpr int RAD = 5;              // window radius: 11 taps
constexpr int K = 2 * RAD + 1;
constexpr int TW = 32;              // tile width: a warp across
constexpr int TH = 32;              // tile height
constexpr int RPT = 4;              // output rows a thread
constexpr int THREADS = TW * TH / RPT;
constexpr int SW = TW + 2 * RAD;    // staged width and height
constexpr int SH = TH + 2 * RAD;
constexpr int NPART = 8;            // a block's partial sums
constexpr float C1 = 1e-4f;         // 0.01^2
constexpr float C2 = 9e-4f;         // 0.03^2

// Partials: 0 L1 sum, 1 SSIM sum, 2 masked pixels, 3 depth L1 sum,
// 4 foreground pixels, 5 mask-term sum, 6 background pixels, 7 unused.

struct Taps {
  float col[K];  // vertical taps: out(y) = sum_k col[k] in(y + k - RAD)
  float row[K];  // horizontal taps
};

struct Frame {
  const float* img;       // [3, H, W] rows contiguous, channel stride img_cs
  long long img_cs;
  const float* depth;     // [H, W]
  const float* gt;        // [H, W, 3]
  const float* gt_depth;  // [H, W]
  const long long* margin;  // [4] left, right, top, bottom; null: none
  float max_depth;
  int H, W;
};

struct Box {
  int x0, x1, y0, y1;  // the unmasked pixels: x0 <= x < x1, y0 <= y < y1
  __device__ bool inside(int x, int y) const { return x >= x0 && x < x1 && y >= y0 && y < y1; }
};

__device__ Box margin_box(const Frame& f) {
  if (f.margin == nullptr) return {0, f.W, 0, f.H};
  return {(int)f.margin[0], f.W - (int)f.margin[1], (int)f.margin[2], f.H - (int)f.margin[3]};
}

__device__ __forceinline__ float sgn(float v) { return (float)((v > 0.f) - (v < 0.f)); }

// Sum of v over the block in a fixed order: shuffles within each warp, then
// warp 0 over the warps. The result is in thread 0.
__device__ float block_sum(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < (int)(blockDim.x / 32) ? scratch[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// The horizontal pass of N staged maps (SH x SW) into N maps of SH x TW.
template <int N>
__device__ __forceinline__ void horizontal(float (*src)[SH][SW], float (*dst)[SH][TW], const float* taps) {
  for (int i = threadIdx.x; i < SH * TW; i += THREADS) {
    const int r = i / TW, c = i % TW;
    float a[N];
#pragma unroll
    for (int n = 0; n < N; ++n) a[n] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int n = 0; n < N; ++n) a[n] += taps[k] * src[n][r][c + k];
    }
#pragma unroll
    for (int n = 0; n < N; ++n) dst[n][r][c] = a[n];
  }
}

// The vertical pass of N maps for this thread's RPT rows of column lx,
// from the RPT + 2 RAD values of the column held in registers.
template <int N>
__device__ __forceinline__ void vertical(float (*src)[SH][TW], int lx, int ly0, const float* taps,
                                         float (*out)[RPT]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float col[RPT + 2 * RAD];
#pragma unroll
    for (int i = 0; i < RPT + 2 * RAD; ++i) col[i] = src[n][ly0 + i][lx];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) a += taps[k] * col[j + k];
      out[n][j] = a;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
pixel_loss_fwd_kernel(Frame f, Taps taps, float* __restrict__ q, float* __restrict__ partials) {
  __shared__ float staged[2][SH][SW];  // x, y
  __shared__ float hpass[5][SH][TW];   // x, y, x^2, y^2, xy
  __shared__ float scratch[32];
  const Box box = margin_box(f);
  const int bx = blockIdx.x * TW, by = blockIdx.y * TH;
  const int lx = threadIdx.x % TW, ly0 = (threadIdx.x / TW) * RPT;
  const int px = bx + lx;
  const long long hw = (long long)f.H * f.W;
  float acc[NPART];
#pragma unroll
  for (int i = 0; i < NPART; ++i) acc[i] = 0.f;

  for (int c = 0; c < 3; ++c) {
    // x and y over the tile and its halo; 0 outside the image and the mask
    for (int i = threadIdx.x; i < SH * SW; i += THREADS) {
      const int r = i / SW, s = i % SW;
      const int gy = by - RAD + r, gx = bx - RAD + s;
      float xv = 0.f, yv = 0.f;
      if (gy >= 0 && gy < f.H && gx >= 0 && gx < f.W && box.inside(gx, gy)) {
        const long long p = (long long)gy * f.W + gx;
        xv = f.img[c * f.img_cs + p];
        yv = f.gt[3 * p + c];
      }
      staged[0][r][s] = xv;
      staged[1][r][s] = yv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < SH * TW; i += THREADS) {
      const int r = i / TW, s = i % TW;
      float a[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float xv = staged[0][r][s + k], yv = staged[1][r][s + k], w = taps.row[k];
        a[0] += w * xv;
        a[1] += w * yv;
        a[2] += w * (xv * xv);
        a[3] += w * (yv * yv);
        a[4] += w * (xv * yv);
      }
#pragma unroll
      for (int n = 0; n < 5; ++n) hpass[n][r][s] = a[n];
    }
    __syncthreads();
    float mom[5][RPT];
    vertical<5>(hpass, lx, ly0, taps.col, mom);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int py = by + ly0 + j;
      if (px >= f.W || py >= f.H || !box.inside(px, py)) continue;
      const float mu1 = mom[0][j], mu2 = mom[1][j];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
      const float s11 = mom[2][j] - mu1_sq, s22 = mom[3][j] - mu2_sq, s12 = mom[4][j] - mu1_mu2;
      const float a1 = 2.f * mu1_mu2 + C1, a2 = 2.f * s12 + C2;
      const float b1 = mu1_sq + mu2_sq + C1, b2 = s11 + s22 + C2;
      const float den = b1 * b2;
      const float ssim = (a1 * a2) / den;
      acc[0] += fabsf(staged[0][ly0 + j + RAD][lx + RAD] - staged[1][ly0 + j + RAD][lx + RAD]);
      acc[1] += ssim;
      if (q != nullptr) {
        // dS/dmu1 with e11, e12 held: through mu1 directly, sigma1^2 and sigma12
        const float d_e11 = -ssim / b2;
        const float d_e12 = 2.f * a1 / den;
        const float d_mu1 = 2.f * mu2 * a2 / den - 2.f * mu1 * ssim / b1 - 2.f * mu1 * d_e11 - mu2 * d_e12;
        const long long p = (long long)py * f.W + px;
        q[(0 * 3 + c) * hw + p] = d_mu1;
        q[(1 * 3 + c) * hw + p] = d_e11;
        q[(2 * 3 + c) * hw + p] = d_e12;
      }
    }
    __syncthreads();  // before the next channel is staged
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int py = by + ly0 + j;
    if (px >= f.W || py >= f.H) continue;
    const long long p = (long long)py * f.W + px;
    const float pd = f.depth[p], gd = f.gt_depth[p];
    const float fg = gd < f.max_depth ? 1.f : 0.f, bg = gd > f.max_depth ? 1.f : 0.f;
    acc[2] += box.inside(px, py) ? 1.f : 0.f;
    acc[3] += fabsf(pd - gd) * fg;
    acc[4] += fg;
    acc[5] += fabsf(pd - f.max_depth) * bg;
    acc[6] += bg;
    if (q != nullptr && !box.inside(px, py)) {
      for (int n = 0; n < 9; ++n) q[n * hw + p] = 0.f;
    }
  }
  float* out = partials + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * NPART;
#pragma unroll
  for (int i = 0; i < NPART; ++i) {
    const float v = block_sum(acc[i], scratch);
    if (threadIdx.x == 0) out[i] = v;
  }
}

// The partials of n blocks -> the four means and their denominators.
__global__ void __launch_bounds__(THREADS)
pixel_loss_reduce_kernel(const float* __restrict__ partials, int n, float* __restrict__ means,
                         float* __restrict__ denom) {
  __shared__ float scratch[32];
  float tot[NPART];
#pragma unroll
  for (int i = 0; i < NPART; ++i) {
    float a = 0.f;
    for (int b = threadIdx.x; b < n; b += THREADS) a += partials[(long long)b * NPART + i];
    tot[i] = block_sum(a, scratch);
  }
  if (threadIdx.x == 0) {
    const float d[4] = {fmaxf(3.f * tot[2], 1.f), fmaxf(3.f * tot[2], 1.f), fmaxf(tot[4], 1.f),
                        fmaxf(tot[6], 1.f)};
    const float s[4] = {tot[0], tot[1], tot[3], tot[5]};
    for (int i = 0; i < 4; ++i) {
      means[i] = s[i] / d[i];
      denom[i] = d[i];
    }
  }
}

// d img [3, H, W] and d depth [H, W] from the four means' cotangents g:
// taps are the forward's mirrored (the window's adjoint).
__global__ void __launch_bounds__(THREADS)
pixel_loss_bwd_kernel(Frame f, Taps taps, const float* __restrict__ q, const float* __restrict__ g,
                      const float* __restrict__ denom, float* __restrict__ d_img, float* __restrict__ d_depth) {
  __shared__ float staged[3][SH][SW];
  __shared__ float hpass[3][SH][TW];
  const Box box = margin_box(f);
  const int bx = blockIdx.x * TW, by = blockIdx.y * TH;
  const int lx = threadIdx.x % TW, ly0 = (threadIdx.x / TW) * RPT;
  const int px = bx + lx;
  const long long hw = (long long)f.H * f.W;
  const float g_l1 = g[0] / denom[0], g_ssim = g[1] / denom[1];
  const float g_depth = g[2] / denom[2], g_mask = g[3] / denom[3];

  for (int c = 0; c < 3; ++c) {
    for (int i = threadIdx.x; i < SH * SW; i += THREADS) {
      const int r = i / SW, s = i % SW;
      const int gy = by - RAD + r, gx = bx - RAD + s;
      const bool in = gy >= 0 && gy < f.H && gx >= 0 && gx < f.W;
      const long long p = (long long)gy * f.W + gx;
#pragma unroll
      for (int n = 0; n < 3; ++n) staged[n][r][s] = in ? q[(n * 3 + c) * hw + p] : 0.f;
    }
    __syncthreads();
    horizontal<3>(staged, hpass, taps.row);
    __syncthreads();
    float kq[3][RPT];
    vertical<3>(hpass, lx, ly0, taps.col, kq);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int py = by + ly0 + j;
      if (px >= f.W || py >= f.H) continue;
      const long long p = (long long)py * f.W + px;
      float d = 0.f;
      if (box.inside(px, py)) {
        const float x = f.img[c * f.img_cs + p], y = f.gt[3 * p + c];
        d = g_ssim * (kq[0][j] + 2.f * x * kq[1][j] + y * kq[2][j]) + g_l1 * sgn(x - y);
      }
      d_img[c * hw + p] = d;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int py = by + ly0 + j;
    if (px >= f.W || py >= f.H) continue;
    const long long p = (long long)py * f.W + px;
    const float pd = f.depth[p], gd = f.gt_depth[p];
    const float fg = gd < f.max_depth ? 1.f : 0.f, bg = gd > f.max_depth ? 1.f : 0.f;
    d_depth[p] = g_depth * fg * sgn(pd - gd) + g_mask * bg * sgn(pd - f.max_depth);
  }
}

Frame frame(const float* img, long long img_cs, const float* depth, const float* gt, const float* gt_depth,
            const long long* margin, float max_depth, int height, int width) {
  return Frame{img, img_cs, depth, gt, gt_depth, margin, max_depth, height, width};
}

Taps taps_of(const float* host) {
  Taps t;
  for (int k = 0; k < K; ++k) {
    t.col[k] = host[k];
    t.row[k] = host[K + k];
  }
  return t;
}

dim3 grid_of(int height, int width) { return dim3((width + TW - 1) / TW, (height + TH - 1) / TH); }

}  // namespace
}  // namespace pixel_loss

// Forward: means[4] = (L1, SSIM, depth L1, mask term), denom[4] their
// clamped counts; q [3, 3, H, W] (null: not kept) the backward's partials,
// [dS/dmu1, dS/dE[x^2], dS/dE[xy]] x channel, 0 outside the margin mask;
// partials NPART floats a TW x TH tile (ops/pixel_loss.py sizes them).
// taps: 22 host floats, the vertical then the horizontal window factors.
extern "C" int pixel_loss_fwd(const float* img, long long img_cs, const float* depth, const float* gt,
                              const float* gt_depth, const long long* margin, float max_depth, int height,
                              int width, const float* taps, float* q, float* partials, float* means,
                              float* denom, void* stream) {
  using namespace pixel_loss;
  if (height <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 g = grid_of(height, width);
  pixel_loss_fwd_kernel<<<g, THREADS, 0, s>>>(
      frame(img, img_cs, depth, gt, gt_depth, margin, max_depth, height, width), taps_of(taps), q, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pixel_loss_reduce_kernel<<<1, THREADS, 0, s>>>(partials, (int)(g.x * g.y), means, denom);
  return (int)cudaGetLastError();
}

// Backward: d_img [3, H, W] and d_depth [H, W] from the means' cotangents g
// [4] and the forward's q and denom. taps: the forward's, each factor
// mirrored.
extern "C" int pixel_loss_bwd(const float* img, long long img_cs, const float* depth, const float* gt,
                              const float* gt_depth, const long long* margin, float max_depth, int height,
                              int width, const float* taps, const float* q, const float* g, const float* denom,
                              float* d_img, float* d_depth, void* stream) {
  using namespace pixel_loss;
  if (height <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pixel_loss_bwd_kernel<<<grid_of(height, width), THREADS, 0, s>>>(
      frame(img, img_cs, depth, gt, gt_depth, margin, max_depth, height, width), taps_of(taps), q, g, denom,
      d_img, d_depth);
  return (int)cudaGetLastError();
}
