// JPEG decode and encode through nvJPEG (the CUDA toolkit's libnvjpeg), with a
// plain C interface for ctypes (gaustar_tpu_torch/io/image_codec.py).
//
// This is I/O, not the port of a TPU kernel: the JAX package reads the dataset's
// frames with PIL (gaustar_tpu/io/dataset.py:83-100) and writes renders with it
// (gaustar_tpu/train/render_seq.py:59-61). Here the Huffman stage runs on the
// host inside nvjpegDecode and the IDCT and colour conversion on the card, so
// a frame lands on the device as interleaved RGB uint8 [H, W, 3] without a
// host image buffer. Encoding reads such an image on the device and returns
// the bitstream on the host.
//
// One library handle, one decode state and one encoder state live for the
// process (created at first use). Every function returns 0 on success,
// 1000 + nvjpegStatus_t for an nvJPEG error, 2000 + cudaError_t for a CUDA
// error, or 1 when the caller's output buffer is too small (jpeg_encode sets
// *length to the size it needs).

#include <cstring>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_dec_state = nullptr;
nvjpegEncoderState_t g_enc_state = nullptr;
nvjpegEncoderParams_t g_enc_params = nullptr;

#define NVJ(call)                                    \
  do {                                               \
    nvjpegStatus_t s_ = (call);                      \
    if (s_ != NVJPEG_STATUS_SUCCESS) return 1000 + (int)s_; \
  } while (0)

#define CU(call)                                     \
  do {                                               \
    cudaError_t e_ = (call);                         \
    if (e_ != cudaSuccess) return 2000 + (int)e_;   \
  } while (0)

int ensure_handle() {
  if (g_handle == nullptr) NVJ(nvjpegCreateSimple(&g_handle));
  if (g_dec_state == nullptr) NVJ(nvjpegJpegStateCreate(g_handle, &g_dec_state));
  return 0;
}

int ensure_encoder(cudaStream_t stream) {
  int err = ensure_handle();
  if (err) return err;
  if (g_enc_state == nullptr) NVJ(nvjpegEncoderStateCreate(g_handle, &g_enc_state, stream));
  if (g_enc_params == nullptr) NVJ(nvjpegEncoderParamsCreate(g_handle, &g_enc_params, stream));
  return 0;
}

}  // namespace

extern "C" {

// Width, height and component count of a JPEG bitstream.
int jpeg_info(const unsigned char* data, long long length, int* width, int* height, int* components) {
  int err = ensure_handle();
  if (err) return err;
  int n = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  NVJ(nvjpegGetImageInfo(g_handle, data, (size_t)length, &n, &sub, widths, heights));
  *width = widths[0];
  *height = heights[0];
  *components = n;
  return 0;
}

// Decode into `out`, a device buffer of height * width * 3 bytes (RGB,
// interleaved, row pitch width * 3), on `stream`.
int jpeg_decode(const unsigned char* data, long long length, unsigned char* out, int width, cudaStream_t stream) {
  int err = ensure_handle();
  if (err) return err;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = out;
  img.pitch[0] = (size_t)width * 3;
  NVJ(nvjpegDecode(g_handle, g_dec_state, data, (size_t)length, NVJPEG_OUTPUT_RGBI, &img, stream));
  CU(cudaGetLastError());
  return 0;
}

// Encode the device image `rgb` (height x width x 3 uint8, interleaved) at
// `quality` with 4:4:4 chroma into the host buffer `out` of *length bytes;
// *length becomes the bitstream's size. Synchronises `stream`.
int jpeg_encode(const unsigned char* rgb, int width, int height, int quality, unsigned char* out,
                long long* length, cudaStream_t stream) {
  int err = ensure_encoder(stream);
  if (err) return err;
  NVJ(nvjpegEncoderParamsSetQuality(g_enc_params, quality, stream));
  NVJ(nvjpegEncoderParamsSetSamplingFactors(g_enc_params, NVJPEG_CSS_444, stream));
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = const_cast<unsigned char*>(rgb);
  img.pitch[0] = (size_t)width * 3;
  NVJ(nvjpegEncodeImage(g_handle, g_enc_state, g_enc_params, &img, NVJPEG_INPUT_RGBI, width, height, stream));
  size_t need = 0;
  NVJ(nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, nullptr, &need, stream));
  CU(cudaStreamSynchronize(stream));
  if ((long long)need > *length) {
    *length = (long long)need;
    return 1;
  }
  NVJ(nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, out, &need, stream));
  CU(cudaStreamSynchronize(stream));
  *length = (long long)need;
  return 0;
}

}  // extern "C"
