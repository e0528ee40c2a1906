// K1: ten-crop + standardize, uint8 frames -> the I3D input batch.
//
// Replaces ten_crop_standardize_pallas (anomaly_detection_on_video_tpu/
// ops/pallas/crop_norm.py:49). frames (gc, fpc, H, W, 3) uint8 ->
// out (gc*10, fpc, S, S, 3) float32 or bfloat16, batch row clip*10 + crop.
// Crops 0-4 sit at the five torchvision positions; crops 5-9 are the same
// five of the horizontally flipped frame, so their source column is
// W - 1 - (left + x). Each value is (v - mean) * inv_std in float32 with
// explicit round-to-nearest operations (no contraction), which makes the
// float32 output bit-equal to the plain version and the bfloat16 output its
// round-to-nearest-even.
//
// Bound: memory. It reads each needed uint8 pixel and writes 4 (or 2) bytes
// per output value, about 12x more bytes written than read. One thread per
// output pixel; a warp writes 96 consecutive values, so the stores coalesce.
#include "common.cuh"

namespace {

struct CropOffsets {
  int top[5];
  int left[5];
};

template <typename T>
__global__ void __launch_bounds__(256) crop_norm_kernel(
    const uint8_t* __restrict__ frames, T* __restrict__ out, int fpc, int height, int width,
    int size, CropOffsets off, float mean, float inv_std) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;  // pixel inside the crop plane
  if (pix >= size * size) return;
  const int plane = blockIdx.y;  // (clip * 10 + crop) * fpc + frame
  const int f = plane % fpc;
  const int n = plane / fpc;
  const int crop = n % 10;
  const int clip = n / 10;
  const int y = pix / size;
  const int x = pix % size;
  const int k = crop % 5;
  const int row = off.top[k] + y;
  int col = off.left[k] + x;
  if (crop >= 5) col = width - 1 - col;
  const uint8_t* src =
      frames + ((static_cast<size_t>(clip) * fpc + f) * height + row) * static_cast<size_t>(width) * 3 +
      static_cast<size_t>(col) * 3;
  T* dst = out + (static_cast<size_t>(plane) * size * size + pix) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = __fmul_rn(__fsub_rn(static_cast<float>(src[c]), mean), inv_std);
    dst[c] = adv::from_float<T>(v);
  }
}

}  // namespace

extern "C" int adv_crop_norm(const void* frames, void* out, int out_bf16, int gc, int fpc,
                             int height, int width, int size, const int* offsets, float mean,
                             float inv_std, void* stream) {
  CropOffsets off;
  for (int i = 0; i < 5; ++i) {
    off.top[i] = offsets[i];
    off.left[i] = offsets[5 + i];
  }
  const dim3 block(256);
  const dim3 grid((size * size + 255) / 256, gc * 10 * fpc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(frames);
  if (out_bf16) {
    crop_norm_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        in, static_cast<__nv_bfloat16*>(out), fpc, height, width, size, off, mean, inv_std);
  } else {
    crop_norm_kernel<float><<<grid, block, 0, s>>>(in, static_cast<float*>(out), fpc, height,
                                                   width, size, off, mean, inv_std);
  }
  return static_cast<int>(cudaGetLastError());
}
