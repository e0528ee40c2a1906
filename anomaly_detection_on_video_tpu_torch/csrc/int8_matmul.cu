// K4: int8 x int8 -> int32 matrix product, with an optional per-column
// float32 scale epilogue.
//
// Replaces probe_raw_matmul (scripts/int8_pallas_probe.py:75), whose
// Pallas body is dot_general(w (K, N), x (K, M)) contracting dim 0 with an
// int32 result: in channels-last order that is C (M, N) = A (M, K) . B (K, N)
// with A the activations. The scaled form, float(C) * scale[n] rounded once
// to float32 or bfloat16, is ConvBN._int8_conv's dequantize, which the JAX
// package leaves to XLA after the product; here it is the kernel's epilogue.
// It serves every 1x1x1 int8 conv of the i3res50 int8 path.
//
// Bound: bytes at the path's shapes (2NK / (K + 2N) operations per byte
// stays below the H100's int8 balance of about 590 but at K = 2048), and
// operations only for the largest K. Design: the shared tile product of
// int8_gemm.cuh (128 x 64 tiles, K steps of 64 staged in shared memory,
// mma.sync m16n8k32 on eight warps); A rows load as 16-byte vectors when
// K is a multiple of 16. No TMA, wgmma or pipelining yet.
#include "int8_gemm.cuh"

namespace {

using namespace adv::i8;

__global__ void __launch_bounds__(THREADS)
    int8_matmul_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                       const float* __restrict__ scale, void* out, int M, int N, int K,
                       int vec_a, int vec_b, int mode) {
  __shared__ __align__(16) int8_t smem[SMEM_BYTES];
  int8_t* s_a = smem;
  int8_t* s_b = smem + BM * LDS;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  int acc[2][4][4] = {};

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 128 rows x 64 bytes, two 16-byte pieces per thread
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int r = (threadIdx.x >> 2) + 64 * p;
      const int kc = (threadIdx.x & 3) * 16;
      const int m = m0 + r;
      const int k = k0 + kc;
      int8_t* dst = s_a + r * LDS + kc;
      if (vec_a && m < M && k + 16 <= K) {
        *reinterpret_cast<int4*>(dst) =
            __ldg(reinterpret_cast<const int4*>(a + static_cast<size_t>(m) * K + k));
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (m < M && k + j < K) ? a[static_cast<size_t>(m) * K + k + j] : int8_t(0);
      }
    }
    load_b_tile(b, s_b, K, N, k0, n0, vec_b);
    __syncthreads();
    mma_tile(s_a, s_b, acc);
    __syncthreads();
  }
  epilogue(acc, m0, n0, M, N, scale, out, mode);
}

}  // namespace

extern "C" int adv_int8_matmul(const void* a, const void* b, const float* scale, void* out, int M,
                               int N, int K, int mode, void* stream) {
  const int vec_a = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vec_b = N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  int8_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), scale, out, M, N, K, vec_a,
      vec_b, mode);
  return static_cast<int>(cudaGetLastError());
}
