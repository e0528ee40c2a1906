// K2: the i3res50 stem, conv + folded BN + ReLU + max pool in one kernel.
//
// Replaces stem_conv_pool_h (anomaly_detection_on_video_tpu/ops/pallas/
// stem.py:150) together with its XLA tail stem_pool_w (:188):
// Conv3d 3->64 k(5,7,7) s(2,2,2) p(2,3,3), BN folded to a float32 affine,
// ReLU, MaxPool3d k(2,3,3) s(2,2,2) without padding.
// x (B, 16, 224, 224, 3) -> out (B, 4, 55, 55, 64), float32 or bfloat16 in
// memory, float32 accumulation. Weights arrive as float32 (735, 64) rows
// ordered (kt, kh, kw, c); in bfloat16 mode they hold bfloat16 values.
//
// Bound: operations (about 9.4 GFLOP of conv per clip against 0.6 MB of
// pixels read). Design: one CTA per (clip, pooled frame u, 4x8 tile of
// pooled positions). It computes the 2 x 9 x 17 stem positions that tile's
// pool windows cover (neighbouring windows share one stem row and column,
// so a tile recomputes about 1.25x the stem outputs it owns) as an implicit
// GEMM with K = 735, N = 64: the input slab and the weights of one temporal
// tap are staged in shared memory, each thread accumulates 5 positions x 16
// channels in registers with CUDA-core FMAs. The epilogue applies the
// affine and ReLU, parks the stem tile in shared memory, and pools it, so
// only the pooled tensor reaches device memory. Tensor cores (wgmma) are
// left to a later revision.
#include "common.cuh"

namespace {

constexpr int IN_T = 16, IN_H = 224, IN_W = 224, IN_C = 3, CO = 64;
constexpr int KT = 5, KH = 7, KW = 7;
constexpr int POOL_T = 4, POOL_HW = 55;
constexpr int TPH = 4, TPW = 8;                 // pooled rows / cols per CTA
constexpr int SR = 2 * TPH + 1, SC = 2 * TPW + 1;  // stem rows / cols per CTA
constexpr int NPOS = 2 * SR * SC;               // stem positions (2 stem frames)
constexpr int THREADS = 256;
constexpr int MP = (NPOS + 63) / 64;            // positions per thread
constexpr int IR = 2 * (SR - 1) + KH;           // input rows per CTA
constexpr int IC = 2 * (SC - 1) + KW;           // input cols per CTA
constexpr int IN_ELEMS = 2 * IR * IC * IN_C;    // one temporal tap, both stem frames
constexpr int IN_SLOT = (IN_ELEMS + 3) / 4 * 4; // keeps s_w 16-byte aligned
constexpr int TAP_K = KH * KW * IN_C;           // 147 rows of K per temporal tap
constexpr int W_ELEMS = TAP_K * CO;
constexpr int STEM_STRIDE = CO + 1;             // padded row: fewer bank conflicts
constexpr int STEM_ELEMS = NPOS * STEM_STRIDE;
constexpr int SMEM_FLOATS = (IN_SLOT + W_ELEMS) > STEM_ELEMS ? (IN_SLOT + W_ELEMS) : STEM_ELEMS;
constexpr int TILES_H = (POOL_HW + TPH - 1) / TPH;
constexpr int TILES_W = (POOL_HW + TPW - 1) / TPW;

template <typename T>
__global__ void __launch_bounds__(THREADS) stem_kernel(const T* __restrict__ x,
                                                       const float* __restrict__ w,
                                                       const float* __restrict__ scale,
                                                       const float* __restrict__ bias,
                                                       T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;             // [2][IR][IC][3]
  float* s_w = smem + IN_SLOT;    // [TAP_K][64]
  const int tid = threadIdx.x;
  const int cg = tid & 3;         // channel group: channels cg*16 .. cg*16+15
  const int pg = tid >> 2;        // position group: positions pg + 64*i
  const int pw0 = blockIdx.x * TPW;
  const int ph0 = blockIdx.y * TPH;
  const int b = blockIdx.z / POOL_T;
  const int u = blockIdx.z % POOL_T;
  const int ih0 = 2 * (2 * ph0) - 3;  // first input row of the tile
  const int iw0 = 2 * (2 * pw0) - 3;

  int base[MP];
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    const int p = pg + 64 * i;
    if (p < NPOS) {
      const int j = p / (SR * SC);
      const int rr = (p / SC) % SR;
      const int cc = p % SC;
      base[i] = ((j * IR + 2 * rr) * IC + 2 * cc) * IN_C;
    } else {
      base[i] = 0;  // padding slot: computed, never stored
    }
  }

  float acc[MP][16];
#pragma unroll
  for (int i = 0; i < MP; ++i)
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[i][n] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();  // the previous tap's reads are done
    for (int e = tid; e < IN_ELEMS; e += THREADS) {
      const int c = e % IN_C;
      const int k = (e / IN_C) % IC;
      const int r = (e / (IN_C * IC)) % IR;
      const int j = e / (IN_C * IC * IR);
      const int f = 4 * u + 2 * j - 2 + kt;  // input frame of stem frame 2u+j
      const int ih = ih0 + r;
      const int iw = iw0 + k;
      float v = 0.f;  // zero padding of the conv
      if (f >= 0 && f < IN_T && ih >= 0 && ih < IN_H && iw >= 0 && iw < IN_W) {
        v = adv::to_float(
            x[(((static_cast<size_t>(b) * IN_T + f) * IN_H + ih) * IN_W + iw) * IN_C + c]);
      }
      s_in[e] = v;
    }
    for (int e = tid; e < W_ELEMS; e += THREADS) s_w[e] = __ldg(w + kt * W_ELEMS + e);
    __syncthreads();

    for (int kh = 0; kh < KH; ++kh) {
      for (int kw = 0; kw < KW; ++kw) {
#pragma unroll
        for (int c = 0; c < IN_C; ++c) {
          const int toff = (kh * IC + kw) * IN_C + c;
          const float4* wr =
              reinterpret_cast<const float4*>(s_w + ((kh * KW + kw) * IN_C + c) * CO + cg * 16);
          float wv[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = wr[q];
            wv[4 * q + 0] = v.x;
            wv[4 * q + 1] = v.y;
            wv[4 * q + 2] = v.z;
            wv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < MP; ++i) {
            const float a = s_in[base[i] + toff];
#pragma unroll
            for (int n = 0; n < 16; ++n) acc[i][n] = fmaf(a, wv[n], acc[i][n]);
          }
        }
      }
    }
  }
  __syncthreads();  // all reads of s_in / s_w done: reuse smem for the stem tile

  float* s_stem = smem;  // [NPOS][STEM_STRIDE]
#pragma unroll
  for (int i = 0; i < MP; ++i) {
    const int p = pg + 64 * i;
    if (p < NPOS) {
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int co = cg * 16 + n;
        const float y = __fadd_rn(__fmul_rn(acc[i][n], __ldg(scale + co)), __ldg(bias + co));
        s_stem[p * STEM_STRIDE + co] = fmaxf(y, 0.f);
      }
    }
  }
  __syncthreads();

  for (int e = tid; e < TPH * TPW * CO; e += THREADS) {
    const int co = e % CO;
    const int pc = (e / CO) % TPW;
    const int pr = e / (CO * TPW);
    const int prow = ph0 + pr;
    const int pcol = pw0 + pc;
    if (prow >= POOL_HW || pcol >= POOL_HW) continue;
    float m = 0.f;  // every pooled value is a ReLU output, so >= 0
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int p = (j * SR + 2 * pr + dr) * SC + 2 * pc + dc;
          m = fmaxf(m, s_stem[p * STEM_STRIDE + co]);
        }
    out[(((static_cast<size_t>(b) * POOL_T + u) * POOL_HW + prow) * POOL_HW + pcol) * CO + co] =
        adv::from_float<T>(m);
  }
}

template <typename T>
int launch(const void* x, const float* w, const float* scale, const float* bias, void* out,
           int batch, cudaStream_t stream) {
  const int smem = SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(TILES_W, TILES_H, batch * POOL_T);
  stem_kernel<T><<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), w, scale, bias,
                                                  static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int adv_stem(const void* x, const float* w, const float* scale, const float* bias,
                        void* out, int bf16, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, w, scale, bias, out, batch, s);
  return launch<float>(x, w, scale, bias, out, batch, s);
}
