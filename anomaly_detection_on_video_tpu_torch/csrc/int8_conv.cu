// K5: int8 3D convolution, channels last, with int32 accumulation and a
// per-output-channel float32 scale epilogue.
//
// Replaces make_conv3x3 / _conv3x3_kernel (scripts/int8_pallas_probe.py:159
// / :116): an int8 3x3 conv with zero padding whose int32 sum is multiplied
// by a per-channel float32 scale and either requantized to int8
// (clip(round(.)), round half to even) or written as bfloat16. Generalized
// from the probe's fixed (128, 28 x 28) planes to any kernel, stride and
// padding of the i3res50 int8 path: k(1,3,3) with stride 1 or 2, k(3,1,1),
// and the stem's k(5,7,7) s2 p(2,3,3) with Cin = 3. It also writes float32,
// ConvBN._int8_conv's dequantize in a float32 model.
// x (B, T, H, W, Cin) int8 -> out (B, To, Ho, Wo, Cout); the weights are
// packed as a (KT*KH*KW*Cin, Cout) int8 matrix with rows (kt, kh, kw, cin).
//
// Bound: operations for the k(1,3,3) convs and the probe's shape, bytes for
// the k(3,1,1) convs over wide inputs. Design: an implicit GEMM with
// M = B*To*Ho*Wo output positions, N = Cout and K = KT*KH*KW*Cin, on the
// tile product of int8_gemm.cuh. The A tile is gathered straight from the
// activation: each thread decodes its two output rows once, then for each
// K step one 16-wide piece of (tap, cin). When Cin is a multiple of 16 the
// piece lies inside one tap and loads as one 16-byte vector, or as zeros
// when the tap falls in the padding. Otherwise (the stem, Cin = 3) it is
// gathered byte by byte, stepping (kt, kh, kw, cin) without divisions, and
// K = 735 is zero-filled past its end. The TPU kernel's masked lane
// rotations answer Mosaic's layout rules and have no counterpart here.
#include "int8_gemm.cuh"

namespace {

using namespace adv::i8;

struct Geometry {
  int B, T, H, W, Cin, Cout;
  int KT, KH, KW, ST, SH, SW, PT, PH, PW;
  int To, Ho, Wo;
};

__global__ void __launch_bounds__(THREADS)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, void* out, Geometry g, int vec_x,
                     int vec_w, int mode) {
  __shared__ __align__(16) int8_t smem[SMEM_BYTES];
  int8_t* s_a = smem;
  int8_t* s_b = smem + BM * LDS;
  const int M = g.B * g.To * g.Ho * g.Wo;
  const int K = g.KT * g.KH * g.KW * g.Cin;
  const int N = g.Cout;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kc = (threadIdx.x & 3) * 16;

  // this thread's two output rows: batch index and the input corner of
  // their receptive field
  int rb[2], rt[2], rh[2], rw[2];
  bool rvalid[2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int m = m0 + (threadIdx.x >> 2) + 64 * p;
    rvalid[p] = m < M;
    const int mm = rvalid[p] ? m : 0;
    const int wo = mm % g.Wo;
    const int ho = (mm / g.Wo) % g.Ho;
    const int to = (mm / (g.Wo * g.Ho)) % g.To;
    rb[p] = mm / (g.Wo * g.Ho * g.To);
    rt[p] = to * g.ST - g.PT;
    rh[p] = ho * g.SH - g.PH;
    rw[p] = wo * g.SW - g.PW;
  }

  int acc[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + kc;
    // (kt, kh, kw, cin) of this thread's first K index
    const int tap = k / g.Cin;
    int ci = k - tap * g.Cin;
    int kw = tap % g.KW;
    int kh = (tap / g.KW) % g.KH;
    int kt = tap / (g.KW * g.KH);
    if (vec_x) {  // Cin % 16 == 0: the 16 values share one tap
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ti = rt[p] + kt, hi = rh[p] + kh, wi = rw[p] + kw;
        int4 v = make_int4(0, 0, 0, 0);
        if (rvalid[p] && k < K && ti >= 0 && ti < g.T && hi >= 0 && hi < g.H && wi >= 0 &&
            wi < g.W) {
          const size_t off =
              (((static_cast<size_t>(rb[p]) * g.T + ti) * g.H + hi) * g.W + wi) * g.Cin + ci;
          v = __ldg(reinterpret_cast<const int4*>(x + off));
        }
        *reinterpret_cast<int4*>(s_a + ((threadIdx.x >> 2) + 64 * p) * LDS + kc) = v;
      }
    } else {
      int8_t v[2][16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int ti = rt[p] + kt, hi = rh[p] + kh, wi = rw[p] + kw;
          int8_t e = 0;
          if (rvalid[p] && k + j < K && ti >= 0 && ti < g.T && hi >= 0 && hi < g.H && wi >= 0 &&
              wi < g.W) {
            e = x[(((static_cast<size_t>(rb[p]) * g.T + ti) * g.H + hi) * g.W + wi) * g.Cin + ci];
          }
          v[p][j] = e;
        }
        if (++ci == g.Cin) {  // next K index: step (kt, kh, kw, cin)
          ci = 0;
          if (++kw == g.KW) {
            kw = 0;
            if (++kh == g.KH) {
              kh = 0;
              ++kt;
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        int8_t* dst = s_a + ((threadIdx.x >> 2) + 64 * p) * LDS + kc;
#pragma unroll
        for (int j = 0; j < 16; ++j) dst[j] = v[p][j];
      }
    }
    load_b_tile(w, s_b, K, N, k0, n0, vec_w);
    __syncthreads();
    mma_tile(s_a, s_b, acc);
    __syncthreads();
  }
  epilogue(acc, m0, n0, M, N, scale, out, mode);
}

}  // namespace

extern "C" int adv_int8_conv(const void* x, const void* w, const float* scale, void* out, int B,
                             int T, int H, int W, int Cin, int Cout, int KT, int KH, int KW,
                             int ST, int SH, int SW, int PT, int PH, int PW, int mode,
                             void* stream) {
  Geometry g{B, T, H, W, Cin, Cout, KT, KH, KW, ST, SH, SW, PT, PH, PW, 0, 0, 0};
  g.To = (T + 2 * PT - KT) / ST + 1;
  g.Ho = (H + 2 * PH - KH) / SH + 1;
  g.Wo = (W + 2 * PW - KW) / SW + 1;
  const int vec_x = Cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = Cout % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const long long M = static_cast<long long>(B) * g.To * g.Ho * g.Wo;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (Cout + BN - 1) / BN);
  int8_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, out, g, vec_x, vec_w,
      mode);
  return static_cast<int>(cudaGetLastError());
}
