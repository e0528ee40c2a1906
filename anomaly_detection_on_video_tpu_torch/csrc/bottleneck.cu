// K3: one i3res50 stage-1 bottleneck block in one launch.
//
// Replaces bottleneck_block (anomaly_detection_on_video_tpu/ops/pallas/
// bottleneck.py:176): conv_a k(3,1,1) pad 1 (a k(1,1,1) conv arrives
// zero-padded to three taps) + BN + ReLU; conv_b k(1,3,3) pad 1 + BN + ReLU;
// conv_c 1x1x1 + BN; optional 1x1x1 projection + BN on the shortcut;
// residual add; ReLU. BN arrives folded to float32 affines and the weights
// as float32 (in, out) matrices: wa (3, Cin, 64), wb (9, 64, 64) with rows
// (kh, kw, in), wc (64, 256), wp (Cin, 256).
// x (B, T, 55, 55, Cin) -> out (B, T, 55, 55, 256), channels last, float32
// or bfloat16 in memory, float32 accumulation; in bfloat16 mode the two
// intermediates are rounded to bfloat16 as the reference block rounds them.
//
// Bound: memory at large batch (the 256-channel activations in and out,
// about 3 GB per block at B = 240, dominate), with conv_a the largest share
// of the operations. Design: one CTA per (clip, frame, band of 5 output
// rows) keeps both intermediates in shared memory, as the TPU kernel keeps
// them in VMEM. conv_a is computed for the band plus a one-row halo above
// and below, looping over Cin straight from global memory, into a zero
// framed (7, 57, 64) tile: the frame is conv_b's zero padding, and rows
// outside the plane or frames outside the clip read as zeros, as the
// padded convs do. conv_b reads that tile, conv_c and the shortcut finish
// the band. Every thread owns a few positions x 16 channels in registers
// and runs CUDA-core FMAs; weights stream through the L1 cache.
#include "common.cuh"

namespace {

constexpr int HW = 55;                 // plane side
constexpr int P = 64;                  // planes
constexpr int OUT_C = 4 * P;           // 256
constexpr int BR = 5;                  // output rows per CTA (55 = 11 bands)
constexpr int YA_R = BR + 2, YA_C = HW + 2;
constexpr int STRIDE = P + 4;          // padded position stride in shared memory
constexpr int MA = YA_R * HW;          // conv_a positions (halo rows included)
constexpr int MB = BR * HW;            // output positions
constexpr int THREADS = 256;
constexpr int MPA = (MA + 63) / 64;    // positions per thread, conv_a
constexpr int MPB = (MB + 63) / 64;    // positions per thread, conv_b / conv_c
constexpr int YA_FLOATS = YA_R * YA_C * STRIDE;
constexpr int YB_FLOATS = MB * STRIDE;
constexpr int SMEM_BYTES = (YA_FLOATS + YB_FLOATS) * static_cast<int>(sizeof(float));

template <int M>
__device__ __forceinline__ void zero_acc(float (&acc)[M][16]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[i][n] = 0.f;
}

// acc[i][n] += sum_kk a[i].kk * w[(k + kk) * ldw + n] for the 4 rows k..k+3
template <int M>
__device__ __forceinline__ void fma4(float (&acc)[M][16], const float4 (&a)[M],
                                     const float* __restrict__ w, int ldw) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float wv[16];
    adv::load16(w + kk * ldw, wv);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float av = adv::get(a[i], kk);
#pragma unroll
      for (int n = 0; n < 16; ++n) acc[i][n] = fmaf(av, wv[n], acc[i][n]);
    }
  }
}

template <typename T, bool PROJ>
__global__ void __launch_bounds__(THREADS, 1) bottleneck_kernel(
    const T* __restrict__ x, T* __restrict__ out, const float* __restrict__ wa,
    const float* __restrict__ wb, const float* __restrict__ wc, const float* __restrict__ wp,
    const float* __restrict__ sa, const float* __restrict__ ba, const float* __restrict__ sb,
    const float* __restrict__ bb, const float* __restrict__ sc, const float* __restrict__ bc,
    const float* __restrict__ sp, const float* __restrict__ bp, int frames, int cin) {
  extern __shared__ __align__(16) float smem[];
  float* ya = smem;              // [YA_R][YA_C][STRIDE], local row 0 = plane row h0 - 1
  float* yb = smem + YA_FLOATS;  // [MB][STRIDE]
  const int tid = threadIdx.x;
  const int cg = tid & 3;        // channels cg*16 .. cg*16+15 of a 64-wide group
  const int pg = tid >> 2;       // positions pg + 64*i
  const int h0 = blockIdx.x * BR;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(HW) * HW;

  // conv_b's zero padding: the left and right columns of the ya tile
  for (int e = tid; e < YA_R * 2 * P; e += THREADS) {
    const int n = e % P;
    const int side = (e / P) % 2;
    const int lr = e / (2 * P);
    ya[(lr * YA_C + (side ? YA_C - 1 : 0)) * STRIDE + n] = 0.f;
  }

  // ---- conv_a + BN + ReLU over the band and its halo rows -> ya
  {
    int xoff[MPA];
    bool ok[MPA];
#pragma unroll
    for (int i = 0; i < MPA; ++i) {
      const int m = pg + 64 * i;
      const int h = h0 - 1 + m / HW;
      ok[i] = m < MA && h >= 0 && h < HW;
      xoff[i] = ok[i] ? (h * HW + m % HW) * cin : 0;
    }
    float acc[MPA][16];
    zero_acc(acc);
    for (int dt = 0; dt < 3; ++dt) {
      const int f = t + dt - 1;
      if (f < 0 || f >= frames) continue;  // temporal zero padding
      const T* xf = x + (static_cast<size_t>(b) * frames + f) * plane * cin;
      const float* w = wa + static_cast<size_t>(dt) * cin * P + cg * 16;
      for (int ci = 0; ci < cin; ci += 4) {
        float4 a[MPA];
#pragma unroll
        for (int i = 0; i < MPA; ++i)
          a[i] = ok[i] ? adv::load4(xf + xoff[i] + ci) : make_float4(0.f, 0.f, 0.f, 0.f);
        fma4(acc, a, w + ci * P, P);
      }
    }
#pragma unroll
    for (int i = 0; i < MPA; ++i) {
      const int m = pg + 64 * i;
      if (m >= MA) continue;
      float* dst = ya + ((m / HW) * YA_C + m % HW + 1) * STRIDE + cg * 16;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int co = cg * 16 + n;
        const float y = fmaxf(__fadd_rn(__fmul_rn(acc[i][n], sa[co]), ba[co]), 0.f);
        dst[n] = ok[i] ? adv::round_to<T>(y) : 0.f;  // rows outside the plane are padding
      }
    }
  }
  __syncthreads();

  int bpos[MPB];
  bool bok[MPB];
#pragma unroll
  for (int i = 0; i < MPB; ++i) {
    const int m = pg + 64 * i;
    bok[i] = m < MB;
    bpos[i] = bok[i] ? m : 0;
  }

  // ---- conv_b (3x3, pad 1) + BN + ReLU -> yb
  {
    float acc[MPB][16];
    zero_acc(acc);
    for (int tap = 0; tap < 9; ++tap) {
      const int kh = tap / 3, kw = tap % 3;
      const float* w = wb + tap * P * P + cg * 16;
      int src[MPB];
#pragma unroll
      for (int i = 0; i < MPB; ++i)
        src[i] = ((bpos[i] / HW + kh) * YA_C + bpos[i] % HW + kw) * STRIDE;
      for (int ci = 0; ci < P; ci += 4) {
        float4 a[MPB];
#pragma unroll
        for (int i = 0; i < MPB; ++i)
          a[i] = *reinterpret_cast<const float4*>(ya + src[i] + ci);
        fma4(acc, a, w + ci * P, P);
      }
    }
#pragma unroll
    for (int i = 0; i < MPB; ++i) {
      if (!bok[i]) continue;
      float* dst = yb + bpos[i] * STRIDE + cg * 16;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int co = cg * 16 + n;
        dst[n] = adv::round_to<T>(fmaxf(__fadd_rn(__fmul_rn(acc[i][n], sb[co]), bb[co]), 0.f));
      }
    }
  }
  __syncthreads();

  // ---- conv_c + BN, shortcut, add, ReLU -> out, 64 output channels at a time
  const T* xt = x + (static_cast<size_t>(b) * frames + t) * plane * cin;
  T* ot = out + (static_cast<size_t>(b) * frames + t) * plane * OUT_C;
  int gpos[MPB];  // position inside the plane
#pragma unroll
  for (int i = 0; i < MPB; ++i) gpos[i] = (h0 + bpos[i] / HW) * HW + bpos[i] % HW;

  for (int nq = 0; nq < OUT_C / P; ++nq) {
    const int n0 = nq * P + cg * 16;
    float accz[MPB][16];
    zero_acc(accz);
    for (int ci = 0; ci < P; ci += 4) {
      float4 a[MPB];
#pragma unroll
      for (int i = 0; i < MPB; ++i) a[i] = *reinterpret_cast<const float4*>(yb + bpos[i] * STRIDE + ci);
      fma4(accz, a, wc + ci * OUT_C + n0, OUT_C);
    }
    float accr[PROJ ? MPB : 1][16];
    if (PROJ) {
      zero_acc(accr);
      for (int ci = 0; ci < cin; ci += 4) {
        float4 a[PROJ ? MPB : 1];
#pragma unroll
        for (int i = 0; i < (PROJ ? MPB : 1); ++i)
          a[i] = bok[i] ? adv::load4(xt + static_cast<size_t>(gpos[i]) * cin + ci)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        fma4(accr, a, wp + ci * OUT_C + n0, OUT_C);
      }
    }
#pragma unroll
    for (int i = 0; i < MPB; ++i) {
      if (!bok[i]) continue;
      T* dst = ot + static_cast<size_t>(gpos[i]) * OUT_C + n0;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int co = n0 + n;
        const float z = __fadd_rn(__fmul_rn(accz[i][n], sc[co]), bc[co]);
        float r;
        if (PROJ) {
          r = __fadd_rn(__fmul_rn(accr[PROJ ? i : 0][n], sp[co]), bp[co]);
        } else {
          r = adv::to_float(xt[static_cast<size_t>(gpos[i]) * cin + co]);
        }
        dst[n] = adv::from_float<T>(fmaxf(__fadd_rn(z, r), 0.f));
      }
    }
  }
}

template <typename T, bool PROJ>
int launch(const void* x, void* out, const float* wa, const float* wb, const float* wc,
           const float* wp, const float* sa, const float* ba, const float* sb, const float* bb,
           const float* sc, const float* bc, const float* sp, const float* bp, int batch,
           int frames, int cin, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<T, PROJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(HW / BR, frames, batch);
  bottleneck_kernel<T, PROJ><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), wa, wb, wc, wp, sa, ba, sb, bb, sc, bc,
      sp, bp, frames, cin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int adv_bottleneck(const void* x, void* out, const float* wa, const float* wb,
                              const float* wc, const float* wp, const float* sa,
                              const float* ba, const float* sb, const float* bb,
                              const float* sc, const float* bc, const float* sp,
                              const float* bp, int bf16, int batch, int frames, int cin,
                              int has_proj, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (has_proj)
      return launch<__nv_bfloat16, true>(x, out, wa, wb, wc, wp, sa, ba, sb, bb, sc, bc, sp, bp,
                                         batch, frames, cin, s);
    return launch<__nv_bfloat16, false>(x, out, wa, wb, wc, wp, sa, ba, sb, bb, sc, bc, sp, bp,
                                        batch, frames, cin, s);
  }
  if (has_proj)
    return launch<float, true>(x, out, wa, wb, wc, wp, sa, ba, sb, bb, sc, bc, sp, bp, batch,
                               frames, cin, s);
  return launch<float, false>(x, out, wa, wb, wc, wp, sa, ba, sb, bb, sc, bc, sp, bp, batch,
                              frames, cin, s);
}
