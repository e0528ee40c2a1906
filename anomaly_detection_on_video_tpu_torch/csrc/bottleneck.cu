// K3: one i3res50 stage-1 bottleneck block in one launch.
//
// Replaces bottleneck_block (anomaly_detection_on_video_tpu/ops/pallas/
// bottleneck.py:176): conv_a k(3,1,1) pad 1 (a k(1,1,1) conv arrives
// zero-padded to three taps) + BN + ReLU; conv_b k(1,3,3) pad 1 + BN + ReLU;
// conv_c 1x1x1 + BN; optional 1x1x1 projection + BN on the shortcut;
// residual add; ReLU. BN arrives folded to float32 affines.
// x (B, T, 55, 55, Cin) -> out (B, T, 55, 55, 256), channels last, float32
// or bfloat16 in memory, float32 accumulation; in bfloat16 mode the two
// intermediates are rounded to bfloat16 as the reference block rounds them.
//
// Bound: memory at large batch (the 256-channel activations in and out,
// about 3 GB per block at B = 240, dominate); conv_a holds most of the
// operations (about 260 GFLOP for the three blocks at B = 40). Both modes
// take one CTA per (clip, frame, band of 5 output rows) and keep both
// 64-channel intermediates in shared memory, as the TPU kernel keeps them
// in VMEM: conv_a is computed for the band plus a one-row halo above and
// below into a zero-framed (7, 57, 64) tile whose frame is conv_b's zero
// padding (rows outside the plane store zeros, not ReLU(bias); frames
// outside the clip are skipped taps), conv_b fills a second tile, and
// conv_c with the shortcut finishes the band.
//
// bfloat16 mode (bottleneck_kernel_bf16): the four products run on the
// tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32 fed by ldmatrix.
// wgmma needs 64-row tiles of one shared-memory layout, while conv_b's A
// operand is an implicit im2col of the ya tile (each fragment row is a
// shifted position, which ldmatrix gathers row by row) and the bands have
// 385 and 275 positions; so every product is mma.sync, the 16 warps split
// 8 x 2 over 16-row tiles and 32 of the 64 output channels. Intermediates
// stay in shared memory as bfloat16, positions padded to 144 bytes so that
// the 8 rows of an ldmatrix hit distinct banks. conv_a streams its input
// in K chunks of 64 channels (385 positions, halo rows zero-filled) and its
// weights through a double-buffered cp.async ring; conv_b's and conv_c's
// weights arrive by cp.async while conv_a's epilogue runs, and the
// shortcut's input (the projection's, or the identity's next 64 channels)
// while the previous output chunk is written. The output is staged 64
// channels at a time and written as 16-byte vectors. Weights arrive as
// bf16 (out, in) matrices, K contiguous per output channel: wa (3, 64,
// Cin), wb (64, 9*64) with columns (kh, kw, in), wc (256, 64), wp (256,
// Cin); Cin is 64 with a projection and 256 without.
//
// float32 mode (bottleneck_kernel_f32): tensor cores would take float32
// as TF32, which keeps about three decimal digits: it would break the
// float32 tolerance (atol 1e-4) and the port's rule that TF32 stays off.
// So it keeps CUDA-core FMAs: every thread owns a few positions x 16
// channels, weights are float32 (in, out) matrices, wa (3, Cin, 64), wb
// (9, 64, 64) with rows (kh, kw, in), wc (64, 256), wp (Cin, 256),
// streamed through L1.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using adv::sm90::cp_async16;
using adv::sm90::cp_async_commit;
using adv::sm90::cp_async_wait;
using adv::sm90::smem_addr;

constexpr int HW = 55;                 // plane side
constexpr int P = 64;                  // planes
constexpr int OUT_C = 4 * P;           // 256
constexpr int BR = 5;                  // output rows per CTA (55 = 11 bands)
constexpr int YA_R = BR + 2, YA_C = HW + 2;
constexpr int MA = YA_R * HW;          // conv_a positions (halo rows included)
constexpr int MB = BR * HW;            // output positions
constexpr int THREADS = 256;

// ---------------------------------------------------------------- float32

constexpr int STRIDE = P + 4;          // padded position stride in shared memory (floats)
constexpr int MPA = (MA + 63) / 64;    // positions per thread, conv_a
constexpr int MPB = (MB + 63) / 64;    // positions per thread, conv_b / conv_c
constexpr int YA_FLOATS = YA_R * YA_C * STRIDE;
constexpr int YB_FLOATS = MB * STRIDE;
constexpr int F32_SMEM = (YA_FLOATS + YB_FLOATS) * static_cast<int>(sizeof(float));

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

template <bool PROJ>
__global__ void __launch_bounds__(THREADS, 1) bottleneck_kernel_f32(
    const float* __restrict__ x, float* __restrict__ out, const float* __restrict__ wa,
    const float* __restrict__ wb, const float* __restrict__ wc, const float* __restrict__ wp,
    const float* __restrict__ sa, const float* __restrict__ ba, const float* __restrict__ sb,
    const float* __restrict__ bb, const float* __restrict__ sc, const float* __restrict__ bc,
    const float* __restrict__ sp, const float* __restrict__ bp, int frames, int cin) {
  extern __shared__ __align__(16) float f32_smem[];
  float* ya = f32_smem;              // [YA_R][YA_C][STRIDE], local row 0 = plane row h0 - 1
  float* yb = f32_smem + YA_FLOATS;  // [MB][STRIDE]
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
      const float* xf = x + (static_cast<size_t>(b) * frames + f) * plane * cin;
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
        dst[n] = ok[i] ? y : 0.f;  // rows outside the plane are padding
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
        dst[n] = fmaxf(__fadd_rn(__fmul_rn(acc[i][n], sb[co]), bb[co]), 0.f);
      }
    }
  }
  __syncthreads();

  // ---- conv_c + BN, shortcut, add, ReLU -> out, 64 output channels at a time
  const float* xt = x + (static_cast<size_t>(b) * frames + t) * plane * cin;
  float* ot = out + (static_cast<size_t>(b) * frames + t) * plane * OUT_C;
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
      for (int i = 0; i < MPB; ++i)
        a[i] = *reinterpret_cast<const float4*>(yb + bpos[i] * STRIDE + ci);
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
      float* dst = ot + static_cast<size_t>(gpos[i]) * OUT_C + n0;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int co = n0 + n;
        const float z = __fadd_rn(__fmul_rn(accz[i][n], sc[co]), bc[co]);
        float r;
        if (PROJ) {
          r = __fadd_rn(__fmul_rn(accr[PROJ ? i : 0][n], sp[co]), bp[co]);
        } else {
          r = xt[static_cast<size_t>(gpos[i]) * cin + co];
        }
        dst[n] = fmaxf(__fadd_rn(z, r), 0.f);
      }
    }
  }
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int PITCH = 144;               // bytes per position of a 64-channel tile (128 + 16)
constexpr int KC = 64;                   // conv_a channels per K chunk
constexpr int XPITCH = KC * 2 + 16;      // bytes per row of a conv_a chunk
constexpr int STAGES = 2;                // conv_a ring: chunk c + 1 loads while c computes
constexpr int WB_PITCH = 9 * P * 2 + 16; // bytes per output channel of wb
constexpr int MT_A = (MA + 15) / 16;     // 16-row tiles: 25 for conv_a
constexpr int MT_B = (MB + 15) / 16;     // 18 for conv_b, conv_c and the projection
constexpr int TC_THREADS = 512;          // 16 warps: 8 row groups x 2 channel halves
constexpr int MG = TC_THREADS / 64;      // row groups; group wm owns tiles wm, wm + MG, ...
constexpr int IA = (MT_A + MG - 1) / MG; // tiles per warp
constexpr int IB = (MT_B + MG - 1) / MG;
constexpr int YA_BYTES = YA_R * YA_C * PITCH;
constexpr int YB_BYTES = MB * PITCH;
constexpr int XS_BYTES = MA * XPITCH;
constexpr int STAGE_BYTES = XS_BYTES + P * XPITCH;
constexpr int WC_BYTES = OUT_C * PITCH;  // wc or wp (Cin 64), (256, 64) at PITCH
constexpr int WB_BYTES = P * WB_PITCH;
// The staging region S over time: conv_a's ring; then wc at 0 and wb after
// it; then wc, wp and the output tile (the shortcut's input goes to ya).
constexpr int OSTG = 2 * WC_BYTES;
constexpr int S_BYTES = STAGES * STAGE_BYTES > OSTG + YB_BYTES ? STAGES * STAGE_BYTES
                                                                : OSTG + YB_BYTES;
constexpr int BF16_SMEM = YA_BYTES + YB_BYTES + S_BYTES;
static_assert(WC_BYTES + WB_BYTES <= S_BYTES, "S too small");
static_assert(BF16_SMEM <= 232448, "more shared memory than a CTA may have");
static_assert(YB_BYTES <= YA_BYTES, "the projection input must fit the ya region");

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of this warp's tiles: acc[i] (16 rows x 32 channels) +=
// A (rows at a + arow[i]) . B (32 output-channel rows at b, K contiguous,
// `bpitch` bytes apart). arow[i] and b already hold this lane's ldmatrix
// row and 16-byte half; n_tiles of the I tiles are real.
template <int I>
__device__ __forceinline__ void k16(float (&acc)[I][4][4], const uint8_t* a, const int (&arow)[I],
                                    int n_tiles, const uint8_t* b, int bpitch) {
  uint32_t b01[4], b23[4];
  ldsm_x4(b01, b);
  ldsm_x4(b23, b + 16 * bpitch);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    if (i < n_tiles) {
      uint32_t af[4];
      ldsm_x4(af, a + arow[i]);
      mma_bf16(acc[i][0], af, b01[0], b01[1]);
      mma_bf16(acc[i][1], af, b01[2], b01[3]);
      mma_bf16(acc[i][2], af, b23[0], b23[1]);
      mma_bf16(acc[i][3], af, b23[2], b23[3]);
    }
  }
}

template <int I>
__device__ __forceinline__ void zero_tiles(float (&acc)[I][4][4]) {
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The folded BN of one channel, in the reference's order: v * s, then + b.
__device__ __forceinline__ float affine(float v, const float* s, const float* b) {
  return __fadd_rn(__fmul_rn(v, __ldg(s)), __ldg(b));
}

__device__ __forceinline__ void store_bf16x2(uint8_t* dst, float y0, float y1) {
  __nv_bfloat162 p;
  p.x = __float2bfloat16_rn(y0);
  p.y = __float2bfloat16_rn(y1);
  *reinterpret_cast<__nv_bfloat162*>(dst) = p;
}

// cp.async `rows` rows of `row_bytes` (a multiple of 16) from global rows
// `src_stride` elements apart into shared rows `pitch` bytes apart.
__device__ __forceinline__ void copy_rows(uint8_t* dst, int pitch, const bf16* src,
                                          size_t src_stride, int rows, int row_bytes) {
  const int vpr = row_bytes / 16;
  for (int v = threadIdx.x; v < rows * vpr; v += TC_THREADS) {
    const int r = v / vpr, q = v % vpr;
    cp_async16(dst + r * pitch + q * 16, src + r * src_stride + q * 8, true);
  }
}

template <bool PROJ>
__global__ void __launch_bounds__(TC_THREADS, 1) bottleneck_kernel_bf16(
    const bf16* __restrict__ x, bf16* __restrict__ out, const bf16* __restrict__ wa,
    const bf16* __restrict__ wb, const bf16* __restrict__ wc, const bf16* __restrict__ wp,
    const float* __restrict__ sa, const float* __restrict__ ba, const float* __restrict__ sb,
    const float* __restrict__ bb, const float* __restrict__ sc, const float* __restrict__ bc,
    const float* __restrict__ sp, const float* __restrict__ bp, int frames, int cin) {
  extern __shared__ __align__(16) uint8_t bf16_smem[];
  uint8_t* ya = bf16_smem;             // [YA_R][YA_C] positions x 64 bf16; row 0 = plane row h0 - 1
  uint8_t* yb = bf16_smem + YA_BYTES;  // [MB] positions x 64 bf16
  uint8_t* S = yb + YB_BYTES;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wn = warp & 1;             // output channels 32*wn .. 32*wn+31 of 64
  const int wm = warp >> 1;            // row tiles wm, wm + MG, ...
  const int h0 = blockIdx.x * BR;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const size_t plane = static_cast<size_t>(HW) * HW;
  const bf16* xt = x + (static_cast<size_t>(b) * frames + t) * plane * cin;
  // this lane's ldmatrix offsets: A rows lane%16, 16-byte half lane/16;
  // B rows (lane%8) + 8*(lane/16), half (lane/8)%2
  const int a_half = (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) << 3);
  const int b_half = ((lane >> 3) & 1) * 16;
  const int g = lane >> 2, q2 = 2 * (lane & 3);  // accumulator row and column pair

  // conv_b's zero padding: the left and right columns of the ya tile
  if (tid < YA_R * 2 * 8) {
    const int lr = tid / 16, side = (tid / 8) % 2, v = tid % 8;
    *reinterpret_cast<int4*>(ya + (lr * YA_C + (side ? YA_C - 1 : 0)) * PITCH + v * 16) =
        make_int4(0, 0, 0, 0);
  }

  // ---- conv_a + BN + ReLU over the band and its halo rows -> ya
  {
    const int dt0 = t == 0 ? 1 : 0;                // taps on frames inside the clip
    const int dt1 = t == frames - 1 ? 1 : 2;
    const int per_tap = cin / KC;
    const int chunks = (dt1 - dt0 + 1) * per_tap;
    auto load_chunk = [&](int c) {
      uint8_t* st = S + (c % STAGES) * STAGE_BYTES;
      const int dt = dt0 + c / per_tap;
      const int ci0 = (c % per_tap) * KC;
      const bf16* xf = x + (static_cast<size_t>(b) * frames + t + dt - 1) * plane * cin + ci0;
      for (int v = tid; v < MA * (KC / 8); v += TC_THREADS) {
        const int m = v / (KC / 8), q = v % (KC / 8);
        const int h = h0 - 1 + m / HW;
        const bool ok = h >= 0 && h < HW;      // halo rows outside the plane read zeros
        const bf16* src = ok ? xf + static_cast<size_t>(h * HW + m % HW) * cin + q * 8 : x;
        cp_async16(st + m * XPITCH + q * 16, src, ok);
      }
      copy_rows(st + XS_BYTES, XPITCH, wa + static_cast<size_t>(dt) * P * cin + ci0, cin, P,
                KC * 2);
    };
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
      if (c < chunks) load_chunk(c);
      cp_async_commit();
    }
    const int n_tiles = (MT_A - wm + MG - 1) / MG;
    int arow[IA];
#pragma unroll
    for (int i = 0; i < IA; ++i)
      arow[i] = min((wm + MG * i) * 16 + (lane & 15), MA - 1) * XPITCH + a_half;
    float acc[IA][4][4];
    zero_tiles(acc);
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk c has landed; chunk c - 1's stage is free
      if (c + STAGES - 1 < chunks) load_chunk(c + STAGES - 1);
      cp_async_commit();
      const uint8_t* st = S + (c % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        k16(acc, st + kk * 32, arow, n_tiles, st + XS_BYTES + b_row * XPITCH + b_half + kk * 32,
            XPITCH);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: bring in wc and wb while the epilogue runs
    copy_rows(S, PITCH, wc, P, OUT_C, P * 2);
    copy_rows(S + WC_BYTES, WB_PITCH, wb, 9 * P, P, 9 * P * 2);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < IA; ++i) {
      if (i >= n_tiles) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = (wm + MG * i) * 16 + g + 8 * hh;
        if (m >= MA) continue;
        const int lr = m / HW, col = m % HW;
        const int h = h0 - 1 + lr;
        const bool ok = h >= 0 && h < HW;
        uint8_t* dst = ya + (lr * YA_C + col + 1) * PITCH;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 32 + j * 8 + q2;
          float y0 = fmaxf(affine(acc[i][j][2 * hh], sa + n, ba + n), 0.f);
          float y1 = fmaxf(affine(acc[i][j][2 * hh + 1], sa + n + 1, ba + n + 1), 0.f);
          if (!ok) y0 = y1 = 0.f;  // rows outside the plane are padding
          store_bf16x2(dst + n * 2, y0, y1);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  const int nb_tiles = (MT_B - wm + MG - 1) / MG;
  int brow[IB];  // output position of this lane's A row for each tile
#pragma unroll
  for (int i = 0; i < IB; ++i) brow[i] = min((wm + MG * i) * 16 + (lane & 15), MB - 1);

  // ---- conv_b (3x3, pad 1) + BN + ReLU -> yb
  {
    int arow[IB];
#pragma unroll
    for (int i = 0; i < IB; ++i)
      arow[i] = ((brow[i] / HW) * YA_C + brow[i] % HW) * PITCH + a_half;
    float acc[IB][4][4];
    zero_tiles(acc);
    const uint8_t* wbs = S + WC_BYTES + b_row * WB_PITCH + b_half;
    for (int tap = 0; tap < 9; ++tap) {
      const uint8_t* a = ya + ((tap / 3) * YA_C + tap % 3) * PITCH;
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        k16(acc, a + kk * 32, arow, nb_tiles, wbs + (tap * P + kk * 16) * 2, WB_PITCH);
    }
#pragma unroll
    for (int i = 0; i < IB; ++i) {
      if (i >= nb_tiles) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = (wm + MG * i) * 16 + g + 8 * hh;
        if (m >= MB) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 32 + j * 8 + q2;
          store_bf16x2(yb + m * PITCH + n * 2,
                       fmaxf(affine(acc[i][j][2 * hh], sb + n, bb + n), 0.f),
                       fmaxf(affine(acc[i][j][2 * hh + 1], sb + n + 1, bb + n + 1), 0.f));
        }
      }
    }
  }
  __syncthreads();

  // ---- conv_c + BN, shortcut, add, ReLU -> out, 64 output channels at a time
  // xs (in the ya region): channels 64*nq .. 64*nq+63 of the band of frame t,
  // the projection's whole input (Cin = 64) or the identity shortcut's chunk
  uint8_t* xs = ya;
  auto load_shortcut = [&](int nq) {
    for (int v = tid; v < MB * 8; v += TC_THREADS) {
      const int m = v >> 3, q = v & 7;
      cp_async16(xs + m * PITCH + q * 16,
                 xt + static_cast<size_t>((h0 + m / HW) * HW + m % HW) * cin + nq * P + q * 8,
                 true);
    }
    cp_async_commit();
  };
  if (PROJ) copy_rows(S + WC_BYTES, PITCH, wp, P, OUT_C, P * 2);
  load_shortcut(0);
  int arow[IB];
#pragma unroll
  for (int i = 0; i < IB; ++i) arow[i] = brow[i] * PITCH + a_half;
  uint8_t* ostg = S + OSTG;
  bf16* ot = out + (static_cast<size_t>(b) * frames + t) * plane * OUT_C;
  for (int nq = 0; nq < OUT_C / P; ++nq) {
    if (nq == 0 || !PROJ) {
      cp_async_wait<0>();
      __syncthreads();  // this chunk's shortcut (and wp) has landed
    }
    const int wrow = (nq * P + b_row) * PITCH + b_half;
    float accz[IB][4][4];
    zero_tiles(accz);
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      k16(accz, yb + kk * 32, arow, nb_tiles, S + wrow + kk * 32, PITCH);
    float accr[PROJ ? IB : 1][4][4];
    if constexpr (PROJ) {
      zero_tiles(accr);
#pragma unroll
      for (int kk = 0; kk < P / 16; ++kk)
        k16(accr, xs + kk * 32, arow, nb_tiles, S + WC_BYTES + wrow + kk * 32, PITCH);
    }
#pragma unroll
    for (int i = 0; i < IB; ++i) {
      if (i >= nb_tiles) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = (wm + MG * i) * 16 + g + 8 * hh;
        if (m >= MB) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = wn * 32 + j * 8 + q2;
          const int co = nq * P + n;
          float r[2], y[2];
          if constexpr (PROJ) {
            r[0] = affine(accr[i][j][2 * hh], sp + co, bp + co);
            r[1] = affine(accr[i][j][2 * hh + 1], sp + co + 1, bp + co + 1);
          } else {
            const __nv_bfloat162 x2 =
                *reinterpret_cast<const __nv_bfloat162*>(xs + m * PITCH + n * 2);
            r[0] = __bfloat162float(x2.x);
            r[1] = __bfloat162float(x2.y);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
            y[e] = fmaxf(__fadd_rn(affine(accz[i][j][2 * hh + e], sc + co + e, bc + co + e), r[e]),
                         0.f);
          store_bf16x2(ostg + m * PITCH + n * 2, y[0], y[1]);
        }
      }
    }
    __syncthreads();  // the output chunk is staged and the shortcut chunk read
    if (!PROJ && nq + 1 < OUT_C / P) load_shortcut(nq + 1);
    for (int v = tid; v < MB * 8; v += TC_THREADS) {
      const int m = v >> 3, q = v & 7;
      const size_t gpos = static_cast<size_t>((h0 + m / HW) * HW + m % HW);
      *reinterpret_cast<int4*>(ot + gpos * OUT_C + nq * P + q * 8) =
          *reinterpret_cast<const int4*>(ostg + m * PITCH + q * 16);
    }
    __syncthreads();
  }
}

// Weights and activations share the type T.
template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, int smem_bytes, const void* x, void* out, const void* wa,
           const void* wb, const void* wc, const void* wp, const float* sa, const float* ba,
           const float* sb, const float* bb, const float* sc, const float* bc, const float* sp,
           const float* bp, int batch, int frames, int cin, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(HW / BR, frames, batch);
  kernel<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(wa),
      static_cast<const T*>(wb), static_cast<const T*>(wc), static_cast<const T*>(wp), sa, ba, sb,
      bb, sc, bc, sp, bp, frames, cin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is_bf16 = 1: x, out and the weights are bfloat16 in the tensor-core layout
// (Cin 64 with a projection, 256 without); is_bf16 = 0: float32 throughout.
extern "C" int adv_bottleneck(const void* x, void* out, const void* wa, const void* wb,
                              const void* wc, const void* wp, const float* sa,
                              const float* ba, const float* sb, const float* bb,
                              const float* sc, const float* bc, const float* sp,
                              const float* bp, int is_bf16, int batch, int frames, int cin,
                              int has_proj, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (cin != (has_proj ? P : OUT_C)) return static_cast<int>(cudaErrorInvalidValue);
    return launch<bf16>(has_proj ? bottleneck_kernel_bf16<true> : bottleneck_kernel_bf16<false>,
                        TC_THREADS, BF16_SMEM, x, out, wa, wb, wc, wp, sa, ba, sb, bb, sc, bc, sp,
                        bp, batch, frames, cin, s);
  }
  return launch<float>(has_proj ? bottleneck_kernel_f32<true> : bottleneck_kernel_f32<false>,
                       THREADS, F32_SMEM, x, out, wa, wb, wc, wp, sa, ba, sb, bb, sc, bc, sp, bp,
                       batch, frames, cin, s);
}
