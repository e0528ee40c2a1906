// K2: the i3res50 stem, conv + folded BN + ReLU + max pool in one kernel.
//
// Replaces stem_conv_pool_h (anomaly_detection_on_video_tpu/ops/pallas/
// stem.py:150) together with its XLA tail stem_pool_w (:188):
// Conv3d 3->64 k(5,7,7) s(2,2,2) p(2,3,3), BN folded to a float32 affine,
// ReLU, MaxPool3d k(2,3,3) s(2,2,2) without padding.
// x (B, 16, 224, 224, 3) -> out (B, 4, 55, 55, 64), float32 or bfloat16 in
// memory, float32 accumulation.
//
// Bound: operations (about 9.4 GFLOP of conv per clip against 0.6 MB of
// pixels read; at B = 40 about 0.34 ms on the bf16 tensor cores). Both
// modes take one CTA per (clip, pooled frame u, 4x8 tile of pooled
// positions). A CTA computes the 2 x 9 x 17 stem positions that tile's
// pool windows cover (neighbouring windows share one stem row and column,
// so a tile recomputes about 1.2x the stem outputs it owns), applies the
// affine and ReLU, parks the stem tile in shared memory and pools it, so
// only the pooled tensor reaches device memory.
//
// bfloat16 mode (stem_kernel_bf16): mma.sync m16n8k16 bf16 -> f32 fed by
// ldmatrix. The contraction runs over (kt, c) inside each (kh, kw) tap:
// 5 temporal taps x 3 channels, padded to 16, are one k16 step, so the 49
// spatial taps give K = 784. Pooled frame u needs input frames 4u-2 ..
// 4u+4; the CTA stages them once as one vector per input pixel,
// [j][16] bf16 with j the stem frame 2u+j of the pool pair (j = 0 holds
// relative frames 0-4, j = 1 frames 2-6, element 15 zero). Every A row
// (stem position, tap) is then 16 contiguous bf16 at a 16-byte aligned
// address that ldmatrix reads directly. The slab splits even and odd
// input columns and pads a pixel to 80 bytes, so the 8 rows of an
// ldmatrix (stem columns 2 pixels apart) fall on distinct banks. The slab
// is loaded as 4-byte words along each input row (two pixels, 12 bytes)
// and transposed in registers into the pixel vectors. The weights are one
// bf16 (64, 784) matrix, K contiguous per output channel, rows (kh, kw,
// [kt, c] padded to 16); both j use it. They stream through a
// double-buffered cp.async ring, one kh row of 7 taps (15 KB) at a time,
// so the CTA needs 102 KB and two CTAs share an SM. Eight warps split the
// 320-row (306 real) product 4 x 2: five 16-row tiles x 32 channels each.
// Wgmma is not used: its A operand would need the 64-row tiles of one
// shared-memory layout, while here each fragment row is a gathered pixel
// address (an implicit im2col), which ldmatrix reads row by row.
//
// float32 mode (stem_kernel_f32): tensor cores would take float32 as TF32
// (about three decimal digits) and break the float32 tolerance (atol
// 1e-4), so it stays on CUDA-core FMAs: each temporal tap stages the
// input slab and a (147, 64) float32 weight slice in shared memory, and
// each thread accumulates 5 positions x 16 channels in registers. Weights
// arrive as float32 (735, 64) rows ordered (kt, kh, kw, c).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using adv::sm90::cp_async16;
using adv::sm90::cp_async_commit;
using adv::sm90::cp_async_wait;
using adv::sm90::smem_addr;

constexpr int IN_T = 16, IN_H = 224, IN_W = 224, IN_C = 3, CO = 64;
constexpr int KT = 5, KH = 7, KW = 7;
constexpr int POOL_T = 4, POOL_HW = 55;
constexpr int TPH = 4, TPW = 8;                 // pooled rows / cols per CTA
constexpr int SR = 2 * TPH + 1, SC = 2 * TPW + 1;  // stem rows / cols per CTA
constexpr int NPOS = 2 * SR * SC;               // stem positions (2 stem frames)
constexpr int THREADS = 256;
constexpr int IR = 2 * (SR - 1) + KH;           // input rows per CTA
constexpr int IC = 2 * (SC - 1) + KW;           // input cols per CTA
constexpr int TILES_H = (POOL_HW + TPH - 1) / TPH;
constexpr int TILES_W = (POOL_HW + TPW - 1) / TPW;

// ---------------------------------------------------------------- float32

constexpr int MP = (NPOS + 63) / 64;            // positions per thread
constexpr int IN_ELEMS = 2 * IR * IC * IN_C;    // one temporal tap, both stem frames
constexpr int IN_SLOT = (IN_ELEMS + 3) / 4 * 4; // keeps s_w 16-byte aligned
constexpr int TAP_K = KH * KW * IN_C;           // 147 rows of K per temporal tap
constexpr int W_ELEMS = TAP_K * CO;
constexpr int STEM_STRIDE = CO + 1;             // padded row: fewer bank conflicts
constexpr int STEM_ELEMS = NPOS * STEM_STRIDE;
constexpr int SMEM_FLOATS = (IN_SLOT + W_ELEMS) > STEM_ELEMS ? (IN_SLOT + W_ELEMS) : STEM_ELEMS;
constexpr int F32_SMEM = SMEM_FLOATS * static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(THREADS) stem_kernel_f32(const float* __restrict__ x,
                                                           const float* __restrict__ w,
                                                           const float* __restrict__ scale,
                                                           const float* __restrict__ bias,
                                                           float* __restrict__ out) {
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
        v = x[(((static_cast<size_t>(b) * IN_T + f) * IN_H + ih) * IN_W + iw) * IN_C + c];
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
    out[(((static_cast<size_t>(b) * POOL_T + u) * POOL_HW + prow) * POOL_HW + pcol) * CO + co] = m;
  }
}

// --------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

constexpr int REL_T = 7;                        // input frames 4u-2 .. 4u+4
constexpr int VEC = 16;                         // [kt, c] of one tap, padded: one k16 step
constexpr int PIX = 2 * VEC * 2 + 16;           // bytes per slab pixel: [j][16] bf16 + pad
constexpr int SLAB_Q = (IC + 1 + 1) / 2;        // pixels per column parity (40 columns)
constexpr int SLAB_ROW = 2 * SLAB_Q * PIX;      // bytes per input row: [parity][SLAB_Q]
constexpr int SLAB_BYTES = IR * SLAB_ROW;
constexpr int TAPS = KH * KW;
constexpr int K_TC = TAPS * VEC;                // 784
constexpr int WPITCH = KW * VEC * 2 + 16;       // bytes per output channel of one kh chunk
constexpr int W_CHUNK = CO * WPITCH;
constexpr int STEM_PITCH = CO * 2 + 16;         // bytes per position of the stem tile
constexpr int TC_SMEM = SLAB_BYTES + 2 * W_CHUNK;
constexpr int MT = (NPOS + 15) / 16;            // 16-row tiles: 20
constexpr int MG = 4;                           // row groups; warp (wm, wn) owns tiles wm*IT ..
constexpr int IT = MT / MG;                     // 5 tiles per warp
static_assert(MT % MG == 0, "row tiles split evenly");
static_assert(NPOS * STEM_PITCH <= SLAB_BYTES, "the stem tile reuses the slab");
static_assert(2 * TC_SMEM + 2048 <= 233472, "two CTAs share an SM");

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

__device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) { return lo | (hi << 16); }

// The 16-element vector of stem frame j for one pixel: element kt*3 + c is
// channel c of relative frame 2j + kt; element 15 is zero.
__device__ __forceinline__ void pixel_vector(const uint32_t (&v)[REL_T][IN_C], int j,
                                             uint32_t (&words)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e0 = 2 * k, e1 = 2 * k + 1;
    const uint32_t lo = v[2 * j + e0 / 3][e0 % 3];
    const uint32_t hi = e1 < KT * IN_C ? v[2 * j + e1 / 3][e1 % 3] : 0u;
    words[k] = pack2(lo, hi);
  }
}

// Both vectors of one pixel, [j][16], as four 16-byte stores.
__device__ __forceinline__ void store_pixel(const uint32_t (&v)[REL_T][IN_C], int4* dst) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t words[8];
    pixel_vector(v, j, words);
    dst[2 * j] = make_int4(words[0], words[1], words[2], words[3]);
    dst[2 * j + 1] = make_int4(words[4], words[5], words[6], words[7]);
  }
}

__global__ void __launch_bounds__(THREADS, 2) stem_kernel_bf16(const bf16* __restrict__ x,
                                                               const bf16* __restrict__ w,
                                                               const float* __restrict__ scale,
                                                               const float* __restrict__ bias,
                                                               bf16* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tc_smem[];
  uint8_t* slab = tc_smem;                  // [IR][parity][SLAB_Q][PIX]
  uint8_t* wbuf = tc_smem + SLAB_BYTES;     // 2 x [CO][WPITCH]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wn = warp & 1;                  // output channels 32*wn .. 32*wn+31
  const int wm = warp >> 1;                 // row tiles wm*IT .. wm*IT+IT-1
  const int pw0 = blockIdx.x * TPW;
  const int ph0 = blockIdx.y * TPH;
  const int b = blockIdx.z / POOL_T;
  const int u = blockIdx.z % POOL_T;
  const int ih0 = 4 * ph0 - 3;              // input row of slab row 0
  const int ic0 = 4 * pw0 - 4;              // input column of slab column 0 (even)

  // one kh row of weights (7 taps x 16 values per output channel) -> buffer
  auto load_w = [&](int kh) {
    uint8_t* dst = wbuf + (kh & 1) * W_CHUNK;
    constexpr int PIECES = KW * VEC * 2 / 16;  // 14 per output channel
    for (int v = tid; v < CO * PIECES; v += THREADS) {
      const int n = v / PIECES, q = v % PIECES;
      cp_async16(dst + n * WPITCH + q * 16, w + static_cast<size_t>(n) * K_TC + kh * KW * VEC + q * 8,
                 true);
    }
    cp_async_commit();
  };
  load_w(0);

  // the slab: two input pixels (12 bytes, three 4-byte words) per frame and
  // unit, transposed in registers into two [j][16] pixel vectors
  for (int unit = tid; unit < IR * SLAB_Q; unit += THREADS) {
    const int r = unit / SLAB_Q, pp = unit % SLAB_Q;
    const int ih = ih0 + r;
    const int iw = ic0 + 2 * pp;            // even: both pixels inside or both outside
    const bool inside = ih >= 0 && ih < IN_H && iw >= 0 && iw < IN_W;
    uint32_t v0[REL_T][IN_C], v1[REL_T][IN_C];
#pragma unroll
    for (int f = 0; f < REL_T; ++f) {
      const int frame = 4 * u - 2 + f;
      uint32_t wd[3] = {0u, 0u, 0u};
      if (inside && frame >= 0 && frame < IN_T) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            x + (((static_cast<size_t>(b) * IN_T + frame) * IN_H + ih) * IN_W + iw) * IN_C);
        wd[0] = __ldg(src);
        wd[1] = __ldg(src + 1);
        wd[2] = __ldg(src + 2);
      }
      // words: (p0c0, p0c1), (p0c2, p1c0), (p1c1, p1c2), low half first
      v0[f][0] = wd[0] & 0xFFFFu;
      v0[f][1] = wd[0] >> 16;
      v0[f][2] = wd[1] & 0xFFFFu;
      v1[f][0] = wd[1] >> 16;
      v1[f][1] = wd[2] & 0xFFFFu;
      v1[f][2] = wd[2] >> 16;
    }
    uint8_t* row = slab + r * SLAB_ROW + pp * PIX;
    store_pixel(v0, reinterpret_cast<int4*>(row));                 // even column
    store_pixel(v1, reinterpret_cast<int4*>(row + SLAB_Q * PIX));  // odd column
  }

  // this lane's ldmatrix rows: A rows lane%16 of each tile at 16-byte half
  // lane/16; B rows (lane%8) + 8*(lane/16) at half (lane/8)%2
  int arow[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    const int p = min((wm * IT + i) * 16 + (lane & 15), NPOS - 1);
    const int j = p / (SR * SC), sr = (p / SC) % SR, sc = p % SC;
    arow[i] = 2 * sr * SLAB_ROW + sc * PIX + j * VEC * 2 + (lane >> 4) * 16;
  }
  const int b_off = (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * WPITCH + ((lane >> 3) & 1) * 16;

  float acc[IT][4][4];
#pragma unroll
  for (int i = 0; i < IT; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.f;

  for (int kh = 0; kh < KH; ++kh) {
    cp_async_wait<0>();
    __syncthreads();  // chunk kh (and, at kh = 0, the slab) has landed; chunk kh-1's buffer is free
    if (kh + 1 < KH) load_w(kh + 1);
    const uint8_t* wb = wbuf + (kh & 1) * W_CHUNK + b_off;
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      // input column 2*sc + kw + 1 of the slab: parity (kw+1)%2, pixel sc + (kw+1)/2
      const int tap = kh * SLAB_ROW + ((kw + 1) & 1) * SLAB_Q * PIX + ((kw + 1) >> 1) * PIX;
      uint32_t b01[4], b23[4];
      ldsm_x4(b01, wb + kw * VEC * 2);
      ldsm_x4(b23, wb + kw * VEC * 2 + 16 * WPITCH);
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        uint32_t af[4];
        ldsm_x4(af, slab + arow[i] + tap);
        mma_bf16(acc[i][0], af, b01[0], b01[1]);
        mma_bf16(acc[i][1], af, b01[2], b01[3]);
        mma_bf16(acc[i][2], af, b23[0], b23[1]);
        mma_bf16(acc[i][3], af, b23[2], b23[3]);
      }
    }
  }
  __syncthreads();  // every read of the slab is done: it becomes the stem tile

  // affine (as the float32 mode rounds it), ReLU, bf16 -> stem tile. Rounding
  // before the pool's max gives the same bits as after it (rounding is monotonic).
  uint8_t* stem = tc_smem;  // [NPOS][STEM_PITCH]
  const int g = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    const int n = wn * 32 + jn * 8 + q2;
    const float s0 = __ldg(scale + n), s1 = __ldg(scale + n + 1);
    const float c0 = __ldg(bias + n), c1 = __ldg(bias + n + 1);
#pragma unroll
    for (int i = 0; i < IT; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = (wm * IT + i) * 16 + g + 8 * hh;
        if (m >= NPOS) continue;
        __nv_bfloat162 y;
        y.x = __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(acc[i][jn][2 * hh], s0), c0), 0.f));
        y.y = __float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(acc[i][jn][2 * hh + 1], s1), c1), 0.f));
        *reinterpret_cast<__nv_bfloat162*>(stem + m * STEM_PITCH + n * 2) = y;
      }
    }
  }
  __syncthreads();

  // pool: one thread per (pooled position, 8 channels), 16-byte loads and stores
  {
    const int cg8 = tid & 7;
    const int pos = tid >> 3;  // 0 .. 31
    const int pr = pos / TPW, pc = pos % TPW;
    const int prow = ph0 + pr, pcol = pw0 + pc;
    if (prow < POOL_HW && pcol < POOL_HW) {
      int4 mv = *reinterpret_cast<const int4*>(stem + (2 * pr * SC + 2 * pc) * STEM_PITCH + cg8 * 16);
      __nv_bfloat162* m = reinterpret_cast<__nv_bfloat162*>(&mv);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int dr = 0; dr < 3; ++dr)
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const int p = (j * SR + 2 * pr + dr) * SC + 2 * pc + dc;
            const int4 iv = *reinterpret_cast<const int4*>(stem + p * STEM_PITCH + cg8 * 16);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&iv);
#pragma unroll
            for (int e = 0; e < 4; ++e) m[e] = __hmax2(m[e], h[e]);
          }
      *reinterpret_cast<int4*>(
          out + (((static_cast<size_t>(b) * POOL_T + u) * POOL_HW + prow) * POOL_HW + pcol) * CO +
          cg8 * 8) = mv;
    }
  }
}

template <typename Kernel, typename T>
int launch(Kernel kernel, int smem, const void* x, const void* w, const float* scale,
           const float* bias, void* out, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(TILES_W, TILES_H, batch * POOL_T);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w), scale,
                                          bias, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 = 1: x, out and w are bfloat16, w the (64, 784) tensor-core operand;
// bf16 = 0: float32 throughout, w the (735, 64) operand.
extern "C" int adv_stem(const void* x, const void* w, const float* scale, const float* bias,
                        void* out, int bf16, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<decltype(&stem_kernel_bf16), __nv_bfloat16>(
      stem_kernel_bf16, TC_SMEM, x, w, scale, bias, out, batch, s);
  return launch<decltype(&stem_kernel_f32), float>(stem_kernel_f32, F32_SMEM, x, w, scale, bias,
                                                   out, batch, s);
}

// The bf16 kernel's launch shape: info = {shared bytes per CTA, threads,
// CTAs resident per SM, pooled rows per tile, pooled columns per tile}.
extern "C" int adv_stem_info(int* info) {
  cudaError_t err =
      cudaFuncSetAttribute(stem_kernel_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, stem_kernel_bf16, THREADS, TC_SMEM);
  info[0] = TC_SMEM;
  info[1] = THREADS;
  info[2] = ctas;
  info[3] = TPH;
  info[4] = TPW;
  return static_cast<int>(err);
}
