// K5: int8 3D convolution, channels last, with int32 accumulation and a
// per-output-channel float32 scale epilogue.
//
// Replaces make_conv3x3 / _conv3x3_kernel (scripts/int8_pallas_probe.py:159
// / :116): an int8 3x3 conv with zero padding whose int32 sum is multiplied
// by a per-channel float32 scale and either requantized to int8
// (clip(round(.)), round half to even) or written as bfloat16. Generalized
// from the probe's fixed (128, 28 x 28) planes to the convs of the i3res50
// int8 path: k(1,3,3) with stride 1 or 2 and k(3,1,1) over Cin % 16 == 0
// channels (any kernel, stride and padding with such Cin), and the stem's
// k(5,7,7) p(2,3,3) at stride (2,2,2) (i3res50) or (1,2,2) (i3d_8x8_r50)
// over Cin = 3 (RGB) or Cin = 2 (the flow stream's dx, dy). It also writes
// float32,
// ConvBN._int8_conv's dequantize in a float32 model. Other geometries are
// refused (the wrapper raises). x (B, T, H, W, Cin) int8 -> out
// (B, To, Ho, Wo, Cout); the epilogue converts each exact int32 sum once,
// __fmul_rn(__int2float_rn(acc), scale[n]), rounded to nearest with
// explicit intrinsics, and stages the tile through shared memory into
// 16-byte row stores. The TPU kernel's masked lane rotations answer
// Mosaic's layout rules and have no counterpart here.
//
// Sizes: every element offset into x, w and out is computed in size_t, so
// neither tensor is bounded by 2^31 elements (the int8 stem's output at
// B = 480 holds 3.1e9). Output positions M = B*To*Ho*Wo and the row index m
// are 32-bit ints, which bounds M below 2^31 - 128 (the wrapper checks);
// the stem's grid holds B * ceil(To / 2) planes in z, at most 65535.
//
// Bound: operations for the k(1,3,3) convs and the probe's shape, bytes for
// the k(3,1,1) convs over wide inputs and the stem (about 0.57 ms for the
// 26 convs of the int8 path at B = 40).
//
// int8_conv_kernel_c16 (Cin % 16 == 0): an implicit GEMM, M = B*To*Ho*Wo
// output positions, N = Cout, K = KT*KH*KW*Cin, weights (N, K) K-contiguous
// (ops/quant.pack_int8_weight_nk, as K4 reads them). Every 16-byte piece of
// an A row lies inside one tap, so each thread gathers its pieces with
// cp.async, zero-filled where the tap falls in the padding; B rows arrive
// the same way. Both land in a 3-4 stage ring of 128-byte K steps written
// in the 128-byte swizzle (16-byte chunk XOR row % 8), the layout wgmma's
// shared-memory descriptors read, so the loads of step k+2 (or k+3)
// overlap the products of step k. Two warpgroups each run wgmma
// m64nBNk32 s32.s8.s8 on 64 rows of a 128 x BN tile (BN = 128, or 64 when
// Cout = 64), both operands from shared memory; after each step's
// cp.async wait a proxy fence makes the generic-proxy writes visible to
// wgmma. Two CTAs share an SM. TMA is not used: the A rows are gathered
// taps (an implicit im2col) with zero padding per tap.
//
// int8_conv_kernel_stem<C, ST> (Cin = C, 3 or 2; temporal stride ST, 2 or
// 1), on mma.sync m16n8k32 s8.s8.s32 fed by ldmatrix: one CTA per (clip,
// stem frame pair, 8 x 16 output positions). It stages its input once as
// one 32-byte vector per pixel, [j][16] int8 for the two stem frames
// 2u + j, which read input frames 2u*ST - 2 + ST*j + kt (kt = 0..4): the
// CTA loads 5 + ST frames, 2u*ST - 2 .. 2u*ST + ST + 2 (7 at ST = 2, 6 at
// ST = 1), and only this frame mapping depends on ST. Element kt * C + c,
// bytes 5 * C .. 15 zero, loaded as C 4-byte words along each input row
// (four pixels of C bytes) and transposed in registers. The flow stream's
// two channels fill 10 of the 16 bytes, so its input is never padded to a
// third zero channel. One m16n8k32 K step then covers two (kh, kw) taps:
// K = 25 x 32 = 800, the 50th tap zero in the weights, which arrive as the
// (64, 800) matrix of pack_int8_conv_weight for either C. Even and odd input
// columns are split and a pixel padded to 48 bytes, so the 8 rows of an
// ldmatrix (stem columns two pixels apart) fall on distinct banks.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using adv::sm90::cp_async16;
using adv::sm90::cp_async_commit;
using adv::sm90::cp_async_wait;
using adv::sm90::smem_addr;
using adv::sm90::sw128_desc;
using adv::sm90::wgmma_commit;
using adv::sm90::wgmma_fence;
using adv::sm90::wgmma_wait;

// what the epilogue stores (the wrapper's MODES)
enum Mode { OUT_FLOAT32 = 1, OUT_BFLOAT16 = 2, OUT_INT8 = 3 };

constexpr int THREADS = 256;

template <int MODE>
struct Out {
  static constexpr int ELEM = MODE == OUT_FLOAT32 ? 4 : (MODE == OUT_BFLOAT16 ? 2 : 1);
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring columns of one accumulator row, converted and stored
// into the staging tile at dst.
template <int MODE>
__device__ __forceinline__ void stage2(uint8_t* dst, int a0, int a1, float s0, float s1) {
  const float y0 = __fmul_rn(__int2float_rn(a0), s0);
  const float y1 = __fmul_rn(__int2float_rn(a1), s1);
  if constexpr (MODE == OUT_FLOAT32) {
    *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
  } else if constexpr (MODE == OUT_BFLOAT16) {
    __nv_bfloat162 p;
    p.x = __float2bfloat16_rn(y0);
    p.y = __float2bfloat16_rn(y1);
    *reinterpret_cast<__nv_bfloat162*>(dst) = p;
  } else {
    const int q0 = min(max(__float2int_rn(y0), -127), 127);
    const int q1 = min(max(__float2int_rn(y1), -127), 127);
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
  }
}

// ------------------------------------------------------ Cin % 16 == 0

struct Geometry {
  int B, T, H, W, Cin, Cout;
  int KT, KH, KW, ST, SH, SW, PT, PH, PW;
  int To, Ho, Wo;
};

constexpr int BM = 128;  // rows per tile: 64 per consumer warpgroup
constexpr int BK = 128;  // bytes of K per stage: one 128-byte swizzle row, 8 chunks of 16

template <int BN>
struct C16 {
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int SMEM = RING + 1024;  // + slack to align the ring to 1024 bytes
  static_assert(BM * (BN * 4 + 16) <= RING, "the float32 staging tile fits the ring");
  static_assert(2 * SMEM + 2048 <= 233472, "two CTAs share an SM");
};

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows, in
// the 128-byte swizzle that TMA writes and wgmma's descriptors read
// (chunk index XOR row % 8; the tile starts on a 1024-byte boundary).
__device__ __forceinline__ int swz(int r, int c) { return r * BK + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
    int8_conv_kernel_c16(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ scale, void* __restrict__ out, Geometry g) {
  using C = C16<BN>;
  extern __shared__ uint8_t c16_raw[];
  // swizzled tiles and wgmma descriptors need 1024-byte alignment
  uint8_t* c16_smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(c16_raw) + 1023) & ~uintptr_t(1023));
  const int M = g.B * g.To * g.Ho * g.Wo;
  const int K = g.KT * g.KH * g.KW * g.Cin;
  const int N = g.Cout;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int chunk = tid & 7;  // this thread's 16-byte piece of every row it loads

  // this thread's four A rows (tid/8 + 32 i): batch, input corner, valid
  int rb[4], rt[4], rh[4], rw[4];
  bool rvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 3) + 32 * i;
    rvalid[i] = m < M;
    const int mm = rvalid[i] ? m : 0;
    const int wo = mm % g.Wo;
    const int ho = (mm / g.Wo) % g.Ho;
    const int to = (mm / (g.Wo * g.Ho)) % g.To;
    rb[i] = mm / (g.Wo * g.Ho * g.To);
    rt[i] = to * g.ST - g.PT;
    rh[i] = ho * g.SH - g.PH;
    rw[i] = wo * g.SW - g.PW;
  }
  // (tap, cin) of this thread's piece at the next K step to load
  int tap = (chunk * 16) / g.Cin;
  int ci = chunk * 16 - tap * g.Cin;

  const int k_steps = (K + BK - 1) / BK;
  auto load = [&](int ks) {
    uint8_t* sa = c16_smem + (ks % C::STAGES) * C::STAGE_BYTES;
    uint8_t* sb = sa + C::A_BYTES;
    const int k = ks * BK + chunk * 16;
    const int kw = tap % g.KW, kh = (tap / g.KW) % g.KH, kt = tap / (g.KW * g.KH);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i;
      const int ti = rt[i] + kt, hi = rh[i] + kh, wi = rw[i] + kw;
      const bool ok = rvalid[i] && k < K && ti >= 0 && ti < g.T && hi >= 0 && hi < g.H &&
                      wi >= 0 && wi < g.W;
      const int8_t* src =
          ok ? x + (((static_cast<size_t>(rb[i]) * g.T + ti) * g.H + hi) * g.W + wi) * g.Cin + ci
             : x;
      cp_async16(sa + swz(r, chunk), src, ok);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int r = (tid >> 3) + 32 * i;
      const bool ok = n0 + r < N && k < K;
      cp_async16(sb + swz(r, chunk), ok ? w + static_cast<size_t>(n0 + r) * K + k : w, ok);
    }
    ci += BK;  // advance the piece to the next step's K
    while (ci >= g.Cin) {
      ci -= g.Cin;
      ++tap;
    }
  };

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < k_steps) load(s);
    cp_async_commit();
  }

  const int wg = tid >> 7;  // consumer warpgroup: rows 64*wg .. 64*wg+63 of the tile
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int ks = 0; ks < k_steps; ++ks) {
    cp_async_wait<C::STAGES - 2>();
    fence_proxy_async();  // this thread's cp.async writes become visible to wgmma
    __syncthreads();      // step ks has landed; every wgmma of step ks - 1 has finished
    if (ks + C::STAGES - 1 < k_steps) load(ks + C::STAGES - 1);
    cp_async_commit();
    const uint8_t* sa = c16_smem + (ks % C::STAGES) * C::STAGE_BYTES;
    const uint64_t da = sw128_desc(sa + wg * 64 * BK);
    const uint64_t db = sw128_desc(sa + C::A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)  // zero-filled bytes past K add nothing
      wgmma_s8(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the staging tile

  // the accumulator holds, for each 8-column group q, columns 8q + 2(lane%4)
  // + {0, 1} of rows 16*warp + lane/4 + {0, 8} of this warpgroup's 64 rows
  constexpr int ELEM = Out<MODE>::ELEM;
  constexpr int PITCH = BN * ELEM + 16;
  uint8_t* stg = c16_smem;
  const int lane = tid & 31;
  const int row0 = wg * 64 + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int q = 0; q < BN / 8; ++q) {
    const int col = 8 * q + 2 * (lane & 3);
    const float s0 = n0 + col < N ? __ldg(scale + n0 + col) : 0.f;
    const float s1 = n0 + col + 1 < N ? __ldg(scale + n0 + col + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      stage2<MODE>(stg + (row0 + 8 * h) * PITCH + col * ELEM, acc[4 * q + 2 * h],
                   acc[4 * q + 2 * h + 1], s0, s1);
  }
  __syncthreads();
  constexpr int VPR = BN * ELEM / 16;  // 16-byte vectors per row
  for (int v = tid; v < BM * VPR; v += THREADS) {
    const int r = v / VPR, cv = v % VPR;
    const int m = m0 + r;
    const int n = n0 + cv * (16 / ELEM);
    if (m < M && n < N)
      *reinterpret_cast<int4*>(static_cast<uint8_t*>(out) + (static_cast<size_t>(m) * N + n) * ELEM) =
          *reinterpret_cast<const int4*>(stg + r * PITCH + cv * 16);
  }
}

// ------------------------------------------------------------- the stem

constexpr int S_CO = 64, S_KT = 5, S_KH = 7, S_KW = 7;
constexpr int S_TR = 8, S_TC = 16;                 // stem rows / cols per CTA
constexpr int S_POS = 2 * S_TR * S_TC;             // 256 positions: 2 stem frames
constexpr int S_IR = 2 * (S_TR - 1) + S_KH;        // 21 input rows
constexpr int S_Q = 20;                            // input columns per parity: 10 groups of 4
static_assert(2 * S_Q >= 2 * (S_TC - 1) + S_KW + 1 && S_Q % 2 == 0, "the slab covers the taps");
constexpr int S_PIX = 2 * 16 + 16;                 // bytes per slab pixel: [j][16] + pad
constexpr int S_ROW = 2 * S_Q * S_PIX;
constexpr int S_SLAB = S_IR * S_ROW;
constexpr int S_K = 25 * 32;                       // 800: tap pairs of one k32 step
constexpr int S_WPITCH = S_K + 16;
constexpr int S_SMEM = S_SLAB + S_CO * S_WPITCH;
constexpr int S_MI = 4;                            // 16-row tiles per warp (4 x 2 warps)
static_assert(S_POS * (S_CO * 4 + 16) <= S_SMEM, "the float32 staging tile fits");
static_assert(2 * S_SMEM + 2048 <= 233472, "two CTAs share an SM");

// byte offset in the slab of tap (kh, kw) from a stem position's corner:
// slab row 2*sr + kh, input column 2*sc + kw + 1 (parity, pixel)
__host__ __device__ constexpr int stem_tap(int tap) {
  return (tap / S_KW) * S_ROW + (((tap % S_KW) + 1) & 1) * S_Q * S_PIX +
         (((tap % S_KW) + 1) >> 1) * S_PIX;
}

template <int MODE, int C, int ST>
__global__ void __launch_bounds__(THREADS, 2)
    int8_conv_kernel_stem(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                          const float* __restrict__ scale, void* __restrict__ out, int T, int H,
                          int W, int To, int Ho, int Wo, int pairs) {
  extern __shared__ __align__(128) uint8_t stem_smem[];
  uint8_t* slab = stem_smem;             // [S_IR][parity][S_Q][S_PIX]
  uint8_t* ws = stem_smem + S_SLAB;      // [64][S_WPITCH]
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * S_TC;      // first stem column
  const int r0 = blockIdx.y * S_TR;      // first stem row
  const int b = blockIdx.z / pairs;
  const int u = blockIdx.z % pairs;      // stem frames 2u, 2u + 1
  const int ih0 = 2 * r0 - 3;            // input row of slab row 0
  const int ic0 = 2 * c0 - 4;            // input column of slab column 0 (a multiple of 4)

  for (int v = tid; v < S_CO * (S_K / 16); v += THREADS) {
    const int n = v / (S_K / 16), q = v % (S_K / 16);
    cp_async16(ws + n * S_WPITCH + q * 16, w + n * S_K + q * 16, true);
  }
  cp_async_commit();

  static_assert((C == 2 || C == 3) && S_KT * C <= 16, "five taps of C channels fit 16 bytes");
  static_assert(ST == 1 || ST == 2, "temporal stride 1 or 2");
  constexpr int NF = S_KT + ST;          // input frames of the pair: 2u*ST - 2 + f
  // the slab: four input pixels (4 * C bytes, C 4-byte words) per frame
  // and unit, transposed in registers into four [j][16] pixel vectors
  for (int unit = tid; unit < S_IR * (S_Q / 2); unit += THREADS) {
    const int r = unit / (S_Q / 2), grp = unit % (S_Q / 2);
    const int ih = ih0 + r;
    const int iw = ic0 + 4 * grp;        // W % 4 == 0: all four pixels inside or outside
    const bool inside = ih >= 0 && ih < H && iw >= 0 && iw < W;
    uint32_t wd[NF][C];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int frame = 2 * ST * u - 2 + f;
#pragma unroll
      for (int q = 0; q < C; ++q) wd[f][q] = 0u;
      if (inside && frame >= 0 && frame < T) {
        // 4-byte aligned: x is, and iw % 4 == 0 with W % 4 == 0
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            x + (((static_cast<size_t>(b) * T + frame) * H + ih) * W + iw) * C);
#pragma unroll
        for (int q = 0; q < C; ++q) wd[f][q] = __ldg(src + q);
      }
    }
#pragma unroll
    for (int px = 0; px < 4; ++px) {
      // pixel 4*grp + px of the slab row: parity px % 2, pixel 2*grp + px / 2
      uint8_t* dst = slab + r * S_ROW + (px & 1) * S_Q * S_PIX + (2 * grp + (px >> 1)) * S_PIX;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t words[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t word = 0u;
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int e = 4 * q + e4;  // element kt * C + c
            if (e < S_KT * C) {
              const int f = ST * j + e / C;
              const int byte = px * C + e % C;  // of the 4 * C-byte group
              word |= ((wd[f][byte >> 2] >> (8 * (byte & 3))) & 0xFFu) << (8 * e4);
            }
          }
          words[q] = word;
        }
        *reinterpret_cast<int4*>(dst + 16 * j) = make_int4(words[0], words[1], words[2], words[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  // A rows: position p = (j * 8 + sr) * 16 + sc; lanes 16-31 read the odd tap
  int arow[S_MI];
#pragma unroll
  for (int i = 0; i < S_MI; ++i) {
    const int p = (wm * S_MI + i) * 16 + (lane & 15);
    const int j = p / (S_TR * S_TC), sr = (p / S_TC) % S_TR, sc = p % S_TC;
    arow[i] = 2 * sr * S_ROW + sc * S_PIX + j * 16;
  }
  const int odd = lane >> 4;
  const uint8_t* wb = ws + (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * S_WPITCH +
                      ((lane >> 3) & 1) * 16;
  int acc[S_MI][4][4];
#pragma unroll
  for (int i = 0; i < S_MI; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0;

#pragma unroll
  for (int kp = 0; kp < 25; ++kp) {
    // the 50th tap has zero weights: its lanes read tap 48's pixels
    const int tap = odd ? (2 * kp + 1 < S_KH * S_KW ? stem_tap(2 * kp + 1) : stem_tap(48))
                        : stem_tap(2 * kp);
    uint32_t b01[4], b23[4];
    ldsm_x4(b01, wb + kp * 32);
    ldsm_x4(b23, wb + kp * 32 + 16 * S_WPITCH);
#pragma unroll
    for (int i = 0; i < S_MI; ++i) {
      uint32_t af[4];
      ldsm_x4(af, slab + arow[i] + tap);
      mma_s8(acc[i][0], af, b01[0], b01[1]);
      mma_s8(acc[i][1], af, b01[2], b01[3]);
      mma_s8(acc[i][2], af, b23[0], b23[1]);
      mma_s8(acc[i][3], af, b23[2], b23[3]);
    }
  }
  __syncthreads();  // slab and weights are read: the region becomes the staging tile

  constexpr int ELEM = Out<MODE>::ELEM;
  constexpr int PITCH = S_CO * ELEM + 16;
  uint8_t* stg = stem_smem;
  const int gq = lane >> 2, q2 = 2 * (lane & 3);
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    const int n = wn * 32 + jn * 8 + q2;
    const float s0 = __ldg(scale + n), s1 = __ldg(scale + n + 1);
#pragma unroll
    for (int i = 0; i < S_MI; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = (wm * S_MI + i) * 16 + gq + 8 * hh;
        stage2<MODE>(stg + p * PITCH + n * ELEM, acc[i][jn][2 * hh], acc[i][jn][2 * hh + 1], s0,
                     s1);
      }
  }
  __syncthreads();
  constexpr int VPR = S_CO * ELEM / 16;
  for (int v = tid; v < S_POS * VPR; v += THREADS) {
    const int p = v / VPR, cv = v % VPR;
    const int j = p / (S_TR * S_TC), sr = (p / S_TC) % S_TR, sc = p % S_TC;
    const int to = 2 * u + j, ho = r0 + sr, wo = c0 + sc;
    if (to < To && ho < Ho && wo < Wo) {
      const size_t m = ((static_cast<size_t>(b) * To + to) * Ho + ho) * Wo + wo;
      *reinterpret_cast<int4*>(static_cast<uint8_t*>(out) + m * S_CO * ELEM + cv * 16) =
          *reinterpret_cast<const int4*>(stg + p * PITCH + cv * 16);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int MODE, int C, int ST>
int launch_stem(const void* x, const void* w, const float* scale, void* out, const Geometry& g,
                cudaStream_t stream) {
  auto kernel = int8_conv_kernel_stem<MODE, C, ST>;
  cudaError_t err = set_smem(kernel, S_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = (g.To + 1) / 2;
  const dim3 grid((g.Wo + S_TC - 1) / S_TC, (g.Ho + S_TR - 1) / S_TR, g.B * pairs);
  kernel<<<grid, THREADS, S_SMEM, stream>>>(static_cast<const int8_t*>(x),
                                            static_cast<const int8_t*>(w), scale, out, g.T, g.H,
                                            g.W, g.To, g.Ho, g.Wo, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int MODE>
int launch_c16(const void* x, const void* w, const float* scale, void* out, const Geometry& g,
               cudaStream_t stream) {
  auto kernel = int8_conv_kernel_c16<BN, MODE>;
  cudaError_t err = set_smem(kernel, C16<BN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long M = static_cast<long long>(g.B) * g.To * g.Ho * g.Wo;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (g.Cout + BN - 1) / BN);
  kernel<<<grid, THREADS, C16<BN>::SMEM, stream>>>(static_cast<const int8_t*>(x),
                                                   static_cast<const int8_t*>(w), scale, out, g);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch(const void* x, const void* w, const float* scale, void* out, const Geometry& g,
           bool stem, cudaStream_t stream) {
  if (stem) {
    if (g.ST == 1)
      return g.Cin == 2 ? launch_stem<MODE, 2, 1>(x, w, scale, out, g, stream)
                        : launch_stem<MODE, 3, 1>(x, w, scale, out, g, stream);
    return g.Cin == 2 ? launch_stem<MODE, 2, 2>(x, w, scale, out, g, stream)
                      : launch_stem<MODE, 3, 2>(x, w, scale, out, g, stream);
  }
  if (g.Cout == 64) return launch_c16<64, MODE>(x, w, scale, out, g, stream);
  return launch_c16<128, MODE>(x, w, scale, out, g, stream);
}

}  // namespace

// x int8 (B, T, H, W, Cin) channels last; w int8 (Cout, K): for Cin % 16
// == 0 pack_int8_weight_nk's rows (kt, kh, kw, cin), for the stem
// (Cin = 3 or 2, k(5,7,7), s(2,2,2) or s(1,2,2), p(2,3,3), Cout = 64,
// W % 4 == 0, x 4-byte aligned) the (64, 800) tap-pair layout. Any other geometry returns cudaErrorInvalidValue.
extern "C" int adv_int8_conv(const void* x, const void* w, const float* scale, void* out, int B,
                             int T, int H, int W, int Cin, int Cout, int KT, int KH, int KW,
                             int ST, int SH, int SW, int PT, int PH, int PW, int mode,
                             void* stream) {
  Geometry g{B, T, H, W, Cin, Cout, KT, KH, KW, ST, SH, SW, PT, PH, PW, 0, 0, 0};
  g.To = (T + 2 * PT - KT) / ST + 1;
  g.Ho = (H + 2 * PH - KH) / SH + 1;
  g.Wo = (W + 2 * PW - KW) / SW + 1;
  const bool stem = (Cin == 2 || Cin == 3) && Cout == S_CO && KT == S_KT && KH == S_KH && KW == S_KW &&
                    (ST == 1 || ST == 2) && SH == 2 && SW == 2 && PT == 2 && PH == 3 && PW == 3 &&
                    W % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool c16 = Cin % 16 == 0 && Cout % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (!(stem || c16) || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == OUT_FLOAT32) return launch<OUT_FLOAT32>(x, w, scale, out, g, stem, s);
  if (mode == OUT_BFLOAT16) return launch<OUT_BFLOAT16>(x, w, scale, out, g, stem, s);
  if (mode == OUT_INT8) return launch<OUT_INT8>(x, w, scale, out, g, stem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
