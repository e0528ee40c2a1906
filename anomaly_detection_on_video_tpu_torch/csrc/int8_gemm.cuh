// The int8 x int8 -> int32 tile product of K5 (int8_conv.cu) and its
// per-column scale epilogue.
//
// A CTA computes a BM x BN tile of C = A (M, K) . B (K, N). Each K step
// stages a BM x BK tile of A and a BK x BN tile of B in shared memory, both
// with K contiguous (B is transposed on its way in), and eight warps run
// mma.sync m16n8k32 s8.s8.s32 on them: warp (wm, wn) owns a 32 x 32 piece,
// 2 x 4 tensor-core tiles of 16 x 8, held as int32 in registers. Rows of
// A and B that fall outside M, N or K are staged as zeros, so a ragged K
// (the stem's 735) adds nothing. The caller's loader fills the A tile: K5
// gathers it from the activation (implicit im2col).
//
// The epilogue converts the exact int32 sum once: float(acc) * scale[n],
// rounded to nearest with explicit intrinsics (no FMA contraction), then
// stored as float32, bfloat16 (round to nearest even) or int8
// (round half to even, clamped to [-127, 127]); or the int32 sum itself.
#pragma once

#include "common.cuh"

namespace adv {
namespace i8 {

constexpr int BM = 128, BN = 64, BK = 64;
constexpr int LDS = BK + 16;  // row pitch in bytes: 16-byte aligned, no bank conflicts
constexpr int THREADS = 256;
constexpr int SMEM_BYTES = (BM + BN) * LDS;

// what the epilogue stores
enum Mode { OUT_INT32 = 0, OUT_FLOAT32 = 1, OUT_BFLOAT16 = 2, OUT_INT8 = 3 };

__device__ __forceinline__ int lds32(const int8_t* p) { return *reinterpret_cast<const int*>(p); }

// The B tile: rows k0 .. k0+BK-1, columns n0 .. n0+BN-1 of B (K, N)
// row-major, stored as s_b[n][k]. Each thread moves 16 consecutive columns
// of one row.
__device__ __forceinline__ void load_b_tile(const int8_t* __restrict__ b, int8_t* s_b, int K,
                                            int N, int k0, int n0, bool vec) {
  const int kr = threadIdx.x >> 2;         // 0 .. 63
  const int nc = (threadIdx.x & 3) * 16;   // 0, 16, 32, 48
  const int k = k0 + kr;
  const int n = n0 + nc;
  int8_t v[16];
  if (vec && k < K && n + 16 <= N) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(b + static_cast<size_t>(k) * N + n));
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&q);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = bytes[j];
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = (k < K && n + j < N) ? b[static_cast<size_t>(k) * N + n + j] : int8_t(0);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) s_b[(nc + j) * LDS + kr] = v[j];
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += the staged A tile . the staged B tile, for this warp's 32 x 32 piece.
__device__ __forceinline__ void mma_tile(const int8_t* s_a, const int8_t* s_b,
                                         int (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // group of the fragment layout
  const int t = lane & 3;   // thread in the group
  const int row0 = (warp >> 1) * 32;
  const int col0 = (warp & 1) * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    int a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = s_a + (row0 + mi * 16 + g) * LDS + kk + t * 4;
      a[mi][0] = lds32(p);
      a[mi][1] = lds32(p + 8 * LDS);
      a[mi][2] = lds32(p + 16);
      a[mi][3] = lds32(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = s_b + (col0 + ni * 8 + g) * LDS + kk + t * 4;
      b[ni][0] = lds32(p);
      b[ni][1] = lds32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

__device__ __forceinline__ void store(void* out, size_t i, int acc, float s, int mode) {
  if (mode == OUT_INT32) {
    static_cast<int*>(out)[i] = acc;
    return;
  }
  const float y = __fmul_rn(__int2float_rn(acc), s);
  if (mode == OUT_FLOAT32) {
    static_cast<float*>(out)[i] = y;
  } else if (mode == OUT_BFLOAT16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  } else {
    const int q = min(max(__float2int_rn(y), -127), 127);
    static_cast<int8_t*>(out)[i] = static_cast<int8_t>(q);
  }
}

// Write this warp's piece of the tile at (m0, n0) of the (M, N) output.
__device__ __forceinline__ void epilogue(const int (&acc)[2][4][4], int m0, int n0, int M, int N,
                                         const float* __restrict__ scale, void* out, int mode) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + (warp & 1) * 32 + ni * 8 + t * 2 + j;
      if (n >= N) continue;
      const float s = mode == OUT_INT32 ? 0.f : __ldg(scale + n);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + (warp >> 1) * 32 + mi * 16 + h * 8 + g;
          if (m < M) store(out, static_cast<size_t>(m) * N + n, acc[mi][ni][2 * h + j], s, mode);
        }
      }
    }
  }
}

}  // namespace i8
}  // namespace adv
