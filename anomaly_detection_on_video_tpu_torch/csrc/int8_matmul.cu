// K4: int8 x int8 -> int32 matrix product, with an optional per-column
// float32 scale epilogue.
//
// Replaces probe_raw_matmul (scripts/int8_pallas_probe.py:75), whose
// Pallas body is dot_general(w (K, N), x (K, M)) contracting dim 0 with an
// int32 result: in channels-last order that is C (M, N) = A (M, K) . W^T
// with A the activations and W the (N, K) weights, K contiguous in both.
// The scaled form, float(C) * scale[n] rounded once to float32 or
// bfloat16, is ConvBN._int8_conv's dequantize, which the JAX package leaves
// to XLA after the product; here it is the kernel's epilogue. It serves
// every 1x1x1 int8 conv of the i3res50 int8 path.
//
// Bound: bytes at the path's shapes (2NK / (K + 2N) operations per byte
// stays below the H100's int8 balance of about 590 but at K = 2048). The
// four stage-1 products (K = 64, N = 256, M = 484,000 at B = 40) are
// almost pure bf16 writes; the deep stage-3/4 products read A once per
// column tile. Design, for that:
// - a persistent grid (one CTA per SM) walks 128 x BN output tiles, BN =
//   256 when N allows it (the stage-1 products cover N in one tile and
//   read their A rows once), else 128;
// - one producer warp (warpgroup 2) keeps a ring of 3-4 stages of 128-byte
//   K steps full with TMA loads (cp.async.bulk.tensor, 128-byte swizzle,
//   zero fill past M, N and K), signalled through mbarriers, and runs
//   ahead into the next tile while the consumers finish the last;
// - two consumer warpgroups each run wgmma m64nBNk32 s32.s8.s8 on 64 of
//   the 128 rows, both operands K-major in shared memory;
// - the epilogue converts each exact int32 sum once, __fmul_rn(
//   __int2float_rn(acc), scale[n]) rounded by __float2bfloat16_rn or kept
//   as float32 (or the int32 sum itself), stages the tile through padded
//   shared memory and writes it out as 16-byte vectors, full rows of the
//   tile at a time.
// Sizes: the output offset (m * N + n) * ELEM is computed in size_t, so C
// may hold more than 2^31 elements; M, N and K are 32-bit, as are TMA's
// box coordinates, so each stays below 2^31 (the wrapper checks). The
// largest product of the int8 path, stage 1's M = B*4*55*55 rows into 256
// channels, holds 1.49e9 values at B = 480, and M is 5.8e6.
// TMA takes 16-byte global strides: K and N must be multiples of 16 and
// both operands 16-byte aligned (the wrapper checks; every shape of the
// int8 path qualifies).
#include <cuda.h>

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace adv::sm90;

enum Mode { OUT_INT32 = 0, OUT_FLOAT32 = 1, OUT_BFLOAT16 = 2 };

constexpr int BM = 128;         // rows per tile, 64 per consumer warpgroup
constexpr int BK = 128;         // bytes of K per stage: one 128-byte swizzle row
constexpr int THREADS = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CHUNK = 512;      // bytes of one output row staged at a time
constexpr int PITCH = CHUNK + 16;  // staging row pitch: 16-byte aligned, fewer bank conflicts
constexpr int STAGING = 2 * 64 * PITCH;

template <int BN>
struct Cfg {
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  static constexpr int BARRIERS = STAGES * STAGE_BYTES + STAGING;
  static constexpr int SMEM = BARRIERS + 2 * STAGES * 8 + 1024;  // + alignment slack
};

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
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

// Chunk C (CC columns) of one consumer warpgroup's 64 x BN piece of the
// tile at (m0, n0) -> out, through its staging rows `stg`. The wgmma
// accumulator holds, for each 8-column group q, the columns
// 8q + 2(lane%4) + {0, 1} of rows 16*warp + lane/4 + {0, 8}. The chunk is
// a template argument so that every accumulator index is a constant.
template <int BN, int MODE, int C>
__device__ __forceinline__ void store_chunk(const int (&acc)[BN / 2], uint8_t* stg, int m0, int n0,
                                            int M, int N, const float* __restrict__ scale,
                                            void* __restrict__ out) {
  constexpr int ELEM = MODE == OUT_BFLOAT16 ? 2 : 4;
  constexpr int CC = BN * ELEM < CHUNK ? BN : CHUNK / ELEM;  // columns per chunk
  constexpr int VPR = CC * ELEM / 16;                         // 16-byte vectors per row
  const int t = threadIdx.x & 127;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int bar = 1 + (threadIdx.x >> 7);
  bar_sync(bar, 128);  // the previous chunk (or tile) has been read out
#pragma unroll
  for (int q = C * CC / 8; q < (C + 1) * CC / 8; ++q) {
    const int col = q * 8 + 2 * (lane & 3);
    const int n = n0 + col;
    float s0 = 0.f, s1 = 0.f;
    if (MODE != OUT_INT32 && n < N) {
      s0 = __ldg(scale + n);
      s1 = __ldg(scale + n + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + (lane >> 2) + 8 * h;
      uint8_t* dst = stg + row * PITCH + (col - C * CC) * ELEM;
      const int v0 = acc[4 * q + 2 * h], v1 = acc[4 * q + 2 * h + 1];
      if (MODE == OUT_INT32) {
        *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
      } else {
        const float y0 = __fmul_rn(__int2float_rn(v0), s0);
        const float y1 = __fmul_rn(__int2float_rn(v1), s1);
        if (MODE == OUT_FLOAT32) {
          *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
        } else {
          __nv_bfloat162 p;
          p.x = __float2bfloat16_rn(y0);
          p.y = __float2bfloat16_rn(y1);
          *reinterpret_cast<__nv_bfloat162*>(dst) = p;
        }
      }
    }
  }
  bar_sync(bar, 128);
  for (int v = t; v < 64 * VPR; v += 128) {
    const int r = v / VPR;
    const int cv = v % VPR;
    const int m = m0 + r;
    const int n = n0 + C * CC + cv * (16 / ELEM);
    if (m < M && n < N)
      *reinterpret_cast<int4*>(static_cast<uint8_t*>(out) +
                               (static_cast<size_t>(m) * N + n) * ELEM) =
          *reinterpret_cast<const int4*>(stg + r * PITCH + cv * 16);
  }
}

// One consumer warpgroup's 64 x BN piece of the tile, in one or two chunks.
template <int BN, int MODE>
__device__ __forceinline__ void epilogue(const int (&acc)[BN / 2], uint8_t* stg, int m0, int n0,
                                         int M, int N, const float* __restrict__ scale,
                                         void* __restrict__ out) {
  constexpr int ELEM = MODE == OUT_BFLOAT16 ? 2 : 4;
  static_assert(BN * ELEM <= 2 * CHUNK, "at most two chunks");
  store_chunk<BN, MODE, 0>(acc, stg, m0, n0, M, N, scale, out);
  if constexpr (BN * ELEM > CHUNK) store_chunk<BN, MODE, 1>(acc, stg, m0, n0, M, N, scale, out);
}

template <int BN, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap tmap_a,
                       const __grid_constant__ CUtensorMap tmap_w, const float* __restrict__ scale,
                       void* __restrict__ out, int M, int N, int K) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled TMA tiles and wgmma descriptors need 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = smem;
  uint8_t* staging = smem + C::STAGES * C::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARRIERS);
  uint64_t* empty = full + C::STAGES;

  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * n_tiles;
  const int k_steps = (K + BK - 1) / BK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&tmap_a);
      tma_prefetch_desc(&tmap_w);
      int stage = 0;
      uint32_t phase = 1;  // the ring starts empty: the first waits pass
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM;
        const int n0 = tile % n_tiles * BN;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[stage], phase);
          mbar_arrive_expect_tx(&full[stage], C::STAGE_BYTES);
          uint8_t* sa = ring + stage * C::STAGE_BYTES;
          tma_load_2d(sa, &tmap_a, &full[stage], ks * BK, m0);
          tma_load_2d(sa + C::A_BYTES, &tmap_w, &full[stage], ks * BK, n0);
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64*wg .. 64*wg+63 of each tile
    regs_alloc<232>();
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * BM;
      const int n0 = tile % n_tiles * BN;
      int prev = 0;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[stage], phase);
        const uint8_t* sa = ring + stage * C::STAGE_BYTES;
        const uint64_t da = sw128_desc(sa + wg * 64 * BK);
        const uint64_t dw = sw128_desc(sa + C::A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)  // zero-filled bytes past K add nothing
          wgmma_s8(acc, da + 2 * kk, dw + 2 * kk, ks > 0 || kk > 0);
        wgmma_commit();
        // one group stays in flight: the previous step's has finished reading its stage
        wgmma_wait<1>();
        if (ks > 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == C::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      mbar_arrive(&empty[prev]);
      epilogue<BN, MODE>(acc, staging + wg * 64 * PITCH, m0 + wg * 64, n0, M, N, scale, out);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major int8 (rows, K) matrix as 128-byte K steps of box_rows rows,
// 128-byte swizzled; boxes past the edges read zeros. A map depends on
// nothing but these four values, so the last few are kept: the weights
// and, through PyTorch's caching allocator, most activations come back at
// the same address and shape, and a launch then skips the driver call.
cudaError_t encode(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  struct Entry {
    const void* ptr;
    int rows, K, box_rows;
    CUtensorMap map;
  };
  constexpr int CACHED = 64;
  static Entry cache[CACHED];
  static int next = 0;
  static std::mutex lock;
  {
    std::lock_guard<std::mutex> guard(lock);
    for (const Entry& e : cache) {
      if (e.ptr == ptr && e.rows == rows && e.K == K && e.box_rows == box_rows) {
        *map = e.map;
        return cudaSuccess;
      }
    }
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> guard(lock);
  cache[next] = Entry{ptr, rows, K, box_rows, *map};
  next = (next + 1) % CACHED;
  return cudaSuccess;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count < 1) count = 1;
  }
  return count;
}

template <int BN, int MODE>
int launch(const void* a, const void* w, const float* scale, void* out, int M, int N, int K,
           cudaStream_t stream) {
  CUtensorMap tmap_a, tmap_w;
  cudaError_t err = encode(&tmap_a, a, M, K, BM);
  if (err == cudaSuccess) err = encode(&tmap_w, w, N, K, BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = int8_matmul_kernel<BN, MODE>;
  static bool sized = false;  // the attribute holds for the process
  if (!sized) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(tmap_a, tmap_w, scale, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_mode(const void* a, const void* w, const float* scale, void* out, int M, int N, int K,
                int mode, cudaStream_t stream) {
  if (mode == OUT_INT32) return launch<BN, OUT_INT32>(a, w, scale, out, M, N, K, stream);
  if (mode == OUT_FLOAT32) return launch<BN, OUT_FLOAT32>(a, w, scale, out, M, N, K, stream);
  if (mode == OUT_BFLOAT16) return launch<BN, OUT_BFLOAT16>(a, w, scale, out, M, N, K, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// a int8 (M, K), w int8 (N, K), both row-major; out (M, N) in the mode's type.
extern "C" int adv_int8_matmul(const void* a, const void* w, const float* scale, void* out, int M,
                               int N, int K, int mode, void* stream) {
  if (K % 16 || N % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || M < 1 || K < 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 256-wide tiles read A once for N = 256 and halve its re-reads elsewhere,
  // unless they would leave SMs without a tile
  if (N % 256 == 0 && (M + BM - 1) / BM * (N / 256) >= sm_count())
    return launch_mode<256>(a, w, scale, out, M, N, K, mode, s);
  return launch_mode<128>(a, w, scale, out, M, N, K, mode, s);
}
