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
// Bound: memory. It reads each uint8 pixel once and writes 4 (or 2) bytes
// per output value: at (24, 16, 256, 341, 3) 2.31 GB (or 1.16 GB) written
// against 0.10 GB read, so the design is about the write stream and about
// not gathering from device memory:
// - A CTA owns one (clip, frame) and a band of `band` output rows of all
//   ten crops. The crops' tops take at most three values, so the input rows
//   the band needs are the union of three runs of `band` rows. Where the
//   crops' column windows (flips included) cover the frame's width, as they
//   do for every frame of the main path, each merged run is staged as whole
//   rows: one contiguous byte segment, copied into shared memory with
//   16-byte cp.async from its start rounded down to 16 bytes (rows are W*3
//   bytes and need not be aligned). Where the crops leave columns between
//   them unread (frames wider than about three crops), a run is staged only
//   over the merged windows of its crops, at most five spans of S pixels
//   in all (one per crop position), each row in a 16-byte-aligned slot
//   copied from its own start rounded down to 16: so a frame of any width
//   fits. All ten crops, the five flips included, read their pixels from
//   there. The plan takes the tallest band that fits a CTA's 227 KB, one
//   CTA per SM (112 rows of 256x341 frames stage 144): a shorter band stages
//   the rows between the tops again for every band, and that cost more than
//   several CTAs per SM gained by overlapping one CTA's staging with another's
//   stores.
// - A thread converts 8 output pixels (24 values) of one crop row per step:
//   the 24 source bytes are contiguous in shared memory (for a flip, in
//   reverse pixel order), read as 7 aligned words and funnel-shifted into 6,
//   so every byte index below is a compile-time constant. Each value goes
//   uint8 -> float32 by the 2^23 exponent trick (exact), then subtract and
//   multiply as the plain version does.
// - Each warp stages its 32 steps (1536 or 3072 contiguous output bytes,
//   since a band of one crop is contiguous in the output) in shared memory
//   and writes them as 16-byte streaming stores, one warp instruction per
//   512 contiguous bytes, so every 32-byte sector is written whole by one
//   instruction. Streaming (st.global.cs, evict first): the output, 1.16 GB
//   at B = 240, is 20x the L2 and is read by the next kernel only after the
//   whole batch is written. Stores from registers rather than TMA bulk
//   stores (cp.async.bulk) of the staged runs: a bulk-store variant, which
//   also needs a second staging buffer per warp, was no faster. When a crop
//   row is not a whole number of 16-byte vectors (S % 8 != 0) the thread
//   writes its values with scalar stores.
// - The launch plan (band height, segments and their column spans, shared
//   offsets and row pitches, which segment and row each crop and each flip
//   starts at) comes from crop_norm_plan in
//   ops/kernels/crop_norm.py, computed once per (H, W, S) on the host; the
//   CPU tests evaluate the same plan. There is no integer division per
//   element: one per CTA and one per 8-pixel step of all ten crops.
// - The grid is one-dimensional, (gc * fpc * n_bands) CTAs.
#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using adv::sm90::cp_async16;
using adv::sm90::cp_async_commit;
using adv::sm90::cp_async_wait;

constexpr int THREADS = 256;  // crop_norm.py THREADS
constexpr int GROUP = 8;  // output pixels per thread step (crop_norm.py GROUP)
constexpr int VALS = GROUP * 3;
constexpr int MAX_SEGMENTS = 5;  // crop_norm.py MAX_SEGMENTS

// The host's launch plan, field for field as CropNormPlan.ints() lays it out.
struct Plan {
  int band;          // output rows per CTA (the last band may be shorter)
  int n_bands;       // CTAs per (clip, frame)
  int n_segments;    // staged segments, 1-5
  int seg_lo[MAX_SEGMENTS];      // segment s holds input rows y0 + seg_lo .. y0 + seg_hi
  int seg_hi[MAX_SEGMENTS];      //   (clamped to H), y0 the band's first output row,
  int seg_c0[MAX_SEGMENTS];      //   columns seg_c0 .. seg_c1
  int seg_c1[MAX_SEGMENTS];
  int seg_pitch[MAX_SEGMENTS];   // shared bytes a staged row takes (W * 3 for whole rows)
  int seg_offset[MAX_SEGMENTS];  // shared byte offset of the segment
  int crop_segment[5];  // crop position k reads segment crop_segment[k], its flip
  int flip_segment[5];  //   flip_segment[k], ...
  int crop_row[5];      // ... from its row crop_row[k] on (top_k - seg_lo)
  int left[5];
  int stage_offset;  // shared byte offset of the warps' output staging
  int shared_bytes;
  int vector;        // 1: 16-byte stores (S % 8 == 0); 0: scalar stores
  int whole_rows;    // 1: every segment is whole rows, copied as one run
};

// a[i] for a register array and a runtime index, without local memory
template <int N>
__device__ __forceinline__ int pick(const int (&a)[N], int i) {
  int v = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? a[j] : v;
  return v;
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The 24 bytes at shared byte offset `a` (any alignment) into 6 words.
__device__ __forceinline__ void load24(const uint8_t* smem, int a, uint32_t (&b)[6]) {
  const uint8_t* p = smem + (a & ~3);
  const int shift = (a & 3) * 8;
  uint32_t w[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) w[i] = lds32(p + 4 * i);
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = __funnelshift_r(w[i], w[i + 1], shift);
}

// Byte j of the 24 in `b` as float32, exactly: 0x4B0000jj is 2^23 + byte.
__device__ __forceinline__ float byte_as_float(const uint32_t (&b)[6], int j) {
  const uint32_t bits = __byte_perm(b[j >> 2], 0x4B000000u, 0x7440 | (j & 3));
  return __fsub_rn(__uint_as_float(bits), 8388608.0f);
}

// Output pixel p, channel c of a step reads byte 3p + c, or for a flip
// (window in reverse pixel order) byte 3(7 - p) + c.
template <bool FLIP>
__device__ __forceinline__ void convert(const uint32_t (&b)[6], float mean, float inv_std,
                                        float (&v)[VALS]) {
#pragma unroll
  for (int p = 0; p < GROUP; ++p) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int j = 3 * (FLIP ? GROUP - 1 - p : p) + c;
      v[3 * p + c] = __fmul_rn(__fsub_rn(byte_as_float(b, j), mean), inv_std);
    }
  }
}

__device__ __forceinline__ void st_global_cs(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// The 24 values as 16-byte vectors: 3 of 8 bfloat16, or 6 of 4 float32.
template <typename T>
struct Vectors;
template <>
struct Vectors<__nv_bfloat16> {
  static constexpr int N = 3;
  static __device__ __forceinline__ void pack(const float (&v)[VALS], uint4 (&out)[N]) {
    uint32_t* u = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int i = 0; i < VALS / 2; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
};
template <>
struct Vectors<float> {
  static constexpr int N = 6;
  static __device__ __forceinline__ void pack(const float (&v)[VALS], uint4 (&out)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = make_uint4(__float_as_uint(v[4 * i]), __float_as_uint(v[4 * i + 1]),
                          __float_as_uint(v[4 * i + 2]), __float_as_uint(v[4 * i + 3]));
  }
};

template <typename T, bool VECTOR, bool WHOLE>
__global__ void __launch_bounds__(THREADS) crop_norm_kernel(
    const uint8_t* __restrict__ frames, T* __restrict__ out, int fpc, int height, int width,
    int size, const Plan plan, float mean, float inv_std) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int plane = blockIdx.x / plan.n_bands;  // clip * fpc + frame
  const int band = blockIdx.x - plane * plan.n_bands;
  const int clip = plane / fpc;
  const int frame = plane - clip * fpc;
  const int y0 = band * plan.band;
  const int rows = min(plan.band, size - y0);
  const int row_bytes = width * 3;
  const uint8_t* src_plane = frames + static_cast<size_t>(plane) * height * row_bytes;

  // stage the band's input. Whole rows: each segment from its start rounded
  // down to 16 bytes, so the copy of row j of segment s starts at
  // seg_offset[s] + mis[s] + j * row_bytes. Column spans: each row j from its
  // own start rounded down to 16 into a slot of seg_pitch[s] bytes, where it
  // starts at seg_offset[s] + j * seg_pitch[s] + (its address % 16).
  int mis[MAX_SEGMENTS] = {0, 0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < MAX_SEGMENTS; ++s) {
    if (s < plan.n_segments) {
      const int lo = y0 + plan.seg_lo[s];
      const int hi = min(y0 + plan.seg_hi[s], height);
      const uint8_t* src = src_plane + static_cast<size_t>(lo) * row_bytes + 3 * plan.seg_c0[s];
      uint8_t* dst = smem + plan.seg_offset[s];
      mis[s] = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
      if (WHOLE) {
        const uint8_t* aligned = src - mis[s];
        const int chunks = (mis[s] + (hi - lo) * row_bytes + 15) >> 4;
        for (int i = tid; i < chunks; i += THREADS)
          cp_async16(dst + 16 * i, aligned + 16 * i, true);
      } else {
        const int span_bytes = 3 * (plan.seg_c1[s] - plan.seg_c0[s]);
        const int pitch = plan.seg_pitch[s];
        const int per_row = pitch >> 4;
        const int chunks = (hi - lo) * per_row;
        for (int i = tid; i < chunks; i += THREADS) {
          const int j = i / per_row;
          const int c = i - j * per_row;
          const uint8_t* row = src + static_cast<size_t>(j) * row_bytes;
          const int m = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
          if (16 * c < m + span_bytes) cp_async16(dst + j * pitch + 16 * c, row - m + 16 * c, true);
        }
      }
    }
  }
  cp_async_commit();

  // shared byte offset of crop position k's first pixel in output row 0:
  // unflipped at column left_k, flipped windows start at column W - 8 - left_k.
  // Column spans add, for output row r, r * pitch and the misalignment of
  // that input row (mis of the crop's first row + r * row_bytes, mod 16).
  int unflipped[5], flipped[5], pitch_u[5], pitch_f[5], mis_u[5], mis_f[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int s = f ? plan.flip_segment[k] : plan.crop_segment[k];
      const int col = (f ? width - GROUP - plan.left[k] : plan.left[k]) - plan.seg_c0[s];
      const int m = pick(mis, s);
      int base, pitch, row_mis;
      if (WHOLE) {
        base = plan.seg_offset[s] + m + plan.crop_row[k] * row_bytes + 3 * col;
        pitch = row_bytes;
        row_mis = 0;
      } else {
        pitch = plan.seg_pitch[s];
        base = plan.seg_offset[s] + plan.crop_row[k] * pitch + 3 * col;
        row_mis = (m + plan.crop_row[k] * row_bytes) & 15;
      }
      if (f) {
        flipped[k] = base;
        pitch_f[k] = pitch;
        mis_f[k] = row_mis;
      } else {
        unflipped[k] = base;
        pitch_u[k] = pitch;
        mis_u[k] = row_mis;
      }
    }
  }
  const int steps_per_row = (size + GROUP - 1) / GROUP;
  const int n_steps = rows * steps_per_row;
  const size_t crop_stride = static_cast<size_t>(fpc) * size * size * 3;  // elements
  T* out_band = out + (static_cast<size_t>(clip) * 10 * fpc + frame) * size * size * 3 +
                static_cast<size_t>(y0) * size * 3;
  using V = Vectors<T>;
  uint4* stage = reinterpret_cast<uint4*>(smem + plan.stage_offset) + warp * 32 * V::N;

  cp_async_wait<0>();
  __syncthreads();

  for (int q0 = warp * 32; q0 < n_steps; q0 += THREADS) {
    const int q = min(q0 + lane, n_steps - 1);  // lanes past the end recompute the last step
    const int r = q / steps_per_row;
    const int g = q - r * steps_per_row;
    const int row_off = r * row_bytes;
    const int valid_chunks = (n_steps - q0) * V::N;  // of this warp's 32 * V::N
#pragma unroll
    for (int crop = 0; crop < 10; ++crop) {
      const int k = crop % 5;
      uint32_t b[6];
      float v[VALS];
      if (crop < 5) {
        const int row = WHOLE ? row_off : r * pitch_u[k] + ((mis_u[k] + row_off) & 15);
        load24(smem, unflipped[k] + row + VALS * g, b);
        convert<false>(b, mean, inv_std, v);
      } else {
        const int row = WHOLE ? row_off : r * pitch_f[k] + ((mis_f[k] + row_off) & 15);
        load24(smem, flipped[k] + row - VALS * g, b);
        convert<true>(b, mean, inv_std, v);
      }
      T* dst = out_band + crop * crop_stride;
      if (VECTOR) {
        // a band of one crop is contiguous in the output: this warp's 32
        // steps are 32 * V::N contiguous 16-byte vectors from step q0 on
        uint4 packed[V::N];
        V::pack(v, packed);
#pragma unroll
        for (int i = 0; i < V::N; ++i) stage[lane * V::N + i] = packed[i];
        __syncwarp();
        uint4* dst16 = reinterpret_cast<uint4*>(dst + static_cast<size_t>(q0) * VALS);
#pragma unroll
        for (int i = 0; i < V::N; ++i) {
          const int c = lane + 32 * i;
          if (c < valid_chunks) st_global_cs(dst16 + c, stage[c]);
        }
        __syncwarp();
      } else if (q0 + lane < n_steps) {
        T* row = dst + static_cast<size_t>(r) * size * 3;
#pragma unroll
        for (int p = 0; p < GROUP; ++p) {
          const int x = g * GROUP + p;
          if (x < size) {
#pragma unroll
            for (int c = 0; c < 3; ++c) row[3 * x + c] = adv::from_float<T>(v[3 * p + c]);
          }
        }
      }
    }
  }
}

template <typename T, bool VECTOR, bool WHOLE>
int launch(const void* frames, void* out, int gc, int fpc, int height, int width, int size,
           const Plan& plan, float mean, float inv_std, cudaStream_t stream) {
  auto kernel = crop_norm_kernel<T, VECTOR, WHOLE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.shared_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ctas = static_cast<unsigned>(gc) * fpc * plan.n_bands;
  kernel<<<ctas, THREADS, plan.shared_bytes, stream>>>(static_cast<const uint8_t*>(frames),
                                                        static_cast<T*>(out), fpc, height, width,
                                                        size, plan, mean, inv_std);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for(const void* frames, void* out, int gc, int fpc, int height, int width, int size,
               const Plan& plan, float mean, float inv_std, cudaStream_t s) {
  if (plan.whole_rows)
    return plan.vector
               ? launch<T, true, true>(frames, out, gc, fpc, height, width, size, plan, mean,
                                       inv_std, s)
               : launch<T, false, true>(frames, out, gc, fpc, height, width, size, plan, mean,
                                        inv_std, s);
  return plan.vector ? launch<T, true, false>(frames, out, gc, fpc, height, width, size, plan,
                                              mean, inv_std, s)
                     : launch<T, false, false>(frames, out, gc, fpc, height, width, size, plan,
                                               mean, inv_std, s);
}

}  // namespace

// plan: the CropNormPlan.ints() of crop_norm_plan(height, width, size, dtype).
extern "C" int adv_crop_norm(const void* frames, void* out, int out_bf16, int gc, int fpc,
                             int height, int width, int size, const int* plan_ints, float mean,
                             float inv_std, void* stream) {
  static_assert(sizeof(Plan) == 57 * sizeof(int), "Plan must match CropNormPlan.ints()");
  Plan plan;
  memcpy(&plan, plan_ints, sizeof(Plan));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_for<__nv_bfloat16>(frames, out, gc, fpc, height, width, size, plan, mean,
                                     inv_std, s);
  return launch_for<float>(frames, out, gc, fpc, height, width, size, plan, mean, inv_std, s);
}
