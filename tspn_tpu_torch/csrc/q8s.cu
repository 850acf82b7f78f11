// int8 x int8 segmented pair scorer for Hopper (sm_90a).
//
// Replaces tspn_tpu/ops/pairwise.py::normalize_classify_q8s_pallas
// (Pallas kernel _kernel_q8s). It computes, for rows p < P and output
// columns r < R,
//
//     acc  = int32(q[p, 0:hp] . qw_t[r, 0:hp]) * s[p, 0]
//     acc += int32(q[p, seg_k] . qw_t[r, seg_k]) * s[p, k + 1]   k = 0..nb-1
//     out[p, r] = acc * sw[r] + b[r]
//
// where seg_k = [hp + k*blk, hp + (k+1)*blk). q is (P, D) int8 row-major,
// qw_t is (R, D) int8 K-major (the classifier's int8 weights transposed
// once at weight prep), s is (P, 16) f32 row multipliers (head scale and
// 1/L1 of each block), sw and b are (R,) f32. D = hp + nb*blk. One kernel
// serves the three geometries of the serve path: the expanded q8 rows
// (hp 3072, 8 x 1024), the factored tracklet rows (hp 128, 4 x 1024) and
// the factored relative rows (hp 3072, no blocks).
//
// Design. One thread block computes a 64-row x 64-column output tile with
// 256 threads; each thread keeps a 4 x 4 int32 micro-tile and a 4 x 4 f32
// accumulator. The K loop stages 64-byte chunks of q and qw_t in shared
// memory (one 16-byte global load per thread per operand) and multiplies
// them with __dp4a. Every segment end is a multiple of 64, so a segment
// closes at a chunk boundary: the int32 partial is converted to f32,
// scaled by s[p, seg] and folded into the f32 accumulator, in the order
// head, block 0, ..., block nb-1. The f32 arithmetic uses __fmul_rn and
// __fadd_rn so that nvcc cannot contract it into FMAs: the result is then
// bit-identical to the plain PyTorch version in tspn_tpu_torch/ops/pairwise.py.
//
// What bounds it on the card: at R = 132 each int8 byte of q feeds 132
// multiply-adds (264 int ops), far below the H100's int8 tensor-core
// ridge, so a tensor-core kernel would be bound by streaming q from HBM.
// This first kernel runs on the CUDA cores (dp4a), not the tensor cores,
// and pads R to a multiple of 64, so it is bound by dp4a issue rate
// rather than by HBM. wgmma with TMA-fed shared-memory rings is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kChunk = 64;                 // bytes of K per stage
constexpr int kWords = kChunk / 4;         // int32 words of K per stage
constexpr int kStride = kWords + 1;        // padded smem row: no bank conflicts
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
q8s_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
           const int8_t* __restrict__ qw_t, const float* __restrict__ sw,
           const float* __restrict__ bias, float* __restrict__ out,
           int P, int R, int D, int hp, int blk, int col_tiles) {
  __shared__ int32_t a_s[kTileRows * kStride];
  __shared__ int32_t b_s[kTileCols * kStride];

  const int tile = blockIdx.x;
  const int row0 = (tile / col_tiles) * kTileRows;
  const int col0 = (tile % col_tiles) * kTileCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column lane: columns tx + 16*j
  const int ty = tid / 16;  // row lane: rows ty + 16*i

  // staging: thread tid copies 16 bytes (4 words) of one row of each operand
  const int ld_row = tid / 4;
  const int ld_word = (tid % 4) * 4;
  const bool a_ok = row0 + ld_row < P;
  const bool b_ok = col0 + ld_row < R;
  const int8_t* a_src = q + (size_t)(row0 + ld_row) * D + ld_word * 4;
  const int8_t* b_src = qw_t + (size_t)(col0 + ld_row) * D + ld_word * 4;

  int32_t iacc[4][4];
  float facc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      iacc[i][j] = 0;
      facc[i][j] = 0.0f;
    }

  int seg = 0;
  int seg_end = hp;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    const int4 av = a_ok ? *reinterpret_cast<const int4*>(a_src + k0)
                         : make_int4(0, 0, 0, 0);
    const int4 bv = b_ok ? *reinterpret_cast<const int4*>(b_src + k0)
                         : make_int4(0, 0, 0, 0);
    int32_t* a_dst = a_s + ld_row * kStride + ld_word;
    int32_t* b_dst = b_s + ld_row * kStride + ld_word;
    a_dst[0] = av.x; a_dst[1] = av.y; a_dst[2] = av.z; a_dst[3] = av.w;
    b_dst[0] = bv.x; b_dst[1] = bv.y; b_dst[2] = bv.z; b_dst[3] = bv.w;
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[(ty + 16 * i) * kStride + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[(tx + 16 * j) * kStride + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) iacc[i][j] = __dp4a(a[i], b[j], iacc[i][j]);
    }
    __syncthreads();

    if (k0 + kChunk == seg_end) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + ty + 16 * i;
        const float s = row < P ? scales[(size_t)row * 16 + seg] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float part = __fmul_rn(__int2float_rn(iacc[i][j]), s);
          facc[i][j] = seg == 0 ? part : __fadd_rn(facc[i][j], part);
          iacc[i][j] = 0;
        }
      }
      ++seg;
      seg_end += blk;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < R)
        out[(size_t)row * R + col] =
            __fadd_rn(__fmul_rn(facc[i][j], sw[col]), bias[col]);
    }
  }
}

}  // namespace

// C entry for ctypes. Launches on `stream` and returns cudaGetLastError()
// (0 = launched). Preconditions, checked by the Python wrapper: all
// tensors contiguous and on one device, q and qw_t 16-byte aligned,
// hp, blk and D multiples of 64, D == hp + nb*blk, nb <= 15.
extern "C" int tspn_q8s_launch(const void* q, const void* scales,
                               const void* qw_t, const void* sw,
                               const void* bias, void* out, int P, int R,
                               int D, int hp, int blk, void* stream) {
  const int col_tiles = (R + kTileCols - 1) / kTileCols;
  const long long row_tiles = ((long long)P + kTileRows - 1) / kTileRows;
  const long long tiles = row_tiles * col_tiles;
  if (P <= 0 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  q8s_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scales, (const int8_t*)qw_t,
      (const float*)sw, (const float*)bias, (float*)out, P, R, D, hp, blk,
      col_tiles);
  return (int)cudaGetLastError();
}
