// K4, the int8 x int8 segmented pair scorer with in-kernel block scales,
// for sm_90a on the CUDA cores (dp4a). Of the dp4a template that K1, K4 and
// K6 shared, this file keeps K4's instantiation alone; K1 and K6 run on
// wgmma in csrc/q8s_sm90.cu.
//
// K4 replaces tspn_tpu/ops/pairwise.py::normalize_classify_q8i8_pallas
// (Pallas kernel _kernel_q8i8). It computes K1's function, for rows p < P
// and output columns r < R,
//
//     acc  = int32(q[p, 0:hp] . qw_t[r, 0:hp]) * head_scale[p]
//     acc += int32(q[p, seg_k] . qw_t[r, seg_k]) * inv_k[p]   k = 0..nb-1
//     out[p, r] = acc * sw[r] + b[r]
//
// where seg_k = [hp + k*blk, hp + (k+1)*blk) and inv_k[p] is 1/L1 of the
// int8 block seg_k of row p (1 where the block is zero), computed in the
// kernel. q is (P, D) int8 row-major, qw_t (R, D) int8 K-major, head_scale
// (P,), sw and b (R,) f32. The 4 threads that stage a row sum |q| over
// their 16 bytes of each chunk (__vabs4 then an unsigned __dp4a, so -128
// counts 128); at the block's last chunk they add their sums with two
// shuffles and write __fdiv_rn(1, L1) to shared memory. L1 <= 128 * 1024 <
// 2^24, so the f32 sum is exact and the quotient equals
// precompute_q8_scales' bit for bit: K4 equals K1 fed those scales.
//
// Design. One thread block computes a 64-row x 64-column output tile with
// 256 threads; each thread keeps a 4 x 4 int32 micro-tile and a 4 x 4 f32
// accumulator. The K loop stages 64-byte chunks of q and qw_t in shared
// memory (one 16-byte global load per thread per operand) and multiplies
// them with __dp4a. Every segment end is a multiple of 64, so a segment
// closes at a chunk boundary: the int32 partial is converted to f32,
// scaled and folded into the f32 accumulator, in the order head, block 0,
// ..., block nb-1. The f32 arithmetic uses __fmul_rn and __fadd_rn so that
// nvcc cannot contract it into FMAs: the result is then bit-identical to
// the plain PyTorch version in tspn_tpu_torch/ops/pairwise.py.
//
// What bounds it on the card: reading q once (about 0.34 ms for the 1.07
// GB of the 95,232 x 11,264 rows of the pair-kernel bench) is the least
// time; on dp4a, with R padded to a multiple of 64, the kernel is bound by
// dp4a issue instead. K4 has no caller on the main path (nor in the JAX
// package); its redesign on wgmma is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kChunk = 64;                 // bytes of K per stage
constexpr int kWords = kChunk / 4;         // int32 words of K per stage
constexpr int kStride = kWords + 1;        // padded smem row: no bank conflicts
constexpr int kThreads = 256;

// q (P, D), head_scale (P,), out f32 (P, R)
__global__ void __launch_bounds__(kThreads)
q8i8_kernel(const int8_t* __restrict__ q, const float* __restrict__ head_scale,
            const int8_t* __restrict__ qw_t, const float* __restrict__ sw,
            const float* __restrict__ bias, float* __restrict__ out,
            int P, int R, int D, int hp, int blk, int col_tiles) {
  __shared__ int32_t a_s[kTileRows * kStride];
  __shared__ int32_t b_s[kTileCols * kStride];
  __shared__ float inv_s[2][kTileRows];  // 1/L1 of the closing block

  const int tile = blockIdx.x;
  const int row0 = (tile / col_tiles) * kTileRows;
  const int col0 = (tile % col_tiles) * kTileCols;
  const int tid = threadIdx.x;
  // the micro-tile holds pairs p_lane + 16*i and outputs r_lane + 16*j;
  // the fast lane runs along the output's contiguous axis
  const int r_lane = tid % 16;
  const int p_lane = tid / 16;

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

  unsigned l1 = 0;  // this thread's part of its row's |q| sum
  int seg = 0;
  int seg_end = hp;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    const int4 av = a_ok ? *reinterpret_cast<const int4*>(a_src + k0) : make_int4(0, 0, 0, 0);
    const int4 bv = b_ok ? *reinterpret_cast<const int4*>(b_src + k0)
                         : make_int4(0, 0, 0, 0);
    int32_t* a_dst = a_s + ld_row * kStride + ld_word;
    a_dst[0] = av.x; a_dst[1] = av.y; a_dst[2] = av.z; a_dst[3] = av.w;
    if (seg > 0) {
      l1 = __dp4a(__vabs4(av.x), 0x01010101u, l1);
      l1 = __dp4a(__vabs4(av.y), 0x01010101u, l1);
      l1 = __dp4a(__vabs4(av.z), 0x01010101u, l1);
      l1 = __dp4a(__vabs4(av.w), 0x01010101u, l1);
      if (k0 + kChunk == seg_end) {  // the block's last chunk
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        if (tid % 4 == 0)
          inv_s[seg & 1][ld_row] = l1 ? __fdiv_rn(1.0f, __uint2float_rn(l1)) : 1.0f;
        l1 = 0;
      }
    }
    int32_t* b_dst = b_s + ld_row * kStride + ld_word;
    b_dst[0] = bv.x; b_dst[1] = bv.y; b_dst[2] = bv.z; b_dst[3] = bv.w;
    __syncthreads();

#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      int32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[(p_lane + 16 * i) * kStride + w];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[(r_lane + 16 * j) * kStride + w];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) iacc[i][j] = __dp4a(a[i], b[j], iacc[i][j]);
    }
    __syncthreads();

    if (k0 + kChunk == seg_end) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + p_lane + 16 * i;
        // the row's head scale, then the in-kernel 1/L1
        const float s =
            seg == 0 ? (row < P ? head_scale[row] : 0.0f) : inv_s[seg & 1][p_lane + 16 * i];
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
    const int row = row0 + p_lane + 16 * i;
    if (row >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + r_lane + 16 * j;
      if (col >= R) continue;
      out[(size_t)row * R + col] = __fadd_rn(__fmul_rn(facc[i][j], sw[col]), bias[col]);
    }
  }
}

}  // namespace

// C entry for ctypes: launches on `stream` and returns cudaGetLastError()
// (0 = launched). Preconditions, checked by the Python wrapper: all
// tensors contiguous and on one device, the int8 operands 16-byte
// aligned, hp, blk and D multiples of 64, D == hp + nb*blk, nb <= 15.
extern "C" int tspn_q8i8_launch(const void* q, const void* head_scale,
                                const void* qw_t, const void* sw,
                                const void* bias, void* out, int P, int R,
                                int D, int hp, int blk, void* stream) {
  const int col_tiles = (R + kTileCols - 1) / kTileCols;
  const long long row_tiles = ((long long)P + kTileRows - 1) / kTileRows;
  const long long tiles = row_tiles * col_tiles;
  if (P <= 0 || R <= 0 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  q8i8_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)head_scale, (const int8_t*)qw_t, (const float*)sw,
      (const float*)bias, (float*)out, P, R, D, hp, blk, col_tiles);
  return (int)cudaGetLastError();
}
