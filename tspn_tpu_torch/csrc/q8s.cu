// int8 x int8 segmented pair scorers for Hopper (sm_90a): K1 and its
// variants K4 (in-kernel block scales) and K6 (transposed), as
// instantiations of one kernel template.
//
// K1 replaces tspn_tpu/ops/pairwise.py::normalize_classify_q8s_pallas
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
// The variants:
// - K4 replaces normalize_classify_q8i8_pallas (_kernel_q8i8): K1 with a
//   (P,) head scale in place of s, and each block's multiplier computed in
//   the kernel as 1/L1 of the int8 block (1 where the block is zero). The
//   4 threads that stage a row sum |q| over their 16 bytes of each chunk
//   (__vabs4 then an unsigned __dp4a, so -128 counts 128); at the block's
//   last chunk they add their sums with two shuffles and write
//   __fdiv_rn(1, L1) to shared memory. L1 <= 128 * 1024 < 2^24, so the
//   f32 sum is exact and the quotient equals precompute_q8_scales' bit
//   for bit: K4 equals K1 fed those scales.
// - K6 replaces normalize_classify_q8t_pallas (_kernel_q8t): K1 on
//   transposed operands, xt (D, P) int8 and s_t (16, P), giving (R, P).
//   The 4 K bytes that one dp4a multiplies are P apart in xt, so each
//   thread loads a 4 K-row x 4 pair block (four 4-byte loads; byte loads
//   where P is not a multiple of 4), transposes it in registers with
//   eight __byte_perm, and stores four words into the same pair-major
//   shared tile as K1's. The thread-to-block mapping puts the 32 lanes of
//   a warp on 32 distinct banks for every store. Same integer sums, same
//   f32 fold: K6 equals K1 transposed bit for bit.
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
// The variants differ only in `if constexpr` branches, so K1's own
// instantiation compiles to the code it had alone.
//
// What bounds it on the card: at R = 132 each int8 byte of q feeds 132
// multiply-adds (264 int ops), far below the H100's int8 tensor-core
// ridge, so a tensor-core kernel would be bound by streaming q from HBM
// (about 0.34 ms for the 1.07 GB of the 95,232 x 11,264 serve batch).
// These kernels run on the CUDA cores (dp4a), not the tensor cores, and
// pad R to a multiple of 64, so they are bound by dp4a issue rate rather
// than by HBM. wgmma with TMA-fed shared-memory rings is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kTileCols = 64;
constexpr int kChunk = 64;                 // bytes of K per stage
constexpr int kWords = kChunk / 4;         // int32 words of K per stage
constexpr int kStride = kWords + 1;        // padded smem row: no bank conflicts
constexpr int kThreads = 256;

enum Mode { kQ8s, kQ8i8, kQ8t };

// 4 K rows (r[i] holds pairs p..p+3 of row k+i) -> 4 pair words (c[j]
// holds K rows k..k+3 of pair p+j), byte i of c[j] = byte j of r[i]
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// kQ8s:   q (P, D), scales (P, 16), out f32 (P, R)
// kQ8i8:  q (P, D), scales = head scale (P,), out f32 (P, R)
// kQ8t:   q = xt (D, P), scales = s_t (16, P), out f32 (R, P)
template <int kMode>
__global__ void __launch_bounds__(kThreads)
q8s_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
           const int8_t* __restrict__ qw_t, const float* __restrict__ sw,
           const float* __restrict__ bias, void* __restrict__ out_,
           int P, int R, int D, int hp, int blk, int col_tiles) {
  constexpr bool kTransposed = kMode == kQ8t;
  __shared__ int32_t a_s[kTileRows * kStride];
  __shared__ int32_t b_s[kTileCols * kStride];
  __shared__ float inv_s[2][kTileRows];  // K4: 1/L1 of the closing block

  const int tile = blockIdx.x;
  const int row0 = (tile / col_tiles) * kTileRows;
  const int col0 = (tile % col_tiles) * kTileCols;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // the micro-tile holds pairs p_lane + 16*i and outputs r_lane + 16*j;
  // the fast lane runs along the output's contiguous axis
  const int p_lane = kTransposed ? tx : ty;
  const int r_lane = kTransposed ? ty : tx;

  // staging: thread tid copies 16 bytes (4 words) of one row of each operand
  const int ld_row = tid / 4;
  const int ld_word = (tid % 4) * 4;
  const bool a_ok = row0 + ld_row < P;
  const bool b_ok = col0 + ld_row < R;
  const int8_t* a_src = q + (size_t)(row0 + ld_row) * D + ld_word * 4;
  const int8_t* b_src = qw_t + (size_t)(col0 + ld_row) * D + ld_word * 4;
  // transposed staging: thread (pg, kw) reads K rows 4kw..4kw+3 of pairs
  // 4pg..4pg+3; within a warp pg % 8 and kw % 4 run over all 32 pairs,
  // so its four stores hit 32 distinct banks
  const int warp = tid / 32, lane = tid % 32;
  const int pg = (lane & 7) + 8 * (warp & 1);
  const int kw = (lane >> 3) + 4 * (warp >> 1);
  const bool vec = P % 4 == 0;

  int32_t iacc[4][4];
  float facc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      iacc[i][j] = 0;
      facc[i][j] = 0.0f;
    }

  unsigned l1 = 0;  // K4: this thread's part of its row's |q| sum
  int seg = 0;
  int seg_end = hp;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    int4 av;
    if constexpr (!kTransposed)
      av = a_ok ? *reinterpret_cast<const int4*>(a_src + k0) : make_int4(0, 0, 0, 0);
    const int4 bv = b_ok ? *reinterpret_cast<const int4*>(b_src + k0)
                         : make_int4(0, 0, 0, 0);
    if constexpr (kTransposed) {
      uint32_t c[4];
      const int p = row0 + 4 * pg;
      const int8_t* src = q + (size_t)(k0 + 4 * kw) * P + p;
      if (vec) {
        uint32_t r[4] = {0, 0, 0, 0};
        if (p < P) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = *reinterpret_cast<const uint32_t*>(src + (size_t)i * P);
        }
        transpose4x4(r, c);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          c[j] = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (p + j < P)
              c[j] |= (uint32_t)(uint8_t)src[(size_t)i * P + j] << (8 * i);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) a_s[(4 * pg + j) * kStride + kw] = (int32_t)c[j];
    } else {
      int32_t* a_dst = a_s + ld_row * kStride + ld_word;
      a_dst[0] = av.x; a_dst[1] = av.y; a_dst[2] = av.z; a_dst[3] = av.w;
      if constexpr (kMode == kQ8i8) {
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
        float s;
        if constexpr (kMode == kQ8s) {
          s = row < P ? scales[(size_t)row * 16 + seg] : 0.0f;
        } else if constexpr (kMode == kQ8t) {
          s = row < P ? scales[(size_t)seg * P + row] : 0.0f;
        } else {  // kQ8i8: the row's head scale, then the in-kernel 1/L1
          s = seg == 0 ? (row < P ? scales[row] : 0.0f) : inv_s[seg & 1][p_lane + 16 * i];
        }
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
      const float y = __fadd_rn(__fmul_rn(facc[i][j], sw[col]), bias[col]);
      if constexpr (kTransposed)
        static_cast<float*>(out_)[(size_t)col * P + row] = y;
      else
        static_cast<float*>(out_)[(size_t)row * R + col] = y;
    }
  }
}

template <int kMode>
int launch(const void* q, const void* scales, const void* qw_t, const void* sw,
           const void* bias, void* out, int P, int R, int D, int hp, int blk,
           void* stream) {
  const int col_tiles = (R + kTileCols - 1) / kTileCols;
  const long long row_tiles = ((long long)P + kTileRows - 1) / kTileRows;
  const long long tiles = row_tiles * col_tiles;
  if (P <= 0 || R <= 0 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  q8s_kernel<kMode><<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scales, (const int8_t*)qw_t,
      (const float*)sw, (const float*)bias, out, P, R, D, hp, blk, col_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched). Preconditions, checked by the Python
// wrappers: all tensors contiguous and on one device, the int8 operands
// 16-byte aligned, hp, blk and D multiples of 64, D == hp + nb*blk,
// nb <= 15.
extern "C" int tspn_q8s_launch(const void* q, const void* scales,
                               const void* qw_t, const void* sw,
                               const void* bias, void* out, int P, int R,
                               int D, int hp, int blk, void* stream) {
  return launch<kQ8s>(q, scales, qw_t, sw, bias, out, P, R, D, hp, blk, stream);
}

// head_scale (P,) in place of K1's (P, 16) scales
extern "C" int tspn_q8i8_launch(const void* q, const void* head_scale,
                                const void* qw_t, const void* sw,
                                const void* bias, void* out, int P, int R,
                                int D, int hp, int blk, void* stream) {
  return launch<kQ8i8>(q, head_scale, qw_t, sw, bias, out, P, R, D, hp, blk, stream);
}

// xt (D, P), scales_t (16, P) -> out (R, P)
extern "C" int tspn_q8t_launch(const void* xt, const void* scales_t,
                               const void* qw_t, const void* sw,
                               const void* bias, void* out, int P, int R,
                               int D, int hp, int blk, void* stream) {
  return launch<kQ8t>(xt, scales_t, qw_t, sw, bias, out, P, R, D, hp, blk, stream);
}
