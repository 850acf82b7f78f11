// int8 features x bf16 weights, segmented, for Hopper (sm_90a).
//
// Replaces tspn_tpu/ops/pairwise.py::normalize_classify_q8_pallas (Pallas
// kernel _kernel_q8). For rows p < P and output columns r < R:
//
//     acc  = f32(q[p, 0:hp] . w_t[r, 0:hp]) * head_scale[p]
//     acc += f32(q[p, seg_k] . w_t[r, seg_k]) * inv[p, k]      k = 0..nb-1
//     out[p, r] = acc + b[r]
//
// where seg_k = [hp + k*blk, hp + (k+1)*blk), D = hp + nb*blk, and
// inv[p, k] = 1/L1 of the int8 block (1 where the block is zero), computed
// in the kernel. q is (P, D) int8 row-major (to_device_layout_q8), w_t the
// classifier's device-layout weights rounded to bf16 and transposed once
// to K-major (R, D), head_scale (P,) and b (R,) f32. Each int8 value is
// exact in bf16 and each product exact in f32; the products are summed in
// f32 by the tensor cores, so the result agrees with the plain version
// (float64 sums) up to summation order.
//
// Design. K2's shape (csrc/q8f_fused.cu) with bf16 operands: one block of
// 8 warps computes a 64-row x 144-column tile, so at R = 132 one column
// tile covers every predicate and each row is read from HBM once. The K
// walk moves 64-element chunks (64 int8 bytes of q, 128 bf16 bytes of w_t
// a row) into shared memory with cp.async through a three-stage ring.
// Warp w owns 16 rows (w % 4) x 72 columns (w / 4) and multiplies with
// mma.sync.m16n8k16 bf16 -> f32: its A fragment is read as int8 pairs and
// converted to bf16 in registers (the float's upper half, exact), then
// used for nine n8 tiles. While a chunk is resident, the 4 threads of
// each row also sum |q| over it (__vabs4 and an unsigned __dp4a); at a
// block's last chunk they add their sums with two shuffles and keep
// __fdiv_rn(1, L1) in shared memory. Every segment end is a multiple of
// 64, so a segment closes at a chunk boundary: the f32 partial is scaled
// and folded (__fmul_rn, __fadd_rn) in the order head, block 0, ...,
// then b is added.
//
// What bounds it on the card: at the serve batch (P 95,232, D 11,264,
// R 132) it reads 1.07 GB of int8 rows for 0.28 TFLOP, about 264 bf16
// FLOP per byte, under the H100's bf16 ridge of about 295: bytes bound,
// about 0.34 ms at 3.35 TB/s, with the bf16 tensor-core time (0.29 ms)
// close behind. This first version holds one tile of 144 columns per
// block and converts the A fragment per chunk; wgmma with TMA is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kTileCols = 144;
constexpr int kNTiles = kTileCols / 2 / 8;    // n8 tiles per warp: 9
constexpr int kChunk = 64;                    // K elements per stage
constexpr int kAStride = kChunk / 4 + 4;      // words: 64 int8 + 16 pad bytes
constexpr int kBStride = kChunk / 2 + 4;      // words: 64 bf16 + 16 pad bytes
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kStageWords = kTileRows * kAStride + kTileCols * kBStride;
constexpr int kSmemBytes = kStages * kStageWords * 4;  // 77,568

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src, bool full) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 (bytes 0 and 1 of v) -> two bf16, the lower K index in the low
// half; an integer of at most 8 bits is exact in bf16, the upper half of
// its f32
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t v) {
  const uint32_t lo = __float_as_uint(__int2float_rn((int8_t)(v & 0xff)));
  const uint32_t hi = __float_as_uint(__int2float_rn((int8_t)((v >> 8) & 0xff)));
  return (lo >> 16) | (hi & 0xffff0000u);
}

__global__ void __launch_bounds__(kThreads)
q8_bf16_kernel(const int8_t* __restrict__ q, const float* __restrict__ head_scale,
               const uint16_t* __restrict__ w_t, const float* __restrict__ bias,
               float* __restrict__ out, int P, int R, int D, int hp, int blk) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float inv_s[kTileRows];

  const int row0 = blockIdx.x * kTileRows;
  const int col0 = blockIdx.y * kTileCols;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (A, C) or column (B) in its tile
  const int t = lane % 4;  // fragment pair along K
  const int wrow = (warp % 4) * 16;
  const int wcol = (warp / 4) * (kTileCols / 2);

  // one chunk of q (64 rows x 4 copies) and w_t (144 rows x 8 copies)
  auto load_stage = [&](int stage, int k0) {
    uint32_t* xs = smem + stage * kStageWords;
    uint32_t* ws = xs + kTileRows * kAStride;
    {
      const int r = tid / 4, c = tid % 4;
      const bool ok = row0 + r < P;
      const int8_t* src = ok ? q + (size_t)(row0 + r) * D + k0 + c * 16 : q;
      cp_async16(xs + r * kAStride + c * 4, src, ok);
    }
    for (int e = tid; e < kTileCols * 8; e += kThreads) {
      const int r = e / 8, c = e % 8;
      const bool ok = col0 + r < R;
      const uint16_t* src = ok ? w_t + (size_t)(col0 + r) * D + k0 + c * 8 : w_t;
      cp_async16(ws + r * kBStride + c * 4, src, ok);
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::); };

  float acc[kNTiles][4], facc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[j][i] = 0.0f;
      facc[j][i] = 0.0f;
    }

  const int chunks = D / kChunk;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load_stage(c, c * kChunk);
    commit();
  }
  int seg = 0;
  int seg_end = hp;
  unsigned l1 = 0;  // this thread's part of its row's |q| sum over the block
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // chunk c visible to all; stage (c - 1) % kStages free
    const int next = c + kStages - 1;
    if (next < chunks) load_stage(next % kStages, next * kChunk);
    commit();
    const uint32_t* xs = smem + (c % kStages) * kStageWords;
    const uint32_t* ws = xs + kTileRows * kAStride;
    const bool closes = (c + 1) * kChunk == seg_end;

    if (seg > 0) {
      const uint32_t* mine = xs + (tid / 4) * kAStride + (tid % 4) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) l1 = __dp4a(__vabs4(mine[i]), 0x01010101u, l1);
      if (closes) {
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        if (tid % 4 == 0) inv_s[tid / 4] = l1 ? __fdiv_rn(1.0f, __uint2float_rn(l1)) : 1.0f;
        l1 = 0;
      }
    }

    const uint16_t* xs16 = reinterpret_cast<const uint16_t*>(xs);
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      const int h = ks * 8 + t;  // int8 pair index along the A row
      const uint32_t af[4] = {
          int8x2_to_bf16x2(xs16[(wrow + g) * kAStride * 2 + h]),
          int8x2_to_bf16x2(xs16[(wrow + g + 8) * kAStride * 2 + h]),
          int8x2_to_bf16x2(xs16[(wrow + g) * kAStride * 2 + h + 4]),
          int8x2_to_bf16x2(xs16[(wrow + g + 8) * kAStride * 2 + h + 4])};
      const int kw = ks * 8 + t;  // bf16 pair (word) index along the B row
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const uint32_t* wrow_s = ws + (wcol + j * 8 + g) * kBStride;
        mma_bf16(acc[j], af, wrow_s[kw], wrow_s[kw + 4]);
      }
    }

    if (closes) {
      __syncthreads();  // inv_s written for this block
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wrow + g + 8 * hh;
        const float s = seg == 0 ? (row0 + r < P ? head_scale[row0 + r] : 0.0f) : inv_s[r];
#pragma unroll
        for (int j = 0; j < kNTiles; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float part = __fmul_rn(acc[j][hh * 2 + e], s);
            facc[j][hh * 2 + e] = seg == 0 ? part : __fadd_rn(facc[j][hh * 2 + e], part);
            acc[j][hh * 2 + e] = 0.0f;
          }
      }
      ++seg;
      seg_end += blk;
    }
  }

  // C fragment: facc[j][h*2 + e] is row wrow + g + 8h, column wcol + 8j + 2t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wrow + g + 8 * h;
    if (row >= P) continue;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + wcol + j * 8 + 2 * t + e;
        if (col < R) out[(size_t)row * R + col] = __fadd_rn(facc[j][h * 2 + e], bias[col]);
      }
  }
}

}  // namespace

// C entry for ctypes. Launches on `stream` and returns cudaGetLastError()
// (0 = launched). Preconditions, checked by the Python wrapper: all
// tensors contiguous and on one device, q and w_t 16-byte aligned, w_t
// bf16, hp, blk and D multiples of 64, D == hp + nb*blk.
extern "C" int tspn_q8_bf16_launch(const void* q, const void* head_scale,
                                   const void* w_t, const void* bias, void* out,
                                   int P, int R, int D, int hp, int blk,
                                   void* stream) {
  const long long row_tiles = ((long long)P + kTileRows - 1) / kTileRows;
  const int col_tiles = (R + kTileCols - 1) / kTileCols;
  if (P <= 0 || R <= 0 || D <= 0 || D % kChunk || hp % kChunk || blk <= 0 ||
      blk % kChunk || row_tiles > 0x7fffffffLL || col_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  // the ring is above the 48 KB a block gets without asking (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      q8_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  q8_bf16_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)head_scale, (const uint16_t*)w_t,
      (const float*)bias, (float*)out, P, R, D, hp, blk);
  return (int)cudaGetLastError();
}
