// Fused L1 normalization + predicate classifier for Hopper (sm_90a), bf16.
//
// Replaces the bf16 half of tspn_tpu/ops/pairwise.py::normalize_classify_pallas
// (Pallas kernel _kernel), the path a model with MODEL.DTYPE bfloat16 takes.
// For device-layout rows x (P, D) bf16, weights w_t (R, D) bf16 (the
// classifier's device-layout kernel rounded to bf16 by RNE and transposed
// once to K-major, ops/pairwise.py::weights_bf16_t) and bias b (R,) f32:
//
//     s_k     = sum_{c in seg_k} |x[p, c]|                       (f32)
//     inv_k   = s_k > 0 ? 1 / s_k : 1                            (IEEE divide)
//     xn[p,c] = x[p, c]                          for c < hp       (head)
//             = bf16_rne(f32(x[p, c]) * inv_k)   for c in seg_k   (BoW block k)
//     out[p, r] = sum_c f32(xn[p, c]) * f32(w_t[r, c]) + b[r]    (f32)
//
// with seg_k = [hp + k*blk, hp + (k+1)*blk) and D = hp + nb*blk (VidVRD:
// 3072 + 8 x 1024 = 11264). That is the TPU kernel's order: the block is
// normalized in f32 and rounded to bf16 BEFORE the product, which then
// multiplies bf16 by bf16 with f32 accumulation (each product is exact in
// f32), and the f32 bias is added last.
//
// Design. K5's shape (csrc/q8_bf16.cu): one block of 8 warps computes a
// 64-row x 144-column tile, so at R = 132 one column tile covers every
// predicate. Unlike K5, which scales f32 partial sums after the product,
// the scale must be applied to the operand, so the block works in two
// passes over its rows:
//  1. L1 sums, while the ring's first (head) chunks arrive: four rows at a
//     time, every thread reads 16-byte words of each row's BoW region
//     (sixteen loads in flight), sums |x| in f32, and each warp reduces its
//     256 elements with shuffles into a slot; each block's slots are added
//     in a fixed order and inv_k of (row, block) kept in shared memory.
//  2. The product: the K walk moves 64-element chunks of x and w_t (128
//     bytes a row) into shared memory with cp.async through a three-stage
//     ring. A chunk never straddles two segments (hp and blk are multiples
//     of 64). When a BoW chunk has landed, the block rescales it in place
//     (f32 multiply by inv_k, round to nearest even to bf16) and syncs;
//     then warp w, owning 16 rows (w % 4) x 72 columns (w / 4), loads its
//     A fragments as bf16 pairs and runs mma.sync.m16n8k16 bf16 -> f32 on
//     nine n8 tiles. Rows >= P and columns >= R load zeros (cp.async with
//     src size 0) and store nothing.
//
// What bounds it on the card: at a training step (P 7936, D 11264, R 132)
// the call must move 186 MB (the bf16 rows once, W, the f32 output), 0.0555
// ms at 3.35 TB/s, against 23.6 GFLOP, 0.024 ms on the bf16 tensor cores:
// bytes bound. This first version reads each row twice (pass 1, then the
// ring), so it moves about twice the bound's bytes; keeping a whole
// 64 x blk A block resident in shared memory (128 KB) while W streams
// would read it once, and wgmma with TMA is the later redesign.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kTileCols = 144;
constexpr int kNTiles = kTileCols / 2 / 8;    // n8 tiles per warp: 9
constexpr int kChunk = 64;                    // K elements per stage
constexpr int kStride = kChunk / 2 + 4;       // words: 64 bf16 + 16 pad bytes
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMaxSegs = 16;                  // head + at most 15 blocks
constexpr int kP1Rows = 4;                    // rows per step of pass 1
constexpr int kMaxSlots = 64;                 // 256-element slots of a row's BoW region
constexpr int kStageWords = (kTileRows + kTileCols) * kStride;
constexpr int kSmemBytes = kStages * kStageWords * 4;  // 89,856

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

// the two bf16 of a word as f32: the lower K index is the low half
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float s) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(bf16_lo(v), s)));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(bf16_hi(v), s)));
  return lo | (hi << 16);
}

__global__ void __launch_bounds__(kThreads)
fused_classify_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w_t,
                           const float* __restrict__ bias, float* __restrict__ out,
                           int P, int R, int D, int hp, int blk) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float inv_s[kTileRows * kMaxSegs];
  __shared__ float part[kP1Rows][kMaxSlots];

  const int row0 = blockIdx.x * kTileRows;
  const int col0 = blockIdx.y * kTileCols;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nb = (D - hp) / blk;

  const int g = lane / 4;  // fragment row (A, C) or column (B) in its tile
  const int t = lane % 4;  // fragment pair along K
  const int wrow = (warp % 4) * 16;
  const int wcol = (warp / 4) * (kTileCols / 2);

  // one chunk of x (64 rows x 8 copies) and w_t (144 rows x 8 copies)
  auto load_stage = [&](int stage, int k0) {
    uint32_t* xs = smem + stage * kStageWords;
    uint32_t* ws = xs + kTileRows * kStride;
    for (int e = tid; e < kTileRows * 8; e += kThreads) {
      const int r = e / 8, c = e % 8;
      const bool ok = row0 + r < P;
      const uint16_t* src = ok ? x + (size_t)(row0 + r) * D + k0 + c * 8 : x;
      cp_async16(xs + r * kStride + c * 4, src, ok);
    }
    for (int e = tid; e < kTileCols * 8; e += kThreads) {
      const int r = e / 8, c = e % 8;
      const bool ok = col0 + r < R;
      const uint16_t* src = ok ? w_t + (size_t)(col0 + r) * D + k0 + c * 8 : w_t;
      cp_async16(ws + r * kStride + c * 4, src, ok);
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::); };

  float acc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  const int chunks = D / kChunk;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load_stage(c, c * kChunk);
    commit();
  }
  // pass 1, while the ring's first chunks (head columns, which need no
  // scale) arrive: inv_s[r * kMaxSegs + k] = 1 / L1 of block k of row r.
  // The block takes its rows kP1Rows at a time; thread tid reads the
  // 16-byte words u = tid + 256 j of each row's BoW region, so each warp's
  // 32 words (256 elements, inside one block as blk % 256 == 0) sum into
  // one slot of part, and each block's slots are then added in order.
  const int nbw = nb * blk / 8;  // 16-byte words of a row's BoW region
  const int spb = blk / 256;     // slots per block
  for (int r0 = 0; r0 < kTileRows; r0 += kP1Rows) {
    for (int jb = 0; jb * 4 * kThreads < nbw; ++jb) {
      uint4 v[kP1Rows][4];
#pragma unroll
      for (int rr = 0; rr < kP1Rows; ++rr)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = tid + (4 * jb + j) * kThreads;
          v[rr][j] = make_uint4(0u, 0u, 0u, 0u);
          if (row0 + r0 + rr < P && u < nbw)
            v[rr][j] = *reinterpret_cast<const uint4*>(
                x + (size_t)(row0 + r0 + rr) * D + hp + (size_t)u * 8);
        }
#pragma unroll
      for (int rr = 0; rr < kP1Rows; ++rr)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t words[4] = {v[rr][j].x, v[rr][j].y, v[rr][j].z, v[rr][j].w};
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s = __fadd_rn(s, fabsf(bf16_lo(words[i])));
            s = __fadd_rn(s, fabsf(bf16_hi(words[i])));
          }
#pragma unroll
          for (int o = 16; o > 0; o /= 2) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
          const int slot = (tid + (4 * jb + j) * kThreads) / 32;
          if (lane == 0 && slot * 32 < nbw) part[rr][slot] = s;
        }
    }
    __syncthreads();  // part complete for these rows
    if (tid < kP1Rows * nb) {
      const int rr = tid / nb, k = tid % nb;
      float s = 0.0f;
      for (int q = 0; q < spb; ++q) s = __fadd_rn(s, part[rr][k * spb + q]);
      inv_s[(r0 + rr) * kMaxSegs + k] = s > 0.0f ? __fdiv_rn(1.0f, s) : 1.0f;
    }
    __syncthreads();  // part free for the next rows
  }

  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // chunk c (and pass 1's inv_s) visible; stage (c - 1) free
    const int next = c + kStages - 1;
    if (next < chunks) load_stage(next % kStages, next * kChunk);
    commit();
    uint32_t* xs = smem + (c % kStages) * kStageWords;
    const uint32_t* ws = xs + kTileRows * kStride;

    const int k0 = c * kChunk;
    if (k0 >= hp) {  // a BoW chunk: normalize and round it in place
      const int k = (k0 - hp) / blk;
      for (int e = tid; e < kTileRows * (kChunk / 2); e += kThreads) {
        const int r = e / (kChunk / 2), wd = e % (kChunk / 2);
        xs[r * kStride + wd] = scale_pair(xs[r * kStride + wd], inv_s[r * kMaxSegs + k]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      const int kw = ks * 8 + t;  // bf16 pair (word) index along a row
      const uint32_t af[4] = {xs[(wrow + g) * kStride + kw], xs[(wrow + g + 8) * kStride + kw],
                              xs[(wrow + g) * kStride + kw + 4],
                              xs[(wrow + g + 8) * kStride + kw + 4]};
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const uint32_t* wrow_s = ws + (wcol + j * 8 + g) * kStride;
        mma_bf16(acc[j], af, wrow_s[kw], wrow_s[kw + 4]);
      }
    }
  }

  // C fragment: acc[j][h*2 + e] is row wrow + g + 8h, column wcol + 8j + 2t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wrow + g + 8 * h;
    if (row >= P) continue;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + wcol + j * 8 + 2 * t + e;
        if (col < R) out[(size_t)row * R + col] = __fadd_rn(acc[j][h * 2 + e], bias[col]);
      }
  }
}

}  // namespace

// C entry for ctypes. Launches on `stream` and returns cudaGetLastError()
// (0 = launched). Preconditions, checked by the Python wrapper: all
// tensors contiguous and on one device, x and w_t bf16 and 16-byte
// aligned, hp a multiple of 64 and blk of 256, D == hp + nb*blk with
// nb <= 15 and nb*blk <= 16384.
extern "C" int tspn_fused_classify_bf16_launch(const void* x, const void* w_t,
                                               const void* bias, void* out, int P, int R,
                                               int D, int hp, int blk, void* stream) {
  const long long row_tiles = ((long long)P + kTileRows - 1) / kTileRows;
  const int col_tiles = (R + kTileCols - 1) / kTileCols;
  if (P <= 0 || R <= 0 || D <= 0 || hp < 0 || hp % kChunk || blk <= 0 || blk % 256 ||
      (D - hp) % blk || (D - hp) / blk >= kMaxSegs || (D - hp) / 256 > kMaxSlots ||
      row_tiles > 0x7fffffffLL ||
      col_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  // the ring is above the 48 KB a block gets without asking (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      fused_classify_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  fused_classify_bf16_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const uint16_t*)x, (const uint16_t*)w_t, (const float*)bias, (float*)out, P, R, D,
      hp, blk);
  return (int)cudaGetLastError();
}
