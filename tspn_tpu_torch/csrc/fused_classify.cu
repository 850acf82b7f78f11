// Fused L1 normalization + predicate classifier for Hopper (sm_90a), f32.
//
// Replaces tspn_tpu/ops/pairwise.py::normalize_classify_pallas (Pallas
// kernel _kernel). For device-layout rows x (P, D) f32, weights W (D, R)
// f32 row-major and bias b (R,) f32 it computes
//
//     out[p, r] = sum_{c < hp} x[p, c] W[c, r]
//               + sum_k sum_{c in seg_k} (x[p, c] * inv[p, k]) W[c, r] + b[r]
//
// with seg_k = [hp + k*blk, hp + (k+1)*blk), s = sum_{c in seg_k} |x[p, c]|
// in f32 and inv[p, k] = s > 0 ? 1/s : 1: the head slab passes through,
// each BoW block is L1-normalized by a reciprocal multiply (a zero block
// keeps scale 1), the product accumulates in f32, then the bias is added.
// D = hp + nb*blk; VidVRD rows are hp 3072 + 8 x 1024 = 11264 wide.
//
// Design. A 2-D grid: blockIdx.x walks 64-row tiles, blockIdx.y 144-column
// tiles of R (one tile for the 132 VidVRD predicates). 256 threads each
// own a 4-row x 9-column f32 accumulator. The block first takes the L1
// sum of every (row, block) pair of its tile, one warp per row with
// 16-byte loads and a shuffle reduction, and keeps the reciprocals in
// shared memory. It then walks K in 32-column chunks: a chunk never
// straddles two segments (hp and blk are multiples of 32), so it stages
// x already multiplied by its row's reciprocal, transposed into a padded
// shared tile, stages the matching 32 rows of W, and accumulates with
// FMAs on the CUDA cores (no TF32: the result agrees with the plain f32
// product up to summation order). Rows >= P and columns >= R load zeros
// and store nothing, so neither x nor W is padded in memory.
//
// What bounds it on the card: at a training step (P 7936, D 11264,
// R 132) the product is 23.6 GFLOP over 357 MB of rows, about 66 FLOP
// per byte, so in f32 on the CUDA cores (67 TFLOP/s) it is bound by
// arithmetic, not by HBM. This first kernel reads every row twice (the
// sums, then the product) and runs no tensor-core instruction; TF32 or
// bf16 wgmma is the later redesign.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // rows of x per block
constexpr int kTx = 16;        // column lanes
constexpr int kTy = 16;        // row lanes
constexpr int kNi = kRows / kTy;  // rows per thread (4)
constexpr int kNj = 9;         // columns per thread
constexpr int kCols = kTx * kNj;  // columns per block (144)
constexpr int kChunk = 32;     // K columns per stage
constexpr int kThreads = kTx * kTy;
constexpr int kMaxSegs = 16;   // head + at most 15 blocks
constexpr int kXStride = kRows + 1;  // padded: conflict-free transposed stores

__global__ void __launch_bounds__(kThreads)
fused_classify_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int P, int R, int D, int hp, int blk, int nb) {
  __shared__ float xs[kChunk * kXStride];
  __shared__ float ws[kChunk * kCols];
  __shared__ float inv[kRows * kMaxSegs];

  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // 1. per-row block reciprocals: one warp per row, 16-byte loads
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int row = row0 + r;
    if (lane == 0) inv[r * kMaxSegs] = 1.0f;
    for (int k = 0; k < nb; ++k) {
      float s = 0.0f;
      if (row < P) {
        const float* src = x + (size_t)row * D + hp + (size_t)k * blk;
        for (int c = lane * 4; c < blk; c += 128) {
          const float4 v = *reinterpret_cast<const float4*>(src + c);
          s += fabsf(v.x) + fabsf(v.y) + fabsf(v.z) + fabsf(v.w);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) inv[r * kMaxSegs + 1 + k] = s > 0.0f ? 1.0f / s : 1.0f;
    }
  }
  __syncthreads();

  // 2. the product, 32 columns of K at a time
  const int tx = tid % kTx;  // columns tx + 16*j
  const int ty = tid / kTx;  // rows ty + 16*i
  float acc[kNi][kNj];
#pragma unroll
  for (int i = 0; i < kNi; ++i)
#pragma unroll
    for (int j = 0; j < kNj; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += kChunk) {
    const int seg = k0 < hp ? 0 : 1 + (k0 - hp) / blk;
    // x: 64 rows x 8 float4 = 512 loads, two per thread
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int f = tid + m * kThreads;
      const int r = f / (kChunk / 4);
      const int kq = f % (kChunk / 4);
      const int row = row0 + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < P)
        v = *reinterpret_cast<const float4*>(x + (size_t)row * D + k0 + kq * 4);
      const float sc = inv[r * kMaxSegs + seg];
      xs[(kq * 4 + 0) * kXStride + r] = v.x * sc;
      xs[(kq * 4 + 1) * kXStride + r] = v.y * sc;
      xs[(kq * 4 + 2) * kXStride + r] = v.z * sc;
      xs[(kq * 4 + 3) * kXStride + r] = v.w * sc;
    }
    // W: 32 rows x 144 columns, coalesced along R
#pragma unroll
    for (int m = 0; m < kChunk * kCols / kThreads; ++m) {
      const int e = tid + m * kThreads;
      const int kk = e / kCols;
      const int c = e % kCols;
      const int col = col0 + c;
      ws[e] = col < R ? w[(size_t)(k0 + kk) * R + col] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[kNi], b[kNj];
#pragma unroll
      for (int i = 0; i < kNi; ++i) a[i] = xs[kk * kXStride + ty + kTy * i];
#pragma unroll
      for (int j = 0; j < kNj; ++j) b[j] = ws[kk * kCols + tx + kTx * j];
#pragma unroll
      for (int i = 0; i < kNi; ++i)
#pragma unroll
        for (int j = 0; j < kNj; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kNi; ++i) {
    const int row = row0 + ty + kTy * i;
    if (row >= P) continue;
#pragma unroll
    for (int j = 0; j < kNj; ++j) {
      const int col = col0 + tx + kTx * j;
      if (col < R) out[(size_t)row * R + col] = acc[i][j] + bias[col];
    }
  }
}

}  // namespace

// C entry for ctypes. Launches on `stream` and returns cudaGetLastError()
// (0 = launched). Preconditions, checked by the Python wrapper: all
// tensors f32, contiguous and on one device, x 16-byte aligned, hp and
// blk multiples of 32, D == hp + nb*blk with nb <= 15.
extern "C" int tspn_fused_classify_launch(const void* x, const void* w,
                                          const void* bias, void* out, int P,
                                          int R, int D, int hp, int blk,
                                          void* stream) {
  if (P <= 0 || R <= 0 || hp < 0 || blk <= 0 || hp % kChunk || blk % kChunk ||
      D < hp || (D - hp) % blk)
    return (int)cudaErrorInvalidValue;
  const int nb = (D - hp) / blk;
  if (nb >= kMaxSegs) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((P + kRows - 1) / kRows),
                  (unsigned)((R + kCols - 1) / kCols));
  fused_classify_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const float*)bias, (float*)out, P, R,
      D, hp, blk, nb);
  return (int)cudaGetLastError();
}
