// Factored int8 rel pass with the per-tracklet A-table add, for Hopper (sm_90a).
//
// Replaces tspn_tpu/ops/pairwise.py::factored_classify_q8_fused (:1071),
// whose Pallas kernel is _kernel_q8f_fused (:1048). For rel rows
// p < rows (rows = B * P, segment b = p / P) and output columns r < R:
//
//     acc       = int32(x[p, :] . qw_t[r, :])
//     y         = (f32(acc) * s[p]) * sw[r] + bias[r]
//     out[p, r] = y + (A[b, sub, r] + A[b, obj, R + r])
//
// where (sub, obj) = pairs[p] and a pair index outside [0, N) adds 0 and
// is never read. x is (rows, D) int8 row-major (the factored relative
// rows, D = 3072 for VidVRD), s the rows' dequant scale, qw_t (R, D) int8
// K-major (the rel block of the classifier, transposed once at weight
// prep), sw and bias (R,) f32, A (B, N, 2R) f32 the q8s tracklet pass
// [A_sub | A_obj]. The f32 epilogue uses __int2float_rn, __fmul_rn and
// __fadd_rn in that order, so nvcc cannot contract it into FMAs; the
// integer sum is exact; so the result equals the plain PyTorch version
// (ops/pairwise.py::factored_classify_q8_fused_plain) bit for bit.
//
// What bounds it on the card: each pair streams its 3,072 int8 bytes from
// HBM once and writes R f32 logits (about 3.1 KB + 0.5 KB per pair at
// R = 132), for 2 * 3072 * R integer operations, far below the int8
// tensor-core ridge: the bound is HBM bandwidth. The design's answer is
// the epilogue: the two-launch path (q8s rel pass, then a gather-add)
// writes the (P, R) rel logits to HBM and reads them back; here they stay
// in registers, and only A (a few hundred KB per batch, L2-resident) is
// read beside the rows.
//
// Design. One block of 8 warps computes a 64-row x 144-column output tile,
// so at R = 132 one column tile covers every predicate and each row is
// read from HBM once. The K walk moves 128-byte chunks of x and qw_t into
// shared memory with cp.async (16 bytes a copy, zero-filled past the
// ragged row and column edges) through a three-stage ring in dynamic
// shared memory, so two chunks are in flight while one is multiplied (a
// single stage in flight left each block waiting out one memory latency
// per chunk). Warp w owns 16 rows (w % 4) x 72 columns (w / 4) and
// multiplies on the int8 tensor cores with mma.sync.m16n8k32.s8 (exact
// int32 sums): per 32-byte K step one A fragment and nine B fragments,
// read from shared rows of 144 bytes, a stride at which the fragment
// reads do not conflict. Rows >= rows and columns >= R store nothing. The
// TPU kernel's 32-row padding, 132 -> 256 lane padding and float-packed
// index sidecar are not carried over: indices come as an int32 (rows, 2)
// tensor. wgmma fed by TMA is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 64;
constexpr int kTileCols = 144;
constexpr int kNTiles = kTileCols / 2 / 8;   // n8 tiles per warp: 9
constexpr int kChunk = 128;                  // bytes of K per stage
constexpr int kCopies = kChunk / 16;         // 16-byte copies per row
constexpr int kStrideWords = kChunk / 4 + 4; // smem row: 128 bytes + 16 pad
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kStageWords = (kTileRows + kTileCols) * kStrideWords;
constexpr int kSmemBytes = kStages * kStageWords * 4;  // 89,856

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src, bool full) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
q8f_fused_kernel(const int8_t* __restrict__ x, const float* __restrict__ s,
                 const int32_t* __restrict__ pairs,
                 const int8_t* __restrict__ qw_t, const float* __restrict__ sw,
                 const float* __restrict__ bias, const float* __restrict__ a,
                 float* __restrict__ out, int rows, int P, int N, int R, int D) {
  extern __shared__ __align__(16) uint32_t smem[];

  const int row0 = blockIdx.x * kTileRows;
  const int col0 = blockIdx.y * kTileCols;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (A, C) or column (B) in its tile
  const int t = lane % 4;  // fragment word along K
  const int wrow = (warp % 4) * 16;
  const int wcol = (warp / 4) * (kTileCols / 2);

  // one chunk of x (64 rows) and qw_t (144 rows), kCopies copies a row
  auto load_stage = [&](int stage, int k0) {
    uint32_t* xs = smem + stage * kStageWords;
    uint32_t* ws = xs + kTileRows * kStrideWords;
    for (int e = tid; e < kTileRows * kCopies; e += kThreads) {
      const int r = e / kCopies, q = e % kCopies;
      const bool ok = row0 + r < rows;
      const int8_t* src = ok ? x + (size_t)(row0 + r) * D + k0 + q * 16 : x;
      cp_async16(xs + r * kStrideWords + q * 4, src, ok);
    }
    for (int e = tid; e < kTileCols * kCopies; e += kThreads) {
      const int r = e / kCopies, q = e % kCopies;
      const bool ok = col0 + r < R;
      const int8_t* src = ok ? qw_t + (size_t)(col0 + r) * D + k0 + q * 16 : qw_t;
      cp_async16(ws + r * kStrideWords + q * 4, src, ok);
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::); };

  int32_t acc[kNTiles][4];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  // one commit group per chunk (empty past the end), so that "all but the
  // newest kStages - 2 groups complete" means "chunk c has landed"
  const int chunks = D / kChunk;
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load_stage(c, c * kChunk);
    commit();
  }
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // chunk c visible to all; stage (c - 1) % kStages free
    const int next = c + kStages - 1;
    if (next < chunks) load_stage(next % kStages, next * kChunk);
    commit();
    const uint32_t* xs = smem + (c % kStages) * kStageWords;
    const uint32_t* ws = xs + kTileRows * kStrideWords;
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      const int kw = ks * 8 + t;
      const uint32_t af[4] = {
          xs[(wrow + g) * kStrideWords + kw], xs[(wrow + g + 8) * kStrideWords + kw],
          xs[(wrow + g) * kStrideWords + kw + 4], xs[(wrow + g + 8) * kStrideWords + kw + 4]};
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const uint32_t* wrow_s = ws + (wcol + j * 8 + g) * kStrideWords;
        mma_s8(acc[j], af, wrow_s[kw], wrow_s[kw + 4]);
      }
    }
  }

  // C fragment: acc[j][h*2 + e] is row wrow + g + 8h, column wcol + 8j + 2t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + wrow + g + 8 * h;
    if (row >= rows) continue;
    const int seg = row / P;
    const int sub = pairs[2 * (size_t)row];
    const int obj = pairs[2 * (size_t)row + 1];
    const bool sub_ok = sub >= 0 && sub < N;
    const bool obj_ok = obj >= 0 && obj < N;
    const float* a_sub = a + ((size_t)seg * N + (sub_ok ? sub : 0)) * 2 * R;
    const float* a_obj = a + ((size_t)seg * N + (obj_ok ? obj : 0)) * 2 * R + R;
    const float s_row = s[row];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + wcol + j * 8 + 2 * t + e;
        if (col >= R) continue;
        const float part = __fmul_rn(__int2float_rn(acc[j][h * 2 + e]), s_row);
        const float y = __fadd_rn(__fmul_rn(part, sw[col]), bias[col]);
        const float add = __fadd_rn(sub_ok ? a_sub[col] : 0.0f,
                                    obj_ok ? a_obj[col] : 0.0f);
        out[(size_t)row * R + col] = __fadd_rn(y, add);
      }
    }
  }
}

}  // namespace

// C entry for ctypes. Launches on `stream` and returns cudaGetLastError()
// (0 = launched). Preconditions, checked by the Python wrapper: all
// tensors contiguous and on one device, x and qw_t 16-byte aligned, D a
// multiple of 128, pairs int32, rows = B * P > 0.
extern "C" int tspn_q8f_fused_launch(const void* x, const void* s,
                                     const void* pairs, const void* qw_t,
                                     const void* sw, const void* bias,
                                     const void* a, void* out, int rows,
                                     int P, int N, int R, int D, void* stream) {
  const long long row_tiles = ((long long)rows + kTileRows - 1) / kTileRows;
  const int col_tiles = (R + kTileCols - 1) / kTileCols;
  if (rows <= 0 || P <= 0 || R <= 0 || D <= 0 || D % kChunk ||
      row_tiles > 0x7fffffffLL || col_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  // the ring is above the 48 KB a block gets without asking (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      q8f_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  q8f_fused_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const float*)s, (const int32_t*)pairs,
      (const int8_t*)qw_t, (const float*)sw, (const float*)bias,
      (const float*)a, (float*)out, rows, P, N, R, D);
  return (int)cudaGetLastError();
}
