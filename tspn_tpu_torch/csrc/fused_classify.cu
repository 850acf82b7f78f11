// Fused L1 normalization + predicate classifier (K3, f32) for sm_90a, on
// three-pass TF32 wgmma.
//
// Replaces tspn_tpu/ops/pairwise.py::normalize_classify_pallas (Pallas
// kernel _kernel) on f32 rows. For device-layout rows x (P, D) f32, weights
// W (D, R) f32 and bias b (R,) f32 it computes
//
//     out[p, r] = sum_{c < hp} x[p, c] W[c, r]
//               + sum_k sum_{c in seg_k} (x[p, c] * inv[p, k]) W[c, r] + b[r]
//
// with seg_k = [hp + k*blk, hp + (k+1)*blk), s = sum_{c in seg_k} |x[p, c]|
// in f32 and inv[p, k] = s > 0 ? 1/s : 1 (a zero block keeps scale 1). The
// plain version (ops/pairwise.py::normalize_classify_fused_plain) scales the
// rows first and runs an f32 GEMM; this kernel agrees with it within
// 1e-5 * (|N(x)| @ |W| + |b|) + 1e-6 per element, not bit for bit.
//
// What bounds it: at a training step (P 7936, D 11264, R 132) the call moves
// 357 MB (0.107 ms at 3.35 TB/s) and its product is 23.6 GFLOP. An
// f32-accurate product on the tensor cores takes three TF32 passes, 70.8
// GFLOP at 494.7 TFLOP/s: 0.143 ms, the bound. (On the CUDA cores the f32
// product alone takes 0.352 ms.)
//
// Design.
// - Three passes. a = a_hi + a_lo and w = w_hi + w_lo with a_hi = tf32(a),
//   a_lo = tf32(a - a_hi) (cvt.rna); a w is taken as a_lo w_hi + a_hi w_lo +
//   a_hi w_hi, which drops a_lo w_lo and the two residues: about 2^-21 of
//   |a w|, far inside the contract. W's halves are made for each call by a
//   small prep kernel (fused_classify_prep_kernel) as two K-major tensors Wt
//   (N_pad, D), N_pad the column tiles' 136 columns each: TF32 wgmma reads B
//   from shared memory only K-major.
// - A in registers. A tile is 128 rows x 136 output columns; warpgroups 0
//   and 1 consume 64 rows each, and thread 0 also fills a 3-stage ring by
//   TMA with the 128-byte swizzle (a producer warp of its own would make
//   ptxas budget registers for 384 threads, and the consumers spilled): a
//   stage is 32 floats of D of the rows (16 KB) and of Wt's two halves (17
//   KB each). The order of k within a 32-column chunk is free as long as A
//   and B agree, so the prep kernel permutes Wt's columns so that lane (g,
//   t) of a warp takes floats 8t .. 8t + 7 of its rows g and g + 8 for the
//   chunk's four k8 steps: two conflict-free 16-byte shared loads a row.
//   The lane sums their |x|, splits them into hi and lo and issues the
//   chunk's 12 wgmma.m64n136k8 (4 steps x 3 passes); a warpgroup waits for
//   its own products before it forms A again, and the other warpgroup's
//   products fill the wait.
// - Rounding. The tensor cores round each step's sum toward zero, about
//   2^-23 of the accumulator's size; over a 1024-column unit (384 steps)
//   that came to 2e-5 of a logit, enough to move a served top-k past a
//   1e-6 tie. So every chunk starts a fresh sum, its eight small products
//   (lo x hi, hi x lo) before its four hi x hi steps, and the chunks' sums
//   are added in f32 (round to nearest): only about 4 truncations of a
//   32-column sum stay in each chunk.
// - The L1 scale, folded per unit. D is cut into units: the BoW blocks, and
//   the head in shares of at most 1024 columns (scale 1). At a unit's end
//   each lane's |x| sums are reduced over the 4 lanes of its rows, and the
//   unit's sums are multiplied by the rows' inv and added in unit order into
//   the f32 folds, which live in shared memory (68 KB: in registers beside
//   the chunk and unit sums they would not fit). So x is read once.
// - The split. At the training geometry 128-row tiles make 62 tiles on 132
//   SMs. A launch then cuts the units into pieces (ops/pairwise.py::
//   fused_plan picks the cut with a cost model): a block takes one (tile,
//   piece) and stores its piece's f32 folds into its own slab of a
//   workspace; a second kernel (fused_classify_fold_kernel) adds the slabs
//   in piece order and the bias, so runs repeat bit for bit.
// - No wgmma sits on a branch (ptxas would serialize every wgmma of the
//   kernel): every chunk is 32 whole columns (hp and blk are multiples of
//   32), and rows past P come in as TMA's zeros.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kRows = 128;                     // rows of a tile
constexpr int kN = 136;                        // output columns of a tile (wgmma N)
constexpr int kK = 32;                         // floats of D a stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kABytes = kRows * kK * 4;        // the rows' box, 16 KB
constexpr int kBBytes = kN * kK * 4;           // one half of Wt's box, 17 KB
constexpr int kStageBytes = kABytes + 2 * kBBytes;
constexpr int kThreads = 256;                  // 2 consumer warpgroups
constexpr int kAcc = kN / 2;                   // accumulators a consumer thread
constexpr int kFoldBytes = kAcc * kThreads * 4;  // the f32 folds, a column a thread
constexpr int kSmem = kStages * kStageBytes + kFoldBytes + 2 * kStages * 8 + 1024;
constexpr int kMaxUnits = 32;

// The launch's work: unit u is chunks [lo[u], hi[u]) (32 floats of D each),
// scaled by the rows' 1/L1 when scaled[u]; piece i runs units [first[i],
// first[i + 1]), units and pieces in fold order.
struct Plan {
  int units, pieces;
  uint16_t lo[kMaxUnits], hi[kMaxUnits];
  uint8_t scaled[kMaxUnits];
  uint8_t first[kMaxUnits + 1];
};

struct Args {
  const float* bias;
  float* out;  // (P, R)
  float* ws;   // split: one (P, R) slab a piece
  int P, R, col_blocks;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void lds128(uint32_t addr, float* v) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(addr));
}

#define ACC8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC68                                                                                 \
  ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), "+f"(d[64]), \
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
#define D68                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
  "%66, %67"

// d (64 x 136, f32) (+)= A (64 x 8 tf32, registers) . B (8 x 136 tf32,
// shared memory, K-major); d is overwritten when acc is 0
__device__ __forceinline__ void mma_tf32(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t desc,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k8.f32.tf32.tf32 {" D68
      "}, {%68, %69, %70, %71}, %72, p, 1, 1;\n}\n"
      : ACC68
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// after wgmma_wait(): reads of the accumulators stay below it
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the TMA loads of a piece's chunk i (32 floats of D) into its stage
__device__ __forceinline__ void load_chunk(uint8_t* ring, uint64_t* full, const CUtensorMap* xmap,
                                           const CUtensorMap* wmap, int i, int c, int p0, int n0,
                                           int lo_row) {
  const int stage = i % kStages;
  uint8_t* st = ring + stage * kStageBytes;
  mbar_expect_tx(&full[stage], kStageBytes);
  tma_load(st, xmap, &full[stage], c * kK, p0);
  tma_load(st + kABytes, wmap, &full[stage], c * kK, n0);                    // hi
  tma_load(st + kABytes + kBBytes, wmap, &full[stage], c * kK, lo_row + n0);  // lo
}

// One block a (piece, tile), pieces outermost; warpgroups 0 and 1 consume.
// Thread 0 also fills the ring: before it consumes chunk i it refills the
// stage of chunk i - 1 with chunk i - 1 + kStages once both warpgroups have
// released it, so the other warpgroup may run up to a chunk behind.
__global__ void __launch_bounds__(kThreads, 1)
fused_classify_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, const __grid_constant__ Plan plan,
                      const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  float* fold_s = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes + kFoldBytes);
  uint64_t* empty = full + kStages;
  const int tiles = gridDim.x / plan.pieces;
  const int piece = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  const int p0 = tile / a.col_blocks * kRows, n0 = tile % a.col_blocks * kN;
  const int u_begin = plan.first[piece], u_end = plan.first[piece + 1];
  // the piece's units are consecutive chunks of D
  const int c_begin = plan.lo[u_begin], chunks = plan.hi[u_end - 1] - c_begin;
  const int lo_row = a.col_blocks * kN;  // Wt's lo half
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages && i < chunks; ++i)
      load_chunk(ring, full, &xmap, &wmap, i, c_begin + i, p0, n0, lo_row);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 64 * wg + 16 * warp + g;  // the lane's tile rows r0 and r0 + 8
  // floats 8t .. 8t + 7 of row r0 are 16-byte chunks 2t and 2t + 1 of its
  // 128 bytes, swizzled; row r0 + 8 is 1024 bytes further on
  const uint32_t off0 = r0 * 128 + (((2 * t) ^ (r0 & 7)) << 4);
  const uint32_t off1 = r0 * 128 + (((2 * t + 1) ^ (r0 & 7)) << 4);
  const uint32_t ring_addr = smem_addr(ring);
  // acc: the tensor cores' sums of one chunk; usum: the unit's chunk sums,
  // added in f32; fold[256 i]: the thread's fold i, in shared memory
  float acc[kAcc], usum[kAcc];
  float* fold = fold_s + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = usum[i] = 0.f;

  int k = 0;  // the piece's chunk
  for (int u = u_begin; u < u_end; ++u) {
    float s0 = 0.f, s1 = 0.f;  // |x| of the lane's columns of rows r0, r0 + 8
    for (int c = plan.lo[u]; c < plan.hi[u]; ++c, ++k) {
      if (threadIdx.x == 0 && k > 0 && k - 1 + kStages < chunks) {
        mbar_wait(&empty[(k - 1) % kStages], (uint32_t)((k - 1) / kStages) & 1);
        load_chunk(ring, full, &xmap, &wmap, k - 1 + kStages, c - 1 + kStages, p0, n0, lo_row);
      }
      __syncwarp();
      const int stage = k % kStages;
      const uint32_t st = ring_addr + stage * kStageBytes;
      mbar_wait(&full[stage], (uint32_t)(k / kStages) & 1);
      float x0[8], x1[8];
      lds128(st + off0, x0);
      lds128(st + off1, x0 + 4);
      lds128(st + 1024 + off0, x1);
      lds128(st + 1024 + off1, x1 + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s0 += fabsf(x0[i]);
        s1 += fabsf(x1[i]);
      }
      // step s: A columns t and t + 4 are floats 8t + 2s and 8t + 2s + 1;
      // registers (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float v[4] = {x0[2 * s], x1[2 * s], x0[2 * s + 1], x1[2 * s + 1]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          hi[s][q] = tf32_rna(v[q]);
          lo[s][q] = tf32_rna(v[q] - __uint_as_float(hi[s][q]));
        }
      }
      const uint64_t b_hi = kmajor_desc(st + kABytes), b_lo = kmajor_desc(st + kABytes + kBBytes);
      // a fresh sum each chunk, the small terms first: the tensor cores
      // round their sums toward zero, relative to the sum's size, so the
      // eight small products lose nearly nothing and only the four hi x hi
      // steps lose bits of the chunk's sum
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) mma_tf32(acc, lo[s], b_hi + (uint64_t)(2 * s), s);
#pragma unroll
      for (int s = 0; s < 4; ++s) mma_tf32(acc, hi[s], b_lo + (uint64_t)(2 * s), 1);
#pragma unroll
      for (int s = 0; s < 4; ++s) mma_tf32(acc, hi[s], b_hi + (uint64_t)(2 * s), 1);
      wgmma_commit();
      wgmma_wait();  // A is rewritten next
      if (lane == 0) mbar_arrive(&empty[stage]);
      fence_acc(acc);
      const bool first = c == plan.lo[u];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) usum[i] = first ? acc[i] : __fadd_rn(usum[i], acc[i]);
    }
    // the unit's end: fold = (fold +) usum * inv, rows r0 and r0 + 8
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    }
    const bool scaled = plan.scaled[u];
    const float inv0 = scaled && s0 > 0.f ? __frcp_rn(s0) : 1.f;
    const float inv1 = scaled && s1 > 0.f ? __frcp_rn(s1) : 1.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const float part = __fmul_rn(usum[i], (i >> 1) & 1 ? inv1 : inv0);
      fold[256 * i] = u == u_begin ? part : __fadd_rn(fold[256 * i], part);
    }
  }

  // fold i = 4j + 2h + e (as the accumulators) is row r0 + 8h, column
  // 8j + 2t + e of the tile
  const bool split = plan.pieces > 1;
  float* base = split ? a.ws + (size_t)piece * a.P * a.R : a.out;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + r0 + 8 * h, n = n0 + 8 * j + 2 * t;
      if (p >= a.P || n >= a.R) continue;
      float v0 = fold[256 * (4 * j + 2 * h)], v1 = fold[256 * (4 * j + 2 * h + 1)];
      float* dst = base + (size_t)p * a.R + n;
      if (!split) v0 = __fadd_rn(v0, a.bias[n]);
      if (n + 1 >= a.R) {
        dst[0] = v0;
        continue;
      }
      if (!split) v1 = __fadd_rn(v1, a.bias[n + 1]);
      if (a.R % 2) {
        dst[0] = v0;
        dst[1] = v1;
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      }
    }
}

// The split's second kernel: out = the pieces' slabs added in piece order,
// plus the bias; one thread an output element.
__global__ void __launch_bounds__(256)
fused_classify_fold_kernel(const __grid_constant__ Plan plan, const __grid_constant__ Args a) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x, elems = (size_t)a.P * a.R;
  if (e >= elems) return;
  float v = __ldcg(a.ws + e);
  for (int pc = 1; pc < plan.pieces; ++pc) v = __fadd_rn(v, __ldcg(a.ws + pc * elems + e));
  a.out[e] = __fadd_rn(v, a.bias[e % a.R]);
}

// W (D, R) row-major -> Wt (2 n_pad, D): rows [0, n_pad) tf32(W)^T, rows
// [n_pad, 2 n_pad) tf32(W - tf32(W))^T, columns of each 32-chunk permuted
// as the consumers read A (position 8s + c holds column 8c + 2s for c < 4,
// 8 (c - 4) + 2s + 1 for c >= 4), rows past R zero. A block transposes a
// 32 x 32 tile through shared memory.
__global__ void __launch_bounds__(256)
fused_classify_prep_kernel(const float* __restrict__ w, float* __restrict__ wt, int D, int R,
                           int n_pad) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + tx;
    tile[i][tx] = n < R ? w[(size_t)(k0 + i) * R + n] : 0.f;
  }
  __syncthreads();
  const int s = tx / 8, c = tx % 8;
  const int src = c < 4 ? 8 * c + 2 * s : 8 * (c - 4) + 2 * s + 1;
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= n_pad) break;
    const float v = tile[src][i];
    const uint32_t hi = tf32_rna(v);
    wt[(size_t)n * D + k0 + tx] = __uint_as_float(hi);
    wt[(size_t)(n_pad + n) * D + k0 + tx] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
  }
}

// a 2-D f32 map (inner, outer), rows `inner` floats apart, boxes of
// box_inner x box_outer with the 128-byte swizzle (zeros past the edges)
bool encode_f32(EncodeTiled encode, CUtensorMap* map, const void* base, int inner, int outer,
                int box_inner, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// C entries for ctypes: each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
//
// prep: w (D, R) f32 -> wt (2 n_pad, D) f32 with n_pad = 136 * ceil(R / 136),
// D a multiple of 32.
extern "C" int tspn_fused_classify_prep_launch(const void* w, void* wt, int D, int R,
                                               void* stream) {
  if (D <= 0 || D % kK || R <= 0) return (int)cudaErrorInvalidValue;
  const int n_pad = (R + kN - 1) / kN * kN;
  const dim3 grid((unsigned)(D / 32), (unsigned)((n_pad + 31) / 32));
  fused_classify_prep_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (const float*)w, (float*)wt, D, R, n_pad);
  return (int)cudaGetLastError();
}

// the product: x (P, D) f32 (16-byte aligned), wt from the prep, bias (R,),
// out (P, R); units: n_units int quads (first chunk, end chunk, scaled,
// piece) in fold order, covering D's chunks once in order, pieces numbered
// from 0 in order (host memory, read before the launch). With more than one
// piece, ws holds one (P, R) f32 slab a piece and the fold kernel runs.
extern "C" int tspn_fused_classify_launch(const void* x, const void* wt, const void* bias,
                                          void* out, void* ws, const void* units, int P, int R,
                                          int D, int n_units, void* stream) {
  if (P <= 0 || R <= 0 || D <= 0 || D % kK || n_units < 1 || n_units > kMaxUnits)
    return (int)cudaErrorInvalidValue;
  Plan plan{};
  plan.units = n_units;
  const int* tbl = static_cast<const int*>(units);
  int next = 0, pieces = 0;
  for (int u = 0; u < n_units; ++u) {
    const int lo = tbl[4 * u], hi = tbl[4 * u + 1], scaled = tbl[4 * u + 2], pc = tbl[4 * u + 3];
    const int prev = u ? tbl[4 * u - 1] : -1;  // a unit goes on its piece or starts the next
    if (lo != next || hi <= lo || hi > 0xFFFF || (scaled != 0 && scaled != 1) || pc < 0 ||
        (pc != prev && pc != prev + 1))
      return (int)cudaErrorInvalidValue;
    if (pc != prev) plan.first[pieces++] = (uint8_t)u;
    plan.lo[u] = (uint16_t)lo;
    plan.hi[u] = (uint16_t)hi;
    plan.scaled[u] = (uint8_t)scaled;
    next = hi;
  }
  if (next * kK != D || (pieces > 1 && !ws)) return (int)cudaErrorInvalidValue;
  plan.pieces = pieces;
  plan.first[pieces] = (uint8_t)n_units;
  const int col_blocks = (R + kN - 1) / kN;
  const long long tiles = ((long long)P + kRows - 1) / kRows * col_blocks;
  if (tiles * pieces > 0x7FFFFFFF || (long long)P * R > 0x7FFFFFFFLL * 256)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap xmap{}, wmap{};
  if (!encode_f32(encode, &xmap, x, D, P, kK, kRows) ||
      !encode_f32(encode, &wmap, wt, D, 2 * col_blocks * kN, kK, kN))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fused_classify_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const Args args{(const float*)bias, (float*)out, (float*)ws, P, R, col_blocks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_classify_kernel<<<(unsigned)(tiles * pieces), kThreads, kSmem, st>>>(xmap, wmap, plan,
                                                                             args);
  e = cudaGetLastError();
  if (e != cudaSuccess || pieces == 1) return (int)e;
  const long long elems = (long long)P * R;
  fused_classify_fold_kernel<<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(plan, args);
  return (int)cudaGetLastError();
}
