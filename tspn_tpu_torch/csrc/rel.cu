// The rel-pass probe kernels, for Hopper (sm_90a): one template over the
// operand format, the epilogue and the depth of the copy ring.
//
// Replaces the 13 pallas_calls of the JAX package's rel-pass probe tools,
// each of which computes (P, D) features x (D, R) weights on the int8 path
// (D = 3072, the factored per-pair rows of VidVRD):
//   Kr  (mode kS8)   int8 x int8:
//       tools/bench_rel_steps.py::make_call (:91 raw, :102 f32, :113 side),
//       tools/bench_rel_pipeline.py (make_grid_call :91, make_emit_call
//       :155, make_ksplit_call :207), tools/bench_rel_probe.py (raw_call
//       :69, mdma_call :130, mdma_full_call :243) and the i8xi8 leg of
//       tools/bench_rel_int4.py (:63, :76);
//   Kn  (mode kS4x8) int4 features packed two to a byte x int8 weights:
//       bench_rel_probe.py nib_call :166 and i4_call :276, and the i4xi8
//       leg of bench_rel_int4.py;
//   Ks4 (mode kS4x4) int4 x int4, both packed: the i4xi4 leg of
//       bench_rel_int4.py.
// For rows p < rows and columns r < R, with acc the exact int32 sum:
//   kInt32  out[p, r] = acc
//   kF32    out[p, r] = f32(acc) * sw[r] + b[r]
//   kSide   out[p, r] = (f32(acc) * s[p * s_stride]) * sw[r] + b[r]
// folded with __int2float_rn, __fmul_rn and __fadd_rn in that order (the
// order of ops/pairwise.py::normalize_classify_q8s_plain at rel_geom), so
// nvcc cannot contract them into FMAs and every epilogue equals its plain
// version (ops/rel.py) bit for bit.
//
// Operands. x is (rows, kb) bytes row-major: int8 columns (kb = D), or int4
// packed two to a byte, column 2j in the low nibble and 2j+1 in the high
// (kb = D / 2). Weights are K-major, transposed once at weight prep: Kr
// takes (R, D) int8; Kn takes W_even and W_odd, each (R, D / 2) int8, the
// even and the odd columns of W; Ks4 takes (R, D / 2) packed int4.
//   Kn: the low nibbles of 4 consecutive packed bytes are 4 consecutive
//   k of an s8 fragment against W_even, the high nibbles against W_odd;
//   four nibbles are sign-extended at once, per byte, with
//   __vsub4((w & 0x0F0F0F0F) ^ 0x08080808, 0x08080808), so the product is
//   lo @ W_even + hi @ W_odd with no interleaving.
//   Ks4 unpacks the weights' packed bytes the same way and runs Kn's two
//   s8 products, lo(x) @ lo(W) + hi(x) @ hi(W). PTX's int4 product,
//   mma.sync.m16n8k64.s4, was tried first: ptxas takes it for sm_90a, but
//   the H100 publishes no int4 tensor-core rate and on the card it ran
//   several times slower than the unpacking form.
//
// What bounds it on the card: each row streams its kb bytes from HBM once
// and writes R outputs; 2 * D * R integer operations a row put the call
// below the int8 tensor-core ridge at R = 132, so the least time is HBM
// bytes (about 349 MB, 0.104 ms, for Kr side at 95,232 x 3072 -> 132;
// about half the feature bytes for the int4 formats). The design's
// answer: every row is read once (one column tile holds all 132
// predicates), copies run ahead of the tensor cores through a ring in
// shared memory, and the persistent schedule keeps the ring running
// across row tiles so that the next tile's loads overlap this tile's
// epilogue. Measured, HBM is not what holds it back: Kn, with half the
// bytes, takes Kr's time, and with one 8-warp block per SM (about 180
// registers) the warps wait on latency. The 2-stage instantiations
// therefore run two blocks per SM at 128 registers (min_blocks), spills
// and all, which on the card ran faster than one block at any ring depth
// and than 16 smaller warps per block. Fewer live registers or wgmma is
// later work.
//
// Design. One block of 8 warps computes a 128-row x 144-column output
// tile; warp w owns 32 rows (w % 4) x 72 columns (w / 4): per 32-byte K
// step two A fragments and nine B fragments, read from shared rows of
// 144 bytes (a stride at which the fragment reads do not conflict), and
// 18 mma.sync.m16n8k32.s8 (exact int32 sums; Kn and Ks4 run 36 over
// unpacked nibbles, per 64 columns). The K walk moves 128-byte chunks of
// the row tile and of the weights with cp.async (16 bytes a copy,
// zero-filled past the ragged row and column edges) through a ring of S
// stages: 2, 3 or 4 for Kr, 2 for Kn (which stages both weight halves)
// and Ks4.
// The work items (row tile, column tile) are walked by blockIdx.x with
// stride gridDim.x: the row-grid schedule launches one block per item,
// the persistent one as many blocks as fit on the card at once, and the
// flattened (item, chunk) sequence keeps one ring running over all of a
// block's items. Split-K by ks (grid.y) gives each K slice its own block:
// each writes its int32 partial to a (ks, rows, R) workspace, and the last
// block of the item to arrive (an atomic counter in a zeroed array) adds
// the others' partials to its own in int32 (exact, so bit-equal to ks = 1)
// and runs the epilogue. The TPU tools' 132 -> 256 lane padding, Mosaic
// block shapes, VMEM limits and "parallel" hints have no counterpart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kS8 = 0, kS4x8 = 1, kS4x4 = 2 };
enum Epi { kInt32 = 0, kF32 = 1, kSide = 2 };

constexpr int kTileRows = 128;
constexpr int kTileCols = 144;
constexpr int kMTiles = 2;                   // m16 tiles per warp: 32 rows
constexpr int kNTiles = kTileCols / 2 / 8;   // n8 tiles per warp: 9
constexpr int kChunk = 128;                  // bytes of K per stage
constexpr int kCopies = kChunk / 16;         // 16-byte copies per row
constexpr int kStrideWords = kChunk / 4 + 4; // smem row: 128 bytes + 16 pad
constexpr int kThreads = 256;

template <int M>
__host__ __device__ constexpr int w_rows() { return M == kS4x8 ? 2 * kTileCols : kTileCols; }
template <int M>
__host__ __device__ constexpr int stage_words() {
  return (kTileRows + w_rows<M>()) * kStrideWords;
}

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

// four packed low (high) nibbles -> four sign-extended int8 bytes
__device__ __forceinline__ uint32_t nib_lo(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t nib_hi(uint32_t w) { return nib_lo(w >> 4); }

// two blocks per SM where two rings fit in shared memory (S = 2, but not
// Kn's double weight tile): at most 128 registers, with some spilled
template <int M, int S>
__host__ __device__ constexpr int min_blocks() { return S == 2 && M != kS4x8 ? 2 : 1; }

template <int M, int E, int S>
__global__ void __launch_bounds__(kThreads, min_blocks<M, S>())
rel_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w0,
           const int8_t* __restrict__ w1, const float* __restrict__ s,
           const float* __restrict__ sw, const float* __restrict__ bias,
           void* __restrict__ out, int32_t* __restrict__ ws,
           int* __restrict__ counters, int rows, int R, int kb, int s_stride,
           int ks) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int last_block;
  constexpr int kStageWords = stage_words<M>();

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row (A, C) or column (B) in its tile
  const int t = lane % 4;  // fragment word along K
  const int wrow = (warp % 4) * (16 * kMTiles);
  const int wcol = (warp / 4) * (kTileCols / 2);

  const int col_tiles = (R + kTileCols - 1) / kTileCols;
  const int items = (rows + kTileRows - 1) / kTileRows * col_tiles;
  const int slice = blockIdx.y;
  const int cpt = kb / kChunk / ks;  // chunks of one item in this K slice
  const int k_base = slice * cpt * kChunk;
  const int my_items =
      (int)blockIdx.x < items ? (items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = my_items * cpt;

  // chunk c of this block: item blockIdx.x + (c / cpt) * gridDim.x
  auto load_stage = [&](int stage, int c) {
    const int item = blockIdx.x + (c / cpt) * gridDim.x;
    const int row0 = item / col_tiles * kTileRows;
    const int col0 = item % col_tiles * kTileCols;
    const int k0 = k_base + c % cpt * kChunk;
    uint32_t* xs = smem + stage * kStageWords;
    uint32_t* wsm = xs + kTileRows * kStrideWords;
    for (int e = tid; e < kTileRows * kCopies; e += kThreads) {
      const int r = e / kCopies, q = e % kCopies;
      const bool ok = row0 + r < rows;
      const int8_t* src = ok ? x + (size_t)(row0 + r) * kb + k0 + q * 16 : x;
      cp_async16(xs + r * kStrideWords + q * 4, src, ok);
    }
    for (int e = tid; e < w_rows<M>() * kCopies; e += kThreads) {
      const int r = e / kCopies, q = e % kCopies;
      const int wr = r % kTileCols;  // kS4x8: rows >= 144 stage W_odd
      const int8_t* base = (M == kS4x8 && r >= kTileCols) ? w1 : w0;
      const bool ok = col0 + wr < R;
      const int8_t* src = ok ? base + (size_t)(col0 + wr) * kb + k0 + q * 16 : w0;
      cp_async16(wsm + r * kStrideWords + q * 4, src, ok);
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::); };

  int32_t acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int m = 0; m < kMTiles; ++m)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0;

  // one commit group per chunk (empty past the end), so that "all but the
  // newest S - 2 groups complete" means "chunk c has landed"
  for (int c = 0; c < S - 1; ++c) {
    if (c < total) load_stage(c, c);
    commit();
  }
  for (int c = 0; c < total; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2));
    __syncthreads();  // chunk c visible to all; stage (c - 1) % S free
    const int next = c + S - 1;
    if (next < total) load_stage(next % S, next);
    commit();
    const uint32_t* xs = smem + (c % S) * kStageWords;
    const uint32_t* wsm = xs + kTileRows * kStrideWords;
#pragma unroll
    for (int kk = 0; kk < kChunk / 32; ++kk) {
      const int kw = kk * 8 + t;
      uint32_t af[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        const uint32_t* r0 = xs + (wrow + 16 * m + g) * kStrideWords;
        const uint32_t* r8 = r0 + 8 * kStrideWords;
        af[m][0] = r0[kw];
        af[m][1] = r8[kw];
        af[m][2] = r0[kw + 4];
        af[m][3] = r8[kw + 4];
      }
      if constexpr (M != kS8) {
        uint32_t lo[kMTiles][4], hi[kMTiles][4];
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo[m][i] = nib_lo(af[m][i]);
            hi[m][i] = nib_hi(af[m][i]);
          }
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const uint32_t* we = wsm + (wcol + j * 8 + g) * kStrideWords;
          uint32_t be0, be1, bo0, bo1;
          if constexpr (M == kS4x8) {
            const uint32_t* wo = we + kTileCols * kStrideWords;
            be0 = we[kw], be1 = we[kw + 4], bo0 = wo[kw], bo1 = wo[kw + 4];
          } else {
            be0 = nib_lo(we[kw]), be1 = nib_lo(we[kw + 4]);
            bo0 = nib_hi(we[kw]), bo1 = nib_hi(we[kw + 4]);
          }
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) {
            mma_s8(acc[m][j], lo[m], be0, be1);
            mma_s8(acc[m][j], hi[m], bo0, bo1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
          const uint32_t* wr = wsm + (wcol + j * 8 + g) * kStrideWords;
          const uint32_t b0 = wr[kw], b1 = wr[kw + 4];
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) mma_s8(acc[m][j], af[m], b0, b1);
        }
      }
    }
    if ((c + 1) % cpt) continue;

    // the last chunk of an item: its epilogue, while the ring loads ahead
    const int item = blockIdx.x + (c / cpt) * gridDim.x;
    const int row0 = item / col_tiles * kTileRows;
    const int col0 = item % col_tiles * kTileCols;
    // C fragment: acc[m][j][h*2 + e] is row wrow + 16m + g + 8h, column
    // wcol + 8j + 2t + e
    if (ks > 1) {
      int32_t* part = ws + (size_t)slice * rows * R;
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + wrow + 16 * m + g + 8 * h;
          if (row >= rows) continue;
#pragma unroll
          for (int j = 0; j < kNTiles; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = col0 + wcol + j * 8 + 2 * t + e;
              if (col < R) part[(size_t)row * R + col] = acc[m][j][h * 2 + e];
            }
        }
      __threadfence();
      __syncthreads();
      if (tid == 0) last_block = atomicAdd(&counters[item], 1) == ks - 1;
      __syncthreads();
      if (last_block) {
        __threadfence();
        for (int o = 0; o < ks; ++o) {
          if (o == slice) continue;
          const int32_t* other = ws + (size_t)o * rows * R;
#pragma unroll
          for (int m = 0; m < kMTiles; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + wrow + 16 * m + g + 8 * h;
              if (row >= rows) continue;
#pragma unroll
              for (int j = 0; j < kNTiles; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int col = col0 + wcol + j * 8 + 2 * t + e;
                  if (col < R) acc[m][j][h * 2 + e] += __ldcg(other + (size_t)row * R + col);
                }
            }
        }
      }
    }
    if (ks == 1 || last_block) {
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + wrow + 16 * m + g + 8 * h;
          if (row >= rows) continue;
          const float s_row = E == kSide ? s[(size_t)row * s_stride] : 0.0f;
#pragma unroll
          for (int j = 0; j < kNTiles; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = col0 + wcol + j * 8 + 2 * t + e;
              if (col >= R) continue;
              const int32_t v = acc[m][j][h * 2 + e];
              const size_t at = (size_t)row * R + col;
              if constexpr (E == kInt32) {
                static_cast<int32_t*>(out)[at] = v;
              } else {
                float y = __int2float_rn(v);
                if constexpr (E == kSide) y = __fmul_rn(y, s_row);
                static_cast<float*>(out)[at] = __fadd_rn(__fmul_rn(y, sw[col]), bias[col]);
              }
            }
        }
    }
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int j = 0; j < kNTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] = 0;
  }
}

template <int M, int E, int S>
int launch(const void* x, const void* w0, const void* w1, const void* s,
           const void* sw, const void* bias, void* out, void* ws, void* counters,
           int persistent, int ks, int rows, int R, int kb, int s_stride,
           cudaStream_t stream) {
  auto kernel = rel_kernel<M, E, S>;
  constexpr int smem_bytes = S * stage_words<M>() * 4;
  // the ring is above the 48 KB a block gets without asking (per device)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long items = ((long long)rows + kTileRows - 1) / kTileRows *
                          ((R + kTileCols - 1) / kTileCols);
  long long blocks = items;
  if (persistent) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                             smem_bytes)) != cudaSuccess)
      return (int)err;
    blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (blocks > items) blocks = items;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)ks);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      (const int8_t*)x, (const int8_t*)w0, (const int8_t*)w1, (const float*)s,
      (const float*)sw, (const float*)bias, out, (int32_t*)ws, (int*)counters,
      rows, R, kb, s_stride, ks);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes. Launches on `stream` and returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for a combination that has no
// instantiation. mode: 0 Kr (int8), 1 Kn (packed int4 x W_even, W_odd), 2
// Ks4 (packed int4 x packed int4); epi: 0 int32, 1 f32, 2 side (Kr only);
// stages 2-4 (Kn and Ks4: 2); persistent 0 = one block per row tile, 1 = about
// one block per SM slot; ks splits K across blocks (ws: (ks, rows, R)
// int32, counters: one zeroed int per row tile; unused when ks == 1); kb
// is the row length in bytes. Preconditions, checked by the Python
// wrapper: operands contiguous on one device, x and the weights 16-byte
// aligned, kb a multiple of 128 * ks, rows and R > 0.
extern "C" int tspn_rel_launch(const void* x, const void* w0, const void* w1,
                               const void* s, const void* sw, const void* bias,
                               void* out, void* ws, void* counters, int mode,
                               int epi, int stages, int persistent, int ks,
                               int rows, int R, int kb, int s_stride, void* stream) {
  if (rows <= 0 || R <= 0 || ks < 1 || kb <= 0 || kb % (kChunk * ks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define REL_ARGS x, w0, w1, s, sw, bias, out, ws, counters, persistent, ks, rows, R, kb, s_stride, st
  const int key = mode * 100 + epi * 10 + stages;
  switch (key) {
    case 2: return launch<kS8, kInt32, 2>(REL_ARGS);
    case 3: return launch<kS8, kInt32, 3>(REL_ARGS);
    case 4: return launch<kS8, kInt32, 4>(REL_ARGS);
    case 12: return launch<kS8, kF32, 2>(REL_ARGS);
    case 13: return launch<kS8, kF32, 3>(REL_ARGS);
    case 14: return launch<kS8, kF32, 4>(REL_ARGS);
    case 22: return launch<kS8, kSide, 2>(REL_ARGS);
    case 23: return launch<kS8, kSide, 3>(REL_ARGS);
    case 24: return launch<kS8, kSide, 4>(REL_ARGS);
    case 102: return launch<kS4x8, kInt32, 2>(REL_ARGS);
    case 202: return launch<kS4x4, kInt32, 2>(REL_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REL_ARGS
}
