// The int8 x int8 segmented pair scorers K1 and K6 for sm_90a, on wgmma.
//
// K1 replaces tspn_tpu/ops/pairwise.py::normalize_classify_q8s_pallas
// (Pallas kernel _kernel_q8s), K6 normalize_classify_q8t_pallas
// (_kernel_q8t). K1 computes, for rows p < P and output columns r < R,
//
//     acc  = f32(int32(q[p, 0:hp] . qw_t[r, 0:hp])) * s[p, 0]
//     acc += f32(int32(q[p, seg_k] . qw_t[r, seg_k])) * s[p, k + 1]   k = 0..nb-1
//     out[p, r] = acc * sw[r] + b[r]
//
// with seg_k = [hp + k blk, hp + (k + 1) blk), q (P, D) int8 row-major, qw_t
// (R, D) int8 K-major (the classifier's int8 weights transposed once at
// weight prep), s (P, 16) f32 (head scale, then 1/L1 of each block), sw and
// b (R,) f32. K6 is K1 on xt (D, P) and s_t (16, P), giving (R, P). The f32
// steps are __fmul_rn / __fadd_rn in that order, so both kernels are
// bit-equal to their plain versions in ops/pairwise.py, and K6 to K1
// transposed. The serve path runs K1 at three geometries: the expanded q8
// rows (hp 3072, 8 x 1024), the factored tracklet rows (hp 128, 4 x 1024,
// R 264) and the factored relative rows (hp 3072, no blocks).
//
// What bounds it: at R = 132 a byte of q feeds 264 integer operations, far
// under the int8 tensor cores' ridge (about 590 a byte), so reading q once
// bounds it: 0.3375 ms for the 95,232 x 11,264 rows of the pair-kernel
// bench, 0.1025 ms for the rel pass's 95,203 x 3,072. The tensor cores must
// run at about half their rate to keep up with that, so: wgmma, fed by TMA.
//
// Design.
// - A tile is 128 rows (pairs) x 144 output columns (wgmma N: R = 132 is
//   one column block, the tracklet pass's R = 264 two, columns fastest so
//   both read the same rows from L2). Warpgroups 0 and 1 consume 64 rows
//   each; thread 256 fills a 4-stage ring, a stage 128 bytes of D: the
//   rows' box (128 x 128 bytes) and the weights' (144 x 128 bytes; rows
//   past R read as zeros), both by TMA with the 128-byte swizzle. Padding
//   lives in the box, never in a copy of the weights.
// - K1's q is row-major: its box is K-major, and wgmma reads A from shared
//   memory by descriptor; a warpgroup keeps one chunk's products in flight
//   while it issues the next (6-9% at the serve geometries in a design
//   probe). K6's xt is pair-major, and 8-bit wgmma reads only K-major
//   operands from shared memory, so A is formed in registers as the probe's
//   (csrc/pair_probe.cu; sm90.cuh::pair_major_a), and a warpgroup waits for
//   its own products before it forms A again. Where P % 16 != 0 TMA cannot
//   describe xt (its row stride must be a multiple of 16 bytes), and the
//   producer warpgroup stages it with aligned word loads
//   (sm90.cuh::stage_pair_rows), about six times as slow a chunk.
// - The fold. Every segment end is a multiple of 64 (the wrapper checks),
//   so a segment closes after a whole k32 step: a segment's chunks start at
//   its first byte, and the last one runs 2 or 4 k32 steps. The first
//   product of a segment has wgmma's scale-d 0, so the int32 accumulators
//   start afresh; when the segment's last products complete, each thread
//   converts its 72 int32 sums to f32, multiplies them by its row's
//   s[p, seg] and adds them into its 72 f32 accumulators in the fixed order.
//   Those live in shared memory (72 KB): in registers beside the int32 sums
//   (and K6's A) they spilled under any setmaxnreg split that leaves K6's
//   producers the registers of their staging loads. A k32 step past a
//   segment's end multiplies a zero A (K1: a zeroed 64-row tile; K6: zeroed
//   registers): ptxas serializes every wgmma of a kernel that issues one
//   on a branch.
// - The split. With fewer tiles than SMs (VidOR: 3 tiles), a tile's work
//   may be cut into pieces of about equal length: whole segments, or
//   segments cut into shares of whole chunks. A work item is then one
//   (tile, piece), which stores its int32 sums into its own slab of an
//   L2-resident workspace laid out as the output, and a second kernel
//   (q8s_fold_kernel), one thread an output, adds each segment's slabs
//   (integer sums: exact in any order) and folds the segments in the fixed
//   order. The slabs cross L2 twice, so ops/pairwise.py::q8s_plan splits
//   only where its cost model says that pays, and picks the cut. (A
//   last-item-folds-the-tile scheme left one SM reading a tile's slabs, its
//   loads serialized behind the fold's stores: slower than no split.)
// - Persistent blocks walk the work items [i W / grid, (i + 1) W / grid),
//   so one tile's epilogue overlaps the next tile's loads.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kRows = 128;                      // rows (pairs) of a tile
constexpr int kN = 144;                         // output columns of a tile
constexpr int kK = 128;                         // bytes of D a stage
constexpr int kStages = 4;
constexpr int kABytes = kRows * kK;             // the rows' box
constexpr int kStageBytes = kABytes + kN * kK;  // 34 x 1024
constexpr int kThreads = 384;                   // 2 consumer warpgroups + 1 producer
constexpr int kAcc = kN / 2;                    // accumulators a thread
// the ring, K1's zero A (64 rows), the f32 accumulators (kAcc a consumer
// thread), the barriers, and room to align the ring on 1024 bytes
constexpr int kZeroBytes = 64 * kK;
constexpr int kFaccBytes = kAcc * 256 * 4;
constexpr int kSmem = kStages * kStageBytes + kZeroBytes + kFaccBytes + 2 * kStages * 8 + 1024;
constexpr int kMaxPieces = 64;
constexpr int kMaxSegs = 16;
enum Staging { kTma = 0, kLoads = 1 };

// A tile's work: piece i is chunks [lo[i], hi[i]) (128 bytes of D each,
// from the segment's first byte) of segment seg[i], pieces in fold order.
// Without a split the pieces are the whole segments and a work item is a
// tile, which runs them all; with one, a work item is one (tile, piece).
struct Plan {
  int count, split;
  uint8_t seg[kMaxPieces];
  uint16_t lo[kMaxPieces], hi[kMaxPieces];
};

struct Args {
  const int8_t* x;    // K1: q (P, D); K6: xt (D, P)
  const float* s;     // K1: (P, 16); K6: (16, P)
  const float* sw;
  const float* bias;
  float* out;         // K1: (P, R); K6: (R, P)
  int32_t* ws;        // split: a slab a piece, each laid out as the output
  int P, R, D, hp, blk, staging, items;
};

// K6's producers staging xt by loads: the rows of the next chunk are asked
// into L2 before a chunk's loads, so that those loads, which wait on memory
// one chunk at a time, find them there (5-7% at the rel and ragged
// geometries in a design probe; two or four chunks ahead did no better)
constexpr int kPrefetch = 1;
__device__ __forceinline__ void prefetch_pair_rows(const int8_t* x, int k0, int p0, int P, int D,
                                                   int warp, int lane) {
  const int k = k0 + warp + 4 * lane;  // the 128 rows, one a producer thread
  if (k >= D) return;
  const int8_t* row = x + (size_t)k * P + p0;
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row));
  if (p0 + kK < P) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(row + kK - 1));
}

__device__ __forceinline__ int seg_begin(const Args& a, int seg) {
  return seg == 0 ? 0 : a.hp + (seg - 1) * a.blk;
}
__device__ __forceinline__ int seg_end(const Args& a, int seg) { return a.hp + seg * a.blk; }

#define ACC8(i)                                                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define ACC72 ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64)
#define D72                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, " \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
  "%66, %67, %68, %69, %70, %71"

// d (64 x 144, s32) (+)= A (64 x 32 s8) . B (32 x 144 s8, shared memory,
// K-major); d is overwritten when acc is 0. A from shared memory (K1) ...
__device__ __forceinline__ void mma_ss(int32_t (&d)[kAcc], uint64_t a_desc, uint64_t b_desc,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {" D72 "}, %72, %73, p;\n}\n"
      : ACC72
      : "l"(a_desc), "l"(b_desc), "r"(acc));
}
// ... or from registers (K6)
__device__ __forceinline__ void mma_rs(int32_t (&d)[kAcc], const uint32_t (&a)[4], uint64_t b_desc,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {" D72
      "}, {%72, %73, %74, %75}, %76, p;\n}\n"
      : ACC72
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(acc));
}

// every wgmma this warpgroup committed but the last group has completed
__device__ __forceinline__ void wgmma_wait_all_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// after wgmma_wait(): reads of the accumulators stay below it
__device__ __forceinline__ void fence_acc(int32_t (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

struct Item {
  int p0, n0, first, last;  // pieces [first, last)
  __device__ Item(int it, const Plan& plan, int col_blocks) {
    const int per_tile = plan.split ? plan.count : 1;
    const int tile = it / per_tile;
    p0 = tile / col_blocks * kRows;
    n0 = tile % col_blocks * kN;
    first = plan.split ? it % per_tile : 0;
    last = plan.split ? first + 1 : plan.count;
  }
};

__device__ __forceinline__ void store2(int32_t* d, int32_t a, int32_t b) {
  *reinterpret_cast<int2*>(d) = make_int2(a, b);
}
__device__ __forceinline__ void store2(float* d, float a, float b) {
  *reinterpret_cast<float2*>(d) = make_float2(a, b);
}

// A thread's accumulators acc[4 j + 2 h + e] are tile row `row_base +
// h * row_step` and column n0 + 8 j + 2 t + e (j < 18). K1: row 16 warp + g
// + 8 h of its warpgroup's 64; K6: pair 2g + h of its warp's 16.
template <bool kT>
struct Layout {
  int P, R;
  // The accumulators in pairs that neighbour in the output's layout: pair
  // (j, u) is acc[i(j, u, 0)] and acc[i(j, u, 1)], K1's columns n, n + 1
  // (u = h), K6's pairs p, p + 1 (u = e). K1 stores a pair as one 8-byte
  // store where both are live and R is even; K6 element by element (its
  // 8-byte stores cost it spilled registers and time).
  static __device__ __forceinline__ int i(int j, int u, int k) {
    return kT ? 4 * j + 2 * k + u : 4 * j + 2 * u + k;
  }
  template <typename T, typename F>
  __device__ __forceinline__ void store_pairs(T* base, int p, int n, int rows_step, F value) const {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int pp = kT ? p : p + u * rows_step, nn = n + 8 * j + (kT ? u : 0);
        const int p1 = kT ? pp + 1 : pp, n1 = kT ? nn : nn + 1;
        if (pp >= P || nn >= R) continue;
        T* dst = base + at(pp, nn);  // (p1, n1) is dst + 1
        const T v0 = value(i(j, u, 0), nn);
        if (p1 >= P || n1 >= R) {
          dst[0] = v0;
        } else if (kT || R % 2) {
          dst[0] = v0;
          dst[1] = value(i(j, u, 1), n1);
        } else {
          store2(dst, v0, value(i(j, u, 1), n1));
        }
      }
  }
  // the element (p, n) of the output, or of a piece's workspace slab
  __device__ __forceinline__ size_t at(int p, int n) const {
    return kT ? (size_t)n * P + p : (size_t)p * R + n;
  }
  __device__ __forceinline__ float scale(const float* s, int p, int seg) const {
    return p < P ? (kT ? s[(size_t)seg * P + p] : s[(size_t)p * 16 + seg]) : 0.f;
  }
};

// Thread 256 (TMA staging) or the producer warpgroup (K6 staged by loads)
// fills the ring; warpgroups 0 and 1 consume.
template <bool kT>
__global__ void __launch_bounds__(kThreads, 1)
q8s_sm90_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ Plan plan, const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint8_t* zero_a = ring + kStages * kStageBytes;
  float* facc_s = reinterpret_cast<float*>(zero_a + kZeroBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(zero_a + kZeroBytes + kFaccBytes);
  uint64_t* empty = full + kStages;
  const int col_blocks = (a.R + kN - 1) / kN;
  const int it_begin = (int)((long long)blockIdx.x * a.items / gridDim.x);
  const int it_end = (int)((long long)(blockIdx.x + 1) * a.items / gridDim.x);
  const bool loads = kT && a.staging == kLoads;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], loads ? 128 : 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (!kT) {
    for (int i = threadIdx.x; i < kZeroBytes / 16; i += kThreads)
      reinterpret_cast<int4*>(zero_a)[i] = make_int4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads it
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup
    const int u = threadIdx.x - 256, warp = u / 32, lane = u % 32;
    if (!loads && u != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = it_begin; it < it_end; ++it) {
      const Item item(it, plan, col_blocks);
      for (int pc = item.first; pc < item.last; ++pc) {
        const int k_begin = seg_begin(a, plan.seg[pc]);
        for (int c = plan.lo[pc]; c < plan.hi[pc]; ++c) {
          const int k0 = k_begin + c * kK;
          uint8_t* st = ring + stage * kStageBytes;
          mbar_wait(&empty[stage], phase ^ 1);
          if (loads) {
            prefetch_pair_rows(a.x, k0 + kPrefetch * kK, item.p0, a.P, a.D, warp, lane);
            stage_pair_rows(st, a.x, k0, item.p0, a.P, a.D, warp, lane);
          }
          // each thread arrives after its own stores; thread 256's arrival
          // also sets the bytes the stage's TMA loads bring
          if (u == 0) {
            mbar_expect_tx(&full[stage], (loads ? 0 : kABytes) + kN * kK);
            if (!loads) {
              if (kT)
                tma_load(st, &amap, &full[stage], item.p0, k0);
              else
                tma_load(st, &amap, &full[stage], k0, item.p0);
            }
            tma_load(st + kABytes, &bmap, &full[stage], k0, item.n0);
          } else {
            mbar_arrive(&full[stage]);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_base = 64 * wg + 16 * warp + (kT ? 2 * g : g), row_step = kT ? 1 : 8;
  const int lane_off = kT ? pair_major_lane_off(lane, 4 * wg + warp) : 0;
  const Layout<kT> lay{a.P, a.R};
  const uint32_t ring_addr = smem_addr(ring), zero_addr = smem_addr(zero_a);
  int32_t acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;
  // the thread's f32 accumulator i: facc[256 i], in shared memory, so that
  // the consumers need registers for the int32 sums (and K6's A) alone and
  // the producers keep theirs for staging
  float* facc = facc_s + threadIdx.x;

  // facc (+)= f32(acc) * s[p, seg], in the fixed order; first: the head
  auto fold = [&](int p0, int seg, bool first) {
    const float s0 = lay.scale(a.s, p0 + row_base, seg);
    const float s1 = lay.scale(a.s, p0 + row_base + row_step, seg);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const float part = __fmul_rn(__int2float_rn(acc[i]), (i >> 1) & 1 ? s1 : s0);
      facc[256 * i] = first ? part : __fadd_rn(facc[256 * i], part);
    }
  };

  int stage = 0, held = -1;  // K1: the stage of the products in flight
  uint32_t phase = 0;
  for (int it = it_begin; it < it_end; ++it) {
    const Item item(it, plan, col_blocks);
    for (int pc = item.first; pc < item.last; ++pc) {
      const int seg = plan.seg[pc], k_begin = seg_begin(a, seg), k_end = seg_end(a, seg);
      for (int c = plan.lo[pc]; c < plan.hi[pc]; ++c) {
        const int k0 = k_begin + c * kK;
        // 2 or 4 steps (segments end on 64 bytes); a step past the segment's
        // end multiplies a zero A, so that no wgmma sits on a branch
        const int steps = min(4, (k_end - k0) / 32);
        const uint32_t st = ring_addr + stage * kStageBytes;
        const uint64_t b_desc = kmajor_desc(st + kABytes);
        mbar_wait(&full[stage], phase);
        if constexpr (kT) {
          uint32_t af[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            pair_major_a(st + lane_off + s * 32 * kK, af[s]);
#pragma unroll
            for (int i = 0; i < 4; ++i) af[s][i] = s < steps ? af[s][i] : 0u;
          }
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_rs(acc, af[s], b_desc + (uint64_t)(2 * s), (c != plan.lo[pc]) | s);
        } else {
          wgmma_fence();
          const uint64_t a_desc = kmajor_desc(st + wg * 64 * kK), z_desc = kmajor_desc(zero_addr);
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_ss(acc, (s < steps ? a_desc : z_desc) + (uint64_t)(2 * s),
                   b_desc + (uint64_t)(2 * s), (c != plan.lo[pc]) | s);
        }
        wgmma_commit();
        if constexpr (kT) {  // A is rewritten next: wait for every product
          wgmma_wait();
          if (lane == 0) mbar_arrive(&empty[stage]);
        } else {  // keep this chunk's products in flight, free the last one's stage
          wgmma_wait_all_but_one();
          if (lane == 0 && held >= 0) mbar_arrive(&empty[held]);
          held = stage;
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (!kT) {
        wgmma_wait();
        if (lane == 0) mbar_arrive(&empty[held]);
        held = -1;
      }
      fence_acc(acc);
      if (!plan.split) {
        fold(item.p0, seg, pc == 0);
        continue;
      }
      // this piece's sums into its slab of the workspace
      lay.store_pairs(a.ws + (size_t)pc * a.P * a.R, item.p0 + row_base, item.n0 + 2 * t,
                      row_step, [&](int i, int) { return acc[i]; });
    }
    if (!plan.split)  // out = facc * sw + b
      lay.store_pairs(a.out, item.p0 + row_base, item.n0 + 2 * t, row_step, [&](int i, int n) {
        return __fadd_rn(__fmul_rn(facc[256 * i], a.sw[n]), a.bias[n]);
      });
  }
}

// The split's second kernel: out = fold of the pieces' slabs, one thread an
// output element (the slabs' layout, so a warp reads 128 contiguous bytes of
// each slab). The slabs of a segment are adjacent in `plan`.
template <bool kT>
__global__ void __launch_bounds__(256)
q8s_fold_kernel(const __grid_constant__ Plan plan, const __grid_constant__ Args a) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x, elems = (size_t)a.P * a.R;
  if (e >= elems) return;
  const int p = kT ? (int)(e % a.P) : (int)(e / a.R), n = kT ? (int)(e / a.P) : (int)(e % a.R);
  const Layout<kT> lay{a.P, a.R};
  int32_t v[kMaxPieces];  // every slab's load in flight at once
#pragma unroll
  for (int pc = 0; pc < kMaxPieces; ++pc)
    if (pc < plan.count) v[pc] = __ldcg(a.ws + pc * elems + e);
  float facc = 0.f;
  int32_t sum = 0;
#pragma unroll
  for (int pc = 0; pc < kMaxPieces; ++pc) {
    if (pc >= plan.count) break;
    sum += v[pc];
    const int seg = plan.seg[pc];
    if (pc + 1 < plan.count && plan.seg[pc + 1] == seg) continue;  // more shares to add
    const float part = __fmul_rn(__int2float_rn(sum), lay.scale(a.s, p, seg));
    facc = seg == 0 ? part : __fadd_rn(facc, part);
    sum = 0;
  }
  a.out[e] = __fadd_rn(__fmul_rn(facc, a.sw[n]), a.bias[n]);
}

template <bool kT>
int launch(const Args& args, const Plan& plan, const void* qw_t, int grid, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap amap{}, bmap{};
  const bool tma_rows = !kT || args.staging == kTma;
  if (tma_rows && !(kT ? encode_u8(encode, &amap, args.x, args.P, args.D, args.P, kRows, kK)
                       : encode_u8(encode, &amap, args.x, args.D, args.P, args.D, kK, kRows)))
    return (int)cudaErrorInvalidValue;
  if (!encode_u8(encode, &bmap, qw_t, args.D, args.R, args.D, kK, kN))
    return (int)cudaErrorInvalidValue;
  const auto kernel = q8s_sm90_kernel<kT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, kSmem, st>>>(amap, bmap, plan, args);
  e = cudaGetLastError();
  if (e != cudaSuccess || !plan.split) return (int)e;
  const long long elems = (long long)args.P * args.R;
  q8s_fold_kernel<kT><<<(unsigned)((elems + 255) / 256), 256, 0, st>>>(plan, args);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes: launches on `stream` and returns cudaGetLastError()
// (0 = launched). K1 (transposed 0): x = q (P, D), s (P, 16), out (P, R);
// K6 (transposed 1): x = xt (D, P), s = s_t (16, P), out (R, P); qw_t (R, D)
// int8, sw and bias (R,) f32; all contiguous, the int8 operands 16-byte
// aligned. hp, blk and D multiples of 64, D = hp + nb blk, nb < 16, D <
// 2^17. pieces: `count` (segment, first chunk, end chunk) int triples in
// fold order (host memory, read before the launch); without a split, the
// whole segments in order. split 1: one work item a (tile, piece), its sums
// in slab `piece` of ws (count slabs shaped as out, int32), then the fold
// kernel. staging 0: TMA (K6 needs P % 16 == 0), 1: K6's word loads. The
// plan comes from ops/pairwise.py::q8s_plan.
extern "C" int tspn_q8s_sm90_launch(const void* x, const void* s, const void* qw_t,
                                    const void* sw, const void* bias, void* out, void* ws,
                                    const void* pieces, int transposed, int P, int R, int D,
                                    int hp, int blk, int count, int split, int staging, int grid,
                                    void* stream) {
  if (P <= 0 || R <= 0 || D <= 0 || D >= (1 << 17) || hp <= 0 || blk <= 0 || hp % 64 ||
      blk % 64 || (D - hp) % blk || count < 1 || count > kMaxPieces || grid < 1 ||
      staging < kTma || staging > kLoads || (staging == kLoads && !transposed) ||
      (transposed && staging == kTma && P % 16) || (split && !ws))
    return (int)cudaErrorInvalidValue;
  const int nseg = 1 + (D - hp) / blk;
  if (nseg > kMaxSegs) return (int)cudaErrorInvalidValue;
  Plan plan{};
  plan.count = count;
  plan.split = split != 0;
  // the segments in order, each covered once by its pieces' chunks;
  // without a split one piece a segment
  const int* tbl = static_cast<const int*>(pieces);
  auto chunks = [&](int seg) { return ((seg == 0 ? hp : blk) + kK - 1) / kK; };
  for (int i = 0; i < count; ++i) {
    const int seg = tbl[3 * i], lo = tbl[3 * i + 1], hi = tbl[3 * i + 2];
    const int prev = i ? plan.seg[i - 1] : -1, prev_hi = i ? plan.hi[i - 1] : 0;
    const bool starts = seg == prev + 1 && lo == 0 && (i == 0 || prev_hi == chunks(prev));
    const bool goes_on = plan.split && seg == prev && lo == prev_hi;
    if (!(starts || goes_on) || hi <= lo || hi > chunks(seg) ||
        (!plan.split && hi != chunks(seg)) ||
        (i + 1 == count && (seg != nseg - 1 || hi != chunks(seg))))
      return (int)cudaErrorInvalidValue;
    plan.seg[i] = (uint8_t)seg;
    plan.lo[i] = (uint16_t)lo;
    plan.hi[i] = (uint16_t)hi;
  }
  const long long tiles = ((long long)P + kRows - 1) / kRows * ((R + kN - 1) / kN);
  const long long items = tiles * (plan.split ? count : 1);
  if (items > 0x7FFFFFFF || (long long)P * R > 0x7FFFFFFFLL * 256) return (int)cudaErrorInvalidValue;
  Args args{(const int8_t*)x, (const float*)s, (const float*)sw, (const float*)bias, (float*)out,
            (int32_t*)ws, P, R, D, hp, blk, staging, (int)items};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return transposed ? launch<true>(args, plan, qw_t, grid, st)
                    : launch<false>(args, plan, qw_t, grid, st);
}
