// The raw int8 probe of tools/bench_pair_kernels.py (Tp) for sm_90a:
//
//     out (R, P) int32 = w (R, D) int8 . x (D, P) int8
//
// Replaces the Pallas kernel of tools/bench_pair_kernels.py::_mk_probe.
// Modes (chosen by the wrapper, ops/pairwise.py::pair_probe): "onedot" and
// "blocks_noscale" compute every row (the same integers), "stream" rows r <
// 32 only, leaving the rest zero. |sum| <= 128^2 * D < 2^31 for D < 2^17.
//
// What bounds it (the tool's 160 x 11,264 x 95,232): 1.07 GB of x, 61 MB
// of output and 1.8 MB of w, 0.339 ms at 3.35 TB/s, against 343 GOP, 0.173
// ms at the int8 tensor cores' 1,979 TOP/s. So x must be read from device
// memory once, and the tensor cores must run at over half their rate before
// the bytes bind: wgmma, since mma.sync s8 stays under that here.
//
// Design.
// - A tile is 128 pairs x all R rows (in blocks of N = 160 rows; N = 32 in
//   stream mode), so each x byte is read once; w's k-chunks come from L2.
//   One persistent block per SM walks work items: a tile, or a tile's share
//   of D when there are fewer tiles than SMs (split-K: each share adds its
//   int32 partial into an output the wrapper zeroed, with atomics; integer
//   sums do not depend on their order, so the result stays exact).
// - Warpgroups 0 and 1 consume (64 pairs each); thread 256 issues the TMA
//   loads of a 5-stage ring, each stage 128 bytes of D: x's (128 k x 128
//   pairs) box and w's (N x 128 k) box, both with the 128-byte swizzle.
// - wgmma.m64nNk32.s32.s8.s8: B is w's box (K-major, as w is stored); A is
//   x, which is pair-major, and 8-bit wgmma reads only K-major operands from
//   shared memory, so A is formed in registers. The order of the rows of a
//   tile is free: accumulator row g of a warp is pair 2g and row g + 8 is
//   pair 2g + 1, so one ldmatrix.x4.trans of 16-bit units (two adjacent
//   pairs) gives a thread k 4t..4t+3 of both its pairs as two words, and
//   two __byte_perm split them into its two A registers (four per k32).
//   The epilogue stores each pair couple as one 8-byte int2.
// - A wgmma reads its A registers until it completes, so a warpgroup waits
//   for its own products (wgmma.wait_group 0) before it forms A again; the
//   other warpgroup's products keep the tensor cores busy meanwhile.
// - Where P % 16 != 0, TMA cannot describe x (its row stride must be a
//   multiple of 16 bytes): the producer warpgroup stages x itself into the
//   same swizzled layout, one 128-byte row of a stage per warp instruction
//   of aligned 4-byte loads (where P % 4 != 0 each lane shifts its bytes
//   out of two neighbouring words: byte loads, which ask for a warp's
//   32-byte sectors one by one, ran several times slower); w still comes
//   by TMA. Same layout, same arithmetic, same integers.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kPairs = 128;             // pairs per tile
constexpr int kK = 128;                 // bytes of D per stage
constexpr int kStages = 5;
constexpr int kXBytes = kK * kPairs;    // x box: 128 k rows x 128 pairs
constexpr int kThreads = 384;           // 2 consumer warpgroups + 1 producer
enum Staging { kTma = 0, kLoads = 1 };

template <int N>
struct Ring {
  static constexpr int kWBytes = N * kK;  // w box: N rows x 128 k
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// D (64 x N, s32) += A (64 x 32 s8, registers) * B (32 x N s8, shared
// memory, K-major); D is zeroed first when acc is 0.
template <int N>
struct Mma;

template <>
struct Mma<160> {
  static __device__ __forceinline__ void run(int32_t (&d)[80], const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
          "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
          "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
          "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
          "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
          "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
          "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
          "+r"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(int32_t (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

// The work items: item = (pair tile, row block, D share), shares fastest;
// share ks of `split` covers k-chunks [ks * chunks / split, (ks + 1) *
// chunks / split), whole 128-byte chunks.
struct Item {
  int p0, n0, c_lo, c_hi;
  __device__ Item(int it, int split, int row_blocks, int chunks, int n) {
    const int ks = it % split, tile = it / split;
    p0 = tile / row_blocks * kPairs;
    n0 = tile % row_blocks * n;
    c_lo = (int)((long long)ks * chunks / split);
    c_hi = (int)((long long)(ks + 1) * chunks / split);
  }
};

// Thread 256 (TMA staging) or warpgroup 2 (staging by loads) fills the
// ring; warpgroups 0 and 1 consume. Rows r >= r_live of the output are
// zero (stream mode); with split == 1 the kernel writes them, with split
// > 1 the wrapper zeroed the output.
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
pair_probe_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const int8_t* __restrict__ x, int32_t* __restrict__ out, int P, int R, int D,
                  int r_live, int split, int staging, int items) {
  using RingN = Ring<N>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * RingN::kStageBytes);
  uint64_t* empty = full + kStages;
  const int row_blocks = (r_live + N - 1) / N, chunks = (D + kK - 1) / kK;
  const int it_begin = (int)((long long)blockIdx.x * items / gridDim.x);
  const int it_end = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], staging == kTma ? 1 : 128);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup
    const int u = threadIdx.x - 256, warp = u / 32, lane = u % 32;
    if (staging == kTma && u != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = it_begin; it < it_end; ++it) {
      const Item item(it, split, row_blocks, chunks, N);
      for (int c = item.c_lo; c < item.c_hi; ++c) {
        uint8_t* xs = ring + stage * RingN::kStageBytes;
        mbar_wait(&empty[stage], phase ^ 1);
        if (staging == kLoads) stage_pair_rows(xs, x, c * kK, item.p0, P, D, warp, lane);
        // each thread arrives after its own stores; thread 0's arrival
        // also sets the bytes the stage's TMA loads bring
        if (u == 0) {
          mbar_expect_tx(&full[stage], (staging == kTma ? kXBytes : 0) + RingN::kWBytes);
          if (staging == kTma) tma_load(xs, &xmap, &full[stage], item.p0, c * kK);
          tma_load(xs + kXBytes, &wmap, &full[stage], c * kK, item.n0);
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int lane_off = pair_major_lane_off(lane, 4 * wg + warp);
  const uint32_t ring_addr = smem_addr(ring);
  int32_t acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = it_begin; it < it_end; ++it) {
    const Item item(it, split, row_blocks, chunks, N);
    for (int c = item.c_lo; c < item.c_hi; ++c) {
      const uint32_t xs = ring_addr + stage * RingN::kStageBytes;
      mbar_wait(&full[stage], phase);
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) pair_major_a(xs + lane_off + s * 32 * kK, a[s]);  // k32 step s
      wgmma_fence();
      const uint64_t desc = kmajor_desc(xs + kXBytes);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        Mma<N>::run(acc, a[s], desc + (uint64_t)((s * 32) >> 4), (c != item.c_lo) | s);
      wgmma_commit();
      wgmma_wait();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");

    // acc[4 j + 2 h + e]: tile row 16 warp + g + 8 h (pair 2g + h of the
    // warp's 16), output row n0 + 8 j + 2 t + e
    const int p = item.p0 + 64 * wg + 16 * warp + 2 * g;
    const bool pair2 = p + 1 < P && (P % 2) == 0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = item.n0 + 8 * j + 2 * t + e;
        if (n >= r_live || p >= P) continue;
        const int32_t v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
        int32_t* dst = out + (size_t)n * P + p;
        if (split > 1) {
          atomicAdd(dst, v0);
          if (p + 1 < P) atomicAdd(dst + 1, v1);
        } else if (pair2) {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        } else {
          dst[0] = v0;
          if (p + 1 < P) dst[1] = v1;
        }
      }
    if (split == 1 && r_live < R) {  // stream mode: the rows it leaves zero
      for (int e = threadIdx.x; e < (R - r_live) * kPairs; e += 256) {
        const int pe = item.p0 + e % kPairs;
        if (pe < P) out[(size_t)(r_live + e / kPairs) * P + pe] = 0;
      }
    }
  }
}

template <int N>
int launch(const void* x, const void* w, void* out, int P, int R, int D, int r_live, int split,
           int staging, int grid, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap xmap{}, wmap{};
  if (staging == kTma && !encode_u8(encode, &xmap, x, P, D, P, kPairs, kK))
    return (int)cudaErrorInvalidValue;
  if (!encode_u8(encode, &wmap, w, D, R, D, kK, N)) return (int)cudaErrorInvalidValue;
  const auto kernel = pair_probe_kernel<N>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<N>::kSmem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = ((long long)P + kPairs - 1) / kPairs * ((r_live + N - 1) / N);
  if (tiles * split > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kThreads, Ring<N>::kSmem, st>>>(xmap, wmap, (const int8_t*)x, (int32_t*)out, P, R,
                                                  D, r_live, split, staging, (int)(tiles * split));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes: launches on `stream` and returns cudaGetLastError()
// (0 = launched). x (D, P) and w (R, D) int8, contiguous, 16-byte aligned;
// out (R, P) int32, zeroed when split > 1. The plan (ops/pairwise.py::
// probe_plan): n 160 (r_live = R) or 32 (stream mode, r_live = min(R, 32)),
// split the D shares per tile, staging 0 (TMA: P % 16 == 0) or 1 (aligned
// 4-byte loads, shifted where P % 4 != 0), grid the persistent blocks.
extern "C" int tspn_pair_probe_launch(const void* x, const void* w, void* out, int P, int R,
                                      int D, int r_live, int n, int split, int staging, int grid,
                                      void* stream) {
  const int chunks = (D + kK - 1) / kK;
  if (P <= 0 || R <= 0 || D <= 0 || D % 64 || D >= (1 << 17) || r_live <= 0 || r_live > R ||
      split < 1 || split > chunks || grid < 1 || staging < kTma || staging > kLoads ||
      (staging == kTma && P % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 160) return launch<160>(x, w, out, P, R, D, r_live, split, staging, grid, st);
  if (n == 32) return launch<32>(x, w, out, P, R, D, r_live, split, staging, grid, st);
  return (int)cudaErrorInvalidValue;
}
