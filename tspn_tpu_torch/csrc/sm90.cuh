// Hopper (sm_90a) helpers shared by the kernels of this directory that run
// mbarrier rings, TMA and wgmma: csrc/roi_probes.cu, csrc/pair_probe.cu and
// csrc/q8s_sm90.cu.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
// wait for the phase of `bar` with this parity to complete; a wait of
// more than 2^35 cycles (about 19 s) traps rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  long long start = 0;
  for (bool first = true;; first = false) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (first)
      start = clock64();
    else if (clock64() - start > (1ll << 35))
      __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// every wgmma this warpgroup committed has completed
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the box at (inner c0, outer c1) of a 2-D map into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of an 8-bit K-major operand staged by TMA with the
// 128-byte swizzle: 128-byte rows, 8-row groups 1024 bytes apart (SBO); LBO
// is unused for a swizzled K-major operand. Adding (k bytes) >> 4 moves it
// k bytes along K within the rows.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// A pair-major int8 operand, x (D, P) with the pairs of a k row contiguous,
// as the probe (csrc/pair_probe.cu) and K6 (csrc/q8s_sm90.cu) take it. A
// stage is 128 k rows x 128 pairs (one byte each) with the 128-byte swizzle,
// as TMA writes it. 8-bit wgmma reads only K-major operands from shared
// memory, so such an operand is A, formed in registers.

// Stage k rows k0 .. k0 + 127 of pairs p0 .. p0 + 127 where TMA cannot
// describe x (P % 16 != 0), by the 4 warps of a warpgroup: warp `warp`
// stages k rows warp + 4 i, lane l bytes 4l..4l+3 of each, all loads issued
// before the first store. The loads are aligned words, lane l's at the
// row's first word + l, so a warp reads whole lines; where the row starts
// off a word boundary (P % 4 != 0) each lane also reads the next word and
// shifts its 4 bytes out of the two. A word is read only if it holds a byte
// of the row, and bytes past P and rows past D are zero. (Byte loads, which
// ask for a warp's 32-byte sectors one by one, ran several times slower.)
__device__ __forceinline__ void stage_pair_rows(uint8_t* xs, const int8_t* x, int k0, int p0,
                                                int P, int D, int warp, int lane) {
  constexpr int kRowsPerWarp = 32;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(x);
  uint32_t lo[kRowsPerWarp], hi[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int k = k0 + warp + 4 * i;
    const size_t a = (size_t)k * P + p0, end = (size_t)k * P + P, w0 = a / 4 + lane;
    lo[i] = k < D && 4 * w0 < end ? __ldg(xw + w0) : 0u;
    hi[i] = a % 4 && k < D && 4 * (w0 + 1) < end ? __ldg(xw + w0 + 1) : 0u;
  }
  uint32_t v[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const size_t a = (size_t)(k0 + warp + 4 * i) * P + p0;
    uint32_t word = __funnelshift_r(lo[i], hi[i], (int)(a % 4) * 8);
    const int valid = P - (p0 + 4 * lane);  // bytes of the row from this lane's
    if (valid < 4) word = valid <= 0 ? 0u : word & ((1u << (8 * valid)) - 1u);
    v[i] = word;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = warp + 4 * i, chunk = (lane / 4) ^ (row & 7);
    *reinterpret_cast<uint32_t*>(xs + row * 128 + chunk * 16 + (lane % 4) * 4) = v[i];
  }
}

// The order of a tile's rows is free: accumulator row g of a warp is pair
// 2g and row g + 8 pair 2g + 1 of the warp's 16 pairs, which are one 16-byte
// chunk (`chunk`) of a stage row. ldmatrix.x4.trans: lane l gives row l % 8
// of matrix l / 8; matrix q holds k rows 16 (q / 2) + 4 (r / 2) + 2 (q % 2) +
// r % 2 (r = 0..7) of the warp's pairs (8 16-bit units), so lane (g, t)
// receives k 4t, 4t + 1 (matrix 0) and 4t + 2, 4t + 3 (matrix 1) of pairs 2g
// and 2g + 1 (and the same 16 k further on from matrices 2 and 3). This is
// the lane's byte offset in a stage.
__device__ __forceinline__ int pair_major_lane_off(int lane, int chunk) {
  const int q = lane / 8, r = lane % 8;
  const int krow = 16 * (q / 2) + 4 * (r / 2) + 2 * (q % 2) + r % 2;
  return krow * 128 + ((chunk ^ (krow & 7)) << 4);
}

// The four A registers of the k32 step whose rows start at `addr` (the
// stage, plus the lane's offset, plus 32 rows a step).
__device__ __forceinline__ void pair_major_a(uint32_t addr, uint32_t (&a)[4]) {
  uint32_t m0, m1, m2, m3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(m0), "=r"(m1), "=r"(m2), "=r"(m3)
               : "r"(addr));
  // m0 = (2g k0, 2g+1 k0, 2g k1, 2g+1 k1), m1 the same at k2, k3
  a[0] = __byte_perm(m0, m1, 0x6420);  // pair 2g (row g): k 4t..4t+3
  a[1] = __byte_perm(m0, m1, 0x7531);  // pair 2g + 1 (row g + 8)
  a[2] = __byte_perm(m2, m3, 0x6420);  // k 16 + 4t..
  a[3] = __byte_perm(m2, m3, 0x7531);
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library links against the runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D int8 map (inner, outer) with rows `stride` bytes apart, boxes of
// box_inner x box_outer with the 128-byte swizzle (zeros past the edges)
bool encode_u8(EncodeTiled encode, CUtensorMap* map, const void* base, int inner, int outer,
               int stride, int box_inner, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
