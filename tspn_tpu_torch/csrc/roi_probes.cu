// The RoIAlign probes of tools/bench_roialign_{fused,variants}.py (T-roi)
// for sm_90a: the fused separable form, and the dense-G GEMM with G built
// from the box or held constant.
//
// Replaces three Pallas kernels:
//  * tools/bench_roialign_fused.py::_make_roi_align_sep_fused (body
//    _kernel_sep_fused): roi_sep_fused_kernel below;
//  * tools/bench_roialign_variants.py::main.<locals>.roi_selector (body
//    _kernel_sel): roi_gemm_f32_kernel (f32 maps) / roi_gemm_bf16_kernel
//    (bf16 maps), kConst false;
//  * tools/bench_roialign_variants.py::main.<locals>.roi_constg (body
//    _kernel_const): the same kernels, kConst true.
//
// All take channels-last maps F (B, H, W, C), f32 or bf16, and boxes
// (B, R, 4) f32 xyxy in feature coordinates; RoI r of image b pools F[b].
// Each block builds its RoI's pooled axis tables itself, in shared memory,
// with the arithmetic of ops/roi_align.py::_pooled_tables (and of K7): for
// output bin i and sample a, coord = lo + ((i*s + a + .5) / s) * (extent /
// out) with lo = x0 - .5 and extent = max(x1 - x0, 1e-6); torchvision's
// border rules give taps (i0, w0), (i1, w1); t[i][y] sums the weights of
// the s samples that land on y (the TPU kernels' _pooled_axis_weights).
// Every operation is a round-to-nearest intrinsic, so the tables equal the
// plain versions' (ops/roi_probes.py) bit for bit.
//
// roi_sep_fused_kernel (T-roi 1): with wy = bf(ty / s^2) and wx = bf(tx)
// rounded to the map's dtype (bf = identity for f32),
//     tmp[i, w, c] = sum_h wy[i, h] F[h, w, c]            (f32)
//     out[i, j, c] = sum_w wx[j, w] tmp[i, w, c]          -> map dtype
// dense over H and W, as the TPU kernel (a tap of weight 0 still counts:
// it carries a NaN or Inf of the map, as the plain version does).
// What bounds it (the tool's 4 x 256 RoIs on 40 x 40 x 1024): 47 GFLOP of
// stage 1 and 16.4 of stage 2; f32 maps on the CUDA cores, 0.946 ms at 67
// TFLOP/s; bf16 maps with stage 1 on the bf16 tensor cores and stage 2 in
// f32 (tmp is f32 in the TPU kernel), 0.293 ms. The first design (one RoI
// x 32 channels a block, one (w, c) column a thread, F read by scalar
// loads in the FMA loop, tables rebuilt by every channel block, bf16 on the
// f32 loop) reached 24% and 7% of that. This one:
//  - A block takes 8 RoIs of one image (they share every load of F: an
//    eighth of the L2 traffic) and walks a share of the 16-channel tiles,
//    building the RoIs' tables once (with the plain versions' arithmetic).
//  - F streams through a 6-stage cp.async ring of slabs (8 map rows f32, 16
//    bf16) x 8 columns x 16 channels, loads running ahead of the products.
//  - The columns go by chunks of 8: stage 1 fills the chunk's tmp (8 RoIs
//    x 14 x 8 x 16 f32, 64.5 KB, whatever W is), stage 2 adds the chunk into
//    register accumulators (RoI, bin row i, 4 channels: all 14 j), so the
//    intermediate never grows with W (and W = 40 needs no padding).
//  - f32 stage 1: a thread owns (RoI, 7 bins, column, 4 channels); per map
//    row one float4 of F and broadcasts of wy feed 28 FMAs (two rows at a
//    time: at 512 threads a thread has 128 registers). bf16 stage 1:
//    mma.sync.m16n8k16 bf16 -> f32, the 14 bins padded to 16 as A (wy rows
//    by ldmatrix), F as B by ldmatrix.trans (the slab's rows padded by 16
//    bytes so that the 8 rows of a matrix hit distinct banks); each warp
//    owns one RoI's 4 columns x 16 channels. bf16 products are exact in
//    f32, so only the order of the sums moves.
//  - Stage 2 (f32 in both): one float4 of tmp and broadcasts of wx feed 56
//    FMAs; 16-byte (f32) or 8-byte (bf16) streaming stores (the output is
//    never read back here).
// Design probes not kept: 4 RoIs x 16-column chunks in 256 threads (twice
// the L2 traffic, W = 40 padded to 48) was slower; an 8- or 10-stage
// ring, 16-row f32 slabs and an unrolled stage 2 gained nothing. With the
// loads removed the kernel keeps most of its time: the FMA issue of stage
// 1 (f32) and of stage 2 bounds it, not F's traffic.

// roi_gemm (T-roi 2, 3): out[(i,j), c] = sum_{(y,x)} G[(i,j),(y,x)] F[(y,x), c]
// with G = bf((ty[i][y] * tx[j][x]) * (1/s^2)) (selector: the TPU kernel's
// _kernel_sel without its one-hot selector matmuls, which only expanded the
// same tables) or G = bf(x0 * 1e-6) everywhere (constg: the lower bound of
// the G form, not RoIAlign). The selector writes the map's dtype, constg
// f32 (as the TPU probes do). Each image's RoIs make one GEMM of M = R * 196
// stacked rows (row m: RoI m / 196, bin i = (m % 196) / 14, j = m % 14), K =
// H * W and N = C. A tile of 128 rows touches at most two RoIs, whose axis
// tables the block builds in shared memory; G is formed from them as it is
// needed and never stored in device memory.
//
// What bounds them (the tools' defaults, 4 x 256 RoIs on 40 x 40 x 1024):
// 0.658 TFLOP against 13 (bf16) or 26 MB (f32) of map and 411 MB (bf16) or
// 822 MB (f32) of output, so the bf16 tensor cores bound bf16 maps (0.665
// ms at 989 TFLOP/s) and the f32 CUDA cores bound f32 maps (9.82 ms at 67
// TFLOP/s, no TF32). The first design (one padded GEMM per RoI, mma.sync)
// reached 18% and 11% of the bf16 bound; what held it back, and what this
// one does instead:
//  1. 64-row tiles per RoI: 196 rows padded to 256, 23% of the work on
//     zeros. Now the stacked rows, padded only in an image's last tile.
//  2. F read again for every 64 x 128 tile, 13.4 GB from L2 in bf16 and
//     26.8 in f32. Now 128 x 256 tiles in bf16 (about 5.1 GB) and 128 x 128
//     in f32 (about 10.3 GB).
//  3. A two-buffer cp.async ring drained at every K chunk, and mma.sync.
//     bf16 now runs wgmma.m64n256k16 in two consumer warpgroups, fed by a
//     4-stage TMA ring (mbarriers, one producer thread, setmaxnreg moving
//     registers to the consumers); one persistent block per SM walks the
//     tiles, so the producer streams the next tile while a tile's stores
//     drain. A warpgroup waits for its own products before it writes A
//     again (see the consumer loop); the other warpgroup's products fill
//     the gap. f32 keeps a 3-stage cp.async ring, one barrier per chunk.
//  4. G through shared memory twice, element by element, with branches. In
//     bf16 each consumer thread forms its A fragments in registers: a stage
//     holds an 8 x 8 (y, x) block of the map, so a k16 step's 8 values of
//     a thread are 2 ty values times 2 tx values of its 2 rows, read from
//     the tables once per 64 k (6 shared loads, no division). In f32, G's
//     128 x 16 tile (a 2 x 8 block) is formed once per chunk into shared
//     memory and read back as float4 broadcasts.
//  5. One-element stores. The bf16 selector's lanes swap values within a
//     quad and store 16 bytes each; f32 outputs go out as float2 (bf16
//     maps' constg) or float4 (f32 maps). Staging the output in shared
//     memory for TMA stores was slower in a design probe: it costs the
//     ring a stage and the consumers registers.
//  6. A 4 x 8 register tile in f32 (0.375 shared loads a FMA). Now 8 x 8
//     (0.25).
// Ragged edges: TMA fills zeros past H, W (an 8 x 8 block of a 29 x 33 map
// overhangs; f32's 2 x 8 blocks likewise, by cp.async) and no box is loaded
// past C (C = 128 * odd: the last tile's upper half is never stored); rows
// past R * 196 are not stored.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kOut = 14;        // output bins per axis (the C4 head)
constexpr int kMaxAxis = 128;   // H, W
constexpr int kMaxRatio = 16;   // s

struct Tap {
  int i0, i1;
  float w0, w1;
};

// torchvision's bilinear_interpolate along one axis (as K7, roi_align.cu)
__device__ __forceinline__ Tap bilinear_1d(float coord, int size) {
  Tap t{0, 0, 0.f, 0.f};
  if (!(coord >= -1.f && coord <= (float)size)) return t;
  const float c = fmaxf(coord, 0.f);
  const float low = floorf(c);
  const bool at_top = low >= (float)(size - 1);
  t.i0 = at_top ? size - 1 : (int)low;
  t.i1 = at_top ? size - 1 : (int)low + 1;
  const float frac = at_top ? 0.f : __fsub_rn(c, low);
  t.w0 = __fsub_rn(1.f, frac);
  t.w1 = frac;
  return t;
}

__device__ __forceinline__ float sample_coord(float lo, float extent, int k, int s) {
  const float grid = __fdiv_rn(__fadd_rn((float)k, 0.5f), (float)s);
  return __fadd_rn(lo, __fmul_rn(grid, __fdiv_rn(extent, (float)kOut)));
}

// the summed weight of the s samples of bin i on index y < size
__device__ float bin_weight(float lo, float extent, int size, int s, int i, int y) {
  float acc = 0.f;
  for (int a = 0; a < s; ++a) {
    const Tap tp = bilinear_1d(sample_coord(lo, extent, i * s + a, s), size);
    acc = __fadd_rn(acc, __fadd_rn(y == tp.i0 ? tp.w0 : 0.f, y == tp.i1 ? tp.w1 : 0.f));
  }
  return acc;
}

struct Box {
  float x0, y0, bw, bh, raw_x0;
};

__device__ __forceinline__ Box read_box(const float* b) {
  Box r;
  r.raw_x0 = b[0];
  r.x0 = __fsub_rn(b[0], 0.5f);
  r.y0 = __fsub_rn(b[1], 0.5f);
  r.bw = fmaxf(__fsub_rn(b[2], b[0]), 1e-6f);
  r.bh = fmaxf(__fsub_rn(b[3], b[1]), 1e-6f);
  return r;
}

// v rounded to T and widened back
template <typename T>
struct Io;
template <>
struct Io<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};


__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

// ------------------------------------------------------- T-roi 1: fused
constexpr int kSepG = 8;          // RoIs per block
constexpr int kSepCt = 16;        // channels per tile
constexpr int kSepWc = 8;         // columns per chunk
constexpr int kSepStages = 6;     // cp.async ring of F slabs
constexpr int kSepThreads = 512;
constexpr int kTmpStride = kSepWc * kSepCt + 16;  // floats per (RoI, i) row of tmp
constexpr int kSlabBytes = 16 * (kSepWc * kSepCt * 2 + 16);

template <typename T>
struct SepCfg;
template <>
struct SepCfg<float> {
  static constexpr int kRows = 8;                         // map rows per slab
  static constexpr int kRowBytes = kSepWc * kSepCt * 4;   // threads read along it
};
template <>
struct SepCfg<__nv_bfloat16> {
  static constexpr int kRows = 16;                        // one k16 step
  static constexpr int kRowBytes = kSepWc * kSepCt * 2 + 16;  // ldmatrix rows on distinct banks
};

// dynamic shared memory of a block: ring, tmp, wx (f32), wy (f32 [8][14][hp]
// or bf16 [8][16][hp + 8])
template <typename T>
int sep_smem_bytes(int H, int W) {
  const int hp = (H + SepCfg<T>::kRows - 1) / SepCfg<T>::kRows * SepCfg<T>::kRows;
  const int wp = (W + kSepWc - 1) / kSepWc * kSepWc;
  const int wy = sizeof(T) == 2 ? kSepG * 16 * (hp + 8) * 2 : kSepG * kOut * hp * 4;
  return kSepStages * kSlabBytes + kSepG * kOut * kTmpStride * 4 + kSepG * kOut * wp * 4 + wy;
}

// Block (x, y, z): RoIs 8y..8y+7 of image z (clamped to R - 1; stores past R
// skipped), channel tiles x, x + gridDim.x, ...
template <typename T>
__global__ void __launch_bounds__(kSepThreads, 1)
roi_sep_fused_kernel(const T* __restrict__ feat, const float* __restrict__ boxes,
                     T* __restrict__ out, int R, int H, int W, int C, int s) {
  using Cfg = SepCfg<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t sep_smem[];
  const int tid = threadIdx.x, b = blockIdx.z, r0 = blockIdx.y * kSepG;
  const int hp = (H + Cfg::kRows - 1) / Cfg::kRows * Cfg::kRows;
  const int wp = (W + kSepWc - 1) / kSepWc * kSepWc;
  const int wy_rows = kBf16 ? 16 : kOut, wy_ld = kBf16 ? hp + 8 : hp;
  uint8_t* ring = sep_smem;
  float* tmp = reinterpret_cast<float*>(ring + kSepStages * kSlabBytes);
  float* wx = tmp + kSepG * kOut * kTmpStride;   // [g][j][wp]
  T* wy = reinterpret_cast<T*>(wx + kSepG * kOut * wp);  // [g][i][wy_ld]

  {  // the tables of the block's RoIs; zero past H and W and in bf16 rows 14, 15
    const float inv_s2 = __fdiv_rn(1.f, (float)(s * s));
    const int n_wx = kSepG * kOut * wp, n_wy = kSepG * wy_rows * wy_ld;
    for (int e = tid; e < n_wx + n_wy; e += kSepThreads) {
      const bool is_x = e < n_wx;
      const int f = is_x ? e : e - n_wx, ld = is_x ? wp : wy_ld, rows = is_x ? kOut : wy_rows;
      const int g = f / (rows * ld), i = f / ld % rows, y = f % ld, size = is_x ? W : H;
      const Box bx = read_box(boxes + 4 * ((size_t)b * R + min(r0 + g, R - 1)));
      const float v = i < kOut && y < size ? bin_weight(is_x ? bx.x0 : bx.y0, is_x ? bx.bw : bx.bh,
                                                        size, s, i, y)
                                           : 0.f;
      if (is_x)
        wx[f] = Io<T>::round(v);
      else if constexpr (kBf16)
        wy[f] = __float2bfloat16_rn(__fmul_rn(v, inv_s2));
      else
        wy[f] = __fmul_rn(v, inv_s2);
    }
  }

  const int n_ct = C / kSepCt, n_wc = wp / kSepWc, n_hb = hp / Cfg::kRows;
  const int per_tile = n_wc * n_hb;
  const int my_tiles = (n_ct - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int slabs = my_tiles * per_tile;
  const T* img = feat + (size_t)b * H * W * C;
  // slab q: tile q / per_tile, chunk q % per_tile / n_hb, row block q % n_hb;
  // pieces of 16 bytes (row, column, channel piece), zero past H and W
  auto load_slab = [&](int q) {
    if (q < slabs) {
      constexpr int kPieces = kSepCt * (int)sizeof(T) / 16;
      const int c0 = ((int)blockIdx.x + q / per_tile * (int)gridDim.x) * kSepCt;
      const int w0 = q % per_tile / n_hb * kSepWc, h0 = q % n_hb * Cfg::kRows;
      uint8_t* dst = ring + q % kSepStages * kSlabBytes;
      for (int e = tid; e < Cfg::kRows * kSepWc * kPieces; e += kSepThreads) {
        const int hh = e / (kSepWc * kPieces), ww = e / kPieces % kSepWc, pc = e % kPieces;
        const int h = h0 + hh, w = w0 + ww;
        const bool in = h < H && w < W;
        cp_async16(dst + hh * Cfg::kRowBytes + (ww * kPieces + pc) * 16,
                   img + (size_t)(in ? h * W + w : 0) * C + c0 + pc * (16 / (int)sizeof(T)), in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);  // empty past the end: the count stays true
  };

  // stage-1 unit (f32): RoI g1, bins 7 ih..+6, chunk column w1, channels 4
  // c1..+3 (a warp shares g1 and ih); (bf16): warp -> RoI warp / 2, chunk
  // columns 4 (warp % 2)..+3, all 16 channels. stage-2 unit (threads <
  // 448): RoI g2, bin row i2, channels 4 c2..+3, all 14 j
  const int g1 = tid / 64, ih = tid / 32 % 2, w1 = tid / 4 % kSepWc, c1 = tid % 4;
  const int warp = tid / 32, lane = tid % 32, gw = warp / 2, wb = 4 * (warp % 2);
  const bool s2_on = tid < kSepG * kOut * 4;
  const int g2 = tid / (kOut * 4), i2 = tid / 4 % kOut, c2 = tid % 4;
  for (int q = 0; q < kSepStages - 1; ++q) load_slab(q);
  int q = 0;
  for (int tl = 0; tl < my_tiles; ++tl) {
    const int c0 = ((int)blockIdx.x + tl * (int)gridDim.x) * kSepCt;
    float o[kOut][4];
#pragma unroll
    for (int j = 0; j < kOut; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
    for (int wc = 0; wc < n_wc; ++wc) {
      // f32: s1[i - 7 ih][c]; bf16: s1[n-tile 2 wl + half][mma accumulator]
      float s1[kBf16 ? 8 : 7][4];
#pragma unroll
      for (int i = 0; i < (kBf16 ? 8 : 7); ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s1[i][c] = 0.f;
      for (int hb = 0; hb < n_hb; ++hb, ++q) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kSepStages - 2));
        __syncthreads();  // slab q in place; every thread is past slab q - 1 (and the tables)
        load_slab(q + kSepStages - 1);
        const uint8_t* slab = ring + q % kSepStages * kSlabBytes;
        const int h0 = hb * Cfg::kRows;
        if constexpr (!kBf16) {
          const float* fs = reinterpret_cast<const float*>(slab) + w1 * kSepCt + c1 * 4;
          const float* wyp = reinterpret_cast<const float*>(wy) + (g1 * kOut + 7 * ih) * wy_ld + h0;
#pragma unroll
          for (int hh = 0; hh < Cfg::kRows; hh += 2) {  // two rows: fewer live registers
            float4 f[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              f[e] = *reinterpret_cast<const float4*>(fs + (hh + e) * (Cfg::kRowBytes / 4));
#pragma unroll
            for (int i = 0; i < 7; ++i) {
              const float2 y = *reinterpret_cast<const float2*>(wyp + i * wy_ld + hh);
              const float ya[2] = {y.x, y.y};
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                s1[i][0] = fmaf(ya[e], f[e].x, s1[i][0]);
                s1[i][1] = fmaf(ya[e], f[e].y, s1[i][1]);
                s1[i][2] = fmaf(ya[e], f[e].z, s1[i][2]);
                s1[i][3] = fmaf(ya[e], f[e].w, s1[i][3]);
              }
            }
          }
        } else {
          // A: wy rows 0..15 of RoI gw at k = h0..h0+15 (matrix l / 8: rows
          // 8 ((l / 8) % 2).., k 8 (l / 16)..)
          uint32_t a0, a1, a2, a3;
          const T* ap = wy + (gw * 16 + lane % 8 + 8 * (lane / 8 % 2)) * wy_ld + h0 + 8 * (lane / 16);
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                       : "r"(smem_addr(ap)));
          // B of column wb + wl: rows h (l % 8 + 8 ((l / 8) % 2)), channels 8 (l / 16)..
          const uint32_t bp = smem_addr(slab) + (lane % 8 + 8 * (lane / 8 % 2)) * Cfg::kRowBytes +
                              (wb * kSepCt + 8 * (lane / 16)) * 2;
#pragma unroll
          for (int wl = 0; wl < 4; ++wl) {
            uint32_t b0, b1, b2, b3;
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                : "r"(bp + wl * kSepCt * 2));
            const uint32_t bb[2][2] = {{b0, b1}, {b2, b3}};
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float (&d)[4] = s1[2 * wl + half];
              asm volatile(
                  "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
                  "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                  : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(bb[half][0]), "r"(bb[half][1]));
            }
          }
        }
      }
      // the chunk's tmp (the last reads of the previous chunk's are behind
      // this chunk's first slab barrier)
      if constexpr (!kBf16) {
#pragma unroll
        for (int i = 0; i < 7; ++i)
          *reinterpret_cast<float4*>(tmp + (g1 * kOut + 7 * ih + i) * kTmpStride + w1 * kSepCt +
                                     c1 * 4) = make_float4(s1[i][0], s1[i][1], s1[i][2], s1[i][3]);
      } else {
        // accumulator e of n-tile (wl, half): bin row lane / 4 + 8 (e / 2),
        // channel 8 half + 2 (lane % 4) + e % 2
        const int gi = lane / 4, ch = 2 * (lane % 4);
#pragma unroll
        for (int wl = 0; wl < 4; ++wl)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* tp = tmp + (gw * kOut + gi) * kTmpStride + (wb + wl) * kSepCt + 8 * half + ch;
            const float(&d)[4] = s1[2 * wl + half];
            *reinterpret_cast<float2*>(tp) = make_float2(d[0], d[1]);
            if (gi + 8 < kOut) *reinterpret_cast<float2*>(tp + 8 * kTmpStride) = make_float2(d[2], d[3]);
          }
      }
      __syncthreads();
      if (s2_on) {
        const int w0 = wc * kSepWc, wn = min(kSepWc, W - w0);
        const float* tp = tmp + (g2 * kOut + i2) * kTmpStride + c2 * 4;
        const float* xp = wx + g2 * kOut * wp + w0;
        // past W both tmp (F zero-filled) and wx are zero
        for (int w = 0; w < wn; w += 4) {
          float4 t[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) t[e] = *reinterpret_cast<const float4*>(tp + (w + e) * kSepCt);
#pragma unroll
          for (int j = 0; j < kOut; ++j) {
            const float4 x = *reinterpret_cast<const float4*>(xp + j * wp + w);
            const float xa[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[j][0] = fmaf(xa[e], t[e].x, o[j][0]);
              o[j][1] = fmaf(xa[e], t[e].y, o[j][1]);
              o[j][2] = fmaf(xa[e], t[e].z, o[j][2]);
              o[j][3] = fmaf(xa[e], t[e].w, o[j][3]);
            }
          }
        }
      }
    }
    if (s2_on && r0 + g2 < R) {
      T* dst = out + (((size_t)b * R + r0 + g2) * kOut + i2) * kOut * C + c0 + c2 * 4;
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        if constexpr (kBf16) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(o[j][0], o[j][1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(o[j][2], o[j][3]);
          __stcs(reinterpret_cast<uint2*>(dst + (size_t)j * C),
                 make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi)));
        } else {
          __stcs(reinterpret_cast<float4*>(dst + (size_t)j * C),
                 make_float4(o[j][0], o[j][1], o[j][2], o[j][3]));
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ------------------------------------------- T-roi 2, 3: the G @ F GEMM
constexpr int kRows = kOut * kOut;  // output rows (i, j) of one RoI
constexpr int kTileM = 128;         // stacked rows per tile: at most two RoIs
// table strides: a warp's rows (8 bins j of one or two bin rows i) read ty
// rows as broadcasts and tx rows 8 words apart, few bank conflicts
constexpr int kTyStride = kMaxAxis + 4, kTxStride = kMaxAxis + 8;

// The two RoIs a tile of stacked rows can touch (slot 0: the RoI of its
// first row, slot 1: the next one, clamped to R - 1): their pooled axis
// tables (1/s^2 not folded in) and their constg constants.
struct Slots {
  float ty[2][kOut][kTyStride];      // [slot][i][y]
  float tx[2][kOut][kTxStride];      // [slot][j][x]
  Tap taps[2][2][kOut * kMaxRatio];  // [slot][axis][i * s + a]
  float cval[2];                     // bf(x0 * 1e-6), widened
};

// Fill `sl` for RoIs r0 and r0 + 1 of image b with bin_weight's arithmetic:
// each (bin, sample) tap once, then each entry sums its bin's taps in
// sample order. Entries y < fill_h and x < fill_w are written (0 past H or
// W). `n` threads run it and meet at `sync()`, which also ends it.
template <typename T, bool kConst, typename Sync>
__device__ void fill_slots(Slots& sl, const float* boxes, int b, int r0, int R, int H, int W,
                           int s, int fill_h, int fill_w, int tid, int n, Sync sync) {
  if (kConst) {
    if (tid < 2) {
      const float* bx = boxes + 4 * ((size_t)b * R + min(r0 + tid, R - 1));
      sl.cval[tid] = Io<T>::round(__fmul_rn(bx[0], 1e-6f));
    }
    sync();
    return;
  }
  const int per_axis = kOut * s;
  for (int e = tid; e < 4 * per_axis; e += n) {
    const int slot = e / (2 * per_axis), axis = e / per_axis % 2, k = e % per_axis;
    const Box bx = read_box(boxes + 4 * ((size_t)b * R + min(r0 + slot, R - 1)));
    sl.taps[slot][axis][k] = axis == 0 ? bilinear_1d(sample_coord(bx.y0, bx.bh, k, s), H)
                                       : bilinear_1d(sample_coord(bx.x0, bx.bw, k, s), W);
  }
  sync();
  const int ny = 2 * kOut * fill_h;
  for (int e = tid; e < ny + 2 * kOut * fill_w; e += n) {
    const bool is_y = e < ny;
    const int f = is_y ? e : e - ny, fill = is_y ? fill_h : fill_w;
    const int slot = f / (kOut * fill), i = f / fill % kOut, y = f % fill;
    const Tap* tp = sl.taps[slot][is_y ? 0 : 1] + i * s;
    float acc = 0.f;
    if (y < (is_y ? H : W))
      for (int a = 0; a < s; ++a) {
        const Tap t = tp[a];
        acc = __fadd_rn(acc, __fadd_rn(y == t.i0 ? t.w0 : 0.f, y == t.i1 ? t.w1 : 0.f));
      }
    if (is_y)
      sl.ty[slot][i][y] = acc;
    else
      sl.tx[slot][i][y] = acc;
  }
  sync();
}

// Row m of a tile starting at stacked row m0 (first RoI r0): its offsets
// into the flattened ty and tx tables of `Slots`, and its slot.
struct RowAt {
  int ty, tx, slot;
  __device__ RowAt(int m, int r0) {
    const int roi = m / kRows, rem = m - roi * kRows;
    slot = min(roi - r0, 1);
    ty = (slot * kOut + rem / kOut) * kTyStride;
    tx = (slot * kOut + rem % kOut) * kTxStride;
  }
};


// ---- f32 maps: SIMT, true f32 FMAs
constexpr int kF32Threads = 256;
constexpr int kF32K = 16;       // K per chunk
constexpr int kF32Stages = 3;   // cp.async ring of F chunks

struct F32Shared {
  float fs[kF32Stages][kF32K][kTileM];  // F chunk, [k][channel]
  float gs[2][kF32K][kTileM];           // G chunk, [k][row]
  Slots sl;
};

// One block per (128 channels, 128 stacked rows, image). Thread (ty_, tx_)
// of 16 x 16 owns rows {0, 64} + 4 ty_ .. +3 and channels {0, 64} + 4 tx_
// .. +3 (8 x 8 outputs). A K chunk is a 2 x 8 (y, x) block of the map (as
// bf16's stages, so G's columns need no division). Each chunk: F's 16 x
// 128 slab arrives by cp.async S - 1 chunks ahead (zeros past H, W); G's
// 128 x 16 tile for the next chunk is formed into the other G buffer
// (thread: row tid % 128, columns tid / 128 + 2 q, from 2 ty and 4 tx
// values), then each thread reads 2 float4 of G and 2 of F per k for 64
// FMAs.
template <bool kConst>
__global__ void __launch_bounds__(kF32Threads, 2)
roi_gemm_f32_kernel(const float* __restrict__ feat, const float* __restrict__ boxes,
                    float* __restrict__ out, int R, int H, int W, int C, int s) {
  extern __shared__ __align__(16) uint8_t smem_f32[];
  F32Shared& sm = *reinterpret_cast<F32Shared*>(smem_f32);
  const int tid = threadIdx.x, b = blockIdx.z;
  const int M = R * kRows, m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileM;
  const int r0 = m0 / kRows;
  // a chunk is a (2 y) x (8 x) block of the map, k_local = 8 yl + xl
  const int x_blocks = (W + 7) / 8, chunks = (H + 1) / 2 * x_blocks;
  fill_slots<float, kConst>(sm.sl, boxes, b, r0, R, H, W, s, (H + 1) / 2 * 2, x_blocks * 8, tid,
                            kF32Threads, [] { __syncthreads(); });
  const float inv_s2 = __fdiv_rn(1.f, (float)(s * s));
  // this thread's row of G, and its columns g_col + 2 q of each chunk
  const int g_row = tid % kTileM, g_col = tid / kTileM;
  const RowAt ra(m0 + g_row, r0);
  const float* ty = &sm.sl.ty[0][0][0] + ra.ty;
  const float* tx = &sm.sl.tx[0][0][0] + ra.tx;
  const float cval = sm.sl.cval[kConst ? ra.slot : 0];
  const float* img = feat + (size_t)b * H * W * C + n0;

  auto load_f = [&](int c) {
    if (c < chunks) {
      const int cy = c / x_blocks * 2, cx = c % x_blocks * 8;
#pragma unroll
      for (int i = 0; i < kF32K * kTileM / 4 / kF32Threads; ++i) {
        const int e = tid + i * kF32Threads, kk = e / (kTileM / 4), n4 = e % (kTileM / 4);
        const int y = cy + kk / 8, x = cx + kk % 8;
        const bool in = y < H && x < W;
        cp_async16(&sm.fs[c % kF32Stages][kk][n4 * 4], img + (size_t)(in ? y * W + x : 0) * C + n4 * 4,
                   in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);  // empty past the end: the count stays true
  };
  // G past H or W multiplies the zeros copied there, so any finite value does
  // (all loads first: the stores to gs could alias them as far as the
  // compiler knows, and would serialize them)
  auto form_g = [&](int c) {
    float v[kF32K / 2];
    if (kConst) {
#pragma unroll
      for (int q = 0; q < kF32K / 2; ++q) v[q] = cval;
    } else {
      const int cy = c / x_blocks * 2, cx = c % x_blocks * 8;
      const float y0 = ty[cy], y1 = ty[cy + 1];
      float xs[4];  // columns g_col + 2 q and g_col + 2 q + 8 share x
#pragma unroll
      for (int q = 0; q < 4; ++q) xs[q] = tx[cx + g_col + 2 * q];
#pragma unroll
      for (int q = 0; q < kF32K / 2; ++q)
        v[q] = __fmul_rn(__fmul_rn(q < 4 ? y0 : y1, xs[q % 4]), inv_s2);
    }
#pragma unroll
    for (int q = 0; q < kF32K / 2; ++q) sm.gs[c & 1][g_col + 2 * q][g_row] = v[q];
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
  const int ty_ = tid / 16, tx_ = tid % 16;
  for (int c = 0; c < kF32Stages - 1; ++c) load_f(c);
  form_g(0);
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kF32Stages - 2));
    __syncthreads();  // chunk c's F and G in place; every thread is past chunk c - 1
    load_f(c + kF32Stages - 1);
    if (c + 1 < chunks) form_g(c + 1);
    const float(*fs)[kTileM] = sm.fs[c % kF32Stages];
    const float(*gs)[kTileM] = sm.gs[c & 1];
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      const float4 g0 = *reinterpret_cast<const float4*>(&gs[kk][ty_ * 4]);
      const float4 g1 = *reinterpret_cast<const float4*>(&gs[kk][64 + ty_ * 4]);
      const float4 f0 = *reinterpret_cast<const float4*>(&fs[kk][tx_ * 4]);
      const float4 f1 = *reinterpret_cast<const float4*>(&fs[kk][64 + tx_ * 4]);
      const float ga[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float fa[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] = fmaf(ga[a], fa[e], acc[a][e]);
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int m = m0 + (a / 4) * 64 + ty_ * 4 + a % 4;
    if (m >= M) continue;
    float* dst = out + ((size_t)b * M + m) * C + n0;
    *reinterpret_cast<float4*>(dst + tx_ * 4) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    *reinterpret_cast<float4*>(dst + 64 + tx_ * 4) =
        make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
  }
}

// ---- bf16 maps: wgmma fed by TMA, A formed in registers
constexpr int kBN = 256;                          // channels per tile
constexpr int kBK = 64;                           // K per stage: an 8 x 8 (y, x) block
constexpr int kStages = 4;
constexpr int kBoxBytes = kBK * 64 * 2;           // one TMA box: 64 k x 64 channels
constexpr int kStageBytes = kBoxBytes * (kBN / 64);
constexpr int kBf16Threads = 384;                 // 2 consumer warpgroups + 1 producer
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

struct Bf16Shared {
  Slots sl;
  uint64_t full[kStages], empty[kStages];
};
constexpr int kBf16Smem = kStages * kStageBytes + (int)sizeof(Bf16Shared) + 1024;

// the box of (channel c, x, y, image b) of the (C, W, H, B) map into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(x), "r"(y), "r"(b), "r"(smem_addr(bar))
      : "memory");
}

// B descriptor of a stage: F's slab, channels contiguous (MN-major), 128-byte
// swizzle; the 8-row k groups 1024 bytes apart (SBO), the 64-channel boxes
// kBoxBytes apart (LBO).
__device__ __forceinline__ uint64_t stage_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kBoxBytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 256, f32) += A (64 x 16 bf16, registers) * B (16 x 256 bf16,
// shared memory, MN-major); D is zeroed first when scale_d is 0.
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the accumulators are not read or written across this point
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bf16 pair (lo, hi) of G = bf((ty * tx) / s^2), lo in the low half
__device__ __forceinline__ uint32_t g_pair(float y, float2 x, float inv_s2) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(y, x.x), inv_s2),
                                                 __fmul_rn(__fmul_rn(y, x.y), inv_s2));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// lane t of a quad holds row t of a 4 x 4 block of words; afterwards it
// holds column t (two butterfly stages of shuffles)
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool hi = t & 2, odd = t & 1;
  uint32_t s0 = hi ? v[0] : v[2], s1 = hi ? v[1] : v[3];
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi) {
    v[0] = s0;
    v[1] = s1;
  } else {
    v[2] = s0;
    v[3] = s1;
  }
  uint32_t u0 = odd ? v[0] : v[1], u1 = odd ? v[2] : v[3];
  u0 = __shfl_xor_sync(0xffffffffu, u0, 1);
  u1 = __shfl_xor_sync(0xffffffffu, u1, 1);
  if (odd) {
    v[0] = u0;
    v[2] = u1;
  } else {
    v[1] = u0;
    v[3] = u1;
  }
}

// Persistent: block i walks tiles [i T / grid, (i + 1) T / grid) of the T =
// B x ceil(M / 128) x ceil(C / 256) tiles, channels fastest, so the axis
// tables are built once per 128 stacked rows. Warpgroups 0 and 1 consume
// (rows 64 w .. +63 of the tile, all 256 channels, 128 f32 accumulators a
// thread); thread 256 produces: for each tile, for each 8 x 8 (y, x) block
// of the map (y outer), it waits for a free stage and loads 64 k x 256
// channels as four 64-channel TMA boxes (zero past W, H; none past C).
// Stage row k_local = 8 yl + xl, so the k16 step j of a stage covers map
// rows yl = 2j, 2j + 1 and x 0..7: a thread's A fragment of step j (rows g
// and g + 8 of its warp, columns 2t, 2t + 1 and 2t + 8, 2t + 9) is its two
// rows' ty at y = 2j, 2j + 1 times their tx at x = 2t, 2t + 1.
template <bool kConst, typename OutT>
__global__ void __launch_bounds__(kBf16Threads, 1)
roi_gemm_bf16_kernel(const __grid_constant__ CUtensorMap fmap, const float* __restrict__ boxes,
                     OutT* __restrict__ out, int R, int H, int W, int C, int s, int tiles) {
  extern __shared__ __align__(16) uint8_t smem_bf16[];
  uint8_t* ring = smem_bf16 + ((1024 - (smem_addr(smem_bf16) & 1023)) & 1023);
  Bf16Shared& sm = *reinterpret_cast<Bf16Shared*>(ring + kStages * kStageBytes);
  const int M = R * kRows;
  const int m_tiles = (M + kTileM - 1) / kTileM, n_tiles = (C + kBN - 1) / kBN;
  const int t_begin = (int)((long long)blockIdx.x * tiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = t_begin; tile < t_end; ++tile) {
        const int n0 = tile % n_tiles * kBN, b = tile / n_tiles / m_tiles;
        const int boxes_n = min(kBN, C - n0) / 64;
        for (int cy = 0; cy < H; cy += 8)
          for (int cx = 0; cx < W; cx += 8) {
            mbar_wait(&sm.empty[stage], phase ^ 1);
            mbar_expect_tx(&sm.full[stage], boxes_n * kBoxBytes);
            for (int i = 0; i < boxes_n; ++i)
              tma_load(ring + stage * kStageBytes + i * kBoxBytes, &fmap, &sm.full[stage],
                       n0 + 64 * i, cx, cy, b);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row = 64 * (warp / 4) + 16 * (warp % 4) + g;  // and row + 8
  const float inv_s2 = __fdiv_rn(1.f, (float)(s * s));
  const float* tyf = &sm.sl.ty[0][0][0];
  const float* txf = &sm.sl.tx[0][0][0];
  const uint32_t ring_addr = smem_addr(ring);
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int tables_of = -1, ty_off[2] = {0, 0}, tx_off[2] = {0, 0};
  uint32_t const_a[2] = {0, 0};
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int nt = tile % n_tiles, rest = tile / n_tiles;
    const int b = rest / m_tiles, m0 = rest % m_tiles * kTileM, r0 = m0 / kRows;
    if (rest != tables_of) {
      tables_of = rest;
      auto sync = [] { asm volatile("bar.sync 1, 256;\n" ::: "memory"); };
      sync();  // every consumer is past the last tile's table reads
      fill_slots<__nv_bfloat16, kConst>(sm.sl, boxes, b, r0, R, H, W, s, (H + 7) / 8 * 8,
                                        (W + 7) / 8 * 8, threadIdx.x, 256, sync);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const RowAt ra(m0 + row + 8 * h, r0);
        ty_off[h] = ra.ty;
        tx_off[h] = ra.tx + 2 * t;
        const float c = sm.sl.cval[kConst ? ra.slot : 0];
        const __nv_bfloat162 v = __floats2bfloat162_rn(c, c);
        const_a[h] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
    // One chunk: form its A fragments (from the tables alone, before its
    // stage arrives), issue its four k16 steps and wait for them, then free
    // the stage. No product of this warpgroup is in flight while `a` is
    // written: the compiler may place `a` in any registers, and a wgmma
    // reads its A registers until it completes. The other warpgroup's
    // products keep the tensor cores busy meanwhile.
    int q = 0;
    for (int cy = 0; cy < H; cy += 8)
      for (int cx = 0; cx < W; cx += 8, ++q) {
        uint32_t a[4][4];
        if (kConst) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j][0] = a[j][2] = const_a[0];
            a[j][1] = a[j][3] = const_a[1];
          }
        } else {
          const float4 y0 = *reinterpret_cast<const float4*>(tyf + ty_off[0] + cy);
          const float4 y1 = *reinterpret_cast<const float4*>(tyf + ty_off[0] + cy + 4);
          const float4 y2 = *reinterpret_cast<const float4*>(tyf + ty_off[1] + cy);
          const float4 y3 = *reinterpret_cast<const float4*>(tyf + ty_off[1] + cy + 4);
          const float2 xa = *reinterpret_cast<const float2*>(txf + tx_off[0] + cx);
          const float2 xb = *reinterpret_cast<const float2*>(txf + tx_off[1] + cx);
          const float ya[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
          const float yb[8] = {y2.x, y2.y, y2.z, y2.w, y3.x, y3.y, y3.z, y3.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[j][0] = g_pair(ya[2 * j], xa, inv_s2);
            a[j][1] = g_pair(yb[2 * j], xb, inv_s2);
            a[j][2] = g_pair(ya[2 * j + 1], xa, inv_s2);
            a[j][3] = g_pair(yb[2 * j + 1], xb, inv_s2);
          }
        }
        mbar_wait(&sm.full[stage], phase);
        wgmma_fence();
        const uint64_t desc = stage_desc(ring_addr + stage * kStageBytes);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_bf16(acc, a[j], desc + (uint64_t)((j * 16 * 128) >> 4), (q | j) != 0);
        wgmma_commit();
        wgmma_wait();
        if (lane == 0) mbar_arrive(&sm.empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    fence_acc(acc);

    // acc[4 j + 2 h + e]: row row + 8 h, channel 8 j + 2 t + e of the tile.
    // bf16: the four lanes of a quad exchange values so that each stores 16
    // contiguous bytes, a 4 x 4 transpose giving lane t the 8 channels of
    // block 4 i + t (a quarter of the store instructions of bf16 pairs).
    const int n0 = nt * kBN;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row + 8 * h;
      OutT* dst = out + ((size_t)b * M + m) * C + n0;
      if constexpr (sizeof(OutT) == 2) {
#pragma unroll
        for (int i = 0; i < kBN / 32; ++i) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const __nv_bfloat162 pr =
                __floats2bfloat162_rn(acc[4 * (4 * i + k) + 2 * h], acc[4 * (4 * i + k) + 2 * h + 1]);
            v[k] = *reinterpret_cast<const uint32_t*>(&pr);
          }
          quad_transpose(v, t);
          const int j = 4 * i + t;
          if (m < M && n0 + 8 * j < C)
            *reinterpret_cast<uint4*>(dst + 8 * j) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      } else {  // f32: a pair of channels a lane (a swap to 16 bytes measured no faster)
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          if (m < M && n0 + 8 * j < C)
            *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

bool bad_shape(int B, int R, int H, int W, int C, int out_size, int s) {
  return B <= 0 || R <= 0 || H <= 0 || W <= 0 || C <= 0 || H > kMaxAxis ||
         W > kMaxAxis || out_size != kOut || s <= 0 || s > kMaxRatio;
}

template <bool kConst>
int launch_gemm_f32(const float* feat, const float* boxes, float* out, int B, int R, int H, int W,
                    int C, int s, cudaStream_t st) {
  const int smem = (int)sizeof(F32Shared);
  const cudaError_t attr = cudaFuncSetAttribute(
      roi_gemm_f32_kernel<kConst>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)(C / kTileM), (unsigned)((R * kRows + kTileM - 1) / kTileM),
                  (unsigned)B);
  roi_gemm_f32_kernel<kConst><<<grid, kF32Threads, smem, st>>>(feat, boxes, out, R, H, W, C, s);
  return (int)cudaGetLastError();
}


template <bool kConst, typename OutT>
int launch_gemm_bf16(const void* feat, const float* boxes, OutT* out, int B, int R, int H, int W,
                     int C, int s, cudaStream_t st) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  // the map as (C, W, H, B), channels innermost; boxes of 64 channels x 8 x 8
  CUtensorMap fmap;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, 8, 8, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&fmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(feat), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const auto kernel = roi_gemm_bf16_kernel<kConst, OutT>;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  // setmaxnreg only moves registers the block already holds: with fewer,
  // the consumers' increase would wait forever
  if (fa.numRegs * kBf16Threads < 128 * kProducerRegs + 256 * kConsumerRegs)
    return (int)cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16Smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const long long tiles = (long long)B * ((R * kRows + kTileM - 1) / kTileM) * ((C + kBN - 1) / kBN);
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kernel<<<grid, kBf16Threads, kBf16Smem, st>>>(fmap, boxes, out, R, H, W, C, s, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched). Preconditions, checked by the Python
// wrappers (ops/roi_probes.py): feat (B, H, W, C) f32 or bf16 (bf16 != 0)
// and boxes (B, R, 4) f32, contiguous, on one device, 16-byte aligned;
// out (B, R, 14, 14, C) in the dtype each entry writes.

// T-roi 1: out in the map's dtype; C % 32 == 0, W <= 112 (the wrapper's
// contract since the first version, whose intermediate grew with W).
extern "C" int tspn_roi_sep_fused_launch(const void* feat, const void* boxes, void* out,
                                         int B, int R, int H, int W, int C, int out_size,
                                         int s, int bf16, void* stream) {
  if (bad_shape(B, R, H, W, C, out_size, s) || C % 32 || W > 112) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  // channel-tile shares: about four waves of one block per SM, each block
  // building its RoIs' tables once
  const int groups = B * ((R + kSepG - 1) / kSepG), n_ct = C / kSepCt;
  const int shares = max(1, min(n_ct, (4 * sms + groups - 1) / groups));
  const dim3 grid((unsigned)shares, (unsigned)((R + kSepG - 1) / kSepG), (unsigned)B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const int smem = sep_smem_bytes<__nv_bfloat16>(H, W);
    e = cudaFuncSetAttribute(roi_sep_fused_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    roi_sep_fused_kernel<__nv_bfloat16><<<grid, kSepThreads, smem, st>>>(
        (const __nv_bfloat16*)feat, (const float*)boxes, (__nv_bfloat16*)out, R, H, W, C, s);
  } else {
    const int smem = sep_smem_bytes<float>(H, W);
    e = cudaFuncSetAttribute(roi_sep_fused_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    roi_sep_fused_kernel<float><<<grid, kSepThreads, smem, st>>>(
        (const float*)feat, (const float*)boxes, (float*)out, R, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

// T-roi 2 (const_g 0, out in the map's dtype) and T-roi 3 (const_g 1, out
// f32); C % 128 == 0.
extern "C" int tspn_roi_gemm_launch(const void* feat, const void* boxes, void* out, int B,
                                    int R, int H, int W, int C, int out_size, int s, int bf16,
                                    int const_g, void* stream) {
  if (bad_shape(B, R, H, W, C, out_size, s) || C % kTileM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  if (!bf16) {
    const float* f = static_cast<const float*>(feat);
    float* o = static_cast<float*>(out);
    return const_g ? launch_gemm_f32<true>(f, bx, o, B, R, H, W, C, s, st)
                   : launch_gemm_f32<false>(f, bx, o, B, R, H, W, C, s, st);
  }
  return const_g ? launch_gemm_bf16<true>(feat, bx, static_cast<float*>(out), B, R, H, W, C, s, st)
                 : launch_gemm_bf16<false>(feat, bx, static_cast<__nv_bfloat16*>(out), B, R, H, W,
                                           C, s, st);
}
