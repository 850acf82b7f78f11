// RoIAlign (K7) for sm_90a: direct bilinear sampling over channels-last
// feature maps, every image's RoIs in one launch; f32 or bf16 maps, and the
// backward into the feature map. The levels form pools each RoI from the
// map of its own level of a feature pyramid (up to four maps), all levels'
// RoIs in one launch, forward and backward.
//
// Replaces tspn_tpu/ops/roi_align.py::roi_align_pallas (_kernel_roi),
// which builds one pooled interpolation matrix G (out^2, H*W) per RoI and
// multiplies it with the feature map on the TPU's matrix unit. Here the
// function is computed directly: each output element is the s x s mean of
// bilinear samples, with torchvision's aligned=True border rules (see
// ops/roi_align.py). No G, no GEMM.
//
// Forward. Layout: features (N, H, W, C) channels-last in f32 or bf16,
// boxes (R, 4) xyxy in feature coordinates (f32), batch_idx (R,) int32,
// out (R, out, out, C) in the map's type. One block per (RoI, output row
// i); its threads span the channels, VEC contiguous elements each (16-byte
// accesses: 4 in f32, 8 in bf16; 4 or 1 where C or the map's alignment
// does not allow it), so every load of a C row is coalesced and every store
// a coalesced write. The block's sample coordinates (out*s along x, s along
// y) are computed once into shared memory. Each sample row's columns are
// interpolated once, in a two-column window that the row's x-samples walk
// (roi_align_kernel): at the detector's RoIs (0.25 to 30 pixels wide on a
// 40-wide map) that is 3 to 5 times fewer loads than 4 taps a sample.
//
// Bound: bytes. At the detector's geometry (8 images x 40x40x1024,
// 2048 RoIs, out 14, s 2) the output alone is 1.64 GB in f32 (0.82 GB in
// bf16) against 52 MB of features, about 40 FLOP per output element, so
// the kernel streams its output with evict-first stores (__stcs) and
// leaves L2 to the features. Instruction issue, not bytes, holds it: four
// separately rounded float operations a sample and channel keep it
// bit-equal to the plain version.
//
// Arithmetic mirrors the plain version (roi_align_plain) op for op, with
// round-to-nearest intrinsics so that nvcc contracts nothing into FMAs:
// coordinates lo + ((k + .5) / s) * (extent / out); rows first
// (f[y0] * wy0 + f[y1] * wy1, the plain version's row over whole columns),
// then columns (row[x0] * wx0 + row[x1] * wx1), then the mean of the s x s
// samples in the plain mean's order (below): the f32 output equals the plain
// one bit for bit. A bf16 map is widened exactly to f32
// as it is read and the output is rounded to bf16 once (RNE), so the bf16
// half equals roi_align_plain(features.float()).to(bfloat16). The TPU
// kernel instead rounds each entry of G to bf16 before an f32-accumulated
// dot: another rounding of the same function.
//
// Backward. dOut (R, out, out, C) in f32 or bf16 (widened as read) ->
// dF (N, H, W, C) f32, zeroed by the caller; the caller rounds dF to bf16
// once for a bf16 map. dF[y, x] = sum over the RoI's bins (i, j) of
// WY_i(y) WX_j(x) dOut[i, j] / s^2, where WY_i (WX_j) sums the bilinear
// weights of bin i's (j's) s samples that land on row y (column x). The
// block of (RoI, row i) keeps WY_i as a list of at most 2s distinct rows
// and walks the row's out * s x-samples in order: their columns never
// decrease, so a two-column window in registers sums every tap that lands
// on one column (over all bins j of the row) before that column leaves the
// window, and then adds it into dF once per distinct row with one atomicAdd
// per channel. A naive scatter issues s^2 * 4 = 16 atomics per output
// element; this issues |rows of bin row i| x |columns of the RoI|
// per (RoI, i), about 3 x 15 against 16 x 14 for a 10-pixel-wide RoI at
// out 14, s 2. The atomics are the bound (and make the sum order
// nondeterministic): reading dOut once and writing dF once is far less
// time.
//
// Levels (roi_align_levels_kernel, roi_align_levels_backward_kernel; f32).
// The FPN's box head pools RoI r from map level[r] of up to four maps of
// one channel count, each with its own size and scale (1 / its stride, a
// power of two, so the scaled box is exact): the block reads its RoI's
// level, scales the box and runs the single-map block's arithmetic on that
// map (pool_row, and backward scatter_row on that level's dF: the bodies of
// roi_align_kernel and roi_align_backward_kernel with the frame, the image
// and the map as arguments; those two kernels keep their own copies). The
// caller computes the levels on the device (ops/roi_align.py): per-level
// launches would need each level's RoI count on the host, and pooling
// every RoI at every level four times the work. A level outside [0, levels) pools nothing, as an
// image outside [0, N) does. Same arithmetic, so the forward equals the
// plain per-level version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSamples = 128;  // out * s along one axis
constexpr int kMaxRatio = 16;     // s

struct Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Tap bilinear_1d(float coord, int size) {
  Tap t{0, 0, 0.f, 0.f};
  if (!(coord >= -1.f && coord <= (float)size)) return t;  // zero weight
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

__device__ __forceinline__ float sample_coord(float lo, float extent, int k, int out, int s) {
  const float grid = __fdiv_rn(__fadd_rn((float)k, 0.5f), (float)s);
  return __fadd_rn(lo, __fmul_rn(grid, __fdiv_rn(extent, (float)out)));
}

// The box's sampling frame: x0, y0 (shifted by -0.5), width, height.
struct Frame {
  float x0, y0, bw, bh;
};

__device__ __forceinline__ Frame box_frame(const float* boxes, int r) {
  const float bx0 = boxes[4 * r + 0], by0 = boxes[4 * r + 1];
  const float bx1 = boxes[4 * r + 2], by1 = boxes[4 * r + 3];
  return {__fsub_rn(bx0, 0.5f), __fsub_rn(by0, 0.5f), fmaxf(__fsub_rn(bx1, bx0), 1e-6f),
          fmaxf(__fsub_rn(by1, by0), 1e-6f)};
}

// VEC consecutive channels of a T row <-> floats. bf16 widens exactly
// (the bits shifted into the high half) and rounds once by RNE.
template <typename T, int VEC>
struct IO;

template <>
struct IO<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct IO<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { __stcs(p, v[0]); }
};

__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <>
struct IO<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(q.x);
    v[1] = bf16_hi(q.x);
    v[2] = bf16_lo(q.y);
    v[3] = bf16_hi(q.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                      bf16_bits(v[2]) | (bf16_bits(v[3]) << 16)));
  }
};

template <>
struct IO<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = bf16_lo(u[k]);
      v[2 * k + 1] = bf16_hi(u[k]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    __stcs(reinterpret_cast<uint4*>(p),
           make_uint4(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                      bf16_bits(v[2]) | (bf16_bits(v[3]) << 16),
                      bf16_bits(v[4]) | (bf16_bits(v[5]) << 16),
                      bf16_bits(v[6]) | (bf16_bits(v[7]) << 16)));
  }
};

template <>
struct IO<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = bf16_lo((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    __stcs(reinterpret_cast<unsigned short*>(p), (unsigned short)bf16_bits(v[0]));
  }
};

// Forward. Each output element is the mean over its bin's s x s samples of
// col(x0) wx0 + col(x1) wx1, where col(x) = f[y0][x] wy0 + f[y1][x] wy1 is
// the sample row's value at column x: every sample of a row that touches
// column x uses the same col(x). So the block walks each sample row's
// x-samples in order with a two-column window (columns a and a + 1) and
// interpolates a column only when the window first reaches it; the samples'
// columns never decrease, except at taps off the map (index 0, weight 0),
// where the window restarts, as it does at each group of bins. The bins'
// sums stay in registers, Walk<VEC, kParts>::kBins bins at a time (a design
// probe timed 7 in f32 and 4 in bf16 fastest, at 128 threads a block).
//
// The sum's order is the plain version's: its mean over the s x s samples
// (PyTorch's reduction) adds sample m = ky s + kx into partial sum m % 4 and
// then adds the four partial sums in order, so with s <= 2 the samples add
// in (ky, kx) order and with s > 2 into kParts = 4 partial sums. The mean
// multiplies by 1 / s^2, as PyTorch's does (a division costs more
// instructions than the rest of an output element).
template <int VEC, int kParts>
struct Walk {
  static constexpr int kBins = kParts > 1 ? 2 : VEC == 8 ? 4 : VEC == 4 ? 7 : 14;
};

template <typename T, int VEC>
__device__ __forceinline__ void interpolate_column(const T* row0, const T* row1, int x, int c,
                                                   const Tap& ty, float (&col)[VEC]) {
  float f0[VEC], f1[VEC];
  IO<T, VEC>::load(row0 + (size_t)x * c, f0);
  IO<T, VEC>::load(row1 + (size_t)x * c, f1);
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    col[e] = __fadd_rn(__fmul_rn(f0[e], ty.w0), __fmul_rn(f1[e], ty.w1));
}

// One block's output row i of RoI r, framed by f, from image b of a map
// (N, h, w, c); xs and ys are the block's shared sample taps. The body of
// roi_align_kernel (below) for the levels kernel.
template <typename T, int VEC, int kParts>
__device__ __forceinline__ void pool_row(const T* __restrict__ feat, const Frame& f, int b,
                                         T* __restrict__ out, int r, int i, int n_img, int h,
                                         int w, int c, int out_size, int s, Tap* xs, Tap* ys) {
  const int n = out_size * s;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = bilinear_1d(sample_coord(f.x0, f.bw, k, out_size, s), w);
  for (int k = threadIdx.x; k < s; k += blockDim.x)
    ys[k] = bilinear_1d(sample_coord(f.y0, f.bh, i * s + k, out_size, s), h);
  __syncthreads();

  const int cv = c / VEC;  // vectors per channel row
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= cv) return;
  const int ch = v * VEC;
  T* dst = out + ((size_t)r * out_size + i) * out_size * c + ch;
  if (b < 0 || b >= n_img) {  // no such image: the RoI pools nothing
    const float zero[VEC] = {};
    for (int j = 0; j < out_size; ++j) IO<T, VEC>::store(dst + (size_t)j * c, zero);
    return;
  }
  const T* img = feat + (size_t)b * h * w * c + ch;
  const float inv = 1.f / (float)(s * s);
  constexpr int kBins = Walk<VEC, kParts>::kBins;

  for (int j0 = 0; j0 < out_size; j0 += kBins) {
    float acc[kBins][kParts][VEC] = {};
    for (int ky = 0; ky < s; ++ky) {
      const Tap ty = ys[ky];
      const T* row0 = img + (size_t)ty.i0 * w * c;
      const T* row1 = img + (size_t)ty.i1 * w * c;
      int a = -2;  // the window: col(a) in ca, col(a + 1) in cb where a + 1 < w
      float ca[VEC] = {}, cb[VEC] = {};
#pragma unroll
      for (int jj = 0; jj < kBins; ++jj) {
        if (j0 + jj >= out_size) break;
        for (int kx = 0; kx < s; ++kx) {
          const Tap tx = xs[(j0 + jj) * s + kx];
          if (tx.i0 != a) {
            if (tx.i0 == a + 1) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) ca[e] = cb[e];
            } else {
              interpolate_column<T, VEC>(row0, row1, tx.i0, c, ty, ca);
            }
            a = tx.i0;
            if (a + 1 < w) interpolate_column<T, VEC>(row0, row1, a + 1, c, ty, cb);
          }
          // i1 is a + 1, or a itself at the last column and off the map
          const bool same = tx.i1 == a;
          const int part = (ky * s + kx) % kParts;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float c1 = same ? ca[e] : cb[e];
            const float smp = __fadd_rn(__fmul_rn(ca[e], tx.w0), __fmul_rn(c1, tx.w1));
#pragma unroll
            for (int q = 0; q < kParts; ++q)
              if (q == part) acc[jj][q][e] = __fadd_rn(acc[jj][q][e], smp);
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) {
      if (j0 + jj >= out_size) break;
      float mean[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float sum = acc[jj][0][e];
#pragma unroll
        for (int q = 1; q < kParts; ++q) sum = __fadd_rn(sum, acc[jj][q][e]);
        mean[e] = __fmul_rn(sum, inv);
      }
      IO<T, VEC>::store(dst + (size_t)(j0 + jj) * c, mean);
    }
  }
}

template <typename T, int VEC, int kParts>
__global__ void roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ boxes,
                                 const int* __restrict__ batch_idx, T* __restrict__ out,
                                 int n_img, int h, int w, int c, int out_size, int s) {
  __shared__ Tap xs[kMaxSamples];
  __shared__ Tap ys[kMaxRatio];

  const int r = blockIdx.x / out_size;
  const int i = blockIdx.x % out_size;
  const Frame f = box_frame(boxes, r);
  const int n = out_size * s;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = bilinear_1d(sample_coord(f.x0, f.bw, k, out_size, s), w);
  for (int k = threadIdx.x; k < s; k += blockDim.x)
    ys[k] = bilinear_1d(sample_coord(f.y0, f.bh, i * s + k, out_size, s), h);
  __syncthreads();

  const int cv = c / VEC;  // vectors per channel row
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= cv) return;
  const int ch = v * VEC;
  T* dst = out + ((size_t)r * out_size + i) * out_size * c + ch;
  const int b = batch_idx[r];
  if (b < 0 || b >= n_img) {  // no such image: the RoI pools nothing
    const float zero[VEC] = {};
    for (int j = 0; j < out_size; ++j) IO<T, VEC>::store(dst + (size_t)j * c, zero);
    return;
  }
  const T* img = feat + (size_t)b * h * w * c + ch;
  const float inv = 1.f / (float)(s * s);
  constexpr int kBins = Walk<VEC, kParts>::kBins;

  for (int j0 = 0; j0 < out_size; j0 += kBins) {
    float acc[kBins][kParts][VEC] = {};
    for (int ky = 0; ky < s; ++ky) {
      const Tap ty = ys[ky];
      const T* row0 = img + (size_t)ty.i0 * w * c;
      const T* row1 = img + (size_t)ty.i1 * w * c;
      int a = -2;  // the window: col(a) in ca, col(a + 1) in cb where a + 1 < w
      float ca[VEC] = {}, cb[VEC] = {};
#pragma unroll
      for (int jj = 0; jj < kBins; ++jj) {
        if (j0 + jj >= out_size) break;
        for (int kx = 0; kx < s; ++kx) {
          const Tap tx = xs[(j0 + jj) * s + kx];
          if (tx.i0 != a) {
            if (tx.i0 == a + 1) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) ca[e] = cb[e];
            } else {
              interpolate_column<T, VEC>(row0, row1, tx.i0, c, ty, ca);
            }
            a = tx.i0;
            if (a + 1 < w) interpolate_column<T, VEC>(row0, row1, a + 1, c, ty, cb);
          }
          // i1 is a + 1, or a itself at the last column and off the map
          const bool same = tx.i1 == a;
          const int part = (ky * s + kx) % kParts;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float c1 = same ? ca[e] : cb[e];
            const float smp = __fadd_rn(__fmul_rn(ca[e], tx.w0), __fmul_rn(c1, tx.w1));
#pragma unroll
            for (int q = 0; q < kParts; ++q)
              if (q == part) acc[jj][q][e] = __fadd_rn(acc[jj][q][e], smp);
          }
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kBins; ++jj) {
      if (j0 + jj >= out_size) break;
      float mean[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float sum = acc[jj][0][e];
#pragma unroll
        for (int q = 1; q < kParts; ++q) sum = __fadd_rn(sum, acc[jj][q][e]);
        mean[e] = __fmul_rn(sum, inv);
      }
      IO<T, VEC>::store(dst + (size_t)(j0 + jj) * c, mean);
    }
  }
}

// Up to four maps of one channel count: map l is (N, h[l], w[l], c), and
// a box in image coordinates times scale[l] is in its coordinates.
constexpr int kMaxLevels = 4;

template <typename P>
struct Levels {
  P map[kMaxLevels];
  int h[kMaxLevels], w[kMaxLevels];
  float scale[kMaxLevels];
  int n;
};

// The box of RoI r on its level's map (a power-of-two scale: exact).
__device__ __forceinline__ Frame level_frame(const float* boxes, int r, float scale) {
  const float scaled[4] = {__fmul_rn(boxes[4 * r + 0], scale), __fmul_rn(boxes[4 * r + 1], scale),
                           __fmul_rn(boxes[4 * r + 2], scale), __fmul_rn(boxes[4 * r + 3], scale)};
  return box_frame(scaled, 0);
}

template <typename T, int VEC, int kParts>
__global__ void roi_align_levels_kernel(Levels<const T*> lv, const float* __restrict__ boxes,
                                        const int* __restrict__ batch_idx,
                                        const int* __restrict__ level, T* __restrict__ out,
                                        int n_img, int c, int out_size, int s) {
  __shared__ Tap xs[kMaxSamples];
  __shared__ Tap ys[kMaxRatio];
  const int r = blockIdx.x / out_size;
  const int l = min(max(level[r], 0), lv.n - 1);  // an off-range level pools nothing (below)
  const bool on = level[r] == l;
  pool_row<T, VEC, kParts>(lv.map[l], level_frame(boxes, r, lv.scale[l]),
                           on ? batch_idx[r] : -1, out, r, blockIdx.x % out_size, n_img,
                           lv.h[l], lv.w[l], c, out_size, s, xs, ys);
}

// One column's summed taps into dF at each of the bin row's distinct rows.
template <int VEC>
__device__ __forceinline__ void scatter_column(float* img, int x, const float (&a)[VEC],
                                               const int* rows, const float* wts, int m, int w,
                                               int c) {
  for (int e2 = 0; e2 < m; ++e2) {
    float* p = img + ((size_t)rows[e2] * w + x) * c;
    const float wy = wts[e2];
#pragma unroll
    for (int e = 0; e < VEC; ++e) atomicAdd(p + e, __fmul_rn(a[e], wy));
  }
}

// Shared memory of a backward block: the row's x taps and its distinct rows.
struct BackwardShared {
  Tap xs[kMaxSamples];
  int rows[2 * kMaxRatio];
  float wts[2 * kMaxRatio];
  int n_rows;
};

// roi_align_backward_kernel's body for the levels kernel: one block's
// output row i of RoI r, framed by f in image b of a map
// (N, h, w, c): its gradient into dF (the map's shape, f32).
template <typename G, int VEC>
__device__ __forceinline__ void scatter_row(const G* __restrict__ dout, const Frame& f, int b,
                                            float* __restrict__ dfeat, int r, int i, int n_img,
                                            int h, int w, int c, int out_size, int s,
                                            BackwardShared& sh) {
  Tap* xs = sh.xs;
  int* rows = sh.rows;
  float* wts = sh.wts;
  if (b < 0 || b >= n_img) return;  // the RoI pooled nothing: no gradient
  const int n = out_size * s;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = bilinear_1d(sample_coord(f.x0, f.bw, k, out_size, s), w);
  if (threadIdx.x == 0) {
    // WY_i / s^2: the bin row's distinct feature rows, each with the summed
    // weight of the taps of its s samples that land there
    const float count = (float)(s * s);
    int m = 0;
    for (int ky = 0; ky < s; ++ky) {
      const Tap t = bilinear_1d(sample_coord(f.y0, f.bh, i * s + ky, out_size, s), h);
      const int idx[2] = {t.i0, t.i1};
      const float wt[2] = {t.w0, t.w1};
      for (int q = 0; q < 2; ++q) {
        if (wt[q] == 0.f) continue;
        int e = 0;
        while (e < m && rows[e] != idx[q]) ++e;
        if (e == m) {
          rows[m] = idx[q];
          wts[m++] = wt[q];
        } else {
          wts[e] = __fadd_rn(wts[e], wt[q]);
        }
      }
    }
    for (int e = 0; e < m; ++e) wts[e] = __fdiv_rn(wts[e], count);
    sh.n_rows = m;
  }
  __syncthreads();

  const int cv = c / VEC;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const int m = sh.n_rows;
  if (v >= cv || m == 0) return;
  const int ch = v * VEC;
  const G* src = dout + ((size_t)r * out_size + i) * out_size * c + ch;
  float* img = dfeat + (size_t)b * h * w * c + ch;

  // the window: columns base and base + 1, with their summed taps
  float acc0[VEC] = {}, acc1[VEC] = {};
  bool hit0 = false, hit1 = false;
  int base = -1;
  for (int j = 0; j < out_size; ++j) {
    float d[VEC];
    IO<G, VEC>::load(src + (size_t)j * c, d);
    for (int kx = 0; kx < s; ++kx) {
      const Tap t = xs[j * s + kx];
      if (t.w0 == 0.f && t.w1 == 0.f) continue;  // a sample off the map
      if (base >= 0 && t.i0 != base) {  // the window moves right: flush what leaves it
        if (hit0) scatter_column<VEC>(img, base, acc0, rows, wts, m, w, c);
        if (t.i0 == base + 1) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc0[e] = acc1[e];
            acc1[e] = 0.f;
          }
          hit0 = hit1;
        } else {
          if (hit1) scatter_column<VEC>(img, base + 1, acc1, rows, wts, m, w, c);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc0[e] = acc1[e] = 0.f;
          hit0 = false;
        }
        hit1 = false;
      }
      base = t.i0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc0[e] = __fadd_rn(acc0[e], __fmul_rn(t.w0, d[e]));
      hit0 = true;
      if (t.w1 != 0.f) {  // i1 = i0 + 1 (at the top edge i1 = i0 and w1 = 0)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc1[e] = __fadd_rn(acc1[e], __fmul_rn(t.w1, d[e]));
        hit1 = true;
      }
    }
  }
  if (hit0) scatter_column<VEC>(img, base, acc0, rows, wts, m, w, c);
  if (hit1) scatter_column<VEC>(img, base + 1, acc1, rows, wts, m, w, c);
}

template <typename G, int VEC>
__global__ void roi_align_backward_kernel(const G* __restrict__ dout,
                                          const float* __restrict__ boxes,
                                          const int* __restrict__ batch_idx,
                                          float* __restrict__ dfeat, int n_img, int h, int w,
                                          int c, int out_size, int s) {
  __shared__ Tap xs[kMaxSamples];
  __shared__ int rows[2 * kMaxRatio];
  __shared__ float wts[2 * kMaxRatio];
  __shared__ int n_rows;

  const int r = blockIdx.x / out_size;
  const int i = blockIdx.x % out_size;
  const int b = batch_idx[r];
  if (b < 0 || b >= n_img) return;  // the RoI pooled nothing: no gradient
  const Frame f = box_frame(boxes, r);
  const int n = out_size * s;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = bilinear_1d(sample_coord(f.x0, f.bw, k, out_size, s), w);
  if (threadIdx.x == 0) {
    // WY_i / s^2: the bin row's distinct feature rows, each with the summed
    // weight of the taps of its s samples that land there
    const float count = (float)(s * s);
    int m = 0;
    for (int ky = 0; ky < s; ++ky) {
      const Tap t = bilinear_1d(sample_coord(f.y0, f.bh, i * s + ky, out_size, s), h);
      const int idx[2] = {t.i0, t.i1};
      const float wt[2] = {t.w0, t.w1};
      for (int q = 0; q < 2; ++q) {
        if (wt[q] == 0.f) continue;
        int e = 0;
        while (e < m && rows[e] != idx[q]) ++e;
        if (e == m) {
          rows[m] = idx[q];
          wts[m++] = wt[q];
        } else {
          wts[e] = __fadd_rn(wts[e], wt[q]);
        }
      }
    }
    for (int e = 0; e < m; ++e) wts[e] = __fdiv_rn(wts[e], count);
    n_rows = m;
  }
  __syncthreads();

  const int cv = c / VEC;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  const int m = n_rows;
  if (v >= cv || m == 0) return;
  const int ch = v * VEC;
  const G* src = dout + ((size_t)r * out_size + i) * out_size * c + ch;
  float* img = dfeat + (size_t)b * h * w * c + ch;

  // the window: columns base and base + 1, with their summed taps
  float acc0[VEC] = {}, acc1[VEC] = {};
  bool hit0 = false, hit1 = false;
  int base = -1;
  for (int j = 0; j < out_size; ++j) {
    float d[VEC];
    IO<G, VEC>::load(src + (size_t)j * c, d);
    for (int kx = 0; kx < s; ++kx) {
      const Tap t = xs[j * s + kx];
      if (t.w0 == 0.f && t.w1 == 0.f) continue;  // a sample off the map
      if (base >= 0 && t.i0 != base) {  // the window moves right: flush what leaves it
        if (hit0) scatter_column<VEC>(img, base, acc0, rows, wts, m, w, c);
        if (t.i0 == base + 1) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc0[e] = acc1[e];
            acc1[e] = 0.f;
          }
          hit0 = hit1;
        } else {
          if (hit1) scatter_column<VEC>(img, base + 1, acc1, rows, wts, m, w, c);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc0[e] = acc1[e] = 0.f;
          hit0 = false;
        }
        hit1 = false;
      }
      base = t.i0;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc0[e] = __fadd_rn(acc0[e], __fmul_rn(t.w0, d[e]));
      hit0 = true;
      if (t.w1 != 0.f) {  // i1 = i0 + 1 (at the top edge i1 = i0 and w1 = 0)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc1[e] = __fadd_rn(acc1[e], __fmul_rn(t.w1, d[e]));
        hit1 = true;
      }
    }
  }
  if (hit0) scatter_column<VEC>(img, base, acc0, rows, wts, m, w, c);
  if (hit1) scatter_column<VEC>(img, base + 1, acc1, rows, wts, m, w, c);
}

template <typename G, int VEC>
__global__ void roi_align_levels_backward_kernel(const G* __restrict__ dout,
                                                 const float* __restrict__ boxes,
                                                 const int* __restrict__ batch_idx,
                                                 const int* __restrict__ level,
                                                 Levels<float*> lv, int n_img, int c,
                                                 int out_size, int s) {
  __shared__ BackwardShared sh;
  const int r = blockIdx.x / out_size;
  const int l = min(max(level[r], 0), lv.n - 1);
  scatter_row<G, VEC>(dout, level_frame(boxes, r, lv.scale[l]),
                      level[r] == l ? batch_idx[r] : -1, lv.map[l], r, blockIdx.x % out_size,
                      n_img, lv.h[l], lv.w[l], c, out_size, s, sh);
}

int check_geometry(int h, int w, int c, int out_size, int s, int vec, int widest) {
  if (out_size <= 0 || s <= 0 || s > kMaxRatio || out_size * s > kMaxSamples || h <= 0 ||
      w <= 0 || (vec != 1 && vec != 4 && vec != widest) || c % vec)
    return (int)cudaErrorInvalidValue;
  return 0;
}

dim3 grid_of(int r, int out_size, int c, int vec, int most, int* threads) {
  const int cv = c / vec;
  *threads = cv >= most ? most : ((cv + 31) / 32) * 32;
  return dim3((unsigned)(r * out_size), (unsigned)((cv + *threads - 1) / *threads));
}

template <typename T>
int launch_forward(const void* feat, const void* boxes, const void* batch_idx, void* out, int r,
                   int n_img, int h, int w, int c, int out_size, int s, int vec, void* stream) {
  if (r <= 0 || c <= 0) return 0;
  // 16-byte accesses: 4 f32 or 8 bf16 channels a thread
  constexpr int kWidest = 16 / (int)sizeof(T);
  if (const int err = check_geometry(h, w, c, out_size, s, vec, kWidest)) return err;
  int threads;
  const dim3 grid = grid_of(r, out_size, c, vec, 128, &threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* f = static_cast<const T*>(feat);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  T* o = static_cast<T*>(out);
  const bool parts = s * s > 4;  // the plain mean's four partial sums
#define TSPN_ROI_FORWARD(V, PARTS) \
  roi_align_kernel<T, V, PARTS><<<grid, threads, 0, st>>>(f, bx, bi, o, n_img, h, w, c, out_size, s)
  if (vec == kWidest && parts)
    TSPN_ROI_FORWARD(kWidest, 4);
  else if (vec == kWidest)
    TSPN_ROI_FORWARD(kWidest, 1);
  else if (vec == 4 && parts)
    TSPN_ROI_FORWARD(4, 4);
  else if (vec == 4)
    TSPN_ROI_FORWARD(4, 1);
  else if (parts)
    TSPN_ROI_FORWARD(1, 4);
  else
    TSPN_ROI_FORWARD(1, 1);
#undef TSPN_ROI_FORWARD
  return (int)cudaGetLastError();
}

template <typename G>
int launch_backward(const void* dout, const void* boxes, const void* batch_idx, void* dfeat,
                    int r, int n_img, int h, int w, int c, int out_size, int s, int vec,
                    void* stream) {
  if (r <= 0 || c <= 0) return 0;
  if (const int err = check_geometry(h, w, c, out_size, s, vec, 4)) return err;
  int threads;
  const dim3 grid = grid_of(r, out_size, c, vec, 256, &threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const G* d = static_cast<const G*>(dout);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  float* df = static_cast<float*>(dfeat);
  if (vec == 4)
    roi_align_backward_kernel<G, 4>
        <<<grid, threads, 0, st>>>(d, bx, bi, df, n_img, h, w, c, out_size, s);
  else
    roi_align_backward_kernel<G, 1>
        <<<grid, threads, 0, st>>>(d, bx, bi, df, n_img, h, w, c, out_size, s);
  return (int)cudaGetLastError();
}

// The levels' table from the entry points' arguments: maps, h and w
// pairs, scales; 0 if it is sound, else an error.
template <typename P>
int make_levels(Levels<P>* lv, P m0, P m1, P m2, P m3, int n_levels, const int* hw,
                const float* scale) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  const P maps[kMaxLevels] = {m0, m1, m2, m3};
  lv->n = n_levels;
  for (int l = 0; l < kMaxLevels; ++l) {
    const int k = l < n_levels ? l : 0;  // unused slots repeat level 0
    lv->map[l] = maps[k];
    lv->h[l] = hw[2 * k];
    lv->w[l] = hw[2 * k + 1];
    lv->scale[l] = scale[k];
    if (lv->h[l] <= 0 || lv->w[l] <= 0 || maps[k] == nullptr) return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int launch_levels_forward(const Levels<const float*>& lv, const void* boxes,
                          const void* batch_idx, const void* level, void* out, int r, int n_img,
                          int c, int out_size, int s, int vec, void* stream) {
  if (r <= 0 || c <= 0) return 0;
  for (int l = 0; l < lv.n; ++l)
    if (const int err = check_geometry(lv.h[l], lv.w[l], c, out_size, s, vec, 4)) return err;
  int threads;
  const dim3 grid = grid_of(r, out_size, c, vec, 128, &threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* lvl = static_cast<const int*>(level);
  float* o = static_cast<float*>(out);
  const bool parts = s * s > 4;
#define TSPN_ROI_LEVELS(V, PARTS)                                                     \
  roi_align_levels_kernel<float, V, PARTS><<<grid, threads, 0, st>>>(lv, bx, bi, lvl, o, \
                                                                      n_img, c, out_size, s)
  if (vec == 4 && parts)
    TSPN_ROI_LEVELS(4, 4);
  else if (vec == 4)
    TSPN_ROI_LEVELS(4, 1);
  else if (parts)
    TSPN_ROI_LEVELS(1, 4);
  else
    TSPN_ROI_LEVELS(1, 1);
#undef TSPN_ROI_LEVELS
  return (int)cudaGetLastError();
}

int launch_levels_backward(const void* dout, const void* boxes, const void* batch_idx,
                           const void* level, const Levels<float*>& lv, int r, int n_img, int c,
                           int out_size, int s, int vec, void* stream) {
  if (r <= 0 || c <= 0) return 0;
  for (int l = 0; l < lv.n; ++l)
    if (const int err = check_geometry(lv.h[l], lv.w[l], c, out_size, s, vec, 4)) return err;
  int threads;
  const dim3 grid = grid_of(r, out_size, c, vec, 256, &threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dout);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  const int* lvl = static_cast<const int*>(level);
  if (vec == 4)
    roi_align_levels_backward_kernel<float, 4>
        <<<grid, threads, 0, st>>>(d, bx, bi, lvl, lv, n_img, c, out_size, s);
  else
    roi_align_levels_backward_kernel<float, 1>
        <<<grid, threads, 0, st>>>(d, bx, bi, lvl, lv, n_img, c, out_size, s);
  return (int)cudaGetLastError();
}

}  // namespace

// The levels form, f32: maps f0..f3 ((N, h_l, w_l, c) each; the first
// n_levels are used), boxes in image coordinates, level (R,) int32 in
// [0, n_levels), scale_l = 1 / stride_l.
extern "C" int tspn_roi_align_levels_launch(const void* f0, const void* f1, const void* f2,
                                            const void* f3, const void* boxes,
                                            const void* batch_idx, const void* level, void* out,
                                            int r, int n_img, int n_levels, int h0, int w0,
                                            int h1, int w1, int h2, int w2, int h3, int w3,
                                            int c, int out_size, int s, int vec, float sc0,
                                            float sc1, float sc2, float sc3, void* stream) {
  const int hw[8] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const float scale[4] = {sc0, sc1, sc2, sc3};
  Levels<const float*> lv;
  if (const int err = make_levels(&lv, static_cast<const float*>(f0),
                                  static_cast<const float*>(f1), static_cast<const float*>(f2),
                                  static_cast<const float*>(f3), n_levels, hw, scale))
    return err;
  return launch_levels_forward(lv, boxes, batch_idx, level, out, r, n_img, c, out_size, s, vec,
                               stream);
}

// Its backward: dOut (R, out, out, c) f32 -> dF_l (N, h_l, w_l, c) f32,
// zeroed by the caller.
extern "C" int tspn_roi_align_levels_backward_launch(
    const void* dout, const void* boxes, const void* batch_idx, const void* level, void* d0,
    void* d1, void* d2, void* d3, int r, int n_img, int n_levels, int h0, int w0, int h1,
    int w1, int h2, int w2, int h3, int w3, int c, int out_size, int s, int vec, float sc0,
    float sc1, float sc2, float sc3, void* stream) {
  const int hw[8] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const float scale[4] = {sc0, sc1, sc2, sc3};
  Levels<float*> lv;
  if (const int err = make_levels(&lv, static_cast<float*>(d0), static_cast<float*>(d1),
                                  static_cast<float*>(d2), static_cast<float*>(d3), n_levels,
                                  hw, scale))
    return err;
  return launch_levels_backward(dout, boxes, batch_idx, level, lv, r, n_img, c, out_size, s,
                                vec, stream);
}

extern "C" int tspn_roi_align_launch(const void* feat, const void* boxes, const void* batch_idx,
                                     void* out, int r, int n_img, int h, int w, int c,
                                     int out_size, int s, int vec, void* stream) {
  return launch_forward<float>(feat, boxes, batch_idx, out, r, n_img, h, w, c, out_size, s, vec,
                               stream);
}

extern "C" int tspn_roi_align_bf16_launch(const void* feat, const void* boxes,
                                          const void* batch_idx, void* out, int r, int n_img,
                                          int h, int w, int c, int out_size, int s, int vec,
                                          void* stream) {
  return launch_forward<__nv_bfloat16>(feat, boxes, batch_idx, out, r, n_img, h, w, c, out_size,
                                       s, vec, stream);
}

// dout_bf16: 1 when dOut is bf16 (a bf16 map's gradient), 0 for f32.
extern "C" int tspn_roi_align_backward_launch(const void* dout, const void* boxes,
                                              const void* batch_idx, void* dfeat, int r,
                                              int n_img, int h, int w, int c, int out_size,
                                              int s, int vec, int dout_bf16, void* stream) {
  if (dout_bf16)
    return launch_backward<__nv_bfloat16>(dout, boxes, batch_idx, dfeat, r, n_img, h, w, c,
                                          out_size, s, vec, stream);
  return launch_backward<float>(dout, boxes, batch_idx, dfeat, r, n_img, h, w, c, out_size, s,
                                vec, stream);
}
