// RoIAlign (K7) for sm_90a: direct bilinear sampling over channels-last
// feature maps, every image's RoIs in one launch.
//
// Replaces tspn_tpu/ops/roi_align.py::roi_align_pallas (_kernel_roi),
// which builds one pooled interpolation matrix G (out^2, H*W) per RoI and
// multiplies it with the feature map on the TPU's matrix unit. Here the
// function is computed directly: each output element is the s x s mean of
// bilinear samples, with torchvision's aligned=True border rules (see
// ops/roi_align.py). No G, no GEMM.
//
// Layout: features (N, H, W, C) f32 channels-last, boxes (R, 4) xyxy in
// feature coordinates, batch_idx (R,) int32, out (R, out, out, C) f32.
// One block per (RoI, output row i); its threads span the channels, VEC
// (4 or 1) contiguous floats each, so every bilinear tap is a coalesced
// read of a C row and every store a coalesced write. The block's sample
// coordinates (out*s along x, s along y) are computed once into shared
// memory; the block then walks the out bins of its row, whose taps
// neighbour each other and hit L1.
//
// Bound: bytes. At the detector's geometry (8 images x 40x40x1024,
// 2048 RoIs, out 14, s 2) the output alone is 1.64 GB against 52 MB of
// features, about 40 FLOP per output float, so the kernel streams its
// output with evict-first stores (__stcs) and leaves L2 to the features.
//
// Arithmetic mirrors the plain version (roi_align_plain) op for op, with
// round-to-nearest intrinsics so that nvcc contracts nothing into FMAs:
// coordinates lo + ((k + .5) / s) * (extent / out); rows first
// (f[y0] * wy0 + f[y1] * wy1), then columns (row[x0] * wx0 + row[x1] * wx1),
// then the s x s sum over the count. Only the order of the final mean's
// sum may differ from PyTorch's reduction.

#include <cuda_runtime.h>
#include <math.h>

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

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    __stcs(reinterpret_cast<float4*>(p), v);
  }
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  template <class F>
  static __device__ __forceinline__ T map(F f, T a, T b, T c, T d) {
    return make_float4(f(a.x, b.x, c.x, d.x), f(a.y, b.y, c.y, d.y),
                       f(a.z, b.z, c.z, d.z), f(a.w, b.w, c.w, d.w));
  }
  template <class F>
  static __device__ __forceinline__ T map2(F f, T a, T b) {
    return make_float4(f(a.x, b.x), f(a.y, b.y), f(a.z, b.z), f(a.w, b.w));
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, T v) { __stcs(p, v); }
  static __device__ __forceinline__ T zero() { return 0.f; }
  template <class F>
  static __device__ __forceinline__ T map(F f, T a, T b, T c, T d) { return f(a, b, c, d); }
  template <class F>
  static __device__ __forceinline__ T map2(F f, T a, T b) { return f(a, b); }
};

template <int VEC>
__global__ void roi_align_kernel(const float* __restrict__ feat,
                                 const float* __restrict__ boxes,
                                 const int* __restrict__ batch_idx,
                                 float* __restrict__ out,
                                 int n_img, int h, int w, int c, int out_size, int s) {
  using V = Vec<VEC>;
  __shared__ Tap xs[kMaxSamples];
  __shared__ Tap ys[kMaxRatio];

  const int r = blockIdx.x / out_size;
  const int i = blockIdx.x % out_size;
  const float bx0 = boxes[4 * r + 0], by0 = boxes[4 * r + 1];
  const float bx1 = boxes[4 * r + 2], by1 = boxes[4 * r + 3];
  const float x0 = __fsub_rn(bx0, 0.5f), y0 = __fsub_rn(by0, 0.5f);
  const float bw = fmaxf(__fsub_rn(bx1, bx0), 1e-6f);
  const float bh = fmaxf(__fsub_rn(by1, by0), 1e-6f);
  const int n = out_size * s;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    xs[k] = bilinear_1d(sample_coord(x0, bw, k, out_size, s), w);
  for (int k = threadIdx.x; k < s; k += blockDim.x)
    ys[k] = bilinear_1d(sample_coord(y0, bh, i * s + k, out_size, s), h);
  __syncthreads();

  const int cv = c / VEC;  // vectors per channel row
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= cv) return;
  const int ch = v * VEC;
  float* dst = out + ((size_t)r * out_size + i) * out_size * c + ch;
  const int b = batch_idx[r];
  if (b < 0 || b >= n_img) {  // no such image: the RoI pools nothing
    for (int j = 0; j < out_size; ++j) V::store(dst + (size_t)j * c, V::zero());
    return;
  }
  const float* img = feat + (size_t)b * h * w * c + ch;
  const float count = (float)(s * s);

  for (int j = 0; j < out_size; ++j) {
    typename V::T acc = V::zero();
    for (int ky = 0; ky < s; ++ky) {
      const Tap ty = ys[ky];
      const float* row0 = img + (size_t)ty.i0 * w * c;
      const float* row1 = img + (size_t)ty.i1 * w * c;
      for (int kx = 0; kx < s; ++kx) {
        const Tap tx = xs[j * s + kx];
        const typename V::T f00 = V::load(row0 + (size_t)tx.i0 * c);
        const typename V::T f10 = V::load(row1 + (size_t)tx.i0 * c);
        const typename V::T f01 = V::load(row0 + (size_t)tx.i1 * c);
        const typename V::T f11 = V::load(row1 + (size_t)tx.i1 * c);
        // (f00 * wy0 + f10 * wy1) * wx0 + (f01 * wy0 + f11 * wy1) * wx1
        const typename V::T smp = V::map(
            [&](float a, float bb, float cc, float d) {
              const float col0 = __fadd_rn(__fmul_rn(a, ty.w0), __fmul_rn(bb, ty.w1));
              const float col1 = __fadd_rn(__fmul_rn(cc, ty.w0), __fmul_rn(d, ty.w1));
              return __fadd_rn(__fmul_rn(col0, tx.w0), __fmul_rn(col1, tx.w1));
            },
            f00, f10, f01, f11);
        acc = V::map2([](float a, float bb) { return __fadd_rn(a, bb); }, acc, smp);
      }
    }
    V::store(dst + (size_t)j * c,
             V::map2([&](float a, float) { return __fdiv_rn(a, count); }, acc, acc));
  }
}

}  // namespace

extern "C" int tspn_roi_align_launch(const void* feat, const void* boxes, const void* batch_idx,
                                     void* out, int r, int n_img, int h, int w, int c,
                                     int out_size, int s, int vec, void* stream) {
  if (r <= 0 || c <= 0) return 0;
  if (out_size <= 0 || s <= 0 || s > kMaxRatio || out_size * s > kMaxSamples ||
      h <= 0 || w <= 0 || (vec != 1 && vec != 4) || c % vec)
    return (int)cudaErrorInvalidValue;
  const int cv = c / vec;
  const int threads = cv >= 256 ? 256 : ((cv + 31) / 32) * 32;
  const dim3 grid((unsigned)(r * out_size), (unsigned)((cv + threads - 1) / threads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const float* bx = static_cast<const float*>(boxes);
  const int* bi = static_cast<const int*>(batch_idx);
  float* o = static_cast<float*>(out);
  if (vec == 4)
    roi_align_kernel<4><<<grid, threads, 0, st>>>(f, bx, bi, o, n_img, h, w, c, out_size, s);
  else
    roi_align_kernel<1><<<grid, threads, 0, st>>>(f, bx, bi, o, n_img, h, w, c, out_size, s);
  return (int)cudaGetLastError();
}
