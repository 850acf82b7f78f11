// The RoIAlign probes of tools/bench_roialign_{fused,variants}.py (T-roi)
// for sm_90a: the fused separable form, and the dense-G GEMM with G built
// from the box or held constant.
//
// Replaces three Pallas kernels:
//  * tools/bench_roialign_fused.py::_make_roi_align_sep_fused (body
//    _kernel_sep_fused): roi_sep_fused_kernel below;
//  * tools/bench_roialign_variants.py::main.<locals>.roi_selector (body
//    _kernel_sel): roi_gemm_f32_kernel / roi_gemm_bf16_kernel, kConst false;
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
// One block per (RoI, 32-channel tile): the intermediate tmp (14 x W x 32
// f32, 71.7 KB at W 40) lives in shared memory and never touches HBM, the
// role VMEM played for the TPU kernel's (8*14, W*C) tile (18 MB at its
// defaults, far above an SM's 228 KB; hence one RoI and 32 channels).
// Stage 1: each thread owns (w, c) columns and walks h four at a time,
// reading wy with 16-byte broadcasts; stage 2: each thread owns (i, c)
// pairs and walks w the same way. The TPU kernel's one-hot expansion of
// wx (`ee`) is a workaround for its lack of gathers: wx is indexed
// directly. Both stages run on the CUDA cores in f32 (the products of
// bf16 values are exact in f32).
//
// roi_gemm kernels (T-roi 2, 3): per RoI, out[(i,j), c] = sum_{(y,x)}
// G[(i,j),(y,x)] F[(y,x), c] with G = bf((ty[i][y] * tx[j][x]) / s^2)
// (selector: the TPU kernel's _kernel_sel without its one-hot selector
// matmuls, which only expanded the same tables) or G = bf(x0 * 1e-6)
// everywhere (constg: the lower bound of the G form, not RoIAlign). Tiles
// of 64 rows (of out^2 = 196) x 128 channels; G's tile for each K chunk is
// formed in shared memory from the tables as it is needed, never stored.
// f32 maps: a SIMT GEMM (16 x 16 threads of 4 x 8 outputs, K chunks of
// 16, true f32 FMAs, no TF32), the next chunk held in registers while the
// current one multiplies. bf16 maps: mma.sync.m16n8k16 bf16 -> f32, 8 warps
// of 16 x 64 outputs, K chunks of 32 in two shared buffers, F's chunk
// copied row-major by cp.async and read with ldmatrix .trans as the .col B
// operand. The selector writes the map's dtype, constg f32 (as the TPU
// probes do).
//
// What bounds them on the card (tools' defaults: 4 x 256 RoIs, 40 x 40 x
// 1024): the fused form does 63.5 GFLOP (47.6 in stage 1, 15.9 in stage 2)
// against 411 MB (bf16) or 822 MB (f32) of output: in f32 it is bound by
// the CUDA cores (0.95 ms); in bf16 stage 1's bf16 products would allow
// the tensor cores, but this first version runs both stages on the CUDA
// cores. The G form does 0.658 TFLOP: 9.8 ms on the CUDA cores in f32,
// 0.67 ms on the bf16 tensor cores; forming G costs instructions of its
// own (a few per element, each element feeding 128 channels). wgmma with
// TMA is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kOut = 14;        // output bins per axis (the C4 head)
constexpr int kMaxAxis = 128;   // H, W
constexpr int kMaxRatio = 16;   // s
constexpr int kThreads = 256;

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

// t[i * stride + y] for i < kOut, y < size: the summed weight of the s
// samples of bin i on index y; columns size..stride-1 are zero
__device__ void axis_table(float* t, int stride, float lo, float extent, int size, int s) {
  for (int e = threadIdx.x; e < kOut * stride; e += blockDim.x) {
    const int i = e / stride, y = e % stride;
    float acc = 0.f;
    if (y < size)
      for (int a = 0; a < s; ++a) {
        const Tap tp = bilinear_1d(sample_coord(lo, extent, i * s + a, s), size);
        const float v = __fadd_rn(y == tp.i0 ? tp.w0 : 0.f, y == tp.i1 ? tp.w1 : 0.f);
        acc = __fadd_rn(acc, v);
      }
    t[e] = acc;
  }
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

template <typename T>
struct Io;
template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// ------------------------------------------------------- T-roi 1: fused
constexpr int kCt = 32;  // channels per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_sep_fused_kernel(const T* __restrict__ feat, const float* __restrict__ boxes,
                     T* __restrict__ out, int R, int H, int W, int C, int s) {
  extern __shared__ __align__(16) float sm[];
  const int hp = (H + 3) / 4 * 4, wp = (W + 3) / 4 * 4;
  float* wy = sm;                 // [kOut][hp], 1/s^2 folded, rounded
  float* wx = wy + kOut * hp;     // [kOut][wp], rounded
  float* tmp = wx + kOut * wp;    // [kOut][W][kCt]

  const int roi = blockIdx.y;     // b * R + r
  const int b = roi / R;
  const int c0 = blockIdx.x * kCt;
  const Box bx = read_box(boxes + 4 * (size_t)roi);
  axis_table(wy, hp, bx.y0, bx.bh, H, s);
  axis_table(wx, wp, bx.x0, bx.bw, W, s);
  __syncthreads();
  const float inv_s2 = __fdiv_rn(1.f, (float)(s * s));
  for (int e = threadIdx.x; e < kOut * hp; e += kThreads)
    wy[e] = Io<T>::round(__fmul_rn(wy[e], inv_s2));
  for (int e = threadIdx.x; e < kOut * wp; e += kThreads) wx[e] = Io<T>::round(wx[e]);
  __syncthreads();

  // stage 1: tmp[i][w][c] = sum_h wy[i][h] F[h][w][c0 + c]
  const T* img = feat + (size_t)b * H * W * C + c0;
  for (int col = threadIdx.x; col < W * kCt; col += kThreads) {
    const int w = col / kCt, c = col % kCt;
    float acc[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
    for (int h = 0; h < hp; h += 4) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = h + e < H ? Io<T>::load(img + ((size_t)(h + e) * W + w) * C + c) : 0.f;
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const float4 t = *reinterpret_cast<const float4*>(wy + i * hp + h);
        acc[i] = fmaf(t.x, f[0], acc[i]);
        acc[i] = fmaf(t.y, f[1], acc[i]);
        acc[i] = fmaf(t.z, f[2], acc[i]);
        acc[i] = fmaf(t.w, f[3], acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kOut; ++i) tmp[(i * W + w) * kCt + c] = acc[i];
  }
  __syncthreads();

  // stage 2: out[i][j][c] = sum_w wx[j][w] tmp[i][w][c]
  T* dst = out + (size_t)roi * kOut * kOut * C + c0;
  for (int pair = threadIdx.x; pair < kOut * kCt; pair += kThreads) {
    const int i = pair / kCt, c = pair % kCt;
    float acc[kOut];
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[j] = 0.f;
    for (int w = 0; w < wp; w += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = w + e < W ? tmp[(i * W + w + e) * kCt + c] : 0.f;
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float4 t = *reinterpret_cast<const float4*>(wx + j * wp + w);
        acc[j] = fmaf(t.x, v[0], acc[j]);
        acc[j] = fmaf(t.y, v[1], acc[j]);
        acc[j] = fmaf(t.z, v[2], acc[j]);
        acc[j] = fmaf(t.w, v[3], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kOut; ++j) Io<T>::store(dst + (size_t)(i * kOut + j) * C + c, acc[j]);
  }
}

// ------------------------------------------- T-roi 2, 3: the G @ F GEMM
constexpr int kM = 64;    // rows (i, j) per block
constexpr int kN = 128;   // channels per block
constexpr int kRows = kOut * kOut;

// A thread's share of G: four rows m_first + 16 r (r < 4), fixed for the
// whole K walk, and a cursor (k, y, x), k = y * W + x, over the columns it
// forms, moved a K chunk at a time. G[m][k] = bf((ty[m / 14][y] *
// tx[m % 14][x]) / s^2), or the constant; 0 for m >= 196 or k >= H * W.
template <typename T, bool kConst>
struct GRows {
  const float* ty_row[4];
  const float* tx_row[4];
  bool live[4];
  int k, y, x, hw, W;
  float inv_s2, cval;

  __device__ GRows(const float* ty, const float* tx, int m_first, int k_first, int hw_,
                   int W_, float inv_s2_, float cval_)
      : k(k_first), y(k_first / W_), x(k_first % W_), hw(hw_), W(W_), inv_s2(inv_s2_),
        cval(cval_) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m_first + 16 * r;
      live[r] = m < kRows;
      ty_row[r] = ty + (live[r] ? m / kOut : 0) * kMaxAxis;
      tx_row[r] = tx + (live[r] ? m % kOut : 0) * kMaxAxis;
    }
  }
  // G at row r and the column `ahead` (0 or 1) past the cursor
  __device__ __forceinline__ float at(int r, int ahead) const {
    const int kk = k + ahead;
    if (!live[r] || kk >= hw) return 0.f;
    if (kConst) return cval;
    const bool wrap = x + ahead >= W;
    const int yy = wrap ? y + 1 : y, xx = wrap ? x + ahead - W : x + ahead;
    return Io<T>::round(__fmul_rn(__fmul_rn(ty_row[r][yy], tx_row[r][xx]), inv_s2));
  }
  __device__ __forceinline__ void advance(int step) {
    k += step;
    x += step;
    while (x >= W) {
      x -= W;
      ++y;
    }
  }
};

// f32 maps: SIMT, thread (ty_, tx_) of 16 x 16 owns rows 4 ty_ .. +3 and
// channels 4 tx_ .. +3 and 64 + 4 tx_ .. +3. Two shared buffers: while the
// block multiplies chunk c, each thread holds chunk c + 1's G values and F
// vectors in registers, and stores them once chunk c is done.
template <bool kConst>
__global__ void __launch_bounds__(kThreads)
roi_gemm_f32_kernel(const float* __restrict__ feat, const float* __restrict__ boxes,
                    float* __restrict__ out, int R, int H, int W, int C, int s) {
  constexpr int kK = 16;
  constexpr int kGPer = kK * kM / kThreads;       // G values a thread forms: 4
  constexpr int kFPer = kK * kN / 4 / kThreads;   // F vectors a thread loads: 2
  __shared__ float tyx[2 * kOut * kMaxAxis];
  __shared__ __align__(16) float gs[2][kK][kM + 4];  // padded: 2-way stores
  __shared__ __align__(16) float fs[2][kK][kN];
  const int roi = blockIdx.z, b = roi / R;
  const int m0 = blockIdx.y * kM, n0 = blockIdx.x * kN;
  const int hw = H * W;
  const Box bx = read_box(boxes + 4 * (size_t)roi);
  float* ty = tyx;
  float* tx = tyx + kOut * kMaxAxis;
  if (!kConst) {
    axis_table(ty, kMaxAxis, bx.y0, bx.bh, H, s);
    axis_table(tx, kMaxAxis, bx.x0, bx.bw, W, s);
  }
  const float inv_s2 = __fdiv_rn(1.f, (float)(s * s));
  const float cval = __fmul_rn(bx.raw_x0, 1e-6f);
  const float* img = feat + (size_t)b * hw * C + n0;
  const int tid = threadIdx.x, ty_ = tid / 16, tx_ = tid % 16;
  // this thread forms G[m][kk] for kk = tid % kK and m = tid / kK + 16 r
  const int gk = tid % kK, gm = tid / kK;
  GRows<float, kConst> grows(ty, tx, m0 + gm, gk, hw, W, inv_s2, cval);
  float gv[kGPer];
  float4 fv[kFPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < kGPer; ++r) gv[r] = grows.at(r, 0);
    grows.advance(kK);
#pragma unroll
    for (int i = 0; i < kFPer; ++i) {
      const int e = tid + i * kThreads, kk = e / (kN / 4), n4 = e % (kN / 4);
      fv[i] = k0 + kk < hw
                  ? __ldg(reinterpret_cast<const float4*>(img + (size_t)(k0 + kk) * C) + n4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int r = 0; r < kGPer; ++r) gs[buf][gk][gm + 16 * r] = gv[r];
#pragma unroll
    for (int i = 0; i < kFPer; ++i) {
      const int e = tid + i * kThreads;
      *reinterpret_cast<float4*>(&fs[buf][e / (kN / 4)][(e % (kN / 4)) * 4]) = fv[i];
    }
  };

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;

  __syncthreads();  // the tables
  fetch(0);
  stash(0);
  __syncthreads();
  const int chunks = (hw + kK - 1) / kK;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < chunks) fetch((c + 1) * kK);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 g = *reinterpret_cast<const float4*>(&gs[buf][kk][ty_ * 4]);
      const float4 f0 = *reinterpret_cast<const float4*>(&fs[buf][kk][tx_ * 4]);
      const float4 f1 = *reinterpret_cast<const float4*>(&fs[buf][kk][64 + tx_ * 4]);
      const float ga[4] = {g.x, g.y, g.z, g.w};
      const float fa[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] = fmaf(ga[a], fa[e], acc[a][e]);
    }
    if (c + 1 < chunks) stash(buf ^ 1);  // the other buffer: free since chunk c - 1
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int m = m0 + ty_ * 4 + a;
    if (m >= kRows) continue;
    float* dst = out + ((size_t)roi * kRows + m) * C + n0;
    *reinterpret_cast<float4*>(dst + tx_ * 4) =
        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    *reinterpret_cast<float4*>(dst + 64 + tx_ * 4) =
        make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src),
               "r"(full ? 16 : 0));
}

// bf16 maps: warp w owns rows 16 (w % 4) .. +15 and channels 64 (w / 4) ..
// +63 (eight n8 tiles); OutT is bf16 (selector) or float (constg). F's
// chunks arrive row-major ([k][channel]) by cp.async into two buffers, and
// ldmatrix .trans hands each warp its .col B fragments; G's chunk for the
// next K step is formed while the current one multiplies.
template <bool kConst, typename OutT>
__global__ void __launch_bounds__(kThreads)
roi_gemm_bf16_kernel(const uint16_t* __restrict__ feat, const float* __restrict__ boxes,
                     OutT* __restrict__ out, int R, int H, int W, int C, int s) {
  constexpr int kK = 32;
  constexpr int kGStride = kK / 2 + 4;   // words per G row: 32 bf16 + 8 pad
  constexpr int kFStride = kN + 8;       // bf16 per F row: 128 + 8 pad
  __shared__ float tyx[2 * kOut * kMaxAxis];
  __shared__ __align__(16) uint32_t gs[2][kM * kGStride];    // [m][k] bf16 pairs
  __shared__ __align__(16) uint16_t fs[2][kK * kFStride];    // [k][channel]
  const int roi = blockIdx.z, b = roi / R;
  const int m0 = blockIdx.y * kM, n0 = blockIdx.x * kN;
  const int hw = H * W;
  const Box bx = read_box(boxes + 4 * (size_t)roi);
  float* ty = tyx;
  float* tx = tyx + kOut * kMaxAxis;
  if (!kConst) {
    axis_table(ty, kMaxAxis, bx.y0, bx.bh, H, s);
    axis_table(tx, kMaxAxis, bx.x0, bx.bw, W, s);
  }
  const float inv_s2 = __fdiv_rn(1.f, (float)(s * s));
  const float cval = __fmul_rn(bx.raw_x0, 1e-6f);
  const uint16_t* img = feat + (size_t)b * hw * C + n0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % 4) * 16, wn = (warp / 4) * 64;
  // this thread forms the bf16 pair (k, k + 1) = k0 + 2 gw_col (+1) of rows
  // m = gm + 16 r
  const int gw_col = tid % (kK / 2), gm = tid / (kK / 2);
  GRows<__nv_bfloat16, kConst> grows(ty, tx, m0 + gm, 2 * gw_col, hw, W, inv_s2, cval);

  // chunk k0 into buffer buf: F by cp.async (two 16-byte pieces a thread),
  // G formed here (four bf16 pairs a thread)
  auto stage = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < kK * (kN / 8) / kThreads; ++i) {
      const int e = tid + i * kThreads, kk = e / (kN / 8), n8 = e % (kN / 8);
      const bool ok = k0 + kk < hw;
      cp_async16(&fs[buf][kk * kFStride + n8 * 8], ok ? img + (size_t)(k0 + kk) * C + n8 * 8 : img,
                 ok);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      gs[buf][(gm + 16 * r) * kGStride + gw_col] = pack_bf16(grows.at(r, 0), grows.at(r, 1));
    grows.advance(kK);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  __syncthreads();  // the tables
  stage(0, 0);
  const int chunks = (hw + kK - 1) / kK;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // chunk c staged by every thread; buffer buf ^ 1 free
    if (c + 1 < chunks) stage(buf ^ 1, (c + 1) * kK);
    const uint32_t* gw = gs[buf];
    const unsigned fbase = static_cast<unsigned>(__cvta_generic_to_shared(fs[buf]));
#pragma unroll
    for (int ks = 0; ks < kK / 16; ++ks) {
      const int kw = ks * 8 + t;
      const uint32_t af[4] = {gw[(wm + g) * kGStride + kw], gw[(wm + g + 8) * kGStride + kw],
                              gw[(wm + g) * kGStride + kw + 4],
                              gw[(wm + g + 8) * kGStride + kw + 4]};
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        // lanes 0-15 address k rows 0-15 of n8 tile j, lanes 16-31 of tile j + 1
        const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = wn + 8 * (j + (lane >> 4));
        uint32_t bfr[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
            : "=r"(bfr[0]), "=r"(bfr[1]), "=r"(bfr[2]), "=r"(bfr[3])
            : "r"(fbase + (unsigned)(krow * kFStride + col) * 2u));
        mma_bf16(acc[j], af, bfr[0], bfr[1]);
        mma_bf16(acc[j + 1], af, bfr[2], bfr[3]);
      }
    }
  }
  // C fragment: acc[j][h*2 + e] is row wm + g + 8h, channel wn + 8j + 2t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wm + g + 8 * h;
    if (m >= kRows) continue;
    OutT* dst = out + ((size_t)roi * kRows + m) * C + n0 + wn;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (sizeof(OutT) == 2)
          dst[j * 8 + 2 * t + e] = __float2bfloat16_rn(acc[j][h * 2 + e]);
        else
          dst[j * 8 + 2 * t + e] = acc[j][h * 2 + e];
      }
  }
}

bool bad_shape(int B, int R, int H, int W, int C, int out_size, int s) {
  return B <= 0 || R <= 0 || H <= 0 || W <= 0 || C <= 0 || H > kMaxAxis ||
         W > kMaxAxis || out_size != kOut || s <= 0 || s > kMaxRatio;
}

}  // namespace

// C entries for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched). Preconditions, checked by the Python
// wrappers (ops/roi_probes.py): feat (B, H, W, C) f32 or bf16 (bf16 != 0)
// and boxes (B, R, 4) f32, contiguous, on one device, 16-byte aligned;
// out (B, R, 14, 14, C) in the dtype each entry writes.

// T-roi 1: out in the map's dtype; C % 32 == 0, W <= 112.
extern "C" int tspn_roi_sep_fused_launch(const void* feat, const void* boxes, void* out,
                                         int B, int R, int H, int W, int C, int out_size,
                                         int s, int bf16, void* stream) {
  if (bad_shape(B, R, H, W, C, out_size, s) || C % kCt) return (int)cudaErrorInvalidValue;
  const int hp = (H + 3) / 4 * 4, wp = (W + 3) / 4 * 4;
  const int smem = (kOut * hp + kOut * wp + kOut * W * kCt) * 4;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(C / kCt), (unsigned)(B * R));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t attr;
  if (bf16) {
    attr = cudaFuncSetAttribute(roi_sep_fused_kernel<__nv_bfloat16>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    roi_sep_fused_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        (const __nv_bfloat16*)feat, (const float*)boxes, (__nv_bfloat16*)out, R, H, W, C, s);
  } else {
    attr = cudaFuncSetAttribute(roi_sep_fused_kernel<float>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return (int)attr;
    roi_sep_fused_kernel<float><<<grid, kThreads, smem, st>>>(
        (const float*)feat, (const float*)boxes, (float*)out, R, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

// T-roi 2 (const_g 0, out in the map's dtype) and T-roi 3 (const_g 1, out
// f32); C % 128 == 0.
extern "C" int tspn_roi_gemm_launch(const void* feat, const void* boxes, void* out, int B,
                                    int R, int H, int W, int C, int out_size, int s, int bf16,
                                    int const_g, void* stream) {
  if (bad_shape(B, R, H, W, C, out_size, s) || C % kN) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(C / kN), (unsigned)((kRows + kM - 1) / kM), (unsigned)(B * R));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  if (!bf16) {
    const float* f = static_cast<const float*>(feat);
    float* o = static_cast<float*>(out);
    if (const_g)
      roi_gemm_f32_kernel<true><<<grid, kThreads, 0, st>>>(f, bx, o, R, H, W, C, s);
    else
      roi_gemm_f32_kernel<false><<<grid, kThreads, 0, st>>>(f, bx, o, R, H, W, C, s);
  } else {
    const uint16_t* f = static_cast<const uint16_t*>(feat);
    if (const_g)
      roi_gemm_bf16_kernel<true, float><<<grid, kThreads, 0, st>>>(
          f, bx, static_cast<float*>(out), R, H, W, C, s);
    else
      roi_gemm_bf16_kernel<false, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
          f, bx, static_cast<__nv_bfloat16*>(out), R, H, W, C, s);
  }
  return (int)cudaGetLastError();
}
