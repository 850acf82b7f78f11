// Weight gradient of a grouped 3x3 convolution (padding 1, stride 1 or 2) in
// f32, for Hopper (sm_90a): ResNeXt's bottleneck conv2, whose forward and
// input gradient stay with cuDNN (ops/grouped_conv.py).
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions to XLA.
// It was added because cuDNN's f32 grouped weight gradient
// (wgrad2d_grouped_direct_kernel) ran at about 2.5% of the f32 CUDA-core
// peak and took a quarter of ResNeXt-101 FPN's training step.
//
// Function. x (N, C, H, W) and dY (N, C, Ho, Wo), both NCHW contiguous, C
// in groups of Cg channels; dW (C, Cg, 3, 3) with, for output channel co of
// group g, input channel ci and tap (kh, kw),
//   dW[co][ci][kh][kw] = sum over n, oh, ow of
//       dY[n][co][oh][ow] * x[n][g Cg + ci][oh s - 1 + kh][ow s - 1 + kw]
// (zero outside the map). Per group it is a (Cg x K) by (K x 9 Cg) product,
// K = N Ho Wo: a small output over a long sum.
//
// Bound, at ResNeXt-101 32x8d's four stages (N 4, an 800 x 1344 canvas):
// every conv does 9.9 GFLOP, 0.148 ms of FFMA at 67 TFLOP/s; x and dY are
// read once, 0.55 GB at res2 (0.164 ms at 3.35 TB/s: bytes bound it there,
// and in res3's strided first block), 0.28 GB at res3, 0.14 at res4 and 0.07
// at res5, where FFMA bounds it. f32 throughout (the configuration turns TF32
// off), so the tensor cores take no part.
//
// Design. A block of 256 threads takes a slab of 64 input channels (64 / Cg
// whole groups, or one group of 64 split over two blocks by output channel)
// and one K slice: a run of pixel tiles, each one output row segment of tw
// columns of one image. Each thread keeps 72 dW terms in registers: 8 output
// channels by the 9 taps of one input channel. Where Cg is 8 or 16 a slab
// has fewer such (channel, 8 output channels) units than threads, so 4 or 2
// thread sets ("phases") split a tile's column pairs, each with its own
// partial sums. A tile's dY rows (the slab's output channels) and the three
// input rows under it with the one-pixel halo are staged in shared memory by
// 4-byte cp.async with zero fill (the padding and a ragged right edge), two
// stages deep, so the next tile loads while this one is summed. The inner
// step takes two output columns: 8 float2 loads of dY (lanes of one group
// read one address), 3 x (s + 3) loads of x (32 channels a warp, an odd
// channel stride: no bank conflict) and 144 FFMA. Each (slice, phase) writes
// its partial sums to a workspace, and a second launch adds the partials of
// each dW term in a fixed order: a run repeats bit for bit. The wrapper
// (ops/grouped_conv.py::grouped_wgrad_plan) picks tw (the widest tile whose
// stage fits two blocks an SM) and the K split (about two blocks an SM in
// all) from the shapes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 64;        // input channels a block takes
constexpr int kCo = 8;           // output channels a thread
constexpr int kAcc = kCo * 9;    // a thread's dW terms
constexpr int kStageFloats = 14336;  // two blocks an SM: 2 x 2 stages x 56 KB

struct Plan {
  int n, c, h, w, ho, wo, cg;
  int tw;         // output columns a tile (even)
  int col_tiles;  // tiles across an output row
  int tiles;      // n * ho * col_tiles
  int ksplit;     // K slices: gridDim.x
  int cs;         // sets of 8 output channels a unit column: min(cg, 32) / 8
  int halves;     // blocks a group's output channels are split over: cg / (8 cs)
  int units;      // threads with dW terms of their own: 64 cs
  int phases;     // thread sets that split a tile's column pairs: 4 / cs
  int co_span;    // output channels a block stages: (64 / cg) 8 cs
  int dyp;        // dY row stride in shared memory, 2 mod 4 (floats)
  int xw;         // input columns staged a row: (tw - 1) s + 3
  int xch;        // input channel stride in shared memory, odd: 3 xw | 1
  int stage;      // floats a stage
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from src into shared dst, or 0 where !ok (src is not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage tile `tile` of slab xg (output half `half`) into buf: dY rows
// [co_span][dyp], then x rows [64][3][xw] at channel stride xch.
template <int S>
__device__ __forceinline__ void stage_tile(float* buf, const float* __restrict__ x,
                                           const float* __restrict__ dy, const Plan& p, int tile,
                                           int xg, int half, int warp, int lane) {
  const int row = tile / p.col_tiles;  // n * ho + oh
  const int c0 = (tile - row * p.col_tiles) * p.tw;
  const int n = row / p.ho, oh = row - n * p.ho;
  const int cs8 = kCo * p.cs;
  for (int k = warp; k < p.co_span; k += kWarps) {
    const int gk = k / cs8;
    const int co = xg * kSlab + gk * p.cg + half * cs8 + (k - gk * cs8);
    const float* src = dy + (((size_t)n * p.c + co) * p.ho + oh) * p.wo + c0;
    float* dst = buf + k * p.dyp;
    for (int j = lane; j < p.tw; j += 32) {
      const bool ok = c0 + j < p.wo;
      cp_async4(dst + j, ok ? src + j : dy, ok);
    }
  }
  float* xs = buf + p.co_span * p.dyp;
  const int iw0 = c0 * S - 1;
  for (int r = warp; r < kSlab * 3; r += kWarps) {
    const int ch = r / 3, kh = r - 3 * ch;
    const int ih = oh * S - 1 + kh;
    const bool row_ok = ih >= 0 && ih < p.h;
    const float* src = x + (((size_t)n * p.c + xg * kSlab + ch) * p.h + (row_ok ? ih : 0)) * p.w;
    float* dst = xs + ch * p.xch + kh * p.xw;
    for (int j = lane; j < p.xw; j += 32) {
      const int iw = iw0 + j;
      const bool ok = row_ok && iw >= 0 && iw < p.w;
      cp_async4(dst + j, ok ? src + iw : x, ok);
    }
  }
}

// grid (ksplit, slabs x halves). ws[(slice phases + phase)][blockIdx.y][72][units]
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         float* __restrict__ ws, const Plan p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x, bg = blockIdx.y;
  const int xg = bg / p.halves, half = bg - xg * p.halves;
  const int u = tid % p.units, phase = tid / p.units;
  const int xl = u % kSlab, set = u / kSlab;
  // the thread's dY rows and x channel in a stage
  const int dy_off = ((xl / p.cg) * p.cs + set) * kCo * p.dyp;
  const int x_off = p.co_span * p.dyp + xl * p.xch;
  const int t0 = (int)((long long)p.tiles * slice / p.ksplit);
  const int t1 = (int)((long long)p.tiles * (slice + 1) / p.ksplit);

  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  if (t0 < t1) stage_tile<S>(smem, x, dy, p, t0, xg, half, warp, lane);
  cp_async_commit();
  for (int t = t0; t < t1; ++t) {
    const float* cur = smem + ((t - t0) & 1) * p.stage;
    if (t + 1 < t1)
      stage_tile<S>(smem + ((t + 1 - t0) & 1) * p.stage, x, dy, p, t + 1, xg, half, warp, lane);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const float* sdy = cur + dy_off;
    const float* sx = cur + x_off;
    for (int c = 2 * phase; c < p.tw; c += 2 * p.phases) {
      float2 d[kCo];
#pragma unroll
      for (int i = 0; i < kCo; ++i) d[i] = *reinterpret_cast<const float2*>(sdy + i * p.dyp + c);
      float xv[3][S + 3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < S + 3; ++k) xv[r][k] = sx[r * p.xw + S * c + k];
#pragma unroll
      for (int i = 0; i < kCo; ++i)
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float& s = acc[i * 9 + r * 3 + k];
            s = fmaf(d[i].x, xv[r][k], s);
            s = fmaf(d[i].y, xv[r][k + S], s);
          }
    }
    __syncthreads();
  }
  float* out = ws + ((size_t)(slice * p.phases + phase) * gridDim.y + bg) * kAcc * p.units + u;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) out[(size_t)a * p.units] = acc[a];
}

// dW from the workspace: each term the sum of its kparts partials in order
__global__ void __launch_bounds__(kThreads)
    grouped_wgrad_reduce(const float* __restrict__ ws, float* __restrict__ dw, const Plan p,
                         int blocks_y, int kparts) {
  const int total = blocks_y * kAcc * p.units;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < kparts; ++k) s += ws[(size_t)k * total + e];
    const int bg = e / (kAcc * p.units), rem = e - bg * kAcc * p.units;
    const int a = rem / p.units, u = rem - a * p.units;
    const int xg = bg / p.halves, half = bg - xg * p.halves;
    const int xl = u % kSlab, set = u / kSlab;
    const int gl = xl / p.cg, ci = xl - gl * p.cg;
    const int i = a / 9, tap = a - 9 * i;
    const int co = xg * kSlab + gl * p.cg + half * kCo * p.cs + set * kCo + i;
    dw[((size_t)co * p.cg + ci) * 9 + tap] = s;
  }
}

}  // namespace

// x (n, c, h, w) and dy (n, c, ho, wo) f32 NCHW contiguous, ho = (h - 1) /
// stride + 1 (and wo); dw (c, cg, 3, 3); ws ksplit * (4 / cs) * c * cg * 9
// floats. tw (even) and ksplit are the wrapper's plan.
extern "C" int tspn_grouped_wgrad_launch(const void* x, const void* dy, void* ws, void* dw, int n,
                                         int c, int h, int w, int cg, int stride, int tw,
                                         int ksplit, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || c % kSlab != 0 ||
      (cg != 8 && cg != 16 && cg != 32 && cg != 64) || (stride != 1 && stride != 2) || tw < 2 ||
      tw % 2 != 0 || ksplit < 1)
    return (int)cudaErrorInvalidValue;
  Plan p;
  p.n = n, p.c = c, p.h = h, p.w = w, p.cg = cg;
  p.ho = (h - 1) / stride + 1, p.wo = (w - 1) / stride + 1;
  p.tw = tw;
  p.col_tiles = (p.wo + tw - 1) / tw;
  p.tiles = n * p.ho * p.col_tiles;
  p.ksplit = ksplit;
  p.cs = (cg < 32 ? cg : 32) / kCo;
  p.halves = cg / (kCo * p.cs);
  p.units = kSlab * p.cs;
  p.phases = kThreads / p.units;
  p.co_span = (kSlab / cg) * kCo * p.cs;
  p.dyp = tw % 4 == 0 ? tw + 2 : tw;
  p.xw = (tw - 1) * stride + 3;
  p.xch = (3 * p.xw) | 1;
  p.stage = p.co_span * p.dyp + kSlab * p.xch;
  if (ksplit > p.tiles || p.stage > kStageFloats) return (int)cudaErrorInvalidValue;
  const int blocks_y = (c / kSlab) * p.halves;
  const size_t smem = 2 * (size_t)p.stage * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)ksplit, (unsigned)blocks_y);
  const float* xp = static_cast<const float*>(x);
  const float* dyp = static_cast<const float*>(dy);
  float* wsp = static_cast<float*>(ws);
  cudaError_t err;
  if (stride == 1) {
    err = cudaFuncSetAttribute(grouped_wgrad_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    grouped_wgrad_kernel<1><<<grid, kThreads, smem, st>>>(xp, dyp, wsp, p);
  } else {
    err = cudaFuncSetAttribute(grouped_wgrad_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    grouped_wgrad_kernel<2><<<grid, kThreads, smem, st>>>(xp, dyp, wsp, p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = blocks_y * kAcc * p.units;
  int rblocks = (total + kThreads - 1) / kThreads;
  if (rblocks > 1056) rblocks = 1056;  // 8 an SM, striding over the rest
  grouped_wgrad_reduce<<<rblocks, kThreads, 0, st>>>(wsp, static_cast<float*>(dw), p, blocks_y,
                                                     ksplit * p.phases);
  return (int)cudaGetLastError();
}
