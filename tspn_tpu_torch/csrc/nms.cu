// Greedy 2-D box NMS with a fixed output shape, for Hopper (sm_90a): one
// launch per call, every image of the batch in it, no host sync.
//
// Replaces no Pallas kernel. The JAX package runs its blocked greedy
// (tspn_tpu/ops/nms.py::nms) as one lax.while_loop on the TPU; the port's
// plain version of that loop (ops/nms.py::_nms_blocked) is driven from the
// host, one sync and some thirty small launches a block of 16, and on the
// card that loop, not any kernel, set the detector's pace. This kernel is
// the loop's device form.
//
// Contract (ops/nms.py): the caller sorts each image's masked scores once,
// stably and descending, and passes the order and whether each sorted
// score is finite. Walking that order, a candidate is kept iff its score is
// finite and no box kept before it overlaps it by IoU > thr; the walk stops
// when top_k boxes are kept or the candidates run out. Output slot s holds
// the s-th kept index with keep 1; slots past the last kept hold index 0,
// keep 0. That is the kept sequence of the blocked loop and of
// nms_sequential, element for element. IoU is box_iou's, operation for
// operation in f32 with round-to-nearest intrinsics (no FMA contraction):
// inter = w * h, union = (area_a + area_b) - inter, inter / union where
// union > 0, else 0, and max / min / clamp keep a NaN as PyTorch's do. thr
// arrives rounded to f32, as PyTorch rounds a Python threshold before a
// comparison with an f32 tensor.
//
// Bound: the walk is sequential; work is the IoU tests, at most (visited
// candidates) x (kept boxes): 12,000 x 2,000 an image at the RPN's
// training top-k, a few million in practice (the walk ends at top_k), and
// a few thousand reads of 16 bytes. Neither bytes nor FLOPs bound it: the
// latency of the dependent walk does. Design: one 1024-thread block per
// image, its kept boxes (and their areas) in a global buffer of the
// wrapper's, 20 B a box: the block writes and rereads it on its own SM,
// so it stays in L1 / L2, and a top_k of any size fits (a kept list in
// shared memory timed the same at the cells' shapes). The block reads the
// sorted candidates 1,024 at a time into shared memory, drops the
// non-finite ones by ballot and prefix (an image's 35,000 class-aware
// candidates, most below the score cut, cost 35 such reads), and takes the
// rest in chunks of 32: every warp tests the chunk (one candidate a lane)
// against a stride of the kept list and ORs its ballot into a shared mask,
// while warp i also records which later chunk members overlap member i.
// After one barrier every thread resolves the chunk's triangle the same
// way from those 32 + 1 masks, warp 0 appends the kept members, and a
// second barrier publishes them: two barriers a chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = kThreads;  // sorted candidates read per step
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum / clamp(min=0): a NaN operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float tmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

// box_iou(a, b) > thr
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b,
                                         float thr) {
  const float w = clamp0(__fsub_rn(tmin(a.z, b.z), tmax(a.x, b.x)));
  const float h = clamp0(__fsub_rn(tmin(a.w, b.w), tmax(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  if (inter == 0.f) return 0.f > thr;  // IoU 0 whatever the union
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) > thr;
}

// One block per image. boxes (B, N) float4; order (B, N) the stably sorted
// candidate indices; finite (B, N) whether each sorted score is finite;
// out_idx (B, top_k) int64, out_keep (B, top_k) bool; kept_box (B, top_k)
// float4 and kept_area (B, top_k) f32, the kept list.
__global__ void __launch_bounds__(kThreads, 1)
    nms_kernel(const float4* __restrict__ boxes, const int64_t* __restrict__ order,
               const uint8_t* __restrict__ finite, int64_t* __restrict__ out_idx,
               uint8_t* __restrict__ out_keep, float4* kept_box, float* kept_area, int n,
               int top_k, float thr) {
  // the window's queue of finite candidates: box, area, index
  __shared__ float4 q_box[kWindow];
  __shared__ float q_area[kWindow];
  __shared__ int q_idx[kWindow];
  __shared__ int s_count[kWarps];
  __shared__ unsigned s_col[32];
  __shared__ unsigned s_sup[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  boxes += (int64_t)b * n;
  order += (int64_t)b * n;
  finite += (int64_t)b * n;
  out_idx += (int64_t)b * top_k;
  out_keep += (int64_t)b * top_k;
  kept_box += (int64_t)b * top_k;
  kept_area += (int64_t)b * top_k;
  if (tid < 2) s_sup[tid] = 0u;

  int kept = 0;   // the same in every thread
  int chunk = 0;  // chunks taken, the parity of s_sup
  for (int base = 0; base < n && kept < top_k; base += kWindow) {
    // the window's finite candidates, compacted in sorted order
    const int p = base + tid;
    const bool fin = p < n && finite[p];
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    int idx = 0;
    if (fin) {
      idx = (int)order[p];
      box = boxes[idx];
    }
    const unsigned ballot = __ballot_sync(kFull, fin);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      offset += w < warp ? c : 0;
      total += c;
    }
    if (fin) {
      const int r = offset + __popc(ballot & below);
      q_box[r] = box;
      q_area[r] = box_area(box);
      q_idx[r] = idx;
    }
    __syncthreads();

    for (int q = 0; q < total && kept < top_k; q += 32, ++chunk) {
      const int c = min(32, total - q);
      const bool mine = lane < c;
      const float4 cb = q_box[q + lane];  // in the queue's bounds: q + 31 < kWindow
      const float ca = q_area[q + lane];
      // the chunk against the kept list, a stride of it a warp
      bool sup = false;
      for (int k = warp; k < kept; k += kWarps)
        sup |= overlaps(cb, ca, kept_box[k], kept_area[k], thr);
      const unsigned m = __ballot_sync(kFull, sup && mine);
      if (lane == 0 && m) atomicOr(&s_sup[chunk & 1], m);
      // the chunk's triangle: which later members overlap member i
      for (int i = warp; i < c; i += kWarps) {
        const bool over = lane > i && mine && overlaps(cb, ca, q_box[q + i], q_area[q + i], thr);
        const unsigned col = __ballot_sync(kFull, over);
        if (lane == 0) s_col[i] = col;
      }
      __syncthreads();
      // resolve in sorted order, the same in every thread
      unsigned gone = s_sup[chunk & 1];
      unsigned keep = 0u;
      for (int i = 0; i < c; ++i) {
        if (!((gone >> i) & 1u)) {
          keep |= 1u << i;
          gone |= s_col[i];
        }
      }
      const int room = top_k - kept;
      while (__popc(keep) > room) keep &= ~(1u << (31 - __clz(keep)));
      if (warp == 0 && ((keep >> lane) & 1u)) {
        const int slot = kept + __popc(keep & below);
        kept_box[slot] = cb;
        kept_area[slot] = ca;
        out_idx[slot] = q_idx[q + lane];
        out_keep[slot] = 1;
      }
      if (tid == 0) s_sup[(chunk + 1) & 1] = 0u;
      kept += __popc(keep);
      __syncthreads();
    }
  }
  for (int s = kept + tid; s < top_k; s += kThreads) {
    out_idx[s] = 0;
    out_keep[s] = 0;
  }
}

}  // namespace

// kept_box (B, top_k) float4 and kept_area (B, top_k) f32: the kernel's
// scratch for the kept list.
extern "C" int tspn_nms_launch(const void* boxes, const void* order, const void* finite,
                               void* out_idx, void* out_keep, void* kept_box, void* kept_area,
                               int bsz, int n, int top_k, float thr, void* stream) {
  if (bsz <= 0 || top_k <= 0) return 0;
  if (n <= 0 || top_k > n || kept_box == nullptr || kept_area == nullptr)
    return (int)cudaErrorInvalidValue;
  nms_kernel<<<(unsigned)bsz, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int64_t*>(order),
      static_cast<const uint8_t*>(finite), static_cast<int64_t*>(out_idx),
      static_cast<uint8_t*>(out_keep), static_cast<float4*>(kept_box),
      static_cast<float*>(kept_area), n, top_k, thr);
  return (int)cudaGetLastError();
}
