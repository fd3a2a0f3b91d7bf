// Greedy single-class non-max suppression, one problem per CTA.
//
// Replaces the TPU kernel mtlx/kernels/nms_pallas.py
// non_max_suppression_pallas (kernel body _nms_kernel).
//
// What bounds it on Hopper: neither bytes nor arithmetic. A problem is a
// chain of max_out dependent steps (pick the best live box, then suppress
// its overlaps), so its time is max_out block-wide reductions and
// barriers in a row. The data (6000 boxes -> 144 KB) is read from device
// memory once; the IoU work is ~15 flops per box per pick.
//
// What the design does about it: the coordinate planes, the areas and the
// live scores stay in dynamic shared memory for the whole loop (the TPU
// kernel kept them in VMEM for the same reason), so each step costs one
// strided pass over shared memory, one warp-shuffle argmax and two
// barriers, and nothing goes back to device memory until the picks are
// written. Problems (images, or image x class pairs) run as separate CTAs.
//
// Exactness: the pick is the maximum of a packed 64-bit key (order-
// preserving score bits, then the complement of the index), so ties go to
// the lower index as in mtlx. The IoU is evaluated in the reference's
// operation order and this file is compiled with --fmad=false, so every
// suppress decision is bit-identical to the plain PyTorch version.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e10f;  // mtlx.ops.nms._NEG
constexpr int kMaxThreads = 512;

__device__ __forceinline__ unsigned int sortable_bits(float s) {
  if (s == 0.0f) s = 0.0f;  // -0 and +0 compare equal in the reference
  unsigned int u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_sortable_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long pack_key(float s, int i) {
  return (static_cast<unsigned long long>(sortable_bits(s)) << 32) |
         static_cast<unsigned long long>(0xffffffffu - static_cast<unsigned int>(i));
}

__global__ void nms_kernel(const float* __restrict__ boxes,        // [P, N, 4]
                           const float* __restrict__ scores,       // [P, N]
                           const unsigned char* __restrict__ valid,  // [P, N]
                           int n, int max_out, float iou_threshold,
                           float score_threshold,
                           int* __restrict__ idx_out,               // [P, max_out]
                           unsigned char* __restrict__ keep_out) {  // [P, max_out]
  extern __shared__ float smem[];
  float* ymin = smem;
  float* xmin = ymin + n;
  float* ymax = xmin + n;
  float* xmax = ymax + n;
  float* area = xmax + n;
  float* live = area + n;
  __shared__ unsigned long long warp_best[kMaxThreads / 32];
  __shared__ unsigned long long best_key;

  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const float4* pb = reinterpret_cast<const float4*>(boxes) + static_cast<size_t>(p) * n;
  const float* ps = scores + static_cast<size_t>(p) * n;
  const unsigned char* pv = valid + static_cast<size_t>(p) * n;
  int* pidx = idx_out + static_cast<size_t>(p) * max_out;
  unsigned char* pkeep = keep_out + static_cast<size_t>(p) * max_out;

  for (int i = tid; i < n; i += blockDim.x) {
    const float4 b = pb[i];
    ymin[i] = b.x;
    xmin[i] = b.y;
    ymax[i] = b.z;
    xmax[i] = b.w;
    area[i] = (b.z - b.x) * (b.w - b.y);
    const float s = ps[i];
    live[i] = (pv[i] && s > score_threshold) ? s : kNeg;
  }
  __syncthreads();

  for (int k = 0; k < max_out; ++k) {
    unsigned long long key = 0ull;
    for (int i = tid; i < n; i += blockDim.x) {
      const unsigned long long c = pack_key(live[i], i);
      key = c > key ? c : key;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
      key = o > key ? o : key;
    }
    if (lane == 0) warp_best[warp] = key;
    __syncthreads();
    if (warp == 0) {
      key = lane < nwarps ? warp_best[lane] : 0ull;
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_down_sync(0xffffffffu, key, off);
        key = o > key ? o : key;
      }
      if (lane == 0) best_key = key;
    }
    __syncthreads();
    key = best_key;
    const float best_score = from_sortable_bits(static_cast<unsigned int>(key >> 32));
    const int best = static_cast<int>(0xffffffffu - static_cast<unsigned int>(key & 0xffffffffull));
    if (!(best_score > kNeg / 2)) {
      // every later pick is empty too: pad the rest of the row here
      for (int j = k + tid; j < max_out; j += blockDim.x) {
        pidx[j] = 0;
        pkeep[j] = 0;
      }
      return;
    }
    if (tid == 0) {
      pidx[k] = best;
      pkeep[k] = 1;
    }
    const float by0 = ymin[best], bx0 = xmin[best];
    const float by1 = ymax[best], bx1 = xmax[best];
    const float barea = (by1 - by0) * (bx1 - bx0);
    for (int i = tid; i < n; i += blockDim.x) {
      const float ih = fmaxf(0.0f, fminf(ymax[i], by1) - fmaxf(ymin[i], by0));
      const float iw = fmaxf(0.0f, fminf(xmax[i], bx1) - fmaxf(xmin[i], bx0));
      const float inter = ih * iw;
      const float uni = area[i] + barea - inter;
      const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-30f) : 0.0f;
      if (iou > iou_threshold || i == best) live[i] = kNeg;
    }
    __syncthreads();
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mtlx_nms_f32(const void* boxes, const void* scores,
                            const void* valid, int num_problems, int n,
                            int max_out, float iou_threshold,
                            float score_threshold, void* idx_out,
                            void* keep_out, void* stream) {
  const size_t smem = static_cast<size_t>(n) * 6 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  nms_kernel<<<num_problems, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<const unsigned char*>(valid), n, max_out, iou_threshold,
      score_threshold, static_cast<int*>(idx_out),
      static_cast<unsigned char*>(keep_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mtlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
