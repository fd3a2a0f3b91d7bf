// Pairwise IoU matrix: [P, N, 4] x [P, M, 4] -> [P, N, M] float32.
//
// Replaces the TPU kernel mtlx/kernels/iou_pallas.py iou_matrix (kernel
// body _iou_kernel), which tiled the output into 256 x 128 VMEM blocks
// and computed each block on the vector unit.
//
// What bounds it on Hopper: bytes. Each output element is ~15 flops and
// one 4-byte store; the output (16 x 100 x 30,720 floats = 197 MB on the
// training path's anchor assignment) dwarfs the boxes read (0.5 MB).
//
// What the design does about it: one thread per output column m (the
// fastest axis, so a warp stores 128 contiguous bytes), looping over a
// run of kRows rows n. The thread keeps its M-side box and its area in
// registers for the whole run; the N-side box is the same for every
// thread of the block and comes from the L1 cache as a broadcast. So the
// boxes are read about once and the output is written once, coalesced.
//
// Numerics: the operation order of mtlx.geometry.box_ops.iou (and of the
// plain version in iou_cuda.py): ih = max(0, min(ymax) - max(ymin)), the
// same for iw, inter = ih * iw, the areas as (ymax - ymin) * (xmax -
// xmin), union = (a1 + a2) - inter, then union > 0 ? inter / max(union,
// 1e-30) : 0 with IEEE division. Compiled with --fmad=false, the output
// is bit-equal to the plain version: the matcher's argmax and its
// thresholds see the same values on the card as on the CPU.
//
// Either side may be shared by every problem (a batch stride of 0): the
// anchors of the RPN assignment are one [M, 4] set for all images.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void iou_kernel(const float* __restrict__ boxes1,  // [P|1, N, 4]
                           const float* __restrict__ boxes2,  // [P|1, M, 4]
                           float* __restrict__ out,           // [P, N, M]
                           int n, int m, int64_t stride1, int64_t stride2) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= m) return;
  const int p = blockIdx.z;
  const float* q = boxes2 + p * stride2 + static_cast<int64_t>(col) * 4;
  const float ymin2 = q[0], xmin2 = q[1], ymax2 = q[2], xmax2 = q[3];
  const float area2 = (ymax2 - ymin2) * (xmax2 - xmin2);
  const float* r = boxes1 + p * stride1;
  float* o = out + static_cast<int64_t>(p) * n * m + col;
  const int row0 = blockIdx.y * kRows;
  const int row_end = row0 + kRows < n ? row0 + kRows : n;
  for (int i = row0; i < row_end; ++i) {
    const float ymin1 = __ldg(r + 4 * i), xmin1 = __ldg(r + 4 * i + 1);
    const float ymax1 = __ldg(r + 4 * i + 2), xmax1 = __ldg(r + 4 * i + 3);
    const float ih = fmaxf(0.0f, fminf(ymax1, ymax2) - fmaxf(ymin1, ymin2));
    const float iw = fmaxf(0.0f, fminf(xmax1, xmax2) - fmaxf(xmin1, xmin2));
    const float inter = ih * iw;
    const float area1 = (ymax1 - ymin1) * (xmax1 - xmin1);
    const float uni = area1 + area2 - inter;
    o[static_cast<int64_t>(i) * m] = uni > 0.0f ? inter / fmaxf(uni, 1e-30f) : 0.0f;
  }
}

}  // namespace

// boxes1 [P or 1, N, 4] and boxes2 [P or 1, M, 4] float32, contiguous;
// shared1 / shared2 = 1 when that side is one set for every problem.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mtlx_iou_f32(const void* boxes1, const void* boxes2, void* out,
                            int p, int n, int m, int shared1, int shared2,
                            void* stream) {
  if (p == 0 || n == 0 || m == 0) return 0;
  if (p > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kThreads - 1) / kThreads, (n + kRows - 1) / kRows, p);
  iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2),
      static_cast<float*>(out), n, m, shared1 ? 0 : static_cast<int64_t>(n) * 4,
      shared2 ? 0 : static_cast<int64_t>(m) * 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mtlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
