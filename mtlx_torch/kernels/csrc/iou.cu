// Pairwise IoU matrix: [P, N, 4] x [P, M, 4] -> [P, N, M] float32.
//
// Replaces the TPU kernel mtlx/kernels/iou_pallas.py iou_matrix (kernel
// body _iou_kernel), which tiled the output into 256 x 128 VMEM blocks
// and computed each block on the vector unit.
//
// What bounds it on Hopper: bytes. The output (16 x 100 x 30,720 floats
// = 197 MB on the training path's anchor assignment) dwarfs the boxes
// read (0.5 MB) and takes 0.059 ms to write. Its ~15 operations an output
// fit in that time only if they are all the thread does: four scalar loads
// of the row box, 64-bit addressing and an IEEE division (a sequence of a
// dozen instructions without fused multiply-add) for each of 49 M outputs
// take longer than the store, and most of those divisions divide 0: 80-99
// of the 100 ground-truth rows are padding, and a real box overlaps a
// small part of the anchors.
//
// What the design does about it: a block stages the boxes of a run of up
// to 16 rows n of its problem, and their areas, in shared memory once;
// each row box is then one 16-byte broadcast load. Each thread owns 4
// adjacent columns m, keeps their boxes and areas in registers, and
// writes one float4 a row with a streaming store (an M that is not a
// multiple of 4 stores its columns one by one). Addresses inside a
// problem are 32-bit. A short M (the 300 proposals, the 64 sampled boxes)
// gives few column blocks; there the runs of rows shorten down to one, so
// the grid still fills the card. The
// division runs only where the intersection is not 0; where it is 0,
// inter / union is inter itself, sign included, so the kernel writes
// inter.
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

constexpr int kThreads = 128;  // threads of a block
constexpr int kCols = 4;       // adjacent columns a thread owns
constexpr int kMaxRun = 16;    // rows a block stages and walks
constexpr int kFillBlocks = 132 * 8;  // blocks that fill the card (132 SMs)

__global__ void __launch_bounds__(kThreads)
iou_kernel(const float* __restrict__ boxes1,  // [P|1, N, 4]
           const float* __restrict__ boxes2,  // [P|1, M, 4]
           float* __restrict__ out,           // [P, N, M]
           int n, int m, int run, int64_t stride1, int64_t stride2) {
  __shared__ float4 row_box[kMaxRun];
  __shared__ float row_area[kMaxRun];
  const int p = blockIdx.z;
  const int row0 = blockIdx.y * run;
  const int rows = min(run, n - row0);
  if (threadIdx.x < rows) {
    const float* r = boxes1 + p * stride1 + 4 * (row0 + threadIdx.x);
    const float4 q = make_float4(__ldg(r), __ldg(r + 1), __ldg(r + 2), __ldg(r + 3));
    row_box[threadIdx.x] = q;
    row_area[threadIdx.x] = (q.z - q.x) * (q.w - q.y);
  }
  __syncthreads();
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (col0 >= m) return;
  const int cols = min(kCols, m - col0);
  const float* q = boxes2 + p * stride2 + 4 * col0;
  float ymin2[kCols], xmin2[kCols], ymax2[kCols], xmax2[kCols], area2[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const bool has = k < cols;
    ymin2[k] = has ? __ldg(q + 4 * k) : 0.0f;
    xmin2[k] = has ? __ldg(q + 4 * k + 1) : 0.0f;
    ymax2[k] = has ? __ldg(q + 4 * k + 2) : 0.0f;
    xmax2[k] = has ? __ldg(q + 4 * k + 3) : 0.0f;
    area2[k] = (ymax2[k] - ymin2[k]) * (xmax2[k] - xmin2[k]);
  }
  // 16-byte stores when every row starts on a 16-byte boundary
  const bool vec = cols == kCols && (m % kCols) == 0;
  float* o = out + static_cast<int64_t>(p) * n * m + (row0 * m + col0);
  for (int i = 0; i < rows; ++i, o += m) {
    const float4 r = row_box[i];
    const float area1 = row_area[i];
    float v[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const float ih = fmaxf(0.0f, fminf(r.z, ymax2[k]) - fmaxf(r.x, ymin2[k]));
      const float iw = fmaxf(0.0f, fminf(r.w, xmax2[k]) - fmaxf(r.y, xmin2[k]));
      const float inter = ih * iw;
      const float uni = area1 + area2[k] - inter;
      if (!(uni > 0.0f)) {
        v[k] = 0.0f;
      } else if (inter == 0.0f) {
        v[k] = inter;  // inter / union, sign included
      } else {
        v[k] = inter / fmaxf(uni, 1e-30f);
      }
    }
    if (vec) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (k < cols) o[k] = v[k];
    }
  }
}

}  // namespace

// boxes1 [P or 1, N, 4] and boxes2 [P or 1, M, 4] float32, contiguous;
// shared1 / shared2 = 1 when that side is one set for every problem.
// N * M must be below 2^31 and N at most 16 * 65535. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mtlx_iou_f32(const void* boxes1, const void* boxes2, void* out,
                            int p, int n, int m, int shared1, int shared2,
                            void* stream) {
  if (p == 0 || n == 0 || m == 0) return 0;
  int slabs = (n + kMaxRun - 1) / kMaxRun;
  if (p > 65535 || slabs > 65535 || static_cast<int64_t>(n) * m > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = kThreads * kCols;
  const int col_blocks = (m + per_block - 1) / per_block;
  // a short M leaves few blocks: then shorter runs of rows, so that the
  // grid still fills the card and no thread walks a long chain alone
  const int64_t blocks = static_cast<int64_t>(col_blocks) * p * slabs;
  if (blocks < kFillBlocks) {
    const int64_t want = (kFillBlocks + static_cast<int64_t>(col_blocks) * p - 1) /
                         (static_cast<int64_t>(col_blocks) * p);
    slabs = static_cast<int>(want < n ? want : n);
  }
  const int run = (n + slabs - 1) / slabs;  // balanced runs of at most kMaxRun rows
  const dim3 grid(col_blocks, (n + run - 1) / run, p);
  iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2),
      static_cast<float*>(out), n, m, run, shared1 ? 0 : static_cast<int64_t>(n) * 4,
      shared2 ? 0 : static_cast<int64_t>(m) * 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mtlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
