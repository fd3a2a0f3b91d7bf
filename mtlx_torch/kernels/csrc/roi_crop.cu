// The ROI crop (TF crop_and_resize contract), gather-bilinear: forward
// (kernel B) and the d(image) backward (kernel D).
//
// Forward. Replaces the TPU kernel mtlx/kernels/roi_pallas.py _crop_fwd
// (kernel body _fwd_kernel), reached through crop_and_resize_fused.
//
// What bounds it on Hopper: bytes. Each output element is 4 taps and
// ~8 flops; the crop [B, N, ch, cw, C] written once (120 MB in bf16 at
// 300 boxes x 14 x 14 x 1024) dwarfs the taps read (a stride-16 map of
// 40 x 64 x 1024 is 5 MB and stays in the 50 MB L2).
//
// What the design does about it: the TPU kernel built dense [ch, H] and
// [cw, W] interpolation matrices so the crop ran on the matrix unit; here
// that would read H + W weights per output to use four. So each thread
// owns one (box, y, x) sample point and a run of channels, computes its
// sample coordinates and the four tap addresses once, and moves the taps
// and the result in 16-byte vectors along C (8 bf16 or 4 f32 channels),
// so neighbouring threads read and write neighbouring addresses.
//
// Numerics: coordinates follow mtlx.ops.roi._sample_coords in its
// operation order; the taps are interpolated in f32 in the order of
// mtlx.ops.roi.crop_and_resize (top, bottom, then between them) and
// rounded once to the feature type. A sample outside [0, limit - 1] on
// either axis reads 0 (extrapolation_value 0). Compiled with --fmad=false
// so an f32 crop is bit-identical to the plain PyTorch version.
//
// Backward. Replaces the TPU kernel mtlx/kernels/roi_pallas.py
// _crop_bwd_image (kernel body _bwd_kernel), the d(image) half of the
// custom VJP _crop_core; the boxes get no gradient, as there.
//
// What bounds it on Hopper: bytes, and behind them the atomics. The
// gradient dout [B, N, ch, cw, C] is read once (411 MB in bf16 at 16 x 64
// boxes x 14 x 14 x 1024 on the training path) and d(image) [B, H, W, C]
// written once (84 MB in bf16). Every dout element adds into 4 taps, so
// the scatter issues 4 adds per element read, into a map that stays in
// the 50 MB L2 per image.
//
// What the design does about it: the TPU kernel carried d(image) in VMEM
// across a sequential grid over the boxes; Hopper's blocks run in no
// order, so each thread owns one (box, y, x) sample point and a run of
// channels (the forward's decomposition), reads its dout run as one
// 16-byte vector, and adds the four weighted taps into a float32 scratch
// map with 16-byte vector atomics (float4 atomicAdd, sm_90), so one atomic
// instruction carries 4 channels. A second pass rounds the scratch to
// bfloat16 once; an f32 d(image) is the scratch itself.
//
// Numerics: the same sample coordinates, in-range rule and clamped hi
// tap as the forward (a clamped tap has weight 0 and is skipped); each
// tap's weight is (1 - fy or fy) * (1 - fx or fx) and its term g * weight,
// in f32. The atomics add the terms of one pixel in an order that changes
// from run to run, so the f32 sum is not deterministic: a pixel's result
// may differ from the plain version's ordered sum by a few ulp of the sum
// of its terms' magnitudes (chip_smoke.py holds it to 1e-4 of that sum).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Vec;  // 16 bytes of T

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out, int width, bool vec) {
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
      for (int j = 0; j < width; ++j) out[j] = p[j];
    }
  }
  __device__ static void store(float* p, const float* v, int width, bool vec) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < width; ++j) p[j] = v[j];
    }
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out, int width, bool vec) {
    if (vec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
      for (int j = 0; j < kN; ++j) out[j] = __bfloat162float(h[j]);
    } else {
      for (int j = 0; j < width; ++j) out[j] = __bfloat162float(p[j]);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v, int width, bool vec) {
    if (vec) {
      uint4 raw;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
      for (int j = 0; j < kN; ++j) h[j] = __float2bfloat16_rn(v[j]);
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
      for (int j = 0; j < width; ++j) p[j] = __float2bfloat16_rn(v[j]);
    }
  }
};

// One axis of mtlx.ops.roi._sample_coords + crop_and_resize.sample_axis.
struct Axis {
  int lo, hi;
  float frac;
  bool in_range;
};

__device__ __forceinline__ Axis sample_axis(float c0, float c1, int size,
                                            int i, int limit) {
  const float lim1 = static_cast<float>(limit - 1);
  float coord;
  if (size > 1) {
    const float step = (c1 - c0) * lim1 / static_cast<float>(size - 1);
    coord = c0 * lim1 + step * static_cast<float>(i);
  } else {
    coord = 0.5f * (c0 + c1) * lim1;
  }
  const float lo = floorf(coord);
  Axis a;
  a.frac = coord - lo;
  int lo_i = static_cast<int>(lo);
  lo_i = lo_i < 0 ? 0 : (lo_i > limit - 1 ? limit - 1 : lo_i);
  const int hi_i = lo_i + 1 > limit - 1 ? limit - 1 : lo_i + 1;
  a.lo = lo_i;
  a.hi = hi_i;
  a.in_range = coord >= 0.0f && coord <= lim1;
  return a;
}

template <typename T>
__global__ void roi_crop_fwd_kernel(const T* __restrict__ image,   // [B, H, W, C]
                                    const float* __restrict__ boxes,  // [B, N, 4]
                                    T* __restrict__ out,  // [B, N, ch, cw, C]
                                    int64_t total, int num_boxes, int h,
                                    int w, int c, int ch, int cw,
                                    int chunks) {
  constexpr int kV = Vec<T>::kN;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int chunk = static_cast<int>(t % chunks);
  int64_t rest = t / chunks;
  const int x = static_cast<int>(rest % cw);
  rest /= cw;
  const int y = static_cast<int>(rest % ch);
  const int64_t bn = rest / ch;  // b * num_boxes + n
  const int b = static_cast<int>(bn / num_boxes);

  const float* box = boxes + bn * 4;
  const Axis ay = sample_axis(box[0], box[2], ch, y, h);
  const Axis ax = sample_axis(box[1], box[3], cw, x, w);

  const int c0 = chunk * kV;
  const int width = c - c0 < kV ? c - c0 : kV;
  // 16-byte vectors only when every row start is 16-byte aligned
  const bool vec = (c % kV) == 0;
  T* dst = out + (((bn * ch + y) * cw + x) * static_cast<int64_t>(c)) + c0;
  float res[kV];
  if (!(ay.in_range && ax.in_range)) {
    for (int j = 0; j < kV; ++j) res[j] = 0.0f;
    Vec<T>::store(dst, res, width, vec);
    return;
  }
  const T* img = image + static_cast<int64_t>(b) * h * w * c + c0;
  const int64_t row_lo = static_cast<int64_t>(ay.lo) * w;
  const int64_t row_hi = static_cast<int64_t>(ay.hi) * w;
  float tl[kV], tr[kV], bl[kV], br[kV];
  Vec<T>::load(img + (row_lo + ax.lo) * c, tl, width, vec);
  Vec<T>::load(img + (row_lo + ax.hi) * c, tr, width, vec);
  Vec<T>::load(img + (row_hi + ax.lo) * c, bl, width, vec);
  Vec<T>::load(img + (row_hi + ax.hi) * c, br, width, vec);
  for (int j = 0; j < kV; ++j) {
    const float top = tl[j] + (tr[j] - tl[j]) * ax.frac;
    const float bottom = bl[j] + (br[j] - bl[j]) * ax.frac;
    res[j] = top + (bottom - top) * ay.frac;
  }
  Vec<T>::store(dst, res, width, vec);
}

template <typename T>
int launch(const void* image, const void* boxes, void* out, int b, int h,
           int w, int c, int n, int ch, int cw, cudaStream_t stream) {
  constexpr int kV = Vec<T>::kN;
  const int chunks = (c + kV - 1) / kV;
  const int64_t total = static_cast<int64_t>(b) * n * ch * cw * chunks;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  roi_crop_fwd_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(image), static_cast<const float*>(boxes),
      static_cast<T*>(out), total, n, h, w, c, ch, cw, chunks);
  return static_cast<int>(cudaGetLastError());
}

// Adds g[0..width) * wgt into dst (float32), 16-byte atomics when vec.
template <int kV>
__device__ __forceinline__ void scatter_add(float* dst, const float* g, float wgt,
                                            int width, bool vec) {
  if (wgt == 0.0f) return;
  if (vec) {
#pragma unroll
    for (int j = 0; j < kV; j += 4) {
      atomicAdd(reinterpret_cast<float4*>(dst + j),
                make_float4(g[j] * wgt, g[j + 1] * wgt, g[j + 2] * wgt, g[j + 3] * wgt));
    }
    return;
  }
  for (int j = 0; j < width; ++j) atomicAdd(dst + j, g[j] * wgt);
}

template <typename T>
__global__ void roi_crop_bwd_kernel(const T* __restrict__ dout,      // [B, N, ch, cw, C]
                                    const float* __restrict__ boxes,  // [B, N, 4]
                                    float* __restrict__ dimg,         // [B, H, W, C] f32
                                    int64_t total, int num_boxes, int h,
                                    int w, int c, int ch, int cw,
                                    int chunks) {
  constexpr int kV = Vec<T>::kN;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int chunk = static_cast<int>(t % chunks);
  int64_t rest = t / chunks;
  const int x = static_cast<int>(rest % cw);
  rest /= cw;
  const int y = static_cast<int>(rest % ch);
  const int64_t bn = rest / ch;  // b * num_boxes + n
  const int b = static_cast<int>(bn / num_boxes);

  const float* box = boxes + bn * 4;
  const Axis ay = sample_axis(box[0], box[2], ch, y, h);
  const Axis ax = sample_axis(box[1], box[3], cw, x, w);
  if (!(ay.in_range && ax.in_range)) return;  // the forward read 0 here

  const int c0 = chunk * kV;
  const int width = c - c0 < kV ? c - c0 : kV;
  const bool vec = (c % kV) == 0;
  float g[kV];
  Vec<T>::load(dout + (((bn * ch + y) * cw + x) * static_cast<int64_t>(c)) + c0, g,
               width, vec);
  const float wy_lo = 1.0f - ay.frac, wy_hi = ay.frac;
  const float wx_lo = 1.0f - ax.frac, wx_hi = ax.frac;
  float* img = dimg + static_cast<int64_t>(b) * h * w * c + c0;
  const int64_t row_lo = static_cast<int64_t>(ay.lo) * w;
  const int64_t row_hi = static_cast<int64_t>(ay.hi) * w;
  scatter_add<kV>(img + (row_lo + ax.lo) * c, g, wy_lo * wx_lo, width, vec);
  scatter_add<kV>(img + (row_lo + ax.hi) * c, g, wy_lo * wx_hi, width, vec);
  scatter_add<kV>(img + (row_hi + ax.lo) * c, g, wy_hi * wx_lo, width, vec);
  scatter_add<kV>(img + (row_hi + ax.hi) * c, g, wy_hi * wx_hi, width, vec);
}

// Rounds n float32 values to bfloat16, four per thread.
__global__ void f32_to_bf16_kernel(const float* __restrict__ in,
                                   __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(in + i);
    out[i] = __float2bfloat16_rn(v.x);
    out[i + 1] = __float2bfloat16_rn(v.y);
    out[i + 2] = __float2bfloat16_rn(v.z);
    out[i + 3] = __float2bfloat16_rn(v.w);
  } else {
    for (int64_t j = i; j < n; ++j) out[j] = __float2bfloat16_rn(in[j]);
  }
}

template <typename T>
int launch_bwd(const void* dout, const void* boxes, float* dimg, int b, int h,
               int w, int c, int n, int ch, int cw, cudaStream_t stream) {
  constexpr int kV = Vec<T>::kN;
  const int chunks = (c + kV - 1) / kV;
  const int64_t total = static_cast<int64_t>(b) * n * ch * cw * chunks;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  roi_crop_bwd_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const float*>(boxes), dimg, total, n,
      h, w, c, ch, cw, chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The image and output base pointers
// must be 16-byte aligned (the wrapper checks). Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int mtlx_roi_crop_fwd(const void* image, const void* boxes,
                                 void* out, int b, int h, int w, int c, int n,
                                 int ch, int cw, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(image, boxes, out, b, h, w, c, n, ch, cw, s);
  if (dtype == 1) return launch<__nv_bfloat16>(image, boxes, out, b, h, w, c, n, ch, cw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32, 1 = bfloat16 (of dout and of d(image)). scratch is
// a float32 [B, H, W, C] buffer (for float32, the output itself); it is
// zeroed here. The base pointers must be 16-byte aligned (the wrapper
// checks). Returns the first CUDA error (0 on success).
extern "C" int mtlx_roi_crop_bwd(const void* dout, const void* boxes, void* scratch,
                                 void* out, int b, int h, int w, int c, int n,
                                 int ch, int cw, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elems = static_cast<int64_t>(b) * h * w * c;
  if (elems == 0) return 0;
  float* acc = static_cast<float*>(scratch);
  cudaError_t e = cudaMemsetAsync(acc, 0, elems * sizeof(float), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int err = dtype == 0
      ? launch_bwd<float>(dout, boxes, acc, b, h, w, c, n, ch, cw, s)
      : launch_bwd<__nv_bfloat16>(dout, boxes, acc, b, h, w, c, n, ch, cw, s);
  if (err != 0 || dtype == 0) return err;
  const int threads = 256;
  const int64_t blocks = ((elems + 3) / 4 + threads - 1) / threads;
  f32_to_bf16_kernel<<<static_cast<unsigned int>(blocks), threads, 0, s>>>(
      acc, static_cast<__nv_bfloat16*>(out), elems);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mtlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
