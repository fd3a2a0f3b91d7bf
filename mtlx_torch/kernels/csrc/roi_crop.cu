// Forward of the ROI crop (TF crop_and_resize contract), gather-bilinear.
//
// Replaces the TPU kernel mtlx/kernels/roi_pallas.py _crop_fwd (kernel
// body _fwd_kernel), reached through crop_and_resize_fused.
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

extern "C" const char* mtlx_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
